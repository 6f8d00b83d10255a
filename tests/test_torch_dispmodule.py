"""The port's DispModule (models/psmnet/dispmodule.py), its helpers, the
full-image reassembly (models/psmnet/inference.py) and DispRCNN's
DISPNET_ON branch against the JAX package on the CPU.

DispModule runs at resolution 8 -> disp_resolution 32 over [-8, 8) (a
cost volume of D = 4 at stride 4), on FPN levels of 8 channels of a
64x128 image, with CONV_LAYERS () and (16,), in eval and in train mode
(Flax's batch statistics over every row, the running statistics updated).
Its variables are the port's seeded random weights carried to JAX by the
inverse of state_dict_from_jax (tests/torch_jax_tree.py), so no JAX model
is traced to draw them. The whole detector (R-50, 64x128, the test size
of test_torch_detector2d.py) with dispnet_on is traced through JAX and
marked slow: its eval disparity_roi, and the train branch's loss_psm with
the gradients of every parameter.

Tolerances: the box helpers, the GT mask on the ROIs and the routing
exactly; the full-image disparity to 1e-5 of max |JAX|; DispModule's
outputs to 1e-4 of max |JAX| (the two frameworks sum the 3D convs in
other orders) and its running statistics to 1e-5 relative (+1e-6); the
detector's disparity_roi to 1e-3 of max |JAX| + 1e-3 px (its boxes agree
to ~1e-4 px); loss_psm to 1e-4 relative; the gradients in ROADMAP C19's
L2 form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.detector import disprcnn as jdet
from disprcnn_tpu.models.psmnet import dispmodule as jdm
from disprcnn_tpu.models.psmnet.inference import rois_to_fullimage_disparity as j_fullimage
from disprcnn_tpu_torch.models.detector import disprcnn as tdet
from disprcnn_tpu_torch.models.psmnet import dispmodule as tdm
from disprcnn_tpu_torch.models.psmnet.inference import rois_to_fullimage_disparity
from disprcnn_tpu_torch.utils.weights import init_random_, load_jax_variables
from torch_jax_tree import jax_tree
from torch_port_helpers import IMG_HW, TINY, jax_variables
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SMALL = dict(maxdisp=8, mindisp=-8, resolution=8, disp_resolution=32)
C = 8  # FPN channels
B, R_PER = 2, 3
HWS = [(16, 32), (8, 16), (4, 8), (2, 4)]


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def t(x):
    return torch.from_numpy(np.array(x))


def boxes(rng, n, hw=IMG_HW, min_wh=4.0):
    """n random boxes inside and across the border of an hw image."""
    h, w = hw
    xy = rng.uniform([-6, -4], [w - 8, h - 8], (n, 2))
    wh = rng.uniform(min_wh, [w / 2, h / 2], (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def stereo_boxes(rng, n):
    left = boxes(rng, n)
    right = left - np.array([1, 0, 1, 0], np.float32) * rng.uniform(0, 12, (n, 1))
    right[:, 2] += rng.uniform(-6, 6, n)  # other widths
    return left, right.astype(np.float32)


def test_expand_left_right_freex_matches_jax():
    rng = np.random.default_rng(0)
    left, right = stereo_boxes(rng, 64)
    left[:8, 0] = IMG_HW[1] - rng.uniform(1, 10, 8)  # the image edge caps the width
    got = tdm.expand_left_right_freex(t(left), t(right), float(IMG_HW[1]))
    want = jdm.expand_left_right_freex(jnp.asarray(left), jnp.asarray(right), float(IMG_HW[1]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][:8, 2] <= IMG_HW[1]).all() and not torch.equal(got[0], t(left))


@pytest.mark.parametrize("method", ["nearest", "lower"])
def test_roi_resolution_keep_matches_jax(method):
    rng = np.random.default_rng(1)
    b = boxes(rng, 200, hw=(400, 600), min_wh=1.0)
    res = (14, 28, 56)
    for r in res:
        got = tdm.roi_resolution_keep(t(b), res, r, method)
        want = jdm.roi_resolution_keep(jnp.asarray(b), res, r, method)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sum(tdm.roi_resolution_keep(t(b), res, r, method).long() for r in res).eq(1).all()


def ellipse_masks(rng, b, m, hw=IMG_HW):
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    c = rng.uniform([0, 0], [w, h], (b, m, 2))
    ax = rng.uniform(4, 30, (b, m, 2))
    return ((((xx - c[..., 0, None, None]) / ax[..., 0, None, None]) ** 2
             + ((yy - c[..., 1, None, None]) / ax[..., 1, None, None]) ** 2) <= 1
            ).astype(np.float32)


def test_gt_mask_on_roi_matches_jax():
    """Each ROI's matched GT mask on its grid, matched indices past both
    ends clipped, as JAX's _gt_mask_on_roi."""
    rng = np.random.default_rng(2)
    m, r, size = 4, 40, 32
    masks = ellipse_masks(rng, B, m)
    bi = rng.integers(0, B, r).astype(np.int32)
    mg = rng.integers(-1, m + 1, r).astype(np.int32)
    bx = boxes(rng, r)
    got = tdet.gt_mask_on_roi(t(masks), t(mg), t(bi), t(bx), size)
    want = jdet._gt_mask_on_roi(jnp.asarray(masks), jnp.asarray(mg), jnp.asarray(bi),
                                jnp.asarray(bx), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.05 < got.float().mean() < 0.95


def test_rois_to_fullimage_disparity_matches_jax():
    """Instances overlapping each other and the border, an invalid row (its
    pixels left to the others or 0), soft masks."""
    rng = np.random.default_rng(3)
    r, s, m = 6, 16, 28
    left, right = stereo_boxes(rng, r)
    disp = rng.uniform(-8, 8, (r, s, s)).astype(np.float32)
    masks = rng.uniform(0, 1, (r, m, m)).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    got = rois_to_fullimage_disparity(t(disp), t(masks), t(left), t(right), t(valid), *IMG_HW)
    want = np.asarray(j_fullimage(jnp.asarray(disp), jnp.asarray(masks), jnp.asarray(left),
                                  jnp.asarray(right), jnp.asarray(valid), *IMG_HW))
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert 0.02 < (want != 0).mean() < 0.9


def dispmodule_inputs(seed):
    rng = np.random.default_rng(seed)
    feats = [[rng.standard_normal((B, C, h, w)).astype(np.float32) for h, w in HWS]
             for _ in range(2)]
    left, right = stereo_boxes(rng, B * R_PER)
    left, right = (np.asarray(x) for x in jdm.expand_left_right_freex(
        jnp.asarray(left), jnp.asarray(right), float(IMG_HW[1])))
    bi = np.repeat(np.arange(B, dtype=np.int32), R_PER)
    return feats, left, right, bi


def run_jax_dispmodule(conv_layers, tree, feats, left, right, bi, train):
    jm = jdm.DispModule(**SMALL, conv_layers=conv_layers)
    nhwc = lambda fs: [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in fs]
    args = (nhwc(feats[0]), nhwc(feats[1]), jnp.asarray(left), jnp.asarray(right),
            jnp.asarray(bi))
    if train:
        return jm.apply(tree, *args, train=True, mutable=["batch_stats"])
    return jm.apply(tree, *args, train=False), None


@pytest.mark.parametrize("conv_layers", [(), (16,)])
@pytest.mark.parametrize("train", [False, True])
def test_dispmodule_matches_jax(conv_layers, train):
    """Eval: the disparity; train: the three deep-supervision disparities
    and the updated running statistics of every BN."""
    tm = tdm.DispModule(C, **SMALL, conv_layers=conv_layers)
    init_random_(tm, torch.Generator().manual_seed(5))
    tree = jax_tree(tm, tm.state_dict())
    assert set(tree) == {"params", "batch_stats"}
    feats, left, right, bi = dispmodule_inputs(6)
    want, updates = run_jax_dispmodule(conv_layers, tree, feats, left, right, bi, train)
    tm.train(train)
    with torch.no_grad():
        got = tm([t(f) for f in feats[0]], [t(f) for f in feats[1]], t(left), t(right), t(bi))
    tm.eval()
    got, want = (got, want) if train else ((got,), (want,))
    assert len(got) == len(want) == (3 if train else 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (B * R_PER, 32, 32)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    if train:
        new = jax_tree(tm, tm.state_dict())["batch_stats"]
        flat = jax.tree_util.tree_leaves_with_path(updates["batch_stats"])
        assert len(flat) == len(jax.tree_util.tree_leaves(new))
        for path, w in flat:
            g = new
            for k in path:
                g = g[k.key]
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6)


# -- the detector with dispnet_on (traced through JAX: slow) ---------------------

DISP = dict(dispnet_on=True, dispnet_maxdisp=8, dispnet_mindisp=-8, dispnet_resolution=8,
            dispnet_disp_resolution=32, dispnet_conv_layers=(16,))


@pytest.mark.slow
def test_disprcnn_dispnet_eval_matches_jax():
    jm = jdet.DispRCNN(**TINY, **DISP)
    v = jax_variables(jm, seed=0)
    tm = load_jax_variables(tdet.DispRCNN(**TINY, **DISP, device="cpu"), v)
    rng = np.random.default_rng(7)
    left, right = (rng.standard_normal((B, *IMG_HW, 3)).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda vv, a, b: jm.apply(vv, a, b))(v, jnp.asarray(left),
                                                          jnp.asarray(right))
    with torch.no_grad():
        got = tm(t(left), t(right))
    np.testing.assert_array_equal(got["detections"].valid.numpy(),
                                  np.asarray(want["detections"].valid))
    np.testing.assert_allclose(got["detections"].left.numpy(),
                               np.asarray(want["detections"].left), rtol=0, atol=1e-3)
    w = np.asarray(want["disparity_roi"])
    assert got["disparity_roi"].shape == w.shape == (B, TINY["max_det"], 32, 32)
    np.testing.assert_allclose(got["disparity_roi"].numpy(), w, rtol=0,
                               atol=1e-3 * np.abs(w).max() + 1e-3)


@pytest.mark.slow
def test_disprcnn_dispnet_train_matches_jax():
    """The train branch with train_psm on the draws of a JAX forward (the
    two sampling keys and the box head's dropout, as
    test_torch_detector2d_train.py reads them): loss_psm, and its gradient
    in every parameter (through DispModule, the pooled FPN features and the
    proposals' coordinates; zero in the stem and layer1 on both sides)."""
    import flax.linen as fnn

    import test_torch_detector2d_train as d2
    from test_torch_train import grads_close
    from disprcnn_tpu_torch.utils.weights import state_dict_from_jax

    jm = jdet.DispRCNN(**d2.JTRAIN, **DISP)
    v = jax_variables(jm, seed=0)
    batch = d2.step_batch()
    h, w = IMG_HW
    xx = np.arange(w, dtype=np.float32)[None, None, :] + np.zeros((d2.B, h, 1), np.float32)
    gt_disp = (5.0 + 3.0 * np.sin(xx / 13.0 + np.arange(d2.B)[:, None, None])).astype(np.float32)
    keys, drawn = {}, {}
    orig_rng = fnn.Module.make_rng

    def make_rng(self, name="params"):
        k = orig_rng(self, name)
        if name == "sampling" and isinstance(self, jdet.DispRCNN):
            i = len(keys)
            keys[i] = None
            jax.debug.callback(lambda kk: keys.__setitem__(i, np.array(kk)), k)
        return k

    r1, r2 = jax.random.split(jax.random.PRNGKey(3))

    def loss(params):
        with fnn.intercept_methods(d2.dropout_recorder(drawn)):
            out, _ = jm.apply({"params": params, "frozen": v["frozen"],
                               "batch_stats": v["batch_stats"]}, train=True, train_psm=True,
                              gt_disp=jnp.asarray(gt_disp), rngs={"sampling": r1, "dropout": r2},
                              mutable=["batch_stats"],
                              **{k: jnp.asarray(x) for k, x in batch.items()})
        return out["loss_psm"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "make_rng", make_rng)
        want, wgrad = jax.jit(jax.value_and_grad(loss))(v["params"])
        jax.block_until_ready(wgrad)
    draws = d2.port_draws([keys[i] for i in sorted(keys)], drawn, 2046)
    tm = load_jax_variables(tdet.DispRCNN(**d2.TRAIN, **DISP, device="cpu"), v)
    tm.train()
    out = tm(**{k: t(x) for k, x in batch.items()}, draws=draws, train_psm=True,
             gt_disp=t(gt_disp))
    out["loss_psm"].backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(out["loss_psm"].detach()), float(want), rtol=1e-4)
    want_sd = state_dict_from_jax(tm, {"params": jax.tree_util.tree_map(np.asarray, wgrad),
                                       "frozen": v["frozen"], "batch_stats": v["batch_stats"]})
    params = dict(tm.named_parameters())
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in params.items()}
    grads_close(got, {n: want_sd[n].numpy() for n in params})
    assert all(params[n].grad is not None for n in params if n.startswith("dispnet."))
