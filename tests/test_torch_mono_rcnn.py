"""The port's mono detector (models/rpn/rpn.py, models/backbone/resnet.py's
Stage5Head and C4 body, models/detector/generalized_rcnn.py) against the
JAX package on the CPU, on numpy-drawn JAX variables loaded by
state_dict_from_jax.

- The RPN head on two levels (anchor-major NHWC channels), its
  postprocess (sigmoid, top-k, decode, clip, min size, NMS) and its loss
  on the uniforms that JAX's balanced sampler draws from its key (the
  losses 1e-5 relative, their gradients 1e-5 * max + 1e-7).
- Stage5Head, the C4 box head (14x14 ROIAlign on one map, res5, the mean)
  and the FPN box head: 1e-4 of max |JAX| + 1e-4.
- The whole model at 3 classes on 1 x 64 x 128 with the FPN body and the
  C4 body (slow: each traces a JAX model): eval (valid detections: boxes
  1e-3 px, scores 1e-5, labels exact; JAX's CPU NMS fills its empty slots
  otherwise, ROADMAP C12) and one train forward (the four losses 1e-5
  relative, the gradients in ROADMAP C19's L2 form, and zero JAX
  gradients where the port has none: the stem and layer1 behind
  freeze_at 2). A C4 body with MASK_ON raises, as in the JAX package.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.backbone.resnet import Stage5Head as JStage5Head
from disprcnn_tpu.models.detector import generalized_rcnn as jgr
from disprcnn_tpu.models.rpn import rpn as jrpn
from disprcnn_tpu.models.rpn.anchors import AnchorGenerator as JAnchorGenerator
from disprcnn_tpu_torch.models.backbone.resnet import Stage5Head
from disprcnn_tpu_torch.models.detector import generalized_rcnn as tgr
from disprcnn_tpu_torch.models.rpn import rpn as trpn
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from test_torch_detector2d_train import sampler_uniforms
from test_torch_train import close, grads_close
from torch_port_helpers import draw_variables
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

HW = (64, 128)
B = 2


def t(x):
    return torch.from_numpy(np.array(x))


def nchw(x):
    return t(np.asarray(x).transpose(0, 3, 1, 2))


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def maps_close(got, want):
    w = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), w, rtol=0,
                               atol=1e-4 * np.abs(w).max() + 1e-4)


def anchors_of(hws, strides=(8, 16)):
    gen = JAnchorGenerator((32, 64), strides, (0.5, 1.0, 2.0))
    a, vis = gen(HW, hws)
    return a, vis


def gt_boxes(seed, b=B, m=4, size=((16, 60), (12, 40))):
    """(b, m, 4) boxes, 3 valid in the first image and 2 in the second, some
    across the border; labels 1..2."""
    rng = np.random.default_rng(seed)
    g = np.zeros((b, m, 4), np.float32)
    valid = np.zeros((b, m), bool)
    for i in range(b):
        for j in range(3 - i):
            w, h = rng.uniform(*size[0]), rng.uniform(*size[1])
            x1, y1 = rng.uniform(-6, HW[1] - w + 6), rng.uniform(-4, HW[0] - h + 4)
            g[i, j] = (x1, y1, x1 + w, y1 + h)
            valid[i, j] = True
    labels = (rng.integers(1, 3, (b, m)) * valid).astype(np.int32)
    return g, labels, valid


# -- the RPN ---------------------------------------------------------------------------

def test_rpn_head_matches_jax():
    rng = np.random.default_rng(0)
    feats = [normal(rng, B, 8, 16, 16), normal(rng, B, 4, 8, 16)]
    jm = jrpn.RPNHead(in_channels=16, num_anchors=3)
    v = draw_variables(jm, [jnp.asarray(f) for f in feats], seed=1)
    want = jm.apply(v, [jnp.asarray(f) for f in feats])
    tm = load_jax_variables(trpn.RPNHead(16, 3), v)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    for (gl, gd), (wl, wd) in zip(got, want):
        maps_close(gl, wl)
        maps_close(gd, wd)
    gl, gd = trpn.flatten_levels(got)
    wl, wd = jrpn.flatten_levels(want)
    maps_close(gl, wl)
    maps_close(gd, wd)


@pytest.mark.parametrize("min_size", [0.0, 6.0])
def test_rpn_postprocess_matches_jax(min_size):
    hws = [(8, 16), (4, 8)]
    anchors, _ = anchors_of(hws)
    n = anchors.shape[0]
    rng = np.random.default_rng(2)
    logits = normal(rng, B, n)
    logits[1, ::7] = logits[1, 3]  # tied scores
    deltas = normal(rng, B, n, 4, scale=0.3)
    want = jax.jit(jax.vmap(lambda o, d: jrpn.postprocess(
        jnp.asarray(anchors), o, d, HW, 200, 50, 0.7, min_size)))(jnp.asarray(logits),
                                                               jnp.asarray(deltas))
    got = trpn.postprocess_batched(t(anchors), t(logits), t(deltas), HW, 200, 50, 0.7,
                                   min_size)
    ok = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    assert ok.sum(1).min() > 5
    close(got.xyxy.numpy()[ok], np.asarray(want.xyxy)[ok], 0.0, 1e-4, "proposals")
    close(got.fields["objectness"].numpy()[ok], np.asarray(want.fields["objectness"])[ok],
          0.0, 1e-6, "objectness")


def test_rpn_loss_matches_jax():
    hws = [(8, 16), (4, 8)]
    anchors, vis = anchors_of(hws)
    n = anchors.shape[0]
    rng = np.random.default_rng(3)
    logits, deltas = normal(rng, B, n), normal(rng, B, n, 4, scale=0.3)
    g, _, gv = gt_boxes(4)
    key = jax.random.PRNGKey(5)

    def f(o, d):
        lo, lb = jrpn.loss(key, jnp.asarray(anchors), jnp.asarray(vis), o, d, jnp.asarray(g),
                           jnp.asarray(gv), batch_per_image=64)
        return lo + 3 * lb, (lo, lb)

    (_, want), wg = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(jnp.asarray(logits),
                                                                         jnp.asarray(deltas))
    up, un = sampler_uniforms(key, B, n)
    to, td = t(logits).requires_grad_(True), t(deltas).requires_grad_(True)
    got = trpn.loss(t(anchors), t(vis), to, td, t(g), t(gv), up, un, batch_per_image=64)
    (got[0] + 3 * got[1]).backward()
    for gg, w in zip(got, want):
        assert float(w) > 0
        close(float(gg.detach()), float(w), 1e-5, 0.0)
    close(to.grad.numpy(), wg[0], 1e-5, 1e-7, "d logits")
    close(td.grad.numpy(), wg[1], 1e-5, 1e-7, "d deltas")


# -- the box heads ----------------------------------------------------------------------

def rois(rng, r, hw=HW):
    x1, y1 = rng.uniform(-4, hw[1] - 20, r), rng.uniform(-4, hw[0] - 16, r)
    return np.stack([x1, y1, x1 + rng.uniform(4, 60, r), y1 + rng.uniform(4, 40, r)],
                    -1).astype(np.float32)


def test_stage5_head_matches_jax():
    rng = np.random.default_rng(6)
    x = normal(rng, 3, 14, 14, 64)
    jm = JStage5Head(body="R-50-C4")
    v = draw_variables(jm, jnp.asarray(x), seed=7)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = load_jax_variables(Stage5Head("R-50-C4", 64), v)
    assert tm.block_names == ["layer4_0", "layer4_1", "layer4_2"]
    with torch.no_grad():
        got = tm(nchw(x))
    maps_close(got, np.asarray(want).transpose(0, 3, 1, 2))


def test_c4_box_head_matches_jax():
    rng = np.random.default_rng(8)
    feat = normal(rng, B, 4, 8, 32)
    boxes = rois(rng, 6)
    bi = np.array([0, 0, 0, 1, 1, 1], np.int32)
    jm = jgr.C4BoxHead(body="R-50-C4", num_classes=3)
    v = draw_variables(jm, jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(bi), seed=9)
    want = jax.jit(jm.apply)(v, jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(bi))
    tm = load_jax_variables(tgr.C4BoxHead("R-50-C4", 32, 3), v)
    with torch.no_grad():
        got = tm(nchw(feat), t(boxes), t(bi))
    for g, w in zip(got, want):
        maps_close(g, w)


def test_fpn_box_head_matches_jax():
    rng = np.random.default_rng(10)
    feats = [normal(rng, B, 16 // 2 ** i, 32 // 2 ** i, 8) for i in range(4)]
    boxes = np.concatenate([rois(rng, 5), np.array([[2.0, 3, 60, 50], [0, 0, 120, 63]],
                                                   np.float32)])
    bi = np.array([0, 1, 0, 1, 0, 1, 0], np.int32)
    jm = jgr.MonoBoxHead(num_classes=3, mlp_dim=16)
    jf = [jnp.asarray(f) for f in feats]
    v = draw_variables(jm, jf, jnp.asarray(boxes), jnp.asarray(bi), seed=11)
    want = jax.jit(jm.apply)(v, jf, jnp.asarray(boxes), jnp.asarray(bi))
    tm = load_jax_variables(tgr.MonoBoxHead(8, 3, 16), v)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats], t(boxes), t(bi))
    for g, w in zip(got, want):
        maps_close(g, w)


def test_c4_mask_on_raises():
    tm = tgr.GeneralizedRCNN(body="R-50-C4", num_classes=3, pre_nms_top_n_test=50,
                             post_nms_top_n_test=8, max_det=4, mask_on=True, device="cpu")
    assert not hasattr(tm, "mask_head")
    with torch.no_grad(), pytest.raises(NotImplementedError, match="FPN body for MASK_ON"):
        tm(torch.zeros(1, *HW, 3))


# -- the whole model --------------------------------------------------------------------

MODEL = dict(num_classes=3, out_channels=32, mlp_head_dim=64, pre_nms_top_n_test=200,
             post_nms_top_n_test=32, pre_nms_top_n_train=400, post_nms_top_n_train=160,
             roi_batch_per_image=32, max_det=8)


@pytest.fixture(scope="module", params=["R-50-FPN", "R-50-C4"])
def pair(request):
    """(JAX model, its numpy variables, the port model with them loaded);
    the FPN body with its mask head."""
    body = request.param
    kw = dict(MODEL, body=body, mask_on=body.endswith("FPN"))
    jm = jgr.GeneralizedRCNN(**kw, max_gt=4)
    v = draw_variables(jm, jnp.zeros((1, *HW, 3)), seed=12, train=False)
    # small RPN deltas: proposals near their anchors, some of which match
    # the GT at 0.5 (the ROI sampler then has positives)
    box = v["params"]["rpn_head"]["bbox_pred"]
    box["kernel"], box["bias"] = box["kernel"] * 0.01, box["bias"] * 0.01
    tm = load_jax_variables(tgr.GeneralizedRCNN(**kw, device="cpu"), v)
    return jm, v, tm


@pytest.mark.slow
def test_mono_eval_matches_jax(pair):
    jm, v, tm = pair
    x = normal(np.random.default_rng(13), B, *HW, 3)
    want = jax.jit(lambda a: jm.apply(v, a, train=False))(jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x))
    wd, gd = want["detections"], got["detections"]
    ok = np.asarray(wd.valid)
    np.testing.assert_array_equal(gd.valid.numpy(), ok)
    assert ok.sum(1).min() > 0
    close(gd.xyxy.numpy()[ok], np.asarray(wd.xyxy)[ok], 0.0, 1e-3, "boxes")
    close(gd.fields["scores"].numpy()[ok], np.asarray(wd.fields["scores"])[ok], 0.0, 1e-5)
    np.testing.assert_array_equal(gd.fields["labels"].numpy()[ok],
                                  np.asarray(wd.fields["labels"])[ok])
    assert ("masks" in got) == ("masks" in want)
    if "masks" in want:
        close(got["masks"].numpy()[ok], np.asarray(want["masks"])[ok], 0.0, 1e-5, "masks")


@pytest.mark.slow
def test_mono_train_matches_jax(pair):
    jm, v, tm = pair
    x = normal(np.random.default_rng(14), B, *HW, 3)
    # boxes the size of the anchors, so that some proposals match them at 0.5
    g, labels, gv = gt_boxes(15, size=((28, 70), (24, 50)))
    keys = {}
    orig_rng = fnn.Module.make_rng

    def make_rng(self, name="params"):
        k = orig_rng(self, name)
        if name == "sampling" and isinstance(self, jgr.GeneralizedRCNN):
            i = len(keys)
            keys[i] = None
            jax.debug.callback(lambda kk: keys.__setitem__(i, np.array(kk)), k)
        return k

    def f(params, a):
        out = jm.apply({"params": params, "frozen": v["frozen"]}, a, train=True,
                       gt_boxes=jnp.asarray(g), gt_labels=jnp.asarray(labels),
                       gt_valid=jnp.asarray(gv), rngs={"sampling": jax.random.PRNGKey(16)})
        return sum(out.values()), out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "make_rng", make_rng)
        (_, want), wg = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"],
                                                                    jnp.asarray(x))
        jax.block_until_ready(wg)
    n_anchors = sum(h * w for h, w in ((16, 32), (8, 16), (4, 8), (2, 4), (1, 2))) * 3 \
        if tm.body.endswith("FPN") else 4 * 8 * 15
    up, un = sampler_uniforms(jnp.asarray(keys[0]), B, n_anchors)
    rp, rn = sampler_uniforms(jnp.asarray(keys[1]), B, MODEL["post_nms_top_n_train"])
    tm.train()
    try:
        got = tm(t(x), t(g), t(labels), t(gv), draws=tgr.MonoDraws(up, un, rp, rn))
    finally:
        tm.eval()
    assert set(got) == set(want)
    for k in want:
        assert float(want[k]) > 0, k
        close(float(got[k].detach()), float(want[k]), 1e-5, 0.0, k)
    tm.zero_grad()
    sum(got.values()).backward()
    jgrad = state_dict_from_jax(tm, {"params": wg, "frozen": v["frozen"]})
    params = dict(tm.named_parameters())
    with_grad = {n for n, p in params.items() if p.grad is not None}
    for n in set(params) - with_grad:  # behind freeze_at, and the mask head
        assert not jgrad[n].any(), n
    assert any(n.startswith("backbone.") for n in with_grad)
    grads_close({n: params[n].grad.numpy() for n in with_grad},
                {n: jgrad[n].numpy() for n in with_grad})
