"""The port's train path for the 3D RPN stage (configs/kitti/car/vob/rpn.yaml,
TRAIN_PC with FIX_DISPARITY, the RPN training and the RCNN disabled)
against the JAX package on the CPU, at small sizes: PointNet++'s SharedMLP
and the RPN heads in train mode (Flax's batch statistics and running
statistics, the heads' dropout on the masks JAX drew), the RPN point
labels, the RPN loss (BCE), the eval forward of a DispRCNN3D
without its RCNN, and one whole train step against JAX's make_train_step
on the same weights, clouds and dropout masks.

The whole step runs JAX's make_train_step jitted, with two adjustments
that its docstrings explain, each with a test of its own: PointNet++'s max
over each ball is taken as an argmax gather (TieSafeMax: XLA's jitted
gradient of a max after train-mode BN is wrong on the CPU,
test_jitted_max_after_train_bn_gradient), and the frozen iDispNet's last
classifier is scaled down so that the clouds are car-sized
(flatten_disparity; on the unflattened clouds
test_rpn_grads_on_deep_clouds_float64_witness holds both packages'
float32 gradients to the port's float64 ones).

Flax draws its dropout masks from make_rng("dropout"), keyed by module
path; the tests do not re-derive them. They copy each Dropout's output out
of the JAX run (flax.linen.intercept_methods) and take its keep mask as
output != 0: where a ReLU output is 0 the mask changes neither the value
nor the gradient.

All float32 but the witness's float64 run. Tolerances (stated in CHANGES.md):
- SharedMLP and ConvHead train forward: max |diff| <= 1e-5 * max |JAX| +
  1e-6, their running statistics 1e-5 * max + 1e-6, the input gradient
  1e-4 * max + 1e-6;
- the point labels: cls exactly, reg 1e-6 * max + 1e-6;
- the jitted max (C25): the unjitted and the argmax gradients within 1e-4
  * max of central differences in float64, the jitted one off by more
  than 1e-2 * max;
- rpn_loss: the losses within 1e-6 relative, their gradients 1e-5 * max +
  1e-7;
- the eval forward: disparity 2e-3 px, roi_ok exactly (as
  test_torch_disprcnn3d.py holds them);
- the whole step: the losses within 1e-5 relative, the RPN gradients, the
  momentum traces and the updates (new - old parameter) in
  test_torch_train.py's L2 form (per tensor relative L2 1e-2 and max
  |diff| 5e-2 * max |JAX|, all tensors together 5e-3; the updates' bounds
  widened by one float32 spacing of the new parameters), the updated BN
  running statistics 1e-5 * max + 1e-6, iDispNet's parameters and buffers
  bit-equal before and after;
- the float64 witness (C26): the port's float32 gradients in C19's form
  of its float64 ones, JAX's within relative L2 1e-1 per tensor and 3e-2
  together, and farther than the port's; the losses 1e-6 (float32 to
  float64) and 1e-5 (JAX) relative.
"""
import copy
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.engine import trainer as jtrainer
from disprcnn_tpu.models.detector import disprcnn3d as j3d
from disprcnn_tpu.models.pointrcnn import lift as jlift
from disprcnn_tpu.models.pointrcnn import point_rcnn as jpr
from disprcnn_tpu.models.pointrcnn import pointnet2 as jpn2
from disprcnn_tpu.models.pointrcnn import rpn3d as jrpn
from disprcnn_tpu.solver import build as jbuild
from disprcnn_tpu.solver import schedules as jsched
from disprcnn_tpu.structures.stereo import StereoBoxes as JStereoBoxes
from disprcnn_tpu_torch.engine.trainer import make_train_step
from disprcnn_tpu_torch.models.detector import disprcnn3d as t3d
from disprcnn_tpu_torch.models.pointrcnn import bbox3d_codec as tcodec
from disprcnn_tpu_torch.models.pointrcnn import lift as tlift
from disprcnn_tpu_torch.models.pointrcnn import pointnet2 as tpn2
from disprcnn_tpu_torch.models.pointrcnn import rpn3d as trpn
from disprcnn_tpu_torch.solver import build as tbuild
from disprcnn_tpu_torch.solver import schedules as tsched
from disprcnn_tpu_torch.structures.stereo import StereoBoxes
from disprcnn_tpu_torch.tools.bench_train import boxes_on_clouds
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from test_torch_train import SOLVER, check_step, close, grads_close
from torch_port_helpers import draw_variables

RPN_CODEC = jpr.PointRCNN.rpn_codec
ANCHOR = np.asarray(jpr.PointRCNN.mean_size, np.float32)


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def t(x):
    return torch.from_numpy(np.array(x))


def stats_of(tm, params, batch_stats):
    return state_dict_from_jax(tm, {"params": params, "batch_stats": batch_stats})


# -- train-mode BN: SharedMLP and the RPN heads ----------------------------------

@pytest.mark.parametrize("shape", [(2, 12, 16, 20), (2, 40, 20)], ids=["grouped", "fp"])
def test_shared_mlp_train_matches_flax(shape):
    """SharedMLP with BN in train mode on a grouped (B, M, S, C) input and
    an FP-shaped (B, N, C) one (JAX's (B, N, 1, C)): the value, the updated
    running statistics and the input gradient under a non-uniform output
    gradient."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    jx = x if len(shape) == 4 else x[:, :, None, :]
    channels = (24, 32)
    jm = jpn2.SharedMLP(channels, use_bn=True)
    v = draw_variables(jm, jnp.asarray(jx), False, seed=1)
    ct = rng.standard_normal(jx.shape[:-1] + (channels[-1],)).astype(np.float32)

    def f(vv, a):
        y, new = jm.apply(vv, a, True, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, new)

    (_, (want, new)), want_dx = jax.jit(jax.value_and_grad(f, argnums=1, has_aux=True))(
        v, jnp.asarray(jx))
    tm = load_jax_variables(tpn2.SharedMLP(channels, shape[-1]), v)
    tm.train()
    tx = t(x).requires_grad_(True)
    got = tm(tx)
    got.backward(t(ct.reshape(got.shape)))
    close(got.detach().numpy(), np.asarray(want).reshape(got.shape), 1e-5, 1e-6, "value")
    close(tx.grad.numpy(), np.asarray(want_dx).reshape(x.shape), 1e-4, 1e-6, "dx")
    want_stats = stats_of(tm, v["params"], new["batch_stats"])
    before = stats_of(tm, v["params"], v["batch_stats"])
    running = {n: b for n, b in tm.named_buffers() if "running" in n}
    assert len(running) == 2 * len(channels)
    for n, b in running.items():
        close(b.numpy(), want_stats[n].numpy(), 1e-5, 1e-6, n)
        assert not torch.equal(b, before[n]), n


def dropout_recorder(record):
    """A flax.linen.intercept_methods interceptor that copies every
    Dropout's output, and the inputs of every PointRCNN call, into
    `record` (by module path) when the run executes."""
    def icpt(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        path = "/".join(context.module.scope.path)
        if isinstance(context.module, fnn.Dropout):
            jax.debug.callback(lambda o: record.__setitem__(path, np.array(o)), out)
        elif isinstance(context.module, jpr.PointRCNN) and context.method_name == "__call__":
            arrays = list(args[:4]) + [kwargs["gt_boxes3d"], kwargs["gt_ok"]]
            jax.debug.callback(
                lambda *a: record.__setitem__(path, [np.array(x) for x in a]), *arrays)
        return out
    return icpt


def test_conv_head_train_matches_flax():
    """The RPN head in train mode: fc0, train BN, ReLU, dropout 0.5 on the
    masks JAX drew, out: the value, the running statistics and the input
    gradient."""
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((3, 50, 16)).astype(np.float32)
    jm = jrpn.ConvHead((32,), 7)
    v = draw_variables(jm, jnp.asarray(feats), seed=3)
    ct = rng.standard_normal((3, 50, 7)).astype(np.float32)
    drawn = {}

    def f(vv, a):
        with fnn.intercept_methods(dropout_recorder(drawn)):
            y, new = jm.apply(vv, a, True, rngs={"dropout": jax.random.PRNGKey(5)},
                              mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, new)

    (_, (want, new)), want_dx = jax.jit(jax.value_and_grad(f, argnums=1, has_aux=True))(
        v, jnp.asarray(feats))
    jax.block_until_ready(want)
    keep = drawn["Dropout_0"] != 0
    assert 0.2 < keep.mean() < 0.5  # half of the positive ReLU outputs
    tm = load_jax_variables(trpn.ConvHead((32,), 7, 16), v)
    tm.train()
    tx = t(feats).requires_grad_(True)
    with pytest.raises(ValueError, match="keep mask"):
        tm(tx)
    got = tm(tx, t(keep))
    got.backward(t(ct))
    close(got.detach().numpy(), want, 1e-5, 1e-6, "value")
    close(tx.grad.numpy(), want_dx, 1e-4, 1e-6, "dx")
    want_stats = stats_of(tm, v["params"], new["batch_stats"])
    for n in ("bn0.running_mean", "bn0.running_var"):
        close(dict(tm.named_buffers())[n].numpy(), want_stats[n].numpy(), 1e-5, 1e-6, n)
    tm.eval()  # eval: no dropout, the updated running statistics
    with torch.no_grad():
        ev = tm(t(feats))
    close(ev.numpy(), jm.apply({"params": v["params"], "batch_stats": new["batch_stats"]},
                               jnp.asarray(feats), False), 1e-5, 1e-6, "eval")


def test_rpn_draws_keep_half():
    d = trpn.draw_rpn_draws(4, 300, torch.Generator().manual_seed(0))
    assert d.cls_keep.shape == d.reg_keep.shape == (4, 300, 128)
    assert d.cls_keep.dtype == torch.bool and abs(float(d.cls_keep.float().mean()) - 0.5) < 0.01
    assert not torch.equal(d.cls_keep, d.reg_keep)


def test_bn_train_route_takes_no_kernel(monkeypatch):
    """A train-mode Pointnet2MSG with BN runs forward and backward with
    every PointNet++ kernel entry point made to raise: the SA kernel and
    its train form, the grouped MLP and FP never run; its eval forward does
    reach them."""
    def boom(*a, **k):
        raise AssertionError("a kernel entry point ran in train mode with BN")

    m = tpn2.Pointnet2MSG(npoints=(64, 16), in_features=0)
    torch.manual_seed(0)
    xyz = torch.randn(2, 64, 3) * 0.6
    for name in ("sa_ball_mlp_max", "sa_ball_mlp_max_train", "grouped_mlp_max", "fp_fused"):
        monkeypatch.setattr(tpn2, name, boom)
    m.train()
    _, feats = m(xyz)
    feats.square().sum().backward()
    assert all(p.grad is not None for p in m.parameters())
    m.eval()
    with torch.no_grad(), pytest.raises(AssertionError, match="kernel entry point"):
        m(xyz)


def test_rpn_head_step_groups_and_nonfinite_restore():
    """The optimizer puts a BN's scale (weight) with the weights and its
    shift (bias) with the biases, as JAX's _is_bias does with Flax's
    scale and bias; a step whose loss is not finite leaves the parameters
    and the train-mode BN's running statistics as they were, and a finite
    one moves both."""
    head = trpn.ConvHead((8,), 3, 5)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.head = head

        def forward(self, x, keep, scale):
            return {"loss": self.head(x, keep).square().mean() * scale}

    net = Net()
    opt = tbuild.make_optimizer(net, tsched.one_cycle(BASE_LR, MAX_ITER),
                                tsched.one_cycle_momentum(MAX_ITER))
    kinds = {id(p): g["kind"] for g in opt.sgd.param_groups for p in g["params"]}
    assert kinds[id(head.bn0.weight)] == "base" and kinds[id(head.bn0.bias)] == "bias"
    assert kinds[id(head.fc0.weight)] == "base" and kinds[id(head.out.bias)] == "bias"
    step = make_train_step(net, opt)
    gen = torch.Generator().manual_seed(1)
    batch = dict(x=torch.randn(2, 6, 5, generator=gen),
                 keep=torch.rand(2, 6, 8, generator=gen) < 0.5)
    state = [t.detach().clone() for t in [*net.parameters(), *net.buffers()]]
    m = step(dict(batch, scale=float("nan")))
    assert float(m["skipped_nonfinite"]) == 1 and opt.count == 0 and step.count == 1
    assert all(torch.equal(a, b) for a, b in zip([*net.parameters(), *net.buffers()], state))
    m = step(dict(batch, scale=1.0))
    assert float(m["skipped_nonfinite"]) == 0 and opt.count == 1
    assert not torch.equal(head.bn0.running_mean, state[-3])
    assert not torch.equal(head.fc0.weight, state[0])


# -- the point labels and the loss ---------------------------------------------------

def label_scene(seed, r=4, n=200):
    """Clouds about car-sized boxes (yawed), with points inside, in the
    0.2 band around and outside each; the last instance without GT."""
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(-1, 1, (r, 3)), rng.uniform(1.3, 1.8, (r, 1)),
                            rng.uniform(1.4, 1.9, (r, 1)), rng.uniform(3.2, 4.5, (r, 1)),
                            rng.uniform(-3, 3, (r, 1))], -1).astype(np.float32)
    pts = (boxes[:, None, 0:3] + rng.standard_normal((r, n, 3)) * [1.4, 0.7, 1.4])
    pts[..., 1] -= boxes[:, None, 3] / 2
    gt_ok = np.arange(r) < r - 1
    return pts.astype(np.float32), boxes, gt_ok


def test_rpn_point_labels_match_jax():
    pts, boxes, gt_ok = label_scene(4)
    want = jax.jit(jlift.rpn_point_labels)(jnp.asarray(pts), jnp.asarray(boxes),
                                           jnp.asarray(gt_ok))
    got = tlift.rpn_point_labels(t(pts), t(boxes), t(gt_ok))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    close(got[1].numpy(), want[1], 1e-6, 1e-6, "reg_label")
    cls = np.asarray(want[0])
    assert (cls[:-1] == 1).any() and (cls[:-1] == -1).any() and (cls[:-1] == 0).any()
    assert (cls[-1] == 0).all()


def test_rpn_loss_matches_jax():
    """The BCE classification loss (rpn.yaml's RPN.LOSS_CLS, the port's
    only one) and the bin-based regression on labels from
    rpn_point_labels, one instance invalid: the two losses and their
    gradients in the predictions."""
    pts, boxes, gt_ok = label_scene(5)
    cls_label, reg_label = (np.asarray(a) for a in jlift.rpn_point_labels(
        jnp.asarray(pts), jnp.asarray(boxes), jnp.asarray(gt_ok)))
    rng = np.random.default_rng(6)
    r, n = cls_label.shape
    cls = (rng.standard_normal((r, n)) * 2).astype(np.float32)
    reg = rng.standard_normal((r, n, RPN_CODEC.reg_channels)).astype(np.float32)
    valid = np.array([True, True, False, True])

    def f(c, g):
        out = jrpn.rpn_loss(c, g, jnp.asarray(cls_label), jnp.asarray(reg_label),
                            jnp.asarray(valid), jnp.asarray(ANCHOR), RPN_CODEC,
                            loss_cls="BinaryCrossEntropy")
        return out["loss_rpn_cls"] + 2 * out["loss_rpn_reg"], out

    (_, want), want_g = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(
        jnp.asarray(cls), jnp.asarray(reg))
    tc, tg = t(cls).requires_grad_(True), t(reg).requires_grad_(True)
    got = trpn.rpn_loss(tc, tg, t(cls_label), t(reg_label), t(valid), t(ANCHOR),
                        tcodec.CodecCfg(*RPN_CODEC))
    (got["loss_rpn_cls"] + 2 * got["loss_rpn_reg"]).backward()
    for k in ("loss_rpn_cls", "loss_rpn_reg"):
        w = float(want[k])
        g = float(got[k].detach())
        assert w > 0 and abs(g - w) <= 1e-6 * abs(w), (k, g, w)
    close(tc.grad.numpy(), want_g[0], 1e-5, 1e-7, "d cls")
    close(tg.grad.numpy(), want_g[1], 1e-5, 1e-7, "d reg")


# -- the stage at test size: eval without the RCNN, one whole step -----------------------

# rpn.yaml at test size: 1 pair of 96x160, 3 detections (the third without
# GT), crops of 32^2, disparity -16..16 and one hourglass (frozen), clouds
# of 128 points, SA ladder 128/64/16, MASK_THRESH 0.5, BCE, RPN training,
# RCNN disabled; rpn.yaml's solver: OneCycle BASE_LR 0.002 over MAX_ITER
# 27600, grad clip 10, FIX_DISPARITY
RPN_MODEL = dict(max_det=3, roi_size=32, maxdisp=16, mindisp=-16, det3d_on=True, npoints=128,
                 lift_grid=32, sa_npoints=(128, 64, 16), psm_hourglass=1,
                 mask_thresh_train=0.5, mask_thresh_eval=0.5, rcnn_enabled=False)
RAW_HW = (96, 160)
CALIB = dict(fu=721.5, fv=721.5, cu=80.0, cv=48.0, tx=0.0, ty=0.0, fuxb=389.6)
BASE_LR, MAX_ITER = 0.002, 27600
RPN_PATH = "pointrcnn"


def stage_inputs():
    rng = np.random.default_rng(8)
    left = np.asarray([[[10.3, 20.7, 70.2, 60.9], [80.5, 30.1, 131.4, 75.6],
                        [40.2, 15.3, 96.8, 80.1]]], np.float32)
    right = left - np.asarray([30.0, 0.0, 28.9, 0.0], np.float32)
    mask = rng.uniform(size=(1, 3, 28, 28)).astype(np.float32)
    raw = [rng.uniform(0, 1, (1,) + RAW_HW + (3,)).astype(np.float32) for _ in range(2)]
    return left, right, mask, raw


def flatten_disparity(v):
    """Scale the frozen iDispNet's last classifier conv by 0.1, so that its
    disparity is smooth about the middle of its range and each instance
    lifts to a car-sized cloud about 13 m away (the boxes' 30 px
    left-right shift). A random iDispNet's disparity spans the whole range
    and lifts clouds 9-12 m deep, on which JAX's float32 gradients lie up
    to ~3e-2 (relative L2, per tensor) from the port's float64 ones, past
    C19's per-tensor bound, while the port's float32 ones lie within
    ~2.4e-3 (test_rpn_grads_on_deep_clouds_float64_witness)."""
    last = v["params"]["idispnet"]["classif1_1"]
    last["kernel"] = np.asarray(last["kernel"]) * 0.1


@pytest.fixture(scope="module")
def stage():
    """The JAX DispRCNN3D of the stage, its numpy-drawn variables, the
    detections and the batch both packages take."""
    left, right, mask, raw = stage_inputs()
    jm = j3d.DispRCNN3D(**RPN_MODEL)
    jd = JStereoBoxes(left=jnp.asarray(left), right=jnp.asarray(right),
                      score=jnp.asarray([[0.9, 0.8, 0.7]]), valid=jnp.ones((1, 3), bool),
                      fields={"mask": jnp.asarray(mask)})
    calib = {k: jnp.full((1,), val, jnp.float32) for k, val in CALIB.items()}
    v = draw_variables(jm, jnp.asarray(raw[0]), jnp.asarray(raw[1]), jd, calib, seed=9,
                       train=False)
    assert "rcnn" not in v["params"]["pointrcnn"]
    deep = jax.tree_util.tree_map(lambda a: a, v)  # the random iDispNet's own disparity
    flatten_disparity(v)
    tdets = StereoBoxes(left=t(left), right=t(right), score=t([[0.9, 0.8, 0.7]]),
                        valid=torch.ones(1, 3, dtype=torch.bool), fields={"mask": t(mask)})
    return types.SimpleNamespace(jm=jm, v=v, deep=deep, jd=jd, calib=calib, left=left,
                                 raw=raw, tdets=tdets)


def test_rcnn_disabled_eval_matches_jax(stage):
    """rcnn_enabled=False: the JAX variables (no rcnn subtree) load, and the
    eval forward gives JAX's disparity and roi_ok, and no box3d."""
    s = stage
    drawn = []
    orig = jlift.sample_fixed_points

    def sample(key, pts, valid, npoints):
        r, c = valid.shape
        pri = jax.vmap(lambda k: jax.random.uniform(k, (c,)))(jax.random.split(key, r))
        jax.debug.callback(lambda p: drawn.append(np.array(p)), pri)
        return orig(key, pts, valid, npoints)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlift, "sample_fixed_points", sample)
        want = jax.jit(lambda vv, a, b, dd: s.jm.apply(
            vv, a, b, dd, s.calib, train=False, rngs={"sampling": jax.random.PRNGKey(7)}))(
            s.v, jnp.asarray(s.raw[0]), jnp.asarray(s.raw[1]), s.jd)
        want = jax.tree_util.tree_map(np.asarray, want)
    assert set(want) == {"disparity_roi", "roi_ok"} and want["roi_ok"].all()
    tm = load_jax_variables(t3d.DispRCNN3D(**RPN_MODEL, device="cpu"), s.v)
    assert not hasattr(tm.pointrcnn, "rcnn")
    with torch.no_grad():
        got = tm(t(s.raw[0]), t(s.raw[1]), s.tdets,
                 {k: torch.full((1,), val) for k, val in CALIB.items()}, t(drawn[0]))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["disparity_roi"].numpy(), want["disparity_roi"], rtol=0,
                               atol=2e-3)
    np.testing.assert_array_equal(got["roi_ok"].numpy(), want["roi_ok"])
    with torch.no_grad():  # PointRCNN alone returns the RPN's scores
        out = tm.pointrcnn(t(np.zeros((2, 128, 3), np.float32)) + torch.randn(2, 128, 3),
                           torch.ones(2, dtype=torch.bool), torch.zeros(2), torch.zeros(2, 3))
    assert set(out) == {"rpn_cls"} and out["rpn_cls"].shape == (2, 128)


class TieSafeMax:
    """jax.numpy, but its max over an axis is the element that argmax picks
    (the same value). Under jit on the CPU, XLA's gradient of a max over
    the ball after a Dense and train-mode BN is wrong at an SA level's
    sizes (ROADMAP C25, test_jitted_max_after_train_bn_gradient): off from
    central differences, where the unjitted gradient and this form agree
    with them. Where the maximum repeats (a ball query's padded slots,
    copies of one point), the argmax form sends the whole gradient to one
    copy, the even split's sum: through BN and the MLP the copies' rows
    are equal, so every parameter's gradient is the same."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def max(x, axis=None, **kwargs):
        if axis is None or kwargs:
            return jnp.max(x, axis, **kwargs)
        i = jnp.expand_dims(jnp.argmax(x, axis), axis)
        return jnp.take_along_axis(x, i, axis).squeeze(axis)


@pytest.mark.parametrize("slots", ["padded", "distinct"])
def test_jitted_max_after_train_bn_gradient(slots):
    """ROADMAP C25, the reason for TieSafeMax, at one SA level's sizes: 3
    clouds x 64 balls x 32 slots (each ball padded with copies of its
    first point, as a ball query pads it, or every slot distinct: ties are
    not the cause), 11 input channels, 128 out; Dense, train-mode BN, ReLU,
    max over the ball. The gradient in the weights, BN's scale and shift,
    read in the shift: XLA's jitted one is off from central differences in
    float64; the unjitted one and the jitted argmax form (TieSafeMax.max)
    agree with them. If the first assert
    fails, the jitted max is right and TieSafeMax can go."""
    rng = np.random.default_rng(11)
    b, m, s, c, o = 3, 64, 32, 11, 128
    x = rng.standard_normal((b, m, s, c)).astype(np.float32)
    for i, j in np.ndindex(b, m):
        if slots == "padded":
            x[i, j, rng.integers(1, 5):] = x[i, j, 0]
    w = (rng.standard_normal((c, o)) / np.sqrt(c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, o).astype(np.float32)
    shift = (rng.standard_normal(o) * 0.1).astype(np.float32)
    ct = rng.standard_normal((b, m, o)).astype(np.float32)

    def f(w, scale, shift, max_=jnp.max):
        y = x @ w
        mean = y.mean((0, 1, 2))
        var = jnp.maximum((y * y).mean((0, 1, 2)) - mean * mean, 0.0)
        y = jax.nn.relu((y - mean) * jax.lax.rsqrt(var + 1e-5) * scale + shift)
        return jnp.sum(max_(y, axis=2) * ct)

    def f64(sh):
        y = x.astype(np.float64) @ w.astype(np.float64)
        mean = y.mean((0, 1, 2))
        var = np.maximum((y * y).mean((0, 1, 2)) - mean * mean, 0.0)
        return (np.maximum((y - mean) / np.sqrt(var + 1e-5) * scale + sh, 0.0).max(2) * ct).sum()

    h, fd, sh = 1e-6, np.zeros(o), shift.astype(np.float64)
    for k in range(o):
        e = np.zeros(o)
        e[k] = h
        fd[k] = (f64(sh + e) - f64(sh - e)) / (2 * h)

    def err(grad):
        g = np.asarray(grad(w, scale, shift)[2], np.float64)
        return np.abs(g - fd).max() / np.abs(fd).max()

    jitted = err(jax.jit(jax.grad(f, (0, 1, 2))))
    eager = err(jax.grad(f, (0, 1, 2)))
    argmax = err(jax.jit(jax.grad(lambda *a: f(*a, max_=TieSafeMax.max), (0, 1, 2))))
    print(f"C25, {slots}: |grad - central differences| / max: jitted {jitted:.3g}, unjitted "
          f"{eager:.3g}, jitted argmax {argmax:.3g}")
    assert jitted > 1e-2, jitted
    assert eager < 1e-4 and argmax < 1e-4, (eager, argmax)


def updates_close(got: dict, want: dict, old: dict):
    """The updates new - old of the port and of JAX in grads_close's L2
    form, each bound widened by one float32 spacing of the new values
    (old + update is rounded on either side: at OneCycle's first rate an
    update of ~1e-6 on a parameter of ~1 is ~10 spacings)."""
    num = den = room = 0.0
    for k in want:
        g, w, o = (np.asarray(a, np.float64) for a in (got[k], want[k], old[k]))
        ulp = np.spacing(np.maximum(np.abs(got[k]), np.abs(want[k])).astype(np.float32))
        ulp = ulp.astype(np.float64)
        d2, w2, u2 = ((g - w) ** 2).sum(), ((w - o) ** 2).sum(), (ulp ** 2).sum()
        assert np.sqrt(d2) <= 1e-2 * np.sqrt(w2) + np.sqrt(u2), (k, np.sqrt(d2), np.sqrt(w2))
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w - o).max() + ulp.max(), k
        num, den, room = num + d2, den + w2, room + u2
    assert np.sqrt(num) <= 5e-3 * np.sqrt(den) + np.sqrt(room), (np.sqrt(num), np.sqrt(den))


def jax_rpn_step(s):
    """JAX's make_train_step for the stage (grad clip 10, idispnet frozen),
    jitted with the lift's priorities, the PointRCNN inputs and the heads'
    dropout outputs copied out of each run."""
    drawn = {}
    orig_sample = jlift.sample_fixed_points

    def sample(key, pts, valid, npoints):
        r, c = valid.shape
        pri = jax.vmap(lambda k: jax.random.uniform(k, (c,)))(jax.random.split(key, r))
        jax.debug.callback(lambda p: drawn.__setitem__("priorities", np.array(p)), pri)
        return orig_sample(key, pts, valid, npoints)

    frozen = ("idispnet",)
    cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(**SOLVER))
    sched = jsched.one_cycle(BASE_LR, MAX_ITER)
    tx = jbuild.make_optimizer(cfg, s.v["params"], sched, frozen,
                               momentum_schedule=jsched.one_cycle_momentum(MAX_ITER))
    state = jtrainer.create_train_state(s.jm, tx, s.v)
    step = jtrainer.make_train_step(s.jm, tx, do_grad_clip=True, grad_clip=10.0,
                                    apply_kwargs=dict(train_psm=False, train_pc=True),
                                    stop_grad_prefixes=frozen)

    @jax.jit
    def run_step(st, batch):
        with fnn.intercept_methods(dropout_recorder(drawn)):
            return step(st, batch, jax.random.PRNGKey(3))

    def run(batch):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jlift, "sample_fixed_points", sample)
            mp.setattr(jpn2, "jnp", TieSafeMax())
            out = run_step(state, batch)
            jax.block_until_ready(out)
        return out, dict(drawn)

    return run, float(sched(0))


def test_rpn_train_step_matches_jax(stage, monkeypatch):
    """One DispRCNN3D stage-3 step: iDispNet frozen, the lift, the RPN in
    train mode (BN batch statistics through PointNet++ and the heads,
    dropout), the point labels, the BCE and bin-based losses, the backward,
    the gradient clip and SGD with OneCycle, against JAX's make_train_step
    on the same weights, priorities and dropout masks. The port's clouds
    and matched GT are held to JAX's first; the RPN then trains on JAX's
    (the frozen iDispNet's float32 differences, ~1e-4 in the points, tip
    FPS and ball selections now and then, ROADMAP C16). Each instance's GT
    is a box on its own cloud (a first JAX run gives the clouds;
    bench_train.boxes_on_clouds), so that
    points are labelled positive and ignored and the regression has
    targets. No PointNet++ kernel entry point runs."""
    s = stage
    batch = dict(left_img=jnp.asarray(s.raw[0]), right_img=jnp.asarray(s.raw[1]), dets=s.jd,
                 calib=s.calib, gt_left=jnp.asarray(s.left),
                 gt_valid=jnp.asarray([[True, True, False]]))
    run, lr = jax_rpn_step(s)
    _, first = run(dict(batch, gt_boxes3d=jnp.zeros((1, 3, 7))))
    pts_c, _, angles, pts_mean, _, _ = first[RPN_PATH]
    gt = boxes_on_clouds(t(pts_c), t(angles), t(pts_mean)).numpy()[None]  # (1, 3, 7)
    (new_state, metrics), drawn = run(dict(batch, gt_boxes3d=jnp.asarray(gt)))
    np.testing.assert_array_equal(drawn["priorities"], first["priorities"])
    j_in = drawn[RPN_PATH]
    assert j_in[1].all() and j_in[5].tolist() == [True, True, False]
    cls_label = np.asarray(jlift.rpn_point_labels(
        jnp.asarray(j_in[0]), jlift.canonicalize_boxes3d(*(jnp.asarray(a) for a in (
            j_in[4], j_in[2], j_in[3]))), jnp.asarray(j_in[5]))[0])
    assert (cls_label == 1).sum() >= 5 and (cls_label == -1).sum() >= 1, \
        ((cls_label == 1).sum(), (cls_label == -1).sum())
    keep = {h: drawn[f"{RPN_PATH}/rpn/{h}/Dropout_0"] != 0 for h in ("cls_head", "reg_head")}
    rpn_draws = trpn.RPNDraws(cls_keep=t(keep["cls_head"]), reg_keep=t(keep["reg_head"]))

    def boom(*a, **k):
        raise AssertionError("a PointNet++ kernel entry point ran in the RPN step")

    for name in ("sa_ball_mlp_max", "sa_ball_mlp_max_train", "grouped_mlp_max", "fp_fused"):
        monkeypatch.setattr(tpn2, name, boom)
    tm = load_jax_variables(t3d.DispRCNN3D(**RPN_MODEL, device="cpu"), s.v)
    frozen = tbuild.frozen_path_prefixes(FIX_DISPARITY=True)
    assert frozen == ("idispnet",)
    opt = tbuild.make_optimizer(tm, tsched.one_cycle(BASE_LR, MAX_ITER),
                                tsched.one_cycle_momentum(MAX_ITER), frozen, momentum=0.9,
                                weight_decay=1e-4, weight_decay_bias=0.0, bias_lr_factor=2.0)
    old = {n: p.detach().clone() for n, p in tm.named_parameters()}
    old_buffers = {n: b.clone() for n, b in tm.named_buffers()}
    step = make_train_step(tm, opt, do_grad_clip=True, grad_clip=10.0,
                           forward_kwargs=dict(train_pc=True))
    seen = []
    orig = tm.pointrcnn.forward

    def on_jax_clouds(*args):
        seen.append([a.detach().clone() for a in args[:6]])
        return orig(*(t(a) for a in j_in), *args[6:])

    tm.pointrcnn.forward = on_jax_clouds
    got = step(dict(left_img=t(s.raw[0]), right_img=t(s.raw[1]), dets=s.tdets,
                    calib={k: torch.full((1,), val) for k, val in CALIB.items()},
                    priorities=t(drawn["priorities"]), gt_left=t(s.left), gt_boxes3d=t(gt),
                    gt_valid=t([[True, True, False]]), rpn_draws=rpn_draws))
    mine = seen[0]
    for i in (1, 5):  # roi_ok, gt_ok
        np.testing.assert_array_equal(mine[i].numpy(), j_in[i])
    for i, what in ((0, "clouds"), (2, "angles"), (3, "pts_mean"), (4, "gt")):
        close(mine[i].numpy(), j_in[i], 1e-3, 1e-3, what)
    for k in ("loss_rpn_cls", "loss_rpn_reg"):
        w = float(metrics[k])
        assert w > 0 and abs(float(got[k]) - w) <= 1e-5 * w, (k, float(got[k]), w)
    names = check_step(tm, old, opt, got, metrics, new_state, s.v, lr)
    rpn_params = [n for n, _ in tm.pointrcnn.rpn.named_parameters()]
    assert sorted(names) == sorted(f"pointrcnn.rpn.{n}" for n in rpn_params)
    new = stats_of(tm, new_state.params, s.v["batch_stats"])
    params = dict(tm.named_parameters())
    updates_close({n: params[n].detach().numpy() for n in names},
                  {n: new[n].numpy() for n in names}, {n: old[n].numpy() for n in names})
    want_stats = stats_of(tm, s.v["params"], new_state.batch_stats)
    buffers = dict(tm.named_buffers())
    running = [n for n in buffers if n.startswith("pointrcnn.rpn.") and "running" in n]
    assert len(running) > 50
    for n in running:
        close(buffers[n].numpy(), want_stats[n].numpy(), 1e-5, 1e-6, n)
        assert not torch.equal(buffers[n], old_buffers[n]), n
    for n, b in buffers.items():
        if n.startswith("idispnet."):
            assert torch.equal(b, old_buffers[n]), n
    for n, p in params.items():
        if n.startswith("idispnet."):
            assert torch.equal(p.detach(), old[n]), n


class _Captured(Exception):
    pass


def test_rpn_grads_on_deep_clouds_float64_witness(stage):
    """ROADMAP C26, on the clouds the random iDispNet itself lifts (not
    flattened): the RPN loss's gradients of the port in float32 and of
    JAX's jitted PointRCNN in float32 (TieSafeMax, on the same clouds, GT
    and dropout masks), each held to the port's own float64 run. The port's
    float32 gradients lie within C19's form of the float64 ones; JAX's lie
    farther, and the port's distance is the smaller: where JAX's and the
    port's float32 gradients part on such clouds, the part is on JAX's side
    and not a divergence of the port. The float64 run takes the float32
    run's point labels (a label or a bin at its edge may fall the other
    way in float64) and its losses are within 1e-6 of float32's."""
    s = stage
    tm = load_jax_variables(t3d.DispRCNN3D(**RPN_MODEL, device="cpu"), s.deep)
    prc = tm.pointrcnn
    seen = []

    def capture(*args):
        seen.append([a.detach() for a in args[:4]])
        raise _Captured

    prc.forward = capture
    tm.train()
    with pytest.raises(_Captured):
        tm(t(s.raw[0]), t(s.raw[1]), s.tdets,
           {k: torch.full((1,), val) for k, val in CALIB.items()},
           generator=torch.Generator().manual_seed(0), gt_left=t(s.left),
           gt_boxes3d=torch.zeros(1, 3, 7), gt_valid=t([[True, True, False]]), train_pc=True)
    del prc.forward
    pts, roi_ok, angles, pts_mean = seen[0]
    gt, gt_ok = boxes_on_clouds(pts, angles, pts_mean), t([True, True, False])

    jp = jpr.PointRCNN(npoints=RPN_MODEL["npoints"], sa_npoints=RPN_MODEL["sa_npoints"],
                       rcnn_enabled=False)
    pv = {"params": s.deep["params"]["pointrcnn"],
          "batch_stats": s.deep["batch_stats"]["pointrcnn"]}
    drawn = {}

    def loss(p):
        with fnn.intercept_methods(dropout_recorder(drawn)):
            out, _ = jp.apply({"params": p, "batch_stats": pv["batch_stats"]},
                              *(jnp.asarray(a.numpy()) for a in (pts, roi_ok, angles, pts_mean)),
                              train=True, gt_boxes3d=jnp.asarray(gt.numpy()),
                              gt_ok=jnp.asarray(gt_ok.numpy()),
                              rngs={"dropout": jax.random.PRNGKey(4)}, mutable=["batch_stats"])
        return out["loss_rpn_cls"] + out["loss_rpn_reg"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpn2, "jnp", TieSafeMax())
        jloss, jgrad = jax.jit(jax.value_and_grad(loss))(pv["params"])
        jax.block_until_ready(jgrad)
    keep = {h: t(drawn[f"rpn/{h}/Dropout_0"] != 0) for h in ("cls_head", "reg_head")}
    draws = trpn.RPNDraws(cls_keep=keep["cls_head"], reg_keep=keep["reg_head"])
    jax_g = state_dict_from_jax(prc, {"params": jgrad, "batch_stats": pv["batch_stats"]})

    cls_label, reg_label = tlift.rpn_point_labels(
        pts, tlift.canonicalize_boxes3d(gt, angles, pts_mean), gt_ok)

    def port(dtype):  # PointRCNN.rpn_train_loss, on float32's labels
        m = copy.deepcopy(prc).to(dtype)
        m.train()
        rpn = m.rpn(pts.to(dtype), draws)
        out = trpn.rpn_loss(rpn["cls"], rpn["reg"], cls_label, reg_label.to(dtype),
                            roi_ok & gt_ok, m.anchor, m.rpn_codec)
        (out["loss_rpn_cls"] + out["loss_rpn_reg"]).backward()
        return out, {n: p.grad.double().numpy() for n, p in m.named_parameters()}

    (l32, g32), (l64, g64) = port(torch.float32), port(torch.float64)
    l32, l64 = ({k: float(v.detach()) for k, v in out.items()} for out in (l32, l64))
    assert (pts[..., 2].amax(1) - pts[..., 2].amin(1) > 5.0).all()  # not car-sized
    for k in l64:
        assert abs(l32[k] - l64[k]) <= 1e-6 * l64[k], k
    total = l64["loss_rpn_cls"] + l64["loss_rpn_reg"]
    assert abs(float(jloss) - total) <= 1e-5 * total

    def dist(g):
        per = {n: np.linalg.norm(g[n] - g64[n]) / np.linalg.norm(g64[n]) for n in g64}
        num = sum(np.square(g[n] - g64[n]).sum() for n in g64)
        return max(per.values()), np.sqrt(num / sum(np.square(v).sum() for v in g64.values()))

    port_d = dist(g32)
    jax_d = dist({n: v.numpy().astype(np.float64) for n, v in jax_g.items()})
    print(f"C26: relative L2 from the port's float64 gradients, worst tensor and all: "
          f"port float32 {port_d[0]:.3g} {port_d[1]:.3g}, JAX float32 {jax_d[0]:.3g} "
          f"{jax_d[1]:.3g}")
    grads_close(g32, g64)
    assert jax_d[0] <= 1e-1 and jax_d[1] <= 3e-2, jax_d
    assert port_d[1] < jax_d[1], (port_d, jax_d)
