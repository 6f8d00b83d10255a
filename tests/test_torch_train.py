"""The port's train path for the iDispNet stage (configs/kitti/car/vob/
idispnet.yaml, TRAIN_PSM) against the JAX package on the CPU, at small
sizes: row 8's train form (the plain version against the Pallas kernel in
interpret mode, and its autograd Function with its launch points routed to
the plain versions), the losses, the schedules, the optimizer against
optax, the train-time detection filters and GT warp, and one whole train
step against JAX's make_train_step on the same weights.

All float32. Tolerances (stated in CHANGES.md, with their reasons):
- one conv (value, dx, dk): max |diff| <= 1e-4 * max |JAX| + 1e-5;
- the Function against autograd of the plain version: 1e-5 * max + 1e-6;
- schedules rtol 1e-6 + atol 1e-6 * their peak (JAX's float32 sums
  cancel); the optimizer over 3 steps 1e-5 * max + 1e-7;
- losses and the GT warp: 1e-5 * max + 1e-5; masks and filters exactly;
- the whole step: losses 1e-4 * |JAX| + 1e-6, BN running statistics 1e-4
  * max + 1e-6; each gradient and each update (new - old parameter)
  within relative L2 1e-2 and max |diff| 5e-2 * max |JAX|, all of them
  together within relative L2 5e-3 (float32 flips of ReLUs at ~0 move the
  gradients of every earlier layer, on either side).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from disprcnn_tpu.engine import trainer as jtrainer
from disprcnn_tpu.models.detector import disprcnn3d as j3d
from disprcnn_tpu.ops import losses as jlosses
from disprcnn_tpu.ops.conv3d_packed import pack_depth, unpack_depth
from disprcnn_tpu.ops.pallas.packed_conv import packed_conv_train
from disprcnn_tpu.solver import build as jbuild
from disprcnn_tpu.solver import schedules as jsched
from disprcnn_tpu.structures.stereo import StereoBoxes as JStereoBoxes
from disprcnn_tpu_torch.engine.trainer import make_train_step, total_loss
from disprcnn_tpu_torch.models.detector import disprcnn3d as t3d
from disprcnn_tpu_torch.ops import losses as tlosses
from disprcnn_tpu_torch.ops.cuda import conv3d as cconv
from disprcnn_tpu_torch.solver import build as tbuild
from disprcnn_tpu_torch.solver import schedules as tsched
from disprcnn_tpu_torch.structures.stereo import StereoBoxes
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from torch_port_helpers import draw_variables

RAW_HW = (96, 160)
# idispnet.yaml's solver: SGD, WEIGHT_DECAY 1e-4, OneCycle BASE_LR 0.01
# over MAX_ITER 41000 with the momentum cycled; the defaults' MOMENTUM 0.9,
# BIAS_LR_FACTOR 2, WEIGHT_DECAY_BIAS 0
SOLVER = dict(OPTIMIZER="SGD", MOMENTUM=0.9, WEIGHT_DECAY=1e-4, WEIGHT_DECAY_BIAS=0.0,
              BIAS_LR_FACTOR=2.0)
BASE_LR, MAX_ITER = 0.01, 41000


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def close(got, want, rel, atol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * np.abs(want).max() + atol, (what, err, np.abs(want).max())


def grads_close(got: dict, want: dict):
    """Per tensor: relative L2 <= 1e-2 and max |diff| <= 5e-2 * max |JAX|;
    all tensors together: relative L2 <= 5e-3."""
    assert set(got) == set(want)
    num = den = 0.0
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        assert g.shape == w.shape and np.isfinite(g).all(), k
        d2, w2 = ((g - w) ** 2).sum(), (w ** 2).sum()
        assert np.sqrt(d2) <= 1e-2 * np.sqrt(w2) + 1e-12, (k, np.sqrt(d2 / max(w2, 1e-30)))
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max() + 1e-12, k
        num, den = num + d2, den + w2
    assert np.sqrt(num / den) <= 5e-3, np.sqrt(num / den)


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# -- row 8: the stride-1 conv's train form ------------------------------------

def test_conv3d_train_plain_matches_pallas():
    """packed_conv_train (Pallas forward in interpret mode, XLA-transpose
    backward) against the port's plain version and its autograd: the raw
    conv, dx and dk, under a non-uniform output gradient, across the
    depth-packing boundary (B 2, D 8, G 4)."""
    rng = np.random.default_rng(0)
    b, d, h, w, c, g = 2, 8, 6, 10, 4, 4
    x = normal(rng, b, d, h, w, c)
    kern = normal(rng, 3, 3, 3, c, c, scale=0.2)
    w_out = normal(rng, b, d, h, w, c)
    dg = d // g
    pack = lambda a: pack_depth(jnp.asarray(a), g).reshape(b * dg, h, w, g * c)
    unpack = lambda a: np.asarray(unpack_depth(a.reshape(b, dg, h, w, g * c), g))

    def loss(x4, k):
        y = packed_conv_train(x4, k, dg, g, 1, True)
        return jnp.sum(y * pack(w_out)), y

    (_, y_j), (dx_j, dk_j) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        pack(x), jnp.asarray(kern))
    xt = torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()).requires_grad_(True)
    kt = torch.from_numpy(kern.transpose(4, 3, 0, 1, 2).copy()).requires_grad_(True)
    y = cconv.conv3d_train(xt, kt)
    (y * torch.from_numpy(w_out.transpose(0, 4, 1, 2, 3).copy())).sum().backward()
    close(y.detach().numpy(), unpack(y_j).transpose(0, 4, 1, 2, 3), 1e-4, 1e-5, "y")
    close(xt.grad.numpy(), unpack(dx_j).transpose(0, 4, 1, 2, 3), 1e-4, 1e-5, "dx")
    close(kt.grad.numpy(), np.asarray(dk_j).transpose(4, 3, 0, 1, 2), 1e-4, 1e-5, "dk")


def test_conv3d_train_function_backward(monkeypatch):
    """The autograd Function that CUDA tensors take, with its two launch
    points routed to the plain versions: dx is the conv of dy with the
    flipped, channel-transposed weights; dk PyTorch's weight gradient."""
    monkeypatch.setattr(cconv, "conv3d_train_cuda", cconv.conv3d_train_plain)
    monkeypatch.setattr(cconv, "conv3d_train_dx_cuda", cconv.conv3d_train_dx_plain)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 4, 6, 7, generator=gen)
    w = torch.randn(5, 5, 3, 3, 3, generator=gen) * 0.2
    dy = torch.randn(2, 5, 4, 6, 7, generator=gen)
    grads = []
    for fn in (cconv._Conv3dTrain.apply, cconv.conv3d_train_plain):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xx, ww)
        y.backward(dy)
        grads.append((y.detach(), xx.grad, ww.grad))
    for got, want in zip(*grads):
        close(got.numpy(), want.numpy(), 1e-5, 1e-6)


# -- losses, schedules, optimizer ----------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(2)
    x, t = normal(rng, 64, scale=2.0), normal(rng, 64, scale=2.0)
    mask = rng.uniform(size=64) > 0.4
    tt = lambda a: torch.from_numpy(np.asarray(a))
    close(tlosses.smooth_l1(tt(x), 0.5), jlosses.smooth_l1(jnp.asarray(x), 0.5), 1e-5, 1e-5)
    close(tlosses.masked_epe(tt(x), tt(t), tt(mask)),
          jlosses.masked_epe(jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask)), 1e-5, 1e-5)
    preds = [normal(rng, 4, 8, 8, scale=3.0) for _ in range(3)]
    tgt, m = normal(rng, 4, 8, 8, scale=3.0), rng.uniform(size=(4, 8, 8)) > 0.5
    close(tlosses.psm_deep_supervision_loss([tt(p) for p in preds], tt(tgt), tt(m)),
          jlosses.psm_deep_supervision_loss(tuple(jnp.asarray(p) for p in preds),
                                            jnp.asarray(tgt), jnp.asarray(m)), 1e-5, 1e-5)
    labels = (rng.uniform(size=64) > 0.5).astype(np.float32)
    close(tlosses.sigmoid_focal_loss_binary(tt(x), tt(labels)),
          jlosses.sigmoid_focal_loss_binary(jnp.asarray(x), jnp.asarray(labels)), 1e-5, 1e-5)
    p = jax.nn.sigmoid(jnp.asarray(x))
    bce = -(labels * jnp.log(jnp.clip(p, 1e-12)) + (1 - labels) * jnp.log(jnp.clip(1 - p, 1e-12)))
    close(tlosses.binary_cross_entropy(tt(x), tt(labels)), bce, 1e-5, 1e-5)


def test_total_loss_matches_jax():
    losses = {"loss_b": 2.5, "loss_a": 0.75, "loss_c": 1.25}
    u = np.asarray([-1.0, 0.5, 0.25], np.float32)
    for uncert in (None, u):
        want = jtrainer.total_loss({k: jnp.asarray(v) for k, v in losses.items()},
                                   None if uncert is None else jnp.asarray(uncert))
        got = total_loss({k: torch.tensor(v) for k, v in losses.items()},
                         None if uncert is None else torch.from_numpy(uncert))
        close(got.numpy(), want, 1e-6, 0)


@pytest.mark.parametrize("name", ["one_cycle", "one_cycle_momentum", "warmup_linear",
                                  "warmup_constant", "constant"])
def test_schedules_match_jax(name):
    make = {
        "one_cycle": lambda m: m.one_cycle(0.01, 41000),
        "one_cycle_momentum": lambda m: m.one_cycle_momentum(62100),
        "warmup_linear": lambda m: m.warmup_multistep(0.02, (300, 700), 0.1, 1 / 3, 500,
                                                      "linear"),
        "warmup_constant": lambda m: m.warmup_multistep(0.02, (300, 700), 0.1, 1 / 3, 500,
                                                        "constant"),
        "constant": lambda m: m.constant(0.003),
    }[name]
    got, want = make(tsched), make(jsched)
    steps = (0, 1, 7, 299, 300, 499, 500, 701, 12299, 12300, 18629, 18630, 40999, 62099)
    peak = max(abs(float(want(s))) for s in steps)
    for step in steps:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-6 * peak,
                                   err_msg=str(step))


def test_make_schedule_names_match_jax():
    for sched in ("WarmupMultiStepLR", "OneCycleScheduler", "ConstantScheduler"):
        cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(
            SCHEDULER=sched, BASE_LR=0.01, MAX_ITER=1000, STEPS=(300,), GAMMA=0.1,
            WARMUP_FACTOR=1 / 3, WARMUP_ITERS=50, WARMUP_METHOD="linear"))
        got = tsched.make_schedule(sched, 0.01, 1000, (300,), 0.1, 1 / 3, 50, "linear")
        mom = tsched.make_momentum_schedule(sched, 1000)
        jmom = jsched.make_momentum_schedule(cfg)
        assert (mom is None) == (jmom is None)
        for step in (0, 40, 299, 300, 999):
            np.testing.assert_allclose(got(step), float(jsched.make_schedule(cfg)(step)),
                                       rtol=1e-6, atol=1e-6 * 0.01)
            if mom is not None:
                np.testing.assert_allclose(mom(step), float(jmom(step)), rtol=1e-6,
                                           atol=1e-6 * 0.95)


def test_frozen_path_prefixes_match_jax():
    flags = dict(FIX_DISPARITY=True, FIX_POINTRCNN_RPN=True, FIX_BACKBONE=False)
    cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(**flags))
    assert tbuild.frozen_path_prefixes(**flags) == jbuild.frozen_path_prefixes(cfg)
    assert tbuild.FIX_FLAG_PREFIXES == jbuild.FIX_FLAG_PREFIXES
    with pytest.raises(KeyError):
        tbuild.frozen_path_prefixes(FIX_NOTHING=True)


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.enc = nn.Linear(3, 4)
        self.head = nn.Linear(4, 2)
        self.norm = nn.BatchNorm1d(2)


def test_optimizer_matches_optax():
    """Three SGD updates with the JAX package's groups: weight decay on the
    weights only, twice the rate on the biases, OneCycle rate and momentum
    over 10 steps (both change every step), `enc` frozen."""
    rng = np.random.default_rng(3)
    jparams = {"enc": {"kernel": normal(rng, 3, 4), "bias": normal(rng, 4)},
               "head": {"kernel": normal(rng, 4, 2), "bias": normal(rng, 2)},
               "norm": {"scale": normal(rng, 2), "bias": normal(rng, 2)}}
    model = _Tiny()
    sd = {"enc.weight": jparams["enc"]["kernel"].T, "enc.bias": jparams["enc"]["bias"],
          "head.weight": jparams["head"]["kernel"].T, "head.bias": jparams["head"]["bias"],
          "norm.weight": jparams["norm"]["scale"], "norm.bias": jparams["norm"]["bias"]}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.ascontiguousarray(sd[n])))
    frozen = tbuild.frozen_path_prefixes(FIX_BACKBONE=False) + ("enc",)
    cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(**SOLVER))
    tx = jbuild.make_optimizer(cfg, jparams, jsched.one_cycle(0.1, 10), frozen,
                               momentum_schedule=jsched.one_cycle_momentum(10))
    opt = tbuild.make_optimizer(model, tsched.one_cycle(0.1, 10), tsched.one_cycle_momentum(10),
                                frozen, momentum=0.9, weight_decay=1e-4,
                                weight_decay_bias=0.0, bias_lr_factor=2.0)
    assert not model.enc.weight.requires_grad and model.head.weight.requires_grad
    state = tx.init(jparams)
    jp = jparams
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda a: normal(rng, *a.shape), jp)
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in model.named_parameters():
            mod, leaf = n.split(".")
            gg = g[mod][{"weight": "scale" if mod == "norm" else "kernel",
                         "bias": "bias"}[leaf]]
            p.grad = torch.from_numpy(np.ascontiguousarray(gg.T if gg.ndim == 2 else gg))
        opt.step()
        for n, p in model.named_parameters():
            mod, leaf = n.split(".")
            want = np.asarray(jp[mod][{"weight": "scale" if mod == "norm" else "kernel",
                                       "bias": "bias"}[leaf]])
            close(p.detach().numpy(), want.T if want.ndim == 2 else want, 1e-5, 1e-7, n)
    assert opt.count == 3


# -- the train-time detection filters and GT warp ------------------------------

def _dets(rng, b, d, hw=RAW_HW):
    h, w = hw
    x1, y1 = rng.uniform(0, w - 50, (b, d)), rng.uniform(0, h - 40, (b, d))
    bw, bh = rng.uniform(20, 48, (b, d)), rng.uniform(16, 38, (b, d))
    left = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    right = left.copy()
    shift = rng.uniform(4, 10, (b, d))
    right[..., 0] -= shift
    right[..., 2] -= shift
    return left, right.astype(np.float32), rng.uniform(size=(b, d, 28, 28)).astype(np.float32)


def test_remove_low_score_and_top_rois_match_jax():
    """Scores with ties (equal values and the -1 of invalid rows), the best
    two kept below the threshold, and the top-k cap over all fields."""
    rng = np.random.default_rng(4)
    left, right, mask = _dets(rng, 2, 6)
    score = np.asarray([[0.9, 0.3, 0.3, 0.7, 0.2, 0.6], [0.2, 0.1, 0.2, 0.4, 0.3, 0.2]],
                       np.float32)
    valid = np.asarray([[True, True, True, False, True, True],
                        [True, True, True, True, False, True]])
    jd = JStereoBoxes(left=jnp.asarray(left), right=jnp.asarray(right), score=jnp.asarray(score),
                      valid=jnp.asarray(valid), fields={"mask": jnp.asarray(mask)})
    td = StereoBoxes(left=torch.from_numpy(left), right=torch.from_numpy(right),
                     score=torch.from_numpy(score), valid=torch.from_numpy(valid),
                     fields={"mask": torch.from_numpy(mask)})
    jf, tf = j3d.remove_low_score_rois(jd, 0.5), t3d.remove_low_score_rois(td, 0.5)
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))

    def topk_one(dv):  # DispRCNN3D.__call__'s max_roi_train cap
        s = jnp.where(dv.valid, dv.score, -1.0)
        _, idx = jax.lax.top_k(s, 3)
        return dv.take(idx, dv.valid[idx])

    jk, tk = jax.vmap(topk_one)(jf), t3d.top_score_rois(tf, 3)
    for f in ("left", "right", "score", "valid"):
        np.testing.assert_array_equal(getattr(tk, f).numpy(), np.asarray(getattr(jk, f)))
    np.testing.assert_array_equal(tk.fields["mask"].numpy(), np.asarray(jk.fields["mask"]))


def test_warp_gt_and_mask_on_crop_match_jax():
    rng = np.random.default_rng(5)
    left, right, mask = _dets(rng, 1, 4)
    left, right, mask = left[0], right[0], mask[0]
    gt = (8 + 4 * rng.standard_normal((2,) + RAW_HW)).astype(np.float32)
    bidx = np.asarray([0, 1, 1, 0])
    lb, rb = t3d.width_aligned_crop_boxes(torch.from_numpy(left), torch.from_numpy(right))
    jlb, jrb = j3d.width_aligned_crop_boxes(jnp.asarray(left), jnp.asarray(right))
    want = jax.vmap(lambda bi, l, r: j3d.warp_gt_disparity_to_roi(jnp.asarray(gt)[bi], l, r, 32))(
        jnp.asarray(bidx), jlb, jrb)
    got = t3d.warp_gt_disparity_to_roi(torch.from_numpy(gt)[torch.from_numpy(bidx)], lb, rb, 32)
    close(got.numpy(), want, 1e-5, 1e-5)
    want_m = j3d._mask_on_crop(jnp.asarray(mask), jnp.asarray(left), jlb, 32, 0.6)
    got_m = t3d._mask_on_crop(torch.from_numpy(mask), torch.from_numpy(left), lb, 32, 0.6)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


# -- one whole train step -------------------------------------------------------

# idispnet.yaml at test size: 1 pair of 96x160, 3 detections, ROI_MIN_SCORE
# 0.5, MAX_ROI_FOR_TRAINING 2 (so 2 crops), crops of 64^2, disparity
# -16..16, one hourglass
PSM_MODEL = dict(max_det=3, roi_size=64, maxdisp=16, mindisp=-16, roi_min_score=0.5,
                 max_roi_train=2, psm_hourglass=1)


def psm_batch():
    rng = np.random.default_rng(6)
    left, right, mask = _dets(rng, 1, 3)
    score = np.asarray([[0.9, 0.3, 0.7]], np.float32)
    raw = [rng.uniform(0, 1, (1,) + RAW_HW + (3,)).astype(np.float32) for _ in range(2)]
    xs = np.arange(RAW_HW[1], dtype=np.float32)
    gt_disp = np.broadcast_to(7 + 2 * np.sin(xs / 9.0), (1,) + RAW_HW).astype(np.float32)
    return left, right, score, mask, raw, gt_disp


def jax_trace(opt_state, params):
    """The momentum trace g + wd * p in make_optimizer's state after its
    first update, zeros for frozen parameters (optax.masked leaves them
    out)."""
    def find(st):
        if hasattr(st, "trace"):
            return st.trace
        for sub in (getattr(st, "inner_state", None),) + (
                tuple(st) if isinstance(st, tuple) and not hasattr(st, "_fields") else ()):
            found = None if sub is None else find(sub)
            if found is not None:
                return found
        return None

    return jax.tree_util.tree_map(
        lambda tr, p: np.zeros(p.shape, np.float32) if isinstance(tr, optax.MaskedNode)
        else np.asarray(tr), find(opt_state), params,
        is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def check_step(tm, old, opt, got, metrics, new_state, v, lr):
    """A port TrainStep's results against JAX's make_train_step's, both one
    step from the same weights. JAX's gradients come from its optimizer's
    momentum trace: after the first update it is g + wd * p (wd = 0 on the
    biases). -> the names of the trainable parameters."""
    assert float(metrics["skipped_nonfinite"]) == 0 and float(got["skipped_nonfinite"]) == 0
    assert int(got["params_without_grad"]) == 0 and opt.count == 1
    for k in metrics:
        if k.startswith("loss"):
            close(got[k].numpy(), metrics[k], 1e-4, 1e-6, k)
    sd = lambda params: state_dict_from_jax(tm, {"params": params,
                                                 "batch_stats": v.get("batch_stats", {})})
    trace = sd(jax_trace(new_state.opt_state, new_state.params))
    new = sd(new_state.params)
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    bias = {n: n.endswith(".bias") for n in names}
    params = dict(tm.named_parameters())
    want_g = {n: trace[n].numpy() - (0.0 if bias[n] else 1e-4) * old[n].numpy() for n in names}
    grads_close({n: params[n].grad.numpy() for n in names}, want_g)
    grads_close({n: opt.sgd.state[params[n]]["momentum_buffer"].numpy() for n in names},
                {n: trace[n].numpy() for n in names})
    for n in names:  # the update carries the gradient's tolerance times the rate
        rate = lr * (2.0 if bias[n] else 1.0)
        close(params[n].detach().numpy(), new[n].numpy(), 1e-5,
              1e-7 + rate * 5e-2 * np.abs(trace[n].numpy()).max(), n)
    for n, p in tm.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p.detach(), old[n]), n
    return names


def test_psm_train_step_matches_jax():
    """One DispRCNN3D TRAIN_PSM step (forward, backward, SGD with the
    OneCycle rate and momentum) of the port's TrainStep against JAX's
    make_train_step on the same weights: the losses, every gradient, the
    momentum traces, the updated parameters, the BN running statistics."""
    left, right, score, mask, raw, gt_disp = psm_batch()
    jm = j3d.DispRCNN3D(**PSM_MODEL, det3d_on=False)
    jd = JStereoBoxes(left=jnp.asarray(left), right=jnp.asarray(right), score=jnp.asarray(score),
                      valid=jnp.ones((1, 3), bool), fields={"mask": jnp.asarray(mask)})
    calib = {k: jnp.ones((1,)) for k in t3d.CALIB_KEYS}
    v = draw_variables(jm, jnp.asarray(raw[0]), jnp.asarray(raw[1]), jd, calib, seed=7,
                       train=False)
    cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(**SOLVER))
    sched, mom = jsched.one_cycle(BASE_LR, MAX_ITER), jsched.one_cycle_momentum(MAX_ITER)
    tx = jbuild.make_optimizer(cfg, v["params"], sched, momentum_schedule=mom)
    state = jtrainer.create_train_state(jm, tx, v)
    batch = dict(left_img=jnp.asarray(raw[0]), right_img=jnp.asarray(raw[1]), dets=jd,
                 calib=calib, gt_disp=jnp.asarray(gt_disp))
    new_state, metrics = jax.jit(jtrainer.make_train_step(
        jm, tx, apply_kwargs=dict(train_psm=True, train_pc=False)))(
        state, batch, jax.random.PRNGKey(0))

    tm = load_jax_variables(t3d.DispRCNN3D(**PSM_MODEL, device="cpu"), v)
    opt = tbuild.make_optimizer(tm, tsched.one_cycle(BASE_LR, MAX_ITER),
                                tsched.one_cycle_momentum(MAX_ITER), momentum=0.9,
                                weight_decay=1e-4, weight_decay_bias=0.0, bias_lr_factor=2.0)
    old = {n: p.detach().clone() for n, p in tm.named_parameters()}
    old_buffers = {n: b.clone() for n, b in tm.named_buffers()}
    step = make_train_step(tm, opt, forward_kwargs=dict(train_psm=True))
    tdets = StereoBoxes(left=torch.from_numpy(left), right=torch.from_numpy(right),
                        score=torch.from_numpy(score), valid=torch.ones(1, 3, dtype=torch.bool),
                        fields={"mask": torch.from_numpy(mask)})
    got = step(dict(left_img=torch.from_numpy(raw[0]), right_img=torch.from_numpy(raw[1]),
                    dets=tdets, gt_disp=torch.from_numpy(gt_disp)))
    assert step.count == 1 and float(metrics["loss_psm"]) > 0.1
    names = check_step(tm, old, opt, got, metrics, new_state, v, float(sched(0)))
    assert len(names) == len(old)  # every parameter trains
    stats = state_dict_from_jax(tm, {"params": v["params"],
                                     "batch_stats": new_state.batch_stats})
    running = [n for n, _ in tm.named_buffers() if "running" in n]
    assert len(running) > 100
    for n in running:
        b = dict(tm.named_buffers())[n]
        close(b.numpy(), stats[n].numpy(), 1e-4, 1e-6, n)
        assert not torch.equal(b, old_buffers[n]), n
