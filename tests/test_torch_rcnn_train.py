"""The port's train path for the RCNN stage (configs/kitti/car/vob/rcnn.yaml,
TRAIN_PC with FIX_DISPARITY, FIX_POINTRCNN_RPN and RPN.FIXED) against the
JAX package on the CPU, at small sizes: row 11's train form (the plain
version against jax.vjp of _sa_xla_oracle, and its autograd Function with
its launch point routed to the plain version), the 3D IoU, the codec's
reg_loss, every function of the proposal target layer on JAX's own draws,
the RCNN loss, and one whole train step against JAX's make_train_step on
the same weights and draws.

The JAX functions draw with jax.random from explicit keys; the tests
recompute those draws from the same keys (jax_draws mirrors the splits of
rcnn3d.py) and hand them to the port, as test_torch_disprcnn3d.py does
for the lift's priorities.

All float32. Tolerances (stated in CHANGES.md): one SA scale, value and every
gradient, max |diff| <= 1e-4 * max |JAX| + 1e-5, balls exactly; the
Function against autograd of its plain version 1e-5 * max + 1e-6; IoU,
reg_loss, the proposal target layer and the loss 1e-5 * max + 1e-5,
indices, labels and flags exactly; the whole step as in
test_torch_train.py.
"""
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.engine import trainer as jtrainer
from disprcnn_tpu.models.detector import disprcnn3d as j3d
from disprcnn_tpu.models.pointrcnn import bbox3d_codec as jcodec
from disprcnn_tpu.models.pointrcnn import lift as jlift
from disprcnn_tpu.models.pointrcnn import rcnn3d as jrcnn
from disprcnn_tpu.ops import iou as jiou
from disprcnn_tpu.ops.pallas.sa_fused import _sa_xla_oracle
from disprcnn_tpu.ops.points import ball_query as jball_query
from disprcnn_tpu.solver import build as jbuild
from disprcnn_tpu.solver import schedules as jsched
from disprcnn_tpu.structures.stereo import StereoBoxes as JStereoBoxes
from disprcnn_tpu_torch.engine.trainer import make_train_step
from disprcnn_tpu_torch.models.detector import disprcnn3d as t3d
from disprcnn_tpu_torch.models.pointrcnn import bbox3d_codec as tcodec
from disprcnn_tpu_torch.models.pointrcnn import point_rcnn as tpr
from disprcnn_tpu_torch.models.pointrcnn import rcnn3d as trcnn
from disprcnn_tpu_torch.ops import iou as tiou
from disprcnn_tpu_torch.ops.cuda import sa as csa
from disprcnn_tpu_torch.ops.points import ball_query
from disprcnn_tpu_torch.ops.roipool3d import enlarge_box3d, pts_in_boxes3d
from disprcnn_tpu_torch.solver import build as tbuild
from disprcnn_tpu_torch.solver import schedules as tsched
from disprcnn_tpu_torch.structures.stereo import StereoBoxes
from disprcnn_tpu_torch.utils.weights import load_jax_variables
from test_torch_train import SOLVER, check_step, close
from torch_port_helpers import draw_variables

ANCHOR = np.asarray(tpr.MEAN_SIZE, np.float32)


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def t(x):
    return torch.from_numpy(np.array(x))


# -- row 11: one SA scale's train form -----------------------------------------

def sa_inputs(seed, b=3, n=64, m=16, c0=32, chain=(48, 64)):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((b, n, 3)) * 0.4).astype(np.float32)
    xyz[:, 5] = xyz[:, 2]  # coincident points
    centers = xyz[:, :m] + (rng.standard_normal((b, m, 3)) * 0.05).astype(np.float32)
    centers[:, -1] = 9.0  # an empty ball
    v = rng.standard_normal((b, n, c0)).astype(np.float32)
    w0x = (rng.standard_normal((3, c0)) * 0.5).astype(np.float32)
    mul0 = (1 + 0.3 * rng.standard_normal(c0)).astype(np.float32)
    add0 = (0.1 * rng.standard_normal(c0)).astype(np.float32)
    weights, cin = [], c0
    for co in chain:
        weights.append(((rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32),
                        (0.1 * rng.standard_normal(co)).astype(np.float32)))
        cin = co
    ct = rng.standard_normal((b, m, chain[-1])).astype(np.float32)
    return (xyz, centers, v, w0x, mul0, add0, weights), ct


def test_sa_train_plain_matches_xla_oracle():
    """The value and the gradients of every input and weight, under a
    non-uniform output gradient, against jax.vjp of the oracle that JAX's
    backward differentiates (empty, partial and full balls, coincident
    points); the balls equal."""
    (xyz, centers, v, w0x, mul0, add0, weights), ct = sa_inputs(0)
    radius, s = 0.5, 16
    args = (xyz, centers, v, w0x, mul0, add0, tuple(weights))
    @jax.jit
    def value_and_vjp(a, cot):
        out, vjp = jax.vjp(lambda *x: _sa_xla_oracle(*x, radius, s), *a)
        return out, vjp(cot)

    want, want_g = value_and_vjp(jax.tree_util.tree_map(jnp.asarray, args), jnp.asarray(ct))
    leaves = [t(a).requires_grad_(True) for a in (xyz, centers, v, w0x, mul0, add0)]
    tw = [(t(w).requires_grad_(True), t(b).requires_grad_(True)) for w, b in weights]
    got = csa.sa_ball_mlp_max_train(*leaves, tw, radius, s)
    got.backward(t(ct))
    close(got.detach().numpy(), want, 1e-4, 1e-5, "value")
    for name, g, w in zip(("xyz", "centers", "v", "w0x", "mul0", "add0"), leaves, want_g[:6]):
        close(g.grad.numpy(), w, 1e-4, 1e-5, name)
    for (gw, gb), (ww, wb) in zip(tw, want_g[6]):
        close(gw.grad.numpy(), ww, 1e-4, 1e-5, "W")
        close(gb.grad.numpy(), wb, 1e-4, 1e-5, "b")
    np.testing.assert_array_equal(
        ball_query(t(centers), t(xyz), radius, s).numpy(),
        np.asarray(jball_query(jnp.asarray(centers), jnp.asarray(xyz), radius, s)))


def test_sa_train_function_backward(monkeypatch):
    """The autograd Function that CUDA tensors take, with its launch point
    routed to the plain version: its recomputed backward gives autograd's
    gradients for every input and weight."""
    monkeypatch.setattr(csa, "sa_ball_mlp_max_train_cuda", csa.sa_ball_mlp_max_plain)
    (xyz, centers, v, w0x, mul0, add0, weights), ct = sa_inputs(1)
    runs = []
    for use_fn in (True, False):
        leaves = [t(a).requires_grad_(True) for a in (xyz, centers, v, w0x, mul0, add0)]
        flat = [t(a).requires_grad_(True) for pair in weights for a in pair]
        pairs = list(zip(flat[0::2], flat[1::2]))
        if use_fn:
            out = csa._SATrain.apply(0.5, 16, *leaves, *flat)
        else:
            out = csa.sa_ball_mlp_max_plain(*leaves, pairs, 0.5, 16)
        out.backward(t(ct))
        runs.append([out.detach()] + [a.grad for a in leaves + flat])
    for got, want in zip(*runs):
        close(got.numpy(), want.numpy(), 1e-5, 1e-6)


# -- 3D IoU, the codec's loss ------------------------------------------------

def box_pairs(seed, n):
    """Boxes and partners: equal, shifted, rotated, shrunk, far away and
    stacked vertically."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.uniform(-5, 5, (n, 3)), rng.uniform(0.8, 4, (n, 3)),
                        rng.uniform(-3, 3, (n, 1))], -1).astype(np.float32)
    b = a.copy()
    kind = np.arange(n) % 6
    b[kind == 1, 0] += rng.uniform(-1, 1, (kind == 1).sum())
    b[kind == 2, 6] += rng.uniform(-1.5, 1.5, (kind == 2).sum())
    b[kind == 3, 3:6] *= 0.6
    b[kind == 4, 0] += 30
    b[kind == 5, 1] -= b[kind == 5, 3] * 0.5
    b[kind >= 1, 2] += rng.uniform(-0.5, 0.5, (kind >= 1).sum())
    return a, b


def test_iou3d_matches_jax():
    a, b = box_pairs(2, 30)
    got = tiou.pairwise_iou3d(t(a), t(b))
    want = jax.jit(jiou.pairwise_iou3d)(jnp.asarray(a), jnp.asarray(b))
    close(got.numpy(), want, 1e-5, 1e-5)
    assert np.diag(np.asarray(want))[::6].min() > 0.999 and (np.asarray(want) == 0).any()
    bev = lambda x: tiou.boxes3d_to_bev(t(x))
    close(tiou.pairwise_bev_iou(bev(a), bev(b)).numpy(),
          jax.jit(lambda x, y: jiou.pairwise_bev_iou(jiou.boxes3d_to_bev(x),
                                                     jiou.boxes3d_to_bev(y)))(
              jnp.asarray(a), jnp.asarray(b)), 1e-5, 1e-5)
    close(tiou.iou3d(t(a), t(b)).numpy(), np.diag(np.asarray(want)), 1e-5, 1e-5)


@pytest.mark.parametrize("fine", [False, True])
def test_reg_loss_matches_jax(fine):
    """The RPN's coarse codec and the RCNN's fine canonical one: the three
    losses and their gradients in the prediction, labels across every bin
    and the heading's wrap, half the rows masked."""
    rng = np.random.default_rng(3)
    cfg = jrcnn.RCNN_CODEC if fine else jcodec.CodecCfg()
    n = 40
    pred = rng.standard_normal((n, cfg.reg_channels)).astype(np.float32)
    label = np.concatenate([rng.uniform(-4, 4, (n, 3)), rng.uniform(1, 5, (n, 3)),
                            rng.uniform(-7, 7, (n, 1))], -1).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.5).astype(np.float32)

    def jloss(p):
        loc, ang, size = jcodec.reg_loss(p, jnp.asarray(label), jnp.asarray(mask),
                                         jnp.asarray(ANCHOR), cfg)
        return loc + 2 * ang + 3 * size, (loc, ang, size)

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(pred))
    tp = t(pred).requires_grad_(True)
    got = tcodec.reg_loss(tp, t(label), t(mask), t(ANCHOR), tcodec.CodecCfg(*cfg))
    (got[0] + 2 * got[1] + 3 * got[2]).backward()
    for g, w in zip(got, want):
        close(g.detach().numpy(), w, 1e-5, 1e-5)
    close(tp.grad.numpy(), want_g, 1e-5, 1e-5)


# -- the proposal target layer on JAX's draws ----------------------------------

def jax_draws(key, r, m, k, aug_times):
    """The uniforms and tiers that jrcnn.prepare_rcnn_train_inputs draws
    from `key` (its splits, in its order), as numpy."""
    return {name: np.asarray(val) for name, val in _jax_draws(key, r, m, k, aug_times).items()}


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_draws(key, r, m, k, aug_times):
    k_s, k_n, k_a = jax.random.split(key, 3)
    u = jax.random.uniform
    fg, hard, easy = [], [], []
    for kk in jax.random.split(k_s, r):
        k1, k2, k3 = jax.random.split(kk, 3)
        fg.append(u(k1, (m,)))
        hard.append(u(k2, (m,)))
        easy.append(u(k3, (m,)))

    def noise(kroi):
        kk, kb = jax.random.split(kroi)
        parts = []
        for kc in jax.random.split(kk, aug_times):
            k1, k2, k3, k4 = jax.random.split(kc, 4)
            parts.append((jax.random.randint(k1, (), 0, len(jrcnn._AUG_RANGES)), u(k2, (3,)),
                          u(k3, (3,)), u(k4, ())))
        return (u(kb, (aug_times,)),) + tuple(jnp.stack(p) for p in zip(*parts))

    keep, tier, pos, hwl, ang = jax.vmap(noise)(jax.random.split(k_n, r * k))
    k1, k2, k3 = jax.random.split(k_a, 3)
    n = r * k
    return dict(fg=jnp.stack(fg), hard=jnp.stack(hard), easy=jnp.stack(easy), keep=keep,
                tier=tier, pos=pos, hwl=hwl, ang=ang, rot=u(k1, (n,)), scale=u(k2, (n,)),
                flip=u(k3, (n,)))


def port_draws(d):
    return trcnn.RCNNDraws(**{k: torch.from_numpy(np.array(v)).to(
        torch.int64 if k == "tier" else torch.float32) for k, v in d.items()})


def rcnn_scene(seed, r=3, m=24, n=256):
    """Per instance one GT box, proposals from tight to far around it (some
    invalid), points in and around it with RPN features and a seg mask."""
    rng = np.random.default_rng(seed)
    gt = np.stack([np.array([rng.uniform(-2, 2), 1.6, rng.uniform(10, 20), 1.5, 1.6, 3.9,
                             rng.uniform(-1.5, 1.5)]) for _ in range(r)]).astype(np.float32)
    spread = np.linspace(0.02, 2.5, m)[None, :, None]
    rois = gt[:, None, :] + rng.standard_normal((r, m, 7)) * spread * [1, 0.2, 1, 0.1, 0.1,
                                                                        0.3, 0.3]
    rois = rois.astype(np.float32)
    valid = rng.uniform(size=(r, m)) > 0.15
    xyz = gt[:, None, 0:3] + rng.standard_normal((r, n, 3)).astype(np.float32) * [1.5, 0.7, 2.0]
    xyz[:, :, 1] -= 0.8
    feats = rng.standard_normal((r, n, 6)).astype(np.float32)
    seg = (rng.uniform(size=(r, n)) > 0.5).astype(np.float32)
    gt_ok = np.array([True, True, False][:r])
    return gt, rois, valid, gt_ok, xyz.astype(np.float32), feats, seg


def test_proposal_target_layer_matches_jax():
    """sample_rcnn_rois, aug_roi_by_noise, rcnn_data_augmentation,
    canonical_gt and the whole prepare_rcnn_train_inputs (RoI-pool 3D
    included) on the draws JAX takes from one key."""
    gt, rois, valid, gt_ok, xyz, feats, seg = rcnn_scene(4)
    r, m, k, times = rois.shape[0], rois.shape[1], 8, 10
    key = jax.random.PRNGKey(11)
    d = jax_draws(key, r, m, k, times)
    draws = port_draws(d)
    k_s, k_n, k_a = jax.random.split(key, 3)
    J = lambda a: jnp.asarray(a)

    ws = jax.jit(partial(jrcnn.sample_rcnn_rois, rois_per_instance=k))(
        k_s, J(rois), J(valid), J(gt), J(gt_ok))
    gs = trcnn.sample_rcnn_rois(t(rois), t(valid), t(gt), t(gt_ok), draws, rois_per_instance=k)
    np.testing.assert_array_equal(gs[0].numpy(), np.asarray(ws[0]))
    close(gs[1].numpy(), ws[1], 1e-5, 1e-5)
    for g, w in zip(gs[2:], ws[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(ws[2]).any() and not np.asarray(ws[2]).all()

    flat = lambda a: np.asarray(a).reshape((r * k,) + np.asarray(a).shape[2:])
    gt_rep = np.broadcast_to(gt[:, None], (r, k, 7))
    wa = jax.jit(partial(jrcnn.aug_roi_by_noise, pos_thresh=0.55, aug_times=times))(
        k_n, J(flat(ws[0])), J(flat(gt_rep)), J(flat(ws[1])), fg_mask=J(flat(ws[2])))
    ga = trcnn.aug_roi_by_noise(t(flat(ws[0])), t(flat(gt_rep)), t(flat(ws[1])), 0.55, draws,
                                times, t(flat(ws[2])))
    for g, w in zip(ga, wa):
        close(g.numpy(), w, 1e-5, 1e-5)

    pts = np.random.default_rng(5).standard_normal((r * k, 32, 3)).astype(np.float32) * 2
    wd = jax.jit(jrcnn.rcnn_data_augmentation)(k_a, J(pts), wa[0], J(flat(gt_rep)))
    gd = trcnn.rcnn_data_augmentation(t(pts), ga[0], t(flat(gt_rep)), draws)
    for g, w in zip(gd, wd):
        close(g.numpy(), w, 1e-5, 1e-5)
    close(trcnn.canonical_gt(gd[1], gd[2]).numpy(), jrcnn.canonical_gt(wd[1], wd[2]), 1e-5, 1e-5)

    wp = jax.jit(partial(jrcnn.prepare_rcnn_train_inputs, rois_per_instance=k, num_points=64))(
        key, J(rois), J(valid), J(gt), J(gt_ok), J(xyz), J(feats), J(seg))
    gp = trcnn.prepare_rcnn_train_inputs(t(rois), t(valid), t(gt), t(gt_ok), t(xyz), t(feats),
                                         t(seg), draws, rois_per_instance=k, num_points=64)
    close(gp[0].numpy(), wp[0], 1e-5, 1e-5)
    for g, w in zip(gp[1:3], wp[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(gp[3:5], wp[3:5]):
        close(g.numpy(), w, 1e-5, 1e-5)
    np.testing.assert_array_equal(gp[5].numpy(), np.asarray(wp[5]))
    assert np.asarray(wp[2]).any() and (np.asarray(wp[1]) == 0).any()


@pytest.mark.parametrize("with_fg", [True, False])
def test_rcnn_loss_matches_jax(with_fg):
    """The BCE + bin-based loss and its gradients, with foreground rois to
    regress and with none (the regression terms then vanish)."""
    rng = np.random.default_rng(6)
    n = 24
    cls = rng.standard_normal(n).astype(np.float32) * 2
    reg = rng.standard_normal((n, jrcnn.RCNN_CODEC.reg_channels)).astype(np.float32)
    label = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    mask = (label > 0) & (rng.uniform(size=n) > 0.3) & with_fg
    gt_ct = np.concatenate([rng.uniform(-1.5, 1.5, (n, 3)), rng.uniform(1, 4, (n, 3)),
                            rng.uniform(-1, 1, (n, 1))], -1).astype(np.float32)
    f = lambda c, g: jrcnn.rcnn_loss(c, g, jnp.asarray(label), jnp.asarray(mask),
                                     jnp.asarray(gt_ct), jnp.asarray(ANCHOR))
    want, (wc, wg) = jax.jit(jax.value_and_grad(f, (0, 1)))(jnp.asarray(cls), jnp.asarray(reg))
    tc, tg = t(cls).requires_grad_(True), t(reg).requires_grad_(True)
    got = trcnn.rcnn_loss(tc, tg, t(label), t(mask), t(gt_ct), t(ANCHOR))
    got.backward()
    close(got.detach().numpy(), want, 1e-5, 1e-5)
    close(tc.grad.numpy(), wc, 1e-5, 1e-5)
    close(tg.grad.numpy(), wg, 1e-5, 1e-5)
    assert mask.any() == with_fg


# -- one whole train step --------------------------------------------------------

# rcnn.yaml at test size: 1 pair of 96x160, 2 detections, crops of 32^2,
# disparity -16..16 and one hourglass (frozen), clouds of 128 points, SA
# ladder 128/64/32/16, TRAIN proposals 64 -> 16 at rcnn.yaml's NMS 0.85, 4
# RCNN rois per instance (2 foreground slots), MASK_THRESH 0.5, RPN.FIXED
PC_MODEL = dict(max_det=2, roi_size=32, maxdisp=16, mindisp=-16, det3d_on=True,
                npoints=128, lift_grid=32, sa_npoints=(128, 64, 32, 16), psm_hourglass=1,
                mask_thresh_train=0.5, rpn_pre_nms_per_roi_train=64,
                proposals_per_roi_train=16, rcnn_rois_per_instance=4, rpn_fixed=True,
                rpn_nms_thresh_train=0.85)
RAW_HW = (96, 160)
CALIB = dict(fu=721.5, fv=721.5, cu=80.0, cv=48.0, tx=0.0, ty=0.0, fuxb=389.6)
MAX_ITER = 62100


def pc_inputs():
    rng = np.random.default_rng(8)
    left = np.asarray([[[10.3, 20.7, 70.2, 60.9], [80.5, 30.1, 131.4, 75.6]]], np.float32)
    right = left - np.asarray([6.2, 0.0, 5.1, 0.0], np.float32)
    mask = rng.uniform(size=(1, 2, 28, 28)).astype(np.float32)
    raw = [rng.uniform(0, 1, (1,) + RAW_HW + (3,)).astype(np.float32) for _ in range(2)]
    return left, right, mask, raw


def jax_pc_step(jm, v):
    """JAX's make_train_step for the stage (grad clip 10, idispnet and
    pointrcnn.rpn frozen), jitted with the lift's priorities, the proposal
    target layer's key and its proposals copied out of each run."""
    drawn = {}
    orig_sample, orig_prepare = jlift.sample_fixed_points, jrcnn.prepare_rcnn_train_inputs

    def sample(key, pts, valid, npoints):
        r, c = valid.shape
        pri = jax.vmap(lambda k: jax.random.uniform(k, (c,)))(jax.random.split(key, r))
        jax.debug.callback(lambda p: drawn.__setitem__("priorities", np.array(p)), pri)
        return orig_sample(key, pts, valid, npoints)

    def prepare(key, rois, *args, **kwargs):
        jax.debug.callback(lambda kd, ro, xyz: drawn.update(key=np.array(kd), rois=np.array(ro),
                                                            xyz=np.array(xyz)),
                           key, rois, args[3])
        out = orig_prepare(key, rois, *args, **kwargs)
        jax.debug.callback(lambda *o: drawn.update(targets=[np.array(a) for a in o[:4]]), *out)
        return out

    frozen = ("idispnet", "pointrcnn.rpn")
    cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(**SOLVER))
    sched = jsched.one_cycle(0.01, MAX_ITER)
    tx = jbuild.make_optimizer(cfg, v["params"], sched, frozen,
                               momentum_schedule=jsched.one_cycle_momentum(MAX_ITER))
    state = jtrainer.create_train_state(jm, tx, v)
    step = jax.jit(jtrainer.make_train_step(jm, tx, do_grad_clip=True, grad_clip=10.0,
                                            apply_kwargs=dict(train_psm=False, train_pc=True),
                                            stop_grad_prefixes=frozen))

    def run(batch):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jlift, "sample_fixed_points", sample)
            mp.setattr(jrcnn, "prepare_rcnn_train_inputs", prepare)
            out = step(state, batch, jax.random.PRNGKey(3))
            jax.block_until_ready(out)
        return out, dict(drawn)

    return run, float(sched(0))


def centre_rpn_boxes(v):
    """Scale the RPN's box regression output down and bias its x and z bins
    to the middle one, so that each proposal is a car-sized box about its
    point (a random regression head throws the small model's boxes off the
    clouds, and every pooled proposal comes out empty)."""
    out = v["params"]["pointrcnn"]["rpn"]["reg_head"]["out"]
    nbin = jcodec.CodecCfg().per_loc_bin_num
    bias = np.zeros_like(np.asarray(out["bias"]))
    bias[[nbin // 2, nbin + nbin // 2]] = 2.0
    out["kernel"] = np.asarray(out["kernel"]) * 0.01
    out["bias"] = bias


def test_pc_train_step_matches_jax():
    """One DispRCNN3D TRAIN_PC step: iDispNet and the RPN frozen, the lift,
    the TRAIN proposals, the proposal target layer, the RCNN forward and
    backward, the gradient clip and SGD, against JAX's make_train_step on
    the same weights, priorities and draws: the RCNN's inputs and labels
    out of the frozen stages, then, on JAX's inputs, the losses, every
    gradient of the RCNN, the momentum traces, the updated parameters, the
    frozen ones unchanged. Each instance's GT box is placed on its proposal that holds
    the most lifted points (the proposals of a first JAX run), so that the
    sampler finds foreground that pools points."""
    left, right, mask, raw = pc_inputs()
    jm = j3d.DispRCNN3D(**PC_MODEL)
    jd = JStereoBoxes(left=jnp.asarray(left), right=jnp.asarray(right),
                      score=jnp.asarray([[0.9, 0.8]]), valid=jnp.ones((1, 2), bool),
                      fields={"mask": jnp.asarray(mask)})
    calib = {k: jnp.full((1,), val, jnp.float32) for k, val in CALIB.items()}
    v = draw_variables(jm, jnp.asarray(raw[0]), jnp.asarray(raw[1]), jd, calib, seed=9,
                       train=False)
    centre_rpn_boxes(v)
    batch = dict(left_img=jnp.asarray(raw[0]), right_img=jnp.asarray(raw[1]), dets=jd,
                 calib=calib, gt_left=jnp.asarray(left), gt_valid=jnp.ones((1, 2), bool))
    run, lr = jax_pc_step(jm, v)
    _, first = run(dict(batch, gt_boxes3d=jnp.zeros((1, 2, 7))))
    inside = pts_in_boxes3d(t(first["xyz"]), enlarge_box3d(t(first["rois"]), 1.0)).sum(-1)
    gt = first["rois"][np.arange(2), inside.argmax(1).numpy()][None]  # (1, 2, 7)
    assert inside.max(1).values.min() > 0
    (new_state, metrics), drawn = run(dict(batch, gt_boxes3d=jnp.asarray(gt)))
    np.testing.assert_array_equal(drawn["priorities"], first["priorities"])
    r, m = drawn["rois"].shape[:2]
    draws = port_draws(jax_draws(jnp.asarray(drawn["key"]), r, m, 4, 10))

    tm = load_jax_variables(t3d.DispRCNN3D(**PC_MODEL, device="cpu"), v)
    frozen = tbuild.frozen_path_prefixes(FIX_DISPARITY=True, FIX_POINTRCNN_RPN=True)
    opt = tbuild.make_optimizer(tm, tsched.one_cycle(0.01, MAX_ITER),
                                tsched.one_cycle_momentum(MAX_ITER), frozen, momentum=0.9,
                                weight_decay=1e-4, weight_decay_bias=0.0, bias_lr_factor=2.0)
    old = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step = make_train_step(tm, opt, do_grad_clip=True, grad_clip=10.0,
                           forward_kwargs=dict(train_pc=True))
    # the RCNN trains on JAX's frozen-stage output: the float32 differences
    # of the frozen iDispNet (~1e-4 in the points) tip FPS and ball
    # selections of the RCNN now and then (ROADMAP C16); the port's own
    # output is held to JAX's first
    targets = []
    orig = tm.pointrcnn.rcnn_targets
    jt = dict(zip(("pts_input", "cls_label", "reg_mask", "gt_ct"),
                  (t(a).reshape((-1,) + a.shape[2:]) for a in drawn["targets"])))
    tm.pointrcnn.rcnn_targets = lambda *a: targets.append(orig(*a)) or jt
    got = step(dict(left_img=t(raw[0]), right_img=t(raw[1]),
                    dets=StereoBoxes(left=t(left), right=t(right), score=t([[0.9, 0.8]]),
                                     valid=torch.ones(1, 2, dtype=torch.bool),
                                     fields={"mask": t(mask)}),
                    calib={k: torch.full((1,), val) for k, val in CALIB.items()},
                    priorities=t(drawn["priorities"]), gt_left=t(left),
                    gt_boxes3d=t(gt), gt_valid=torch.ones(1, 2, dtype=torch.bool),
                    rcnn_draws=draws))
    tgt = targets[0]
    for k in ("cls_label", "reg_mask"):
        assert torch.equal(tgt[k], jt[k]), k
    for k in ("pts_input", "gt_ct"):
        close(tgt[k].numpy(), jt[k].numpy(), 1e-3, 1e-3, k)
    assert int(tgt["reg_mask"].sum()) > 0 and int((tgt["cls_label"] == 0).sum()) > 0
    assert np.isfinite(float(metrics["loss_box3d"])) and float(metrics["loss_box3d"]) > 0
    names = check_step(tm, old, opt, got, metrics, new_state, v, lr)
    assert names and all(n.startswith("pointrcnn.rcnn.") for n in names)
    assert len(names) == len(list(tm.pointrcnn.rcnn.parameters()))
