"""PointRCNN's two proposal options (ROADMAP A2) against the JAX package on
the CPU: RPN.NMS_TYPE "rotate" (``bev_nms_mask(rotated=True)``, the
rotated BEV IoU under the fixpoint greedy) and
TEST.RPN_DISTANCE_BASED_PROPOSE (``distance_propose``: near and far bands
with a 70/30 split, the near band's overflow window where the far band is
empty), at 128 points a cloud.

The clouds cover both bands, the near band only (the overflow window),
the far band only, no band at all (every row invalid), and quantized
scores (ties, broken by index: ROADMAP C4). Validity and scores are held
exactly, the boxes to 1e-5 of max |JAX| (the decode's float32 rounding).
The fixpoint is held to a sequential greedy and to JAX's ``_greedy_keep``
on random IoU matrices, exactly.

The 3D RPN's other classification losses, RPN.LOSS_CLS SigmoidFocalLoss
(normalized by the positives) and DiceLoss (no factor 2, over the counted
points), on rpn_point_labels' labels with one instance invalid: the losses
within 1e-6 relative, their gradients 1e-5 * max + 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.pointrcnn import bbox3d_codec as jcodec
from disprcnn_tpu.models.pointrcnn import lift as jlift
from disprcnn_tpu.models.pointrcnn import rpn3d as jrpn
from disprcnn_tpu.ops import nms as jnms
from disprcnn_tpu_torch.models.pointrcnn import bbox3d_codec as tcodec
from disprcnn_tpu_torch.models.pointrcnn import rpn3d as trpn
from disprcnn_tpu_torch.models.pointrcnn.point_rcnn import MEAN_SIZE
from disprcnn_tpu_torch.ops import nms as tnms
from test_torch_rpn_train import ANCHOR, RPN_CODEC, close, label_scene
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

N = 128
CFG = dict(loc_scope=3.0, loc_bin_size=0.5, num_head_bin=12, xz_fine=False)
# each cloud's z range: both bands, near only, far only, none, both with ties
Z_RANGES = ((2.0, 78.0), (1.0, 38.0), (42.0, 78.0), (-30.0, -6.0), (2.0, 78.0))


def t(x):
    return torch.from_numpy(np.array(x))


def clouds(seed, z_ranges=Z_RANGES):
    """(cls (R, N), reg (R, N, C), xyz (R, N, 3)): points spread over a few
    metres in x and y and over the cloud's z range, small regression
    logits, the last cloud's scores on 6 levels."""
    rng = np.random.default_rng(seed)
    r = len(z_ranges)
    c = tcodec.CodecCfg(**CFG).reg_channels
    xyz = np.stack([np.stack([rng.uniform(-4, 4, N), rng.uniform(-1, 2, N),
                              rng.uniform(lo, hi, N)], -1) for lo, hi in z_ranges])
    cls = rng.standard_normal((r, N))
    cls[-1] = np.round(cls[-1] * 2) / 2
    reg = rng.standard_normal((r, N, c)) * 0.5
    return (cls.astype(np.float32), reg.astype(np.float32), xyz.astype(np.float32))


def check(got, want):
    g_rois, g_s, g_ok = (x.numpy() for x in got)
    w_rois, w_s, w_ok = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(g_ok, w_ok)
    np.testing.assert_array_equal(g_s[w_ok], w_s[w_ok])
    np.testing.assert_allclose(g_rois[w_ok], w_rois[w_ok], rtol=0,
                               atol=1e-5 * np.abs(w_rois).max())
    return w_ok


def run_both(fn_name, cls, reg, xyz, pre, post, thresh, rotated):
    anchor = np.asarray(MEAN_SIZE, np.float32)
    fn = jax.jit(lambda *a: getattr(jrpn, fn_name)(*a, jcodec.CodecCfg(**CFG), pre, post,
                                                   thresh, rotated=rotated))
    want = fn(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(xyz), jnp.asarray(anchor))
    got = getattr(trpn, fn_name)(t(cls), t(reg), t(xyz), t(anchor), tcodec.CodecCfg(**CFG),
                                 pre, post, thresh, rotated=rotated)
    return got, want


@pytest.mark.parametrize("pre, post, thresh", [(128, 16, 0.8), (64, 20, 0.1)])
def test_rotated_propose_matches_jax(pre, post, thresh):
    cls, reg, xyz = clouds(0)
    got, want = run_both("propose", cls, reg, xyz, pre, post, thresh, True)
    ok = check(got, want)
    assert ok.any(1).all()
    if thresh < 0.5:  # the rotated IoU suppresses what the axis-aligned one keeps, or back
        axis = trpn.propose(t(cls), t(reg), t(xyz), t(np.asarray(MEAN_SIZE, np.float32)),
                            tcodec.CodecCfg(**CFG), pre, post, thresh)
        assert not torch.equal(axis[0], got[0])


@pytest.mark.parametrize("rotated, pre, post", [(False, 128, 16), (True, 100, 30)])
def test_distance_propose_matches_jax(rotated, pre, post):
    """Both bands, the overflow window (cloud 1: its far slots are the
    near band's ranks [pre_near, pre)), the far band alone (cloud 2: no near
    proposal), no band (cloud 3: every slot invalid), ties (cloud 4)."""
    cls, reg, xyz = clouds(1)
    got, want = run_both("distance_propose", cls, reg, xyz, pre, post, 0.8, rotated)
    ok = check(got, want)
    post1 = int(post * 0.7)
    assert ok[0, :post1].any() and ok[0, post1:].any()
    assert ok[1, post1:].any()  # the overflow window proposes in the far slots
    assert not ok[2, :post1].any() and ok[2, post1:].any()
    assert not ok[3].any()
    assert ok[4].any()


def test_distance_propose_overflow_window_is_near_ranks():
    """A cloud without a far box: its far slots come from the near band's
    score ranks after the first pre_near, as the reference's fallback."""
    cls, reg, xyz = clouds(2, z_ranges=((5.0, 30.0),))
    pre, post = 64, 10
    got = trpn.distance_propose(t(cls), t(reg), t(xyz), t(np.asarray(MEAN_SIZE, np.float32)),
                                tcodec.CodecCfg(**CFG), pre, post, 1.0)
    pre1, post1 = int(pre * 0.7), int(post * 0.7)
    ranked = np.sort(cls[0])[::-1]
    # IoU threshold 1: no suppression; each band keeps its best post_n
    np.testing.assert_array_equal(got[1][0, :post1].numpy(), ranked[:post1])
    np.testing.assert_array_equal(got[1][0, post1:].numpy(), ranked[pre1:pre1 + post - post1])
    assert got[2].all()


def sequential_greedy(iou, valid, thresh):
    keep = np.zeros_like(valid)
    for i in range(len(valid)):
        keep[i] = valid[i] and not any(keep[j] and iou[i, j] > thresh for j in range(i))
    return keep


@pytest.mark.parametrize("n, thresh", [(1, 0.5), (7, 0.3), (40, 0.5), (128, 0.7)])
def test_greedy_keep_fixpoint_matches_sequential_greedy_and_jax(n, thresh):
    """Random (asymmetric) IoU matrices with exact ties at the threshold and
    invalid rows: the fixpoint's keep equals the sequential greedy's (strict
    >) and JAX's _greedy_keep; the passes run in blocks of FIXPOINT_BLOCK,
    one host sync each."""
    rng = np.random.default_rng(n)
    b = 4
    iou = rng.uniform(0, 1, (b, n, n)).astype(np.float32)
    iou[rng.uniform(size=iou.shape) < 0.1] = thresh
    valid = rng.uniform(size=(b, n)) > 0.15
    before = dict(tnms.rotated_stats)
    got = tnms.greedy_keep(t(iou), t(valid), thresh).numpy()
    calls = tnms.rotated_stats["calls"] - before["calls"]
    passes = tnms.rotated_stats["passes"] - before["passes"]
    syncs = tnms.rotated_stats["syncs"] - before["syncs"]
    assert calls == 1 and syncs == -(-passes // tnms.FIXPOINT_BLOCK) and passes <= max(n, 1)
    for k in range(b):
        np.testing.assert_array_equal(got[k], sequential_greedy(iou[k], valid[k], thresh))
        np.testing.assert_array_equal(
            got[k], np.asarray(jnms._greedy_keep(jnp.asarray(iou[k]), jnp.asarray(valid[k]),
                                                 thresh)))


def test_rotated_bev_nms_mask_matches_jax_in_chunks(monkeypatch):
    """bev_nms_mask(rotated=True) on boxes in random order with invalid
    entries and tied scores, its IoU evaluated in chunks of a few rows,
    against JAX's per image."""
    rng = np.random.default_rng(5)
    b, n = 3, 50
    ctr = rng.uniform(-3, 3, (b, n, 2))
    half = rng.uniform(0.5, 2.0, (b, n, 2))
    bev = np.concatenate([ctr - half, ctr + half, rng.uniform(-3, 3, (b, n, 1))], -1)
    bev = bev.astype(np.float32)
    scores = np.round(rng.standard_normal((b, n)) * 2).astype(np.float32) / 2
    valid = rng.uniform(size=(b, n)) > 0.2
    monkeypatch.setattr(tnms, "IOU_PAIRS_CHUNK", 7 * n)
    got = tnms.bev_nms_mask(t(bev), t(scores), t(valid), 0.3, rotated=True).numpy()
    want = jax.jit(jax.vmap(lambda *a: jnms.bev_nms_mask(*a, 0.3, rotated=True)))(
        jnp.asarray(bev), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.any() and not got[valid].all()


@pytest.mark.parametrize("loss_cls", ["SigmoidFocalLoss", "DiceLoss"])
def test_rpn_loss_forms_match_jax(loss_cls):
    pts, boxes, gt_ok = label_scene(5)
    cls_label, reg_label = (np.asarray(a) for a in jlift.rpn_point_labels(
        jnp.asarray(pts), jnp.asarray(boxes), jnp.asarray(gt_ok)))
    rng = np.random.default_rng(7)
    r, n = cls_label.shape
    cls = (rng.standard_normal((r, n)) * 2).astype(np.float32)
    reg = rng.standard_normal((r, n, RPN_CODEC.reg_channels)).astype(np.float32)
    valid = np.array([True, True, False, True])
    assert (cls_label[valid] == 1).any() and (cls_label[valid] == -1).any()

    def f(c):
        out = jrpn.rpn_loss(c, jnp.asarray(reg), jnp.asarray(cls_label), jnp.asarray(reg_label),
                            jnp.asarray(valid), jnp.asarray(ANCHOR), RPN_CODEC,
                            loss_cls=loss_cls)
        return out["loss_rpn_cls"], out

    (_, want), want_g = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(cls))
    tc = t(cls).requires_grad_(True)
    got = trpn.rpn_loss(tc, t(reg), t(cls_label), t(reg_label), t(valid), t(ANCHOR),
                        tcodec.CodecCfg(*RPN_CODEC), loss_cls=loss_cls)
    got["loss_rpn_cls"].backward()
    for k in ("loss_rpn_cls", "loss_rpn_reg"):
        w, g = float(want[k]), float(got[k].detach())
        assert w > 0 and abs(g - w) <= 1e-6 * abs(w), (k, g, w)
    close(tc.grad.numpy(), want_g, 1e-5, 1e-7, "d cls")
