"""The port's 3D stage modules against the JAX package on the CPU, at small
sizes, on JAX variables drawn by numpy (BN statistics away from 0 and 1)
and loaded through utils/weights.py: the 3D box helpers, the lift, the
box codec, the BEV NMS, PointNet++ (SA, FP, the MSG backbone), RPN3D and
propose, the RCNN pooling, RCNNNet, the postprocess and PointRCNN.

Tolerances: selections (indices, validity, argmax picks, NMS keeps,
`random`) exactly; float32 values max |diff| <= 1e-4 * max |JAX| + 1e-4
(the same arithmetic summed in another order, through up to ~20 layers);
the lift's points 1e-4 relative (a depth 1 / disparity amplifies the
bilinear sums' rounding).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.pointrcnn import bbox3d_codec as jcodec
from disprcnn_tpu.models.pointrcnn import lift as jlift
from disprcnn_tpu.models.pointrcnn import point_rcnn as jpr
from disprcnn_tpu.models.pointrcnn import pointnet2 as jpn2
from disprcnn_tpu.models.pointrcnn import rcnn3d as jrcnn
from disprcnn_tpu.models.pointrcnn import rpn3d as jrpn
from disprcnn_tpu.structures import boxes3d as jb3
from disprcnn_tpu_torch.models.pointrcnn import bbox3d_codec as tcodec
from disprcnn_tpu_torch.models.pointrcnn import lift as tlift
from disprcnn_tpu_torch.models.pointrcnn import point_rcnn as tpr
from disprcnn_tpu_torch.models.pointrcnn import pointnet2 as tpn2
from disprcnn_tpu_torch.models.pointrcnn import rcnn3d as trcnn
from disprcnn_tpu_torch.models.pointrcnn import rpn3d as trpn
from disprcnn_tpu_torch.ops import iou as tiou
from disprcnn_tpu_torch.ops import nms as tnms
from disprcnn_tpu_torch.structures import boxes3d as tb3
from disprcnn_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import draw_variables

jiou = importlib.import_module("disprcnn_tpu.ops.iou")
jnms = importlib.import_module("disprcnn_tpu.ops.nms")

R, N = 3, 128
SA_NPOINTS = (128, 64, 32, 16)


def close(got, want, rtol=1e-4, atol=1e-4):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * np.abs(want).max() + atol, err


def t(x):
    return torch.from_numpy(np.array(x))


def car_clouds(seed, r=R, n=N):
    """Canonical clouds about a car's size, with coincident points."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((r, n, 3)) * np.array([1.5, 0.6, 0.8])).astype(np.float32)
    pts[:, 7] = pts[:, 3]
    return pts


def boxes7(seed, n):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-5, 5, (n, 3))
    hwl = rng.uniform(0.5, 4, (n, 3))
    ry = rng.uniform(-3, 3, (n, 1))
    return np.concatenate([xyz, hwl, ry], -1).astype(np.float32)


def test_boxes3d_helpers_match_jax():
    b = boxes7(1, 12)
    pts = np.random.default_rng(2).standard_normal((12, 5, 3)).astype(np.float32)
    ang = b[:, 6]
    close(tb3.rotate_points_along_y(t(pts), t(ang)), jb3.rotate_points_along_y(pts, ang),
          atol=1e-6)
    corners = tb3.corners_from_xyzhwl_ry(t(b))
    close(corners, jb3.corners_from_xyzhwl_ry(jnp.asarray(b)), atol=1e-6)
    close(tb3.xyzhwl_ry_from_corners(corners), jb3.xyzhwl_ry_from_corners(np.asarray(corners)),
          atol=1e-5)


def test_codec_decode_matches_jax():
    """Both codecs (RPN: coarse, 12 heading bins; RCNN: fine, canonical)."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((40, 3)).astype(np.float32)
    anchor = np.asarray(tpr.MEAN_SIZE, np.float32)
    for cfg, base_ry in ((jcodec.CodecCfg(), None),
                         (jrcnn.RCNN_CODEC, rng.uniform(-3, 3, 40).astype(np.float32))):
        pred = rng.standard_normal((40, cfg.reg_channels)).astype(np.float32)
        pred[0, :12] = 1.0  # a tie among the x bins: the first wins
        want = jcodec.decode(base, pred, jnp.asarray(anchor), cfg,
                             base_ry=None if base_ry is None else jnp.asarray(base_ry))
        got = tcodec.decode(t(base), t(pred), t(anchor), tcodec.CodecCfg(*cfg),
                            base_ry=None if base_ry is None else t(base_ry))
        close(got, want, atol=1e-5)
        assert tcodec.CodecCfg(*cfg).reg_channels == cfg.reg_channels


def test_remainder_matches_jnp():
    x = np.array([-7.5, -0.0, 0.0, 1e-8, 6.2831855, 6.3, -6.2831855, 100.1], np.float32)
    np.testing.assert_array_equal(tcodec.remainder(t(x), 2 * np.pi).numpy(),
                                  np.asarray(jnp.remainder(x, 2 * np.pi)))


def test_bev_nms_and_topk_after_nms_match_jax():
    """Axis-aligned BEV NMS without the +1 term, then the post-NMS top-k:
    keeps, indices (the empty slots' order included) and flags equal."""
    rng = np.random.default_rng(4)
    b = boxes7(5, 60)
    b[20:40, [0, 2]] = b[0, [0, 2]] + rng.uniform(-0.3, 0.3, (20, 2))  # a cluster
    b[41] = b[40]  # a duplicate
    scores = rng.standard_normal(60).astype(np.float32)
    scores[50:] = scores[10]  # ties
    valid = rng.uniform(size=60) > 0.1
    bev = jiou.boxes3d_to_bev(jnp.asarray(b))
    tbev = tiou.boxes3d_to_bev(t(b))
    close(tbev, bev, rtol=0, atol=0)
    want = np.asarray(jax.jit(lambda *a: jnms.bev_nms_mask(*a, 0.3, rotated=False))(
        bev, jnp.asarray(scores), jnp.asarray(valid)))
    got = tnms.bev_nms_mask(tbev[None], t(scores)[None], t(valid)[None], 0.3)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert 5 < want.sum() < valid.sum()
    wi, wo = jnms.topk_after_nms(jnp.asarray(want), jnp.asarray(scores), 45)
    gi, go = tnms.topk_after_nms(got[None], t(scores)[None], 45)
    np.testing.assert_array_equal(gi[0].numpy(), np.asarray(wi))
    np.testing.assert_array_equal(go[0].numpy(), np.asarray(wo))


def lift_inputs(seed, r=4, s=32, g=16):
    rng = np.random.default_rng(seed)
    disp = rng.uniform(2, 20, (r, s, s)).astype(np.float32)
    disp[0] = -5.0  # negative disparity: no point
    mask = rng.uniform(size=(r, 28, 28)).astype(np.float32)
    x1 = rng.uniform(0, 100, r)
    y1 = rng.uniform(0, 60, r)
    left = np.stack([x1, y1, x1 + rng.uniform(10, 60, r), y1 + rng.uniform(10, 40, r)],
                    -1).astype(np.float32)
    right = left - np.array([6.3, 0, 4.1, 0], np.float32)
    calib = [np.full(r, v, np.float32) for v in (721.5, 721.5, 80.0, 48.0, 0.1, -0.2, 389.6)]
    return disp, mask, left, right, calib


def test_lift_candidates_match_jax():
    disp, mask, left, right, calib = lift_inputs(6)
    wp, wv = jax.jit(lambda *a: jlift.roi_points_candidates(*a, grid=16))(
        *(jnp.asarray(a) for a in (disp, mask, left, right)), *(jnp.asarray(c) for c in calib))
    gp, gv = tlift.roi_points_candidates(t(disp), t(mask), t(left), t(right),
                                         *(t(c) for c in calib), grid=16)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert not gv[0].any() and gv[1:].any(-1).all() and not gv.all()
    close(gp, wp, atol=1e-5)


def test_sample_fixed_points_matches_jax_draws():
    """The port's sampler on the priorities JAX draws inside
    sample_fixed_points; ROIs with no, few and many valid candidates."""
    rng = np.random.default_rng(7)
    r, c, npoints = 4, 64, 24
    pts = rng.standard_normal((r, c, 3)).astype(np.float32)
    valid = rng.uniform(size=(r, c)) > 0.5
    valid[0] = False
    valid[1] = False
    valid[1, [3, 40, 41]] = True
    key = jax.random.PRNGKey(11)
    want_p, want_ok = jlift.sample_fixed_points(key, jnp.asarray(pts), jnp.asarray(valid),
                                                npoints)
    pri = jax.vmap(lambda k: jax.random.uniform(k, (c,)))(jax.random.split(key, r))
    got_p, got_ok = tlift.sample_fixed_points(t(pri), t(pts), t(valid), npoints)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_canonical_frames_match_jax():
    rng = np.random.default_rng(8)
    left = np.abs(rng.standard_normal((5, 4)) * 300).astype(np.float32)
    fu = np.full(5, 721.5, np.float32)
    ang = tlift.canonical_angles(t(left), 1248.0, t(fu))
    close(ang, jlift.canonical_angles(jnp.asarray(left), 1248.0, jnp.asarray(fu)), atol=1e-6)
    pts = rng.standard_normal((5, 30, 3)).astype(np.float32) * 3 + 10
    gc, gm = tlift.canonicalize(t(pts), ang)
    wc, wm = jlift.canonicalize(jnp.asarray(pts), jnp.asarray(ang.numpy()))
    close(gc, wc, atol=1e-5)
    close(gm, wm, atol=1e-5)
    close(tlift.decanonicalize(gc, ang, gm), pts, atol=1e-5)
    b = boxes7(9, 5)
    close(tlift.canonicalize_boxes3d(t(b), ang, gm),
          jlift.canonicalize_boxes3d(jnp.asarray(b), jnp.asarray(ang.numpy()), wm), atol=1e-5)
    close(tlift.decanonicalize_boxes3d(t(b), ang, gm),
          jlift.decanonicalize_boxes3d(jnp.asarray(b), jnp.asarray(ang.numpy()), wm), atol=1e-5)


def load_pair(jmod, tmod, *args, seed=0, **kwargs):
    v = draw_variables(jmod, *args, seed=seed, **kwargs)
    return v, load_jax_variables(tmod, v)


@pytest.mark.parametrize("use_bn", [True, False])
def test_sa_msg_matches_jax(use_bn):
    """A scale below the channel gate (plain) and one above it (the SA
    kernel's plain version), with input features."""
    xyz = car_clouds(10, 2, 64)
    feats = np.random.default_rng(10).standard_normal((2, 64, 24)).astype(np.float32)
    jm = jpn2.SAModuleMSG(npoint=20, radii=(0.5, 1.0), nsamples=(16, 32),
                          mlps=((32, 32, 48), (64, 96, 128)), use_bn=use_bn)
    tm = tpn2.SAModuleMSG(20, (0.5, 1.0), (16, 32), ((32, 32, 48), (64, 96, 128)), 24,
                          use_bn=use_bn)
    v, tm = load_pair(jm, tm, jnp.asarray(xyz), jnp.asarray(feats), False, seed=1)
    wx, wf = jax.jit(lambda vv, a, b: jm.apply(vv, a, b, False))(v, jnp.asarray(xyz),
                                                                jnp.asarray(feats))
    with torch.no_grad():
        gx, gf = tm(t(xyz), t(feats))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    close(gf, wf)


def test_sa_single_scale_and_group_all_match_jax():
    """The RCNN's BN-free single-scale SA (kernel site) and group-all."""
    xyz = car_clouds(11, 4, 96) * 0.3
    feats = np.random.default_rng(11).standard_normal((4, 96, 64)).astype(np.float32)
    for npoint, mlp in ((24, (64, 64, 128)), (None, (64, 64, 96))):
        jm = jpn2.SAModule(npoint=npoint, radius=0.2 if npoint else 100.0, nsample=16,
                           mlp=mlp, use_bn=False)
        tm = tpn2.SAModule(npoint, 0.2 if npoint else 100.0, 16, mlp, 64, use_bn=False)
        v, tm = load_pair(jm, tm, jnp.asarray(xyz), jnp.asarray(feats), False, seed=2)
        wx, wf = jm.apply(v, jnp.asarray(xyz), jnp.asarray(feats), False)
        with torch.no_grad():
            gx, gf = tm(t(xyz), t(feats))
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        close(gf, wf)


@pytest.mark.parametrize("skip", [True, False])
def test_fp_module_matches_jax(skip):
    """With skip features (the FP kernel's plain version) and without (fp0)."""
    rng = np.random.default_rng(12)
    unknown, known = car_clouds(12, 2, 40), car_clouds(13, 2, 12)
    kf = rng.standard_normal((2, 12, 20)).astype(np.float32)
    uf = rng.standard_normal((2, 40, 8)).astype(np.float32) if skip else None
    jm = jpn2.FPModule((32, 16))
    tm = tpn2.FPModule((32, 16), 20 + (8 if skip else 0))
    args = (jnp.asarray(unknown), jnp.asarray(known), None if uf is None else jnp.asarray(uf),
            jnp.asarray(kf), False)
    v, tm = load_pair(jm, tm, *args, seed=3)
    want = jm.apply(v, *args)
    with torch.no_grad():
        got = tm(t(unknown), t(known), None if uf is None else t(uf), t(kf))
    close(got, want)


@pytest.fixture(scope="module")
def point_rcnn_pair():
    """JAX PointRCNN and the port's, same numpy-drawn variables, 3 clouds of
    128 points (one instance invalid), SA ladder 128/64/32/16, 8 proposals
    per instance."""
    pts = car_clouds(14)
    rng = np.random.default_rng(14)
    valid = np.array([True, True, False])
    ang = np.array([0.1, -0.3, 0.5], np.float32)
    mean = (rng.standard_normal((R, 3)) * 5).astype(np.float32)
    jm = jpr.PointRCNN(npoints=N, sa_npoints=SA_NPOINTS, proposals_per_roi=8)
    args = tuple(jnp.asarray(a) for a in (pts, valid, ang, mean))
    v = draw_variables(jm, *args, seed=5, train=False)
    tm = load_jax_variables(tpr.PointRCNN(npoints=N, sa_npoints=SA_NPOINTS,
                                          proposals_per_roi=8), v)
    return jm, tm, v, (pts, valid, ang, mean)


@pytest.fixture(scope="module")
def rpn_pair(point_rcnn_pair):
    jm, tm, v, (pts, *_) = point_rcnn_pair
    jrpn3d = jrpn.RPN3D(codec_cfg=jm.rpn_codec, npoints=SA_NPOINTS)
    rv = {"params": v["params"]["rpn"], "batch_stats": v["batch_stats"]["rpn"]}
    want = jax.jit(lambda vv, p: jrpn3d.apply(vv, p, train=False))(rv, jnp.asarray(pts))
    with torch.no_grad():
        got = tm.rpn(t(pts))
    return want, got


def test_rpn3d_matches_jax(rpn_pair):
    want, got = rpn_pair
    np.testing.assert_array_equal(got["xyz"].numpy(), np.asarray(want["xyz"]))
    for k in ("features", "cls", "reg"):
        close(got[k], want[k])


def test_propose_matches_jax(rpn_pair, point_rcnn_pair):
    """pre/post NMS 64/16 at IoU 0.8, and 128/40 at 0.3 (more suppressed)."""
    want, _ = rpn_pair
    anchor = np.asarray(tpr.MEAN_SIZE, np.float32)
    for pre, post, th in ((64, 16, 0.8), (128, 40, 0.3)):
        w = jax.jit(lambda c, g, x, a: jrpn.propose(c, g, x, a, jcodec.CodecCfg(), pre, post,
                                                    th))(want["cls"], want["reg"], want["xyz"],
                                                         jnp.asarray(anchor))
        g = trpn.propose(t(want["cls"]), t(want["reg"]), t(want["xyz"]), t(anchor),
                         tcodec.CodecCfg(), pre, post, th)
        np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
        close(g[0], w[0], atol=1e-5)
        close(g[1], w[1], atol=0)
    assert not np.asarray(w[2]).all()


def test_pool_rcnn_inputs_matches_jax(rpn_pair):
    """Pooling from the RPN's points and features into proposals, an empty
    one included."""
    want, _ = rpn_pair
    rois = np.stack([boxes7(15 + i, 6) * [0.3, 0.3, 0.3, 1, 1, 1, 1] for i in range(R)])
    rois[:, -1, :3] = 60.0  # far from every point
    seg = (np.asarray(want["cls"]) > 0).astype(np.float32)
    wp, we = jax.jit(lambda *a: jrcnn.pool_rcnn_inputs(*a, num_points=64))(
        want["xyz"], want["features"], jnp.asarray(seg), jnp.asarray(rois.astype(np.float32)))
    gp, ge = trcnn.pool_rcnn_inputs(t(want["xyz"]), t(want["features"]), t(seg),
                                    t(rois.astype(np.float32)), num_points=64)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    assert ge[:, -1].all() and not ge[:, 0].all()
    close(gp, wp, atol=1e-5)


def test_rcnn_net_matches_jax():
    pts_input = np.concatenate([car_clouds(16, 6, 512) * 0.4,
                                np.random.default_rng(16).standard_normal((6, 512, 130))],
                               -1).astype(np.float32)
    jm = jrcnn.RCNNNet()
    v, tm = load_pair(jm, trcnn.RCNNNet(), jnp.asarray(pts_input), False, seed=6)
    wc, wr = jax.jit(lambda vv, x: jm.apply(vv, x, False))(v, jnp.asarray(pts_input))
    with torch.no_grad():
        gc, gr = tm(t(pts_input))
    close(gc, wc)
    close(gr, wr)


def test_rcnn_postprocess_matches_jax():
    """Refined boxes above the threshold, the fallback to the best RPN
    proposal, an instance with no valid slot (slot 0), tied scores."""
    rng = np.random.default_rng(17)
    r, m = 4, 6
    cls = rng.standard_normal((r, m)).astype(np.float32)
    cls[0] = -9.0  # below the threshold: fallback
    cls[3, 1] = cls[3, 4] = 5.0  # a tie: the first wins
    reg = rng.standard_normal((r, m, jrcnn.RCNN_CODEC.reg_channels)).astype(np.float32)
    rois = np.stack([boxes7(18 + i, m) for i in range(r)])
    valid = rng.uniform(size=(r, m)) > 0.3
    valid[2] = False
    scores = rng.standard_normal((r, m)).astype(np.float32)
    anchor = np.asarray(tpr.MEAN_SIZE, np.float32)
    w = jax.jit(jrcnn.rcnn_postprocess)(
        *(jnp.asarray(a) for a in (cls, reg, rois, valid, scores, anchor)))
    g = trcnn.rcnn_postprocess(*(t(a) for a in (cls, reg, rois, valid, scores, anchor)))
    np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
    assert g[2][0] and g[2][2] and not g[2][3]
    close(g[0], w[0], atol=1e-5)
    close(g[1], w[1], atol=0)


@pytest.mark.parametrize("r,k,cap", [(128, 16, 6400), (128, 100, 6400), (3, 16, 16), (7, 9, 5)])
def test_roi_blocks_match_jax(monkeypatch, r, k, cap):
    monkeypatch.setenv("DISPRCNN_RCNN_ROI_BLOCK", str(cap))
    assert tpr._roi_blocks(r, k, cap) == jpr._roi_blocks(r, k)


@pytest.mark.parametrize("roi_block", [6400, 16])
def test_point_rcnn_matches_jax(point_rcnn_pair, monkeypatch, roi_block):
    """The eval forward: box3d, score3d, random; in one proposal block and
    in two (the reference budget's block loop)."""
    jm, tm, v, args = point_rcnn_pair
    monkeypatch.setenv("DISPRCNN_RCNN_ROI_BLOCK", str(roi_block))
    assert tpr._roi_blocks(R, 8, roi_block) == (1 if roi_block == 6400 else 2)
    want = jax.jit(lambda vv, *a: jm.apply(vv, *a, train=False))(
        v, *(jnp.asarray(a) for a in args))
    tm.roi_block = roi_block
    with torch.no_grad():
        got = tm(*(t(a) for a in args))
    np.testing.assert_array_equal(got["random"].numpy(), np.asarray(want["random"]))
    assert got["random"][2]  # the invalid instance falls back
    close(got["box3d"], want["box3d"])
    close(got["score3d"], want["score3d"])
