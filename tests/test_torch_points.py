"""The port's PointNet++ primitives (ops/points.py), its 3D RoI pooling
(ops/roipool3d.py) and the plain versions of its four point kernels
(ops/cuda/{fps,sa,fp,roipool3d}.py), against the JAX package on the CPU.

Tolerances:
- every selection exactly: FPS, ball query, 3-NN, the in-box mask and the
  first-k slots (the same float32 comparisons on the same values);
- gathered values exactly (copies of the same float32 values);
- values the JAX XLA path computes with float32 arithmetic:
  max |diff| <= 1e-4 * max |JAX| + 1e-5 (sums in another order);
- the SA and FP Pallas kernels in interpret mode, which round their
  features, weights and activations to bf16 inside: max |diff| <= 3e-2 *
  max |Pallas| + 1e-2, with the port's inputs rounded to bf16 first;
- the FPS and RoI-pool Pallas kernels in interpret mode exactly.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.pointrcnn import pointnet2 as jpn2
from disprcnn_tpu.ops import points as jpoints
from disprcnn_tpu.ops.pallas.fp_fused import fp_fused as jfp_fused
from disprcnn_tpu.ops.pallas.fps import furthest_point_sample_pallas
from disprcnn_tpu.ops.pallas.roipool3d_fused import roipool3d_fused
from disprcnn_tpu.ops.pallas.sa_fused import _sa_xla_oracle, sa_ball_mlp_max
from disprcnn_tpu_torch.ops import points as tpoints
from disprcnn_tpu_torch.ops import roipool3d as troi
from disprcnn_tpu_torch.ops.cuda import fp as tfp
from disprcnn_tpu_torch.ops.cuda import fps as tfps
from disprcnn_tpu_torch.ops.cuda import roipool3d as tcroi
from disprcnn_tpu_torch.ops.cuda import sa as tsa

# disprcnn_tpu.ops re-exports the function roipool3d under the module's name
jroi = importlib.import_module("disprcnn_tpu.ops.roipool3d")


def close(got, want, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + atol, err


def bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def t(x):
    return torch.from_numpy(np.array(x))


def cloud(seed, b, n, scale=1.5, dup=True):
    """Seeded clouds with coincident points (exact distance ties) and a
    far outlier, so that balls are empty, partial and full."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n, 3)) * scale).astype(np.float32)
    if dup:
        x[:, 5] = x[:, 2]
        x[:, 9] = x[:, 2]
        x[:, n - 1] = x[:, 7]
    x[:, 3] = 40.0
    return x


@pytest.mark.parametrize("n,npoint", [(64, 16), (96, 95), (40, 40)])
def test_fps_matches_jax(n, npoint):
    xyz = cloud(1, 3, n)
    xyz[2] = 0.0  # one all-coincident cloud: every step ties at 0 -> index 0
    want = np.asarray(jax.vmap(lambda p: jpoints._fps_single(p, npoint))(jnp.asarray(xyz)))
    got = tfps.furthest_point_sample(t(xyz), npoint)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # three points of each cloud repeat others: once the distinct ones are
    # taken, every step ties at 0 and takes index 0
    assert (got[2] == 0).all() and len(set(got[0].tolist())) == min(npoint, n - 3)


def test_fps_matches_pallas_interpret():
    xyz = cloud(2, 9, 48)
    want = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), 20, interpret=True))
    np.testing.assert_array_equal(tfps.furthest_point_sample(t(xyz), 20).numpy(), want)


def test_fps_or_identity():
    xyz = t(cloud(3, 2, 16))
    assert tpoints.fps_or_identity(xyz, 16) is None
    assert tpoints.fps_or_identity(xyz, 8).shape == (2, 8)


def test_ball_query_matches_jax():
    """Radius 1.0 over sigma 1.5 clouds with an outlier centre: empty,
    partial and full balls; ties of coincident points."""
    xyz = cloud(4, 2, 80)
    centers = np.concatenate([xyz[:, :12], np.full((2, 1, 3), 30.0, np.float32)], axis=1)
    want = np.asarray(jpoints.ball_query(jnp.asarray(centers), jnp.asarray(xyz), 1.0, 16))
    got = tpoints.ball_query(t(centers), t(xyz), 1.0, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    cnt = np.array([[len(set(r)) for r in c] for c in want])
    assert (want[:, -1] == 0).all()  # empty ball
    assert (cnt > 1).any() and (cnt < 16).any()


def test_group_and_gather_match_jax():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 30, 7)).astype(np.float32)
    idx = rng.integers(0, 30, (2, 4, 5)).astype(np.int32)
    want = np.asarray(jpoints.group_points_gather(jnp.asarray(feats), jnp.asarray(idx)))
    np.testing.assert_array_equal(tpoints.group_points(t(feats), t(idx).long()).numpy(), want)
    want = np.asarray(jpoints.gather_points(jnp.asarray(feats), jnp.asarray(idx[:, 0])))
    np.testing.assert_array_equal(tpoints.gather_points(t(feats), t(idx[:, 0]).long()).numpy(),
                                  want)


def test_three_nn_and_interpolation_match_jax():
    unknown = cloud(6, 2, 40)
    known = cloud(7, 2, 20)
    known[:, 11] = known[:, 4]  # a tie among the neighbours
    unknown[:, 0] = known[:, 4]  # a zero distance
    jd, ji = jpoints.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    td, ti = tpoints.three_nn(t(unknown), t(known))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(td.numpy(), jd)
    feats = np.random.default_rng(8).standard_normal((2, 20, 6)).astype(np.float32)
    jw = jpoints.three_nn_interpolate_weights(jd)
    tw = tpoints.three_nn_interpolate_weights(td)
    close(tw.numpy(), jw)
    close(tpoints.three_interpolate(t(feats), ti, tw).numpy(),
          jpoints.three_interpolate(jnp.asarray(feats), ji, jw))


def sa_inputs(seed, b=2, n=64, m=16, c0=64, chain=(64, 96)):
    rng = np.random.default_rng(seed)
    xyz = cloud(seed, b, n)
    centers = np.concatenate([xyz[:, :m - 1], np.full((b, 1, 3), 50.0, np.float32)], axis=1)
    v = rng.standard_normal((b, n, c0)).astype(np.float32)
    w0x = (rng.standard_normal((3, c0)) * 0.5).astype(np.float32)
    mul0 = rng.uniform(0.5, 1.5, c0).astype(np.float32)
    add0 = (rng.standard_normal(c0) * 0.1).astype(np.float32)
    ws, cin = [], c0
    for co in chain:
        ws.append(((rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32),
                   (rng.standard_normal(co) * 0.1).astype(np.float32)))
        cin = co
    return xyz, centers, v, w0x, mul0, add0, ws


def test_sa_plain_matches_jax_xla():
    """The SA kernel's plain version against the JAX package's XLA form of
    the same function in float32 (`_sa_xla_oracle`)."""
    xyz, centers, v, w0x, mul0, add0, ws = sa_inputs(9)
    want = _sa_xla_oracle(*(jnp.asarray(a) for a in (xyz, centers, v, w0x, mul0, add0)),
                          tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in ws), 1.2, 16)
    got = tsa.sa_ball_mlp_max(t(xyz), t(centers), t(v), t(w0x), t(mul0), t(add0),
                              [(t(w), t(b)) for w, b in ws], 1.2, 16)
    assert got.shape == (2, 16, 96)
    close(got.numpy(), want)


def test_sa_plain_chunks_like_whole(monkeypatch):
    """The plain version's batch chunks (memory bound) change nothing."""
    args = sa_inputs(10, b=5)
    targs = [t(a) for a in args[:6]] + [[(t(w), t(b)) for w, b in args[6]], 1.2, 16]
    whole = tsa.sa_ball_mlp_max_plain(*targs)
    monkeypatch.setattr(tsa, "PLAIN_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(tsa.sa_ball_mlp_max_plain(*targs).numpy(), whole.numpy())


def test_sa_plain_matches_pallas_interpret():
    """Against sa_ball_mlp_max in interpret mode (bf16 inside), on
    bf16-rounded inputs; the ball indices are held exactly against the
    JAX ball query."""
    xyz, centers, v, w0x, mul0, add0, ws = sa_inputs(11, chain=(64, 64))
    v = bf16(v)
    ws = [(bf16(w), b) for w, b in ws]
    want = np.asarray(sa_ball_mlp_max(
        *(jnp.asarray(a) for a in (xyz, centers, v, w0x, mul0, add0)),
        tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in ws), 1.2, 8, interpret=True),
        np.float32)
    got = tsa.sa_ball_mlp_max(t(xyz), t(centers), t(v), t(w0x), t(mul0), t(add0),
                              [(t(w), t(b)) for w, b in ws], 1.2, 8)
    close(got.numpy(), want, rtol=3e-2, atol=1e-2)
    np.testing.assert_array_equal(
        tpoints.ball_query(t(centers), t(xyz), 1.2, 8).numpy(),
        np.asarray(jpoints.ball_query(jnp.asarray(centers), jnp.asarray(xyz), 1.2, 8)))


def fp_inputs(seed, b=2, nt=24, ns=10, c=8, cs=6, chain=(16, 12)):
    rng = np.random.default_rng(seed)
    unknown, known = cloud(seed, b, nt), cloud(seed + 1, b, ns)
    kf = rng.standard_normal((b, ns, c)).astype(np.float32)
    uf = rng.standard_normal((b, nt, cs)).astype(np.float32)
    ws, cin = [], c + cs
    for co in chain:
        ws.append(((rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32),
                   (rng.standard_normal(co) * 0.1).astype(np.float32)))
        cin = co
    return unknown, known, kf, uf, ws


def test_fp_plain_matches_jax_fpmodule():
    """The FP kernel's plain version against the JAX FPModule's XLA path
    (BN off, so its dense layers are the chain's)."""
    unknown, known, kf, uf, ws = fp_inputs(12)
    mod = jpn2.FPModule((16, 12), use_bn=False)
    v = {"params": {"mlp": {f"mlp{i}": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
                            for i, (w, b) in enumerate(ws)}}}
    want = mod.apply(v, *(jnp.asarray(a) for a in (unknown, known, uf, kf)), False)
    got = tfp.fp_fused(t(unknown), t(known), t(kf), t(uf), [(t(w), t(b)) for w, b in ws])
    close(got.numpy(), want)


def test_fp_plain_matches_pallas_interpret():
    unknown, known, kf, uf, ws = fp_inputs(13)
    kf, uf = bf16(kf), bf16(uf)
    ws = [(bf16(w), b) for w, b in ws]
    want = np.asarray(jfp_fused(*(jnp.asarray(a) for a in (unknown, known, kf, uf)),
                                tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in ws),
                                interpret=True), np.float32)
    got = tfp.fp_fused(t(unknown), t(known), t(kf), t(uf), [(t(w), t(b)) for w, b in ws])
    close(got.numpy(), want, rtol=3e-2, atol=1e-2)


def roi_inputs(seed, b=2, n=700, c=5):
    """Clouds and boxes holding 0 points, fewer than 32, between 32 and
    512, and more than 512."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, (b, n, 3)).astype(np.float32)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    boxes = np.tile(np.array([[0.0, 2.0, 0.0, 4.0, 4.0, 4.0, 0.4],  # ~90 points
                              [1.0, 0.5, -1.0, 1.6, 2.0, 2.0, -0.8],  # ~9
                              [50.0, 50.0, 50.0, 1.0, 1.0, 1.0, 0.0],  # none
                              [0.0, 4.0, 0.0, 8.5, 9.0, 9.0, 0.3]],  # ~600
                             np.float32)[None], (b, 1, 1))
    boxes[1] += np.array([0.3, 0, -0.2, 0, 0, 0, 0.7], np.float32)
    return pts, feats, boxes


def test_pts_in_boxes3d_and_first_k_match_jax():
    pts, _, boxes = roi_inputs(14)
    for bi in range(2):
        want = np.asarray(jroi.pts_in_boxes3d(jnp.asarray(pts[bi]), jnp.asarray(boxes[bi])))
        got = troi.pts_in_boxes3d(t(pts[bi]), t(boxes[bi])).numpy()
        np.testing.assert_array_equal(got, want)
        counts = want.sum(-1)
        assert counts[2] == 0 and 0 < counts[1] < 32 < counts[0] < 512 < counts[3], counts
        wi, wc = jroi._first_k_cycled_rows(jnp.asarray(want), 32)
        gi, gc = troi._first_k_cycled_rows(t(want), 32)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("s", [32, 512])
def test_roipool3d_plain_matches_jax(s):
    """The XLA path of ops/roipool3d.roipool3d: slots, rows and flags equal."""
    pts, feats, boxes = roi_inputs(15)
    wp, we = jroi.roipool3d(*(jnp.asarray(a) for a in (pts, feats, boxes)), sampled_pts_num=s)
    gp, ge = tcroi.roipool3d(t(pts), t(feats), t(boxes), s)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert ge[:, 2].all() and not ge[:, [0, 1, 3]].any()
    assert (gp[:, 2] == 0).all()


def test_roipool3d_plain_matches_pallas_interpret():
    """roipool3d_fused in interpret mode with the production "f32dot"
    gather (rcnn3d.pool_rcnn_inputs): equal."""
    pts, feats, boxes = roi_inputs(16, n=120)
    boxes = np.concatenate([boxes, boxes + np.array([0.5, 0, -0.5, 0, 0, 0, 0.2], np.float32)],
                           axis=1)
    wp, we = roipool3d_fused(*(jnp.asarray(a) for a in (pts, feats, boxes)), 40,
                             interpret=True, f32_channels="f32dot")
    gp, ge = tcroi.roipool3d(t(pts), t(feats), t(boxes), 40)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


def test_enlarge_box3d_matches_jax():
    boxes = roi_inputs(17)[2]
    np.testing.assert_array_equal(troi.enlarge_box3d(t(boxes), 1.0).numpy(),
                                  np.asarray(jroi.enlarge_box3d(jnp.asarray(boxes), 1.0)))


def test_wrappers_take_the_plain_version_on_the_cpu(monkeypatch):
    """A CPU tensor never reaches a launch point."""
    def boom(*a, **k):
        raise AssertionError("launch on a CPU tensor")

    for mod, name in ((tfps, "furthest_point_sample_cuda"), (tsa, "sa_ball_mlp_max_cuda"),
                      (tfp, "fp_fused_cuda"), (tcroi, "roipool3d_cuda")):
        monkeypatch.setattr(mod, name, boom)
    xyz, centers, v, w0x, mul0, add0, ws = sa_inputs(18)
    tfps.furthest_point_sample(t(xyz), 8)
    tsa.sa_ball_mlp_max(t(xyz), t(centers), t(v), t(w0x), t(mul0), t(add0),
                        [(t(w), t(b)) for w, b in ws], 1.0, 16)
    unknown, known, kf, uf, fws = fp_inputs(19)
    tfp.fp_fused(t(unknown), t(known), t(kf), t(uf), [(t(w), t(b)) for w, b in fws])
    pts, feats, boxes = roi_inputs(20)
    tcroi.roipool3d(t(pts), t(feats), t(boxes), 16)
    assert tfps.launches == tsa.launches == tfp.launches == tcroi.launches == 0
