"""The port's DispRCNN3D eval forward, up to the instance disparity
(det3d_on=False) and through the lift and PointRCNN to 3D boxes
(det3d_on=True), and the ``predict`` entry point, against the JAX package
on the CPU at small sizes.

Tolerances: the box helpers exactly (floor/ceil/max/stack of the same
float32 values); the normalized crops 1e-5 (ROIAlign's bilinear taps in
float32, values within about +-2.6); the disparity of a ROI 2e-3 px, as
for the PSMNet eval in test_torch_psmnet.py; the 2D detections as in
test_torch_detector2d.py (boxes 1e-3 px, scores 1e-4); with det3d_on,
roi_ok and random exactly, box3d and score3d within 1e-3 * max |JAX| +
1e-3 (the disparity's float32 differences pass through depth = f*B / d
into the points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.detector import disprcnn3d as j3d
from disprcnn_tpu.models.pointrcnn import lift as jlift
from disprcnn_tpu.models.detector.disprcnn import DispRCNN as JDispRCNN
from disprcnn_tpu.structures.stereo import StereoBoxes as JStereoBoxes
from disprcnn_tpu_torch.engine.inference import predict
from disprcnn_tpu_torch.models.detector import disprcnn3d as t3d
from disprcnn_tpu_torch.models.detector.disprcnn import DispRCNN
from disprcnn_tpu_torch.structures.stereo import StereoBoxes
from disprcnn_tpu_torch.utils.weights import init_random_, load_jax_variables
from torch_port_helpers import IMG_HW, TINY, draw_variables, jax_variables

DISP_ATOL = 2e-3
BOX3D_TOL = 1e-3
RAW_HW = (96, 160)
# the small det3d_on configuration: clouds of 128 points, SA ladder
# 128/64/32/16 (FPS still runs at three levels), a 32 x 32 lift grid
SMALL_3D = dict(npoints=128, lift_grid=32, sa_npoints=(128, 64, 32, 16))


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def stereo_boxes(seed, b, d, hw=RAW_HW, degenerate=True):
    """Random (B, D) stereo detections inside an image of size hw, with
    fractional coordinates; some rows degenerate (< 1 px wide or tall)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    x1 = rng.uniform(0, w - 40, (b, d))
    y1 = rng.uniform(0, h - 30, (b, d))
    bw, bh = rng.uniform(8, 40, (b, d)), rng.uniform(8, 30, (b, d))
    if degenerate:
        bw[:, 0] = 0.5
        bh[:, -1] = 0.25
    left = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    shift = rng.uniform(0, 12, (b, d))
    right = left.copy()
    right[..., 0] -= shift
    right[..., 2] -= shift - rng.uniform(-2, 2, (b, d))
    score = rng.uniform(0.1, 1, (b, d)).astype(np.float32)
    valid = rng.uniform(size=(b, d)) > 0.2
    mask = rng.uniform(size=(b, d, 28, 28)).astype(np.float32)
    return left, right.astype(np.float32), score, valid, mask


def both(left, right, score, valid, mask):
    j = JStereoBoxes(left=jnp.asarray(left), right=jnp.asarray(right), score=jnp.asarray(score),
                     valid=jnp.asarray(valid), fields={"mask": jnp.asarray(mask)})
    t = StereoBoxes(left=torch.from_numpy(left), right=torch.from_numpy(right),
                    score=torch.from_numpy(score), valid=torch.from_numpy(valid),
                    fields={"mask": torch.from_numpy(mask)})
    return j, t


def raw_images(seed, b, hw=RAW_HW):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (b, *hw, 3)).astype(np.float32) for _ in range(2)]


def test_remove_illegal_detections_matches_jax():
    j, t = both(*stereo_boxes(1, 2, 8))
    want = j3d.remove_illegal_detections(j)
    got = t3d.remove_illegal_detections(t)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not got.valid[:, 0].any() and not got.valid[:, -1].any()


def test_width_aligned_crop_boxes_matches_jax():
    left, right = (x.reshape(-1, 4) for x in stereo_boxes(2, 2, 8)[:2])
    want = j3d.width_aligned_crop_boxes(jnp.asarray(left), jnp.asarray(right))
    got = t3d.width_aligned_crop_boxes(torch.from_numpy(left), torch.from_numpy(right))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the right crop takes its y from the left box; both share one width
    np.testing.assert_array_equal(got[1][:, 1::2].numpy(), got[0][:, 1::2].numpy())
    np.testing.assert_array_equal((got[0][:, 2] - got[0][:, 0]).numpy(),
                                  (got[1][:, 2] - got[1][:, 0]).numpy())


def test_crop_and_normalize_matches_jax():
    images = raw_images(3, 2)[0]
    left, right = (x.reshape(-1, 4) for x in stereo_boxes(3, 2, 8)[:2])
    lb, _ = j3d.width_aligned_crop_boxes(jnp.asarray(left), jnp.asarray(right))
    bi = np.repeat(np.arange(2, dtype=np.int32), 8)
    want = np.asarray(j3d.crop_and_normalize(jnp.asarray(images), lb, jnp.asarray(bi), 32))
    got = t3d.crop_and_normalize(torch.from_numpy(images), torch.from_numpy(np.array(lb)),
                                 torch.from_numpy(bi), 32)
    assert got.shape == (16, 3, 32, 32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


def jax_3d(max_det, roi_size, dets, left_raw):
    """JAX DispRCNN3D(det3d_on=False) and numpy-drawn variables."""
    jm = j3d.DispRCNN3D(max_det=max_det, roi_size=roi_size, maxdisp=16, mindisp=-16,
                        det3d_on=False)
    calib = {k: jnp.ones((left_raw.shape[0],)) for k in ("fu", "fv", "cu", "cv", "tx", "ty",
                                                          "fuxb")}
    v = draw_variables(jm, jnp.asarray(left_raw), jnp.asarray(left_raw), dets, calib, seed=4,
                       train=False)
    run = jax.jit(lambda vv, a, b, dd: jm.apply(vv, a, b, dd, calib, train=False))
    return v, run


def test_disprcnn3d_eval_matches_jax():
    """DispRCNN3D(det3d_on=False) eval on fixed detections: 1 image, 2 ROIs
    (one of them invalid, which still runs) of 64x64, disparity -16..16."""
    left_raw, right_raw = raw_images(5, 1)
    j, t = both(*stereo_boxes(5, 1, 2, degenerate=False))
    v, run = jax_3d(2, 64, j, left_raw)
    want = np.asarray(run(v, jnp.asarray(left_raw), jnp.asarray(right_raw), j)["disparity_roi"])
    tm = load_jax_variables(t3d.DispRCNN3D(max_det=2, roi_size=64, maxdisp=16, mindisp=-16,
                                           device="cpu"), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(left_raw), torch.from_numpy(right_raw), t)["disparity_roi"]
    assert got.shape == want.shape == (2, 64, 64)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DISP_ATOL)


def test_det3d_on_raises():
    """det3d_on runs the lift, which needs the calibration and the sampling
    priorities (or a generator to draw them)."""
    m = t3d.DispRCNN3D(max_det=2, roi_size=32, maxdisp=16, mindisp=-16, det3d_on=True,
                       device="cpu", **SMALL_3D)
    left_raw, right_raw = (torch.from_numpy(x) for x in raw_images(9, 1))
    _, dets = both(*stereo_boxes(9, 1, 2, degenerate=False))
    with torch.no_grad(), pytest.raises(ValueError, match="calib"):
        m(left_raw, right_raw, dets)
    calib = {k: torch.ones(1) for k in t3d.CALIB_KEYS}
    with torch.no_grad(), pytest.raises(ValueError, match="priorities or a generator"):
        m(left_raw, right_raw, dets, calib)


def calib_arrays(b, hw=RAW_HW):
    """bench.py's calibration (fu = fv = 721.5, the principal point at the
    image centre, f * baseline 389.6) for b pairs."""
    vals = dict(fu=721.5, fv=721.5, cu=hw[1] / 2, cv=hw[0] / 2, tx=0.0, ty=0.0, fuxb=389.6)
    return {k: np.full((b,), v, np.float32) for k, v in vals.items()}


def jax_det3d(max_det, roi_size, dets, left_raw, right_raw, calib, seed):
    """JAX DispRCNN3D(det3d_on=True) eval on numpy-drawn variables, and the
    sampling priorities it draws: sample_fixed_points is wrapped to copy
    them out (jax.random.uniform of jax.random.split(key, R), as it draws
    them)."""
    jm = j3d.DispRCNN3D(max_det=max_det, roi_size=roi_size, maxdisp=16, mindisp=-16,
                        det3d_on=True, **SMALL_3D)
    jcal = {k: jnp.asarray(v) for k, v in calib.items()}
    v = draw_variables(jm, jnp.asarray(left_raw), jnp.asarray(right_raw), dets, jcal,
                       seed=seed, train=False)
    drawn = []
    orig = jlift.sample_fixed_points

    def sample_and_copy(key, pts, valid, npoints):
        r, c = valid.shape
        pri = jax.vmap(lambda k: jax.random.uniform(k, (c,)))(jax.random.split(key, r))
        jax.debug.callback(lambda p: drawn.append(np.array(p)), pri)
        return orig(key, pts, valid, npoints)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlift, "sample_fixed_points", sample_and_copy)
        out = jax.jit(lambda vv, a, b, dd: jm.apply(
            vv, a, b, dd, jcal, train=False, rngs={"sampling": jax.random.PRNGKey(7)}))(
            v, jnp.asarray(left_raw), jnp.asarray(right_raw), dets)
        out = jax.tree_util.tree_map(np.asarray, out)
    assert len(drawn) == 1
    return v, out, drawn[0]


def check_3d(got, want):
    for k in ("roi_ok", "random"):
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    for k in ("box3d", "score3d"):
        g, w = np.asarray(got[k]), want[k]
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= BOX3D_TOL * np.abs(w).max() + BOX3D_TOL, k


@pytest.fixture(scope="module")
def det3d_slice():
    """The JAX DispRCNN3D(det3d_on=True) on 1 pair of 96x160 with 2 valid
    detections, roi 64, disparity -16..16, and the port on the same
    variables and sampling priorities."""
    left_raw, right_raw = raw_images(10, 1)
    j, tdets = both(*stereo_boxes(10, 1, 2, degenerate=False))
    j = JStereoBoxes(left=j.left, right=j.right, score=j.score, valid=jnp.ones((1, 2), bool),
                     fields=j.fields)
    tdets.valid = torch.ones((1, 2), dtype=torch.bool)
    calib = calib_arrays(1)
    v, want, pri = jax_det3d(2, 64, j, left_raw, right_raw, calib, seed=11)
    tm = load_jax_variables(t3d.DispRCNN3D(max_det=2, roi_size=64, maxdisp=16, mindisp=-16,
                                           det3d_on=True, device="cpu", **SMALL_3D), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(left_raw), torch.from_numpy(right_raw), tdets,
                 {k: torch.from_numpy(a) for k, a in calib.items()}, torch.tensor(pri))
    return got, want, pri


def test_disprcnn3d_det3d_matches_jax(det3d_slice):
    """The whole slice: crops, iDispNet, the lift, PointRCNN's RPN,
    proposals, RoI-pool 3D, RCNN and postprocess."""
    got, want, pri = det3d_slice
    assert pri.shape == (2, 32 * 32)
    np.testing.assert_allclose(got["disparity_roi"].numpy(), want["disparity_roi"], rtol=0,
                               atol=DISP_ATOL)
    assert got["box3d"].shape == (1, 2, 7) and want["roi_ok"].all()
    check_3d(got, want)


def test_disprcnn3d_det3d_generator_draws(det3d_slice):
    """Priorities drawn from a generator give a valid run of the same
    shapes; the same generator seed gives the same boxes."""
    got, _, _ = det3d_slice
    left_raw, right_raw = (torch.from_numpy(x) for x in raw_images(10, 1))
    _, tdets = both(*stereo_boxes(10, 1, 2, degenerate=False))
    m = init_random_(t3d.DispRCNN3D(max_det=2, roi_size=64, maxdisp=16, mindisp=-16,
                                    det3d_on=True, device="cpu", **SMALL_3D),
                     torch.Generator().manual_seed(1))
    calib = {k: torch.from_numpy(a) for k, a in calib_arrays(1).items()}
    runs = []
    for _ in range(2):
        with torch.no_grad():
            runs.append(m(left_raw, right_raw, tdets, calib,
                          generator=torch.Generator().manual_seed(4)))
    for k in ("box3d", "score3d", "random", "roi_ok"):
        assert runs[0][k].shape == got[k].shape
        assert torch.equal(runs[0][k], runs[1][k])


@pytest.fixture(scope="module")
def tiny2d():
    """The TINY 2D detector's JAX eval on 1 pair of 64x128, its variables,
    and the pair's images, shared by the predict tests."""
    rng = np.random.default_rng(6)
    left, right = (rng.standard_normal((1, *IMG_HW, 3)).astype(np.float32) for _ in range(2))
    left_raw, right_raw = raw_images(6, 1, IMG_HW)
    jm2 = JDispRCNN(**TINY)
    v2 = jax_variables(jm2, seed=0)
    out2 = jax.jit(lambda vv, a, b: jm2.apply(vv, a, b, train=False))(
        v2, jnp.asarray(left), jnp.asarray(right))
    wd = out2["detections"]
    jdets = JStereoBoxes(left=wd.left, right=wd.right, score=wd.score, valid=wd.valid,
                         fields={"mask": out2["masks"]})
    return (left, right, left_raw, right_raw), v2, wd, jdets


def test_predict_matches_jax_chain(tiny2d):
    """predict at the TINY 2D configuration (1 pair of 64x128, 8 detection
    slots) and 32x32 ROIs, against DispRCNN.apply -> DispRCNN3D.apply."""
    (left, right, left_raw, right_raw), v2, wd, jdets = tiny2d
    v3, run = jax_3d(8, 32, jdets, left_raw)
    want = np.asarray(run(v3, jnp.asarray(left_raw), jnp.asarray(right_raw),
                          jdets)["disparity_roi"]).reshape(1, 8, 32, 32)

    m2 = load_jax_variables(DispRCNN(**TINY, device="cpu"), v2)
    m3 = load_jax_variables(t3d.DispRCNN3D(max_det=8, roi_size=32, maxdisp=16, mindisp=-16,
                                           device="cpu"), v3)
    got = predict(m2, m3, left, right, left_raw, right_raw)
    gd = got["detections"]
    ok = np.asarray(wd.valid)
    np.testing.assert_array_equal(gd.valid.numpy(), ok)
    assert ok.sum() >= 2
    np.testing.assert_allclose(gd.left.numpy()[ok], np.asarray(wd.left)[ok], atol=1e-3)
    np.testing.assert_allclose(gd.right.numpy()[ok], np.asarray(wd.right)[ok], atol=1e-3)
    np.testing.assert_allclose(gd.score.numpy()[ok], np.asarray(wd.score)[ok], atol=1e-4)
    assert got["disparity_roi"].shape == (1, 8, 32, 32)
    # the valid slots' crops are the same integer boxes on both sides
    crops = [t3d.width_aligned_crop_boxes(torch.as_tensor(np.asarray(d.left)[ok]),
                                          torch.as_tensor(np.asarray(d.right)[ok]))
             for d in (gd, wd)]
    for a, b in zip(*crops):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(got["disparity_roi"].numpy()[ok], want[ok], rtol=0,
                               atol=DISP_ATOL)


def test_predict_3d_matches_jax_chain(tiny2d):
    """predict with det3d_on (TINY 2D detector, 32x32 ROIs, the small 3D
    configuration) against DispRCNN.apply -> DispRCNN3D(det3d_on).apply on
    the same sampling priorities: box3d, score3d, random and roi_ok of every
    slot."""
    (left, right, left_raw, right_raw), v2, wd, jdets = tiny2d
    calib = calib_arrays(1, IMG_HW)
    # the random detector puts each right box right of its left box, so the
    # disparities are negative: a negative f * baseline makes their depths
    # positive, and the lift keeps points
    calib["fuxb"] = -calib["fuxb"]
    v3, want, pri = jax_det3d(8, 32, jdets, left_raw, right_raw, calib, seed=12)
    m2 = load_jax_variables(DispRCNN(**TINY, device="cpu"), v2)
    m3 = load_jax_variables(t3d.DispRCNN3D(max_det=8, roi_size=32, maxdisp=16, mindisp=-16,
                                           det3d_on=True, device="cpu", **SMALL_3D), v3)
    got = predict(m2, m3, left, right, left_raw, right_raw,
                  calib={k: float(a[0]) for k, a in calib.items()}, priorities=pri)
    np.testing.assert_array_equal(got["detections"].valid.numpy(), np.asarray(wd.valid))
    assert got["box3d"].shape == (1, 8, 7) and got["roi_ok"].sum() >= 2
    np.testing.assert_array_equal(got["roi_ok"].numpy(),
                                  want["roi_ok"] & np.asarray(wd.valid))
    check_3d(got, want)
