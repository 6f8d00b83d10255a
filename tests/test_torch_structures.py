"""structures/calib.py, structures/disparity.py, structures/image_list.py,
the paste functions of structures/masks.py and utils/stereo.py against the
JAX package's on seeded inputs.

Tolerances: the projections and the warp are float32 of the same formula,
held to 1e-5 relative (1e-4 px absolute where a pixel coordinate is
hundreds); the antialiased shrinking resize of a disparity map to 1e-4 of
its range (two implementations of the triangle filter); the padded batch
and the pasted masks exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.structures import calib as jcalib
from disprcnn_tpu.structures import disparity as jdisp
from disprcnn_tpu.structures import image_list as jil
from disprcnn_tpu.structures import masks as jmasks
from disprcnn_tpu.utils import stereo as jstereo
from disprcnn_tpu_torch.structures import calib as tcalib
from disprcnn_tpu_torch.structures import disparity as tdisp
from disprcnn_tpu_torch.structures import image_list as til
from disprcnn_tpu_torch.structures import masks as tmasks
from disprcnn_tpu_torch.utils import stereo as tstereo
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _calibs(seed=0):
    rng = np.random.default_rng(seed)
    fu, cu, cv = rng.uniform(600, 800), rng.uniform(550, 650), rng.uniform(150, 200)
    p2 = np.array([[fu, 0, cu, rng.uniform(30, 50)], [0, fu * 1.01, cv, rng.uniform(-1, 1)],
                   [0, 0, 1, rng.uniform(-0.01, 0.01)]], np.float32)
    p3 = p2.copy()
    p3[0, 3] -= fu * 0.54
    size = (1242, 375)
    return (jcalib.Calib(P2=jnp.asarray(p2), P3=jnp.asarray(p3), size=size),
            tcalib.Calib(P2=torch.from_numpy(p2), P3=torch.from_numpy(p3), size=size))


def close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_calib_intrinsics_and_projections_match_jax():
    j, t = _calibs(1)
    for name in ("fu", "fv", "cu", "cv", "tx", "ty", "stereo_baseline"):
        close(getattr(t, name), getattr(j, name))
    assert (t.width, t.height) == (j.width, j.height)
    rng = np.random.default_rng(2)
    u, v = rng.uniform(0, 1242, 50).astype(np.float32), rng.uniform(0, 375, 50).astype(np.float32)
    depth = rng.uniform(3, 60, 50).astype(np.float32)
    pts_t = t.img_to_rect(*map(torch.from_numpy, (u, v, depth)))
    pts_j = j.img_to_rect(*map(jnp.asarray, (u, v, depth)))
    close(pts_t, pts_j)
    uv_t, d_t = t.rect_to_img(pts_t)
    uv_j, d_j = j.rect_to_img(pts_j)
    close(uv_t, uv_j, atol=1e-4)
    close(d_t, d_j, atol=1e-5)
    disp = torch.from_numpy(rng.uniform(1, 90, 50).astype(np.float32))
    close(t.disparity_to_depth(disp), j.disparity_to_depth(jnp.asarray(disp.numpy())))
    close(t.depth_to_disparity(disp), j.depth_to_disparity(jnp.asarray(disp.numpy())))
    dm = rng.uniform(3, 60, (6, 9)).astype(np.float32)
    close(t.depth_map_to_rect(torch.from_numpy(dm)), j.depth_map_to_rect(jnp.asarray(dm)))


@pytest.mark.parametrize("box,size", [((100, 50, 400, 300), (640, 192)),
                                      ((0, 0, 1242, 375), (1248, 384))])
def test_calib_crop_and_resize_match_jax(box, size):
    j, t = _calibs(3)
    for jc, tc in ((j.crop(box), t.crop(box)), (j.resize(size), t.resize(size)),
                   (j.crop(box).resize(size), t.crop(box).resize(size))):
        close(tc.P2, jc.P2)
        close(tc.P3, jc.P3)
        assert tc.size == jc.size


@pytest.mark.parametrize("dst", [(50, 90), (20, 30), (33, 47)])
def test_resize_disparity_matches_jax(dst):
    disp = np.random.default_rng(4).uniform(0, 60, (2, 40, 64)).astype(np.float32)
    got = tdisp.resize_disparity(torch.from_numpy(disp), dst)
    want = jdisp.resize_disparity(jnp.asarray(disp), dst)
    assert got.shape == (2, *dst)
    close(got, want, rtol=0, atol=1e-4 * 60 * dst[1] / 64)


def test_crop_and_shift_disparity_match_jax():
    disp = np.random.default_rng(5).uniform(0, 60, (3, 40, 64)).astype(np.float32)
    box = (5, 7, 50, 33)
    close(tdisp.crop_disparity(torch.from_numpy(disp), box),
          jdisp.crop_disparity(jnp.asarray(disp), box), rtol=0)
    off = np.float32(12.5)
    close(tdisp.shift_disparity(torch.from_numpy(disp), off),
          jdisp.shift_disparity(jnp.asarray(disp), off), rtol=0)


@pytest.mark.parametrize("div", [0, 32])
def test_image_batch_matches_jax(div):
    rng = np.random.default_rng(6)
    ims = [rng.uniform(size=(h, w, 3)).astype(np.float32) for h, w in ((30, 70), (41, 50))]
    got, want = til.to_image_batch(ims, div), jil.to_image_batch(ims, div)
    np.testing.assert_array_equal(got.tensor, want.tensor)
    assert got.image_sizes == want.image_sizes and len(got) == len(want) == 2


def _masks(seed, n, m=28, im=(60, 90)):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(n, m, m)).astype(np.float32)
    x1 = rng.uniform(-10, im[1] - 10, n)
    y1 = rng.uniform(-10, im[0] - 10, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, 50, n), y1 + rng.uniform(1, 40, n)],
                     1).astype(np.float32)
    boxes[0] = [10.3, 12.7, 10.9, 13.1]  # under one pixel
    valid = rng.uniform(size=n) > 0.25
    return masks, boxes, valid


@pytest.mark.parametrize("thresh,padding", [(0.5, 1), (0.3, 2)])
def test_paste_masks_in_image_matches_jax(thresh, padding):
    masks, boxes, valid = _masks(7, 9)
    got = tmasks.paste_masks_in_image(torch.from_numpy(masks), torch.from_numpy(boxes),
                                      torch.from_numpy(valid), 60, 90, thresh, padding)
    want = jmasks.paste_masks_in_image(jnp.asarray(masks), jnp.asarray(boxes),
                                       jnp.asarray(valid), 60, 90, thresh, padding)
    assert got.dtype == torch.bool and got.shape == (9, 60, 90)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got[~torch.from_numpy(valid)].any()
    one = tmasks.paste_mask_in_image(torch.from_numpy(masks[1]), torch.from_numpy(boxes[1]),
                                     60, 90, thresh, padding)
    np.testing.assert_array_equal(one.numpy(), np.asarray(jax.jit(
        jmasks.paste_mask_in_image, static_argnums=(2, 3, 4, 5))(masks[1], boxes[1], 60, 90,
                                                                thresh, padding)))


def test_warp_and_photometric_error_match_jax():
    rng = np.random.default_rng(8)
    right = rng.uniform(size=(20, 33, 3)).astype(np.float32)
    left = rng.uniform(size=(20, 33, 3)).astype(np.float32)
    disp = rng.uniform(-3, 40, (20, 33)).astype(np.float32)  # some samples fall outside
    mask = rng.uniform(size=(20, 33)) > 0.5
    t = lambda a: torch.from_numpy(a)
    close(tstereo.warp_right_to_left(t(right), t(disp)),
          jax.jit(jstereo.warp_right_to_left)(right, disp), atol=1e-6)
    for m in (None, mask):
        close(tstereo.photometric_warp_error(t(left), t(right), t(disp),
                                             None if m is None else t(m)),
              jax.jit(jstereo.photometric_warp_error)(left, right, disp, m))
