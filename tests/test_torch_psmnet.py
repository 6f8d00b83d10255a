"""The port's iDispNet (PSMNet) against the JAX package on the CPU, at small
sizes: each kernel's plain PyTorch version against the JAX Pallas kernel it
replaces (run in interpret mode on inputs packed by the JAX package's own
pack_depth/pack_kernel*/wpack), then the feature tower and the whole eval
forward.

All float32. Tolerances, with their reasons:
- a plain conv against its Pallas kernel: rtol 1e-4 + atol 1e-5, the JAX
  package's own for these kernels (values O(1), sums of <= 27 * 16 terms
  taken in other orders);
- the soft-argmin: 1e-4 px (the Pallas kernel's interpolation weights come
  from float64 positions, the port's from float32 ones, as in psmnet.py);
- the feature tower: max |diff| <= 1e-5 * max |JAX| (features reach ~1e2
  with these weights; 29 conv layers summed in other orders);
- the disparity of the whole eval forward: 2e-3 px (range +-16 here),
  the same sums through ~60 conv layers and a softmax over 32 disparities.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.psmnet import psmnet as jpsm
from disprcnn_tpu.ops.conv3d_packed import (pack_depth, pack_kernel, pack_kernel_strided,
                                            pack_kernel_transposed, pack_kernel_w,
                                            unpack_depth, wpack, wunpack)
from disprcnn_tpu.ops.pallas.packed_conv import (cost_volume_conv_bn, packed_conv_bn,
                                                 packed_conv_bn_s2, packed_deconv_bn,
                                                 wpacked_conv_bn)
from disprcnn_tpu.ops.pallas.softargmin import fused_softargmin
from disprcnn_tpu_torch.models.psmnet.psmnet import FeatureExtraction, PSMNet
from disprcnn_tpu_torch.ops.cost_volume import build_cost_volume
from disprcnn_tpu_torch.ops.cuda import conv3d as tconv
from disprcnn_tpu_torch.ops.cuda import softargmin as tsam
from disprcnn_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import draw_variables

KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)
B, H, W = 2, 6, 10


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def bn_affine(rng, co):
    return normal(rng, co, scale=0.5) + 1.0, normal(rng, co, scale=0.1)


def torch_weight(kern):
    """DHWIO (3, 3, 3, Ci, Co) -> OIDHW."""
    return torch.from_numpy(np.ascontiguousarray(kern.transpose(4, 3, 0, 1, 2)))


def ncdhw(x):
    """(B, D, H, W, C) -> (B, C, D, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def nchw(x):
    """(B, H, W, C) -> (B, C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def unpack(y4, b, g):
    """Pallas output (B*Dg, H, W, G*Co) -> (B, Co, D, H, W) numpy."""
    y = np.asarray(y4)
    y = unpack_depth(jnp.asarray(y.reshape(b, -1, *y.shape[1:])), g)
    return np.asarray(y).transpose(0, 4, 1, 2, 3)


@pytest.mark.parametrize("mind4,maxd4", [(-4, 4), (0, 8), (-8, 0)])
def test_build_cost_volume_matches_jax(mind4, maxd4):
    rng = np.random.default_rng(1)
    lf, rf = normal(rng, B, H, W, 4), normal(rng, B, H, W, 4)
    want = np.asarray(jpsm.build_cost_volume(jnp.asarray(lf), jnp.asarray(rf), mind4, maxd4))
    got = build_cost_volume(*(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in (lf, rf)),
                            mind4, maxd4)
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 4, 1, 2, 3))


@pytest.mark.parametrize("mind4", [-4, 0, -7])
def test_cost_volume_conv_plain_matches_pallas(mind4):
    """cost_volume_conv_bn (Pallas, interpret) against the plain version,
    over ranges that start below, at and far below zero; the conv's depth
    padding slices are zero, not the volume at mind4 - 1 and maxd4."""
    rng = np.random.default_rng(2)
    c, co, g = 4, 4, 4
    maxd4 = mind4 + 8
    lf, rf = normal(rng, B, H, W, c), normal(rng, B, H, W, c)
    kern = normal(rng, 3, 3, 3, 2 * c, co, scale=0.2)
    mul, add = bn_affine(rng, co)
    want = cost_volume_conv_bn(
        jnp.asarray(lf), jnp.asarray(rf), pack_kernel(jnp.asarray(kern[:, :, :, :c]), g),
        pack_kernel(jnp.asarray(kern[:, :, :, c:]), g), jnp.tile(mul, g), jnp.tile(add, g),
        (maxd4 - mind4) // g, g, mind4, relu=True, interpret=True)
    got = tconv.cost_volume_conv_bn(
        *(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()) for x in (lf, rf)),
        torch_weight(kern), torch.from_numpy(mul), torch.from_numpy(add), mind4, maxd4)
    np.testing.assert_allclose(got.numpy(), unpack(want, B, g), **KERNEL_TOL)


@pytest.mark.parametrize("residual,relu", [(False, False), (False, True), (True, True),
                                           (True, False)])
def test_conv3d_bn_plain_matches_pallas(residual, relu):
    """packed_conv_bn (Pallas, interpret): conv + folded BN, with and
    without the residual (joined before the ReLU) and the ReLU, across
    image boundaries of the depth halo (B > 1)."""
    rng = np.random.default_rng(3)
    d, ci, co, g = 8, 4, 4, 4
    x = normal(rng, B, d, H, W, ci)
    kern = normal(rng, 3, 3, 3, ci, co, scale=0.2)
    mul, add = bn_affine(rng, co)
    res = normal(rng, B, d, H, W, co) if residual else None
    x4 = pack_depth(jnp.asarray(x), g).reshape(B * d // g, H, W, g * ci)
    res4 = (None if res is None
            else pack_depth(jnp.asarray(res), g).reshape(B * d // g, H, W, g * co))
    want = packed_conv_bn(x4, pack_kernel(jnp.asarray(kern), g), jnp.tile(mul, g),
                          jnp.tile(add, g), d // g, g, relu=relu, residual=res4, interpret=True)
    got = tconv.conv3d_bn(ncdhw(x), torch_weight(kern), torch.from_numpy(mul),
                          torch.from_numpy(add), None if res is None else ncdhw(res), relu)
    np.testing.assert_allclose(got.numpy(), unpack(want, B, g), **KERNEL_TOL)


def test_conv3d_cl1_plain_matches_pallas_dg1():
    """The classifier's 32 -> 1 conv form: packed_conv_bn at dg = 1 (G = D,
    Co = 1, identity affine) against the plain conv with no affine."""
    rng = np.random.default_rng(4)
    d, ci = 8, 4
    x = normal(rng, B, d, H, W, ci)
    kern = normal(rng, 3, 3, 3, ci, 1, scale=0.2)
    x4 = pack_depth(jnp.asarray(x), d).reshape(B, H, W, d * ci)
    want = packed_conv_bn(x4, pack_kernel(jnp.asarray(kern), d), jnp.ones(d), jnp.zeros(d),
                          1, d, relu=False, interpret=True)
    got = tconv.conv3d_bn(ncdhw(x), torch_weight(kern))
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want).transpose(0, 3, 1, 2),
                               **KERNEL_TOL)


@pytest.mark.parametrize("relu", [True, False])
def test_conv3d_s2_plain_matches_pallas(relu):
    """packed_conv_bn_s2 (Pallas, interpret): the stride-2 pad-1 conv + BN
    (+ ReLU), its depth halo crossing packing groups (dg = 2) and images."""
    rng = np.random.default_rng(8)
    d, ci, co, g = 8, 4, 4, 4
    x = normal(rng, B, d, H, W, ci)
    kern = normal(rng, 3, 3, 3, ci, co, scale=0.2)
    mul, add = bn_affine(rng, co)
    x4 = pack_depth(jnp.asarray(x), g).reshape(B * d // g, H, W, g * ci)
    want = packed_conv_bn_s2(x4, pack_kernel_strided(jnp.asarray(kern), g),
                             jnp.tile(mul, g // 2), jnp.tile(add, g // 2), d // g, g,
                             relu=relu, interpret=True)
    got = tconv.conv3d_bn(ncdhw(x), torch_weight(kern), torch.from_numpy(mul),
                          torch.from_numpy(add), relu=relu, stride=2)
    assert got.shape == (B, co, d // 2, H // 2, W // 2)
    np.testing.assert_allclose(got.numpy(), unpack(want, B, g // 2), **KERNEL_TOL)


def deconv_weight(kern):
    """Flax ConvTranspose kernel (3, 3, 3, Ci, Co) -> torch ConvTranspose3d
    weight (Ci, Co, 3, 3, 3), flipped in space (as utils/weights.py)."""
    return torch.from_numpy(np.ascontiguousarray(kern[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)))


@pytest.mark.parametrize("residual,relu", [(True, True), (True, False), (False, False)])
def test_deconv3d_plain_matches_pallas(residual, relu):
    """packed_deconv_bn (Pallas, interpret): ConvTranspose(k3, s2, flax
    padding (1, 2)) + BN (+ residual before the ReLU, + ReLU), the depth
    halo crossing packing groups (dg = 2) and images."""
    rng = np.random.default_rng(9)
    d, h, w, ci, co, g = 4, 3, 5, 4, 4, 2
    x = normal(rng, B, d, h, w, ci)
    kern = normal(rng, 3, 3, 3, ci, co, scale=0.2)
    mul, add = bn_affine(rng, co)
    res = normal(rng, B, 2 * d, 2 * h, 2 * w, co) if residual else None
    x4 = pack_depth(jnp.asarray(x), g).reshape(B * d // g, h, w, g * ci)
    res4 = (None if res is None else
            pack_depth(jnp.asarray(res), 2 * g).reshape(B * d // g, 2 * h, 2 * w, 2 * g * co))
    want = packed_deconv_bn(x4, pack_kernel_transposed(jnp.asarray(kern), g),
                            jnp.tile(mul, 2 * g), jnp.tile(add, 2 * g), d // g, g, relu=relu,
                            residual=res4, interpret=True)
    got = tconv.deconv3d_bn(ncdhw(x), deconv_weight(kern), torch.from_numpy(mul),
                            torch.from_numpy(add), None if res is None else ncdhw(res), relu)
    assert got.shape == (B, co, 2 * d, 2 * h, 2 * w)
    np.testing.assert_allclose(got.numpy(), unpack(want, B, 2 * g), **KERNEL_TOL)


@pytest.mark.parametrize("residual,relu", [(False, True), (True, False), (True, True)])
def test_conv2d_plain_matches_pallas(residual, relu):
    """wpacked_conv_bn (Pallas, interpret) on a W-packed image (G = 4): the
    tower's 3x3 stride-1 conv + BN (+ residual before the ReLU, + ReLU)."""
    rng = np.random.default_rng(10)
    ci, co, g = 4, 4, 4
    x = normal(rng, B, H, 2 * W, ci)
    kern = normal(rng, 3, 3, ci, co, scale=0.2)
    mul, add = bn_affine(rng, co)
    res = normal(rng, B, H, 2 * W, co) if residual else None
    want = wpacked_conv_bn(wpack(jnp.asarray(x), g), pack_kernel_w(jnp.asarray(kern), g),
                           jnp.tile(mul, g), jnp.tile(add, g), g, relu=relu,
                           residual=None if res is None else wpack(jnp.asarray(res), g),
                           interpret=True)
    weight = torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 2, 0, 1)))
    got = tconv.conv2d_bn(nchw(x), weight, torch.from_numpy(mul), torch.from_numpy(add),
                          None if res is None else nchw(res), relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(wunpack(want, g)).transpose(0, 3, 1, 2),
                               **KERNEL_TOL)


@pytest.mark.parametrize("out_hw", [(24, 32), (27, 33)])
def test_softargmin_plain_matches_pallas(out_hw):
    """fused_softargmin (Pallas, interpret) against the plain regression,
    including an output height that is not a multiple of its row stripe."""
    rng = np.random.default_rng(5)
    mindisp, maxdisp = -8, 8
    c = normal(rng, B, 7, 9, 4, scale=2.0)  # (B, h4, w4, D4)
    want = fused_softargmin(jnp.asarray(c), out_hw, mindisp, maxdisp, interpret=True)
    got = tsam.softargmin(torch.from_numpy(c.transpose(0, 3, 1, 2).copy()), out_hw, mindisp,
                          maxdisp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_in,n_out", [(1, 5), (4, 16), (7, 24), (56, 224)])
def test_interp_matrix_matches_jax(n_in, n_out):
    np.testing.assert_array_equal(
        tsam.interp_matrix_align_corners(n_in, n_out).numpy(),
        np.asarray(jpsm._interp_matrix_align_corners(n_in, n_out)))


def images(seed, b, hw):
    rng = np.random.default_rng(seed)
    return [normal(rng, b, *hw, 3) for _ in range(2)]


def test_feature_extraction_matches_jax():
    """The tower (W-packed on the JAX side at this size), SPP included."""
    jm = jpsm.FeatureExtraction()
    x = images(6, 2, (64, 64))[0]
    v = draw_variables(jm, jnp.asarray(x), seed=6)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = load_jax_variables(FeatureExtraction(), v)
    with torch.no_grad():
        got = tm(nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 16, 16, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_psmnet_eval_matches_jax():
    """PSMNet.apply(train=False) at 2 ROIs of 64x64, disparity -16..16, 3
    hourglasses, against the port's eval forward on the same weights."""
    jm = jpsm.PSMNet(maxdisp=16, mindisp=-16, num_hourglass=3)
    left, right = images(7, 2, (64, 64))
    v = draw_variables(jm, jnp.asarray(left), jnp.asarray(right), seed=7, train=False)
    want = np.asarray(jax.jit(lambda vv, a, b: jm.apply(vv, a, b, train=False))(
        v, jnp.asarray(left), jnp.asarray(right)))
    tm = load_jax_variables(PSMNet(maxdisp=16, mindisp=-16, num_hourglass=3), v)
    with torch.no_grad():
        got = tm(nchw(left), nchw(right)).numpy()
    assert got.shape == want.shape == (2, 64, 64)
    assert np.isfinite(got).all() and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_psmnet_eval_matches_jax_at_main_path_geometry():
    """The main path's geometry: one crop pair of 224x224, disparity -48..48
    (56^2 features, where the SPP's 32 and 16 pools do not tile exactly, and
    24 quarter-resolution disparities), 3 hourglasses. The same tolerance
    as at 64^2, 2e-3 px."""
    jm = jpsm.PSMNet(maxdisp=48, mindisp=-48, num_hourglass=3)
    left, right = images(8, 1, (224, 224))
    v = draw_variables(jm, jnp.asarray(left), jnp.asarray(right), seed=8, train=False)
    want = np.asarray(jax.jit(lambda vv, a, b: jm.apply(vv, a, b, train=False))(
        v, jnp.asarray(left), jnp.asarray(right)))
    tm = load_jax_variables(PSMNet(maxdisp=48, mindisp=-48, num_hourglass=3), v)
    with torch.no_grad():
        got = tm(nchw(left), nchw(right)).numpy()
    assert got.shape == want.shape == (1, 224, 224)
    assert np.isfinite(got).all() and np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
