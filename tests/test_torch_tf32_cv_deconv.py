"""The arithmetic of the cost-volume conv (csrc/cost_volume_tc.cu) and the
transposed conv (csrc/conv3d_tc.cu's parity split) on the CPU: the
identities each kernel computes, in float64 and float32, their 3xTF32
models, against the JAX Pallas kernels they replace and the JAX package's
decomposed cost-volume conv, and the staged weight layouts.

- The cost volume as tap planes: per view, PL[kd, kw, o] = the (3, 1) 2D
  conv of the features to 9 Co channels, and each output the sum of the
  planes at the column taps the volume's mask keeps
  (cost_volume_conv_bn_planes_plain). It is exact: in float64 it equals
  build_cost_volume + F.conv3d to 1e-10 (values ~1e2), whatever the
  disparity range, the depth edges and |i| >= W.
- The transposed conv split by output parity: each of the 8 classes a
  stride-1 conv over the input grid (deconv3d_bn_parity_plain); in float64
  it equals F.conv_transpose3d to 1e-10.
- The 3xTF32 models (each product lo*hi + hi*lo + hi*hi of the split
  operands) sit inside the card's kernel tolerance CONV_RTOL/CONV_ATOL of
  the float32 functions (bench.py: max |diff| <= 1e-4 * max |plain| +
  1e-5), and 10x inside it (float32-level).
- Against the Pallas kernels in interpret mode: rtol 1e-4 + atol 1e-5, the
  JAX package's own tolerance for these kernels.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from disprcnn_tpu.ops.conv3d_packed import pack_depth, pack_kernel, pack_kernel_transposed
from disprcnn_tpu.ops.conv3d_packed import unpack_depth
from disprcnn_tpu.ops.cv_conv import cost_volume_conv_decomposed
from disprcnn_tpu.ops.pallas.packed_conv import cost_volume_conv_bn, packed_deconv_bn
from disprcnn_tpu_torch.bench import CONV_ATOL, CONV_RTOL
from disprcnn_tpu_torch.ops.cost_volume import build_cost_volume
from disprcnn_tpu_torch.ops.cuda import conv3d as tconv

KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)
B = 2


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def within_tolerance(got, want):
    err = float((got - want).abs().max())
    return err, err <= CONV_RTOL * float(want.abs().max()) + CONV_ATOL


def cv_inputs(seed, c, h, w, co, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    left, right = normal(rng, B, c, h, w), normal(rng, B, c, h, w)
    weight = normal(rng, co, 2 * c, 3, 3, 3, scale=0.2)
    mul, add = normal(rng, co, scale=0.3) + 1, normal(rng, co, scale=0.1)
    return [torch.from_numpy(a).to(dtype) for a in (left, right, weight, mul, add)]


def cost_volume_conv_dense(left, right, weight, mul, add, mind4, maxd4, relu=True):
    """The definition: the stored volume, then the 3D conv."""
    y = F.conv3d(build_cost_volume(left, right, mind4, maxd4), weight, padding=1)
    y = y * mul.view(1, -1, 1, 1, 1) + add.view(1, -1, 1, 1, 1)
    return torch.relu(y) if relu else y


# (mind4, maxd4, H, W): negative, zero and positive starts; D = 1 and 2
# (every slice at a depth edge); |i| >= W, which empties whole slices; the
# main path's range at a small width
CV_CASES = [(-3, 3, 5, 7), (0, 5, 4, 6), (2, 9, 3, 5), (-12, 12, 4, 9), (0, 1, 3, 4),
            (-2, 0, 4, 6), (5, 8, 3, 4), (-8, -5, 2, 3)]


@pytest.mark.parametrize("mind4,maxd4,h,w", CV_CASES)
def test_cost_volume_planes_identity_is_exact(mind4, maxd4, h, w):
    """The tap planes' masked, shifted sums equal the conv of the stored
    volume in float64, to 1e-10 (the depth padding slices zero)."""
    args = cv_inputs(w + abs(mind4), 5, h, w, 8, torch.float64)
    want = cost_volume_conv_dense(*args, mind4, maxd4, relu=False)
    got = tconv.cost_volume_conv_bn_planes_plain(*args, mind4, maxd4, relu=False)
    assert got.shape == (B, 8, maxd4 - mind4, h, w)
    assert float((got - want).abs().max()) <= 1e-10


@pytest.mark.parametrize("mind4,maxd4,h,w", CV_CASES[:4])
def test_cost_volume_planes_in_float32(mind4, maxd4, h, w):
    """In float32, the planes form and its 3xTF32 model against the float32
    conv of the stored volume: float32-level, 10x inside the card
    tolerance, at the main path's 32 -> 64 channels (K = 96 a plane)."""
    args = cv_inputs(h + w, 32, h, w, 32)
    want = tconv.cost_volume_conv_bn_plain(*args, mind4, maxd4)
    for fn in (tconv.cost_volume_conv_bn_planes_plain, tconv.cost_volume_conv_bn_3xtf32_plain):
        got = fn(*args, mind4, maxd4)
        err, ok = within_tolerance(got, want)
        assert ok and err <= 1e-5 * float(want.abs().max()), (fn.__name__, err)


def test_cost_volume_one_tf32_product_is_not_float32():
    """Why the split: the planes from hi*hi alone (plain TF32) are off the
    float32 conv by more than 1e-5 of its magnitude, 10x what the 3xTF32
    model is held to."""
    left, right, weight, mul, add = cv_inputs(3, 32, 4, 9, 32)

    def one_tf32(x, w):
        return F.conv2d(tconv.split_tf32(x)[0], tconv.split_tf32(w)[0], padding=(1, 0))
    pl, pr = tconv.cost_volume_planes(left, right, weight, one_tf32)
    got = tconv.cost_volume_planes_sum(pl, pr, -4, 4)
    want = tconv.cost_volume_conv_bn_plain(left, right, weight, None, None, -4, 4, relu=False)
    assert float((got - want).abs().max()) > 1e-5 * float(want.abs().max())


def nhwc(t):
    return jnp.asarray(t.numpy().transpose(0, 2, 3, 1))


def unpack(y4, b, g):
    """Depth-packed (B*Dg, H, W, G*Co) -> (B, Co, D, H, W) numpy."""
    y = np.asarray(y4)
    y = unpack_depth(jnp.asarray(y.reshape(b, -1, *y.shape[1:])), g)
    return np.asarray(y).transpose(0, 4, 1, 2, 3)


def dhwio(weight):
    """OIDHW -> the JAX package's DHWIO kernel."""
    return jnp.asarray(weight.numpy().transpose(2, 3, 4, 1, 0))


@pytest.mark.parametrize("mind4", [-4, 0, 3])
def test_cost_volume_planes_match_pallas(mind4):
    """Against cost_volume_conv_bn (_kernel_cv, the TPU kernel row 2
    replaces) in interpret mode, with BN and ReLU: the planes form and its
    3xTF32 model."""
    c, co, g, h, w = 4, 4, 4, 5, 9
    left, right, weight, mul, add = cv_inputs(10 + mind4, c, h, w, co)
    kern = dhwio(weight)
    want = cost_volume_conv_bn(nhwc(left), nhwc(right), pack_kernel(kern[:, :, :, :c], g),
                               pack_kernel(kern[:, :, :, c:], g), jnp.tile(mul.numpy(), g),
                               jnp.tile(add.numpy(), g), 2, g, mind4, relu=True,
                               interpret=True)
    for fn in (tconv.cost_volume_conv_bn_planes_plain, tconv.cost_volume_conv_bn_3xtf32_plain):
        got = fn(left, right, weight, mul, add, mind4, mind4 + 2 * g)
        np.testing.assert_allclose(got.numpy(), unpack(want, B, g), **KERNEL_TOL)


@pytest.mark.parametrize("mind4,maxd4,w", [(-4, 8, 14), (0, 8, 9), (-12, 12, 20)])
def test_cost_volume_planes_match_decomposed(mind4, maxd4, w):
    """Against the JAX package's decomposed cost-volume conv (ops/cv_conv.py:
    2D convs, shifted sums and per-column corrections), the raw conv: the
    planes form needs no corrections."""
    c, co, g, h = 4, 6, 4, 6
    left, right, weight, _, _ = cv_inputs(w + maxd4, c, h, w, co)
    want = cost_volume_conv_decomposed(nhwc(left), nhwc(right), dhwio(weight), mind4, maxd4, g)
    got = tconv.cost_volume_conv_bn_planes_plain(left, right, weight, None, None, mind4, maxd4,
                                                 relu=False)
    np.testing.assert_allclose(got.numpy(), unpack(want, B, g), **KERNEL_TOL)


def deconv_inputs(seed, ci, co, shape, residual, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = normal(rng, B, ci, *shape)
    weight = normal(rng, ci, co, 3, 3, 3, scale=0.2)
    mul, add = normal(rng, co, scale=0.3) + 1, normal(rng, co, scale=0.1)
    res = normal(rng, B, co, *(2 * s for s in shape)) if residual else None
    return [None if a is None else torch.from_numpy(a).to(dtype)
            for a in (x, weight, mul, add, res)]


@pytest.mark.parametrize("shape,residual,relu", [
    ((3, 4, 5), True, True), ((2, 3, 4), True, False), ((1, 5, 3), False, False),
    ((4, 1, 1), False, True),
])
def test_deconv_parity_identity_is_exact(shape, residual, relu):
    """The 8 parity classes, interleaved, equal F.conv_transpose3d (k 3,
    stride 2, padding 1, output_padding 1) in float64 to 1e-10, with and
    without the residual and the ReLU; D, H, W = 1 included."""
    x, weight, mul, add, res = deconv_inputs(sum(shape), 6, 8, shape, residual, torch.float64)
    want = tconv.deconv3d_bn_plain(x, weight, mul, add, res, relu)
    got = tconv.deconv3d_bn_parity_plain(x, weight, mul, add, res, relu)
    assert got.shape == (B, 8, *(2 * s for s in shape))
    assert float((got - want).abs().max()) <= 1e-10


@pytest.mark.parametrize("ci,co,shape,residual,relu", [
    (64, 64, (3, 4, 4), True, True), (64, 32, (3, 5, 6), True, False),
    (32, 32, (2, 3, 7), False, False),
])
def test_deconv_3xtf32_matches_float32(ci, co, shape, residual, relu):
    """The parity form and its 3xTF32 model within the card tolerance of the
    float32 transposed conv, float32-level (10x inside), at the hourglass's
    channel counts (K up to 512 terms for the odd-odd-odd class)."""
    x, weight, mul, add, res = deconv_inputs(ci + co, ci, co, shape, residual)
    want = tconv.deconv3d_bn_plain(x, weight, mul, add, res, relu)
    for fn in (tconv.deconv3d_bn_parity_plain, tconv.deconv3d_bn_3xtf32_plain):
        got = fn(x, weight, mul, add, res, relu)
        err, ok = within_tolerance(got, want)
        assert ok and err <= 1e-5 * float(want.abs().max()), (fn.__name__, err)


@pytest.mark.parametrize("residual,relu", [(True, True), (True, False), (False, False)])
def test_deconv_parity_matches_pallas(residual, relu):
    """Against packed_deconv_bn (_kernel_dc, the TPU kernel row 5 replaces)
    in interpret mode: the parity form and its 3xTF32 model, with BN (+
    residual before the ReLU, + ReLU), the depth halo crossing packing
    groups (dg = 2) and images."""
    d, h, w, ci, co, g = 4, 3, 5, 4, 4, 2
    x, weight, mul, add, res = deconv_inputs(30 + 2 * residual + relu, ci, co, (d, h, w),
                                             residual)
    # the Flax kernel correlates: the torch weight flipped in space, DHWIO
    kern = jnp.asarray(weight.numpy()[:, :, ::-1, ::-1, ::-1].transpose(2, 3, 4, 0, 1))
    x4 = pack_depth(jnp.asarray(x.numpy().transpose(0, 2, 3, 4, 1)), g)
    x4 = x4.reshape(B * d // g, h, w, g * ci)
    res4 = None
    if res is not None:
        res4 = pack_depth(jnp.asarray(res.numpy().transpose(0, 2, 3, 4, 1)), 2 * g)
        res4 = res4.reshape(B * d // g, 2 * h, 2 * w, 2 * g * co)
    want = packed_deconv_bn(x4, pack_kernel_transposed(kern, g), jnp.tile(mul.numpy(), 2 * g),
                            jnp.tile(add.numpy(), 2 * g), d // g, g, relu=relu, residual=res4,
                            interpret=True)
    for fn in (tconv.deconv3d_bn_parity_plain, tconv.deconv3d_bn_3xtf32_plain):
        got = fn(x, weight, mul, add, res, relu)
        np.testing.assert_allclose(got.numpy(), unpack(want, B, 2 * g), **KERNEL_TOL)


@pytest.mark.parametrize("co,c", [(32, 32), (64, 32), (32, 5)])
def test_pack_cost_volume_weight_is_the_b_fragment_layout(co, c):
    """pack_tf32_cost_volume_weight[v, kd, cc, kh, j, l] = [hi, hi, lo, lo]
    of weight[o, v C + ch, kd, kh, kw] for channels ch = 8 cc + l % 4 and
    + 4, column 8 j + l // 4 = kw Co + o of the (view, kd) GEMM (mma's B
    fragment); the channels that pad C to a multiple of 8 are zero."""
    rng = np.random.default_rng(co + c)
    w = torch.from_numpy(normal(rng, co, 2 * c, 3, 3, 3))
    packed = tconv.pack_tf32_cost_volume_weight(w)
    ci8 = -(-c // 8)
    assert packed.shape == (2, 3, ci8, 3, 3 * co // 8, 32, 4) and packed.is_contiguous()
    hi, lo = tconv.split_tf32(w)
    v, kd, cc, kh, j, lane = np.meshgrid(*(np.arange(n) for n in packed.shape[:6]),
                                         indexing="ij")
    col = 8 * j + lane // 4
    kw, o = col // co, col % co
    for k, (part, half) in enumerate(((hi, 0), (hi, 1), (lo, 0), (lo, 1))):
        ch = 8 * cc + lane % 4 + 4 * half
        inside = ch < c
        want = np.zeros(ch.shape, np.float32)
        want[inside] = part.numpy()[o[inside], (v * c + ch)[inside], kd[inside], kh[inside],
                                    kw[inside]]
        np.testing.assert_array_equal(packed[..., k].numpy(), want)


@pytest.mark.parametrize("ci,co", [(64, 64), (64, 32), (6, 32)])
def test_pack_deconv_weight_is_the_b_fragment_layout(ci, co):
    """pack_tf32_deconv_weight of the ConvTranspose3d weight (Ci, Co, 3, 3,
    3): [cc, kd, kh * 3 + kw, j, l] = [hi, hi, lo, lo] of weight[c, o, kd,
    kh, kw], unflipped, c = 8 cc + l % 4 and + 4, o = 8 j + l // 4; Ci padded
    with zeros to a multiple of 8."""
    rng = np.random.default_rng(ci * co)
    w = torch.from_numpy(normal(rng, ci, co, 3, 3, 3))
    packed = tconv.pack_tf32_deconv_weight(w)
    ci8 = -(-ci // 8)
    assert packed.shape == (ci8, 3, 9, co // 8, 32, 4) and packed.is_contiguous()
    hi, lo = tconv.split_tf32(w)
    cc, kd, tap, j, lane = np.meshgrid(*(np.arange(n) for n in packed.shape[:5]),
                                       indexing="ij")
    o = 8 * j + lane // 4
    for k, (part, half) in enumerate(((hi, 0), (hi, 1), (lo, 0), (lo, 1))):
        c = 8 * cc + lane % 4 + 4 * half
        inside = c < ci
        want = np.zeros(c.shape, np.float32)
        want[inside] = part.numpy()[c[inside], o[inside], kd[inside], tap[inside] // 3,
                                    tap[inside] % 3]
        np.testing.assert_array_equal(packed[..., k].numpy(), want)
