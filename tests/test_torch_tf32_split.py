"""The arithmetic of the tensor-core conv (csrc/conv3d_tc.cu) on the CPU:
the TF32 split, the emulated 3xTF32 conv (3D, and the feature tower's 2D
conv) against the float32 conv and against the JAX Pallas kernels it
replaces, and the staged weight layouts.

The kernel holds each operand as hi + lo, hi = tf32(v), lo = tf32(v - hi)
(10 mantissa bits, to nearest, ties away from zero), and sums lo*hi +
hi*lo + hi*hi. `conv3d_bn_3xtf32_plain` does the same products in three
F.conv3d calls (a product of two TF32 values is exact in float32), so its
distance from `conv3d_bn_plain` is the split's error, which must sit
inside the card's kernel tolerance CONV_RTOL/CONV_ATOL (bench.py:
max |diff| <= 1e-4 * max |plain| + 1e-5). One TF32 product alone does not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.ops.conv3d_packed import (pack_depth, pack_kernel, pack_kernel_strided,
                                            pack_kernel_w, unpack_depth, wpack, wunpack)
from disprcnn_tpu.ops.pallas.packed_conv import (packed_conv_bn, packed_conv_bn_s2,
                                                 wpacked_conv_bn)
from disprcnn_tpu_torch.bench import CONV_ATOL, CONV_RTOL
from disprcnn_tpu_torch.ops.cuda import conv3d as tconv

B = 2


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def wide_values(seed, n=100_000):
    """float32 values over many binades, both signs, with zeros."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    v[::997] = 0.0
    return torch.from_numpy(v.astype(np.float32))


def within_tolerance(got, want):
    err = float((got - want).abs().max())
    return err, err <= CONV_RTOL * float(want.abs().max()) + CONV_ATOL


def test_split_tf32_reconstructs_to_2_pow_minus_21():
    v = wide_values(0)
    hi, lo = tconv.split_tf32(v)
    err = (hi.double() + lo.double() - v.double()).abs()
    assert bool((err <= 2.0 ** -21 * v.double().abs()).all())
    assert torch.equal(hi[v == 0], v[v == 0]) and bool((lo[v == 0] == 0).all())


def test_split_tf32_parts_have_zero_low_mantissa_bits():
    hi, lo = tconv.split_tf32(wide_values(1))
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("sign", [1, -1])
def test_split_tf32_ties_round_away_from_zero(sign):
    """Bit patterns of 1.x with 13 dropped bits: below, at and above the
    tie; at a tie the magnitude rounds up (ties to even would keep 1.0 for
    0x3f801000); a carry crosses into the exponent."""
    cases = {0x3F800FFF: 0x3F800000, 0x3F801000: 0x3F802000, 0x3F801001: 0x3F802000,
             0x3F803000: 0x3F804000, 0x3FFFF000: 0x40000000}
    bits = torch.tensor(list(cases), dtype=torch.int64)
    want = torch.tensor(list(cases.values()), dtype=torch.int64)
    if sign < 0:
        bits, want = bits | 0x80000000, want | 0x80000000
    v = (bits - (bits >= 2 ** 31) * 2 ** 32).to(torch.int32).view(torch.float32)
    hi, _ = tconv.split_tf32(v)
    assert hi.view(torch.int32).tolist() == (want - (want >= 2 ** 31) * 2 ** 32).tolist()


@pytest.mark.parametrize("ci,co,shape,stride,residual,relu", [
    (32, 32, (5, 9, 11), 1, True, False),
    (32, 64, (5, 9, 11), 1, False, True),
    (64, 64, (4, 7, 6), 1, True, True),
    (32, 64, (6, 10, 11), 2, False, True),
    (64, 64, (5, 7, 8), 2, True, True),
    (64, 32, (4, 6, 6), 2, False, False),
])
def test_3xtf32_conv_matches_float32_conv(ci, co, shape, stride, residual, relu):
    """The kernel's arithmetic within the card tolerance of the float32
    conv, at Ci 32 and 64 (K = 864 and 1728 terms), stride 1 and 2."""
    rng = np.random.default_rng(ci + co + stride)
    x = torch.from_numpy(normal(rng, B, ci, *shape))
    w = torch.from_numpy(normal(rng, co, ci, 3, 3, 3, scale=0.05))
    mul = torch.from_numpy(normal(rng, co, scale=0.3) + 1)
    add = torch.from_numpy(normal(rng, co, scale=0.1))
    out_shape = (B, co, *((s - 1) // stride + 1 for s in shape))
    res = torch.from_numpy(normal(rng, *out_shape)) if residual else None
    got = tconv.conv3d_bn_3xtf32_plain(x, w, mul, add, res, relu, stride)
    want = tconv.conv3d_bn_plain(x, w, mul, add, res, relu, stride)
    assert got.shape == out_shape
    err, ok = within_tolerance(got, want)
    assert ok, err
    assert err <= 1e-5 * float(want.abs().max())  # float32-level, 10x inside


def test_one_tf32_product_misses_the_tolerance():
    """Why the split: hi*hi alone (plain TF32) over K = 1728 terms is off
    by more than CONV_RTOL of the output's magnitude."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(normal(rng, B, 64, 4, 8, 8))
    w = torch.from_numpy(normal(rng, 64, 64, 3, 3, 3, scale=0.05))
    (xh, _), (wh, _) = tconv.split_tf32(x), tconv.split_tf32(w)
    _, ok = within_tolerance(torch.nn.functional.conv3d(xh, wh, padding=1),
                             tconv.conv3d_bn_plain(x, w))
    assert not ok


def torch_weight(kern):
    """DHWIO (3, 3, 3, Ci, Co) -> OIDHW."""
    return torch.from_numpy(np.ascontiguousarray(kern.transpose(4, 3, 0, 1, 2)))


def ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def unpack(y4, b, g):
    """Pallas output (B*Dg, H, W, G*Co) -> (B, Co, D, H, W) numpy."""
    y = np.asarray(y4)
    y = unpack_depth(jnp.asarray(y.reshape(b, -1, *y.shape[1:])), g)
    return np.asarray(y).transpose(0, 4, 1, 2, 3)


@pytest.mark.parametrize("stride,residual", [(1, True), (2, False)])
def test_3xtf32_conv_matches_pallas(stride, residual):
    """The emulated kernel against the TPU kernels it replaces, run in
    interpret mode: packed_conv_bn (_kernel) and packed_conv_bn_s2
    (_kernel_s2), with BN and ReLU, at the JAX package's kernel tolerance."""
    rng = np.random.default_rng(7 + stride)
    d, h, w, ci, co, g = 8, 6, 10, 8, 8, 4
    x = normal(rng, B, d, h, w, ci)
    kern = normal(rng, 3, 3, 3, ci, co, scale=0.2)
    mul, add = normal(rng, co, scale=0.5) + 1.0, normal(rng, co, scale=0.1)
    res = normal(rng, B, d, h, w, co) if residual else None
    x4 = pack_depth(jnp.asarray(x), g).reshape(B * d // g, h, w, g * ci)
    if stride == 1:
        res4 = pack_depth(jnp.asarray(res), g).reshape(B * d // g, h, w, g * co)
        want = unpack(packed_conv_bn(x4, pack_kernel(jnp.asarray(kern), g), jnp.tile(mul, g),
                                     jnp.tile(add, g), d // g, g, relu=True, residual=res4,
                                     interpret=True), B, g)
    else:
        want = unpack(packed_conv_bn_s2(x4, pack_kernel_strided(jnp.asarray(kern), g),
                                        jnp.tile(mul, g // 2), jnp.tile(add, g // 2), d // g,
                                        g, relu=True, interpret=True), B, g // 2)
    got = tconv.conv3d_bn_3xtf32_plain(ncdhw(x), torch_weight(kern), torch.from_numpy(mul),
                                       torch.from_numpy(add),
                                       None if res is None else ncdhw(res), True, stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ci,co", [(32, 32), (64, 64), (6, 32)])
def test_pack_tf32_weight_is_the_b_fragment_layout(ci, co):
    """pack_tf32_weight[cc, kd, kh * 3 + kw, j, l] = [hi, hi, lo, lo] of
    the weights from input channels 8 cc + l % 4 and 8 cc + l % 4 + 4 to
    output channel 8 j + l // 4 (mma.m16n8k8's B fragment); the channels
    that pad Ci to a multiple of 8 are zero."""
    rng = np.random.default_rng(ci + co)
    w = torch.from_numpy(normal(rng, co, ci, 3, 3, 3))
    packed = tconv.pack_tf32_weight(w)
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
        want[inside] = part.numpy()[o[inside], c[inside], kd[inside], tap[inside] // 3,
                                    tap[inside] % 3]
        np.testing.assert_array_equal(packed[..., k].numpy(), want)


@pytest.mark.parametrize("ci,hw,residual,relu", [
    (32, (12, 14), False, True), (32, (12, 14), True, False),
    (64, (7, 9), True, True), (64, (7, 9), False, False),
])
def test_3xtf32_conv2d_matches_float32_conv(ci, hw, residual, relu):
    """The 2D conv in the kernel's arithmetic (the feature tower's sites:
    Ci = Co = 32 and 64, K = 288 and 576 terms) within the card tolerance
    of the float32 conv, with and without residual and ReLU."""
    rng = np.random.default_rng(ci + hw[0] + 2 * residual + relu)
    x = torch.from_numpy(normal(rng, B, ci, *hw))
    w = torch.from_numpy(normal(rng, ci, ci, 3, 3, scale=0.05))
    mul = torch.from_numpy(normal(rng, ci, scale=0.3) + 1)
    add = torch.from_numpy(normal(rng, ci, scale=0.1))
    res = torch.from_numpy(normal(rng, B, ci, *hw)) if residual else None
    got = tconv.conv2d_bn_3xtf32_plain(x, w, mul, add, res, relu)
    want = tconv.conv2d_bn_plain(x, w, mul, add, res, relu)
    assert got.shape == (B, ci, *hw)
    err, ok = within_tolerance(got, want)
    assert ok, err
    assert err <= 1e-5 * float(want.abs().max())  # float32-level, 10x inside


@pytest.mark.parametrize("residual", [False, True])
def test_3xtf32_conv2d_matches_pallas(residual):
    """The emulated 2D kernel against wpacked_conv_bn (_kernel_w, the TPU
    kernel it replaces) in interpret mode on a W-packed image (G = 4), with
    BN and ReLU, at the JAX package's kernel tolerance."""
    rng = np.random.default_rng(20 + residual)
    h, w, ci, co, g = 6, 20, 8, 8, 4
    x = normal(rng, B, h, w, ci)
    kern = normal(rng, 3, 3, ci, co, scale=0.2)
    mul, add = normal(rng, co, scale=0.5) + 1.0, normal(rng, co, scale=0.1)
    res = normal(rng, B, h, w, co) if residual else None
    want = wpacked_conv_bn(wpack(jnp.asarray(x), g), pack_kernel_w(jnp.asarray(kern), g),
                           jnp.tile(mul, g), jnp.tile(add, g), g, relu=True,
                           residual=None if res is None else wpack(jnp.asarray(res), g),
                           interpret=True)
    weight = torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 2, 0, 1)))

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    got = tconv.conv2d_bn_3xtf32_plain(nchw(x), weight, torch.from_numpy(mul),
                                       torch.from_numpy(add),
                                       None if res is None else nchw(res), True)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(wunpack(want, g)).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ci,co", [(32, 32), (64, 64), (5, 32)])
def test_pack_tf32_weight_2d_is_the_middle_depth_tap(ci, co):
    """A 2D weight (Co, Ci, 3, 3) packs as (ceil(Ci / 8), 9, Co / 8, 32,
    4): the B fragments of its taps, which are those of the middle depth
    tap of the 3D weight that holds it there (the 2D conv is the 3D body at
    D = 1, where only that tap is inside the volume); Ci padded with zeros
    to a multiple of 8."""
    rng = np.random.default_rng(ci * co)
    w = torch.from_numpy(normal(rng, co, ci, 3, 3))
    packed = tconv.pack_tf32_weight(w)
    assert packed.shape == (-(-ci // 8), 9, co // 8, 32, 4) and packed.is_contiguous()
    w3 = torch.zeros(co, ci, 3, 3, 3)
    w3[:, :, 1] = w
    assert torch.equal(packed, tconv.pack_tf32_weight(w3)[:, 1])
    hi, lo = tconv.split_tf32(w)
    k, o = 1, 3  # one fragment read out by hand: chunk 0, tap (0, 2), N-tile 0, lane 4 o + k
    assert packed[0, 2, 0, 4 * o + k].tolist() == [
        float(v) for v in (hi[o, k, 0, 2], hi[o, k + 4, 0, 2] if k + 4 < ci else 0.0,
                           lo[o, k, 0, 2], lo[o, k + 4, 0, 2] if k + 4 < ci else 0.0)]
