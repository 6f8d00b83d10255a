"""The order of sums of the classifier's 32 -> 1 conv kernel (csrc/conv3d.cu,
a depth-marching stencil) on the CPU: `conv3d_cl1_march_plain`, which adds
each output's products one at a time in the kernel's (kd, c, kh, kw)
order, each fused into the sum as the kernel's fmaf does, against the JAX Pallas kernel it replaces (packed_conv_bn at dg = 1,
interpret mode, as tests/test_torch_psmnet.py runs it) and against the
plain version (F.conv3d). Depths of 1 and 2 (a slice with one or no depth
neighbour), heights and widths that fill no tile and widths that are not
multiples of 4 (the kernel's scalar staging), the epilogue with and
without a residual (the classifiers' running sum) and ReLU.

Tolerances: against F.conv3d, the card's kernel tolerance
CONV_RTOL/CONV_ATOL (bench.py: max |diff| <= 1e-4 * max |plain| + 1e-5:
the same products summed in another order); against the Pallas kernel,
test_torch_psmnet.py's KERNEL_TOL (rtol 1e-4, atol 1e-5, elementwise).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.ops.conv3d_packed import pack_depth, pack_kernel
from disprcnn_tpu.ops.pallas.packed_conv import packed_conv_bn
from disprcnn_tpu_torch.bench import CONV_ATOL, CONV_RTOL
from disprcnn_tpu_torch.ops.cuda import conv3d as tconv

KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)


def cl1_inputs(seed, b, ci, d, h, w, residual):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d, h, w, ci)).astype(np.float32)  # NDHWC, as JAX takes it
    kern = (rng.standard_normal((3, 3, 3, ci, 1)) * 0.2).astype(np.float32)
    res = rng.standard_normal((b, 1, d, h, w)).astype(np.float32) if residual else None
    return x, kern, res


def torch_args(x, kern):
    return (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3))),
            torch.from_numpy(np.ascontiguousarray(kern.transpose(4, 3, 0, 1, 2))))


# (B, Ci, D, H, W)
SHAPES = [(2, 8, 1, 5, 7), (2, 8, 2, 6, 9), (1, 6, 5, 9, 13), (2, 4, 3, 33, 8)]


@pytest.mark.parametrize("b,ci,d,h,w", SHAPES)
def test_cl1_march_matches_pallas_dg1(b, ci, d, h, w):
    """packed_conv_bn at dg = 1 (G = D, Co = 1, identity affine)."""
    x, kern, _ = cl1_inputs(b + ci + d + h + w, b, ci, d, h, w, False)
    x4 = pack_depth(jnp.asarray(x), d).reshape(b, h, w, d * ci)
    want = packed_conv_bn(x4, pack_kernel(jnp.asarray(kern), d), jnp.ones(d), jnp.zeros(d),
                          1, d, relu=False, interpret=True)
    got = tconv.conv3d_cl1_march_plain(*torch_args(x, kern))
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want).transpose(0, 3, 1, 2),
                               **KERNEL_TOL)


@pytest.mark.parametrize("b,ci,d,h,w", SHAPES + [(1, 32, 4, 12, 56)])
@pytest.mark.parametrize("residual,relu", [(False, False), (True, False), (True, True)])
def test_cl1_march_matches_plain(b, ci, d, h, w, residual, relu):
    x, kern, res = cl1_inputs(7 * d + w, b, ci, d, h, w, residual)
    xt, wt = torch_args(x, kern)
    rt = None if res is None else torch.from_numpy(res)
    got = tconv.conv3d_cl1_march_plain(xt, wt, residual=rt, relu=relu)
    want = tconv.conv3d_bn_plain(xt, wt, residual=rt, relu=relu)
    assert got.shape == (b, 1, d, h, w)
    err = float((got - want).abs().max())
    assert err <= CONV_RTOL * float(want.abs().max()) + CONV_ATOL, err


def test_cl1_march_identity_affine_is_exact():
    """The classifiers' running sum joined as the residual under the identity
    affine (v * 1 + 0, then + residual) equals the sum taken after the conv
    bit for bit, as psmnet.py's eval forward relies on."""
    x, kern, res = cl1_inputs(3, 2, 8, 3, 6, 10, True)
    xt, wt = torch_args(x, kern)
    rt = torch.from_numpy(res)
    fused = tconv.conv3d_cl1_march_plain(xt, wt, torch.ones(1), torch.zeros(1), rt)
    assert torch.equal(fused, tconv.conv3d_cl1_march_plain(xt, wt) + rt)


def test_cl1_march_fuses_each_product():
    """Each product joins the running sum with one rounding, as fmaf: -1 then
    a * a with a = 1 + 2^-12 gives 2^-11 + 2^-24, which a product rounded on
    its own (1 + 2^-11, the tie to even) would lose."""
    a = np.float32(1 + 2.0 ** -12)
    x = torch.zeros(1, 1, 3, 3, 3)
    weight = torch.zeros(1, 1, 3, 3, 3)
    x[0, 0, 0, 1, 1], weight[0, 0, 0, 1, 1] = 1.0, -1.0  # tap kd = 0 of output (1, 1, 1)
    x[0, 0, 1, 1, 1], weight[0, 0, 1, 1, 1] = float(a), float(a)  # its tap kd = 1
    got = tconv.conv3d_cl1_march_plain(x, weight)
    assert float(got[0, 0, 1, 1, 1]) == 2.0 ** -11 + 2.0 ** -24
