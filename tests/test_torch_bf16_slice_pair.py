"""Row 3's slice pairs on the CPU: ops/cuda/conv3d.py::conv3d_slice_pair_plain,
the stride-1 3x3x3 conv with two output slices as one tall image (the first
slice's rows, 2 zero rows, the second's), each depth tap staging both input
slices, exactly as the bf16 kernel (csrc/conv_bf16_wgmma.cu, form kStride1
with PAIR) indexes its halo, held to the conv (F.conv3d) and, on bf16
values, to the bf16 form's twin. Both comparisons sum the same 27 Ci
products in other orders, so they agree within the float32 sums' floor (27
Ci F32_SUM_ERR times the conv of |x| and |w|); the bf16 one within one bf16
step beyond it (bf16_agreement)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from disprcnn_tpu_torch.ops.cuda import conv3d as tconv
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

BF16 = torch.bfloat16

CASES = [
    (2, 64, 64, (6, 14, 14), False, True),   # the trunk's 14^2 site, cut to size
    (1, 64, 64, (3, 14, 14), True, True),    # odd D: the last pair's second slice past the volume
    (2, 13, 32, (5, 9, 11), True, False),    # Ci off the 16-channel step, odd H and W
    (1, 16, 64, (2, 7, 7), False, False),    # DispModule's 7^2 level, one pair
    (2, 5, 32, (1, 3, 2), True, True),       # D 1: one pair, its second slice absent
]


def _inputs(n, ci, co, shape, residual, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, ci, *shape), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((co, ci, 3, 3, 3), dtype=np.float32) * 0.05)
    mul = torch.from_numpy(1 + 0.3 * rng.standard_normal(co, dtype=np.float32))
    add = torch.from_numpy(0.1 * rng.standard_normal(co, dtype=np.float32))
    res = torch.from_numpy(rng.standard_normal((n, co, *shape), dtype=np.float32)) if residual \
        else None
    return x, w, mul, add, res


def _floor(ci, x, w, mul):
    """The float32 sums' worst-case rounding over the 27 Ci terms."""
    return 27 * ci * tconv.F32_SUM_ERR * tconv.conv3d_bn_plain(
        x.float().abs(), w.abs(), mul.abs(), torch.zeros_like(mul))


@pytest.mark.parametrize("n,ci,co,shape,residual,relu", CASES)
def test_slice_pairs_match_the_conv(torch_one_thread, n, ci, co, shape, residual, relu):
    x, w, mul, add, res = _inputs(n, ci, co, shape, residual, seed=ci * co + shape[0])
    got = tconv.conv3d_slice_pair_plain(x, w, mul, add, res, relu)
    want = tconv.conv3d_bn_plain(x, w, mul, add, res, relu)
    assert got.shape == want.shape == (n, co, *shape)
    # the affine scales a difference of the sums by |mul| (in the floor),
    # the residual and the ReLU do not widen it
    assert bool(((got - want).abs() <= _floor(ci, x, w, mul)).all())


@pytest.mark.parametrize("n,ci,co,shape,residual,relu", CASES)
def test_slice_pairs_match_the_bf16_twin(torch_one_thread, n, ci, co, shape, residual, relu):
    x, w, mul, add, res = _inputs(n, ci, co, shape, residual, seed=ci + co + shape[-1])
    xb = x.to(BF16)
    rb = None if res is None else res.to(BF16)
    wb = w.to(BF16).float()
    got = tconv.conv3d_slice_pair_plain(xb.float(), wb, mul, add,
                                        None if rb is None else rb.float(), relu).to(BF16)
    want = tconv.conv3d_bn_bf16_plain(xb, w, mul, add, rb, relu)
    agree = tconv.bf16_agreement(got, want, _floor(ci, xb, wb, mul))
    assert agree["beyond"] == 0 and agree["max_ulps_clear"] <= 1, agree
    assert agree["equal"] >= 0.99, agree


def test_slice_pairs_read_each_tap_where_the_kernel_does(torch_one_thread):
    """One weight tap at a time on a ramp input: output (z, y, x) of tap
    (kd, kh, kw) is input (z - 1 + kd, y - 1 + kh, x - 1 + kw), zero outside,
    so neither the rows between a pair's slices nor the slices past the
    volume leak into a tap."""
    d, h, w = 5, 4, 6
    x = torch.arange(1, 1 + d * h * w, dtype=torch.float32).view(1, 1, d, h, w)
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                wt = torch.zeros(1, 1, 3, 3, 3)
                wt[0, 0, kd, kh, kw] = 1.0
                got = tconv.conv3d_slice_pair_plain(x, wt)
                assert torch.equal(got, F.conv3d(x, wt, padding=1)), (kd, kh, kw)
