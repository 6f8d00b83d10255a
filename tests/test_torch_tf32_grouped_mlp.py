"""The arithmetic of row 12's tensor-core chain (csrc/grouped_mlp.cu with
csrc/mlp_wgmma.cuh) on the CPU: the grouped MLP + max with its chain in
3xTF32 (`grouped_mlp_max_3xtf32_plain`: each product lo*hi + hi*lo + hi*hi
of operands split by split_tf32) against the same function in float64 and
against the plain float32 version, a control that one TF32 product
misses, and the packed weight image that the kernel's wgmma descriptors
read.

Tolerance: the card's kernel tolerance CONV_RTOL/CONV_ATOL (bench.py: max
|diff| <= 1e-4 * max |reference| + 1e-5).
"""
import numpy as np
import pytest
import torch

from disprcnn_tpu_torch.bench import CONV_ATOL, CONV_RTOL
from disprcnn_tpu_torch.ops.cuda import grouped_mlp as tgm
from disprcnn_tpu_torch.ops.cuda.conv3d import split_tf32


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cuda.matmul.allow_tf32 = False


def inputs(seed, g, s, c0, chain):
    """Seeded x (G, S, C0), a non-trivial BN affine and a chain of weights."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((g, s, c0)).astype(np.float32))
    mul0 = torch.from_numpy(rng.uniform(0.5, 1.5, c0).astype(np.float32))
    add0 = torch.from_numpy((rng.standard_normal(c0) * 0.1).astype(np.float32))
    ws, cin = [], c0
    for co in chain:
        ws.append((torch.from_numpy((rng.standard_normal((cin, co)) / np.sqrt(cin))
                                    .astype(np.float32)),
                   torch.from_numpy((rng.standard_normal(co) * 0.1).astype(np.float32))))
        cin = co
    return x, mul0, add0, ws


def float64_max(x, mul0, add0, ws):
    y = torch.relu(x.double() * mul0.double() + add0.double())
    for w, b in ws:
        y = torch.relu(y @ w.double() + b.double())
    return y.amax(dim=1)


def within_tolerance(got, want):
    err = float((got.double() - want.double()).abs().max())
    return err, err <= CONV_RTOL * float(want.abs().max()) + CONV_ATOL


# (G, S, C0, chain after the input affine): the eight SA-off sites' widths
# and group sizes (chip_smoke.py GM_SITES) at a few groups
SITES = [
    (24, 16, 64, (64, 128)),     # RPN SA1 scale 0
    (24, 32, 64, (96, 128)),     # RPN SA1 scale 1
    (16, 16, 128, (196, 256)),   # RPN SA2 scale 0: a 196-wide layer
    (16, 32, 128, (196, 256)),   # RPN SA2 scale 1
    (8, 16, 256, (256, 512)),    # RPN SA3 scale 0
    (8, 32, 256, (384, 512)),    # RPN SA3 scale 1, the widest chain
    (12, 64, 128, (128, 128)),   # RCNN SA0
    (12, 64, 128, (128, 256)),   # RCNN SA1
]


@pytest.mark.parametrize("g,s,c0,chain", SITES)
def test_3xtf32_grouped_mlp_matches_float64(g, s, c0, chain):
    args = inputs(g + s + c0, g, s, c0, chain)
    got = tgm.grouped_mlp_max_3xtf32_plain(*args)
    assert got.shape == (g, chain[-1])
    exact = float64_max(*args)
    err, ok = within_tolerance(got, exact)
    assert ok, err
    assert err <= 1e-5 * float(exact.abs().max())  # float32-level, 10x inside
    _, ok = within_tolerance(got, tgm.grouped_mlp_max_plain(*args))
    assert ok


def test_one_tf32_product_chain_misses_the_tolerance():
    """Why the split: the chain with hi*hi alone (plain TF32) is off the
    float64 chain by more than the card tolerance."""
    x, mul0, add0, ws = inputs(3, *SITES[5])
    y = torch.relu(x * mul0 + add0)
    for w, b in ws:
        y = torch.relu(split_tf32(y)[0] @ split_tf32(w)[0] + b)
    _, ok = within_tolerance(y.amax(dim=1), float64_max(x, mul0, add0, ws))
    assert not ok


@pytest.mark.parametrize("nc", tgm.CHUNKS)
@pytest.mark.parametrize("widths", [(64, 196, 256), (128, 128, 128), (65, 70, 33, 18),
                                    (256, 384, 512), (64, 96, 128)])
def test_pack_wgmma_chain_is_the_descriptor_layout(widths, nc):
    """pack_wgmma_chain: for each layer W (Ci, Co), chunk c of nc columns
    (width NCW, the last one narrower, widths padded to 32), slab s of 32
    K values and k8 step kk, the hi image starts at the chunk's offset +
    64 NCW s + 8 NCW kk floats and the lo image 32 NCW floats later; from
    there the descriptor (no swizzle, leading byte offset 128, stride byte
    offset 256) reads W[k, n] at byte 256 (n // 8) + 128 (k // 4) + 16 (n %
    8) + 4 (k % 4) of the step (k, n within it). Every other float is
    zero."""
    rng = np.random.default_rng(len(widths) + nc)
    ws = [(torch.from_numpy(rng.standard_normal((ci, co)).astype(np.float32)), torch.zeros(co))
          for ci, co in zip(widths, widths[1:])]
    packed = tgm.pack_wgmma_chain(ws, nc).numpy()
    seen = np.zeros(packed.shape, bool)
    off = 0
    for w, _ in ws:
        ci, co = w.shape
        kp, np_ = -(-ci // 32) * 32, -(-co // 32) * 32
        hi, lo = (t.numpy() for t in split_tf32(w))
        k, n = np.meshgrid(np.arange(ci), np.arange(co), indexing="ij")
        chunk, nn = n // nc, n % nc
        ncw = np.minimum(nc, np_ - chunk * nc)
        step = off + 2 * kp * nc * chunk + 64 * ncw * (k // 32) + 8 * ncw * (k % 32 // 8)
        inner = (256 * (nn // 8) + 128 * (k % 8 // 4) + 16 * (nn % 8) + 4 * (k % 4)) // 4
        for part, shift in ((hi, 0), (lo, 32 * ncw)):
            at = step + shift + inner
            np.testing.assert_array_equal(packed[at], part[k, n])
            assert not seen[at].any()
            seen[at] = True
        off += 2 * kp * np_
    assert off == packed.size
    assert not packed[~seen].any()
