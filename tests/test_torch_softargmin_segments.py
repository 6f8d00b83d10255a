"""The soft-argmin kernel's order of operations (csrc/softargmin.cu) on the
CPU: `disparity_segments`, the D interpolation's taps by segment as the
kernel takes them, against the nonzeros of the plain version's matrix
(exactly), and `softargmin_segments_plain` (H and W taps first, then the
segments' walk: the max from each segment's two ends, one pass of base-2
exponentials with log2 e folded in, per-segment sums) against the JAX
Pallas kernel it replaces (fused_softargmin, interpret mode) and against
the plain version. D4 of 1, 2, 4 and 24, D not a multiple of D4 - 1, D
below D4 (segments with no disparity), negative and positive mindisp.

Tolerance: 1e-4 px, as tests/test_torch_psmnet.py holds the plain version
to the Pallas kernel (whose interpolation weights come from float64
positions, the port's from float32 ones).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.ops.pallas.softargmin import fused_softargmin
from disprcnn_tpu_torch.ops.cuda import softargmin as tsam

TOL_PX = 1e-4


@pytest.mark.parametrize("d4,d", [(1, 5), (2, 7), (4, 16), (24, 96), (24, 10), (8, 33),
                                  (5, 1), (64, 512)])
def test_segments_weights_are_the_matrix_nonzeros(d4, d):
    fk, first, count = tsam.disparity_segments(d4, d)
    assert fk.dtype == torch.float32 and fk.shape == (d,)
    assert count.shape == (max(d4 - 1, 1),) and int(count.sum()) == d
    assert torch.equal(first[1:], (first + count)[:-1])  # segments in order, back to back
    weights = torch.zeros(d, d4)
    for s in range(len(count)):
        for k in range(int(first[s]), int(first[s] + count[s])):
            weights[k, s] = 1 - fk[k]
            if d4 > 1:
                weights[k, s + 1] = fk[k]
    assert torch.equal(weights, tsam.interp_matrix_align_corners(d4, d))


# (B, D4, (h4, w4), (H, W), (mindisp, maxdisp))
CASES = [(2, 1, (3, 4), (9, 13), (-4, 4)),
         (2, 2, (3, 4), (9, 12), (-5, 8)),
         (2, 4, (5, 6), (17, 21), (0, 16)),
         (1, 4, (2, 3), (5, 9), (7, 17)),
         (2, 24, (7, 9), (27, 33), (-48, 48)),
         (1, 24, (4, 5), (13, 17), (5, 40)),
         (1, 24, (3, 3), (5, 5), (3, 13))]


def logits(seed, b, d4, hw4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d4, *hw4)) * 3.0).astype(np.float32)


@pytest.mark.parametrize("b,d4,hw4,out_hw,disp", CASES)
def test_segments_plain_matches_pallas(b, d4, hw4, out_hw, disp):
    x = logits(d4 + out_hw[0], b, d4, hw4)
    want = fused_softargmin(jnp.asarray(x.transpose(0, 2, 3, 1)), out_hw, *disp, interpret=True)
    got = tsam.softargmin_segments_plain(torch.from_numpy(x), out_hw, *disp)
    assert got.shape == (b, *out_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL_PX)


@pytest.mark.parametrize("b,d4,hw4,out_hw,disp", CASES)
def test_segments_plain_matches_plain(b, d4, hw4, out_hw, disp):
    x = torch.from_numpy(logits(7 * d4 + out_hw[1], b, d4, hw4))
    got = tsam.softargmin_segments_plain(x, out_hw, *disp)
    want = tsam.softargmin_plain(x, out_hw, *disp)
    assert float((got - want).abs().max()) <= TOL_PX


def test_segments_plain_survives_a_peaked_volume():
    """One logit far above its neighbours: the max from the segments' ends
    keeps every exponent <= 0 and the peak's disparity wins."""
    x = torch.zeros(1, 24, 3, 3)
    x[0, 11] = 500.0
    got = tsam.softargmin_segments_plain(x, (9, 9), -48, 48)
    want = tsam.softargmin_plain(x, (9, 9), -48, 48)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL_PX
