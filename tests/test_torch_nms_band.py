"""The greedy-NMS kernel's IoU test against the quotient it stands for.

csrc/nms.cu decides IoU > thresh without a division wherever the answer
is certain and divides only in a narrow band around the threshold. Its
plain form, ops/cuda/nms.py iou_above_band_plain, must equal
fl(inter / union) > thresh in float32 on every pair: seeded random box
pairs, and pairs built so that their IoU sits within a few ulps of each
threshold, at both +1 conventions. No JAX here: the quotient is the
reference.
"""
import numpy as np
import pytest
import torch

from disprcnn_tpu_torch.ops.cuda import nms as cnms

THRESHOLDS = (0.5, 0.7, 0.8)


def inter_union(a: torch.Tensor, b: torch.Tensor, to_remove: float):
    """inter and max(area_a + area_b - inter, 1e-12) of (P, 4) box pairs, a
    the earlier box, rounded as nms_sorted_plain rounds them."""
    w = (torch.minimum(a[:, 2], b[:, 2]) - torch.maximum(a[:, 0], b[:, 0])
         + to_remove).clamp_min(0.0)
    h = (torch.minimum(a[:, 3], b[:, 3]) - torch.maximum(a[:, 1], b[:, 1])
         + to_remove).clamp_min(0.0)
    inter = w * h

    def area(x):
        return ((x[:, 2] - x[:, 0] + to_remove).clamp_min(0.0)
                * (x[:, 3] - x[:, 1] + to_remove).clamp_min(0.0))

    return inter, (area(a) + area(b) - inter).clamp_min(1e-12)


def random_pairs(rng, count: int):
    """Overlapping and disjoint boxes of 1-200 px in a 400 px square."""
    xy = rng.uniform(0, 400, (2, count, 2)).astype(np.float32)
    wh = rng.uniform(1, 200, (2, count, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    # a third of the pairs: b a small shift of a, so that many IoUs are high
    near = rng.uniform(size=count) < 1 / 3
    boxes[1, near] = boxes[0, near] + rng.uniform(-8, 8, (int(near.sum()), 4))
    return torch.from_numpy(boxes[0]), torch.from_numpy(boxes[1])


def threshold_pairs(rng, count: int, thresh: float, to_remove: float):
    """Pairs of equal boxes of W' x H' (W' = W + to_remove) with b shifted
    by dx = W' (1 - t) / (1 + t), where their IoU is t, then each of b's x
    coordinates moved by -8..8 ulps: IoUs within a few ulps of t."""
    w = rng.uniform(8, 300, count).astype(np.float32)
    h = rng.uniform(8, 300, count).astype(np.float32)
    x0 = rng.uniform(0, 800, count).astype(np.float32)
    y0 = rng.uniform(0, 300, count).astype(np.float32)
    wp = w.astype(np.float64) + to_remove
    dx = (wp * (1 - thresh) / (1 + thresh)).astype(np.float32)
    a = np.stack([x0, y0, x0 + w, y0 + h], -1)
    b = a.copy()
    b[:, 0] += dx
    b[:, 2] += dx
    for col in (0, 2):
        steps = rng.integers(-8, 9, count)
        for s in range(1, 9):
            up, down = steps >= s, steps <= -s
            b[up, col] = np.nextafter(b[up, col], np.float32(np.inf))
            b[down, col] = np.nextafter(b[down, col], np.float32(-np.inf))
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("to_remove", [0.0, 1.0])
@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_band_matches_quotient_on_random_pairs(thresh, to_remove):
    rng = np.random.default_rng(int(thresh * 10) + int(to_remove))
    a, b = random_pairs(rng, 120_000)
    inter, union = inter_union(a, b, to_remove)
    want = inter / union > thresh
    assert torch.equal(cnms.iou_above_band_plain(inter, union, thresh), want)
    # both answers occur
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize("to_remove", [0.0, 1.0])
@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_band_matches_quotient_at_the_threshold(thresh, to_remove):
    rng = np.random.default_rng(100 + int(thresh * 10) + int(to_remove))
    a, b = threshold_pairs(rng, 60_000, thresh, to_remove)
    inter, union = inter_union(a, b, to_remove)
    iou = inter / union
    want = iou > thresh
    assert torch.equal(cnms.iou_above_band_plain(inter, union, thresh), want)
    # the pairs reach the band: IoUs equal to the threshold and on either
    # side of it, and pairs that only the quotient decides
    t, th_hi, th_lo = cnms.band_thresholds(thresh)
    assert int((iou == t).sum()) > 0 and 0 < int(want.sum()) < want.numel()
    in_band = ~(inter > th_hi * union) & ~(inter < th_lo * union)
    assert int(in_band.sum()) > 100


@pytest.mark.parametrize("thresh", [0.5, 0.7, 0.8, 1e-20, 1.5, 0.0])
def test_band_matches_quotient_near_the_products(thresh):
    """inter at -8..8 ulps of fl(thresh * union) over unions of 1e-12 to
    1e9: every decision at the edge of the band; thresholds outside
    [BAND_MIN, 1] divide everywhere."""
    rng = np.random.default_rng(7)
    union = torch.from_numpy(np.exp(rng.uniform(np.log(1e-12), np.log(1e9), 50_000))
                             .astype(np.float32))
    inter = torch.tensor(thresh, dtype=torch.float32) * union
    steps = torch.from_numpy(rng.integers(-8, 9, inter.numel()))
    for s in range(1, 9):
        inter = torch.where(steps >= s, torch.nextafter(inter, torch.tensor(np.inf)), inter)
        inter = torch.where(steps <= -s, torch.nextafter(inter, torch.tensor(-np.inf)), inter)
    assert torch.equal(cnms.iou_above_band_plain(inter, union, thresh), inter / union > thresh)
