"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked `cuda` and skips without a card. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from disprcnn_tpu_torch.models.pointrcnn import pointnet2 as tpn2
from disprcnn_tpu_torch.ops import nms as tnms
from disprcnn_tpu_torch.ops.cuda import conv3d as cconv
from disprcnn_tpu_torch.ops.cuda import fp as cfp
from disprcnn_tpu_torch.ops.cuda import fps as cfps
from disprcnn_tpu_torch.ops.cuda import grouped_mlp as cgm
from disprcnn_tpu_torch.ops.cuda import nms as cnms
from disprcnn_tpu_torch.ops.cuda import roipool3d as croi
from disprcnn_tpu_torch.ops.cuda import sa as csa
from disprcnn_tpu_torch.ops.cuda import softargmin as csam
from nms_cases import KINDS, make_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # the plain versions' cuDNN convs in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k,thresh", [(6000, 300, 0.7), (300, 16, 0.5), (1, 4, 0.5)])
def test_nms_kernel_matches_plain(card, kind, n, k, thresh):
    """The SRPN call, the box head's call, and a one-box edge. Exact."""
    boxes, scores, valid = (torch.from_numpy(x).to(card)
                            for x in make_case(9, 8, max(n, 2), kind))
    boxes, scores, valid = boxes[:, :n].contiguous(), scores[:, :n], valid[:, :n]
    before = cnms.launches
    got = tnms.nms_topk_batched(boxes, scores, valid, thresh, k)
    assert cnms.launches == before + 1
    with pytest.MonkeyPatch.context() as mp:  # the plain version, on the card
        mp.setattr(cnms, "nms_sorted_cuda", cnms.nms_sorted_plain)
        want = tnms.nms_topk_batched(boxes, scores, valid, thresh, k)
    assert cnms.launches == before + 1
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,n,k,thresh,to_remove", [
    (128, 128, 128, 0.8, 0.0), (128, 768, 768, 0.8, 0.0), (8, 1000, 1000, 0.7, 1.0),
    (3, 3000, 40, 0.5, 1.0), (2, 10000, 600, 0.7, 1.0), (2, 12000, 2000, 0.7, 1.0)])
def test_nms_kernel_at_more_sites_matches_plain(card, kind, b, n, k, thresh, to_remove):
    """The 3D proposals' BEV NMS (no +1 term, k = N) at both budgets, Ns
    that are not a multiple of 64 walked to their end and in two passes,
    and an N whose walk reads the masks from global memory. Exact."""
    boxes, scores, valid = (torch.from_numpy(x).to(card)
                            for x in make_case(n + b, b, n, kind))
    if n == 12000:
        assert cnms.walk_routes(n, k) == ("global",)
    before = cnms.launches
    got = tnms.nms_topk_batched(boxes, scores, valid, thresh, k, to_remove=to_remove)
    assert cnms.launches == before + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cnms, "nms_sorted_cuda", cnms.nms_sorted_plain)
        want = tnms.nms_topk_batched(boxes, scores, valid, thresh, k, to_remove=to_remove)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", KINDS)
def test_nms_kernel_at_the_2d_train_site_matches_plain(card, kind):
    """The SRPN's train budget in the 2D train step: 4 images, the top 2000
    boxes in score order (presorted), k = 2000, IoU 0.7, the double-view
    union. Exact."""
    boxes, scores, valid = (torch.from_numpy(x).to(card) for x in make_case(17, 4, 2000, kind))
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid = torch.gather(valid, 1, order)
    right = boxes - torch.tensor([12.0, 0.0, 12.0, 0.0], device=card)
    before = cnms.launches
    got = tnms.double_view_nms_topk_batched(boxes, right, scores, valid, 0.7, 2000,
                                            presorted=True)
    assert cnms.launches == before + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cnms, "nms_sorted_cuda", cnms.nms_sorted_plain)
        want = tnms.double_view_nms_topk_batched(boxes, right, scores, valid, 0.7, 2000,
                                                 presorted=True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,n,k,thresh,share", [
    (160, 1000, 32, 0.5, 0.05), (2, 6000, 1000, 0.7, 1.0), (2, 1000, 100, 0.4, 0.3)])
def test_nms_kernel_at_the_a6_sites_matches_plain(card, kind, b, n, k, thresh, share):
    """The single-view models' sites: the mono box head's per-class NMS (2
    images x 80 classes as one batch, N = 1000 proposals, k = 32, few valid
    boxes a row: those above the score threshold), the C4 RPN's (6000 ->
    1000) and RetinaNet's (1000 -> 100); `share` keeps about that share of
    the case's valid boxes. Exact."""
    boxes, scores, valid = (torch.from_numpy(x).to(card) for x in make_case(n + k, b, n, kind))
    gen = torch.Generator(device="cuda").manual_seed(n + b)
    valid &= torch.rand(valid.shape, generator=gen, device=card) < share
    before = cnms.launches
    got = tnms.nms_topk_batched(boxes, scores, valid, thresh, k)
    assert cnms.launches == before + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cnms, "nms_sorted_cuda", cnms.nms_sorted_plain)
        want = tnms.nms_topk_batched(boxes, scores, valid, thresh, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("hw", [(96, 312), (95, 313)])
def test_fbnet_padded_depthwise_conv_card_matches_cpu(card, k, hw):
    """FBNet's stride-2 depthwise ConvBNRelu (Flax's SAME padding, (0, 1) or
    (1, 1) at k = 3 on even and odd sides) and a whole FBNet-cham_v1a trunk
    at scale 0.5, card against CPU: 1e-5 (one conv) and 1e-4 (the trunk)
    of max |CPU| + 1e-6."""
    from disprcnn_tpu_torch.models.backbone import fbnet
    from disprcnn_tpu_torch.utils.weights import init_random_

    torch.manual_seed(k)
    conv = fbnet.ConvBNRelu(24, 24, k, stride=2, groups=24)
    init_random_(conv, torch.Generator().manual_seed(k))
    x = torch.randn(2, 24, *hw)
    with torch.no_grad():
        want = conv(x)
        got = copy.deepcopy(conv).to(card)(x.to(card)).cpu()
    assert got.shape == want.shape == (2, 24, -(-hw[0] // 2), -(-hw[1] // 2))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()) + 1e-6
    if k != 7:
        return
    trunk = init_random_(fbnet.FBNet("cham_v1a", scale_factor=0.5), torch.Generator().manual_seed(1))
    x = torch.randn(1, 3, *hw)
    with torch.no_grad():
        want = trunk(x)
        got = [g.cpu() for g in copy.deepcopy(trunk).to(card)(x.to(card))]
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()) + 1e-6


def test_nms_kernel_refuses_non_contiguous(card):
    boxes = torch.zeros(2, 8, 8, device=card)[..., :4]
    valid = torch.ones(2, 8, dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        cnms.nms_sorted_cuda(boxes, valid, 4, 0.5)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _close(got, want):
    """Kernel vs plain conv: the two sum in different orders;
    max |diff| <= 1e-4 * max |plain| + 1e-5."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()) + 1e-5, err


@pytest.mark.parametrize("co,mind4", [(32, -4), (32, 0), (32, -6), (64, 3)])
def test_cost_volume_conv_kernel_matches_plain(card, co, mind4):
    """Two column tiles (W 40), a partial row tile (H 13), and disparity
    ranges below, at and above zero; the depth padding slices are zero."""
    gen = torch.Generator(device="cuda").manual_seed(co - mind4)
    left, right = _randn(gen, 2, 32, 13, 40), _randn(gen, 2, 32, 13, 40)
    weight = _randn(gen, co, 64, 3, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    before = cconv.launches["cost_volume_conv"]
    got = cconv.cost_volume_conv_bn(left, right, weight, mul, add, mind4, mind4 + 8)
    assert cconv.launches["cost_volume_conv"] == before + 1
    _close(got, cconv.cost_volume_conv_bn_plain(left, right, weight, mul, add, mind4,
                                                mind4 + 8))


@pytest.mark.parametrize("n,c,hw,co,mind4,maxd4", [
    (2, 32, (7, 9), 32, -2, -1),     # D = 1: both depth taps in the padding
    (2, 32, (5, 11), 64, 0, 2),      # D = 2
    (3, 32, (6, 5), 32, -12, 12),    # |i| >= W: whole slices empty
    (2, 32, (4, 7), 64, 7, 11),      # every disparity >= W
    (2, 12, (9, 31), 32, -5, 6),     # C not a multiple of the 8-channel step, odd widths
    (1, 32, (3, 97), 32, -4, 4),     # a width past the sum's channel groups' rows
    (8, 32, (56, 56), 32, -12, 12),  # the main path's site at N = 8
    (2, 32, (1, 13), 32, -3, 3),     # H = 1
])
def test_cost_volume_conv_kernel_edges(card, n, c, hw, co, mind4, maxd4):
    """The planes form at the depth edges (D = 1, 2), disparities that
    empty whole slices, ragged C, H and W."""
    gen = torch.Generator(device="cuda").manual_seed(n + c + hw[1] - mind4)
    left, right = _randn(gen, n, c, *hw), _randn(gen, n, c, *hw)
    weight = _randn(gen, co, 2 * c, 3, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    got = cconv.cost_volume_conv_bn(left, right, weight, mul, add, mind4, maxd4)
    assert got.shape == (n, co, maxd4 - mind4, *hw)
    _close(got, cconv.cost_volume_conv_bn_plain(left, right, weight, mul, add, mind4, maxd4))


@pytest.mark.parametrize("co,c", [(32, 32), (64, 32), (32, 5), (64, 12)])
def test_cost_volume_pack_kernel_matches_plain(card, co, c):
    """The cost-volume planes' weight packing (one launch) equals
    pack_tf32_cost_volume_weight bit for bit, C not a multiple of 8 padded
    with zeros."""
    gen = torch.Generator(device="cuda").manual_seed(co + c)
    weight = _randn(gen, co, 2 * c, 3, 3, 3)
    got = cconv.pack_tf32_cost_volume_weight_cuda(weight)
    torch.cuda.synchronize()
    assert torch.equal(got, cconv.pack_tf32_cost_volume_weight(weight))


def test_cost_volume_kernel_refuses_bad_inputs(card):
    left = torch.zeros(1, 32, 4, 8, device=card)
    w = torch.zeros(32, 64, 3, 3, 3, device=card)
    mul, add = torch.ones(32, device=card), torch.zeros(32, device=card)
    with pytest.raises(ValueError, match="Co"):
        cconv.cost_volume_conv_bn_cuda(left, left, torch.zeros(16, 64, 3, 3, 3, device=card),
                                       mul[:16], add[:16], -2, 2)
    with pytest.raises(ValueError, match="empty"):
        cconv.cost_volume_conv_bn_cuda(left, left, w, mul, add, 2, 2)
    with pytest.raises(ValueError, match="shape"):
        cconv.cost_volume_conv_bn_cuda(left, left, torch.zeros(32, 32, 3, 3, 3, device=card),
                                       mul, add, -2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cconv.cost_volume_conv_bn_cuda(left.transpose(2, 3), left.transpose(2, 3), w, mul, add,
                                       -2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cconv.cost_volume_conv_bn_cuda(left.cpu(), left, w, mul, add, -2, 2)
    wide = torch.zeros(1, 32, 2, 404, device=card)  # the sum's rows past shared memory
    with pytest.raises(RuntimeError, match="cost_volume_tc_cuda"):
        cconv.cost_volume_conv_bn_cuda(wide, wide, w, mul, add, -2, 2)


@pytest.mark.parametrize("ci,co,shape,residual,relu", [
    (32, 32, (6, 14, 40), False, True), (32, 32, (6, 14, 40), True, False),
    (64, 64, (6, 14, 40), True, True), (64, 64, (6, 14, 40), False, False),
    (6, 32, (6, 14, 40), False, True),  # Ci not a multiple of the kernel's 8-channel step
    # the trunk's sites (row 3): 56^2 32 -> 32, 28^2 and 14^2 64 -> 64
    (32, 32, (24, 56, 56), False, True), (32, 32, (24, 56, 56), True, False),
    (64, 64, (12, 28, 28), True, True), (64, 64, (12, 28, 28), False, True),
    (64, 64, (6, 14, 14), False, True), (64, 64, (6, 14, 14), True, False),
    # ragged: rows and columns that fill no tile, odd depth, W = 1, H = 1,
    # 32 -> 64, a width past one block's positions (column tiles)
    (32, 64, (7, 13, 37), True, True), (64, 64, (5, 9, 1), False, True),
    (32, 32, (3, 1, 29), True, False), (64, 32, (1, 3, 300), False, True),
    (32, 32, (2, 3, 600), True, True),
])
def test_conv3d_kernel_matches_plain(card, ci, co, shape, residual, relu):
    # the (6, 14, 40) cases keep their seed ci + co
    seed = ci + co + (0 if shape == (6, 14, 40) else shape[0] + shape[2])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _randn(gen, 2, ci, *shape)
    weight = _randn(gen, co, ci, 3, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    res = _randn(gen, 2, co, *shape) if residual else None
    before = cconv.launches["conv3d"]
    got = cconv.conv3d_bn(x, weight, mul, add, res, relu)
    assert cconv.launches["conv3d"] == before + 1
    _close(got, cconv.conv3d_bn_plain(x, weight, mul, add, res, relu))


CL1_CASES = [
    (3, 32, (8, 20, 36), False),
    # the main path's classifier at 4 ROI slots: 56-wide rows (14 quads), 24
    # slices; the later classifiers add the previous one's cost as residual
    (4, 32, (24, 56, 56), False), (4, 32, (24, 56, 56), True),
    # edges: one and two slices, rows and widths that fill no tile, W % 4 != 0
    # (4-byte staging), Ci not a multiple of the 4-channel stage, H = 1, a
    # width past one column tile (256 columns) with and without W % 4
    (2, 32, (1, 9, 12), True), (2, 8, (2, 7, 13), False), (3, 6, (5, 1, 30), True),
    (1, 5, (3, 11, 300), False), (1, 32, (2, 5, 601), True),
]


@pytest.mark.parametrize("n,ci,shape,residual", CL1_CASES)
def test_conv3d_cl1_kernel_matches_plain(card, n, ci, shape, residual):
    """The classifier's Ci -> 1 conv, identity affine."""
    seed = 7 if shape == (8, 20, 36) else n + ci + sum(shape)  # the first case keeps its seed
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _randn(gen, n, ci, *shape)
    weight = _randn(gen, 1, ci, 3, 3, 3, scale=0.05)
    res = _randn(gen, n, 1, *shape) if residual else None
    before = cconv.launches["conv3d_cl1"]
    got = cconv.conv3d_bn(x, weight, residual=res)
    assert cconv.launches["conv3d_cl1"] == before + 1
    _close(got, cconv.conv3d_bn_plain(x, weight, residual=res))


@pytest.mark.parametrize("n,ci,shape,residual", CL1_CASES)
def test_conv3d_cl1_kernel_matches_march(card, n, ci, shape, residual):
    """The classifier's conv against conv3d_cl1_march_plain, its own order of
    sums with each product fused: max |diff| <= 2e-6 * max |march|, 50x
    inside CONV_RTOL (the two differ only where the plain version's double
    rounding does, an ulp of a partial sum)."""
    gen = torch.Generator(device="cuda").manual_seed(n + ci + sum(shape) + 1)
    x = _randn(gen, n, ci, *shape)
    weight = _randn(gen, 1, ci, 3, 3, 3, scale=0.05)
    res = _randn(gen, n, 1, *shape) if residual else None
    got = cconv.conv3d_bn(x, weight, residual=res)
    want = cconv.conv3d_cl1_march_plain(x, weight, residual=res)
    err = float((got - want).abs().max())
    assert err <= 2e-6 * float(want.abs().max()), err


@pytest.mark.parametrize("ci,co,flip", [(32, 32, False), (32, 64, False), (64, 64, True),
                                         (6, 32, False), (64, 32, True), (6, 32, True)])
def test_tf32_pack_kernel_matches_plain(card, ci, co, flip):
    """The tensor-core conv's weight split and layout (one launch) equals
    pack_tf32_weight bit for bit, of the weight or, with flip, of the input
    gradient's weight; Ci not a multiple of 8 padded with zeros."""
    gen = torch.Generator(device="cuda").manual_seed(ci + co)
    weight = _randn(gen, ci, co, 3, 3, 3) if flip else _randn(gen, co, ci, 3, 3, 3)
    got = cconv.pack_tf32_weight_cuda(weight, flip)
    torch.cuda.synchronize()
    assert torch.equal(got, cconv.pack_tf32_weight(cconv.flip_transpose(weight) if flip
                                                   else weight))


@pytest.mark.parametrize("ci,co", [(32, 32), (64, 64), (5, 32), (32, 64)])
def test_tf32_pack_kernel_2d_matches_plain(card, ci, co):
    """The 2D conv's weight packing (one launch, one depth tap) equals
    pack_tf32_weight of the 2D weight bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(ci * co)
    weight = _randn(gen, co, ci, 3, 3)
    got = cconv.pack_tf32_weight_cuda(weight)
    torch.cuda.synchronize()
    assert got.shape == (-(-ci // 8), 9, co // 8, 32, 4)
    assert torch.equal(got, cconv.pack_tf32_weight(weight))


@pytest.mark.parametrize("widths", [(64, 64, 128), (128, 196, 256), (256, 384, 512),
                                    (64, 80, 70, 40), (128, 128, 128, 128, 256)])
def test_sa_pack_kernel_matches_plain(card, widths):
    """The SA chain's weight packing (one launch for every layer) equals
    pack_tf32_chain bit for bit, widths not multiples of 8 padded with
    zeros."""
    gen = torch.Generator(device="cuda").manual_seed(sum(widths))
    ws = [(_randn(gen, ci, co), _randn(gen, co)) for ci, co in zip(widths, widths[1:])]
    got = csa.pack_tf32_chain_cuda(ws)
    torch.cuda.synchronize()
    assert torch.equal(got, csa.pack_tf32_chain(ws))


@pytest.mark.parametrize("ci,co,shape,residual,relu", [
    (32, 64, (24, 56, 56), False, True),   # the hourglass's first stride-2 conv
    (64, 64, (12, 28, 28), False, True),   # its second
    (32, 32, (7, 13, 70), False, False),   # odd sizes, two column tiles
    (6, 64, (5, 9, 11), False, True),      # Ci not a multiple of the 8-channel step
    (32, 64, (24, 56, 56), True, False),   # with a residual
    (64, 64, (12, 28, 28), True, True),
    (64, 64, (5, 1, 9), False, True),      # H = 1
    (64, 32, (4, 6, 1), True, True),       # W = 1
    (32, 64, (3, 27, 3), False, False),    # odd sizes, depth 3
    (64, 64, (2, 5, 601), False, True),    # output wider than a block's positions
])
def test_conv3d_s2_kernel_matches_plain(card, ci, co, shape, residual, relu):
    gen = torch.Generator(device="cuda").manual_seed(ci + co + shape[0])
    x = _randn(gen, 2, ci, *shape)
    weight = _randn(gen, co, ci, 3, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    out_shape = (2, co, *((s - 1) // 2 + 1 for s in shape))
    res = _randn(gen, *out_shape) if residual else None
    before = cconv.launches["conv3d_s2"]
    got = cconv.conv3d_bn(x, weight, mul, add, res, relu=relu, stride=2)
    assert cconv.launches["conv3d_s2"] == before + 1
    assert got.shape == out_shape
    _close(got, cconv.conv3d_bn_plain(x, weight, mul, add, res, relu=relu, stride=2))


@pytest.mark.parametrize("ci,co,shape,residual,relu", [
    (64, 64, (6, 14, 14), True, True),    # the hourglass's first transposed conv
    (64, 32, (12, 28, 28), True, False),  # its second
    (64, 32, (3, 5, 40), False, False),   # odd sizes, two column tiles
    (6, 64, (2, 3, 7), True, True),       # Ci not a multiple of the 4-channel step
    (64, 64, (1, 5, 7), True, True),      # D = 1: the odd slice's second depth tap is past the edge
    (32, 32, (2, 9, 13), False, True),    # D = 2, odd sizes
    (64, 64, (3, 7, 33), True, False),    # a last short row tile, odd width
    (64, 32, (2, 4, 1), True, True),      # W = 1
    (64, 64, (2, 1, 6), False, False),    # H = 1
    (64, 64, (1, 2, 150), True, True),    # an input wider than a block's positions
    (13, 32, (3, 6, 6), False, True),     # Ci not a multiple of the 8-channel step
])
def test_deconv3d_kernel_matches_plain(card, ci, co, shape, residual, relu):
    gen = torch.Generator(device="cuda").manual_seed(ci + co + shape[0])
    x = _randn(gen, 2, ci, *shape)
    weight = _randn(gen, ci, co, 3, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    out_shape = (2, co, *(2 * s for s in shape))
    res = _randn(gen, *out_shape) if residual else None
    before = cconv.launches["deconv3d"]
    got = cconv.deconv3d_bn(x, weight, mul, add, res, relu)
    assert cconv.launches["deconv3d"] == before + 1
    assert got.shape == out_shape
    _close(got, cconv.deconv3d_bn_plain(x, weight, mul, add, res, relu))


@pytest.mark.parametrize("ci,co", [(64, 64), (64, 32), (6, 64), (13, 32)])
def test_deconv_pack_kernel_matches_plain(card, ci, co):
    """The transposed conv's weight packing (one launch) equals
    pack_tf32_deconv_weight of the ConvTranspose3d weight bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(ci * co + 1)
    weight = _randn(gen, ci, co, 3, 3, 3)
    got = cconv.pack_tf32_deconv_weight_cuda(weight)
    torch.cuda.synchronize()
    assert torch.equal(got, cconv.pack_tf32_deconv_weight(weight))


def test_deconv3d_kernel_refuses_bad_inputs(card):
    x = torch.zeros(1, 64, 2, 4, 4, device=card)
    w = torch.zeros(64, 32, 3, 3, 3, device=card)
    mul, add = torch.ones(32, device=card), torch.zeros(32, device=card)
    with pytest.raises(ValueError, match="Co"):
        cconv.deconv3d_bn_cuda(x, torch.zeros(64, 16, 3, 3, 3, device=card), mul[:16],
                               add[:16])
    with pytest.raises(ValueError, match="residual"):
        cconv.deconv3d_bn_cuda(x, w, mul, add, torch.zeros(1, 32, 4, 8, 7, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        cconv.deconv3d_bn_cuda(x.transpose(3, 4), w, mul, add)
    with pytest.raises(ValueError, match="CUDA"):
        cconv.deconv3d_bn_cuda(x.cpu(), w, mul, add)


@pytest.mark.parametrize("ci,co,hw,residual,relu,n", [
    (32, 32, (112, 112), False, True, 3), (32, 32, (112, 112), True, False, 3),
    (64, 64, (56, 56), True, False, 3), (64, 64, (13, 70), False, True, 3),
    (5, 32, (9, 33), True, True, 3),  # Ci not a multiple of the 8-channel step
    # the feature tower's two sites (112^2 32 -> 32, 56^2 64 -> 64) at N = 2
    (32, 32, (112, 112), False, True, 2), (64, 64, (56, 56), True, False, 2),
    # ragged sizes: a last short row tile, a width over one tile's positions
    # (two column tiles), one row, one column, 32 -> 64
    (32, 32, (113, 111), True, True, 2), (64, 64, (57, 55), False, False, 2),
    (64, 64, (5, 300), False, True, 2), (32, 32, (1, 40), True, False, 2),
    (32, 32, (37, 1), False, True, 2), (32, 64, (20, 24), False, True, 2),
])
def test_conv2d_kernel_matches_plain(card, ci, co, hw, residual, relu, n):
    """The 2D conv on the tensor cores (csrc/conv3d_tc.cu at depth 1)."""
    gen = torch.Generator(device="cuda").manual_seed(ci + co + hw[0])
    x = _randn(gen, n, ci, *hw)
    weight = _randn(gen, co, ci, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    res = _randn(gen, n, co, *hw) if residual else None
    before = cconv.launches["conv2d"]
    got = cconv.conv2d_bn(x, weight, mul, add, res, relu)
    assert cconv.launches["conv2d"] == before + 1
    _close(got, cconv.conv2d_bn_plain(x, weight, mul, add, res, relu))


def test_conv3d_kernel_refuses_bad_inputs(card):
    x = torch.zeros(1, 32, 4, 8, 8, device=card)
    w = torch.zeros(32, 32, 3, 3, 3, device=card)
    with pytest.raises(ValueError, match="Co"):
        cconv.conv3d_bn_cuda(x, torch.zeros(16, 32, 3, 3, 3, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        cconv.conv3d_bn_cuda(x.transpose(3, 4), w)
    with pytest.raises(ValueError, match="CUDA"):
        cconv.conv3d_bn_cuda(x.cpu(), w)


@pytest.mark.parametrize("b,d4,hw4,out_hw,disp", [
    (2, 24, (14, 14), (56, 56), (-48, 48)),
    (2, 8, (7, 9), (27, 33), (-16, 16)),
    (1, 4, (1, 5), (3, 17), (0, 16)),  # one row of logits
])
def test_softargmin_kernel_matches_plain(card, b, d4, hw4, out_hw, disp):
    """Within 1e-3 px: the kernel interpolates H and W before D and takes
    the softmax online."""
    gen = torch.Generator(device="cuda").manual_seed(d4)
    logits = _randn(gen, b, d4, *hw4, scale=3.0)
    before = csam.launches
    got = csam.softargmin(logits, out_hw, *disp)
    assert csam.launches == before + 1
    want = csam.softargmin_plain(logits, out_hw, *disp)
    torch.cuda.synchronize()
    assert got.shape == (b, *out_hw)
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("b,d4,hw4,out_hw,disp", [
    (2, 3, (5, 6), (19, 23), (-10, 11)),
    (2, 8, (6, 5), (21, 17), (0, 40)),
    (2, 13, (4, 7), (15, 25), (-30, 20)),
    (2, 24, (56, 56), (224, 224), (-48, 48)),  # the main path's shape at B = 2
    (1, 31, (5, 5), (17, 17), (-64, 64)),
    (1, 48, (3, 4), (9, 13), (5, 200)),
    (1, 64, (4, 4), (13, 13), (-256, 256)),
])
def test_softargmin_kernel_specialisations_match_plain(card, b, d4, hw4, out_hw, disp):
    """Each D4 instantiation of the segment walk (D4 <= 4, 8, 16, 24, 32,
    48, 64) within 1e-3 px; D = 512 is the largest the wrapper takes."""
    gen = torch.Generator(device="cuda").manual_seed(100 + d4)
    logits = _randn(gen, b, d4, *hw4, scale=3.0)
    got = csam.softargmin_cuda(logits, out_hw, *disp)
    want = csam.softargmin_plain(logits, out_hw, *disp)
    torch.cuda.synchronize()
    assert got.shape == (b, *out_hw) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-3


def test_softargmin_kernel_refuses_bad_inputs(card):
    logits = torch.zeros(1, 4, 3, 3, device=card)
    with pytest.raises(ValueError, match="D4"):
        csam.softargmin_cuda(torch.zeros(1, 65, 3, 3, device=card), (5, 5), 0, 8)
    with pytest.raises(ValueError, match="maxdisp"):
        csam.softargmin_cuda(logits, (5, 5), 0, 513)


@pytest.mark.parametrize("n_in,n_out", [(56, 224), (24, 96), (14, 56), (1, 7)])
def test_interp_matrix_on_card_divides_exactly(card, n_in, n_out):
    """The matrix the soft-argmin's plain version uses on the card holds the
    weights at the correctly rounded float32 positions o * (n_in - 1) /
    (n_out - 1), as the kernel and the JAX package compute them (numpy's
    float32 division here), not at a multiply by the reciprocal: exactly."""
    got = csam.interp_matrix_align_corners(n_in, n_out, card)
    assert got.device.type == "cuda"
    want = np.zeros((n_out, n_in), np.float32)
    if n_in == 1:
        want[:] = 1
    else:
        pos = np.arange(n_out, dtype=np.float32) * np.float32(n_in - 1) / np.float32(n_out - 1)
        i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
        frac = pos - i0.astype(np.float32)
        want[np.arange(n_out), i0] = np.float32(1) - frac
        want[np.arange(n_out), i0 + 1] = frac
    assert np.array_equal(got.cpu().numpy(), want)


def _clouds(gen, b, n, scale=1.5):
    """Clouds with coincident points (distance ties) and a far outlier."""
    x = _randn(gen, b, n, 3, scale=scale)
    x[:, 5] = x[:, 2]
    x[:, n - 1] = x[:, 7]
    x[:, 3] = 40.0
    return x.contiguous()


@pytest.mark.parametrize("b,n,npoint", [
    (128, 768, 512), (6, 512, 128), (9, 128, 32), (5, 1000, 999), (3, 40, 40), (2, 33, 1),
])
def test_fps_kernel_matches_plain(card, b, n, npoint):
    """Indices exactly, including the ties of coincident points and an
    all-coincident cloud (every later step takes index 0)."""
    gen = torch.Generator(device="cuda").manual_seed(n + npoint)
    xyz = _clouds(gen, b, n)
    xyz[-1] = 0.0
    before = cfps.launches
    got = cfps.furthest_point_sample(xyz, npoint)
    assert cfps.launches == before + 1
    want = cfps.furthest_point_sample_plain(xyz, npoint)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1024, 768, 512, 256, 128])
@pytest.mark.parametrize("above", [0, 1])
def test_fps_kernel_at_the_route_threshold(card, above, n):
    """At each N range of BLOCK_ROUTE_MAX_B its limit of clouds takes the
    block route, one more the warp route: indices exactly on both sides."""
    b = next(lim for n0, lim in cfps.BLOCK_ROUTE_MAX_B if n > n0) + above
    assert cfps.fps_route(b, n) == ("warp" if above else "block")
    gen = torch.Generator(device="cuda").manual_seed(b + n)
    xyz = _clouds(gen, b, n)
    xyz[-1] = 0.0
    got = cfps.furthest_point_sample(xyz, 32)
    want = cfps.furthest_point_sample_plain(xyz, 32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["block", "warp"])
@pytest.mark.parametrize("b,n,npoint", [(3, 1024, 1024), (5, 1024, 300), (7, 700, 200),
                                        (4, 257, 100), (2, 1, 1), (2048, 128, 32)])
def test_fps_kernel_routes_match_plain(card, route, b, n, npoint):
    """Both routes at any shape (N = 1024 included), indices exactly, and
    equal to the CPU twin of the route's argmax (furthest_point_sample_keys_plain)."""
    gen = torch.Generator(device="cuda").manual_seed(n + b)
    xyz = _clouds(gen, b, n) if n > 7 else _randn(gen, b, n, 3)
    xyz[-1] = 0.0
    got = cfps._launch(xyz, npoint, route)
    want = cfps.furthest_point_sample_plain(xyz, npoint)
    threads = cfps.BLOCK_THREADS if route == "block" else 32
    twin = cfps.furthest_point_sample_keys_plain(xyz.cpu(), npoint, threads)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), twin)


def _sa_args(gen, b, n, m, c0, chain):
    xyz = _clouds(gen, b, n)
    centers = torch.cat([xyz[:, :m - 1], torch.full((b, 1, 3), 30.0, device="cuda")], 1)
    v = _randn(gen, b, n, c0)
    w0x = _randn(gen, 3, c0, scale=0.5)
    mul0, add0 = 1 + _randn(gen, c0, scale=0.3), _randn(gen, c0, scale=0.1)
    ws, cin = [], c0
    for co in chain:
        ws.append((_randn(gen, cin, co, scale=cin ** -0.5), _randn(gen, co, scale=0.1)))
        cin = co
    return xyz, centers.contiguous(), v, w0x, mul0, add0, ws


@pytest.mark.parametrize("b,n,m,c0,chain,radius,s", [
    (4, 768, 512, 64, (64, 128), 0.5, 16),    # RPN SA1, both scales
    (4, 768, 512, 64, (96, 128), 1.0, 32),
    (3, 512, 256, 128, (196, 256), 1.0, 16),  # RPN SA2 (196 wide)
    (2, 256, 64, 256, (384, 512), 4.0, 32),   # RPN SA3, the widest chain
    (8, 512, 128, 128, (128, 128), 0.2, 64),  # RCNN SA0
    (8, 128, 32, 128, (128, 256), 0.4, 64),   # RCNN SA1
    (3, 100, 37, 64, (), 0.8, 16),            # no layer after mlp0, a partial tile
    (3, 90, 21, 64, (80, 70, 40), 0.8, 32),   # three layers, a width not a multiple of 4
    (2, 256, 64, 256, (256, 512), 2.0, 16),   # RPN SA3 scale 0
    (3, 512, 100, 128, (196, 256), 2.0, 32),  # RPN SA2 scale 1, a partial tile
    (5, 300, 45, 128, (128, 196), 0.6, 64),   # the last layer 196 wide, one ball a tile
    (3, 200, 50, 64, (64, 96), 1.0, 8),       # S under 16: several balls a fragment half
    (2, 150, 33, 64, (64,), 0.7, 4),
    (2, 80, 19, 64, (72, 64), 0.9, 2),
    (2, 60, 23, 64, (64, 64), 0.9, 1),
    (2, 128, 40, 96, (128, 128, 128, 256), 1.2, 32),  # four layers
])
def test_sa_kernel_matches_plain(card, b, n, m, c0, chain, radius, s):
    """max |diff| <= 1e-4 * max |plain| + 1e-5 (float32 sums in another
    order); the clouds hold empty (the far centre), partial and full balls,
    so a wrong neighbour would show far above that."""
    gen = torch.Generator(device="cuda").manual_seed(n + m + s)
    args = _sa_args(gen, b, n, m, c0, chain)
    before = csa.launches
    got = csa.sa_ball_mlp_max(*args, radius, s)
    assert csa.launches == before + 1
    want = csa.sa_ball_mlp_max_plain(*args, radius, s)
    assert got.shape == (b, m, chain[-1] if chain else c0)
    _close(got, want)


@pytest.mark.parametrize("g,s,c0,chain,negative", [
    (4096, 16, 64, (64, 128), False),    # RPN SA1 scale 0 (G cut from 65 536)
    (4096, 32, 64, (96, 128), False),    # RPN SA1 scale 1
    (2048, 16, 128, (196, 256), False),  # RPN SA2 (196 wide)
    (1024, 32, 256, (384, 512), False),  # RPN SA3 scale 1, the widest chain
    (2048, 64, 128, (128, 128), False),  # RCNN SA0
    (2048, 64, 128, (128, 256), False),  # RCNN SA1
    (1000, 16, 64, (64, 128), True),     # every pre-activation below 0: the max is 0
    (777, 1, 128, (196, 256), False),    # S = 1
    (301, 48, 64, (96, 128), False),     # S = 48: two groups and 32 idle rows a tile
    (1001, 16, 128, (128,), False),      # one layer, a last partial tile
    (517, 32, 65, (70, 33, 18), False),  # widths not multiples of 4 (the scalar path)
    # whole tiles only, each block walking one or more: the tile boundaries
    # split no group (128-row tiles of 8, 4 and 2 groups)
    (1056, 16, 64, (64, 128), False),    # S = 16: 132 tiles, one a block
    (2128, 32, 128, (128, 128), False),  # S = 32: 532 tiles
    (528, 64, 128, (128, 256), False),   # S = 64: 264 tiles, two a block
    (1001, 16, 256, (384, 512), False),  # the widest chain 256 -> 384 -> 512, S = 16
    # S neither dividing 16 nor a multiple of 16: the max value by value
    (301, 24, 64, (96, 128), False),     # groups across two warps
    (333, 5, 64, (64,), False),          # groups across warps and row halves
])
def test_grouped_mlp_kernel_matches_plain(card, g, s, c0, chain, negative):
    """Row 12: max |diff| <= 1e-4 * max |plain| + 1e-5 (float32 sums in
    another order)."""
    gen = torch.Generator(device="cuda").manual_seed(g + s + c0)
    x, mul0, add0 = _randn(gen, g, s, c0), 1 + _randn(gen, c0, scale=0.3), _randn(gen, c0,
                                                                                 scale=0.1)
    if negative:
        x, mul0, add0 = -(x.abs() + 1), mul0.abs() + 0.5, -add0.abs()
    ws, cin = [], c0
    for co in chain:
        b = _randn(gen, co, scale=0.1)
        ws.append((_randn(gen, cin, co, scale=cin ** -0.5), -b.abs() if negative else b))
        cin = co
    before = cgm.launches
    got = cgm.grouped_mlp_max(x, mul0, add0, ws)
    assert cgm.launches == before + 1
    assert got.shape == (g, chain[-1])
    want = cgm.grouped_mlp_max_plain(x, mul0, add0, ws)
    _close(got, want)
    if negative:
        assert float(got.abs().max()) == 0.0


def test_grouped_mlp_kernel_refuses_bad_inputs(card):
    x, vec = torch.zeros(8, 16, 64, device=card), torch.zeros(64, device=card)
    w = [(torch.zeros(64, 32, device=card), torch.zeros(32, device=card))]
    with pytest.raises(ValueError, match="layers"):
        cgm.grouped_mlp_max_cuda(x, vec, vec, [])
    with pytest.raises(ValueError, match="layers"):
        cgm.grouped_mlp_max_cuda(x, vec, vec, w * 5)
    with pytest.raises(ValueError, match="S <= 64"):
        cgm.grouped_mlp_max_cuda(torch.zeros(2, 65, 64, device=card), vec, vec, w)
    with pytest.raises(ValueError, match="contiguous"):
        cgm.grouped_mlp_max_cuda(torch.zeros(8, 64, 16, device=card).transpose(1, 2), vec, vec,
                                 w)
    with pytest.raises(ValueError, match="CUDA"):
        cgm.grouped_mlp_max_cuda(x.cpu(), vec.cpu(), vec.cpu(),
                                 [(t.cpu(), b.cpu()) for t, b in w])


@pytest.mark.parametrize("b,nt,ns,c,cs,chain", [
    (4, 256, 64, 1024, 512, (512, 512)),  # fp3
    (4, 512, 256, 512, 256, (512, 512)),  # fp2
    (4, 768, 512, 512, 96, (256, 256)),   # fp1
    (3, 50, 9, 20, 12, (30, 20, 10)),     # three layers, a partial tile
    (2, 70, 48, 128, 24, (64, 64)),       # a tail tile of 6 targets; the last chunk all skip
    (1, 40, 9, 100, 60, (30, 20)),        # a chunk boundary inside the skip columns;
                                          # widths not multiples of 8 or 4
    (2, 33, 11, 37, 11, (45, 17, 33, 9)),  # four layers, every width odd
    (2, 20, 8, 8, 4, (16,)),              # one layer
    (1, 100, 4096, 64, 32, (64, 64)),     # Ns at the limit: the points fill the buffers
    (1, 70, 16, 512, 512, (2048, 256)),   # a 2048-wide layer: 16-row tiles
])
def test_fp_kernel_matches_plain(card, b, nt, ns, c, cs, chain):
    gen = torch.Generator(device="cuda").manual_seed(nt + ns)
    unknown, known = _clouds(gen, b, nt), _clouds(gen, b, ns)
    unknown[:, 0] = known[:, 4]  # a zero distance
    kf, uf = _randn(gen, b, ns, c), _randn(gen, b, nt, cs)
    ws, cin = [], c + cs
    for co in chain:
        ws.append((_randn(gen, cin, co, scale=cin ** -0.5), _randn(gen, co, scale=0.1)))
        cin = co
    before = cfp.launches
    got = cfp.fp_fused(unknown, known, kf, uf, ws)
    assert cfp.launches == before + 1
    _close(got, cfp.fp_fused_plain(unknown, known, kf, uf, ws))


def _roipool_inputs(b, n, m, c):
    """Seeded points and features, and boxes holding no point, fewer than
    S and more than S."""
    gen = torch.Generator(device="cuda").manual_seed(n + m)
    pts = (torch.rand(b, n, 3, generator=gen, device="cuda") * 8 - 4).contiguous()
    feats = _randn(gen, b, n, c)
    base = torch.tensor([[0.0, 2.0, 0.0, 4.0, 4.0, 4.0, 0.4],
                         [1.0, 0.5, -1.0, 1.6, 2.0, 2.0, -0.8],
                         [50.0, 50.0, 50.0, 1.0, 1.0, 1.0, 0.0],
                         [0.0, 4.0, 0.0, 8.5, 9.0, 9.0, 0.3]], device="cuda")
    boxes = base[torch.arange(m, device="cuda") % 4][None].repeat(b, 1, 1)
    boxes[:, :, :3] += _randn(gen, b, m, 3, scale=0.3)
    return pts, feats, boxes.contiguous()


@pytest.mark.parametrize("b,n,m,c,s", [(128, 768, 16, 130, 512), (128, 768, 50, 130, 512),
                                       (3, 700, 4, 5, 32), (2, 50, 3, 0, 8)])
def test_roipool3d_kernel_matches_plain(card, b, n, m, c, s):
    """The headline and the reference block, and small edges: rows and
    flags exactly (copies of the same values)."""
    pts, feats, boxes = _roipool_inputs(b, n, m, c)
    before = croi.launches
    got, gempty = croi.roipool3d(pts, feats, boxes, s)
    assert croi.launches == before + 1
    want, wempty = croi.roipool3d_plain(pts, feats, boxes, s)
    torch.cuda.synchronize()
    assert torch.equal(gempty, wempty) and gempty.any() and not gempty.all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("route", ["bulk", "direct"])
@pytest.mark.parametrize("b,n,m,c,s", [(4, 300, 6, 130, 7), (3, 700, 5, 130, 513),
                                       (2, 500, 6, 7, 7), (2, 400, 3, 7, 45)])
def test_roipool3d_routes_match_plain(card, route, b, n, m, c, s):
    """Both routes where S is not a multiple of 4 (a box's run and its
    chunks start off 16 bytes: plain stores at both ends of each bulk
    store) and at an odd C. Exact."""
    pts, feats, boxes = _roipool_inputs(b, n, m, c)
    got, gempty = croi._launch(pts, feats, boxes, s, route=route)
    want, wempty = croi.roipool3d_plain(pts, feats, boxes, s)
    torch.cuda.synchronize()
    assert torch.equal(gempty, wempty) and gempty.any() and not gempty.all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,n,m,c,s", [(16, 768, 16, 130, 512), (3, 700, 5, 7, 45)])
def test_roipool3d_train_form_matches_plain_autograd(card, b, n, m, c, s):
    """Row 14's train form (the RPN and RCNN trained in one step): one
    kernel launch forward, rows and flags equal to the plain version's, and
    the points' and features' gradients within 1e-5 of their max of
    autograd of the plain version, under a non-uniform output gradient;
    the eval wrapper refuses a feature that needs a gradient."""
    pts, feats, boxes = _roipool_inputs(b, n, m, c)
    ct = torch.randn(b, m, s, 3 + c, device=card)
    runs = []
    for fn in (croi.roipool3d_train, croi.roipool3d_plain):
        tp, tf = pts.clone().requires_grad_(True), feats.clone().requires_grad_(True)
        before = croi.train_launches
        pooled, empty = fn(tp, tf, boxes, s)
        assert croi.train_launches == before + (fn is croi.roipool3d_train)
        pooled.backward(ct)
        runs.append((pooled.detach(), empty, tp.grad, tf.grad))
    torch.cuda.synchronize()
    (gp, ge, gdp, gdf), (wp, we, wdp, wdf) = runs
    assert torch.equal(gp, wp) and torch.equal(ge, we) and ge.any() and not ge.all()
    for g, w in ((gdp, wdp), (gdf, wdf)):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    with pytest.raises(RuntimeError, match="no backward"):
        croi.roipool3d(pts, feats.clone().requires_grad_(True), boxes, s)


def test_point_kernels_refuse_bad_inputs(card):
    xyz = torch.zeros(2, 64, 3, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        cfps.furthest_point_sample_cuda(torch.zeros(2, 3, 64, device=card).transpose(1, 2), 8)
    with pytest.raises(ValueError, match="npoint"):
        cfps.furthest_point_sample_cuda(xyz, 65)
    with pytest.raises(ValueError, match="route"):
        cfps._launch(xyz, 8, "grid")
    v = torch.zeros(2, 64, 64, device=card)
    w0x, vec = torch.zeros(3, 64, device=card), torch.zeros(64, device=card)
    with pytest.raises(ValueError, match="S dividing"):
        csa.sa_ball_mlp_max_cuda(xyz, xyz, v, w0x, vec, vec, [], 1.0, 24)
    with pytest.raises(ValueError, match="weights"):
        csa.sa_ball_mlp_max_cuda(xyz, xyz, v, w0x, vec, vec,
                                 [(torch.zeros(32, 8, device=card), vec[:8])], 1.0, 16)
    with pytest.raises(ValueError, match="CUDA"):
        croi.roipool3d_cuda(xyz.cpu(), xyz.cpu(), torch.zeros(2, 1, 7), 8)
    with pytest.raises(ValueError, match="route"):
        croi._launch(xyz, xyz, torch.zeros(2, 1, 7, device=card), 8, route="tma")


def _grads(out, leaves, dy):
    """(out, d out / d leaf for each leaf) under output gradient dy."""
    return [out.detach()] + list(torch.autograd.grad(out, leaves, dy))


@pytest.mark.parametrize("c,d,hw", [(32, 24, 56), (64, 12, 28), (64, 6, 14), (32, 5, 13),
                                    (64, 3, 9)])
def test_conv3d_train_kernel_matches_autograd(card, c, d, hw):
    """Row 8's train form at the trunk sites (two crops each) and ragged
    ones: the raw conv, dx through the kernel and dk, against autograd of
    F.conv3d; two kernel launches (forward and dx)."""
    gen = torch.Generator(device="cuda").manual_seed(c + d)
    x = _randn(gen, 2, c, d, hw, hw).requires_grad_(True)
    w = _randn(gen, c, c, 3, 3, 3, scale=0.05).requires_grad_(True)
    dy = _randn(gen, 2, c, d, hw, hw)
    before = cconv.launches["conv3d_train"]
    got = _grads(cconv.conv3d_train(x, w), (x, w), dy)
    assert cconv.launches["conv3d_train"] == before + 2
    want = _grads(cconv.conv3d_train_plain(x, w), (x, w), dy)
    for g, ww in zip(got, want):
        _close(g, ww)


@pytest.mark.parametrize("b,n,m,c0,chain,radius,s", [
    (8, 512, 128, 128, (128, 128), 0.2, 64),  # RCNN SA0
    (8, 128, 32, 128, (128, 256), 0.4, 64),   # RCNN SA1
    (3, 90, 21, 64, (80, 70, 40), 0.8, 32),
])
def test_sa_train_kernel_matches_autograd(card, b, n, m, c0, chain, radius, s):
    """Row 11's train form: the kernel forward and every input and weight
    gradient against autograd of the plain version; one launch."""
    gen = torch.Generator(device="cuda").manual_seed(b + n + m)
    xyz, centers, v, w0x, mul0, add0, ws = _sa_args(gen, b, n, m, c0, chain)
    leaves = [t.requires_grad_(True) for t in (v, w0x, mul0, add0)]
    flat = [t.requires_grad_(True) for pair in ws for t in pair]
    dy = _randn(gen, b, m, chain[-1])
    before = csa.train_launches
    got = _grads(csa.sa_ball_mlp_max_train(xyz, centers, *leaves, ws, radius, s),
                 leaves + flat, dy)
    assert csa.train_launches == before + 1
    want = _grads(csa.sa_ball_mlp_max_plain(xyz, centers, *leaves, ws, radius, s),
                  leaves + flat, dy)
    for g, ww in zip(got, want):
        _close(g, ww)


def test_forward_only_kernels_refuse_gradients(card):
    """An eval launch whose output autograd would need raises instead of
    silently cutting the gradient."""
    x = torch.zeros(1, 32, 4, 8, 8, device=card)
    w = torch.zeros(32, 32, 3, 3, 3, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        cconv.conv3d_bn(x, w)
    with torch.no_grad():
        cconv.conv3d_bn(x, w)


def _point_launches():
    return {"sa": csa.launches, "sa_train": csa.train_launches, "grouped_mlp": cgm.launches,
            "fp": cfp.launches, "fps": cfps.launches}


def test_bn_train_backbone_takes_no_sa_or_fp_kernel(card):
    """A train-mode PointNet++ backbone with BN (the 3D RPN's) forward and
    backward on the card: FPS launches at the two sampled levels, and none
    of the SA, grouped-MLP or FP kernels; its output, gradients and updated
    BN statistics match the same module's run on the CPU (features and
    statistics 1e-4 * max + 1e-5, each gradient within relative L2 1e-2,
    all of them within 5e-3: float32 sums in other orders, ROADMAP C19)."""
    gen = torch.Generator().manual_seed(0)
    m = tpn2.Pointnet2MSG(npoints=(256, 64, 16))
    with torch.no_grad():
        for n, b in m.named_buffers():
            if "running_var" in n:
                b.uniform_(0.5, 2.0, generator=gen)
    xyz = torch.randn(4, 256, 3, generator=gen) * torch.tensor([2.0, 1.0, 2.0])
    ct = torch.randn(4, 256, m.out_channels, generator=gen)
    runs = []
    for dev in (torch.device("cpu"), card):
        mm = copy.deepcopy(m).to(dev).train()
        before = _point_launches()
        _, feats = mm(xyz.to(dev))
        (feats * ct.to(dev)).sum().backward()
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _point_launches().items()}
        runs.append((feats.detach().cpu(), {n: p.grad.cpu() for n, p in mm.named_parameters()},
                     {n: b.cpu() for n, b in mm.named_buffers() if "running" in n}, launched))
    (want, want_g, want_s, _), (got, got_g, got_s, launched) = runs
    assert launched == {"sa": 0, "sa_train": 0, "grouped_mlp": 0, "fp": 0, "fps": 2}, launched
    assert (got - want).abs().max() <= 1e-4 * want.abs().max() + 1e-5
    for n, w in want_s.items():
        assert (got_s[n] - w).abs().max() <= 1e-4 * w.abs().max() + 1e-5, n
    num = den = 0.0
    for n, w in want_g.items():
        d, ww = float((got_g[n] - w).norm()), float(w.norm())
        assert d <= 1e-2 * ww, (n, d / ww)
        num, den = num + d * d, den + ww * ww
    assert num ** 0.5 <= 5e-3 * den ** 0.5


# DispModule's trunk (MODEL.DISPNET_ON: 28^2 ROIs, [-48, 48) at stride 4):
# (kind, input channels, output channels, input shape (D, H, W))
DISPMODULE_SITES = [
    ("cost_volume", 32, 32, (1, 28, 28)),  # the volume of D = 24, built in the kernel
    ("conv3d", 32, 32, (24, 28, 28)), ("conv3d", 64, 64, (12, 14, 14)),
    ("conv3d", 64, 64, (6, 7, 7)),
    ("conv3d_s2", 32, 64, (24, 28, 28)), ("conv3d_s2", 64, 64, (12, 14, 14)),
    ("deconv3d", 64, 64, (6, 7, 7)), ("deconv3d", 64, 32, (12, 14, 14)),
    ("conv3d_cl1", 32, 1, (24, 28, 28)),
    ("conv3d_train", 32, 32, (24, 28, 28)), ("conv3d_train", 64, 64, (6, 7, 7)),
]


@pytest.mark.parametrize("kind,ci,co,shape", DISPMODULE_SITES)
def test_dispmodule_sites_match_plain(card, kind, ci, co, shape):
    """Rows 2-6 and 8 at the shapes DispModule gives them (3 ROIs each,
    with residuals where the trunk adds them), against their plain
    versions, one launch each (row 8: its forward and dx)."""
    gen = torch.Generator(device="cuda").manual_seed(ci + co + shape[0] + shape[1])
    n = 3
    weight = _randn(gen, *((ci, co) if kind == "deconv3d" else (co, ci)), 3, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    name = "cost_volume_conv" if kind == "cost_volume" else kind
    before = cconv.launches[name]
    if kind == "cost_volume":
        left, right = (_randn(gen, n, ci, *shape[1:]) for _ in range(2))
        weight = _randn(gen, co, 2 * ci, 3, 3, 3, scale=0.05)
        got = cconv.cost_volume_conv_bn(left, right, weight, mul, add, -12, 12, relu=True)
        want = cconv.cost_volume_conv_bn_plain(left, right, weight, mul, add, -12, 12, True)
        assert got.shape == (n, co, 24, *shape[1:])
    elif kind == "conv3d_train":
        x = _randn(gen, n, ci, *shape).requires_grad_(True)
        dy = _randn(gen, n, co, *shape)
        w = weight.requires_grad_(True)
        got = _grads(cconv.conv3d_train(x, w), (x, w), dy)
        want = _grads(cconv.conv3d_train_plain(x, w), (x, w), dy)
        assert cconv.launches[name] == before + 2
        for g, ww in zip(got, want):
            _close(g, ww)
        return
    else:
        x = _randn(gen, n, ci, *shape)
        if kind == "deconv3d":
            res = _randn(gen, n, co, *(2 * s for s in shape))
            got = cconv.deconv3d_bn(x, weight, mul, add, res, relu=True)
            want = cconv.deconv3d_bn_plain(x, weight, mul, add, res, relu=True)
        elif kind == "conv3d_cl1":
            res = _randn(gen, n, 1, *shape)
            got = cconv.conv3d_bn(x, weight, residual=res)
            want = cconv.conv3d_bn_plain(x, weight, residual=res)
        else:
            stride = 2 if kind == "conv3d_s2" else 1
            out = tuple((s - 1) // stride + 1 for s in shape)
            res = _randn(gen, n, co, *out)
            got = cconv.conv3d_bn(x, weight, mul, add, res, relu=True, stride=stride)
            want = cconv.conv3d_bn_plain(x, weight, mul, add, res, relu=True, stride=stride)
    assert cconv.launches[name] == before + 1
    _close(got, want)


def test_dispmodule_softargmin_matches_plain(card):
    """Row 15 at DispModule's 28^2 -> 112^2 over [-48, 48): the main path's
    (24, 96) disparity taps (softargmin_fixed_kernel), within 1e-3 px."""
    gen = torch.Generator(device="cuda").manual_seed(112)
    logits = _randn(gen, 4, 24, 28, 28, scale=3.0)
    before = csam.launches
    got = csam.softargmin(logits, (112, 112), -48, 48)
    assert csam.launches == before + 1
    want = csam.softargmin_plain(logits, (112, 112), -48, 48)
    torch.cuda.synchronize()
    assert got.shape == (4, 112, 112)
    assert float((got - want).abs().max()) <= 1e-3


# The bf16 forms (the JAX package's bf16 model) against their bf16 twins:
# the twin is the float32 plain version of the same bf16 values, rounded
# to bf16 where the kernel stores, so the two differ only in the order of
# their float32 sums and that one rounding: at least 99.9% of the elements
# equal, and every element at most one bf16 step apart, beyond the float32
# sums' worst-case rounding where they cancel below a step of their terms
# (and at most one step where that floor is under a step)
# (cconv.bf16_agreement; the floor is K * F32_SUM_ERR times the same
# function of |x|, |weight| and |mul|, K its terms).
BF16 = torch.bfloat16


def _bf16_close(got, want, floor, min_equal=0.999):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == BF16 and got.shape == want.shape
    agree = cconv.bf16_agreement(got, want, floor)
    assert agree["beyond"] == 0 and agree["max_ulps_clear"] <= 1, agree
    assert agree["equal"] >= min_equal, agree


def _floor(k, plain, x, weight, mul, *args):
    """k * F32_SUM_ERR * the plain function of |x| (one tensor or a pair)
    and the bf16 weight's magnitudes, with |mul|, no add, residual or ReLU:
    the float32 sums' worst-case rounding over k terms."""
    xs = x if isinstance(x, tuple) else (x,)
    mags = plain(*(t.float().abs() for t in xs), weight.to(BF16).float().abs(),
                 None if mul is None else mul.abs(),
                 None if mul is None else torch.zeros_like(mul), *args)
    return k * cconv.F32_SUM_ERR * mags


def _randn_bf16(gen, *shape, scale=1.0):
    return _randn(gen, *shape, scale=scale).to(BF16)


@pytest.mark.parametrize("n,ci,co,shape,stride,residual,relu", [
    (2, 32, 32, (24, 56, 56), 1, False, True), (2, 32, 32, (24, 56, 56), 1, True, False),
    (2, 64, 64, (12, 28, 28), 1, True, True), (2, 64, 64, (6, 14, 14), 1, False, True),
    (2, 32, 64, (24, 56, 56), 2, False, True), (2, 64, 64, (12, 28, 28), 2, False, True),
    (2, 13, 32, (5, 9, 33), 1, True, True),  # Ci off the 16-channel step, ragged sizes
    (2, 64, 32, (7, 57, 55), 2, False, False),
])
def test_conv3d_bf16_kernel_matches_twin(card, n, ci, co, shape, stride, residual, relu):
    """Rows 3 and 6's bf16 form at the trunk's and hourglasses' sites."""
    gen = torch.Generator(device="cuda").manual_seed(ci * co + shape[-1] + stride)
    x = _randn_bf16(gen, n, ci, *shape)
    weight = _randn(gen, co, ci, 3, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    out_shape = (n, co, *((s - 1) // stride + 1 for s in shape))
    res = _randn_bf16(gen, *out_shape) if residual else None
    name = "conv3d_s2" if stride == 2 else "conv3d"
    before, before32 = cconv.launches_bf16[name], cconv.launches[name]
    got = cconv.conv3d_bn(x, weight, mul, add, res, relu, stride)
    assert cconv.launches_bf16[name] == before + 1 and cconv.launches[name] == before32
    _bf16_close(got, cconv.conv3d_bn_bf16_plain(x, weight, mul, add, res, relu, stride),
                _floor(27 * ci, cconv.conv3d_bn_plain, x, weight, mul, None, False, stride))


@pytest.mark.parametrize("shape,residual", [
    ((24, 56, 56), False), ((24, 56, 56), True),  # bulk copies (W % 8 == 0)
    ((6, 14, 28), True),  # 8-byte cp.async a quad (W % 4 == 0)
    ((5, 9, 33), True), ((3, 4, 300), False),  # plain loads; two column tiles
])
def test_conv3d_cl1_bf16_kernel_matches_twin(card, shape, residual):
    """Row 4's bf16 form (Co = 1): the conv rounded to bf16 before the
    previous classifier's cost joins, the sum rounded again."""
    gen = torch.Generator(device="cuda").manual_seed(shape[-1] + residual)
    x = _randn_bf16(gen, 2, 32, *shape)
    weight = _randn(gen, 1, 32, 3, 3, 3, scale=0.05)
    res = _randn_bf16(gen, 2, 1, *shape) if residual else None
    before = cconv.launches_bf16["conv3d_cl1"]
    got = cconv.conv3d_bn(x, weight, residual=res)
    assert cconv.launches_bf16["conv3d_cl1"] == before + 1
    # the conv rounds before the residual joins: one step of it more
    conv = cconv.conv3d_bn_plain(x.float(), weight.to(BF16).float())
    _bf16_close(got, cconv.conv3d_bn_bf16_plain(x, weight, residual=res),
                cconv.bf16_step(conv) + _floor(27 * 32, cconv.conv3d_bn_plain, x, weight, None))


@pytest.mark.parametrize("ci,co,shape,residual,relu", [
    (64, 64, (6, 14, 14), True, True), (64, 32, (12, 28, 28), True, False),
    (13, 32, (3, 5, 7), False, False),
])
def test_deconv3d_bf16_kernel_matches_twin(card, ci, co, shape, residual, relu):
    """Row 5's bf16 form at the hourglasses' sites."""
    gen = torch.Generator(device="cuda").manual_seed(ci + co + shape[-1])
    x = _randn_bf16(gen, 2, ci, *shape)
    weight = _randn(gen, ci, co, 3, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    out_shape = (2, co, *(2 * s for s in shape))
    res = _randn_bf16(gen, *out_shape) if residual else None
    before = cconv.launches_bf16["deconv3d"]
    got = cconv.deconv3d_bn(x, weight, mul, add, res, relu)
    assert cconv.launches_bf16["deconv3d"] == before + 1
    _bf16_close(got, cconv.deconv3d_bn_bf16_plain(x, weight, mul, add, res, relu),
                _floor(27 * ci, cconv.deconv3d_bn_plain, x, weight, mul))


@pytest.mark.parametrize("ci,co,hw,residual,relu", [
    (32, 32, (112, 112), False, True), (32, 32, (112, 112), True, False),
    (64, 64, (56, 56), True, False), (13, 32, (20, 33), True, True),
])
def test_conv2d_bf16_kernel_matches_twin(card, ci, co, hw, residual, relu):
    """Row 7's bf16 form at the tower's sites."""
    gen = torch.Generator(device="cuda").manual_seed(ci + co + hw[0])
    x = _randn_bf16(gen, 4, ci, *hw)
    weight = _randn(gen, co, ci, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    res = _randn_bf16(gen, 4, co, *hw) if residual else None
    before = cconv.launches_bf16["conv2d"]
    got = cconv.conv2d_bn(x, weight, mul, add, res, relu)
    assert cconv.launches_bf16["conv2d"] == before + 1
    _bf16_close(got, cconv.conv2d_bn_bf16_plain(x, weight, mul, add, res, relu),
                _floor(9 * ci, cconv.conv2d_bn_plain, x, weight, mul))


def _wgmma_form_matches_twin(kind, n, ci, co, shape, residual, relu, seed):
    """One launch of a bf16 form of csrc/conv_bf16_wgmma.cu (rows 3, 5, 6 and
    7: kind "conv3d", "deconv3d", "conv3d_s2", "conv2d") held to its twin
    with bf16_agreement: no element beyond one bf16 step and the float32
    sums' floor; the launch counted once, as bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _randn_bf16(gen, n, ci, *shape)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    if kind == "conv2d":
        weight = _randn(gen, co, ci, 3, 3, scale=0.05)
        out_shape = (n, co, *shape)
        launch, twin, plain, k = cconv.conv2d_bn, cconv.conv2d_bn_bf16_plain, \
            cconv.conv2d_bn_plain, 9 * ci
        args = ()
    elif kind == "deconv3d":
        weight = _randn(gen, ci, co, 3, 3, 3, scale=0.05)
        out_shape = (n, co, *(2 * s for s in shape))
        launch, twin, plain, k = cconv.deconv3d_bn, cconv.deconv3d_bn_bf16_plain, \
            cconv.deconv3d_bn_plain, 27 * ci
        args = ()
    else:
        stride = 2 if kind == "conv3d_s2" else 1
        weight = _randn(gen, co, ci, 3, 3, 3, scale=0.05)
        out_shape = (n, co, *((s - 1) // stride + 1 for s in shape))
        launch, twin, plain, k = cconv.conv3d_bn, cconv.conv3d_bn_bf16_plain, \
            cconv.conv3d_bn_plain, 27 * ci
        args = (stride,)
    res = _randn_bf16(gen, *out_shape) if residual else None
    before, before32 = cconv.launches_bf16[kind], cconv.launches[kind]
    got = launch(x, weight, mul, add, res, relu, *args)
    assert cconv.launches_bf16[kind] == before + 1 and cconv.launches[kind] == before32
    assert got.shape == out_shape
    _bf16_close(got, twin(x, weight, mul, add, res, relu, *args),
                _floor(k, plain, x, weight, mul, *((None, False) + args if args else ())))


@pytest.mark.parametrize("kind,n,ci,co,shape,residual,relu", [
    ("conv2d", 256, 32, 32, (112, 112), False, True),  # firstconv, layer1
    ("conv2d", 256, 32, 32, (112, 112), True, False),
    ("conv2d", 256, 64, 64, (56, 56), False, True),  # layer2
    ("conv2d", 256, 64, 64, (56, 56), True, False),
    ("conv2d", 256, 64, 64, (56, 56), True, True),
    ("deconv3d", 128, 64, 64, (6, 14, 14), True, True),  # the hourglasses
    ("deconv3d", 128, 64, 32, (12, 28, 28), True, False),
    ("conv3d", 128, 32, 32, (24, 56, 56), False, True),  # dres0_1, dres1_0, classif*_0
    ("conv3d", 128, 32, 32, (24, 56, 56), True, False),  # dres1_1
    ("conv3d", 128, 64, 64, (12, 28, 28), False, True),  # ConvBN_1 of the first hourglass
    ("conv3d", 128, 64, 64, (12, 28, 28), True, True),  # ConvBN_1 of the later two
    ("conv3d", 128, 64, 64, (6, 14, 14), False, True),  # ConvBN_3: 196-position slices
    ("conv3d_s2", 128, 32, 64, (24, 56, 56), False, True),  # ConvBN_0
    ("conv3d_s2", 128, 64, 64, (12, 28, 28), False, True),  # ConvBN_2
])
def test_wgmma_bf16_forms_at_main_path_sites(card, kind, n, ci, co, shape, residual, relu):
    """The bf16 forms of rows 3, 5, 6 and 7 at the bf16 idispnet.yaml
    request's own sites: 128 ROI slots, both views in the tower."""
    _wgmma_form_matches_twin(kind, n, ci, co, shape, residual, relu, seed=n + ci + co)


@pytest.mark.parametrize("kind,n,ci,co,shape,residual,relu", [
    ("conv2d", 1, 32, 32, (112, 112), True, True),  # N = 1
    ("conv2d", 2, 32, 32, (20, 33), True, False),  # W 33: plain staging, direct stores
    ("conv2d", 2, 64, 64, (20, 20), False, True),  # W 20: no multiple of 8, TMA legal
    ("conv2d", 2, 32, 32, (20, 112), True, False),  # a ragged last tile (tiles of 7 rows)
    ("conv2d", 1, 64, 64, (61, 56), True, True),  # ragged at Co 64 (tiles of 8 rows)
    ("conv2d", 2, 16, 32, (9, 8), False, False),  # one tile, Ci 16
    ("deconv3d", 1, 64, 64, (1, 14, 14), True, True),  # D = 1
    ("deconv3d", 2, 64, 32, (3, 28, 28), False, True),  # D = 3, no residual
    ("deconv3d", 2, 64, 32, (3, 30, 30), True, False),  # a ragged last tile
    ("deconv3d", 1, 32, 64, (3, 10, 20), True, False),  # W 20
    ("deconv3d", 2, 13, 32, (3, 5, 7), True, True),  # Ci off the 16-channel step
    ("conv3d", 1, 32, 32, (24, 56, 56), True, True),  # N = 1
    ("conv3d", 2, 32, 32, (1, 56, 56), True, False),  # D = 1: one depth tap
    ("conv3d", 2, 64, 64, (3, 28, 28), False, True),  # D = 3, no residual
    ("conv3d", 2, 32, 32, (3, 20, 33), True, True),  # W 33: plain staging, direct stores
    ("conv3d", 2, 64, 64, (4, 10, 20), True, False),  # W 20
    ("conv3d", 256, 64, 64, (6, 7, 7), True, True),  # DispModule's (6, 7^2): plain staging
    ("conv3d", 256, 64, 64, (12, 14, 14), False, True),  # DispModule's (12, 14^2)
    ("conv3d", 2, 13, 32, (3, 9, 16), True, True),  # Ci 13
    ("conv3d", 2, 16, 64, (3, 9, 16), True, False),  # Ci 16
    ("conv3d", 1, 32, 32, (2, 61, 56), True, True),  # ragged at Co 32: rows 13, 13, ..., 9
    ("conv3d", 1, 64, 64, (2, 61, 32), True, True),  # ragged at Co 64: tiles of 13 rows
    # slice pairs (Co 64, whole slices, fewer rounds than single slices):
    ("conv3d", 64, 64, 64, (3, 14, 14), True, True),  # odd D: a second slice past the volume
    ("conv3d", 100, 13, 64, (2, 9, 11), True, False),  # Ci 13, plain staging, D 2
    ("conv3d", 200, 16, 64, (5, 4, 6), False, True),  # TMA staging from before the volume
    ("conv3d_s2", 1, 32, 64, (24, 56, 56), True, True),  # N = 1, with a residual
    ("conv3d_s2", 2, 64, 64, (1, 28, 28), False, True),  # D = 1
    ("conv3d_s2", 2, 64, 32, (3, 28, 28), False, False),  # D = 3: the last slice's two taps
    ("conv3d_s2", 2, 32, 64, (3, 20, 33), True, True),  # W 33: odd, plain staging
    ("conv3d_s2", 2, 64, 64, (4, 10, 20), True, False),  # W 20: output 10 wide
    ("conv3d_s2", 256, 64, 64, (12, 14, 14), False, True),  # DispModule's 14^2 -> 7^2
    ("conv3d_s2", 256, 32, 64, (24, 28, 28), False, True),  # DispModule's 28^2 -> 14^2
    ("conv3d_s2", 2, 13, 32, (5, 9, 11), True, True),  # Ci 13, odd sizes
    ("conv3d_s2", 2, 16, 64, (4, 16, 16), False, False),  # Ci 16
    ("conv3d_s2", 1, 32, 32, (2, 122, 112), True, True),  # ragged at Co 32: 61 output rows
    ("conv3d_s2", 1, 64, 64, (2, 121, 64), True, True),  # ragged at Co 64: 61 output rows
])
def test_wgmma_bf16_forms_edge_cases(card, kind, n, ci, co, shape, residual, relu):
    """The bf16 forms of rows 3, 5, 6 and 7 off the main path's shapes."""
    _wgmma_form_matches_twin(kind, n, ci, co, shape, residual, relu, seed=7 * n + ci + shape[-1])


@pytest.mark.parametrize("c,d,s", [(32, 24, 56), (64, 12, 28), (64, 6, 14)])
def test_wgmma_bf16_train_form_at_trunk_sites(card, c, d, s):
    """Row 8's bf16 train form at the iDispNet step's trunk sites (24 ROI
    crops): the forward (conv3d_train_cuda) and the input gradient
    (conv3d_train_dx_cuda, the flipped weights) each one launch of
    csrc/conv_bf16_wgmma.cu's stride-1 form, held to their twins."""
    gen = torch.Generator(device="cuda").manual_seed(c + d + s)
    x = _randn_bf16(gen, 24, c, d, s, s)
    dy = _randn_bf16(gen, 24, c, d, s, s)
    w = _randn(gen, c, c, 3, 3, 3, scale=0.05)
    before = cconv.launches_bf16["conv3d_train"]
    y, dx = cconv.conv3d_train_cuda(x, w), cconv.conv3d_train_dx_cuda(dy, w)
    assert cconv.launches_bf16["conv3d_train"] == before + 2
    wa = w.to(BF16).float().abs()
    _bf16_close(y, cconv.conv3d_train_bf16_plain(x, w),
                27 * c * cconv.F32_SUM_ERR * F.conv3d(x.float().abs(), wa, padding=1))
    _bf16_close(dx, cconv.conv3d_train_dx_bf16_plain(dy, w),
                27 * c * cconv.F32_SUM_ERR * F.conv3d(dy.float().abs(),
                                                      cconv.flip_transpose(wa), padding=1))


def test_wgmma_bf16_forms_refuse_what_they_do_not_take(card):
    """The bf16 launch points of csrc/conv_bf16_wgmma.cu take every Ci (the
    channels past Ci are zero in the weights and in the staged input), and
    raise on a Co other than 32 or 64 and on a row wider than they take (a
    tile's M-tiles hold one halo row, and its staging and halos fit in
    shared memory), naming it; nothing falls back to another body or to the
    twin."""
    x = torch.zeros(1, 13, 8, 8, device=card, dtype=BF16)
    mul, add = torch.ones(16, device=card), torch.zeros(16, device=card)
    with pytest.raises(ValueError, match="Co in"):
        cconv.conv2d_bn_bf16_cuda(x, torch.zeros(16, 13, 3, 3, device=card), mul, add)
    with pytest.raises(ValueError, match="Co in"):
        cconv.deconv3d_bn_bf16_cuda(x[:, :, None], torch.zeros(13, 16, 3, 3, 3, device=card),
                                    mul, add)
    for stride in (1, 2):
        with pytest.raises(ValueError, match="Co in"):
            cconv.conv3d_bn_bf16_cuda(x[:, :, None], torch.zeros(16, 13, 3, 3, 3, device=card),
                                      mul, add, stride=stride)
    with pytest.raises(ValueError, match="Co in"):
        cconv.conv3d_train_dx_cuda(x[:, :, None], torch.zeros(13, 16, 3, 3, 3, device=card))
    mul, add = torch.ones(64, device=card), torch.zeros(64, device=card)
    wide = torch.zeros(1, 64, 2, 600, device=card, dtype=BF16)
    with pytest.raises(ValueError, match="W = 600"):
        cconv.conv2d_bn_bf16_cuda(wide, torch.zeros(64, 64, 3, 3, device=card), mul, add)
    with pytest.raises(ValueError, match="W = 600"):
        cconv.deconv3d_bn_bf16_cuda(wide[:, :, None], torch.zeros(64, 64, 3, 3, 3, device=card),
                                    mul, add)
    w3 = torch.zeros(64, 64, 3, 3, 3, device=card)
    with pytest.raises(ValueError, match="W = 600"):
        cconv.conv3d_bn_bf16_cuda(wide[:, :, None], w3, mul, add)
    with pytest.raises(ValueError, match="W = 600"):
        cconv.conv3d_train_cuda(wide[:, :, None], w3)
    # stride 2: 1200 wide is a 600-wide output row
    wider = torch.zeros(1, 64, 1, 2, 1200, device=card, dtype=BF16)
    with pytest.raises(ValueError, match="W = 1200"):
        cconv.conv3d_bn_bf16_cuda(wider, w3, mul, add, stride=2)
    # within the M-tiles' 895 positions at Co 32, but the tile's staging and
    # halos do not fit in shared memory
    with pytest.raises(ValueError, match="W = 600"):
        cconv.conv2d_bn_bf16_cuda(wide[:, :32], torch.zeros(32, 32, 3, 3, device=card),
                                  mul[:32], add[:32])


# the forms (conv_bf16_wgmma_max_width's) and the rows an M-tile set holds
_WGMMA_FORMS = {"conv2d": cconv.FORM_STRIDE1, "conv3d": cconv.FORM_STRIDE1,
                "deconv3d": cconv.FORM_TRANSPOSED, "conv3d_s2": cconv.FORM_STRIDE2}


@pytest.mark.parametrize("kind,co", [("conv2d", 32), ("conv2d", 64), ("deconv3d", 32),
                                     ("deconv3d", 64), ("conv3d", 32), ("conv3d", 64),
                                     ("conv3d_s2", 32), ("conv3d_s2", 64)])
def test_wgmma_bf16_forms_take_their_widest_row(card, kind, co):
    """The widest input row the launch point lets through
    (conv_bf16_wgmma_max_width) runs at the height whose tiles take the
    most shared memory (8 times the rows a tile holds) and agrees with the
    twin."""
    form = _WGMMA_FORMS[kind]
    w = cconv._widest(form, co)
    mrows = 2 * 64 * {(0, 32): 7, (0, 64): 4, (1, 32): 2, (1, 64): 1, (2, 32): 2,
                      (2, 64): 2}[form, co]  # M-tile rows (mtiles)
    hs = (w - 1) // 2 + 2 if form == cconv.FORM_STRIDE2 else w + 1  # the halo row
    assert 56 <= w and hs <= mrows
    rows = 8 * (mrows // hs)  # output rows (input rows of the transposed conv)
    if kind == "conv2d":
        shape = (rows, w)
    else:
        shape = (1, 2 * rows if form == cconv.FORM_STRIDE2 else rows, w)
    _wgmma_form_matches_twin(kind, 1, 16, co, shape, True, True, seed=w + co)


@pytest.mark.parametrize("c,hw,co,mind4,maxd4", [
    (32, (56, 56), 32, -12, 12), (13, (9, 40), 32, -3, 5), (32, (13, 40), 64, 3, 11)])
def test_cost_volume_bf16_kernel_matches_twin(card, c, hw, co, mind4, maxd4):
    """Row 2's bf16 form: the main path's (24, 56^2) volume, C off the
    16-channel step, a range above zero at Co 64."""
    gen = torch.Generator(device="cuda").manual_seed(c + co + mind4)
    left, right = _randn_bf16(gen, 2, c, *hw), _randn_bf16(gen, 2, c, *hw)
    weight = _randn(gen, co, 2 * c, 3, 3, 3, scale=0.05)
    mul, add = 1 + _randn(gen, co, scale=0.3), _randn(gen, co, scale=0.1)
    before = cconv.launches_bf16["cost_volume_conv"]
    got = cconv.cost_volume_conv_bn(left, right, weight, mul, add, mind4, maxd4)
    assert cconv.launches_bf16["cost_volume_conv"] == before + 1
    _bf16_close(got, cconv.cost_volume_conv_bn_bf16_plain(left, right, weight, mul, add,
                                                          mind4, maxd4),
                _floor(54 * c + 18, cconv.cost_volume_conv_bn_plain, (left, right), weight, mul,
                       mind4, maxd4, False))


@pytest.mark.parametrize("co,ci", [(32, 32), (64, 64), (32, 13), (64, 5)])
def test_bf16_pack_kernels_match_plain(card, co, ci):
    """The bf16 packings (3D, flipped 3D, 2D, transposed, cost volume) equal
    their plain versions bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(co + ci)
    w3, w2 = _randn(gen, co, ci, 3, 3, 3), _randn(gen, co, ci, 3, 3)
    wd = _randn(gen, ci, co, 3, 3, 3)
    wc = _randn(gen, co, 2 * ci, 3, 3, 3)
    wf = _randn(gen, ci, co, 3, 3, 3)  # a forward weight whose input gradient has Co out
    for got, want in ((cconv.pack_wgmma_weight_cuda(w3, "conv"),
                       cconv.pack_wgmma_weight(w3, "conv")),
                      (cconv.pack_wgmma_weight_cuda(wf, "flip"),
                       cconv.pack_wgmma_weight(wf, "flip")),
                      (cconv.pack_wgmma_weight_cuda(w2, "conv"),
                       cconv.pack_wgmma_weight(w2, "conv")),
                      (cconv.pack_wgmma_weight_cuda(wd, "deconv"),
                       cconv.pack_wgmma_weight(wd, "deconv")),
                      (cconv.pack_bf16_cost_volume_weight_cuda(wc),
                       cconv.pack_bf16_cost_volume_weight(wc))):
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got.view(torch.int16)
                                                       if got.dtype == BF16 else got,
                                                       want.view(torch.int16)
                                                       if want.dtype == BF16 else want)


@pytest.mark.parametrize("b,d4,hw4,out_hw,disp", [
    (16, 24, (56, 56), (224, 224), (-48, 48)), (3, 7, (9, 4), (27, 33), (-8, 8))])
def test_softargmin_bf16_kernel_matches_float32_form(card, b, d4, hw4, out_hw, disp):
    """Row 15's bf16 form reads its logits as float32: equal to the float32
    kernel on the logits cast up, bit for bit, and within 1e-3 px of its
    twin (the float32 plain version, summing in another order)."""
    gen = torch.Generator(device="cuda").manual_seed(b + d4)
    logits = _randn_bf16(gen, b, d4, *hw4, scale=3.0)
    before = csam.launches_bf16
    got = csam.softargmin(logits, out_hw, *disp)
    assert csam.launches_bf16 == before + 1 and got.dtype == torch.float32
    want = csam.softargmin_cuda(logits.float(), out_hw, *disp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float((got - csam.softargmin_bf16_plain(logits, out_hw, *disp)).abs().max()) <= 1e-3


def test_kernels_refuse_the_other_dtype(card):
    """A bf16 tensor given to a float32 launch point raises, and a float32
    one to a bf16 launch point: nothing is cast to reach a kernel."""
    x = torch.zeros(1, 32, 4, 8, 8, device=card)
    w = torch.zeros(32, 32, 3, 3, 3, device=card)
    mul, add = torch.ones(32, device=card), torch.zeros(32, device=card)
    with pytest.raises(ValueError, match="float32 CUDA"):
        cconv.conv3d_bn_cuda(x.to(BF16), w)
    with pytest.raises(ValueError, match="bfloat16 CUDA"):
        cconv.conv3d_bn_bf16_cuda(x, w)
    with pytest.raises(ValueError, match="bfloat16 CUDA"):
        cconv.conv3d_bn_bf16_cuda(x.to(BF16), w, mul, add, residual=x)
    with pytest.raises(ValueError, match="float32 CUDA"):
        cconv.conv2d_bn_cuda(x[:, :, 0].to(BF16), w[:, :, 0], mul, add)
    with pytest.raises(ValueError, match="bfloat16 CUDA"):
        cconv.conv2d_bn_bf16_cuda(x[:, :, 0], w[:, :, 0], mul, add)
    with pytest.raises(ValueError, match="float32 CUDA"):
        cconv.deconv3d_bn_cuda(x.to(BF16), w, mul, add)
    with pytest.raises(ValueError, match="bfloat16 CUDA"):
        cconv.deconv3d_bn_bf16_cuda(x, w, mul, add)
    f = torch.zeros(1, 32, 8, 8, device=card)
    wc = torch.zeros(32, 64, 3, 3, 3, device=card)
    with pytest.raises(ValueError, match="float32 CUDA"):
        cconv.cost_volume_conv_bn_cuda(f.to(BF16), f.to(BF16), wc, mul, add, 0, 4)
    with pytest.raises(ValueError, match="bfloat16 CUDA"):
        cconv.cost_volume_conv_bn_bf16_cuda(f, f, wc, mul, add, 0, 4)
    # the train form's launch point takes x's dtype (row 8's bf16 form):
    # a bf16 x reaches the bf16 kernel uncast
    before = cconv.launches_bf16["conv3d_train"]
    assert cconv.conv3d_train_cuda(x.to(BF16), w).dtype == BF16
    assert cconv.launches_bf16["conv3d_train"] == before + 1
    with pytest.raises(ValueError, match="float32"):
        csam.softargmin_cuda(f.to(BF16), (16, 16), 0, 8)
    with pytest.raises(ValueError, match="bfloat16"):
        csam.softargmin_bf16_cuda(f, (16, 16), 0, 8)


# The PointNet++ bf16 forms (rows 10 and 13; row 14's bf16 read) against
# their twins, at the main path's sites and at edges. The chains' floor is
# sa.bf16_chain_floor: the last layer's float32 sums' worst-case rounding,
# and the hidden layers' outputs rounded to either side, propagated. A
# hidden output that rounds to the other side (where its sums lie within
# their float32 error of a bf16 midpoint) moves every later layer's sums a
# little, so the share of equal elements falls with depth: 99.9% for the
# main path's chains (two layers after mlp0, or two in FP), 99.5% for the
# three- and four-layer edges and a 2048-wide hidden layer.
@pytest.mark.parametrize("b,n,m,c0,chain,radius,s", [
    (4, 768, 512, 64, (64, 128), 0.5, 16),    # RPN SA1, both scales
    (4, 768, 512, 64, (96, 128), 1.0, 32),
    (3, 512, 256, 128, (196, 256), 1.0, 16),  # RPN SA2 (196 wide: 208 in bf16)
    (2, 256, 64, 256, (384, 512), 4.0, 32),   # RPN SA3, the widest chain
    (8, 512, 128, 128, (128, 128), 0.2, 64),  # RCNN SA0
    (8, 128, 32, 128, (128, 256), 0.4, 64),   # RCNN SA1
    (3, 100, 37, 64, (), 0.8, 16),            # no layer after mlp0, a partial tile
    (3, 90, 21, 66, (80, 70, 40), 0.8, 32),   # three layers, C0 not a multiple of 4
    (2, 150, 33, 64, (64,), 0.7, 4),          # S under 16
    (2, 128, 40, 96, (128, 128, 128, 256), 1.2, 32),  # four layers
])
def test_sa_bf16_kernel_matches_twin(card, b, n, m, c0, chain, radius, s):
    """Row 10's bf16 form: x0 is the twin's bit for bit (every rounding
    explicit), the chain's float32 sums in another order."""
    gen = torch.Generator(device="cuda").manual_seed(n + m + s + 1)
    xyz, centers, v, w0x, mul0, add0, ws = _sa_args(gen, b, n, m, c0, chain)
    v = v.to(BF16)
    before, before32 = csa.launches_bf16, csa.launches
    got = csa.sa_ball_mlp_max(xyz, centers, v, w0x, mul0, add0, ws, radius, s)
    assert csa.launches_bf16 == before + 1 and csa.launches == before32
    assert got.shape == (b, m, chain[-1] if chain else c0)
    args = (xyz, centers, v, w0x, mul0, add0, ws, radius, s)
    want = csa.sa_ball_mlp_max_bf16_plain(*args)
    floor = (csa.sa_ball_mlp_max_bf16_plain(*args, chain=csa.bf16_chain_floor) if chain
             else torch.zeros(got.shape, device=card))
    _bf16_close(got, want, floor, 0.999 if len(chain) <= 2 else 0.995)
    if not chain:
        assert torch.equal(got, want)


@pytest.mark.parametrize("b,nt,ns,c,cs,chain,min_equal", [
    (4, 256, 64, 1024, 512, (512, 512), 0.999),  # fp3
    (4, 512, 256, 512, 256, (512, 512), 0.999),  # fp2
    (4, 768, 512, 512, 96, (256, 256), 0.999),   # fp1
    (3, 50, 9, 20, 12, (30, 20, 10), 0.995),     # three layers, a partial tile
    (1, 40, 9, 100, 60, (30, 20), 0.999),        # a chunk boundary inside the skip columns
    (2, 33, 11, 37, 11, (45, 17, 33, 9), 0.995),  # four layers, every width odd (scalar loads)
    # a 2048-wide hidden layer (16-row tiles): each output sums 2048 hidden
    # values, so more of them meet a hidden value rounded the other way
    (1, 70, 16, 512, 512, (2048, 256), 0.995),
])
def test_fp_bf16_kernel_matches_twin(card, b, nt, ns, c, cs, chain, min_equal):
    """Row 13's bf16 form: the interpolated columns are the twin's bit for
    bit (each operation rounded on its own), the chain's sums in another
    order."""
    gen = torch.Generator(device="cuda").manual_seed(nt + ns + 1)
    unknown, known = _clouds(gen, b, nt), _clouds(gen, b, ns)
    unknown[:, 0] = known[:, 4]  # a zero distance
    kf, uf = _randn_bf16(gen, b, ns, c), _randn_bf16(gen, b, nt, cs)
    ws, cin = [], c + cs
    for co in chain:
        ws.append((_randn(gen, cin, co, scale=cin ** -0.5), _randn(gen, co, scale=0.1)))
        cin = co
    before, before32 = cfp.launches_bf16, cfp.launches
    got = cfp.fp_fused(unknown, known, kf, uf, ws)
    assert cfp.launches_bf16 == before + 1 and cfp.launches == before32
    _bf16_close(got, cfp.fp_fused_bf16_plain(unknown, known, kf, uf, ws),
                cfp.fp_fused_bf16_plain(unknown, known, kf, uf, ws, chain=csa.bf16_chain_floor),
                min_equal)


@pytest.mark.parametrize("route", [None, "bulk", "direct"])
@pytest.mark.parametrize("b,n,m,e,c,s", [(128, 768, 16, 2, 128, 512), (3, 700, 5, 2, 128, 513),
                                         (2, 500, 6, 3, 5, 7)])
def test_roipool3d_bf16_read_matches_widened_float32(card, route, b, n, m, e, c, s):
    """Row 14 reading bf16 features: bit-equal to the float32 kernel and to
    the plain version on the features widened to float32."""
    pts, extra, boxes = _roipool_inputs(b, n, m, e)
    feats = _randn_bf16(torch.Generator(device="cuda").manual_seed(n), b, n, c)
    before, before32 = croi.launches_bf16, croi.launches
    if route is None:
        got, gempty = croi.roipool3d_bf16(pts, extra, feats, boxes, s)
        assert croi.launches_bf16 == before + 1 and croi.launches == before32
    else:
        got, gempty = croi._launch(pts, extra, boxes, s, route=route, bf16_feats=feats)
    wide = torch.cat([extra, feats.float()], -1).contiguous()
    want, wempty = croi.roipool3d_plain(pts, wide, boxes, s)
    f32, _ = croi._launch(pts, wide, boxes, s, route=route)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, m, s, 3 + e + c)
    assert torch.equal(gempty, wempty) and gempty.any() and not gempty.all()
    assert torch.equal(got, want) and torch.equal(got, f32)
    again, _ = croi.roipool3d_bf16_plain(pts, extra, feats, boxes, s)
    assert torch.equal(again, want)


@pytest.mark.parametrize("chans", [(64, 64, 128), (128, 196, 256), (37, 45, 17, 33, 9)])
def test_bf16_chain_pack_matches_plain(card, chans):
    gen = torch.Generator(device="cuda").manual_seed(sum(chans))
    ws = [(_randn(gen, ci, co), _randn(gen, co)) for ci, co in zip(chans, chans[1:])]
    got = csa.pack_bf16_chain_cuda(ws)
    torch.cuda.synchronize()
    assert torch.equal(got, csa.pack_bf16_chain(ws))


def test_pointnet_kernels_refuse_the_other_dtype(card):
    """Rows 10, 12, 13 and 14: each form raises on the other's dtype rather
    than casting to reach a kernel (row 12's bf16 form since ROADMAP
    A8.3b)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    xyz, centers, v, w0x, mul0, add0, ws = _sa_args(gen, 2, 64, 16, 64, (64,))
    with pytest.raises(ValueError, match="float32"):
        csa.sa_ball_mlp_max_cuda(xyz, centers, v.to(BF16), w0x, mul0, add0, ws, 0.5, 16)
    with pytest.raises(ValueError, match="bfloat16"):
        csa.sa_ball_mlp_max_bf16_cuda(xyz, centers, v, w0x, mul0, add0, ws, 0.5, 16)
    kf, uf = _randn(gen, 2, 16, 8), _randn(gen, 2, 64, 8)
    fws = [(_randn(gen, 16, 8), _randn(gen, 8))]
    with pytest.raises(ValueError, match="float32"):
        cfp.fp_fused_cuda(xyz, centers, kf.to(BF16), uf.to(BF16), fws)
    with pytest.raises(ValueError, match="bfloat16"):
        cfp.fp_fused_bf16_cuda(xyz, centers, kf, uf, fws)
    pts, extra, boxes = _roipool_inputs(2, 64, 4, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        croi.roipool3d_bf16_cuda(pts, extra, extra, boxes, 8)
    with pytest.raises(ValueError, match="float32"):
        croi.roipool3d_cuda(pts, extra.to(BF16), boxes, 8)
    x = _randn_bf16(gen, 8, 16, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        cgm.grouped_mlp_max_bf16_cuda(x.float(), mul0, add0, ws)
    with pytest.raises(ValueError, match="float32"):
        cgm.grouped_mlp_max_cuda(x, mul0, add0, ws)


@pytest.mark.parametrize("g,s,c0,chain", [(4096, 16, 64, (64, 128)), (1001, 32, 256, (384, 512)),
                                         (517, 24, 65, (70, 33, 18))])
def test_grouped_mlp_bf16_matches_twin(card, g, s, c0, chain):
    """Row 12's bf16 form (the SA-off route of a bf16 model) against its
    twin: its packing bit-equal to pack_wgmma_chain_bf16, the output within
    a bf16 step beyond the chains' floor (bf16_agreement), and
    grouped_mlp_max dispatching a bf16 x to it."""
    gen = torch.Generator(device="cuda").manual_seed(g)
    x = _randn_bf16(gen, g, s, c0)
    mul0, add0 = 1 + 0.3 * _randn(gen, c0), 0.1 * _randn(gen, c0)
    ws, cin = [], c0
    for co in chain:
        ws.append((_randn(gen, cin, co) * cin ** -0.5, 0.1 * _randn(gen, co)))
        cin = co
    nc = cgm.launch_plan([c0, *chain], s, bf16=True)[1]
    assert torch.equal(cgm.pack_wgmma_chain_cuda(ws, nc, bf16=True),
                       cgm.pack_wgmma_chain_bf16(ws, nc))
    before = cgm.launches_bf16
    got = cgm.grouped_mlp_max(x, mul0, add0, ws)
    assert cgm.launches_bf16 == before + 1 and got.dtype == BF16
    want = cgm.grouped_mlp_max_bf16_plain(x, mul0, add0, ws)
    x0 = torch.relu(x.float() * mul0 + add0).to(BF16)
    ag = cconv.bf16_agreement(got, want, csa.bf16_chain_floor(x0, ws).amax(dim=1))
    assert ag["beyond"] == 0 and ag["max_ulps_clear"] <= 1, ag
