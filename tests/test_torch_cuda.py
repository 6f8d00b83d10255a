"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked `cuda` and skips without a card. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import copy

import numpy as np
import pytest
import torch

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
