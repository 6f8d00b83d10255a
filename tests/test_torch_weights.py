"""utils/weights.py: JAX variables -> the port's state_dict, with every key
checked."""
import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from disprcnn_tpu.models.detector.disprcnn import DispRCNN as JDispRCNN
from disprcnn_tpu.models.psmnet.psmnet import PSMNet as JPSMNet
from disprcnn_tpu_torch.models.detector.disprcnn import DispRCNN
from disprcnn_tpu_torch.models.psmnet.psmnet import PSMNet, _deconv
from disprcnn_tpu_torch.utils.weights import (
    flatten_variables, init_random_, load_jax_variables, state_dict_from_jax)
from torch_port_helpers import TINY, draw_variables, jax_variables


@pytest.fixture(scope="module")
def variables():
    return jax_variables(JDispRCNN(**TINY), seed=1)


@pytest.fixture
def model():
    return DispRCNN(**TINY, device="cpu")


def test_round_trip_sets_every_entry(variables, model):
    sd = state_dict_from_jax(model, variables)
    assert set(sd) == set(model.state_dict())
    load_jax_variables(model, variables)
    p, f = variables["params"], variables["frozen"]
    got = model.state_dict()
    np.testing.assert_array_equal(  # conv: HWIO -> OIHW
        got["backbone.body.stem.conv1.weight"].numpy(),
        p["backbone"]["body"]["stem"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(  # dense: (in, out) -> (out, in)
        got["box_predictor.bbox_pred.weight"].numpy(),
        p["box_predictor"]["bbox_pred"]["kernel"].T)
    np.testing.assert_array_equal(  # transposed conv: flipped, (in, out, kh, kw)
        got["mask_head.deconv.weight"].numpy(),
        p["mask_head"]["deconv"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1))
    block = f["backbone"]["body"]["layer1_0"]  # has a downsample: its norm is _0
    np.testing.assert_array_equal(got["backbone.body.layer1_0.downsample_bn.weight"].numpy(),
                                  block["FrozenBatchNorm_0"]["scale"])
    np.testing.assert_array_equal(got["backbone.body.layer1_0.bn3.running_var"].numpy(),
                                  block["FrozenBatchNorm_3"]["var"])
    np.testing.assert_array_equal(  # no downsample: bn1 is _0
        got["backbone.body.layer1_1.bn1.running_mean"].numpy(),
        f["backbone"]["body"]["layer1_1"]["FrozenBatchNorm_0"]["mean"])


def test_flat_and_nested_inputs_agree(variables, model):
    flat = {c: flatten_variables(variables[c]) for c in variables}
    a, b = state_dict_from_jax(model, variables), state_dict_from_jax(model, flat)
    assert all(torch.equal(a[k], b[k]) for k in a)


def _flat_copy(variables):
    return {c: flatten_variables(variables[c]) for c in variables}


def test_missing_key_raises(variables, model):
    flat = _flat_copy(variables)
    del flat["params"]["rpn_head/conv/bias"]
    with pytest.raises(KeyError, match="left unset"):
        state_dict_from_jax(model, flat)


def test_missing_frozen_constant_raises(variables, model):
    flat = _flat_copy(variables)
    del flat["frozen"]["backbone/body/layer2_0/FrozenBatchNorm_2/var"]
    with pytest.raises(KeyError, match="left unset"):
        state_dict_from_jax(model, flat)


@pytest.mark.parametrize("coll,path", [
    ("params", "backbone/fpn/output5/kernel"),  # never created in this fork
    ("params", "rpn_head/conv/scale"),
    ("frozen", "backbone/body/layer1_1/FrozenBatchNorm_3/scale"),  # no downsample: 3 norms
    ("frozen", "backbone/fpn/FrozenBatchNorm_0/scale"),
])
def test_extra_key_raises(variables, model, coll, path):
    flat = _flat_copy(variables)
    flat[coll][path] = np.zeros((3, 3, 32, 32), np.float32)
    with pytest.raises(KeyError):
        state_dict_from_jax(model, flat)


def test_extra_collection_raises(variables, model):
    with pytest.raises(KeyError, match="collections"):
        state_dict_from_jax(model, {**variables, "intermediates": {}})


def test_shape_mismatch_raises(variables, model):
    flat = _flat_copy(variables)
    flat["params"]["rpn_head/conv/kernel"] = np.zeros((1, 1, 32, 64), np.float32)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax(model, flat)


def test_random_init_is_seeded_and_sets_frozen_constants():
    a = init_random_(DispRCNN(**TINY, device="cpu"), torch.Generator().manual_seed(3))
    b = init_random_(DispRCNN(**TINY, device="cpu"), torch.Generator().manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    var = sa["backbone.body.layer3_2.bn2.running_var"]
    assert not torch.equal(var, torch.ones_like(var))
    assert sa["rpn_head.conv.bias"].abs().sum() > 0


@pytest.fixture(scope="module")
def psm_variables():
    x = jnp.zeros((1, 64, 64, 3))
    return draw_variables(JPSMNet(maxdisp=16, mindisp=-16), x, x, seed=2, train=False)


def test_psmnet_sets_every_key(psm_variables):
    """Every PSMNet entry is set from params or batch_stats, and every JAX
    variable is used: BatchNorm params and statistics, 2D and 3D convs, the
    bias-free classifier convs and the flipped transposed convs."""
    model = PSMNet(maxdisp=16, mindisp=-16)
    sd = state_dict_from_jax(model, psm_variables)
    assert set(sd) == set(model.state_dict())
    p, st = psm_variables["params"], psm_variables["batch_stats"]
    np.testing.assert_array_equal(  # 3D conv: DHWIO -> OIDHW
        sd["dres0_0.Conv_0.weight"].numpy(), p["dres0_0"]["Conv_0"]["kernel"].transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        sd["classif3_1.weight"].numpy(), p["classif3_1"]["kernel"].transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(  # transposed 3D conv: flipped, (in, out, kd, kh, kw)
        sd["dres4.ConvTranspose_1.weight"].numpy(),
        p["dres4"]["ConvTranspose_1"]["kernel"][::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))
    fe = "feature_extraction"
    np.testing.assert_array_equal(
        sd[f"{fe}.BasicBlock_3.Conv_0.weight"].numpy(),
        p[fe]["BasicBlock_3"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd[f"{fe}.ConvBN_7.BatchNorm_0.weight"].numpy(),
                                  p[fe]["ConvBN_7"]["BatchNorm_0"]["scale"])
    np.testing.assert_array_equal(sd["dres2.BatchNorm_1.running_var"].numpy(),
                                  st["dres2"]["BatchNorm_1"]["var"])
    np.testing.assert_array_equal(sd["dres1_1.BatchNorm_0.running_mean"].numpy(),
                                  st["dres1_1"]["BatchNorm_0"]["mean"])
    assert all(int(v) == 0 for k, v in sd.items() if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("coll,path", [
    ("batch_stats", "dres0_1/BatchNorm_0/var"),
    ("params", "dres3/ConvTranspose_0/kernel"),
    ("params", "feature_extraction/BasicBlock_19/BatchNorm_0/scale"),
])
def test_psmnet_missing_key_raises(psm_variables, coll, path):
    flat = _flat_copy(psm_variables)
    del flat[coll][path]
    with pytest.raises(KeyError, match="left unset"):
        state_dict_from_jax(PSMNet(maxdisp=16, mindisp=-16), flat)


@pytest.mark.parametrize("coll,path", [
    ("batch_stats", "dres0_1/Conv_0/mean"),  # statistics of a conv
    ("batch_stats", "dres0_1/BatchNorm_0/scale"),  # a param in the statistics
    ("params", "classif1_1/bias"),  # the classifier conv has no bias
])
def test_psmnet_extra_key_raises(psm_variables, coll, path):
    flat = _flat_copy(psm_variables)
    flat[coll][path] = np.zeros((32,), np.float32)
    with pytest.raises(KeyError):
        state_dict_from_jax(PSMNet(maxdisp=16, mindisp=-16), flat)


class _OneDeconv(nn.Module):
    def __init__(self):
        super().__init__()
        self.ConvTranspose_0 = _deconv(4, 3)


def test_conv_transpose3d_flip_and_padding_match_flax():
    """One flax ConvTranspose(k=3, s=2, padding [(1, 2)] * 3), as the JAX
    hourglass builds it, against the port's ConvTranspose3d(k=3, s=2, p=1,
    output_padding=1) with the kernel converted by state_dict_from_jax."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32)  # NDHWC
    kernel = rng.standard_normal((3, 3, 3, 4, 3)).astype(np.float32)
    layer = fnn.ConvTranspose(3, (3, 3, 3), strides=(2, 2, 2), padding=[(1, 2)] * 3,
                              use_bias=False)
    want = np.asarray(layer.apply({"params": {"kernel": kernel}}, jnp.asarray(x)))
    model = load_jax_variables(_OneDeconv(), {"params": {"ConvTranspose_0": {"kernel": kernel}}})
    with torch.no_grad():
        got = model.ConvTranspose_0(torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()))
    assert want.shape == (2, 6, 8, 10, 3)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 4, 1), want, rtol=1e-5, atol=1e-5)


def test_random_init_covers_psmnet():
    """init_random_ sets every conv and batch norm of PSMNet from the
    generator, scaling down the last norm of each tower residual branch."""
    a = init_random_(PSMNet(maxdisp=16, mindisp=-16), torch.Generator().manual_seed(4))
    b = init_random_(PSMNet(maxdisp=16, mindisp=-16), torch.Generator().manual_seed(4))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    var = sa["dres3.BatchNorm_0.running_var"]
    assert not torch.equal(var, torch.ones_like(var))
    fe = "feature_extraction"
    assert sa[f"{fe}.BasicBlock_5.ConvBN_1.BatchNorm_0.weight"].max() <= 0.3
    assert sa[f"{fe}.BasicBlock_5.ConvBN_0.BatchNorm_0.weight"].min() >= 0.5
    assert sa[f"{fe}.ConvBN_1.BatchNorm_0.weight"].min() >= 0.5


@pytest.fixture(scope="module")
def prcnn_variables():
    """A JAX PointRCNN (SA ladder 32/16/8/4 over clouds of 32 points)."""
    from disprcnn_tpu.models.pointrcnn.point_rcnn import PointRCNN as JPointRCNN

    args = (jnp.zeros((2, 32, 3)), jnp.ones((2,), bool), jnp.zeros((2,)), jnp.zeros((2, 3)))
    return draw_variables(JPointRCNN(npoints=32, sa_npoints=(32, 16, 8, 4)), *args, seed=3,
                          train=False)


def _prcnn():
    from disprcnn_tpu_torch.models.pointrcnn.point_rcnn import PointRCNN

    return PointRCNN(npoints=32, sa_npoints=(32, 16, 8, 4))


def test_pointrcnn_sets_every_key(prcnn_variables):
    """Every PointRCNN entry is set and every JAX variable used: the SA
    scales' sliced mlp0 (xyz rows first) and BatchNorms, the FP MLPs, the
    RPN heads, and the BN-free RCNN's dense layers and heads."""
    model = _prcnn()
    sd = state_dict_from_jax(model, prcnn_variables)
    assert set(sd) == set(model.state_dict())
    p, st = prcnn_variables["params"], prcnn_variables["batch_stats"]
    scale = p["rpn"]["backbone"]["sa1"]["mlp_scale0"]
    np.testing.assert_array_equal(  # (3 + C, C0) -> (C0, 3 + C)
        sd["rpn.backbone.sa1.mlp_scale0.mlp0.weight"].numpy(), scale["mlp0"]["kernel"].T)
    assert sd["rpn.backbone.sa1.mlp_scale0.mlp0.weight"].shape == (64, 3 + 96)
    np.testing.assert_array_equal(sd["rpn.backbone.sa1.mlp_scale0.bn2.weight"].numpy(),
                                  scale["bn2"]["scale"])
    np.testing.assert_array_equal(sd["rpn.backbone.fp2.mlp.bn1.running_var"].numpy(),
                                  st["rpn"]["backbone"]["fp2"]["mlp"]["bn1"]["var"])
    np.testing.assert_array_equal(sd["rpn.cls_head.bn0.running_mean"].numpy(),
                                  st["rpn"]["cls_head"]["bn0"]["mean"])
    np.testing.assert_array_equal(sd["rpn.reg_head.out.bias"].numpy(),
                                  p["rpn"]["reg_head"]["out"]["bias"])
    np.testing.assert_array_equal(sd["rcnn.sa0.mlp.mlp0.weight"].numpy(),
                                  p["rcnn"]["sa0"]["mlp"]["mlp0"]["kernel"].T)
    np.testing.assert_array_equal(sd["rcnn.merge_down.mlp0.bias"].numpy(),
                                  p["rcnn"]["merge_down"]["mlp0"]["bias"])
    np.testing.assert_array_equal(sd["rcnn.reg_out.weight"].numpy(),
                                  p["rcnn"]["reg_out"]["kernel"].T)


@pytest.mark.parametrize("coll,path", [
    ("params", "rpn/backbone/sa2/mlp_scale1/bn1/scale"),
    ("batch_stats", "rpn/cls_head/bn0/var"),
    ("params", "rcnn/cls_fc1/bias"),
])
def test_pointrcnn_missing_key_raises(prcnn_variables, coll, path):
    flat = _flat_copy(prcnn_variables)
    del flat[coll][path]
    with pytest.raises(KeyError, match="left unset"):
        state_dict_from_jax(_prcnn(), flat)


@pytest.mark.parametrize("coll,path", [
    ("params", "rcnn/xyz_up/bn0/scale"),  # the RCNN has no batch norm
    ("batch_stats", "rpn/backbone/fp0/mlp/mlp0/mean"),  # statistics of a dense layer
    ("params", "rpn/backbone/sa0/mlp_scale0/mlp0/bias"),  # BN scales' dense have no bias
])
def test_pointrcnn_extra_key_raises(prcnn_variables, coll, path):
    flat = _flat_copy(prcnn_variables)
    flat[coll][path] = np.zeros((16,), np.float32)
    with pytest.raises(KeyError):
        state_dict_from_jax(_prcnn(), flat)


def test_random_init_covers_pointrcnn():
    """init_random_ sets every dense layer and batch norm of PointRCNN from
    the generator, the statistics away from 0 and 1."""
    a = init_random_(_prcnn(), torch.Generator().manual_seed(5))
    b = init_random_(_prcnn(), torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    var = sa["rpn.backbone.sa3.mlp_scale1.bn1.running_var"]
    assert var.min() >= 0.5 and not torch.equal(var, torch.ones_like(var))
    assert sa["rcnn.sa1.mlp.mlp2.bias"].abs().sum() > 0


def test_random_init_of_the_detector_heads():
    """The 2D detector's box regressors start at zero and its classifiers
    at std 0.01 (the reference's init), so that an untrained detector
    proposes its anchors instead of boxes that span or leave the image."""
    sd = init_random_(DispRCNN(**TINY, device="cpu"), torch.Generator().manual_seed(6)).state_dict()
    for name in ("rpn_head.bbox_pred", "box_predictor.bbox_pred"):
        assert not sd[f"{name}.weight"].any() and not sd[f"{name}.bias"].any()
    for name in ("rpn_head.cls_logits", "box_predictor.cls_score"):
        w = sd[f"{name}.weight"]
        assert 0.005 < float(w.std()) < 0.02 and not sd[f"{name}.bias"].any()
