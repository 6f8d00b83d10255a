"""The reference's released checkpoints as the port's ``state_dict()`` keys
(counterpart of disprcnn_tpu/utils/torch_import.py).

The released artifacts (the reference's scripts/download/model/*):

- the 2D detector in maskrcnn-benchmark format
  (``srcnn_pretrained_2d_mrcnn_format.pth``, ``smrcnn.pth``);
- the standalone iDispNet (PSMNet) ``bestmodel`` ``.tar``, its keys
  ``module.``-prefixed;
- ``pointrcnn.pth``, ``torch.load(...)["model"]`` with DDP ``module.``
  prefixes;
- the full DispRCNN3D stage, ``dispnet.*`` and ``pcnet.*`` in one dict;
- a Detectron/Caffe2 ``.pkl`` of the ResNet(-FPN) backbone.

The port's layouts are torch's, so only the names change: no transposes
and no flips (a ConvTranspose2d weight is the reference's as it is), and a
1x1 Conv1d/Conv2d weight of PointRCNN becomes the port's ``nn.Linear``
``(O, I)`` by a reshape. Each ``remap_*`` returns the port's key for a
reference key, or None where the port has no counterpart;
``import_*`` returns a ``{port key: tensor}`` dict for
``utils/checkpoint.py::align_and_update_params``, which fills a model by
the longest dotted suffix, so a file of one stage fills the same modules
inside a larger model. Torch BN's ``num_batches_tracked`` is skipped, as
the JAX package skips it; ``load_stage_weights`` leaves the model's own.
"""
from __future__ import annotations

import pickle
import re
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """A ``.pth``/``.tar`` file -> its tensors: the first of ``model``,
    ``state_dict``, ``model_state`` that holds a dict (else the file's
    dict itself), non-tensors dropped and every ``module.`` removed
    wherever it stands in a key."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict):
        for key in ("model", "state_dict", "model_state"):
            if key in blob and isinstance(blob[key], dict):
                blob = blob[key]
                break
    return {k.replace("module.", ""): v.detach().cpu() for k, v in blob.items()
            if isinstance(v, torch.Tensor)}


def _counter(key: str) -> bool:
    return key.endswith("num_batches_tracked")


# -- the released 2D detector (maskrcnn-benchmark names) --------------------
_Rule = Tuple[re.Pattern, Union[str, Callable]]
_2D_RULES: List[_Rule] = [
    (re.compile(r"^backbone\.body\.stem\.(conv1|bn1)\."), r"backbone.body.stem.\1."),
    (re.compile(r"^backbone\.body\.layer(\d)\.(\d+)\.(conv\d|bn\d)\."),
     r"backbone.body.layer\1_\2.\3."),
    (re.compile(r"^backbone\.body\.layer(\d)\.(\d+)\.downsample\.0\."),
     r"backbone.body.layer\1_\2.downsample_conv."),
    (re.compile(r"^backbone\.body\.layer(\d)\.(\d+)\.downsample\.1\."),
     r"backbone.body.layer\1_\2.downsample_bn."),
    (re.compile(r"^backbone\.fpn\.fpn_inner(\d)\."),
     lambda m: f"backbone.fpn.lateral{int(m.group(1)) + 1}."),
    (re.compile(r"^backbone\.fpn\.fpn_layer(\d)\."),
     lambda m: f"backbone.fpn.output{int(m.group(1)) + 1}."),
    (re.compile(r"^rpn\.head\.(conv|cls_logits|bbox_pred)\."), r"rpn_head.\1."),
    (re.compile(r"^roi_heads\.box\.feature_extractor\.RCNN_top\.0\."),
     "box_extractor.rcnn_top0."),
    (re.compile(r"^roi_heads\.box\.feature_extractor\.RCNN_top\.3\."),
     "box_extractor.rcnn_top1."),
    (re.compile(r"^roi_heads\.box\.predictor\.(cls_score|bbox_pred)\."), r"box_predictor.\1."),
    (re.compile(r"^roi_heads\.mask\.feature_extractor\.mask_fcn(\d)\."), r"mask_head.fcn\1."),
    (re.compile(r"^roi_heads\.mask\.predictor\.conv5_mask\."), "mask_head.deconv."),
    (re.compile(r"^roi_heads\.mask\.predictor\.mask_fcn_logits\."), "mask_head.mask_logits."),
]


def remap_disprcnn2d_name(key: str) -> str:
    """A maskrcnn-benchmark key of the stereo detector -> the port's key
    (the first rule that matches; a key no rule matches is kept as it is,
    as the JAX package keeps it, and matches nothing of the port)."""
    for pat, repl in _2D_RULES:
        if pat.match(key):
            return pat.sub(repl, key, count=1)
    return key


def remap_disprcnn2d(sd: StateDict) -> StateDict:
    return {remap_disprcnn2d_name(k): v for k, v in sd.items() if not _counter(k)}


# -- Caffe2 / Detectron pickles ---------------------------------------------
# Reference utils/c2_model_loading.py:12-175 (maskrcnn-benchmark lineage).
# The blobs are named in Caffe2's convention (res2_0_branch2a_w,
# res2_0_branch2a_bn_s, conv1_w, fpn_inner_res2_2_sum_lateral_w, ...) and
# carry BN as an affine only (scale s, bias b): the statistics are folded
# in, so the FrozenBN's running mean 0 and variance 1 are made up.
_C2_STAGE = {"res2": "layer1", "res3": "layer2", "res4": "layer3", "res5": "layer4"}
_C2_BRANCH = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3",
              "branch1": "downsample.0"}


def rename_c2_resnet_key(k: str) -> Optional[str]:
    """A Caffe2 blob name -> the maskrcnn-benchmark key (backbone and FPN),
    or None for a blob with no counterpart (momenta, the classifier)."""
    if k.endswith("_momentum") or k.startswith(("fc1000", "pred_")):
        return None
    m = re.match(r"^conv1_(w|b)$", k)
    if m:
        return f"backbone.body.stem.conv1.{'weight' if m.group(1) == 'w' else 'bias'}"
    m = re.match(r"^res_conv1_bn_(s|b)$", k) or re.match(r"^conv1_bn_(s|b)$", k)
    if m:
        return f"backbone.body.stem.bn1.{'weight' if m.group(1) == 's' else 'bias'}"
    m = re.match(r"^(res[2-5])_(\d+)_(branch(?:1|2[abc]))(_bn)?_(w|b|s)$", k)
    if m:
        stage, blk, br, bn, leaf = m.groups()
        mod = _C2_BRANCH[br]
        if bn:
            mod = "downsample.1" if mod == "downsample.0" else mod.replace("conv", "bn")
        leaf_name = {"w": "weight", "s": "weight", "b": "bias"}[leaf]
        return f"backbone.body.{_C2_STAGE[stage]}.{blk}.{mod}.{leaf_name}"
    m = re.match(r"^fpn_inner_(res[2-5])_\d+_sum(?:_lateral)?_(w|b)$", k)
    if m:
        lvl = int(m.group(1)[3]) - 1  # res2 -> fpn_inner1
        return f"backbone.fpn.fpn_inner{lvl}.{'weight' if m.group(2) == 'w' else 'bias'}"
    m = re.match(r"^fpn_(res[2-5])_\d+_sum_(w|b)$", k)
    if m:
        lvl = int(m.group(1)[3]) - 1
        return f"backbone.fpn.fpn_layer{lvl}.{'weight' if m.group(2) == 'w' else 'bias'}"
    return None


def load_c2_pickle(path: str) -> Dict[str, np.ndarray]:
    """A Detectron pickle (latin-1, its arrays under ``blobs`` if there is
    such a key) -> {blob name: array}."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if isinstance(data, dict) and "blobs" in data:
        data = data["blobs"]
    return {k: np.asarray(v) for k, v in data.items()
            if isinstance(v, np.ndarray) or hasattr(v, "shape")}


def import_c2_backbone(path: str) -> StateDict:
    """A Detectron ``.pkl`` -> {port key: tensor} of the ResNet(-FPN)
    backbone, every norm's running mean 0 and variance 1 made up."""
    sd: StateDict = {}
    for k, v in load_c2_pickle(path).items():
        name = rename_c2_resnet_key(k)
        if name is not None:
            sd[name] = torch.from_numpy(np.ascontiguousarray(v))
    for k in list(sd):
        if (".bn" in k or "downsample.1" in k) and k.endswith(".weight"):
            base, n = k.rsplit(".", 1)[0], sd[k].shape[0]
            sd.setdefault(f"{base}.running_mean", torch.zeros(n))
            sd.setdefault(f"{base}.running_var", torch.ones(n))
    return remap_disprcnn2d(sd)


# -- the released PSMNet ------------------------------------------------------
# The standalone iDispNet of the reference's train_idispnet_fa.py
# (modeling/psmnet/stackhourglass.PSMNet). Each torch Sequential index maps
# to the port's explicit module names, which follow Flax's numbering.
_FE_LAYER_OFFSET = {"1": 0, "2": 3, "3": 19, "4": 22}  # BasicBlock_ index base


def remap_psmnet_name(k: str) -> Optional[str]:
    """A PSMNet module path (leaf stripped) -> the port's, or None."""
    k = re.sub(r"^(module\.|model\.)", "", k)
    m = re.match(r"^feature_extraction\.firstconv\.([024])\.([01])$", k)
    if m:
        sub = "Conv_0" if m.group(2) == "0" else "BatchNorm_0"
        return f"feature_extraction.ConvBN_{int(m.group(1)) // 2}.{sub}"
    m = re.match(r"^feature_extraction\.layer([1-4])\.(\d+)\.(.+)$", k)
    if m:
        blk = _FE_LAYER_OFFSET[m.group(1)] + int(m.group(2))
        sub = {"conv1.0.0": "ConvBN_0.Conv_0", "conv1.0.1": "ConvBN_0.BatchNorm_0",
               "conv2.0": "ConvBN_1.Conv_0", "conv2.1": "ConvBN_1.BatchNorm_0",
               "downsample.0": "Conv_0", "downsample.1": "BatchNorm_0"}.get(m.group(3))
        return None if sub is None else f"feature_extraction.BasicBlock_{blk}.{sub}"
    m = re.match(r"^feature_extraction\.branch([1-4])\.1\.([01])$", k)
    if m:
        sub = "Conv_0" if m.group(2) == "0" else "BatchNorm_0"
        return f"feature_extraction.ConvBN_{int(m.group(1)) + 2}.{sub}"
    m = re.match(r"^feature_extraction\.lastconv\.(0\.[01]|2)$", k)
    if m:
        sub = {"0.0": "ConvBN_7.Conv_0", "0.1": "ConvBN_7.BatchNorm_0", "2": "Conv_0"}[m.group(1)]
        return f"feature_extraction.{sub}"
    m = re.match(r"^dres([01])\.([02])\.([01])$", k)
    if m:
        sub = "Conv_0" if m.group(3) == "0" else "BatchNorm_0"
        return f"dres{m.group(1)}_{0 if m.group(2) == '0' else 1}.{sub}"
    m = re.match(r"^dres([234])\.conv([1-4])\.(?:0\.)?([01])$", k)
    if m:
        sub = "Conv_0" if m.group(3) == "0" else "BatchNorm_0"
        return f"dres{m.group(1)}.ConvBN_{int(m.group(2)) - 1}.{sub}"
    m = re.match(r"^dres([234])\.conv([56])\.([01])$", k)
    if m:
        j = int(m.group(2)) - 5
        sub = f"ConvTranspose_{j}" if m.group(3) == "0" else f"BatchNorm_{j}"
        return f"dres{m.group(1)}.{sub}"
    m = re.match(r"^classif([123])\.(0\.[01]|2)$", k)
    if m:
        n = m.group(1)
        return {"0.0": f"classif{n}_0.Conv_0", "0.1": f"classif{n}_0.BatchNorm_0",
                "2": f"classif{n}_1"}[m.group(2)]
    return None


def _remap_leaves(sd: StateDict, remap: Callable[[str], Optional[str]],
                  prefix: str = "") -> StateDict:
    out: StateDict = {}
    for k, v in sd.items():
        if _counter(k) or "." not in k:
            continue
        base, leaf = k.rsplit(".", 1)
        name = remap(base)
        if name is not None:
            out[f"{prefix}{name}.{leaf}"] = v
    return out


def import_psmnet(sd: StateDict, prefix: str = "") -> StateDict:
    """The released PSMNet's tensors -> {port key: tensor}."""
    return _remap_leaves(sd, remap_psmnet_name, prefix)


# -- the released PointRCNN ---------------------------------------------------
# models/kitti/<cls>/<base>/rcnn/pointrcnn.pth of lib/net/point_rcnn.PointRCNN
# (disprcnn3d.py:35-42). Torch module paths:
#   rpn.backbone_net.SA_modules.{k}.mlps.{i}.layer{j}.{conv|bn.bn}
#   rpn.backbone_net.FP_modules.{k}.mlp.layer{j}.{conv|bn.bn}
#   rpn.rpn_{cls|reg}_layer.{s}.{conv|bn.bn}   (a Dropout at index 1)
#   rcnn_net.{xyz_up|merge_down}_layer.layer{j}.{conv|bn.bn}
#   rcnn_net.SA_modules.{k}.mlps.0.layer{j}.{conv|bn.bn}
#   rcnn_net.{cls|reg}_layer.{s}.{conv|bn.bn}
# Every conv is a 1x1 Conv1d/Conv2d (pt_utils), the port's nn.Linear; the
# BN wrappers nest twice ('bn.bn', pytorch_utils.py:83,108).


def _head_idx(s: int, n_fc: int) -> str:
    """A pt_utils head's Sequential index -> fc{i} / out (the Dropout at
    index 1 shifts the later ones by one)."""
    if s == 0:
        return "fc0"
    i = s - 1
    return f"fc{i}" if i < n_fc else "out"


def remap_pointrcnn_name(k: str, n_cls_fc: int = 1, n_reg_fc: int = 1) -> Optional[str]:
    """A PointRCNN module path (leaf stripped) -> the port's, or None."""
    k = re.sub(r"^(module\.|pcnet\.)*", "", k)
    m = re.match(r"^rpn\.backbone_net\.SA_modules\.(\d+)\.mlps\.(\d+)\.layer(\d+)\.(conv|bn\.bn)$", k)
    if m:
        sub = f"mlp{m.group(3)}" if m.group(4) == "conv" else f"bn{m.group(3)}"
        return f"rpn.backbone.sa{m.group(1)}.mlp_scale{m.group(2)}.{sub}"
    m = re.match(r"^rpn\.backbone_net\.FP_modules\.(\d+)\.mlp\.layer(\d+)\.(conv|bn\.bn)$", k)
    if m:
        sub = f"mlp{m.group(2)}" if m.group(3) == "conv" else f"bn{m.group(2)}"
        return f"rpn.backbone.fp{m.group(1)}.mlp.{sub}"
    m = re.match(r"^rpn\.rpn_(cls|reg)_layer\.(\d+)\.(conv|bn\.bn)$", k)
    if m:
        head, s, kind = m.group(1), int(m.group(2)), m.group(3)
        slot = _head_idx(s, n_cls_fc if head == "cls" else n_reg_fc)
        return f"rpn.{head}_head.{slot if kind == 'conv' else slot.replace('fc', 'bn')}"
    m = re.match(r"^rcnn_net\.(xyz_up|merge_down)_layer\.layer(\d+)\.(conv|bn\.bn)$", k)
    if m:
        sub = f"mlp{m.group(2)}" if m.group(3) == "conv" else f"bn{m.group(2)}"
        return f"rcnn.{m.group(1)}.{sub}"
    m = re.match(r"^rcnn_net\.SA_modules\.(\d+)\.mlps\.0\.layer(\d+)\.(conv|bn\.bn)$", k)
    if m:
        sub = f"mlp{m.group(2)}" if m.group(3) == "conv" else f"bn{m.group(2)}"
        return f"rcnn.sa{m.group(1)}.mlp.{sub}"
    m = re.match(r"^rcnn_net\.(cls|reg)_layer\.(\d+)\.(conv|bn\.bn)$", k)
    if m:
        head, s, kind = m.group(1), int(m.group(2)), m.group(3)
        slot = _head_idx(s, n_cls_fc if head == "cls" else n_reg_fc)
        return f"rcnn.{head}_{slot if kind == 'conv' else slot.replace('fc', 'bn')}"
    return None


def import_pointrcnn(sd: StateDict, n_cls_fc: int = 1, n_reg_fc: int = 1,
                     rcnn_n_cls_fc: int = 2, rcnn_n_reg_fc: int = 2,
                     prefix: str = "") -> StateDict:
    """The released ``pointrcnn.pth``'s tensors -> {port key: tensor}; the
    FC counts are the RPN's and the RCNN's heads'."""
    out: StateDict = {}
    for k, v in sd.items():
        if _counter(k) or "." not in k:
            continue
        base, leaf = k.rsplit(".", 1)
        ncf, nrf = (rcnn_n_cls_fc, rcnn_n_reg_fc) if "rcnn_net." in k else (n_cls_fc, n_reg_fc)
        name = remap_pointrcnn_name(base, ncf, nrf)
        if name is None:
            continue
        if leaf == "weight" and v.dim() in (3, 4):  # 1x1 Conv1d/Conv2d -> Linear
            v = v.reshape(v.shape[0], v.shape[1])
        out[f"{prefix}{name}.{leaf}"] = v
    return out


def import_disprcnn3d(sd: StateDict) -> StateDict:
    """The full DispRCNN3D stage's tensors (``dispnet.*`` and ``pcnet.*``)
    -> {port key: tensor} under the port's ``idispnet.`` and ``pointrcnn.``."""
    scope = lambda p: {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    return {**import_psmnet(scope("dispnet."), prefix="idispnet."),
            **import_pointrcnn(scope("pcnet."), prefix="pointrcnn.")}


def import_released(path: str) -> Tuple[str, StateDict]:
    """A released ``.pth``/``.tar`` -> (its layout, {port key: tensor}),
    the layout told apart in the JAX package's order: ``dispnet.``/
    ``pcnet.`` keys, then ``backbone_net``, then ``feature_extraction``,
    else the 2D detector."""
    sd = load_torch_state_dict(path)
    if any(k.startswith(("dispnet.", "pcnet.")) for k in sd):
        return "disprcnn3d", import_disprcnn3d(sd)
    if any("backbone_net" in k for k in sd):
        return "pointrcnn", import_pointrcnn(sd)
    if any(k.startswith("feature_extraction") for k in sd):
        return "psmnet", import_psmnet(sd)
    return "disprcnn2d", remap_disprcnn2d(sd)
