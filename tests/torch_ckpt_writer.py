"""The reference's released checkpoint layouts written from the port's
models, for the tests of utils/torch_import.py and for chip_smoke.py (this
module imports neither jax nor the JAX package).

Each ``reference_*`` turns a port ``state_dict()`` into the state dict the
reference's own module would hold, under its key names and layouts: the
maskrcnn-benchmark stereo detector, stackhourglass PSMNet (its BN counters
included), PointRCNN of pt_utils (1x1 Conv2d in the shared MLPs, Conv1d in
the heads with a Dropout at index 1, ``bn.bn`` norms) and DispRCNN3D's
``dispnet.``/``pcnet.`` scopes. ``c2_blobs`` writes a Detectron pickle's
Caffe2 blobs of the ResNet-FPN backbone (affine norms only). Every port
key must have a counterpart, else they raise.
"""
from __future__ import annotations

import pickle
import re
from typing import Dict

import numpy as np
import torch

_2D = [
    (r"^backbone\.body\.stem\.", "backbone.body.stem."),
    (r"^backbone\.body\.layer(\d)_(\d+)\.downsample_conv\.", r"backbone.body.layer\1.\2.downsample.0."),
    (r"^backbone\.body\.layer(\d)_(\d+)\.downsample_bn\.", r"backbone.body.layer\1.\2.downsample.1."),
    (r"^backbone\.body\.layer(\d)_(\d+)\.((?:conv|bn)\d)\.", r"backbone.body.layer\1.\2.\3."),
    (r"^backbone\.fpn\.lateral(\d)\.", lambda m: f"backbone.fpn.fpn_inner{int(m.group(1)) - 1}."),
    (r"^backbone\.fpn\.output(\d)\.", lambda m: f"backbone.fpn.fpn_layer{int(m.group(1)) - 1}."),
    (r"^rpn_head\.", "rpn.head."),
    (r"^box_extractor\.rcnn_top0\.", "roi_heads.box.feature_extractor.RCNN_top.0."),
    (r"^box_extractor\.rcnn_top1\.", "roi_heads.box.feature_extractor.RCNN_top.3."),
    (r"^box_predictor\.", "roi_heads.box.predictor."),
    (r"^mask_head\.fcn(\d)\.", r"roi_heads.mask.feature_extractor.mask_fcn\1."),
    (r"^mask_head\.deconv\.", "roi_heads.mask.predictor.conv5_mask."),
    (r"^mask_head\.mask_logits\.", "roi_heads.mask.predictor.mask_fcn_logits."),
]


def _rename(key: str, rules) -> str:
    for pat, repl in rules:
        if re.match(pat, key):
            return re.sub(pat, repl, key, count=1)
    raise KeyError(f"{key!r} has no reference counterpart")


def reference_2d(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's DispRCNN -> maskrcnn-benchmark keys."""
    return {_rename(k, _2D): v.clone() for k, v in sd.items()}


_BLOCK_LAYER = [(0, 1), (3, 2), (19, 3), (22, 4)]  # first BasicBlock_ of layer1..4


def _psm_module(name: str) -> str:
    m = re.match(r"^feature_extraction\.ConvBN_([0-7])\.(Conv_0|BatchNorm_0)$", name)
    if m:
        i, j = int(m.group(1)), "0" if m.group(2) == "Conv_0" else "1"
        if i < 3:
            return f"feature_extraction.firstconv.{2 * i}.{j}"
        if i < 7:
            return f"feature_extraction.branch{i - 2}.1.{j}"
        return f"feature_extraction.lastconv.0.{j}"
    if name == "feature_extraction.Conv_0":
        return "feature_extraction.lastconv.2"
    m = re.match(r"^feature_extraction\.BasicBlock_(\d+)\.(.+)$", name)
    if m:
        b = int(m.group(1))
        base, layer = max((o, n) for o, n in _BLOCK_LAYER if o <= b)
        sub = {"ConvBN_0.Conv_0": "conv1.0.0", "ConvBN_0.BatchNorm_0": "conv1.0.1",
               "ConvBN_1.Conv_0": "conv2.0", "ConvBN_1.BatchNorm_0": "conv2.1",
               "Conv_0": "downsample.0", "BatchNorm_0": "downsample.1"}[m.group(2)]
        return f"feature_extraction.layer{layer}.{b - base}.{sub}"
    m = re.match(r"^dres([01])_([01])\.(Conv_0|BatchNorm_0)$", name)
    if m:
        return f"dres{m.group(1)}.{2 * int(m.group(2))}.{0 if m.group(3) == 'Conv_0' else 1}"
    m = re.match(r"^dres([234])\.ConvBN_([0-3])\.(Conv_0|BatchNorm_0)$", name)
    if m:
        n, j = int(m.group(2)) + 1, 0 if m.group(3) == "Conv_0" else 1
        # hourglass conv2 is a bare convbn_3d; conv1, conv3, conv4 add a ReLU
        return f"dres{m.group(1)}.conv{n}.{j}" if n == 2 else f"dres{m.group(1)}.conv{n}.0.{j}"
    m = re.match(r"^dres([234])\.(ConvTranspose|BatchNorm)_([01])$", name)
    if m:
        return f"dres{m.group(1)}.conv{5 + int(m.group(3))}.{0 if m.group(2) == 'ConvTranspose' else 1}"
    m = re.match(r"^classif([123])_0\.(Conv_0|BatchNorm_0)$", name)
    if m:
        return f"classif{m.group(1)}.0.{0 if m.group(2) == 'Conv_0' else 1}"
    m = re.match(r"^classif([123])_1$", name)
    if m:
        return f"classif{m.group(1)}.2"
    raise KeyError(f"PSMNet module {name!r} has no reference counterpart")


def reference_psmnet(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's PSMNet -> stackhourglass PSMNet keys."""
    out = {}
    for k, v in sd.items():
        base, leaf = k.rsplit(".", 1)
        out[f"{_psm_module(base)}.{leaf}"] = v.clone()
    return out


def _head_slot(slot: str, n_fc: int) -> int:
    """fc{i} / out -> the pt_utils Sequential index (Dropout at 1)."""
    i = n_fc if slot == "out" else int(slot[2:])
    return 0 if i == 0 else i + 1


def _pr_module(name: str, counts: dict):
    """-> (reference module path, 'conv2d' | 'conv1d' | 'bn')."""
    m = re.match(r"^rpn\.backbone\.sa(\d+)\.mlp_scale(\d+)\.(mlp|bn)(\d+)$", name)
    if m:
        sub = "conv" if m.group(3) == "mlp" else "bn.bn"
        return (f"rpn.backbone_net.SA_modules.{m.group(1)}.mlps.{m.group(2)}.layer{m.group(4)}."
                f"{sub}", "conv2d" if m.group(3) == "mlp" else "bn")
    m = re.match(r"^rpn\.backbone\.fp(\d+)\.mlp\.(mlp|bn)(\d+)$", name)
    if m:
        sub = "conv" if m.group(2) == "mlp" else "bn.bn"
        return (f"rpn.backbone_net.FP_modules.{m.group(1)}.mlp.layer{m.group(3)}.{sub}",
                "conv2d" if m.group(2) == "mlp" else "bn")
    m = re.match(r"^rpn\.(cls|reg)_head\.(fc\d+|bn\d+|out)$", name)
    if m:
        head, slot = m.groups()
        idx = _head_slot(slot.replace("bn", "fc"), counts[f"rpn_{head}"])
        kind = "bn" if slot.startswith("bn") else "conv1d"
        return f"rpn.rpn_{head}_layer.{idx}.{'bn.bn' if kind == 'bn' else 'conv'}", kind
    m = re.match(r"^rcnn\.(xyz_up|merge_down)\.(mlp|bn)(\d+)$", name)
    if m:
        sub = "conv" if m.group(2) == "mlp" else "bn.bn"
        return (f"rcnn_net.{m.group(1)}_layer.layer{m.group(3)}.{sub}",
                "conv2d" if m.group(2) == "mlp" else "bn")
    m = re.match(r"^rcnn\.sa(\d+)\.mlp\.(mlp|bn)(\d+)$", name)
    if m:
        sub = "conv" if m.group(2) == "mlp" else "bn.bn"
        return (f"rcnn_net.SA_modules.{m.group(1)}.mlps.0.layer{m.group(3)}.{sub}",
                "conv2d" if m.group(2) == "mlp" else "bn")
    m = re.match(r"^rcnn\.(cls|reg)_(fc\d+|bn\d+|out)$", name)
    if m:
        head, slot = m.groups()
        idx = _head_slot(slot.replace("bn", "fc"), counts[f"rcnn_{head}"])
        kind = "bn" if slot.startswith("bn") else "conv1d"
        return f"rcnn_net.{head}_layer.{idx}.{'bn.bn' if kind == 'bn' else 'conv'}", kind
    raise KeyError(f"PointRCNN module {name!r} has no reference counterpart")


def reference_pointrcnn(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's PointRCNN -> lib/net/point_rcnn keys, the 1x1 convs'
    weights as Conv2d (O, I, 1, 1) in the shared MLPs and Conv1d (O, I, 1)
    in the heads."""
    counts = {}
    for head in ("rpn_cls", "rpn_reg", "rcnn_cls", "rcnn_reg"):
        stage, h = head.split("_")
        pat = rf"^rpn\.{h}_head\.fc(\d+)\." if stage == "rpn" else rf"^rcnn\.{h}_fc(\d+)\."
        counts[head] = len({m.group(1) for m in map(lambda k: re.match(pat, k), sd) if m})
    out = {}
    for k, v in sd.items():
        base, leaf = k.rsplit(".", 1)
        name, kind = _pr_module(base, counts)
        if leaf == "weight" and kind != "bn":
            v = v.reshape(*v.shape, *((1, 1) if kind == "conv2d" else (1,)))
        out[f"{name}.{leaf}"] = v.clone()
    return out


def reference_disprcnn3d(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's DispRCNN3D -> ``dispnet.*`` and ``pcnet.*``."""
    scope = lambda p: {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    extra = [k for k in sd if not k.startswith(("idispnet.", "pointrcnn."))]
    if extra:
        raise KeyError(f"{extra[:3]} have no reference counterpart")
    return {**{f"dispnet.{k}": v for k, v in reference_psmnet(scope("idispnet.")).items()},
            **{f"pcnet.{k}": v for k, v in reference_pointrcnn(scope("pointrcnn.")).items()}}


def ddp(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Keys as DistributedDataParallel saves them."""
    return {f"module.{k}": v for k, v in sd.items()}


_C2_STAGE = {"1": "res2", "2": "res3", "3": "res4", "4": "res5"}
_C2_BRANCH = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c",
              "bn1": "branch2a_bn", "bn2": "branch2b_bn", "bn3": "branch2c_bn",
              "downsample_conv": "branch1", "downsample_bn": "branch1_bn"}


def c2_blobs(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's DispRCNN backbone -> Detectron's Caffe2 blobs: the ResNet
    (norms as scale ``_s`` and bias ``_b``; their statistics are not
    written) and the FPN (``fpn_inner_res<L>_<last>_sum[_lateral]``,
    ``fpn_res<L>_<last>_sum``)."""
    last = {}
    for k in sd:
        m = re.match(r"^backbone\.body\.layer(\d)_(\d+)\.", k)
        if m:
            last[m.group(1)] = max(last.get(m.group(1), 0), int(m.group(2)))
    blobs = {}
    leaf_of = {"weight": "w", "bias": "b"}
    for k, v in sd.items():
        if not k.startswith("backbone.") or k.endswith(("running_mean", "running_var")):
            continue
        a = v.detach().cpu().numpy().copy()
        m = re.match(r"^backbone\.body\.stem\.(conv1|bn1)\.(weight|bias)$", k)
        if m:
            name = ("conv1_" + leaf_of[m.group(2)] if m.group(1) == "conv1"
                    else "res_conv1_bn_" + ("s" if m.group(2) == "weight" else "b"))
            blobs[name] = a
            continue
        m = re.match(r"^backbone\.body\.layer(\d)_(\d+)\.(\w+)\.(weight|bias)$", k)
        if m:
            br = _C2_BRANCH[m.group(3)]
            leaf = ("s" if m.group(4) == "weight" else "b") if br.endswith("_bn") else \
                leaf_of[m.group(4)]
            blobs[f"{_C2_STAGE[m.group(1)]}_{m.group(2)}_{br}_{leaf}"] = a
            continue
        m = re.match(r"^backbone\.fpn\.(lateral|output)(\d)\.(weight|bias)$", k)
        if m:
            lvl = int(m.group(2))
            res = f"res{lvl}_{last[str(lvl - 1)]}_sum"
            if m.group(1) == "lateral":
                name = f"fpn_inner_{res}{'' if lvl == 5 else '_lateral'}"
            else:
                name = f"fpn_{res}"
            blobs[f"{name}_{leaf_of[m.group(3)]}"] = a
            continue
        raise KeyError(f"{k!r} has no Caffe2 blob")
    return blobs


def write_pth(path: str, sd: Dict[str, torch.Tensor], wrapper: str = "model",
              **extra) -> str:
    """torch.save the state dict under `wrapper` (none: the dict itself),
    with `extra` entries beside it (an optimizer's state, an iteration)."""
    torch.save({wrapper: sd, **extra} if wrapper else {**sd, **extra}, path)
    return path


def write_pkl(path: str, blobs: Dict[str, np.ndarray]) -> str:
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    return path
