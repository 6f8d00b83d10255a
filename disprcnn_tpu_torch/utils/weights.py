"""Weights for the port: the JAX package's variables as a ``state_dict()``,
and random weights from an explicit ``torch.Generator``.

``state_dict_from_jax(model, variables)`` takes the JAX variables as numpy
arrays, ``{"params": {...}, "frozen": {...}, "batch_stats": {...}}`` (the
collections the model has), each either nested as Flax keeps them or
flattened by "/"-joined path. It maps

- a conv kernel (kh, kw, in, out) HWIO to (out, in, kh, kw) OIHW (a
  depthwise one, FBNet's (k, k, 1, mid), to (mid, 1, k, k)), and a 3D
  one (kd, kh, kw, in, out) DHWIO to (out, in, kd, kh, kw) OIDHW;
- a transposed-conv kernel, 2D or 3D, to (in, out, k...), flipped in every
  spatial dim (Flax's ConvTranspose correlates; torch's is the adjoint of
  a correlation);
- a dense kernel (in, out) to (out, in): ``nn.Dense``, and the
  ``_SlicedDense``/``_RawDense`` of the PointNet++ MLPs, whose mlp0 holds the
  3 xyz rows before the feature rows (the port keeps that column order);
- FrozenBatchNorm ``scale/bias/mean/var`` to the buffers
  ``weight/bias/running_mean/running_var``, renaming Flax's auto-numbered
  ``FrozenBatchNorm_<i>`` to the port's ``bn1..bn3``/``downsample_bn``
  (the ResNet's, and those of the C4 box head's ``head/layer4_{b}``);
- a Flax ``GroupNorm_<i>``'s params ``scale/bias`` (MODEL.BACKBONE.USE_GN,
  MODEL.FPN.USE_GN) to ``weight/bias`` of the port's GroupNorm in the same
  place: ``bn1..bn3``/``downsample_bn`` in the ResNet, as the frozen norms,
  and in the FPN ``lateral{k}_gn`` (Flax's first ones, from P2 up), then
  ``output{k}_gn`` (from the top down, as Flax creates them);
- a Flax ``BatchNorm``'s params ``scale/bias`` to ``weight/bias`` and its
  ``batch_stats`` ``mean/var`` to ``running_mean/running_var`` of the eval
  ``nn.BatchNorm{1,2,3}d`` of the same name (``num_batches_tracked``, which
  eval never reads, is set to 0; eps 1e-5), FBNet's ``RunningBatchNorm2d``
  included.

Names are the Flax module paths, "/" becoming ".": e.g.
``backbone/body/xif3_2/dw/conv`` (FBNet), ``backbone/fpn/p6_s2``,
``head/cls_tower0`` (RetinaNet), ``box_head/head/layer4_0/conv1`` (C4),
``pointrcnn/rpn/backbone/sa1/mlp_scale0/mlp0``, ``.../fp2/mlp/bn1``,
``pointrcnn/rpn/cls_head/fc0``, ``pointrcnn/rcnn/xyz_up/mlp1``,
``pointrcnn/rcnn/sa0/mlp/mlp2``, ``pointrcnn/rcnn/reg_out``.

Every key is checked: it raises on a JAX key it leaves unused, on a port
entry it leaves unset, and on a shape that does not match.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..models.backbone.fpn import FPN
from ..models.backbone.resnet import Bottleneck, FrozenBatchNorm, GroupNorm, Stem

_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_COLLECTIONS = ("params", "frozen", "batch_stats")


def flatten_variables(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {"a/b/c": array}."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(flatten_variables(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def norm_order(mod: nn.Module) -> list:
    """The port's names of the auto-numbered Flax norms (FrozenBatchNorm_<i>
    or GroupNorm_<i>) of a Stem, Bottleneck or FPN, in Flax's numbering."""
    if isinstance(mod, Stem):
        return ["bn1"]
    if isinstance(mod, Bottleneck):
        # the downsample norm is created first when there is one
        return (["downsample_bn"] if mod.downsample_bn is not None else []) + ["bn1", "bn2", "bn3"]
    if isinstance(mod, FPN) and mod.use_gn:
        n = mod.num_levels
        return ([f"lateral{k}_gn" for k in range(2, n + 2)]
                + [f"output{k}_gn" for k in range(n, 1, -1)])
    return []


def _bn_module_name(model: nn.Module, owner: str, flax_name: str) -> str:
    """Flax's FrozenBatchNorm_<i> or GroupNorm_<i> inside `owner` -> the
    port's attribute."""
    i = int(flax_name.rsplit("_", 1)[1])
    order = norm_order(model.get_submodule(owner))
    if not order:
        raise KeyError(f"no {flax_name.rsplit('_', 1)[0]} expected under {owner!r}")
    if i >= len(order):
        raise KeyError(f"{owner}/{flax_name} has no counterpart")
    return order[i]


def _convert(model: nn.Module, path: str, arr: np.ndarray, coll: str):
    """One JAX variable of collection `coll` -> (state_dict key, tensor)."""
    parts = path.split("/")
    owner, module_name, leaf = ".".join(parts[:-2]), parts[-2], parts[-1]
    if coll == "frozen":
        if not module_name.startswith("FrozenBatchNorm_") or leaf not in _BN_NAMES:
            raise KeyError(f"unexpected frozen variable {path!r}")
        name = _bn_module_name(model, owner, module_name)
        return f"{owner}.{name}.{_BN_NAMES[leaf]}", arr
    if module_name.startswith("GroupNorm_"):
        name = _bn_module_name(model, owner, module_name)
        if coll != "params" or leaf not in ("scale", "bias"):
            raise KeyError(f"unexpected {coll} variable {path!r} of a group norm")
        if not isinstance(model.get_submodule(f"{owner}.{name}"), GroupNorm):
            raise KeyError(f"{path!r} maps to {owner}.{name}, which is not a GroupNorm")
        return f"{owner}.{name}.{_BN_NAMES[leaf]}", arr
    key_mod = f"{owner}.{module_name}" if owner else module_name
    mod = model.get_submodule(key_mod)
    if isinstance(mod, nn.modules.batchnorm._BatchNorm):
        names = ({"mean": "running_mean", "var": "running_var"} if coll == "batch_stats"
                 else {"scale": "weight", "bias": "bias"})
        if leaf not in names:
            raise KeyError(f"unexpected {coll} variable {path!r} of a batch norm")
        return f"{key_mod}.{names[leaf]}", arr
    if coll == "batch_stats":
        raise KeyError(f"batch_stats variable {path!r} maps to {type(mod).__name__}")
    if leaf == "bias":
        return f"{key_mod}.bias", arr
    if leaf != "kernel":
        raise KeyError(f"unexpected parameter {path!r}")
    if isinstance(mod, nn.ConvTranspose3d):
        arr = arr[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
    elif isinstance(mod, nn.ConvTranspose2d):
        arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
    elif isinstance(mod, nn.Conv3d):
        arr = arr.transpose(4, 3, 0, 1, 2)
    elif isinstance(mod, nn.Conv2d):
        arr = arr.transpose(3, 2, 0, 1)
    elif isinstance(mod, nn.Linear):
        arr = arr.T
    else:
        raise KeyError(f"{path!r} maps to {type(mod).__name__}, not a conv or dense layer")
    return f"{key_mod}.weight", arr


def state_dict_from_jax(model: nn.Module, variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables -> a complete state_dict for `model` (see module doc)."""
    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise KeyError(f"unexpected variable collections {sorted(extra)}")
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key in target:
        if key.endswith(".num_batches_tracked"):
            out[key] = torch.zeros_like(target[key])
    for coll in _COLLECTIONS:
        for path, arr in flatten_variables(variables.get(coll, {})).items():
            try:
                key, val = _convert(model, path, np.asarray(arr), coll)
            except AttributeError as e:  # get_submodule on a missing path
                raise KeyError(f"JAX variable {coll}/{path} has no counterpart in the port") from e
            if key not in target:
                raise KeyError(f"JAX variable {coll}/{path} -> {key!r}, not in the port")
            if key in out:
                raise KeyError(f"two JAX variables map to {key!r}")
            if tuple(val.shape) != tuple(target[key].shape):
                raise ValueError(f"{coll}/{path}: shape {val.shape} -> {key} "
                                 f"{tuple(target[key].shape)}")
            out[key] = torch.from_numpy(np.ascontiguousarray(val)).to(target[key].dtype)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"port entries left unset: {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return out


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load the JAX variables into `model` in place (strict)."""
    model.load_state_dict(state_dict_from_jax(model, variables), strict=True)
    return model


# The last norm of each residual branch: a ResNet Bottleneck's bn3 and the
# second ConvBN of a PSMNet tower BasicBlock.
_RESIDUAL_BRANCH_NORM = re.compile(r"(^|\.)(bn3|BasicBlock_\d+\.ConvBN_1\.BatchNorm_0)$")


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from `generator` (which must live on the model's
    device): He-normal convs and dense layers, small biases, and frozen-BN
    constants away from 0/1. A RetinaNet head's ``cls_logits`` bias takes
    its prior (``cls_logits_prior_bias``, -log((1 - 0.01) / 0.01)), as
    Flax's bias_init draws it. The last norm of each residual branch is
    scaled down so activations stay finite through deep stacks. The 2D
    detector's classifiers (the RPN's ``cls_logits``, the box head's
    ``cls_score``) are drawn as the reference initializes them (normal, std
    0.01, zero bias), and its box regressors (``bbox_pred``) are zero: an
    untrained detector then proposes its anchors and detects its proposals,
    left and right boxes alike, instead of boxes that span the image or
    collapse at its border."""
    def normal(t: torch.Tensor, std: float, mean: float = 0.0):
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * std + mean)

    def uniform(t: torch.Tensor, lo: float, hi: float):
        t.copy_(torch.rand(t.shape, generator=generator, device=t.device) * (hi - lo) + lo)

    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d,
                            nn.Linear)):
            # fan-in: a transposed conv's weight is (in, out, k...)
            fan_in = (mod.weight.shape[0] * mod.weight[0, 0].numel()
                      if isinstance(mod, (nn.ConvTranspose2d, nn.ConvTranspose3d))
                      else mod.weight[0].numel())
            if name.endswith(("cls_logits", "cls_score", "bbox_pred")):
                normal(mod.weight, 0.0 if name.endswith("bbox_pred") else 0.01)
                owner = model.get_submodule(name.rpartition(".")[0])
                mod.bias.fill_(getattr(owner, "cls_logits_prior_bias", 0.0)
                               if name.endswith("cls_logits") else 0.0)
                continue
            normal(mod.weight, math.sqrt(2.0 / fan_in))
            if mod.bias is not None:
                normal(mod.bias, 0.01)
        elif isinstance(mod, GroupNorm):
            uniform(mod.weight, *((0.1, 0.3) if _RESIDUAL_BRANCH_NORM.search(name)
                                  else (0.5, 1.0)))
            normal(mod.bias, 0.05)
        elif isinstance(mod, (FrozenBatchNorm, nn.modules.batchnorm._BatchNorm)):
            lo, hi = (0.1, 0.3) if _RESIDUAL_BRANCH_NORM.search(name) else (0.5, 1.0)
            uniform(mod.weight, lo, hi)
            normal(mod.bias, 0.05)
            normal(mod.running_mean, 0.05)
            uniform(mod.running_var, 0.5, 1.5)
    return model
