"""The JAX variables of a port model's state_dict: the inverse of
utils/weights.py::state_dict_from_jax, key by key, for the port's parity
tests (no JAX model is traced to draw them). It covers the FrozenBatchNorm
and GroupNorm numbering of the ResNet and FPN (weights.norm_order), Flax
BatchNorm params and batch_stats, and conv, transposed-conv and dense
kernels."""
import numpy as np
from torch import nn

from disprcnn_tpu_torch.models.backbone.resnet import FrozenBatchNorm, GroupNorm
from disprcnn_tpu_torch.utils.weights import norm_order

_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def jax_tree(model: nn.Module, sd: dict) -> dict:
    """{"params": ..., "frozen": ..., "batch_stats": ...} nested as Flax
    keeps them, of which `sd` is state_dict_from_jax(model, .)."""
    tree = {}
    for key, val in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        owner, leaf = key.rsplit(".", 1)
        parent, name = owner.rsplit(".", 1) if "." in owner else ("", owner)
        mod, arr = model.get_submodule(owner), val.detach().cpu().numpy()
        if isinstance(mod, (FrozenBatchNorm, GroupNorm)):
            kind = "FrozenBatchNorm" if isinstance(mod, FrozenBatchNorm) else "GroupNorm"
            i = norm_order(model.get_submodule(parent)).index(name)
            coll = "frozen" if kind == "FrozenBatchNorm" else "params"
            path = f"{parent}.{kind}_{i}.{_BN[leaf]}"
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            coll = "batch_stats" if leaf.startswith("running") else "params"
            path = f"{owner}.{_BN[leaf]}"
        elif leaf == "bias":
            coll, path = "params", key
        else:
            coll, path = "params", f"{owner}.kernel"
            if isinstance(mod, nn.ConvTranspose3d):
                arr = arr.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
            elif isinstance(mod, nn.ConvTranspose2d):
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                arr = arr.transpose(*range(2, arr.ndim), 1, 0)
            else:
                arr = arr.T
        node = tree.setdefault(coll, {})
        *dirs, last = path.split(".")
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = np.ascontiguousarray(arr)
    return tree
