"""Checkpoints and the stage handoff (counterpart of
disprcnn_tpu/utils/checkpoint.py; reference utils/checkpoint.py:13-148,
model_serialization.py:10-80). ``torch.save`` takes the place of orbax.

- ``Checkpointer(directory, max_to_keep=10)`` writes ``step_<n>.pt`` files,
  each ``{"model": model.state_dict(), "optimizer": optimizer.state_dict()
  (with its update count), "step": n}``, and a ``last_checkpoint`` file
  holding the step; it keeps the newest max_to_keep. ``load(model,
  optimizer, load_optimizer=...)`` restores the newest into the model (and
  the optimizer) and returns its step as the start iteration. With
  load_optimizer False (SOLVER.LOAD_OPTIMIZER, False in every shipped
  config) the optimizer stays fresh but the saved step is still returned,
  as the JAX package's does: the iterations continue from the saved step
  while the schedules, which read the optimizer's update count, start
  again at 0.
- ``resolve_weight`` maps the catalog (``catalog://``) and URL names of
  MODEL.WEIGHT to files under $DISPRCNN_WEIGHTS (default ``weights``,
  relative to the working directory): there is no download.
- ``align_and_update_params`` is the fuzzy longest-dotted-suffix alignment
  of the reference (model_serialization.py:10-59), here over
  ``state_dict()`` keys, buffers included (FrozenBN constants, BN running
  statistics).
- ``load_stage_weights(model, weight)`` loads a previous stage's
  checkpoint directory (or one of its files) into a model by that
  alignment: stage 2's DispRCNN3D fills stage 3's ``idispnet.*`` and leaves
  ``pointrcnn.*`` at their init, reported as unmatched. It also takes the
  reference's released files (utils/torch_import.py): a ``.pth``/``.tar``
  of one of the four layouts (the full 3D stage, ``pointrcnn.pth``,
  iDispNet's bestmodel, the 2D detector) or a Detectron ``.pkl``; their
  BN counters (``num_batches_tracked``) keep the model's values and are
  not reported.
"""
from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from . import torch_import

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: nn.Module, optimizer=None) -> str:
        state = {"model": model.state_dict(),
                 "optimizer": None if optimizer is None else optimizer.state_dict(),
                 "step": int(step)}
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        with open(os.path.join(self.directory, "last_checkpoint"), "w") as f:
            f.write(str(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def read(self, step: Optional[int] = None) -> Optional[dict]:
        """The saved state of `step` (default the newest) on the CPU, or None."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def load(self, model: nn.Module, optimizer=None, step: Optional[int] = None,
             load_optimizer: bool = True) -> int:
        """Restore `step` (default the newest) into `model` (strict) and, with
        load_optimizer, into `optimizer`. -> the saved step, 0 when there is
        no checkpoint."""
        state = self.read(step)
        if state is None:
            return 0
        model.load_state_dict(state["model"])
        if load_optimizer and optimizer is not None:
            if state["optimizer"] is None:
                raise ValueError(f"{self.path(state['step'])} holds no optimizer state")
            optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])


_CATALOG = {
    # names the reference resolves through ModelCatalog (utils/checkpoint.py:
    # 110-148 + model_zoo); there is no download, so they map to local files
    "ImageNetPretrained/MSRA/R-50": "R-50.pkl",
    "ImageNetPretrained/MSRA/R-101": "R-101.pkl",
    "ImageNetPretrained/MSRA/R-152": "R-152.pkl",
}


def resolve_weight(weight: str) -> str:
    """`catalog://` / URL resolution (reference DetectronCheckpointer
    _load_file): catalog names and URLs map to files under
    $DISPRCNN_WEIGHTS (default ``weights``); a missing file raises."""
    root = os.environ.get("DISPRCNN_WEIGHTS", "weights")
    if weight.startswith("catalog://"):
        name = weight[len("catalog://"):]
        path = os.path.join(root, _CATALOG.get(name, name.replace("/", "_") + ".pkl"))
    elif weight.startswith(("http://", "https://")):
        path = os.path.join(root, os.path.basename(weight))
    else:
        return weight
    if not os.path.exists(path):
        raise FileNotFoundError(f"{weight} resolves to the local file {path}, which does not "
                                "exist (there is no download: place the file there)")
    return path


def align_and_update_params(target: Dict[str, object],
                            source: Dict[str, object]) -> Tuple[Dict[str, object], List[str]]:
    """Fuzzy alignment by the longest matching dotted suffix (reference
    model_serialization.py:10-59): each target key takes the source entry
    whose key equals it, or is a dotted suffix of it, or has it as one,
    with the longest common length (the first such source key on ties), if
    the shapes agree. -> (the updated flat dict, the target keys left
    unmatched). The candidates are looked up by dotted suffix, not by
    scanning every source key for every target key."""
    out = dict(target)
    unmatched = []
    order = {sk: i for i, sk in enumerate(source)}
    longer: Dict[str, int] = {}  # dotted suffix -> the first source key that ends with it
    for sk, i in order.items():
        for pos in (j for j, ch in enumerate(sk) if ch == "."):
            longer.setdefault(sk[pos + 1:], i)
    keys = list(source)
    for tk in target:
        # (common length, -source order): the longest, the first on ties
        cands = [(len(tk), -i) for i in (order.get(tk), longer.get(tk)) if i is not None]
        cands += [(len(tk) - pos - 1, -order[tk[pos + 1:]]) for pos, ch in enumerate(tk)
                  if ch == "." and tk[pos + 1:] in order]
        best = keys[-max(cands)[1]] if cands else None
        if best is not None and tuple(source[best].shape) == tuple(target[tk].shape):
            out[tk] = source[best]
        else:
            unmatched.append(tk)
    return out, unmatched


def load_stage_weights(model: nn.Module, weight: str) -> List[str]:
    """Load weights, MODEL.WEIGHT or --ckpt: a Checkpointer directory (its
    newest step) or one of its files, or a released ``.pth``/``.tar``/
    ``.pkl`` (see the module doc), into `model` in place by
    align_and_update_params. -> the model's state_dict keys left at their
    values (logged, as the JAX package logs them)."""
    weight = resolve_weight(weight)
    if not os.path.exists(weight):
        raise FileNotFoundError(f"no checkpoint at {weight}")
    state = model.state_dict()
    target = state
    if weight.endswith((".pth", ".tar", ".pkl")):
        source = (torch_import.import_c2_backbone(weight) if weight.endswith(".pkl")
                  else torch_import.import_released(weight)[1])
        target = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    elif os.path.isdir(weight):
        saved = Checkpointer(weight).read()
        if saved is None:
            raise FileNotFoundError(f"no checkpoint under {weight}")
        source = saved["model"]
    else:
        source = torch.load(weight, map_location="cpu", weights_only=True)["model"]
    merged, unmatched = align_and_update_params(target, source)
    model.load_state_dict({**state, **merged})
    if unmatched:
        logging.getLogger("disprcnn_tpu_torch").info(
            f"load_stage_weights({weight}): {len(unmatched)} entries not found (kept init), "
            f"e.g. {unmatched[:5]}")
    return unmatched
