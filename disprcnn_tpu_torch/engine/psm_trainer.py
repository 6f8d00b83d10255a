"""Epoch-based iDispNet trainer (counterpart of
disprcnn_tpu/engine/psm_trainer.py; reference engine/psm_trainer.py:89-424
and tools/kitti_object/train_idispnet_fa.py, whose fastai Learner and
fit_one_cycle become a plain trainer class).

``PSMTrainer(...).fit(train_ds, val_ds, collate)`` trains a PSMNet on ROI
crops (data/datasets/kitti_roi.py: NHWC crops, their disparity and mask):
- Adam (solver/build.py, optax.adam's arithmetic) over
  ``one_cycle(lr, epochs * steps_per_epoch)``;
- the loss: the deep-supervised masked smooth-L1 with weights 0.5/0.7/1.0
  (ops/losses.py::psm_deep_supervision_loss) under the mask
  ``mask * (disp > mindisp) * (disp < maxdisp)``;
- train-mode BN as Flax computes it (psmnet.batch_norm_train);
- each epoch's order ``np.random.default_rng(epoch).permutation``, its
  steps ``len(train_ds) // batch_size`` (at least 1) full batches;
- validation and ``get_preds`` over the full batches in order (the last
  partial batch dropped), EPE by ops/losses.py::masked_epe;
- the best model by EPE saved through utils/checkpoint.py at its epoch.

No randomness beyond the weights, drawn by utils/weights.py::init_random_
from `seed` unless the caller passes a model. On the card the train step
runs row 8 (the trunk's stride-1 convs, ops/cuda/conv3d.py::conv3d_train),
validation and get_preds rows 2-7 and 15 (psmnet.py's eval forward); on
the CPU every kernel's plain version runs.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..models.psmnet.psmnet import PSMNet
from ..ops.losses import masked_epe, psm_deep_supervision_loss
from ..solver.build import make_optimizer
from ..solver.schedules import one_cycle
from ..utils.checkpoint import Checkpointer
from ..utils.logging import setup_logger
from ..utils.weights import init_random_


class PSMTrainer:
    def __init__(self, maxdisp: int = 48, mindisp: int = -48, roi_size: int = 224,
                 lr: float = 1e-3, epochs: int = 100, batch_size: int = 12,
                 output_dir: str = "models/idispnet", device: str = "cuda", seed: int = 0,
                 model: Optional[PSMNet] = None):
        self.maxdisp, self.mindisp = maxdisp, mindisp
        self.roi_size = roi_size
        self.epochs, self.bs = epochs, batch_size
        self.lr = lr
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PSMTrainer on cuda: no CUDA device (give device 'cpu')")
        self.logger = setup_logger("disprcnn_tpu_torch.psm_trainer", output_dir)
        self.ckpt = Checkpointer(f"{output_dir}/ckpt")
        if model is None:
            # float32, as the JAX tool builds its PSMNet (tools/train_idispnet.py
            # passes no dtype); train_net trains at TPU.COMPUTE_DTYPE
            self.logger.info("iDispNet trains in float32, as the JAX package's "
                             "tools/train_idispnet.py does")
            model = PSMNet(maxdisp=maxdisp, mindisp=mindisp).to(self.device)
            init_random_(model, torch.Generator(device=self.device).manual_seed(seed))
        self.model = model
        self.optimizer = None
        self.history = []  # (epoch, mean train loss, validation EPE)
        self.times = {"data_s": 0.0, "train_s": 0.0, "val_s": 0.0, "steps": 0}

    def _batch(self, samples) -> dict:
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in samples.items()}
        for k in ("left", "right"):  # NHWC crops -> NCHW
            out[k] = out[k].permute(0, 3, 1, 2).contiguous()
        return out

    def fit(self, train_ds, val_ds, collate: Callable) -> float:
        steps = max(len(train_ds) // self.bs, 1)
        self.optimizer = make_optimizer(self.model, one_cycle(self.lr, self.epochs * steps),
                                        optimizer="Adam", weight_decay=0.0,
                                        weight_decay_bias=0.0, bias_lr_factor=1.0)
        best = float("inf")
        for epoch in range(self.epochs):
            t0 = time.perf_counter()
            loss = self.train_epoch(train_ds, collate, epoch, steps)
            epe = self.validate(val_ds, collate)
            self.history.append((epoch, loss, epe))
            self.logger.info(f"epoch {epoch}: loss {loss:.4f} EPE {epe:.4f} "
                             f"({time.perf_counter() - t0:.1f}s)")
            if epe < best:
                best = epe
                self.ckpt.save(epoch, self.model)
        return best

    def train_step(self, batch: dict) -> torch.Tensor:
        """One Adam step on a batch of crops; -> the loss (on the device)."""
        model = self.model
        model.train()
        for p in self.optimizer.params:
            p.grad = None
        preds = model(batch["left"], batch["right"])
        disp = batch["disparity"]
        m = batch["mask"] * (disp > self.mindisp) * (disp < self.maxdisp)
        loss = psm_deep_supervision_loss(preds, disp, m)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_epoch(self, ds, collate, epoch: int, steps: int) -> float:
        order = np.random.default_rng(epoch).permutation(len(ds))
        losses = []
        for i in range(steps):
            t0 = time.perf_counter()
            idxs = order[i * self.bs:(i + 1) * self.bs]
            batch = self._batch(collate([ds[int(j)] for j in idxs]))
            t1 = time.perf_counter()
            losses.append(float(self.train_step(batch)))
            self.times["data_s"] += t1 - t0
            self.times["train_s"] += time.perf_counter() - t1
            self.times["steps"] += 1
        return float(np.mean(losses))

    def _full_batches(self, ds, collate):
        for i in range(0, len(ds) - self.bs + 1, self.bs):
            yield self._batch(collate([ds[j] for j in range(i, i + self.bs)]))

    @torch.inference_mode()
    def _predict(self, batch: dict) -> torch.Tensor:
        self.model.eval()
        return self.model(batch["left"], batch["right"])

    def validate(self, ds, collate) -> float:
        t0 = time.perf_counter()
        epes = [float(masked_epe(self._predict(b), b["disparity"], b["mask"]))
                for b in self._full_batches(ds, collate)]
        self.times["val_s"] += time.perf_counter() - t0
        return float(np.mean(epes)) if epes else float("nan")

    def get_preds(self, ds, collate) -> np.ndarray:
        preds = [self._predict(b).cpu().numpy() for b in self._full_batches(ds, collate)]
        return np.concatenate(preds) if preds else np.zeros((0,))
