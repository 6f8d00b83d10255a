"""Inference entry points of the port (counterpart of
disprcnn_tpu/engine/inference.py, which drives the jitted eval forward).

``predict_2d`` answers one request of stereo pairs with the 2D detector;
``predict`` runs it and then the 3D stage over its detections: iDispNet
over the ROI crops and, when the 3D model has det3d_on, the pseudo-LiDAR
lift and PointRCNN.

``compute_on_dataset`` and ``inference`` are the eval loop over a loader
(disprcnn_tpu/engine/inference.py:20-38, 96-137): per-image prediction
dicts of numpy arrays, cached in ``predictions.pkl`` (the reference's
predictions.pth and --no_force_recompute workflow), then the evaluator.
With several ranks (parallel/multihost.py) each rank evaluates its shard
of the dataset, ``merge_predictions_across_hosts`` gives every rank the
whole dict (JAX :42-93), and rank 0 alone writes the cache.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.detector.disprcnn import DispRCNN
from ..models.detector.disprcnn3d import DispRCNN3D
from ..parallel.multihost import (all_gather_predictions, is_main_process, process_count,
                                  synchronize)
from ..structures.stereo import StereoBoxes
from ..utils.logging import Timer, setup_logger


def predict_2d(model: DispRCNN, left, right) -> Dict[str, object]:
    """Eval forward of the 2D stereo detector on the model's device.

    left, right: (B, H, W, 3) normalized images, tensors or numpy arrays.
    Returns the JAX eval forward's dict: "detections" (StereoBoxes of
    (B, max_det) rows with "labels") and "masks" (B, max_det, 28, 28).
    """
    left, right = (torch.as_tensor(x, dtype=torch.float32, device=model.device)
                   for x in (left, right))
    with torch.inference_mode():
        return model(left, right)


def predict(model2d: DispRCNN, model3d: DispRCNN3D, left, right, left_raw, right_raw,
            calib: Optional[Dict[str, object]] = None,
            generator: Optional[torch.Generator] = None,
            priorities: Optional[torch.Tensor] = None) -> Dict[str, object]:
    """The 2D stereo detector, then the 3D stage over its detections (the
    pipeline of bench.py:_time_pipeline).

    left, right: (B, H, W, 3) normalized images for the 2D detector;
    left_raw, right_raw: the same pairs as raw [0, 1] RGB, which the 3D
    stage crops. Returns "detections" and "masks" as ``predict_2d`` does,
    and "disparity_roi" (B, max_det, roi, roi): one disparity map per
    detection slot, valid or not. With model3d.det3d_on it also returns
    "box3d" (B, max_det, 7) xyzhwl_ry boxes in the rect camera frame,
    "score3d" (B, max_det), "random" (B, max_det: no refined box passed the
    score threshold and the box is the best RPN proposal) and "roi_ok"
    (B, max_det: a valid detection with lifted points); it then needs
    `calib` ({fu, fv, cu, cv, tx, ty, fuxb}, each a number or (B,) values)
    and the lift's sampling priorities, as `priorities` (B * max_det,
    lift_grid^2) or drawn from `generator` (on model3d's device).
    """
    out = predict_2d(model2d, left, right)
    dets = out["detections"]
    dets3 = StereoBoxes(left=dets.left, right=dets.right, score=dets.score, valid=dets.valid,
                        fields={"mask": out["masks"]})
    dev = model3d.device
    left_raw, right_raw = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                           for x in (left_raw, right_raw))
    b, d = dets.valid.shape
    if calib is not None:
        calib = {k: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1).expand(b)
                 for k, v in calib.items()}
    if priorities is not None:
        priorities = torch.as_tensor(priorities, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        out3 = model3d(left_raw, right_raw, dets3, calib=calib, priorities=priorities,
                       generator=generator)
    disp = out3.pop("disparity_roi")
    return {**out, "disparity_roi": disp.reshape(b, d, *disp.shape[1:]), **out3}


def compute_on_dataset(predict_fn: Callable[[dict], dict], loader, logger=None,
                       stats: Optional[Dict[str, float]] = None) -> Dict[str, dict]:
    """predict_fn(batch) -> dict of numpy arrays with a leading batch axis.
    Returns imgid -> that image's prediction dict (the duplicate ids of a
    padded last batch collapse). `stats`, when given, gains the seconds
    spent waiting for the loader ("data_s": dataset, transforms and
    collate) and in predict_fn ("predict_s"), and the batch count."""
    results = {}
    timer = Timer()
    stats = {} if stats is None else stats
    for key in ("data_s", "predict_s", "batches"):
        stats.setdefault(key, 0)
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        stats["data_s"] += time.perf_counter() - t0
        if batch is None:
            break
        timer.tic()
        out = predict_fn(batch)
        dt = timer.toc()
        stats["predict_s"] += dt
        stats["batches"] += 1
        bs = len(batch["imgid"])
        for i, imgid in enumerate(batch["imgid"]):
            results[imgid] = {k: np.asarray(v[i]) for k, v in out.items()}
        if logger:
            logger.info(f"inference {len(results)} images, {dt / bs:.3f} s/img")
    return results


def merge_predictions_across_hosts(local: Dict[str, dict]) -> Dict[str, dict]:
    """Every rank's per-image predictions, merged into the full dict on
    every rank (the identity on one process), as fixed-shape array
    gathers (reference engine/inference.py:253-272 pickled them).

    Shards may differ in size: a first gather agrees on the largest row
    count and image-id width, every rank zero-pads its stacked arrays to
    them (a ``_valid`` row mask marks the padding, dropped after the
    gather), and the ids travel as zero-padded UTF-8 codes, so any string
    id comes back. An id that several rows carry (a loader's pad_last
    repeats samples to fill the shards) keeps the first row in rank
    order: the padding repeats the dataset's first samples on later ranks
    than theirs, so the image's own prediction is kept where the JAX
    package's dict update would keep the repeat's. A rank with no
    prediction raises.
    """
    if process_count() == 1:
        return local
    if not local:
        raise ValueError("merge_predictions_across_hosts: this rank holds 0 predictions "
                         "(every rank must evaluate >= 1 image; the loader pads shards)")
    ids = sorted(local)
    keys = sorted(local[ids[0]])
    n = len(ids)
    width = max(len(i.encode("utf-8")) for i in ids)
    dims = all_gather_predictions({"_dims": np.asarray([[n, width]], np.int64)})["_dims"]
    nmax, wmax = int(dims[:, 0].max()), int(dims[:, 1].max())

    def pad_rows(a: np.ndarray) -> np.ndarray:
        return np.concatenate([a, np.zeros((nmax - n,) + a.shape[1:], a.dtype)])

    stacked = {k: pad_rows(np.stack([np.asarray(local[i][k]) for i in ids])) for k in keys}
    codes = np.zeros((nmax, wmax), np.uint8)
    for r, i in enumerate(ids):
        b = i.encode("utf-8")
        codes[r, :len(b)] = np.frombuffer(b, np.uint8)
    stacked["_imgid"] = codes
    stacked["_valid"] = np.arange(nmax) < n
    merged = all_gather_predictions(stacked)
    out = {}
    for row in np.flatnonzero(merged["_valid"]):
        imgid = bytes(merged["_imgid"][row]).rstrip(b"\x00").decode("utf-8")
        if imgid not in out:
            out[imgid] = {k: merged[k][row] for k in keys}
    return out


def inference(predict_fn, loader, dataset_name: str, output_folder: Optional[str] = None,
              force_recompute: bool = True, evaluator=None, logger=None,
              stats: Optional[Dict[str, float]] = None):
    """The eval loop of one dataset: predictions from `predict_fn` over
    `loader` (or, with force_recompute False, from the folder's cached
    predictions.pkl), written to that cache, then `evaluator(predictions,
    output_folder)` when given (its result is returned), else the
    predictions. With several ranks `loader` holds this rank's shard; the
    ranks meet at a barrier, merge their predictions, and rank 0 writes
    the cache."""
    logger = logger or setup_logger("disprcnn_tpu_torch.inference", output_folder or "")
    cache = os.path.join(output_folder, "predictions.pkl") if output_folder else None
    if cache and os.path.exists(cache) and not force_recompute:
        with open(cache, "rb") as f:
            predictions = pickle.load(f)
        logger.info(f"loaded cached predictions for {dataset_name}")
    else:
        t0 = time.perf_counter()
        predictions = compute_on_dataset(predict_fn, loader, logger, stats)
        total = time.perf_counter() - t0
        logger.info(f"total inference time {total:.1f}s "
                    f"({total / max(len(predictions), 1):.3f} s/img per device)")
        synchronize()
        predictions = merge_predictions_across_hosts(predictions)
        if cache and is_main_process():
            os.makedirs(output_folder, exist_ok=True)
            with open(cache, "wb") as f:
                pickle.dump(predictions, f)
    if evaluator is not None:
        return evaluator(predictions, output_folder)
    return predictions
