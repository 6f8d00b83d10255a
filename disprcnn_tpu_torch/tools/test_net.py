"""Inference / eval entry point of the port (counterpart of tools/test_net.py;
reference tools/test_net.py:19-103).

    python -m disprcnn_tpu_torch.tools.test_net --config-file configs/kitti/car/vob/rcnn.yaml \\
        [--dataset synthetic3d_8] [--static-hw 384,1248] [--evaluate --gt-dir DIR] \\
        [--device cuda] [--kernels-off sa] [--seed 0] [--no_force_recompute] \\
        [--ckpt DIR_OR_FILE] [--deterministic] [--dist-backend nccl] [KEY VALUE ...]
    torchrun --nproc_per_node N -m disprcnn_tpu_torch.tools.test_net ...

config file (+ KEY VALUE overrides) -> the dataset(s) of --dataset or
DATASETS.TEST (data/catalog.py), the eval transforms and a loader padded
to --static-hw -> the model of MODEL.META_ARCHITECTURE (models/build.py)
-> ``engine.inference.inference`` -> OUTPUT_DIR/inference/<dataset>/
predictions.pkl and txt/<imgid>.txt in KITTI's format -> with --evaluate,
the AP evaluator against the label files in --gt-dir.

- DispRCNN (mask.yaml): the 2D stereo detections and masks.
- DispRCNN3D (idispnet.yaml, rpn.yaml, rcnn.yaml): the 3D model over the
  batch's offline 2D predictions (the pred_* keys); the predictions keep
  those boxes, scores, labels and masks, valid becomes pred_valid & roi_ok,
  and with the RCNN they gain box3d, score3d and random3d.
The predictions are dicts of numpy arrays with the JAX package's keys and
dtypes, so either package reads the other's predictions.pkl.

The weights are --ckpt: a train run's checkpoint (a Checkpointer
directory such as tools/train_net.py's OUTPUT_DIR/ckpt, or one of its
files) or one of the reference's released files (a .pth/.tar of its four
layouts, a Detectron .pkl), else OUTPUT_DIR/ckpt when it holds a
last_checkpoint, as the JAX tool does, loaded by
utils/checkpoint.py::load_stage_weights; without
one they are random, drawn by utils/weights.py::init_random_ from --seed
(the lift's sampling priorities come from a generator seeded alike either
way). --deterministic turns TF32 off and has cuDNN pick deterministic
algorithms, so that two runs on one card give equal predictions. The JAX
tool's --roi-buckets dispatches
per-image ROI counts to separately compiled programs, a compile-count
option of XLA, and is not ported. It runs on the card unless --device
says otherwise; the CPU runs every kernel's plain version.

Under torchrun (WORLD_SIZE > 1) every rank joins the process group of
--dist-backend (parallel/multihost.py) on cuda:LOCAL_RANK (or the
--device given with an index) and evaluates its shard of each dataset
(the loader's interleaved shards, the last ones padded with repeats);
the predictions are merged on every rank
(engine/inference.py::merge_predictions_across_hosts), and rank 0 alone
writes predictions.pkl, the txt and the AP while the others wait at a
barrier. Each rank's generator replays the lift's draws of every rank's
batch and keeps its own, so at TEST.IMS_PER_BATCH 1 the merged
predictions are the one-process run's.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import get_default_cfg
from ..data.catalog import resolve
from ..data.loader import StereoBatchLoader
from ..data.transforms import build_transforms
from ..engine.batching import check_cli_model, make_batch_converter
from ..engine.inference import inference
from ..evaluation.kitti_eval import evaluate_kitti, write_kitti_txt
from ..models.build import build_detection_model
from ..parallel.multihost import (init_distributed, is_main_process, process_count,
                                  process_index, synchronize)
from ..utils.checkpoint import load_stage_weights
from ..utils.logging import setup_logger
from ..utils.weights import init_random_

# the JAX package's prediction dtypes (tools/test_net.py:135-192)
PRED_DTYPES = {"left_boxes": np.float32, "right_boxes": np.float32, "scores": np.float32,
               "valid": np.bool_, "labels": np.int32, "masks": np.float32,
               "box3d": np.float32, "score3d": np.float32, "random3d": np.bool_}


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="disprcnn_tpu_torch inference")
    p.add_argument("--config-file", required=True)
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory or file (default OUTPUT_DIR/ckpt when it holds "
                        "a last_checkpoint)")
    p.add_argument("--no_force_recompute", action="store_true")
    p.add_argument("--dataset", default=None)
    p.add_argument("--static-hw", default="384,1248")
    p.add_argument("--evaluate", action="store_true",
                   help="run the KITTI AP evaluator on the written txt")
    p.add_argument("--gt-dir", default=None, help="label dir for --evaluate")
    p.add_argument("--device", default="cuda")
    p.add_argument("--kernels-off", default="",
                   help="comma list of PointNet++ kernel families to route off (sa, pool, fp)")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--deterministic", action="store_true",
                   help="no TF32 and deterministic cuDNN algorithms: equal predictions "
                        "run to run")
    p.add_argument("--dist-backend", default="nccl",
                   help="torch.distributed backend under torchrun (nccl, or gloo)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def make_loader(cfg, name: str, static_hw, transforms=None) -> StereoBatchLoader:
    """The eval loader of dataset `name`: TEST.IMS_PER_BATCH samples a
    batch in order, padded to static_hw (rounded up to
    DATALOADER.SIZE_DIVISIBILITY, at least 32), the last batch filled up
    with its first sample; with several ranks this rank's shard."""
    if transforms is None:
        transforms = build_transforms(cfg, is_train=False)
    ds = resolve(name, cfg, training=False, transforms=transforms)
    return StereoBatchLoader(ds, max(cfg.TEST.IMS_PER_BATCH, 1), tuple(static_hw),
                             shuffle=False,
                             size_divisibility=max(cfg.DATALOADER.SIZE_DIVISIBILITY, 32),
                             num_shards=process_count(), shard_id=process_index(),
                             pad_last=True)


class Predictor:
    """predict(batch) -> the JAX package's prediction dict of numpy arrays
    for a loader batch. Accumulates seconds in `times`: the batch's copy to
    the device ("to_device_s"), the model ("model_s": CUDA events on the
    card) and the copy back with the dicts ("to_host_s"). `priorities`,
    when given, is a function batch -> the lift's sampling priorities of
    a DispRCNN3D (else they come from `generator`)."""

    def __init__(self, cfg, model, device, generator: Optional[torch.Generator] = None,
                 priorities=None):
        self.meta = cfg.MODEL.META_ARCHITECTURE
        self.model = model
        self.device = torch.device(device)
        self.convert, _ = make_batch_converter(cfg, self.device)
        self.generator = generator
        self.priorities = priorities
        self.times = {"to_device_s": 0.0, "model_s": 0.0, "to_host_s": 0.0}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        kw = self.convert(batch)
        if self.meta == "DispRCNN3D":
            if self.priorities is not None:
                kw["priorities"] = torch.as_tensor(self.priorities(batch), dtype=torch.float32,
                                                   device=self.device)
            elif process_count() > 1 and self.model.det3d_on:
                # every rank's batch of this step drawn in rank order, as one
                # process draws them batch after batch; this rank keeps its own
                b, d = batch["pred_valid"].shape
                shape = (b * d, self.model.lift_grid ** 2)
                kw["priorities"] = [torch.rand(shape, generator=self.generator,
                                               device=self.device)
                                    for _ in range(process_count())][process_index()]
            else:
                kw["generator"] = self.generator
        self._sync()
        t1 = time.perf_counter()
        events = None
        if self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        with torch.inference_mode():
            out = self.model(**kw)
        if events:
            events[1].record()
        self._sync()
        t2 = time.perf_counter()
        pred = self._predictions(batch, out)
        t3 = time.perf_counter()
        self.times["to_device_s"] += t1 - t0
        self.times["model_s"] += (events[0].elapsed_time(events[1]) / 1e3 if events
                                  else t2 - t1)
        self.times["to_host_s"] += t3 - t2
        return pred

    def _predictions(self, batch, out) -> Dict[str, np.ndarray]:
        # a bf16 output (score3d of a bf16 model) widened exactly: the file
        # holds float32, as the JAX tool writes it
        host = lambda t: (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu().numpy()
        if self.meta == "DispRCNN3D":
            valid = np.asarray(batch["pred_valid"])
            if "roi_ok" in out:
                valid = valid & host(out["roi_ok"])
            pred = {"left_boxes": batch["pred_left"], "right_boxes": batch["pred_right"],
                    "scores": batch["pred_score"], "labels": batch["pred_labels"],
                    "masks": batch["pred_mask"],  # the stage handoff keeps the masks
                    "valid": valid}
            if "box3d" in out:
                pred.update(box3d=host(out["box3d"]), score3d=host(out["score3d"]),
                            random3d=host(out["random"]))
        else:
            dets = out["detections"]
            pred = {"left_boxes": host(dets.left), "right_boxes": host(dets.right),
                    "scores": host(dets.score), "valid": host(dets.valid),
                    "labels": host(dets.fields["labels"])}
            if "masks" in out:  # MODEL.MASK_ON False writes none, as the JAX tool
                pred["masks"] = host(out["masks"])
        return {k: np.asarray(v, PRED_DTYPES[k]) for k, v in pred.items()}


def run(config_file: str, opts: Sequence[str] = (), dataset: Optional[str] = None,
        static_hw=(384, 1248), evaluate: bool = False, gt_dir: Optional[str] = None,
        device: str = "cuda", kernels_off: Sequence[str] = (), seed: int = 0,
        force_recompute: bool = True, ckpt: Optional[str] = None, model=None,
        priorities=None, logger=None, dist_backend: str = "nccl",
        deterministic: bool = False) -> dict:
    """The tool's run, in-process. `model` replaces the built one (the
    tests load the JAX package's weights into it); `priorities` as
    Predictor's; the checkpoint (`ckpt`, else OUTPUT_DIR/ckpt when it
    holds a last_checkpoint) loads into either. -> {"cfg", "model",
    "ckpt", "datasets": {name: {"predictions", "out_dir", "txt_dir", "ap"
    (with evaluate), "images", "stats"}}}, where "stats" holds the loop's
    seconds: data_s, to_device_s, model_s, to_host_s, txt_s, ap_s, loop_s
    (the whole loop, txt and AP included). Under torchrun a rank other
    than 0 has no "txt_dir" or "ap"."""
    cfg = get_default_cfg()
    cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    cfg.freeze()
    check_cli_model(cfg)
    if deterministic:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    device = init_distributed(dist_backend, device)
    main = is_main_process()
    logger = logger or setup_logger("disprcnn_tpu_torch.test", cfg.OUTPUT_DIR,
                                    rank=process_index())
    meta = cfg.MODEL.META_ARCHITECTURE
    if kernels_off and meta != "DispRCNN3D":
        raise ValueError(f"--kernels-off routes PointNet++ kernels; {meta} runs none")
    if model is None:
        model = build_detection_model(cfg, device=device, kernels_off=kernels_off,
                                      logger=logger)
        init_random_(model, torch.Generator(device=device).manual_seed(seed))
    default_ckpt = os.path.join(cfg.OUTPUT_DIR, "ckpt")
    if not ckpt and os.path.exists(os.path.join(default_ckpt, "last_checkpoint")):
        ckpt = default_ckpt
    if ckpt:
        unmatched = load_stage_weights(model, ckpt)
        logger.info(f"weights from {ckpt} ({len(unmatched)} entries not in it)")
    model.eval()
    names = [dataset] if dataset else (list(cfg.DATASETS.TEST) or ["synthetic_16"])
    transforms = build_transforms(cfg, is_train=False)
    out = {"cfg": cfg, "model": model, "ckpt": ckpt, "datasets": {}}
    for name in names:
        t_start = time.perf_counter()
        loader = make_loader(cfg, name, static_hw, transforms)
        predictor = Predictor(cfg, model, device,
                              torch.Generator(device=device).manual_seed(seed), priorities)
        stats: Dict[str, float] = {}
        out_dir = os.path.join(cfg.OUTPUT_DIR, "inference", name)
        preds = inference(predictor, loader, name, out_dir, force_recompute=force_recompute,
                          logger=logger, stats=stats)
        stats.update(predictor.times)
        res = {"predictions": preds, "out_dir": out_dir, "images": len(preds), "stats": stats}
        stats["txt_s"] = stats["ap_s"] = 0.0
        if main:
            t0 = time.perf_counter()
            res["txt_dir"] = write_kitti_txt(preds, out_dir)
            stats["txt_s"] = time.perf_counter() - t0
            logger.info(f"wrote KITTI txt to {res['txt_dir']}")
            t0 = time.perf_counter()
            if evaluate and gt_dir:
                res["ap"] = evaluate_kitti(gt_dir, res["txt_dir"], out_dir)
                for thr, ap in res["ap"].items():
                    logger.info(f"AP@{thr}: {ap}")
            stats["ap_s"] = time.perf_counter() - t0
        synchronize()
        stats["loop_s"] = time.perf_counter() - t_start
        logger.info(f"{name}: {len(preds)} images in {stats['loop_s']:.3f} s "
                    f"({len(preds) / stats['loop_s']:.3f} images/s); " + ", ".join(
                        f"{k} {stats[k]:.3f}" for k in ("data_s", "to_device_s", "model_s",
                                                        "to_host_s", "txt_s", "ap_s")))
        out["datasets"][name] = res
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    run(args.config_file, args.opts, dataset=args.dataset,
        static_hw=tuple(int(v) for v in args.static_hw.split(",")),
        evaluate=args.evaluate, gt_dir=args.gt_dir, device=args.device,
        kernels_off=[t for t in args.kernels_off.split(",") if t], seed=args.seed,
        force_recompute=not args.no_force_recompute, ckpt=args.ckpt,
        dist_backend=args.dist_backend, deterministic=args.deterministic)


if __name__ == "__main__":
    main()
