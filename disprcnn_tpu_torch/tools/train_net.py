"""Training entry point of the port (counterpart of tools/train_net.py;
reference tools/train_net.py:23-128).

    python -m disprcnn_tpu_torch.tools.train_net --config-file configs/kitti/car/vob/mask.yaml \\
        [--max-iter N] [--dataset NAME] [--static-hw 384,1248] [--device cuda] \\
        [--kernels-off sa] [--seed 0] [--dist-backend nccl] [KEY VALUE ...]
    torchrun --nproc_per_node N -m disprcnn_tpu_torch.tools.train_net ...

config file (+ KEY VALUE overrides; --max-iter sets SOLVER.MAX_ITER, so the
OneCycle schedules span the shortened run) -> the dataset(s) of --dataset
or DATASETS.TRAIN concatenated (data/catalog.py::resolve_many), the train
transforms (their draws from a numpy generator seeded by --seed) and a
loader of SOLVER.IMS_PER_BATCH pairs padded to --static-hw, shuffled
(INPUT.SHUFFLE) and grouped by aspect (DATALOADER.ASPECT_RATIO_GROUPING)
for MAX_ITER iterations -> the model of MODEL.META_ARCHITECTURE
(models/build.py) with random weights from --seed (utils/weights.py), then
MODEL.WEIGHT, a previous stage's checkpoint, loaded by
utils/checkpoint.py::load_stage_weights -> the optimizer of
SOLVER.OPTIMIZER with the SOLVER.FIX_* prefixes frozen and its schedules
(solver/) -> engine/trainer.py's step, with the converter's static
kwargs (train_psm / train_pc) -> the loop.

- Resume: when OUTPUT_DIR/ckpt holds a checkpoint, the model (and with
  SOLVER.LOAD_OPTIMIZER the optimizer) is restored from it and the loop
  starts at its step, and ends at MAX_ITER, as the reference's
  iteration-based sampler does. With LOAD_OPTIMIZER False (every shipped
  config) the optimizer is fresh, so its schedules start again at 0 while
  the iterations continue (utils/checkpoint.py).
- Every PRINT_INTERVAL iterations the metrics go to the log through a
  MetricLogger and, with the rate and the batch time, to
  OUTPUT_DIR/tb (utils/tb.py); a non-finite metric there raises
  FloatingPointError unless SOLVER.ALLOW_EXCEPTION (the step itself
  applies nothing on a non-finite loss or gradient, engine/trainer.py).
- A checkpoint every CHECKPOINT_PERIOD iterations and one at the end at
  max(MAX_ITER, last iteration + 1), in OUTPUT_DIR/ckpt.
- The model's draws (the lift's sampling priorities, the 3D heads'
  dropout, the 2D sampler's priorities and the box head's dropout) come
  from a torch.Generator on the device seeded by --seed.

- Under torchrun (WORLD_SIZE > 1) every rank joins the process group of
  --dist-backend (parallel/multihost.py; NCCL takes one card a rank,
  gloo lets several ranks share one) on cuda:LOCAL_RANK (or the --device
  given with an index), broadcasts rank 0's weights, and walks the
  one-process loader's stream, taking its share of every global batch
  of SOLVER.IMS_PER_BATCH pairs (IMS_PER_BATCH / world a rank; fewer
  pairs than ranks gives one a rank, as the JAX package's
  max(IMS_PER_BATCH, devices) does; a remainder raises). The step
  (engine/trainer.py) then equals one process's step at the global
  batch. The model's draws come from one generator seeded by --seed on
  every rank, which draws the global batch's and keeps the rank's rows
  (parallel/mesh.py::shard_batch), so the ranks draw what one process
  draws; the transforms' numpy generator is seeded by (--seed, rank).
  Rank 0 alone writes the checkpoints, TensorBoard and log.txt; every
  rank resumes from the same checkpoint, after a barrier. With
  WORLD_SIZE unset or 1 no process group is made and the run is the
  one-process run.

- SOLVER.UNCERT_LOSS_WEIGHT N > 0: N learned loss weights u, from -1,
  weigh the losses as sum(u) + sum(l_i exp(-u_i)) over the losses sorted
  by key, with their own optimizer (momentum SOLVER.MOMENTUM on the LR
  schedule, no weight decay; solver/build.py::UncertWeights); the
  checkpoints carry u and its optimizer, and each logged iteration writes
  u as the scalars uncert0 .. uncert{N-1} to TensorBoard (JAX
  tools/train_net.py:113-121, 158-160).
- A checkpoint also holds the generator of the model's draws, so that a
  resumed run draws as the uninterrupted run does.

It runs on the card unless --device says otherwise; with --device cuda and
no card it raises. The CPU runs every kernel's plain version.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import get_default_cfg
from ..data.catalog import resolve_many
from ..data.loader import StereoBatchLoader
from ..data.transforms import build_transforms
from ..engine.batching import check_cli_model, make_batch_converter
from ..engine.trainer import make_train_step
from ..models.build import build_detection_model
from ..parallel.mesh import replicate
from ..parallel.multihost import (init_distributed, is_main_process, process_count,
                                  process_index, synchronize)
from ..solver.build import (FIX_FLAG_PREFIXES, UncertWeights, frozen_path_prefixes,
                            make_optimizer)
from ..solver.schedules import make_momentum_schedule, make_schedule
from ..utils.checkpoint import Checkpointer, load_stage_weights
from ..utils.logging import MetricLogger, setup_logger
from ..utils.tb import SummaryWriter
from ..utils.weights import init_random_


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="disprcnn_tpu_torch training")
    p.add_argument("--config-file", required=True)
    p.add_argument("--max-iter", type=int, default=None, help="overrides SOLVER.MAX_ITER")
    p.add_argument("--dataset", default=None, help="overrides DATASETS.TRAIN")
    p.add_argument("--static-hw", default="384,1248")
    p.add_argument("--device", default="cuda")
    p.add_argument("--kernels-off", default="",
                   help="comma list of PointNet++ kernel families to route off (sa, pool, fp)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights, the transforms and the model's draws")
    p.add_argument("--dist-backend", default="nccl",
                   help="torch.distributed backend under torchrun (nccl, or gloo)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def rank_batch(ims_per_batch: int, world: int) -> int:
    """Pairs a rank takes of a global batch of ims_per_batch pairs."""
    if ims_per_batch <= world:
        return 1
    if ims_per_batch % world:
        raise ValueError(f"SOLVER.IMS_PER_BATCH {ims_per_batch} does not split over {world} "
                         "ranks")
    return ims_per_batch // world


def load_config(config_file: str, opts: Sequence[str] = (), max_iter: Optional[int] = None):
    cfg = get_default_cfg()
    cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    if max_iter is not None:
        cfg.SOLVER.MAX_ITER = max_iter
    cfg.freeze()
    return cfg


def build_optimizer(cfg, model):
    """The optimizer of SOLVER.OPTIMIZER over `model` with its schedules and
    the FIX_* prefixes frozen. -> (optimizer, schedule)."""
    s = cfg.SOLVER
    schedule = make_schedule(s.SCHEDULER, s.BASE_LR, s.MAX_ITER, tuple(s.STEPS), s.GAMMA,
                             s.WARMUP_FACTOR, s.WARMUP_ITERS, s.WARMUP_METHOD)
    frozen = frozen_path_prefixes(**{flag: bool(s[flag]) for flag in FIX_FLAG_PREFIXES})
    opt = make_optimizer(model, schedule, make_momentum_schedule(s.SCHEDULER, s.MAX_ITER),
                         frozen, momentum=s.MOMENTUM, weight_decay=s.WEIGHT_DECAY,
                         weight_decay_bias=s.WEIGHT_DECAY_BIAS,
                         bias_lr_factor=s.BIAS_LR_FACTOR, optimizer=s.OPTIMIZER)
    return opt, schedule


def train(cfg, dataset: Optional[str] = None, static_hw=(384, 1248), device: str = "cuda",
          kernels_off: Sequence[str] = (), seed: int = 0, model=None, logger=None,
          dist_backend: str = "nccl") -> dict:
    """The tool's run on a frozen config, in-process. `model` replaces the
    built and randomly drawn one (the tests load the JAX package's weights
    into it; MODEL.WEIGHT still applies). -> {"cfg", "model", "optimizer",
    "step" (the TrainStep), "start_iter", "iters" (run here), "metrics" (a
    list of (iteration, {name: float}) at the log cadence), "ckpt_dir",
    "unmatched" (MODEL.WEIGHT's keys left at their init, or None), "uncert"
    (the learned loss weights, or None), "stats"
    (seconds: data_s in the loader, to_device_s, step_s, loop_s; and
    s_per_iter, data_share), "world", "rank", "ims_per_rank"}."""
    s = cfg.SOLVER
    check_cli_model(cfg)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")
    device = init_distributed(dist_backend, device)
    world, rank, main = process_count(), process_index(), is_main_process()
    ims = rank_batch(s.IMS_PER_BATCH, world)
    logger = logger or setup_logger("disprcnn_tpu_torch.train", cfg.OUTPUT_DIR, rank=rank)
    meta = cfg.MODEL.META_ARCHITECTURE
    if model is None:
        model = build_detection_model(cfg, device=device, kernels_off=kernels_off, train=True,
                                      logger=logger)
        init_random_(model, torch.Generator(device=device).manual_seed(seed))
    unmatched = None
    if cfg.MODEL.WEIGHT:
        unmatched = load_stage_weights(model, cfg.MODEL.WEIGHT)
        logger.info(f"initialized from {cfg.MODEL.WEIGHT} ({len(unmatched)} entries kept "
                    "their init)")
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model: {meta}, {n_params / 1e6:.1f}M parameters on {device}")
    opt, schedule = build_optimizer(cfg, model)
    # the learned uncertainty loss weights, an optimizer of their own
    uncert = (UncertWeights(s.UNCERT_LOSS_WEIGHT, schedule, s.MOMENTUM, device)
              if s.UNCERT_LOSS_WEIGHT else None)
    convert, static_kwargs = make_batch_converter(cfg, device)
    step = make_train_step(model, opt, s.DO_GRAD_CLIP, s.GRAD_CLIP, forward_kwargs=static_kwargs,
                           uncert=uncert)
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, "ckpt")
    ckpt = Checkpointer(ckpt_dir)
    generator = torch.Generator(device=device).manual_seed(seed)
    synchronize()
    start_iter = ckpt.load(model, opt, load_optimizer=s.LOAD_OPTIMIZER, uncert=uncert,
                           generator=generator)
    replicate(model)
    if start_iter:
        if s.LOAD_OPTIMIZER:
            step.count = start_iter
        logger.info(f"resumed from {ckpt.path(start_iter)} at iteration {start_iter}")

    names = [dataset] if dataset else (list(cfg.DATASETS.TRAIN) or ["synthetic_64"])
    transforms = build_transforms(
        cfg, True, np.random.default_rng(seed if world == 1 else (seed, rank)))
    ds = resolve_many(names, cfg, training=True, transforms=transforms)
    loader = StereoBatchLoader(ds, ims, tuple(static_hw), shuffle=cfg.INPUT.SHUFFLE,
                               size_divisibility=max(cfg.DATALOADER.SIZE_DIVISIBILITY, 32),
                               max_iter=s.MAX_ITER, start_iter=start_iter,
                               num_shards=world, shard_id=rank,
                               group_by_aspect=cfg.DATALOADER.ASPECT_RATIO_GROUPING)
    if world > 1:
        logger.info(f"rank {rank} of {world} on {device}: {ims} of every {ims * world} pairs")
    meters = MetricLogger()
    tb = SummaryWriter(os.path.join(cfg.OUTPUT_DIR, "tb")) if main else None
    stats = {"data_s": 0.0, "to_device_s": 0.0, "step_s": 0.0}
    logged = []
    it = start_iter - 1
    t0 = t_last = time.perf_counter()
    try:
        batches = iter(loader) if start_iter < s.MAX_ITER else iter(())
        while True:
            t_a = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            it += 1
            t_b = time.perf_counter()
            kw = dict(convert(batch, train=True), generator=generator)
            t_c = time.perf_counter()
            metrics = step(kw)
            stats["data_s"] += t_b - t_a
            stats["to_device_s"] += t_c - t_b
            stats["step_s"] += time.perf_counter() - t_c
            if it % s.PRINT_INTERVAL == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                scalars = dict(metrics, lr=float(schedule(it)),
                               batch_time=(now - t_last) / max(s.PRINT_INTERVAL, 1))
                if uncert is not None:
                    scalars.update({f"uncert{i}": float(v)
                                    for i, v in enumerate(uncert.u.detach())})
                t_last = now
                if tb:
                    tb.add_scalars(scalars, it)
                bad = [k for k, v in metrics.items() if not np.isfinite(v)]
                if bad:
                    msg = f"non-finite metrics at iteration {it}: {bad}"
                    if not s.ALLOW_EXCEPTION:
                        raise FloatingPointError(msg)
                    logger.warning(msg + " (SOLVER.ALLOW_EXCEPTION: continuing)")
                meters.update(**metrics)
                logged.append((it, metrics))
                eta = (now - t0) / max(it - start_iter + 1, 1) * (s.MAX_ITER - it)
                logger.info(f"iter {it}/{s.MAX_ITER} {meters} "
                            f"eta {datetime.timedelta(seconds=int(eta))}")
            if it > start_iter and it % s.CHECKPOINT_PERIOD == 0 and main:
                ckpt.save(it, model, opt, uncert, generator)
        final = max(s.MAX_ITER, it + 1)
        if main:
            ckpt.save(final, model, opt, uncert, generator)
        synchronize()
    finally:
        if tb:
            tb.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    iters = it + 1 - start_iter
    stats["loop_s"] = time.perf_counter() - t0
    stats["s_per_iter"] = stats["loop_s"] / max(iters, 1)
    stats["data_share"] = stats["data_s"] / max(stats["loop_s"], 1e-12)
    logger.info(f"training done: {iters} iterations in {stats['loop_s']:.3f} s "
                f"({stats['s_per_iter']:.3f} s/iteration, data layer "
                f"{100 * stats['data_share']:.1f}%); checkpoint {ckpt.path(final)}")
    return {"cfg": cfg, "model": model, "optimizer": opt, "step": step,
            "start_iter": start_iter, "iters": iters, "metrics": logged, "ckpt_dir": ckpt_dir,
            "final_step": final, "unmatched": unmatched, "uncert": uncert, "stats": stats,
            "world": world,
            "rank": rank, "ims_per_rank": ims}


def run(argv: Optional[Sequence[str]] = None, model=None) -> dict:
    """The command line `argv` in-process (see train)."""
    args = parse_args(argv)
    cfg = load_config(args.config_file, args.opts, args.max_iter)
    return train(cfg, dataset=args.dataset,
                 static_hw=tuple(int(v) for v in args.static_hw.split(",")),
                 device=args.device, kernels_off=[t for t in args.kernels_off.split(",") if t],
                 seed=args.seed, model=model, dist_backend=args.dist_backend)


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
