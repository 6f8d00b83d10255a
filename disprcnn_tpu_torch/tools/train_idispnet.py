"""Standalone iDispNet trainer of the port (counterpart of
tools/train_idispnet.py; reference tools/kitti_object/train_idispnet_fa.py:
21-90), built on engine/psm_trainer.py::PSMTrainer: Adam + OneCycle over
the epochs, the deep-supervised masked smooth-L1, EPE validation and the
best model checkpointed in OUTPUT/ckpt.

    python -m disprcnn_tpu_torch.tools.train_idispnet --data-dir DIR | --synthetic N \\
        [--epochs 100] [--bs 12] [--lr 1e-3] [--maxdisp 48] [--mindisp -48] \\
        [--roi-size 224] [--output models/idispnet] [--device cuda] [--seed 0]

--data-dir reads DIR/train/*.npz and DIR/val/*.npz (one ROI each,
data/datasets/kitti_roi.py); --synthetic N trains on N synthetic crops
and validates on N // 4 (at least 1) others. The weights are random,
drawn from --seed. It runs on the card unless --device says otherwise;
with --device cuda and no card it raises.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..data.datasets.kitti_roi import KittiRoiDataset, SyntheticRoiDataset, collate_roi
from ..engine.psm_trainer import PSMTrainer


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="disprcnn_tpu_torch iDispNet training")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--bs", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--maxdisp", type=int, default=48)
    p.add_argument("--mindisp", type=int, default=-48)
    p.add_argument("--roi-size", type=int, default=224)
    p.add_argument("--output", default="models/idispnet")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    return p.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """The command line `argv` in-process. -> {"trainer", "best_epe",
    "train_ds", "val_ds"}."""
    args = parse_args(argv)
    if args.synthetic:
        train_ds = SyntheticRoiDataset(args.synthetic, args.roi_size, args.maxdisp)
        val_ds = SyntheticRoiDataset(max(args.synthetic // 4, 1), args.roi_size, args.maxdisp,
                                     seed=1)
    elif args.data_dir:
        train_ds = KittiRoiDataset(args.data_dir, "train")
        val_ds = KittiRoiDataset(args.data_dir, "val")
    else:
        raise ValueError("give --data-dir or --synthetic N")
    trainer = PSMTrainer(args.maxdisp, args.mindisp, args.roi_size, args.lr, args.epochs,
                         args.bs, args.output, device=args.device, seed=args.seed)
    best = trainer.fit(train_ds, val_ds, collate_roi)
    trainer.logger.info(f"best EPE {best:.4f}")
    return {"trainer": trainer, "best_epe": best, "train_ds": train_ds, "val_ds": val_ds}


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
