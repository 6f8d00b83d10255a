"""Split a predictions.pkl into one pickle an image, keyed by image id
(counterpart of tools/split_predictions.py; reference
tools/split_predictions.py:9-36): the stage handoff that
SOLVER.OFFLINE_2D_PREDICTIONS reads (data/datasets/kitti.py).

    python -m disprcnn_tpu_torch.tools.split_predictions --predictions P.pkl --out DIR

writes DIR/<imgid>.pkl, each the image's prediction dict.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional, Sequence


def split(predictions: dict, out_dir: str) -> int:
    """Write each image's prediction dict to out_dir/<imgid>.pkl. -> the
    number of files."""
    os.makedirs(out_dir, exist_ok=True)
    for imgid, pred in predictions.items():
        with open(os.path.join(out_dir, f"{imgid}.pkl"), "wb") as f:
            pickle.dump(pred, f)
    return len(predictions)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="split predictions.pkl into one pickle an image")
    p.add_argument("--predictions", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    with open(args.predictions, "rb") as f:
        predictions = pickle.load(f)
    print(f"split {split(predictions, args.out)} predictions into {args.out}")


if __name__ == "__main__":
    main()
