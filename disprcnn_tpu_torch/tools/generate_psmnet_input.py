"""ROI records for the standalone iDispNet trainer (counterpart of
tools/generate_psmnet_input.py; reference
tools/kitti_object/generate_psmnet_input_inf.py:29-128).

    python -m disprcnn_tpu_torch.tools.generate_psmnet_input --predictions P.pkl \\
        --dataset kitti_train_vob_car --out DIR/train [--roi-size 224] [--min-score 0.05] \\
        [--device cuda]

For each image of --dataset (untransformed) with predictions: the
detections scoring above --min-score (and valid) have their left and right
boxes widened to one integer width (models/detector/disprcnn3d.py::
width_aligned_crop_boxes); both RAW images are cropped to roi_size^2 by
ROIAlign at one sample a bin (data/datasets/kitti_roi.py normalizes at
load time); the GT disparity is sampled over the left crop, shifted by x1 -
x1' and rescaled (warp_gt_disparity_to_roi); the detection's mask is
sampled on the crop's grid above 0.5 (_mask_on_crop). Each ROI is one
DIR/<imgid>_<i:03d>.npz with "left", "right" (roi, roi, 3), "disparity"
(roi, roi) and "mask" (roi, roi, float32). It runs on the card unless
--device says otherwise.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import get_default_cfg
from ..data.catalog import resolve
from ..models.detector.disprcnn3d import (_mask_on_crop, warp_gt_disparity_to_roi,
                                          width_aligned_crop_boxes)
from ..ops.roi_align import roi_align_batched


def generate(predictions: dict, dataset: str, out_dir: str, roi_size: int = 224,
             min_score: float = 0.05, device: str = "cuda") -> int:
    """Write the ROI records of `predictions` ({imgid: prediction dict})
    over the images of `dataset`. -> the number of records."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")
    ds = resolve(dataset, get_default_cfg(), training=False, transforms=None)
    os.makedirs(out_dir, exist_ok=True)
    s, count = roi_size, 0
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)  # noqa
    for idx in range(len(ds)):
        sample = ds[idx]
        imgid = sample["imgid"]
        if imgid not in predictions:
            continue
        pred = predictions[imgid]
        keep = (pred["scores"] > min_score) & pred.get("valid",
                                                        np.ones_like(pred["scores"], bool))
        if not keep.any():
            continue
        lb, rb = t(pred["left_boxes"][keep]), t(pred["right_boxes"][keep])
        lc, rc = width_aligned_crop_boxes(lb, rb)
        bi = torch.zeros(len(lc), dtype=torch.int64, device=device)
        crop = lambda img, boxes: roi_align_batched(  # noqa: E731
            t(img)[None].permute(0, 3, 1, 2), boxes, bi, s, 1.0,
            sampling_ratio=1).permute(0, 2, 3, 1)
        lcrops, rcrops = crop(sample["left"], lc), crop(sample["right"], rc)
        gt = t(sample["gt_disp"])
        disp = warp_gt_disparity_to_roi(gt[None].expand(len(lc), *gt.shape), lc, rc, s)
        masks = _mask_on_crop(t(pred["masks"][keep]), lb, lc, s, 0.5)
        host = lambda x: x.cpu().numpy()  # noqa: E731
        for i in range(len(lc)):
            np.savez_compressed(os.path.join(out_dir, f"{imgid}_{i:03d}.npz"),
                                left=host(lcrops[i]), right=host(rcrops[i]),
                                disparity=host(disp[i]), mask=host(masks[i]).astype(np.float32))
            count += 1
    return count


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="ROI records for tools/train_idispnet.py")
    p.add_argument("--predictions", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--roi-size", type=int, default=224)
    p.add_argument("--min-score", type=float, default=0.05)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with open(args.predictions, "rb") as f:
        predictions = pickle.load(f)
    n = generate(predictions, args.dataset, args.out, args.roi_size, args.min_score, args.device)
    print(f"wrote {n} ROI records to {args.out}")


if __name__ == "__main__":
    main()
