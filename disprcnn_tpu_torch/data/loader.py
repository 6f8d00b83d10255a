"""Batch assembly: aspect grouping, iteration-based sampling, fixed-shape
padding to device batches (a copy of disprcnn_tpu/data/loader.py; the
batches stay numpy, and engine/batching.py puts them on the device).

Reference: data/build.py:16-170, samplers/grouped_batch_sampler.py,
iteration_based_batch_sampler.py, collate_batch.py DoubleViewBatchCollator.
TPU twist: every batch pads images to ONE static (H, W) per loader (the max
over the dataset after resize, rounded up to SIZE_DIVISIBILITY) so jit traces
once.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def aspect_ratio_groups(sizes: Sequence[tuple], group_portrait: bool = True):
    """Group ids: 0 = landscape, 1 = portrait (reference _quantize on aspect)."""
    return [0 if w >= h else 1 for h, w in sizes]


class StereoBatchLoader:
    """Iterates fixed-shape numpy batches over a sample-dict dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        static_hw: tuple[int, int],
        shuffle: bool = True,
        size_divisibility: int = 32,
        seed: int = 0,
        max_iter: Optional[int] = None,
        start_iter: int = 0,
        num_shards: int = 1,
        shard_id: int = 0,
        pad_last: bool = False,  # eval: wrap the final partial batch (the
        # duplicate imgids collapse in the per-image prediction dict)
        group_by_aspect: bool = False,  # DATALOADER.ASPECT_RATIO_GROUPING:
        # draw each batch from one aspect cluster (reference
        # grouped_batch_sampler.py:9-111; with one global static shape the
        # effect is batch homogeneity, not per-batch padding)
    ):
        self.ds = dataset
        self.bs = batch_size
        d = max(size_divisibility, 1)
        self.hw = (int(np.ceil(static_hw[0] / d) * d), int(np.ceil(static_hw[1] / d) * d))
        self.shuffle = shuffle
        self.seed = seed
        self.max_iter = max_iter
        self.start_iter = start_iter
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.pad_last = pad_last
        self.group_by_aspect = group_by_aspect
        self._groups = None
        if group_by_aspect and hasattr(dataset, "image_sizes"):
            self._groups = np.asarray(
                aspect_ratio_groups(dataset.image_sizes()), np.int32
            )

    def _index_stream(self) -> Iterator[int]:
        epoch = 0
        while True:
            idxs = np.arange(len(self.ds))
            if self.shuffle:
                idxs = np.random.default_rng(self.seed + epoch).permutation(idxs)
            if self._groups is not None:
                # stable partition by aspect group: batches then form within
                # clusters (GroupedBatchSampler semantics, shuffled order
                # inside each cluster preserved)
                idxs = np.concatenate(
                    [idxs[self._groups[idxs] == g] for g in (0, 1)]
                )
            # shard for distributed hosts, padded to even shards
            # (reference samplers/distributed.py:10-66)
            per = int(np.ceil(len(idxs) / self.num_shards))
            padded = np.concatenate([idxs, idxs[: per * self.num_shards - len(idxs)]])
            yield from padded[self.shard_id::self.num_shards]
            epoch += 1
            if self.max_iter is None:
                return

    def _pad_images(self, imgs: List[np.ndarray]) -> np.ndarray:
        h, w = self.hw
        out = np.zeros((len(imgs), h, w, imgs[0].shape[2]), np.float32)
        for i, im in enumerate(imgs):
            out[i, : im.shape[0], : im.shape[1]] = im[:h, :w]
        return out

    def _collate(self, samples: List[dict]) -> Dict[str, np.ndarray]:
        h, w = self.hw
        batch = {
            "left": self._pad_images([s["left"] for s in samples]),
            "right": self._pad_images([s["right"] for s in samples]),
            "gt_left": np.stack([s["gt_left"] for s in samples]),
            "gt_right": np.stack([s["gt_right"] for s in samples]),
            "gt_box3d": np.stack([s["gt_box3d"] for s in samples]),
            "gt_labels": np.stack([s["gt_labels"] for s in samples]),
            "gt_valid": np.stack([s["gt_valid"] for s in samples]),
            "imgid": [s["imgid"] for s in samples],
        }
        if "raw_left" in samples[0]:
            batch["raw_left"] = self._pad_images([s["raw_left"] for s in samples])
            batch["raw_right"] = self._pad_images([s["raw_right"] for s in samples])
        # offline 2D predictions (stage 2/3 input)
        for k in ("pred_left", "pred_right", "pred_score", "pred_labels",
                  "pred_valid", "pred_mask"):
            if k in samples[0]:
                batch[k] = np.stack([s[k] for s in samples])
        if "gt_masks" in samples[0]:
            m = np.zeros((len(samples), samples[0]["gt_masks"].shape[0], h, w), np.float32)
            for i, s in enumerate(samples):
                mh, mw = s["gt_masks"].shape[1:]
                m[i, :, : min(mh, h), : min(mw, w)] = s["gt_masks"][:, :h, :w]
            batch["gt_masks"] = m
        if "gt_disp" in samples[0]:
            d = np.zeros((len(samples), h, w), np.float32)
            for i, s in enumerate(samples):
                dh, dw = s["gt_disp"].shape
                d[i, : min(dh, h), : min(dw, w)] = s["gt_disp"][:h, :w]
            batch["gt_disp"] = d
        if "calib" in samples[0]:
            batch["calib"] = {
                k: np.stack([s["calib"][k] for s in samples])
                for k in samples[0]["calib"]
            }
            batch["P2"] = np.stack([s["P2"] for s in samples])
            batch["P3"] = np.stack([s["P3"] for s in samples])
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        stream = self._index_stream()
        it = self.start_iter
        while True:
            idxs = list(itertools.islice(stream, self.bs))
            if len(idxs) < self.bs:
                if not (self.pad_last and idxs):
                    return
                idxs = idxs + [idxs[0]] * (self.bs - len(idxs))
            yield self._collate([self.ds[int(i)] for i in idxs])
            it += 1
            if self.max_iter is not None and it >= self.max_iter:
                return
