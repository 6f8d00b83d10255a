"""Padded image batches (a copy of disprcnn_tpu/structures/image_list.py;
reference structures/image_list.py:7-80).

Images are HWC numpy arrays on the host. ``to_image_batch`` pads a list of
them to one size divisible by ``size_divisible`` and records each image's
true size.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class ImageBatch:
    """tensor (B, H, W, C) + per-image (h, w) sizes."""

    def __init__(self, tensor: np.ndarray, image_sizes: Sequence[Tuple[int, int]]):
        self.tensor = tensor
        self.image_sizes = list(image_sizes)

    def __len__(self):
        return self.tensor.shape[0]


def to_image_batch(images: List[np.ndarray], size_divisible: int = 0) -> ImageBatch:
    max_h = max(im.shape[0] for im in images)
    max_w = max(im.shape[1] for im in images)
    if size_divisible > 0:
        d = size_divisible
        max_h = int(np.ceil(max_h / d) * d)
        max_w = int(np.ceil(max_w / d) * d)
    c = images[0].shape[2]
    out = np.zeros((len(images), max_h, max_w, c), dtype=images[0].dtype)
    sizes = []
    for i, im in enumerate(images):
        out[i, : im.shape[0], : im.shape[1]] = im
        sizes.append((im.shape[0], im.shape[1]))
    return ImageBatch(out, sizes)
