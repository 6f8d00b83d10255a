"""Dataset catalog: name -> factory + args (counterpart of
disprcnn_tpu/data/catalog.py; reference config/paths_catalog.py:8-100).

The reference names (kitti_{split}_{vob|pob}_{car|pedestrian} and
kitti_{split}_cyclist) resolve to KittiStereoDataset configurations; a
synthetic_* family is added for data-free testing and benchmarking
(synthetic3d_* variants additionally emit offline-2D-prediction keys so
DispRCNN3D configs run without a prior stage).
"""
from __future__ import annotations

import os
import re

DATA_DIR = "data/kitti"


def data_dir() -> str:
    """KITTI root; override with DISPRCNN_DATA_DIR (e.g. a
    tools/make_mini_kitti.py dump). Read per-call so tests can monkeypatch."""
    return os.environ.get("DISPRCNN_DATA_DIR", DATA_DIR)


def resolve(name: str, cfg=None, training: bool = True, transforms=None):
    from .datasets.kitti import KittiStereoDataset
    from .datasets.synthetic import SyntheticStereoDataset

    max_gt = cfg.TPU.MAX_GT if cfg is not None else 32
    max_det = cfg.TPU.MAX_DETECTIONS if cfg is not None else 32
    offline = cfg.SOLVER.OFFLINE_2D_PREDICTIONS if cfg is not None else ""

    m = re.match(r"kitti_(train|val|trainval|test)_(vob|pob)_(car|pedestrian)$", name)
    if m:
        split, base, category = m.groups()
        return KittiStereoDataset(
            root=data_dir(), split=split, category=category, max_gt=max_gt,
            max_det=max_det, training=training, transforms=transforms,
            shape_prior_base=base, offline_2d_predictions=offline or None,
        )
    m = re.match(r"kitti_(train|val|trainval|test)_cyclist$", name)
    if m:
        return KittiStereoDataset(
            root=data_dir(), split=m.group(1), category="cyclist", max_gt=max_gt,
            max_det=max_det, training=training, transforms=transforms,
            shape_prior_base=None, offline_2d_predictions=offline or None,
        )
    m = re.match(r"synthetic(3d)?_(\d+)$", name)
    if m:
        return SyntheticStereoDataset(
            n_samples=int(m.group(2)), max_gt=max_gt, transforms=transforms,
            with_offline_preds=bool(m.group(1)),
        )
    raise KeyError(f"Unknown dataset: {name}")


def resolve_many(names, cfg=None, training: bool = True, transforms=None):
    """Concatenation of several catalog entries (reference
    data/datasets/concat_dataset.py via data/build.py:16-44)."""
    from .datasets.concat import ConcatDataset

    datasets = [resolve(n, cfg, training, transforms) for n in names]
    if len(datasets) == 1:
        return datasets[0]
    return ConcatDataset(datasets)
