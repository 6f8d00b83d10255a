"""KITTI object-dataset I/O: calibration files, label files, split lists
(a copy of disprcnn_tpu/data/kitti_io.py).

Host-side numpy parsing (reference utils/kitti_utils.py:12-546: Calibration
construction, load_label_2/load_label_3, KITTIObject3D fields). Produces plain
numpy structures the input pipeline pads into fixed-shape batches.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

KITTI_CLASSES = (
    "__background__", "Car", "Van", "Truck", "Pedestrian", "Person_sitting",
    "Cyclist", "Tram", "Misc", "DontCare",
)


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            key, vals = line.split(":", 1)
            try:
                out[key.strip()] = np.asarray([float(v) for v in vals.split()], np.float64)
            except ValueError:
                continue
    return out


@dataclass
class KittiCalib:
    P2: np.ndarray  # (3, 4)
    P3: np.ndarray  # (3, 4)
    R0: np.ndarray  # (3, 3)
    V2C: np.ndarray  # (3, 4)

    @classmethod
    def from_file(cls, path: str) -> "KittiCalib":
        d = read_calib_file(path)
        return cls(
            P2=d["P2"].reshape(3, 4),
            P3=d["P3"].reshape(3, 4),
            R0=d.get("R0_rect", np.eye(3).reshape(-1)).reshape(3, 3),
            V2C=d.get("Tr_velo_to_cam", np.eye(3, 4).reshape(-1)).reshape(3, 4),
        )

    @property
    def fu(self):
        return self.P2[0, 0]

    @property
    def fv(self):
        return self.P2[1, 1]

    @property
    def cu(self):
        return self.P2[0, 2]

    @property
    def cv(self):
        return self.P2[1, 2]

    @property
    def tx(self):
        return self.P2[0, 3] / (-self.fu)

    @property
    def ty(self):
        return self.P2[1, 3] / (-self.fv)

    @property
    def stereo_fuxbaseline(self):
        """fu x baseline: depth = this / disparity (kitti_utils.py:66-68)."""
        return self.P2[0, 3] - self.P3[0, 3]


@dataclass
class KittiObject:
    cls_name: str
    truncated: float
    occluded: float
    alpha: float
    box2d: np.ndarray  # (4,) xyxy
    h: float
    w: float
    l: float
    xyz: np.ndarray  # (3,) bottom-center, rect frame
    ry: float
    score: float = -1.0

    @property
    def box3d_xyzhwl_ry(self) -> np.ndarray:
        return np.asarray(
            [*self.xyz, self.h, self.w, self.l, self.ry], np.float32
        )


def parse_label_line(line: str) -> Optional[KittiObject]:
    t = line.strip().split()
    if len(t) < 15:
        return None
    return KittiObject(
        cls_name=t[0],
        truncated=float(t[1]),
        occluded=float(t[2]),
        alpha=float(t[3]),
        box2d=np.asarray([float(v) for v in t[4:8]], np.float32),
        h=float(t[8]),
        w=float(t[9]),
        l=float(t[10]),
        xyz=np.asarray([float(v) for v in t[11:14]], np.float32),
        ry=float(t[14]),
        score=float(t[15]) if len(t) > 15 else -1.0,
    )


def load_labels(path: str) -> List[KittiObject]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        objs = [parse_label_line(l) for l in f if l.strip()]
    return [o for o in objs if o is not None]


def load_split(kitti_root: str, name: str) -> List[str]:
    """Image ids of a split file (data/kitti/object/split_set/<name>.txt)."""
    path = os.path.join(kitti_root, "object", "split_set", f"{name}.txt")
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def disparity_from_png(arr: np.ndarray) -> np.ndarray:
    """16-bit KITTI disparity PNG -> float disparity (values / 256, 0=invalid)
    (reference kitti_car.py:290-305)."""
    return arr.astype(np.float32) / 256.0


def object_alpha_from_box(ry: float, x: float, z: float) -> float:
    """alpha = ry + atan(-x/z) (reference kitti_eval.py write_txt)."""
    return ry + np.arctan2(-x, z)
