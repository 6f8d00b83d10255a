"""The port's visualizer (disprcnn_tpu_torch/tools/visualize.py) and its
line raster (utils/draw.py) on the CPU.

- ``draw_line`` sets exactly the pixels of ``cv2.line(img, p0, p1, color,
  1)`` on seeded segments: steep, shallow, reversed, single-pixel, along
  the border, crossing it, and with endpoints far off the image.
- ``render`` is pixel-equal to the root tool's ``render`` (tools/
  visualize.py: the JAX package's mask paste and corners, OpenCV's line,
  written by cv2.imwrite and read back by PIL) on synthetic samples with
  predictions that hold masks, boxes across the border, invalid rows, and
  3D boxes in front of, near and behind the camera.
- The CLI end to end on --device cpu: one PNG per image, decoded by PIL
  equal to ``render``.
"""
import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from disprcnn_tpu_torch.config import get_default_cfg
from disprcnn_tpu_torch.data.catalog import resolve
from disprcnn_tpu_torch.tools import visualize as tviz
from disprcnn_tpu_torch.utils.draw import draw_line, line_pixels
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("torch_one_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = "synthetic_4"


def segments(seed, n, h, w):
    """(p0, p1) float endpoints: random, steep, shallow, reversed, single
    points, along the border, and far off the image."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 7
        p0 = rng.uniform([-5, -5], [w + 5, h + 5])
        if kind == 0:
            p1 = rng.uniform([-5, -5], [w + 5, h + 5])
        elif kind == 1:  # steep
            p1 = p0 + [rng.uniform(-3, 3), rng.uniform(-h, h)]
        elif kind == 2:  # shallow, right to left
            p1 = p0 + [-rng.uniform(5, w + 5), rng.uniform(-3, 3)]
        elif kind == 3:
            p1 = p0.copy()
        elif kind == 4:  # on the border
            p0, p1 = np.array([0.0, h - 1]), np.array([w - 1.0, h - 1])
            if i % 2:
                p0, p1 = np.array([w - 1.0, 0]), np.array([w - 1.0, h - 1])
        elif kind == 5:  # far off, crossing the image
            p0 = rng.uniform(-1e6, 1e6, 2)
            p1 = -p0 + rng.uniform([0, 0], [w, h])
        else:  # far off, missing it or not
            p0, p1 = rng.uniform(-3e4, 3e4, 2), rng.uniform(-3e4, 3e4, 2)
        out.append((p0, p1))
    return out


@pytest.mark.parametrize("h, w", [(1, 1), (7, 300), (192, 640), (375, 1242)])
def test_draw_line_is_cv2_line(h, w):
    color = np.array([200, 120, 30], np.uint8)
    drawn = 0
    for p0, p1 in segments(h + w, 300 if h * w < 10 ** 5 else 120, h, w):
        want = np.zeros((h, w, 3), np.uint8)
        cv2.line(want, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), color.tolist(), 1)
        got = np.zeros_like(want)
        draw_line(got, p0, p1, color)
        np.testing.assert_array_equal(got, want, err_msg=f"{p0} -> {p1} on {h}x{w}")
        drawn += bool(want.any())
    assert drawn > 40
    ys, xs = line_pixels((-10 ** 9, 5), (10 ** 9, 5), h, w)  # beyond int32: clipped
    assert len(xs) == (w if h > 5 else 0)


def root_visualize():
    spec = importlib.util.spec_from_file_location("root_visualize",
                                                  os.path.join(REPO, "tools", "visualize.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def predictions(ds, seed):
    """{imgid: prediction} from each sample's GT, with soft random masks,
    a few invalid rows, boxes across the border, and 3D boxes moved in
    front of, close to (huge projections) and behind the camera."""
    rng = np.random.default_rng(seed)
    preds = {}
    for i in range(len(ds)):
        s = ds[i]
        n = int(s["gt_valid"].sum()) + 3
        left = s["gt_left"][:n].copy()
        left[-1] = (-20, -10, 60, 40)
        box3d = s["gt_box3d"][:n].copy()
        box3d[-2, 2] = 0.3  # corners straddle the 0.1 depth test, or not
        box3d[-3, 2] = -5.0  # behind the camera
        box3d[0, :3] = (0.2, 1.0, 1.6)  # in front, close: lines clipped from far off
        valid = np.ones(n, bool)
        valid[1] = False
        preds[s["imgid"]] = {
            "left_boxes": left.astype(np.float32), "scores": rng.uniform(0.1, 1, n),
            "valid": valid, "masks": rng.uniform(0, 1, (n, 28, 28)).astype(np.float32),
            "box3d": box3d.astype(np.float32)}
    return preds


@pytest.fixture(scope="module")
def scene():
    ds = resolve(DATASET, get_default_cfg(), training=False, transforms=None)
    return ds, predictions(ds, 0)


def test_render_matches_root_tool(scene, tmp_path):
    ds, preds = scene
    root = root_visualize()
    for i in range(len(ds)):
        s = ds[i]
        pred = preds[s["imgid"]]
        path = str(tmp_path / f"{s['imgid']}.png")
        root.render(s, pred, path)
        want = np.asarray(Image.open(path).convert("RGB"))
        got = tviz.render(s, pred, device="cpu")
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=s["imgid"])
        assert (got != (s["left"] * 255).clip(0, 255).astype(np.uint8)).any()


def test_cli_writes_pngs(scene, tmp_path):
    ds, preds = scene
    pkl = tmp_path / "predictions.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(preds, f)
    out = tmp_path / "viz"
    tviz.main(["--predictions", str(pkl), "--dataset", DATASET, "--out", str(out),
               "--limit", "3", "--device", "cpu"])
    files = sorted(os.listdir(out))
    assert files == sorted(f"{k}.png" for k in list(preds)[:3])
    by_id = {ds[i]["imgid"]: ds[i] for i in range(len(ds))}
    for name in files:
        imgid = name[:-4]
        got = np.asarray(Image.open(out / name).convert("RGB"))
        np.testing.assert_array_equal(got, tviz.render(by_id[imgid], preds[imgid], "cpu"))


def test_device_defaults_to_the_card(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tviz.visualize(scene[1], DATASET, str(tmp_path))
