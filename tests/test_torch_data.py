"""The port's data layer (disprcnn_tpu_torch/data) against the JAX
package's.

Tolerances: the datasets' samples, the loader's batches, the zarr stores
and everything a transform computes without resizing are bit-equal (same
values, same dtypes). The resize is OpenCV's INTER_LINEAR rule in numpy
and torch ops instead of cv2.resize: within 4 float32 ulps of the largest
magnitude of cv2's output (2.4e-7 on [0, 1] images), so a normalized image
(x 255, BGR) within 255 times that.
"""
import importlib.util
import os
import pathlib
import pickle
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from disprcnn_tpu.config import get_default_cfg as jax_default_cfg
from disprcnn_tpu.data import catalog as jcatalog
from disprcnn_tpu.data import loader as jloader
from disprcnn_tpu.data import transforms as jtransforms
from disprcnn_tpu.data import zarr_io as jzarr
from disprcnn_tpu.data.datasets.kitti import KittiStereoDataset as JKitti
from disprcnn_tpu_torch.config import get_default_cfg
from disprcnn_tpu_torch.data import catalog, loader, transforms, zarr_io
from disprcnn_tpu_torch.data.datasets.kitti import KittiStereoDataset
from test_zarr_io import _blosc_header, _lz4_rle, _meta, _write_store

REPO = pathlib.Path(__file__).resolve().parents[1]
RESIZE_ULPS = 4


def assert_equal_trees(got, want, path=""):
    """Equal keys, and equal values of equal dtype, down the tree."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_equal_trees(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)) and not isinstance(want, np.ndarray):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal_trees(g, w, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


def resize_tol(want: np.ndarray, scale: float = 1.0) -> float:
    return RESIZE_ULPS * float(np.spacing(np.float32(np.abs(want).max()))) * scale


def cfgs(path=None, opts=()):
    t, j = get_default_cfg(), jax_default_cfg()
    for c in (t, j):
        if path:
            c.merge_from_file(str(REPO / path))
        c.merge_from_list(list(opts))
        c.freeze()
    return t, j


@pytest.mark.parametrize("name", ["synthetic_3", "synthetic3d_3"])
def test_synthetic_samples_bit_equal(name):
    t, j = cfgs("configs/kitti/car/vob/rcnn.yaml", ["TPU.MAX_GT", "8"])
    tds = catalog.resolve(name, t, training=False)
    jds = jcatalog.resolve(name, j, training=False)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        assert_equal_trees(tds[i], jds[i])
    assert tds[1]["gt_masks"].shape == (8, 192, 640)
    assert ("pred_left" in tds[0]) == name.startswith("synthetic3d")


RESIZES = [((192, 640), (600, 2000)), ((375, 1242), (600, 1987)), ((100, 300), (37, 111)),
           ((192, 640), (96, 320)), ((7, 9), (13, 5))]


@pytest.mark.parametrize("hw,new_hw", RESIZES)
def test_resize_matches_cv2(hw, new_hw):
    """Images, a binary mask and disparity (values 0-80) against
    cv2.resize(INTER_LINEAR), as the JAX package calls it (each mask on its
    own)."""
    rng = np.random.default_rng(sum(hw))
    cases = [rng.uniform(0, 1, (*hw, 3)).astype(np.float32),
             (rng.uniform(size=hw) > 0.5).astype(np.float32),
             rng.uniform(0, 80, hw).astype(np.float32)]
    for x in cases:
        want = cv2.resize(x, (new_hw[1], new_hw[0]), interpolation=cv2.INTER_LINEAR)
        got = transforms._resize_img(x, new_hw)
        assert got.dtype == np.float32 and got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= resize_tol(want), (x.shape, err)


def test_eval_transforms_match_jax():
    """mask.yaml's eval transforms (the resize to the 600-pixel short side,
    then the BGR255 normalization) on synthetic3d samples: the resized
    arrays within the resize bound, every box, calibration entry and
    offline prediction exactly."""
    t, j = cfgs("configs/kitti/car/vob/mask.yaml", ["TPU.MAX_GT", "4"])
    tds = catalog.resolve("synthetic3d_2", t, training=False,
                          transforms=transforms.build_transforms(t, is_train=False))
    jds = jcatalog.resolve("synthetic3d_2", j, training=False,
                           transforms=jtransforms.build_transforms(j, is_train=False))
    resized = {"left": 255.0, "right": 255.0, "raw_left": 1.0, "raw_right": 1.0,
               "gt_masks": 1.0, "gt_disp": 1.0}
    for i in range(2):
        got, want = tds[i], jds[i]
        assert got["left"].shape == (600, 2000, 3)
        for k, scale in resized.items():
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert np.abs(got[k] - want[k]).max() <= resize_tol(want[k], scale), k
        assert_equal_trees({k: v for k, v in got.items() if k not in resized},
                           {k: v for k, v in want.items() if k not in resized})


def test_eval_transforms_draw_nothing():
    t, _ = cfgs("configs/kitti/car/vob/mask.yaml", ["TPU.MAX_GT", "4"])
    state = np.random.get_state()[1].copy()
    ds = catalog.resolve("synthetic_1", t, training=False,
                         transforms=transforms.build_transforms(t, is_train=False))
    ds[0]
    np.testing.assert_array_equal(np.random.get_state()[1], state)
    with pytest.raises(ValueError, match="generator"):
        transforms.build_transforms(t, is_train=True)


def test_random_transforms_draw_from_their_generator():
    """A flip that always fires equals the JAX package's; the jitter's draws
    repeat with the generator's seed."""
    t, j = cfgs(opts=["INPUT.DO_RESIZE", "False", "INPUT.FLIP_PROB_TRAIN", "1.0",
                      "INPUT.BRIGHTNESS", "0.2", "INPUT.CONTRAST", "0.2"])
    sample = catalog.resolve("synthetic3d_1", t, training=False)[0]
    flip_t = transforms.RandomHorizontalFlip(1.0, np.random.default_rng(0))
    assert_equal_trees(flip_t(sample), jtransforms.RandomHorizontalFlip(1.0)(sample))
    runs = [transforms.build_transforms(t, True, np.random.default_rng(5))(sample)
            for _ in range(2)]
    assert_equal_trees(runs[0], runs[1])
    other = transforms.build_transforms(t, True, np.random.default_rng(6))(sample)
    assert not np.array_equal(other["left"], runs[0]["left"])


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    """tools/make_mini_kitti.py's scenes (3 train, 2 val, 96x160), and
    offline 2D predictions for them as a directory of pickles and as one
    predictions.pkl."""
    root = tmp_path_factory.mktemp("mini_kitti")
    spec = importlib.util.spec_from_file_location("make_mini_kitti",
                                                  REPO / "tools" / "make_mini_kitti.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = sys.argv
    sys.argv = ["make_mini_kitti.py", "--root", str(root), "--n-train", "3", "--n-val", "2",
                "--image-hw", "96,160"]
    try:
        mod.main()
    finally:
        sys.argv = argv
    rng = np.random.default_rng(3)
    preds = {}
    pdir = root / "offline"
    pdir.mkdir()
    for n, imgid in enumerate(f"{i:06d}" for i in range(5)):
        d = 6
        valid = rng.uniform(size=d) > 0.4
        valid[0] = n != 1  # scene 1 has no valid detection: filtered in training
        pred = {"left_boxes": rng.uniform(0, 90, (d, 4)).astype(np.float32),
                "right_boxes": rng.uniform(0, 90, (d, 4)).astype(np.float32),
                "scores": rng.uniform(size=d).astype(np.float32),
                "labels": np.ones(d, np.int32), "valid": valid & (n != 1),
                "masks": rng.uniform(size=(d, 1, 28, 28) if n % 2 else (d, 28, 28))
                .astype(np.float32)}
        preds[imgid] = pred
        with open(pdir / f"{imgid}.pkl", "wb") as f:
            pickle.dump(pred, f)
    with open(root / "predictions.pkl", "wb") as f:
        pickle.dump(preds, f)
    return root


@pytest.mark.parametrize("split,training,offline", [
    ("train", True, None), ("val", False, None), ("train", True, "offline"),
    ("trainval", False, "offline"), ("trainval", True, "predictions.pkl")])
def test_mini_kitti_samples_bit_equal(mini_kitti, split, training, offline):
    kw = dict(root=str(mini_kitti), split=split, category="car", max_gt=8, max_det=4,
              training=training, shape_prior_base="vob",
              offline_2d_predictions=str(mini_kitti / offline) if offline else None)
    tds, jds = KittiStereoDataset(**kw), JKitti(**kw)
    assert tds.ids == jds.ids and len(tds) >= 1
    if offline and training:
        assert "000001" not in tds.ids
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        assert_equal_trees(got, want)
        assert got["gt_masks"][: int(got["gt_valid"].sum())].any()  # read from the zarr store
        assert got["gt_disp"].any()


def test_mini_kitti_through_the_catalog(mini_kitti, monkeypatch):
    monkeypatch.setenv("DISPRCNN_DATA_DIR", str(mini_kitti))
    t, j = cfgs("configs/kitti/car/vob/rcnn.yaml",
                ["SOLVER.OFFLINE_2D_PREDICTIONS", str(mini_kitti / "offline")])
    tds = catalog.resolve("kitti_val_vob_car", t, training=False)
    jds = jcatalog.resolve("kitti_val_vob_car", j, training=False)
    assert tds.root == str(mini_kitti) and len(tds) == len(jds) == 2
    assert_equal_trees(tds[1], jds[1])
    for name in ("kitti_val_cyclist", "synthetic3d_2"):
        assert type(catalog.resolve(name, t)).__name__ == type(jcatalog.resolve(name, j)).__name__
    with pytest.raises(KeyError):
        catalog.resolve("coco_2017_val", t)


ZARR_ARRAYS = [np.arange(12, dtype="<i4").reshape(3, 4), np.float32(2.5) * np.ones((2, 3, 5)),
               (np.arange(40).reshape(5, 8) % 3 == 0), np.array(7, "<u2"),
               np.random.default_rng(0).uniform(size=(4, 6)).astype("<f8")]


@pytest.mark.parametrize("compressor", ["zlib", None])
def test_zarr_round_trips_both_ways(tmp_path, compressor):
    for n, arr in enumerate(ZARR_ARRAYS):
        for k, save in enumerate((zarr_io.save_zarr, jzarr.save_zarr)):
            path = str(tmp_path / f"{n}_{k}.zarr")
            save(path, arr, compressor=compressor)
            got = zarr_io.load_zarr(path)
            assert_equal_trees(got, jzarr.load_zarr(path))
            assert got.dtype == arr.dtype
            np.testing.assert_array_equal(got.reshape(arr.shape), arr)
        files = lambda k: sorted(os.listdir(tmp_path / f"{n}_{k}.zarr"))
        assert files(0) == files(1)


def test_zarr_reads_the_stores_of_test_zarr_io(tmp_path):
    """The blosc-lz4 and memcpy chunks, F order and missing chunks of the
    JAX package's zarr tests read the same through both readers."""
    arr = np.arange(6 * 4, dtype="<f4").reshape(6, 4)
    stores = {
        "zl": (_meta(arr.shape, (3, 4), "<f4", {"id": "zlib", "level": 1}, order="F",
                     fill=-1.0),
               {"0.0": zlib.compress(np.asfortranarray(arr[:3]).tobytes(order="F"))}),
    }
    b0, b1 = bytes([7, 1, 9, 3]) * 64, bytes([5, 5, 5, 5]) * 48
    s0, s1 = _lz4_rle(b0), _lz4_rle(b1)
    chunk = bytearray(_blosc_header(1 << 5, 1, len(b0 + b1), 256, 0))
    chunk += struct.pack("<2I", 24, 28 + len(s0))
    chunk += struct.pack("<I", len(s0)) + s0 + struct.pack("<I", len(s1)) + s1
    stores["bl"] = (_meta((len(b0 + b1),), (len(b0 + b1),), "|u1", {"id": "blosc"}),
                    {"0": bytes(chunk)})
    for name, (meta, chunks) in stores.items():
        p = str(tmp_path / f"{name}.zarr")
        _write_store(p, meta, chunks)
        assert_equal_trees(zarr_io.load_zarr(p), jzarr.load_zarr(p))


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, shuffle=False, pad_last=True),
    dict(batch_size=2, shuffle=True, seed=3, pad_last=False),
    dict(batch_size=1, shuffle=True, seed=1, num_shards=2, shard_id=1),
    dict(batch_size=2, shuffle=False, num_shards=2, shard_id=0, pad_last=True),
    dict(batch_size=2, shuffle=True, max_iter=4, start_iter=1, group_by_aspect=True)])
def test_loader_batches_bit_equal(kw):
    """Batches over synthetic3d samples, cropped and padded to a static
    size that cuts the 192x640 images: images, GT, masks, disparity,
    calibration and offline predictions."""
    t, j = cfgs(opts=["TPU.MAX_GT", "4"])
    tl = loader.StereoBatchLoader(catalog.resolve("synthetic3d_5", t), static_hw=(150, 600),
                                  size_divisibility=32, **kw)
    jl = jloader.StereoBatchLoader(jcatalog.resolve("synthetic3d_5", j), static_hw=(150, 600),
                                   size_divisibility=32, **kw)
    assert tl.hw == (160, 608)
    got, want = list(tl), list(jl)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert_equal_trees(g, w)
