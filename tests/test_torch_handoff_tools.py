"""The recipe's stage-handoff tools of the port against the JAX package's
on the CPU: tools/split_predictions.py and tools/generate_psmnet_input.py
on one predictions.pkl (seeded boxes, scores and masks over synthetic_4,
some detections below the score threshold or invalid) and one dataset;
and utils/{profiling,benchmarking}.py on the CPU.

Tolerances: the same file names, the split pickles equal; the ROI records'
masks exactly, their disparities within 1e-5 absolute + 1e-7 relative,
their crops (ROIAlign of the raw [0, 1] images) within 2^-14 absolute:
the two packages compute the sampling coordinates in float32 by different
formulas (JAX's as matrix contractions), one float32 spacing of an x in
[512, 1024) px is 2^-14 px, and a crop value moves by that times the step
between neighbouring pixels, at most 1 (2.2e-5 measured); the port's
KittiRoiDataset reads the port's records as the JAX package's reads the
JAX tool's, the crops then within 2^-14 / 0.224 (ImageNet's smallest std)
and the rest as above.
"""
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from disprcnn_tpu.data.datasets import kitti_roi as jroi
from disprcnn_tpu_torch.data.datasets import kitti_roi
from disprcnn_tpu_torch.tools import generate_psmnet_input, split_predictions
from disprcnn_tpu_torch.utils import benchmarking, profiling
from torch_eval_helpers import REPO

DATASET = "synthetic_4"
CROP_ATOL = 2.0 ** -14


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_tool(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    jax_tool(name).main()


def predictions(seed=0, d=6, hw=(192, 640)):
    """Per image d detections: left boxes inside the image, the right ones
    shifted by 8-60 px, scores about the 0.05 threshold, one invalid."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(4):
        x1 = rng.uniform(0, hw[1] - 120, d)
        y1 = rng.uniform(0, hw[0] - 80, d)
        w, h = rng.uniform(8, 110, d), rng.uniform(6, 70, d)
        left = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
        right = left - np.asarray([1, 0, 1, 0], np.float32) * rng.uniform(8, 60, (d, 1))
        valid = np.ones(d, bool)
        valid[-1] = False
        out[f"synt{i:06d}"] = {"left_boxes": left, "right_boxes": right.astype(np.float32),
                           "scores": rng.uniform(0.0, 0.3, d).astype(np.float32),
                           "valid": valid, "labels": np.ones(d, np.int32),
                           "masks": rng.uniform(0, 1, (d, 28, 28)).astype(np.float32)}
    return out


@pytest.fixture(scope="module")
def pkl(tmp_path_factory):
    path = tmp_path_factory.mktemp("preds") / "predictions.pkl"
    with open(path, "wb") as f:
        pickle.dump(predictions(), f)
    return str(path)


def test_split_predictions_matches_jax(pkl, tmp_path, monkeypatch):
    run_jax_tool("split_predictions", ["--predictions", pkl, "--out", str(tmp_path / "jax")],
                 monkeypatch)
    split_predictions.main(["--predictions", pkl, "--out", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [f"synt{i:06d}.pkl" for i in range(4)]
    for n in names:
        with open(tmp_path / "jax" / n, "rb") as f, open(tmp_path / "port" / n, "rb") as g:
            want, got = pickle.load(f), pickle.load(g)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_generate_psmnet_input_matches_jax(pkl, tmp_path, monkeypatch):
    run_jax_tool("generate_psmnet_input", ["--predictions", pkl, "--dataset", DATASET,
                                           "--out", str(tmp_path / "jax" / "train")],
                 monkeypatch)
    generate_psmnet_input.main(["--predictions", pkl, "--dataset", DATASET, "--out",
                                str(tmp_path / "port" / "train"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax" / "train"))
    assert names == sorted(os.listdir(tmp_path / "port" / "train"))
    kept = sum(int(((p["scores"] > 0.05) & p["valid"]).sum()) for p in predictions().values())
    assert len(names) == kept > 4
    masked = 0
    for n in names:
        want = np.load(tmp_path / "jax" / "train" / n)
        got = np.load(tmp_path / "port" / "train" / n)
        assert sorted(got.files) == ["disparity", "left", "mask", "right"]
        for k in ("left", "right", "disparity"):
            assert got[k].shape == want[k].shape and got[k].dtype == np.float32, (n, k)
            np.testing.assert_allclose(got[k], want[k], rtol=0 if k != "disparity" else 1e-7,
                                       atol=CROP_ATOL if k != "disparity" else 1e-5,
                                       err_msg=(n, k))
        np.testing.assert_array_equal(got["mask"], want["mask"], err_msg=n)
        masked += int(got["mask"].sum())
    assert masked > 0
    ours = kitti_roi.KittiRoiDataset(str(tmp_path / "port"), "train")
    theirs = jroi.KittiRoiDataset(str(tmp_path / "jax"), "train")
    assert len(ours) == len(theirs) == kept
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            crop = k in ("left", "right")
            np.testing.assert_allclose(a[k], b[k], rtol=0 if crop else 1e-7,
                                       atol=CROP_ATOL / 0.224 if crop else 1e-5, err_msg=(i, k))


def test_profiling_and_benchmarking_on_the_cpu(tmp_path):
    x = torch.randn(16, 32)
    w = torch.randn(32, 8)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        y = x @ w
    assert os.path.getsize(prof.trace_path) > 0
    assert any("mm" in e.key for e in prof.key_averages())
    timer = profiling.StepTimer(window=3)
    for _ in range(4):
        out, dt = timer.timed(lambda: {"y": x @ w})
        assert dt > 0 and torch.equal(out["y"], y)
    assert len(timer.samples) == 3 and timer.median > 0
    assert profiling.device_memory_stats(torch.device("cpu")) == {}
    assert benchmarking.compiled_flops(lambda a, b: a @ b, x, w) == 2 * 16 * 32 * 8
    assert benchmarking.peak_flops(torch.device("cpu")) == 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            benchmarking.device_timeit(lambda: x @ w)
