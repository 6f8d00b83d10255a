"""The port's eval entry point against the JAX package's on the CPU, 3D
stage: the whole loop of tools/test_net on rcnn.yaml at small sizes, and
the CLI once in a subprocess (tests/test_torch_eval_entry.py has the 2D
loop and the evaluator).

Tolerances: the offline boxes, scores, labels and masks, valid =
pred_valid & roi_ok and random3d equal; box3d and score3d within 1e-3 *
max |JAX| + 1e-3, as test_torch_disprcnn3d.py::test_predict_3d_matches_jax_chain
holds them. The CLI's predictions.pkl has the JAX package's keys, dtypes
and shapes.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_eval_helpers import (RCNN_HW, RCNN_YAML, REPO, TINY_RCNN, check_keys_and_dtypes,
                                jax_loop, port_loop, write_gt_labels)

BOX3D_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def loop_3d(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop3d")
    want, wtxt, v, drawn = jax_loop(RCNN_YAML, TINY_RCNN, "synthetic3d_2", RCNN_HW,
                                    str(tmp / "jax"), seed=1)
    assert len(drawn) == 2  # one batch an image (TEST.IMS_PER_BATCH 1)
    got = port_loop(RCNN_YAML, TINY_RCNN, "synthetic3d_2", RCNN_HW, str(tmp / "port"), v,
                    drawn)
    return got, want, wtxt


def test_whole_loop_3d_matches_jax(loop_3d):
    got, want, wtxt = loop_3d
    preds = got["predictions"]
    check_keys_and_dtypes(preds, want)
    for imgid, w in want.items():
        g = preds[imgid]
        for k in ("left_boxes", "right_boxes", "scores", "labels", "masks", "valid",
                  "random3d"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert w["valid"].any()
        for k in ("box3d", "score3d"):
            assert np.isfinite(g[k]).all()
            assert np.abs(g[k] - w[k]).max() <= BOX3D_TOL * np.abs(w[k]).max() + BOX3D_TOL, k
    assert sorted(os.listdir(got["txt_dir"])) == sorted(os.listdir(wtxt))


def test_cli_runs_on_the_cpu(tmp_path, loop_3d):
    """python -m disprcnn_tpu_torch.tools.test_net --device cpu --evaluate:
    predictions.pkl with the JAX package's keys and dtypes, the txt, and the
    AP files of both IoU thresholds."""
    _, want, _ = loop_3d
    gt = str(tmp_path / "gt")
    write_gt_labels(gt, "synthetic3d_2", ["TPU.MAX_GT", "4"])
    out = str(tmp_path / "out")
    cmd = [sys.executable, "-m", "disprcnn_tpu_torch.tools.test_net", "--config-file",
           str(REPO / RCNN_YAML), "--dataset", "synthetic3d_2", "--static-hw", "192,640",
           "--device", "cpu", "--evaluate", "--gt-dir", gt, "--seed", "3",
           *TINY_RCNN, "OUTPUT_DIR", out]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "AP@0.7" in r.stdout and "AP@0.5" in r.stdout
    res = os.path.join(out, "inference", "synthetic3d_2")
    with open(os.path.join(res, "predictions.pkl"), "rb") as f:
        check_keys_and_dtypes(pickle.load(f), want)
    assert sorted(os.listdir(os.path.join(res, "txt"))) == ["synt000000.txt", "synt000001.txt"]
    for sub in ("eval_07", "eval_05"):
        files = os.listdir(os.path.join(res, sub))
        assert {"stats_car_detection.txt", "stats_car_detection_ground.txt",
                "stats_car_detection_3d.txt"} <= set(files)
    assert os.path.exists(os.path.join(out, "log.txt"))
