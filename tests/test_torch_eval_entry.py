"""The port's eval entry point against the JAX package's on the CPU: the
KITTI evaluator and txt writer, and the whole loop of tools/test_net (config
-> catalog -> loader -> batching -> model -> inference -> KITTI txt) on a
small mask.yaml (tests/test_torch_eval_entry_3d.py has rcnn.yaml's loop and
the CLI).

Tolerances: the AP dicts, the stats_*.txt files and the txt files of equal
predictions are equal (bytes). Through the whole loop the 2D detections
are held as tests/test_torch_detector2d.py holds them (valid slots and
labels equal, boxes within 1e-3 px, scores within 1e-5, mask
probabilities within 1e-4; the regressors zero, see
torch_eval_helpers.zero_box_regressors), and predictions.pkl has the JAX
package's keys, dtypes and shapes.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from disprcnn_tpu.evaluation import ap as jap
from disprcnn_tpu.evaluation import kitti_eval as jkitti_eval
from disprcnn_tpu_torch.evaluation import ap, kitti_eval
from disprcnn_tpu_torch.tools import test_net as tn
from test_evaluation import _write_scene
from torch_eval_helpers import (MASK_HW, MASK_YAML, TINY_MASK, check_keys_and_dtypes,
                                jax_loop, port_loop, zero_box_regressors)


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# -- the evaluator and the txt writer ---------------------------------------
def read_all(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("thresh,seed", [(0.7, 0), (0.5, 1)])
def test_evaluate_ap_matches_jax(tmp_path, thresh, seed):
    gt, pred = str(tmp_path / "gt"), str(tmp_path / "pred")
    _write_scene(gt, pred, np.random.default_rng(seed))
    got = ap.evaluate_ap(gt, pred, str(tmp_path / "t"), "Car", thresh)
    want = jap.evaluate_ap(gt, pred, str(tmp_path / "j"), "Car", thresh)
    assert got == want and set(got) == {"image", "ground", "3d", "orientation"}
    assert read_all(tmp_path / "t") == read_all(tmp_path / "j")
    assert 5.0 < got["image"][0] < 100.0


def test_evaluate_kitti_matches_jax(tmp_path):
    gt, pred = str(tmp_path / "gt"), str(tmp_path / "pred")
    _write_scene(gt, pred, np.random.default_rng(2), det_prob=0.6)
    got = kitti_eval.evaluate_kitti(gt, pred, str(tmp_path / "t"))
    want = jkitti_eval.evaluate_kitti(gt, pred, str(tmp_path / "j"), use_native=False)
    assert got == want and set(got) == {0.7, 0.5}
    for sub in ("eval_07", "eval_05"):
        assert read_all(tmp_path / "t" / sub) == read_all(tmp_path / "j" / sub)
        parsed = kitti_eval._parse_stats(str(tmp_path / "t" / sub), "Car")
        assert parsed == jkitti_eval._parse_stats(str(tmp_path / "j" / sub), "Car")
        thr = 0.7 if sub == "eval_07" else 0.5
        # the files hold the curves to 6 decimals: AP (x 100) to 1e-4
        for kind, metric in (("bbox", "image"), ("bev", "ground"), ("3d", "3d")):
            np.testing.assert_allclose(parsed[kind], got[thr][metric], rtol=0, atol=1e-4)


def random_predictions(rng, n_images, d, with_3d):
    out = {}
    for i in range(n_images):
        x1 = rng.uniform(0, 500, (d, 2))
        p = {"left_boxes": np.concatenate([x1, x1 + rng.uniform(10, 90, (d, 2))], 1)
             .astype(np.float32), "scores": rng.uniform(size=d).astype(np.float32),
             "valid": rng.uniform(size=d) > 0.3}
        if with_3d:
            box3d = rng.uniform(-3, 3, (d, 7)).astype(np.float32)
            box3d[:, 2] = rng.uniform(-2, 40, d)  # z <= 0 writes alpha -10
            p.update(box3d=box3d, score3d=rng.uniform(size=d).astype(np.float32))
        out[f"{i:06d}"] = p
    return out


@pytest.mark.parametrize("with_3d", [False, True])
def test_write_kitti_txt_matches_jax(tmp_path, with_3d):
    preds = random_predictions(np.random.default_rng(int(with_3d)), 4, 6, with_3d)
    got = kitti_eval.write_kitti_txt(preds, str(tmp_path / "t"), "Car")
    want = jkitti_eval.write_kitti_txt(preds, str(tmp_path / "j"), "Car")
    assert read_all(got) == read_all(want) and len(read_all(got)) == 4


# -- the whole loop -----------------------------------------------------------
@pytest.fixture(scope="module")
def loop_2d(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop2d")
    want, wtxt, v, _ = jax_loop(MASK_YAML, TINY_MASK, "synthetic_2", MASK_HW,
                                str(tmp / "jax"), seed=0, prepare=zero_box_regressors)
    return port_loop(MASK_YAML, TINY_MASK, "synthetic_2", MASK_HW, str(tmp / "port"), v, []), \
        want, wtxt


def test_whole_loop_2d_matches_jax(loop_2d):
    got, want, wtxt = loop_2d
    preds = got["predictions"]
    check_keys_and_dtypes(preds, want)
    n_valid = 0
    for imgid, w in want.items():
        g = preds[imgid]
        ok = w["valid"]
        np.testing.assert_array_equal(g["valid"], ok)
        np.testing.assert_array_equal(g["labels"][ok], w["labels"][ok])
        for k in ("left_boxes", "right_boxes"):
            np.testing.assert_allclose(g[k][ok], w[k][ok], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g["scores"][ok], w["scores"][ok], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["masks"][ok], w["masks"][ok], rtol=0, atol=1e-4)
        n_valid += int(ok.sum())
    assert n_valid >= 2
    assert sorted(os.listdir(got["txt_dir"])) == sorted(os.listdir(wtxt))
    with open(os.path.join(got["out_dir"], "predictions.pkl"), "rb") as f:
        check_keys_and_dtypes(pickle.load(f), want)


def test_cached_predictions_are_read_back(tmp_path, loop_2d):
    """force_recompute=False reads predictions.pkl and runs no batch."""
    got, _, _ = loop_2d
    calls = []
    preds = tn.inference(lambda batch: calls.append(1), [{"imgid": ["x"]}], "synthetic_2",
                         got["out_dir"], force_recompute=False)
    assert not calls and sorted(preds) == sorted(got["predictions"])


def test_each_run_logs_to_its_own_output_dir(tmp_path):
    """setup_logger moves its file handler to each call's save_dir: a
    second run in the same process writes its own log.txt, not into the
    first run's."""
    from disprcnn_tpu_torch.utils.logging import setup_logger
    name = "disprcnn_tpu_torch.test_own_log"
    for run in ("a", "b"):
        setup_logger(name, str(tmp_path / run)).info(f"run {run}")
    setup_logger(name).info("no dir")
    assert (tmp_path / "a" / "log.txt").read_text().count("run") == 1
    assert "run a" in (tmp_path / "a" / "log.txt").read_text()
    assert (tmp_path / "b" / "log.txt").read_text().count("run") == 1
    assert "run b" in (tmp_path / "b" / "log.txt").read_text()
    assert "no dir" not in (tmp_path / "b" / "log.txt").read_text()
