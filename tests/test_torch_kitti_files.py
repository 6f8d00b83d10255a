"""A user's files through the port: the mini-KITTI writer, the KITTI
dataset over it, the native evaluator and the recipe scripts, held to the
JAX package's tools.

- tools/make_mini_kitti.py of the port and the repo's root tool (JAX's
  synthetic scenes, PIL's PNGs), run on one seed: the same file list,
  byte-equal txt files, PNGs and zarr stores that decode to equal arrays.
- KittiStereoDataset of the port and of the JAX package over one tree:
  every sample bit-equal, and the image sizes.
- evaluate_kitti's native route against its Python route on
  tests/test_ap_differential.py's scenes: the stats files equal to their
  print precision (the native build prints 6 significant digits, the
  Python one 6 decimals: 1e-6 between them), the AP to 1e-4; a missing
  compiler or a failed build raises.
- Every recipe script under disprcnn_tpu_torch/scripts parses (bash -n),
  calls only the port's tools, and carries its root twin's configs,
  datasets, checkpoints and options.
"""
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from disprcnn_tpu.data.datasets.kitti import KittiStereoDataset as JKitti
from disprcnn_tpu.data.zarr_io import load_zarr as jload_zarr
from disprcnn_tpu_torch.data import png
from disprcnn_tpu_torch.data.datasets.kitti import KittiStereoDataset
from disprcnn_tpu_torch.data.zarr_io import load_zarr
from disprcnn_tpu_torch.evaluation import kitti_eval
from disprcnn_tpu_torch.tools import make_mini_kitti
from test_ap_differential import _gen_scenes
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")
REPO = pathlib.Path(__file__).resolve().parents[1]
ARGS = dict(n_train=3, n_val=2, image_hw=(96, 320), seed=5)


def _files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(the port's tree, the root tool's tree), written from one seed."""
    port, jax_tree = (str(tmp_path_factory.mktemp(n)) for n in ("port", "jax"))
    make_mini_kitti.main(["--root", port, "--n-train", str(ARGS["n_train"]), "--n-val",
                          str(ARGS["n_val"]), "--image-hw", "96,320", "--seed", "5"])
    spec = importlib.util.spec_from_file_location("root_make_mini_kitti",
                                                  REPO / "tools" / "make_mini_kitti.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    argv = sys.argv
    sys.argv = ["make_mini_kitti.py", "--root", jax_tree, "--n-train", "3", "--n-val", "2",
                "--image-hw", "96,320", "--seed", "5"]
    try:
        tool.main()
    finally:
        sys.argv = argv
    return port, jax_tree


def test_mini_kitti_writer_matches_root_tool(trees):
    port, jax_tree = trees
    files = _files(port)
    assert files == _files(jax_tree) and len(files) > 30
    zarr_stores = set()
    for f in files:
        a, b = os.path.join(port, f), os.path.join(jax_tree, f)
        if f.endswith(".txt"):
            assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes(), f
        elif f.endswith(".png"):
            want = np.asarray(Image.open(b))
            assert np.array_equal(np.asarray(Image.open(a)), want), f
            assert np.array_equal(png.read_png(a), want), f
            assert np.array_equal(png.read_png(b), want), f
        elif ".zarr" in f:
            zarr_stores.add(f.split(".zarr")[0] + ".zarr")
    assert len(zarr_stores) == ARGS["n_train"] + ARGS["n_val"]
    for z in sorted(zarr_stores):
        want = jload_zarr(os.path.join(jax_tree, z))
        assert want.size and np.array_equal(load_zarr(os.path.join(port, z)), want), z


def test_mini_kitti_holds_the_synthetic_scenes(trees):
    """What the writer wrote reads back as the scenes, after the uint8 and
    uint16 rounding."""
    port, _ = trees
    ds = make_mini_kitti.SyntheticStereoDataset(n_samples=5, image_hw=(96, 320), max_gt=8,
                                                seed=5)
    kitti = KittiStereoDataset(port, "trainval", shape_prior_base="vob", training=False,
                               max_gt=8)
    assert kitti.ids == [f"{i:06d}" for i in range(5)]
    for i in range(5):
        s, k = ds[i], kitti[i]
        for key in ("left", "right"):
            assert np.array_equal(k[key], (s[key] * 255).astype(np.uint8) / np.float32(255))
        assert np.array_equal(k["gt_disp"], np.clip(s["gt_disp"] * 256, 0, 65535)
                              .astype(np.uint16) / np.float32(256))
        n = int(s["gt_valid"].sum())
        assert np.array_equal(k["gt_masks"][:n], s["gt_masks"][s["gt_valid"]] != 0)


@pytest.mark.parametrize("split,training", [("train", True), ("val", False)])
def test_kitti_dataset_matches_jax(trees, split, training):
    port, _ = trees
    kw = dict(category="car", max_gt=6, max_det=6, training=training, shape_prior_base="vob")
    got, want = KittiStereoDataset(port, split, **kw), JKitti(port, split, **kw)
    assert got.ids == want.ids and len(got) > 0
    assert got.image_sizes() == want.image_sizes() == [(320, 96)] * len(got)
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for key in w:
            if key == "calib":
                assert all(np.array_equal(g[key][c], w[key][c]) for c in w[key])
            else:
                assert np.array_equal(np.asarray(g[key]), np.asarray(w[key])), key
                assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key


def test_image_sizes_raise_on_a_missing_image(trees, tmp_path):
    port, _ = trees
    ds = KittiStereoDataset(port, "val", shape_prior_base="vob", training=False)
    ds.ids = ds.ids + ["999999"]
    with pytest.raises(FileNotFoundError):
        ds.image_sizes()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    base = tmp_path_factory.mktemp("ap")
    gt, det = str(base / "gt"), str(base / "det")
    os.makedirs(gt)
    os.makedirs(det)
    _gen_scenes(gt, det)
    return base, gt, det


def test_native_evaluator_matches_python(scenes):
    base, gt, det = scenes
    native = kitti_eval.evaluate_kitti(gt, det, str(base / "native"))
    python = kitti_eval.evaluate_kitti(gt, det, str(base / "python"), use_native=False)
    assert set(native) == set(python) == {0.7, 0.5}
    for thr, sub in ((0.7, "eval_07"), (0.5, "eval_05")):
        names = sorted(os.listdir(base / "python" / sub))
        assert sorted(os.listdir(base / "native" / sub)) == names and len(names) == 4
        for name in names:
            c = np.loadtxt(base / "native" / sub / name)
            p = np.loadtxt(base / "python" / sub / name)
            assert c.shape == p.shape == (3, 41)
            np.testing.assert_allclose(c, p, rtol=0, atol=1e-6, err_msg=name)
        assert native[thr] == kitti_eval.read_stats(str(base / "native" / sub), "Car")
        assert set(native[thr]) == set(python[thr])
        for kind in python[thr]:
            np.testing.assert_allclose(native[thr][kind], python[thr][kind], rtol=0, atol=1e-4)
        assert any(v > 5 for v in native[thr]["image"])


def test_native_and_python_split_an_exact_tie(tmp_path):
    """Record (ROADMAP C32): a BEV overlap that equals the threshold in exact
    arithmetic. Two axis-aligned cars 0.65 m apart in x and 0.32 m in z
    overlap 3.25 x 1.28 = 4.16 m^2 of a 8.32 m^2 union: IoU 0.5. The Python
    evaluator's polygon area comes out a few ulps above (0.5 + 1.5e-14), a
    match at 0.5; the native one's does not, so their BEV curves part. When
    this test's first assert fails, the two agree at the tie."""
    gt, det = tmp_path / "gt", tmp_path / "det"
    gt.mkdir()
    det.mkdir()
    (gt / "000000.txt").write_text(
        "Car 0.00 0 0.00 100.00 100.00 200.00 180.00 1.50 1.60 3.90 25.54 -2.39 16.23 0.00\n")
    (det / "000000.txt").write_text(
        "Car -1 -1 0.00 100.00 100.00 200.00 180.00 1.50 1.60 3.90 26.19 -2.67 16.55 0.00 "
        "0.9\n")
    native = kitti_eval.evaluate_kitti(str(gt), str(det), str(tmp_path / "n"), (0.5,))
    python = kitti_eval.evaluate_kitti(str(gt), str(det), str(tmp_path / "p"), (0.5,),
                                       use_native=False)
    assert python[0.5]["ground"][0] > 0 and native[0.5]["ground"] == [0.0] * 3
    assert native[0.5]["image"] == python[0.5]["image"] and native[0.5]["image"][0] > 0


def test_native_evaluator_raises_without_a_build(tmp_path, monkeypatch):
    src = (REPO / "disprcnn_tpu_torch" / "csrc" / "kitti_ap.cpp").read_text()
    assert src == (REPO / "csrc" / "kitti_ap.cpp").read_text()  # a copy of the root's
    (tmp_path / "kitti_ap.cpp").write_text(src)
    monkeypatch.setattr(kitti_eval, "CSRC", tmp_path)
    monkeypatch.setattr(kitti_eval.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        kitti_eval.evaluate_kitti(str(tmp_path), str(tmp_path), str(tmp_path / "o"))
    monkeypatch.undo()
    (tmp_path / "kitti_ap.cpp").write_text(src + "\nthis is not C++;\n")
    monkeypatch.setattr(kitti_eval, "CSRC", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        kitti_eval.evaluate_kitti(str(tmp_path), str(tmp_path), str(tmp_path / "o"))
    assert not list((tmp_path / "build").glob("kitti_ap-*"))


PORT_SCRIPTS = sorted((REPO / "disprcnn_tpu_torch" / "scripts").rglob("*.sh"))


def _commands(text: str) -> list:
    """The script's command lines, continuations joined, comments dropped."""
    text = re.sub(r"\\\n\s*", " ", text)
    return [line.strip() for line in text.splitlines() if line.strip()
            and not line.lstrip().startswith("#")]


def test_every_root_script_has_a_port_twin():
    root = sorted(p.relative_to(REPO) for p in (REPO / "scripts").rglob("*.sh"))
    assert [p.relative_to(REPO / "disprcnn_tpu_torch") for p in PORT_SCRIPTS] == root
    assert len(root) == 30


@pytest.mark.parametrize("script", PORT_SCRIPTS, ids=lambda p: str(p.relative_to(REPO)))
def test_recipe_script_is_its_root_twin_on_the_port(script):
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    assert os.access(script, os.X_OK)
    twin = REPO / script.relative_to(REPO / "disprcnn_tpu_torch")
    got, want = _commands(script.read_text()), _commands(twin.read_text())
    calls = [c for c in got if c.startswith("python")]
    assert calls and all(re.match(r"python -m disprcnn_tpu_torch\.tools\.(test|train)_net ", c)
                         for c in calls), calls
    # back on the root's tools and one directory up, the lines are the root's
    back = [re.sub(r"python -m disprcnn_tpu_torch\.tools\.(\w+)", r"python tools/\1.py", c)
            .replace('cd "$(dirname "$0")/..', 'cd "$(dirname "$0")', 1) for c in got]
    assert back == want
