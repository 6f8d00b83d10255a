"""The port and chip_smoke.py load nothing of JAX, Flax, orbax, optax or
disprcnn_tpu.

Checked in a subprocess: tests/conftest.py has already imported jax in
this process. The machine with the card has no jax or flax, so one such
import anywhere in the port would stop it there.
"""
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import disprcnn_tpu_torch
for mod in pkgutil.walk_packages(disprcnn_tpu_torch.__path__, "disprcnn_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "optax")
             or (m.split(".")[0].startswith("disprcnn_tpu") and m.split(".")[0] != "disprcnn_tpu_torch"))
print("BAD", bad)
print("COUNT", sum(m.startswith("disprcnn_tpu_torch.") for m in sys.modules))
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("disprcnn_tpu_torch."))))
"""

# modules of the iDispNet and PointRCNN slices, of their train steps, of
# the bench, of the eval and train entry points, and of the distribution
# layer, the handoff tools and the profiling utilities, which chip_smoke.py
# drives on the card
SLICE_MODULES = (
    "disprcnn_tpu_torch.bench",
    "disprcnn_tpu_torch.config.defaults",
    "disprcnn_tpu_torch.config.node",
    "disprcnn_tpu_torch.data.catalog",
    "disprcnn_tpu_torch.data.datasets.concat",
    "disprcnn_tpu_torch.data.datasets.kitti_roi",
    "disprcnn_tpu_torch.data.datasets.kitti",
    "disprcnn_tpu_torch.data.datasets.synthetic",
    "disprcnn_tpu_torch.data.kitti_io",
    "disprcnn_tpu_torch.data.loader",
    "disprcnn_tpu_torch.data.transforms",
    "disprcnn_tpu_torch.data.zarr_io",
    "disprcnn_tpu_torch.engine.batching",
    "disprcnn_tpu_torch.engine.psm_trainer",
    "disprcnn_tpu_torch.evaluation.ap",
    "disprcnn_tpu_torch.evaluation.kitti_eval",
    "disprcnn_tpu_torch.models.build",
    "disprcnn_tpu_torch.tools.test_net",
    "disprcnn_tpu_torch.tools.train_idispnet",
    "disprcnn_tpu_torch.tools.train_net",
    "disprcnn_tpu_torch.utils.checkpoint",
    "disprcnn_tpu_torch.utils.logging",
    "disprcnn_tpu_torch.utils.tb",
    "disprcnn_tpu_torch.engine.inference",
    "disprcnn_tpu_torch.engine.trainer",
    "disprcnn_tpu_torch.models.detector.disprcnn3d",
    "disprcnn_tpu_torch.models.pointrcnn.bbox3d_codec",
    "disprcnn_tpu_torch.models.pointrcnn.lift",
    "disprcnn_tpu_torch.models.pointrcnn.point_rcnn",
    "disprcnn_tpu_torch.models.pointrcnn.pointnet2",
    "disprcnn_tpu_torch.models.pointrcnn.rcnn3d",
    "disprcnn_tpu_torch.models.pointrcnn.rpn3d",
    "disprcnn_tpu_torch.models.psmnet.psmnet",
    "disprcnn_tpu_torch.ops.cost_volume",
    "disprcnn_tpu_torch.ops.cuda.conv3d",
    "disprcnn_tpu_torch.ops.cuda.fp",
    "disprcnn_tpu_torch.ops.cuda.fps",
    "disprcnn_tpu_torch.ops.cuda.grouped_mlp",
    "disprcnn_tpu_torch.ops.cuda.roipool3d",
    "disprcnn_tpu_torch.ops.cuda.sa",
    "disprcnn_tpu_torch.ops.cuda.softargmin",
    "disprcnn_tpu_torch.ops.iou",
    "disprcnn_tpu_torch.ops.losses",
    "disprcnn_tpu_torch.ops.points",
    "disprcnn_tpu_torch.ops.roipool3d",
    "disprcnn_tpu_torch.solver.build",
    "disprcnn_tpu_torch.solver.schedules",
    "disprcnn_tpu_torch.structures.boxes3d",
    "disprcnn_tpu_torch.tools.bench_train",
    "disprcnn_tpu_torch.parallel.mesh",
    "disprcnn_tpu_torch.parallel.multihost",
    "disprcnn_tpu_torch.tools.generate_psmnet_input",
    "disprcnn_tpu_torch.tools.split_predictions",
    "disprcnn_tpu_torch.utils.benchmarking",
    "disprcnn_tpu_torch.utils.profiling",
)


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", _CHECK.format(repo=str(REPO))],
                         capture_output=True, text=True, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    count = int(out.stdout.split("COUNT")[1].split()[0])
    assert count >= 40  # every submodule was imported
    loaded = set(out.stdout.split("LOADED")[1].split())
    assert set(SLICE_MODULES) <= loaded, sorted(set(SLICE_MODULES) - loaded)


def test_no_import_statement_names_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|orbax|optax|disprcnn_tpu)\b")
    files = [*(REPO / "disprcnn_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert not hits, hits


# The machine with the card has no PyYAML, PIL or OpenCV: with the three
# made unimportable, the config reads a shipped YAML, the synthetic data
# goes through mask.yaml's eval transforms (the resize included) and the
# loader, and the evaluator scores GT against itself.
_BLOCKED = r"""
import importlib.abc, os, sys, tempfile
sys.path.insert(0, {repo!r})

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("yaml", "PIL", "cv2"):
            raise ImportError(f"blocked: {{name}}")

sys.meta_path.insert(0, Blocker())
from disprcnn_tpu_torch.config import get_default_cfg
from disprcnn_tpu_torch.data import catalog, loader, transforms
from disprcnn_tpu_torch.data.datasets import kitti, synthetic
from disprcnn_tpu_torch.evaluation.kitti_eval import evaluate_kitti
from disprcnn_tpu_torch.tools import test_net, train_idispnet, train_net
cfg = get_default_cfg()
cfg.merge_from_file(os.path.join({repo!r}, "configs/kitti/car/vob/mask.yaml"))
cfg.merge_from_list(["TPU.MAX_GT", "4"])
ds = catalog.resolve("synthetic_2", cfg, training=False,
                     transforms=transforms.build_transforms(cfg, is_train=False))
batch = next(iter(loader.StereoBatchLoader(ds, 2, (384, 1248), shuffle=False)))
assert batch["left"].shape == (2, 384, 1248, 3), batch["left"].shape
d = tempfile.mkdtemp()
for sub in ("gt", "pred"):
    os.makedirs(os.path.join(d, sub))
    for i in range(41):
        with open(os.path.join(d, sub, f"{{i:06d}}.txt"), "w") as f:
            f.write("Car 0 0 -10 100 100 200 180 1.5 1.6 3.9 1 1.5 20 0.1"
                    + (" 0.9" if sub == "pred" else "") + "\n")
ap = evaluate_kitti(os.path.join(d, "gt"), os.path.join(d, "pred"), d, (0.7,))
assert all(v == [100.0] * 3 for k, v in ap[0.7].items() if k != "orientation"), ap
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("yaml", "PIL", "cv2")))
"""


def test_config_and_data_load_without_yaml_pil_cv2():
    out = subprocess.run([sys.executable, "-c", _BLOCKED.format(repo=str(REPO))],
                         capture_output=True, text=True, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout
