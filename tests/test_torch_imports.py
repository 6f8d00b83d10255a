"""The port and chip_smoke.py load nothing of JAX, Flax or disprcnn_tpu.

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
             if m.split(".")[0] in ("jax", "jaxlib", "flax")
             or (m.split(".")[0].startswith("disprcnn_tpu") and m.split(".")[0] != "disprcnn_tpu_torch"))
print("BAD", bad)
print("COUNT", sum(m.startswith("disprcnn_tpu_torch.") for m in sys.modules))
print("LOADED", " ".join(sorted(m for m in sys.modules if m.startswith("disprcnn_tpu_torch."))))
"""

# modules of the iDispNet and PointRCNN slices, of their train steps and of
# the bench, which chip_smoke.py drives on the card
SLICE_MODULES = (
    "disprcnn_tpu_torch.bench",
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
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|disprcnn_tpu)\b")
    files = [*(REPO / "disprcnn_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert not hits, hits
