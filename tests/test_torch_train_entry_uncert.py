"""tools/train_net with SOLVER.UNCERT_LOSS_WEIGHT at test size on the CPU:
rcnn.yaml with the RPN and the RCNN trained in one step (RPN.FIXED False,
SOLVER.FIX_POINTRCNN_RPN False) and 3 learned loss weights, run for 1
iteration and resumed for a second, against the same 2 iterations in one
run: the weights, the learned loss weights u with their optimizer, and
the model's draws continue exactly (bit-equal); the TensorBoard scalars
uncert0..2 are written. The weights' own arithmetic is held to JAX's in
test_torch_a7_settings.py; this file checks the entry point's wiring, so
everything here is exact.

A resumed run's loader starts its index stream again at the first epoch,
as the JAX package's loader does (ROADMAP C37): the runs here read one
scene a batch from a dataset of one (synthetic3d_1), so that every
batch is the same and the resumed run's first is the uninterrupted
run's second. The cut: 1 pair a batch and 4 RCNN ROIs an instance.
"""
import numpy as np
import torch

from disprcnn_tpu_torch.utils import tb
from disprcnn_tpu_torch.utils.checkpoint import Checkpointer
from torch_train_helpers import TINY_TRAIN, check_stage, port_train
from torch_train_helpers import torch_one_thread  # noqa: F401  (fixture)

# LOAD_OPTIMIZER: a resumed run takes the saved optimizer; a constant rate,
# so that a 1-iteration run's schedule is the 2-iteration run's
UNCERT = TINY_TRAIN + ["MODEL.POINTRCNN.RPN.FIXED", "False", "SOLVER.FIX_POINTRCNN_RPN", "False",
                       "SOLVER.UNCERT_LOSS_WEIGHT", "3", "SOLVER.LOAD_OPTIMIZER", "True",
                       "SOLVER.SCHEDULER", "ConstantScheduler", "MODEL.WEIGHT", "",
                       "SOLVER.IMS_PER_BATCH", "1", "MODEL.POINTRCNN.RCNN.ROI_PER_IMAGE", "4"]
DATASET = "synthetic3d_1"


def test_uncert_loss_weights_train_and_resume_exactly(tmp_path, torch_one_thread):
    whole = port_train("rcnn", UNCERT, tmp_path / "whole", max_iter=2, dataset=DATASET)
    part = port_train("rcnn", UNCERT, tmp_path / "part", max_iter=1, dataset=DATASET)
    check_stage(whole, {})
    assert part["uncert"].count == 1 and part["uncert"].u.shape == (3,)
    saved = Checkpointer(part["ckpt_dir"]).read()
    assert saved["uncert"]["count"] == 1 and saved["generator"]["device"] == "cpu"
    assert torch.equal(saved["uncert"]["u"], part["uncert"].u.detach())
    rest = port_train("rcnn", UNCERT, tmp_path / "part", max_iter=2, dataset=DATASET)
    assert rest["start_iter"] == 1 and rest["iters"] == 1
    for k in ("loss_rpn_cls", "loss_rpn_reg", "loss_box3d", "loss_total"):
        assert rest["metrics"][0][1][k] == whole["metrics"][1][1][k], k
    a, b = whole["model"].state_dict(), rest["model"].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    moved = [k for k in a if k.startswith("pointrcnn.rpn.") and "running" not in k
             and not torch.equal(a[k], part["model"].state_dict()[k])]
    assert moved  # the RPN trains
    for run in (whole, rest):
        assert run["uncert"].count == 2
    assert torch.equal(whole["uncert"].u, rest["uncert"].u)
    assert not torch.equal(whole["uncert"].u.detach(), torch.full((3,), -1.0))
    sa, sb = (r["uncert"].sgd.state_dict()["state"][0]["momentum_buffer"] for r in (whole, rest))
    assert torch.equal(sa, sb)
    scalars = tb.read_scalars(next((tmp_path / "whole" / "tb").iterdir()).as_posix())
    last = scalars[-1][1]
    np.testing.assert_array_equal([last[f"uncert{i}"] for i in range(3)],
                                  whole["uncert"].u.detach().numpy())
