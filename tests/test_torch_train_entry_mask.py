"""Stage 1 through the port's train entry point (tools/train_net.py),
in-process on the CPU: mask.yaml cut as tests/torch_eval_helpers.py cuts
it (TINY_MASK: R-50, 32 FPN channels, the box head at 64, no resize), with
the train budgets cut too (200 pre-NMS proposals into 64, 64 ROIs an
image), the pretrained weights of MODEL.WEIGHT a .pth in the reference's
2D layout (tests/torch_ckpt_writer.py) of weights drawn from a seed,
synthetic_4 at 96x320, 2 pairs a batch, 2 iterations, then a resumed run. The 2D train step itself is held
to the JAX package's in tests/test_torch_detector2d_train.py.

Held exactly: finite losses, no skipped step, no trainable parameter
without a gradient, the frozen backbone, RPN and box head (FrozenBN
constants included) bit-equal to their init, the mask head moved, the
checkpoint bit-equal to the model, a resumed run starting at the saved
step; every entry of the model filled from the .pth; and the shipped
MODEL.WEIGHT, whose file is not in the repo, refused by name.
"""
import pytest
import torch

from disprcnn_tpu_torch.tools import train_net as trn
from disprcnn_tpu_torch.utils.checkpoint import Checkpointer
import torch_ckpt_writer as W
from torch_eval_helpers import MASK_HW, TINY_MASK
from torch_train_helpers import (check_resume, check_stage, port_train,  # noqa: F401
                                 torch_one_thread, yaml)

MASK_TRAIN = TINY_MASK + ["MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "200",
                          "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "64",
                          "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
                          "SOLVER.IMS_PER_BATCH", "2", "SOLVER.PRINT_INTERVAL", "1",
                          "MODEL.WEIGHT", ""]
FROZEN = ("backbone.", "rpn_head.", "box_extractor.", "box_predictor.")
pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_mask_stage_trains_and_resumes(tmp_path):
    kw = dict(dataset="synthetic_4", hw=MASK_HW)
    with pytest.raises(FileNotFoundError, match="srcnn_pretrained_2d_mrcnn_format.pth"):
        port_train("mask", MASK_TRAIN[:-2], tmp_path / "pth", **kw)  # the shipped WEIGHT
    # the pretrained detector: weights drawn from seed 9 (train_net draws
    # its own from 3), written in the reference's layout
    cfg = trn.load_config(yaml("mask"), MASK_TRAIN, 2)
    model = trn.init_random_(trn.build_detection_model(cfg, device="cpu"),
                             torch.Generator().manual_seed(9))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pth = W.write_pth(str(tmp_path / "mrcnn.pth"), W.reference_2d(before))
    opts = MASK_TRAIN[:-2] + ["MODEL.WEIGHT", pth]
    res = port_train("mask", opts, tmp_path / "mask", **kw)
    assert res["unmatched"] == []
    sd = res["model"].state_dict()
    frozen = {k: v for k, v in before.items() if k.startswith(FROZEN)}
    assert any("bn1.running_var" in k for k in frozen)
    check_stage(res, frozen)
    assert res["metrics"][-1][1]["loss_mask"] > 0
    mask_head = [k for k in sd if k.startswith("mask_head.")]
    assert mask_head and all(not torch.equal(sd[k], before[k]) for k in mask_head)
    saved = Checkpointer(res["ckpt_dir"]).read()["model"]
    assert all(torch.equal(saved[k], v) for k, v in sd.items())
    check_resume("mask", opts, tmp_path / "mask", res, **kw)
