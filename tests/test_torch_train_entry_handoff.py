"""The recipe's stage handoff through the port's train entry point
(tools/train_net.py), in-process on the CPU at the test size of
tests/torch_train_helpers.py: idispnet.yaml from seeded random weights,
rpn.yaml seeded from its checkpoint (MODEL.WEIGHT), rcnn.yaml from rpn's,
each with a resumed run, then tools/test_net.py reading rcnn's checkpoint.
idispnet.yaml's loop itself is held to the JAX package's in
tests/test_torch_train_entry_loop.py.

Held exactly: the weights a stage loads are the weights the previous one
saved, bit for bit, the entries it does not find keep their init and are
reported, the frozen prefixes stay so, the losses are finite with no
skipped step and no trainable parameter without a gradient, a resumed run
starts at the saved step, and test_net's predictions from the checkpoint
equal those of the model in memory.
"""
import os

import numpy as np
import pytest
import torch

from disprcnn_tpu_torch.tools import test_net as tn
from disprcnn_tpu_torch.utils.checkpoint import Checkpointer
from torch_eval_helpers import TINY_RCNN
from torch_train_helpers import (DATASET, HW, ITERS, TINY_TRAIN, check_resume, check_stage,
                                 port_train, torch_one_thread, yaml)  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def test_handoff_idispnet_rpn_rcnn_and_test_net(tmp_path):
    first = port_train("idispnet", TINY_TRAIN, tmp_path / "idispnet")
    check_stage(first, {})
    saved = Checkpointer(first["ckpt_dir"]).read()
    assert saved["step"] == first["final_step"] == ITERS
    assert all(torch.equal(saved["model"][k], v) for k, v in first["model"].state_dict().items())

    rpn_opts = TINY_TRAIN + ["MODEL.WEIGHT", first["ckpt_dir"]]
    rpn = port_train("rpn", rpn_opts, tmp_path / "rpn")
    sd = rpn["model"].state_dict()
    assert sorted(rpn["unmatched"]) == sorted(k for k in sd if k.startswith("pointrcnn."))
    # idispnet.* as stage 2 saved them, bit for bit (FIX_DISPARITY keeps them)
    disp = [k for k in sd if k.startswith("idispnet.")]
    assert sorted(disp) == sorted(saved["model"])
    check_stage(rpn, {k: saved["model"][k] for k in disp})
    check_resume("rpn", rpn_opts, tmp_path / "rpn", rpn)

    rpn_saved = Checkpointer(rpn["ckpt_dir"]).read()["model"]
    # rcnn.yaml's own IMS_PER_BATCH, 1 pair, and 4 RCNN ROIs an instance
    rcnn_opts = TINY_TRAIN + ["SOLVER.IMS_PER_BATCH", "1", "MODEL.POINTRCNN.RCNN.ROI_PER_IMAGE",
                              "4", "MODEL.WEIGHT", rpn["ckpt_dir"]]
    rcnn = port_train("rcnn", rcnn_opts, tmp_path / "rcnn")
    sd = rcnn["model"].state_dict()
    assert rcnn["unmatched"] and all(k.startswith("pointrcnn.rcnn") for k in rcnn["unmatched"])
    # FIX_DISPARITY and FIX_POINTRCNN_RPN: both as rpn's checkpoint holds them
    frozen = {k: rpn_saved[k] for k in sd if k.startswith(("idispnet.", "pointrcnn.rpn."))}
    assert len(frozen) > 100
    check_stage(rcnn, frozen)
    resumed = check_resume("rcnn", rcnn_opts, tmp_path / "rcnn", rcnn)
    final = resumed["model"]

    # test_net on the last checkpoint (2 pairs): the weights it loads are the
    # final model's, and so are its predictions
    run = tn.run(yaml("rcnn"), TINY_RCNN + ["OUTPUT_DIR", str(tmp_path / "eval")],
                 dataset="synthetic3d_2", static_hw=HW, device="cpu", ckpt=resumed["ckpt_dir"])
    assert run["ckpt"] == resumed["ckpt_dir"]
    for k, v in final.state_dict().items():
        assert torch.equal(run["model"].state_dict()[k], v), k
    direct = tn.run(yaml("rcnn"), TINY_RCNN + ["OUTPUT_DIR", str(tmp_path / "eval_mem")],
                    dataset="synthetic3d_2", static_hw=HW, device="cpu", model=final)
    got = run["datasets"]["synthetic3d_2"]["predictions"]
    want = direct["datasets"]["synthetic3d_2"]["predictions"]
    assert sorted(got) == sorted(want) and len(got) == 2
    for imgid in want:
        for k in want[imgid]:
            np.testing.assert_array_equal(got[imgid][k], want[imgid][k], err_msg=(imgid, k))
    # without --ckpt it reads OUTPUT_DIR/ckpt when that holds a last_checkpoint
    rcnn_dir = str(tmp_path / "rcnn")
    assert tn.run(yaml("rcnn"), TINY_RCNN + ["OUTPUT_DIR", rcnn_dir], dataset="synthetic3d_1",
                  static_hw=HW, device="cpu")["ckpt"] == os.path.join(rcnn_dir, "ckpt")
