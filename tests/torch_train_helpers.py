"""The port's train entry point (tools/train_net.py) driven in-process at
test size, for tests/test_torch_train_entry_*.py: the stage configs cut as
tests/torch_eval_helpers.py cuts rcnn.yaml (TINY_RCNN: 4 detection slots,
32^2 ROIs at +-16, clouds of 128 points, 8 proposals an instance), without
the resize (ROADMAP C29), 2 pairs a batch and 2 iterations, and the checks
each stage's run must pass."""
import numpy as np
import pytest
import torch

from disprcnn_tpu_torch.tools import train_net as trn
from disprcnn_tpu_torch.utils.checkpoint import Checkpointer
from torch_eval_helpers import REPO, TINY_RCNN

HW = (192, 640)
DATASET = "synthetic3d_4"
TINY_TRAIN = TINY_RCNN + ["INPUT.DO_RESIZE", "False", "SOLVER.IMS_PER_BATCH", "2",
                          "SOLVER.PRINT_INTERVAL", "1",
                          "MODEL.POINTRCNN.TRAIN.RPN_POST_NMS_TOP_N", "8"]
ITERS = 2


def yaml(stage):
    return str(REPO / "configs/kitti/car/vob" / f"{stage}.yaml")


def port_train(stage, opts, out_dir, max_iter=ITERS, model=None, dataset=DATASET, hw=HW):
    cfg = trn.load_config(yaml(stage), list(opts) + ["OUTPUT_DIR", str(out_dir)], max_iter)
    return trn.train(cfg, dataset=dataset, static_hw=hw, device="cpu", seed=3, model=model)


def check_stage(res, frozen: dict):
    """Finite losses, no skipped step, no trainable parameter without a
    gradient, the frozen entries unchanged."""
    assert len(res["metrics"]) == res["iters"] > 0
    for it, m in res["metrics"]:
        assert all(np.isfinite(v) for k, v in m.items() if k.startswith("loss")), (it, m)
        assert m["skipped_nonfinite"] == 0 and m["params_without_grad"] == 0, (it, m)
    sd = res["model"].state_dict()
    for k, v in frozen.items():
        assert torch.equal(sd[k], v), k


def check_resume(stage, opts, out_dir, first, **kw):
    """The same OUTPUT_DIR one iteration longer: the run starts at the
    saved step and saves at the new end."""
    saved = Checkpointer(first["ckpt_dir"]).read()
    res = port_train(stage, opts, out_dir, max_iter=ITERS + 1, **kw)
    assert res["start_iter"] == first["final_step"] == saved["step"] == ITERS
    assert res["iters"] == 1 and [it for it, _ in res["metrics"]] == [ITERS]
    assert res["optimizer"].count == 1  # LOAD_OPTIMIZER False: a fresh optimizer
    assert Checkpointer(res["ckpt_dir"]).steps() == [ITERS, ITERS + 1]
    return res


@pytest.fixture
def torch_one_thread():
    """PyTorch on one thread for the test: the suite runs several workers
    on the machine's cores, and a CPU-bound test whose thread pool spins
    against the other workers' took up to 10x its one-thread time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
