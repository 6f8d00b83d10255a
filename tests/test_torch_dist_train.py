"""The port's data-parallel training on the CPU: tools/train_net.py on two
ranks (gloo, one subprocess each, tests/torch_dist_worker.py) at 1 pair a
rank against one process at the global batch of 2 pairs, from the same
seeded weights, for the four stages of the recipe at the test size of
tests/torch_train_helpers.py (mask.yaml as tests/test_torch_train_entry_
mask.py cuts it). No random transform runs (no resize, no flip), so both
runs see the same pairs; the model's draws are the global batch's on
either side (parallel/mesh.py::shard_batch).

The two stages with train-mode BatchNorm (idispnet.yaml's iDispNet,
rpn.yaml's PointNet++ and heads) run in float64 on both sides: in float32
the moments' sums take another order over two ranks than over one batch,
which flips the odd ReLU (ROADMAP C19: one iDispNet tensor moved by 1.4e-2
relative L2) and, on the deep clouds of a random iDispNet, cancels in
E[x^2] - E[x]^2 (C26: rpn.yaml's cls loss 1.9e-5 apart), and the
comparison would measure that instead of the step's semantics. mask.yaml
and rcnn.yaml (no train BN) run in float32.

Tolerances: the first iteration's losses within 1e-5 relative, the second
(after one update) within 1e-4; the first step's gradients in C19's L2
form (per tensor relative L2 1e-2 and max |diff| 5e-2 * max |one|, all
tensors together 5e-3); BN's running statistics after the first step
within 1e-6 relative L2 per tensor; the final parameters in C19's form;
the two ranks' final state bit-equal, rank 0's checkpoint equal to it.
A control takes train BN's cross-rank gradient terms out (its forward
unchanged): its idispnet.yaml gradients must fail C19's form.
"""
import numpy as np
import pytest
import torch

from disprcnn_tpu_torch.utils.checkpoint import Checkpointer
from test_torch_train_entry_mask import MASK_TRAIN
from torch_dist_helpers import run_ranks, train_stage
from torch_eval_helpers import MASK_HW
from torch_train_helpers import DATASET, HW, TINY_TRAIN, torch_one_thread  # noqa: F401

ITERS = 2
STAGES = {  # opts, dataset, hw, dtype
    "mask": (MASK_TRAIN, "synthetic_4", MASK_HW, "float32"),
    "idispnet": (TINY_TRAIN, DATASET, HW, "float64"),
    "rpn": (TINY_TRAIN, DATASET, HW, "float64"),
    "rcnn": (TINY_TRAIN + ["MODEL.POINTRCNN.RCNN.ROI_PER_IMAGE", "4"], DATASET, HW, "float32"),
}


def run_args(stage, out_dir):
    opts, dataset, hw, dtype = STAGES[stage]
    return dict(stage=stage, opts=opts, out_dir=str(out_dir), dataset=dataset, hw=list(hw),
                max_iter=ITERS, dtype=dtype)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' runs of the four stages, in one process group."""
    tmp = tmp_path_factory.mktemp("dist_train")
    ranks = run_ranks("train", {"runs": [run_args(s, tmp / s) for s in STAGES]}, tmp)
    return {s: [r[i] for r in ranks] for i, s in enumerate(STAGES)}


def c19_fails(got: dict, want: dict):
    """The tensors outside C19's per-tensor L2 form, and the relative L2
    distance over all tensors."""
    bad, num, den = [], 0.0, 0.0
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        d2, w2 = float(((g - w) ** 2).sum()), float((w ** 2).sum())
        if not (torch.isfinite(g).all() and np.sqrt(d2) <= 1e-2 * np.sqrt(w2) + 1e-12
                and float((g - w).abs().max()) <= 5e-2 * float(w.abs().max()) + 1e-12):
            bad.append(k)
        num, den = num + d2, den + w2
    return bad, np.sqrt(num / max(den, 1e-30))


@pytest.mark.usefixtures("torch_one_thread")
@pytest.mark.parametrize("stage", list(STAGES))
def test_two_ranks_equal_one_process_at_the_global_batch(stage, two_ranks, tmp_path):
    r0, r1 = two_ranks[stage]
    one = train_stage(**run_args(stage, tmp_path))
    assert (r0["world"], r0["rank"], r1["rank"], r0["ims_per_rank"]) == (2, 0, 1, 1)
    assert (one["world"], one["ims_per_rank"]) == (1, 2)
    for it, ((i0, m0), (i1, m1), (io, mo)) in enumerate(zip(r0["metrics"], r1["metrics"],
                                                            one["metrics"])):
        assert i0 == i1 == io == it and m0 == m1  # the ranks log the summed metrics
        assert m0["skipped_nonfinite"] == mo["skipped_nonfinite"] == 0
        losses = [k for k in mo if k.startswith("loss")]
        assert sorted(losses) == sorted(k for k in m0 if k.startswith("loss"))
        for k in losses:
            np.testing.assert_allclose(m0[k], mo[k], rtol=1e-5 if it == 0 else 1e-4,
                                       atol=1e-12, err_msg=(stage, it, k))
    assert sorted(r0["grads"]) == sorted(one["grads"]) and one["grads"]
    bad, together = c19_fails(r0["grads"], one["grads"])
    assert not bad and together <= 5e-3, (stage, bad, together)
    stats = [k for k in one["buffers"] if k.endswith(("running_mean", "running_var"))]
    for k in stats:
        g, w = r0["buffers"][k].double(), one["buffers"][k].double()
        assert float((g - w).norm()) <= 1e-6 * float(w.norm()) + 1e-12, (stage, k)
    params = [k for k in one["grads"]]
    bad, together = c19_fails({k: r0["state"][k] for k in params},
                              {k: one["state"][k] for k in params})
    assert not bad and together <= 5e-3, (stage, bad, together)
    # the ranks end bit-equal; rank 0's checkpoint holds that state
    assert all(torch.equal(r0["state"][k], v) for k, v in r1["state"].items())
    saved = Checkpointer(r0["ckpt_dir"]).read()
    assert saved["step"] == ITERS and Checkpointer(r0["ckpt_dir"]).steps() == [ITERS]
    assert all(torch.equal(saved["model"][k], v) for k, v in r0["state"].items())


def test_control_without_cross_rank_bn_gradient_fails(two_ranks, tmp_path):
    """idispnet.yaml's train BN with the forward's global moments but a
    gradient that misses the other rank's terms: the losses still agree,
    the gradients leave C19's form."""
    (r0,), _ = run_ranks("train", {"runs": [run_args("idispnet", tmp_path / "run")],
                                   "control": "bn_local_grad"}, tmp_path)
    good = two_ranks["idispnet"][0]
    assert r0["metrics"][0][1]["loss_psm"] == pytest.approx(good["metrics"][0][1]["loss_psm"],
                                                            rel=1e-9)
    bad, together = c19_fails(r0["grads"], good["grads"])
    assert bad and together > 5e-3, together
