"""idispnet.yaml's step on two ranks held directly to the JAX package's
make_train_step at the global batch (its one SPMD step over a mesh computes
exactly that): tools/train_net.py on two gloo ranks at 1 pair a rank
(tests/torch_dist_worker.py) from the numpy-drawn weights of
tests/test_torch_train_entry_loop.py's JAX loop at 2 pairs a step, 2
iterations, float32.

Tolerances, as that test and ROADMAP C19 hold the iDispNet step:
- the losses at the first iteration within 1e-4 relative of JAX's, at the
  second within 1e-2;
- against JAX over all tensors together: the final parameters and the BN
  running statistics within relative L2 5e-3, the updates (final -
  initial parameters) within 5e-3 a step;
- per tensor, C19's form for the iDispNet step (chip_smoke.py phase 15):
  each update within twice the furthest float32 order's distance from an
  exact step, + 1e-3 of its norm. The exact step is the port's one-process
  step at the global batch in float64; the float32 orders are JAX's step
  and the port's one-process float32 step. Over two ranks the BN moments
  are summed in another order, which flips the odd ReLU (one update 1.35e-2
  relative L2 from JAX's, against C19's 1e-2 for one order);
- the BN running statistics per tensor in C19's L2 form (relative L2 1e-2,
  max |diff| 5e-2 * max |JAX|); the ranks' final states bit-equal.
"""
import numpy as np
import pytest
import torch

from disprcnn_tpu_torch.tools import train_net as trn
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from test_torch_train_entry_loop import c19_close, jax_train_loop
from torch_dist_helpers import run_ranks, train_stage
from torch_train_helpers import DATASET, HW, ITERS, TINY_TRAIN, torch_one_thread, yaml  # noqa

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def l2(a: dict, b: dict, keys) -> dict:
    return {k: float((a[k].double() - b[k].double()).norm()) for k in keys}


def together(got: dict, want: dict, keys) -> float:
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in keys)
    return np.sqrt(num / max(sum(float((want[k].double() ** 2).sum()) for k in keys), 1e-30))


def test_two_rank_idispnet_step_matches_jax_at_the_global_batch(tmp_path):
    variables, state, jmetrics = jax_train_loop("idispnet", TINY_TRAIN, seed=21)
    cfg = trn.load_config(yaml("idispnet"), TINY_TRAIN + ["OUTPUT_DIR", str(tmp_path)], ITERS)
    model = load_jax_variables(trn.build_detection_model(cfg, device="cpu"), variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(before, tmp_path / "weights.pt")
    run = dict(stage="idispnet", opts=TINY_TRAIN, dataset=DATASET, hw=list(HW), max_iter=ITERS,
               weights=str(tmp_path / "weights.pt"))
    (r0,), (r1,) = run_ranks("train", {"runs": [dict(run, out_dir=str(tmp_path / "run"))]},
                             tmp_path)
    assert r0["world"] == 2 and r0["ims_per_rank"] == 1
    for (it, got), jm in zip(r0["metrics"], jmetrics):
        for k in jm:
            if k.startswith("loss"):
                np.testing.assert_allclose(got[k], jm[k], rtol=1e-4 if it == 0 else 1e-2,
                                           err_msg=(it, k))
        assert got["skipped_nonfinite"] == jm["skipped_nonfinite"] == 0
    want = state_dict_from_jax(model, {"params": state.params, "batch_stats": state.batch_stats})
    sd = r0["state"]
    params = [n for n, _ in model.named_parameters()]
    stats = [n for n in sd if n.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100
    assert together(sd, want, params) <= 5e-3
    assert together(sd, want, stats) <= 5e-3
    upd = lambda s: {k: s[k].double() - before[k].double() for k in params}  # noqa: E731
    assert together(upd(sd), upd(want), params) <= ITERS * 5e-3
    c19_close({k: sd[k] for k in stats}, {k: want[k] for k in stats}, "BN statistics")
    # per tensor: the exact step's distance, beside the float32 orders'
    one32 = train_stage(**run, out_dir=str(tmp_path / "one32"))["state"]
    exact = upd(train_stage(**run, out_dir=str(tmp_path / "one64"), dtype="float64")["state"])
    d2 = l2(upd(sd), exact, params)
    orders = [l2(upd(want), exact, params), l2(upd(one32), exact, params)]
    norms = {k: float(exact[k].norm()) for k in params}
    worst = max(d2[k] / max(2 * max(o[k] for o in orders) + 1e-3 * norms[k], 1e-30)
                for k in params)
    print("two ranks' update per tensor, worst share of its bound:", worst)
    assert worst <= 1.0
    assert all(torch.equal(v, r1["state"][k]) for k, v in sd.items())
