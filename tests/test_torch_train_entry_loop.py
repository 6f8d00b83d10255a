"""The port's train entry point (tools/train_net.py) as a whole on the CPU:
idispnet.yaml's loop against one built from the JAX package's own modules
(its loader, batch converter, optimizer, schedules and make_train_step, as
tools/train_net.py composes them), at the test size of
tests/torch_train_helpers.py (synthetic3d_4 at 192x640, 2 pairs a batch,
2 iterations), from the same numpy-drawn weights.

Tolerances (float32): idispnet.yaml's losses at the first iteration
within 1e-4 relative (the inputs and weights are equal), at the second
within 1e-2 (it follows one SGD update at a rate of 0.008 with C19's
gradients: 8.1e-4 measured); the final parameters, each parameter's
update (final - initial) and the BN running statistics per tensor within
relative L2 1e-2 and max |diff| 5e-2 * max |JAX|, all together within
5e-3 (ROADMAP C19), the updates together within 5e-3 a step (the second
step's gradient is taken where the first left each side: 5.26e-3
measured over 2).
"""
import jax
import numpy as np
import pytest
import torch

from disprcnn_tpu.config import get_default_cfg as jax_default_cfg
from disprcnn_tpu.data import catalog as jcatalog
from disprcnn_tpu.data import loader as jloader
from disprcnn_tpu.data import transforms as jtransforms
from disprcnn_tpu.engine import batching as jbatching
from disprcnn_tpu.engine import trainer as jtrainer
from disprcnn_tpu.models import build as jbuild
from disprcnn_tpu.solver import build as jsolver
from disprcnn_tpu.solver import schedules as jsched
from disprcnn_tpu_torch.tools import train_net as trn
from disprcnn_tpu_torch.utils.checkpoint import Checkpointer
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from torch_port_helpers import draw_variables
from torch_train_helpers import (DATASET, HW, ITERS, TINY_TRAIN,  # noqa: F401
                                 torch_one_thread, yaml)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def jax_train_loop(stage, opts, seed):
    """tools/train_net.py's loop on the JAX package's modules, on numpy-drawn
    variables. -> (initial variables, final TrainState, each iteration's
    metrics)."""
    cfg = jax_default_cfg()
    cfg.merge_from_file(yaml(stage))
    cfg.merge_from_list(opts)
    cfg.SOLVER.MAX_ITER = ITERS
    cfg.freeze()
    ds = jcatalog.resolve_many([DATASET], cfg, training=True,
                               transforms=jtransforms.build_transforms(cfg, is_train=True))
    loader = jloader.StereoBatchLoader(
        ds, cfg.SOLVER.IMS_PER_BATCH, HW, shuffle=cfg.INPUT.SHUFFLE,
        size_divisibility=max(cfg.DATALOADER.SIZE_DIVISIBILITY, 32),
        max_iter=cfg.SOLVER.MAX_ITER, group_by_aspect=cfg.DATALOADER.ASPECT_RATIO_GROUPING)
    model = jbuild.build_detection_model(cfg)
    convert, static = jbatching.make_batch_converter(cfg)
    variables = draw_variables(model, seed=seed, train=False, **static,
                               **convert(next(iter(loader)), train=False))
    frozen = jsolver.frozen_path_prefixes(cfg)
    tx = jsolver.make_optimizer(cfg, variables["params"], jsched.make_schedule(cfg), frozen,
                                momentum_schedule=jsched.make_momentum_schedule(cfg))
    state = jtrainer.create_train_state(model, tx, variables)
    step = jax.jit(jtrainer.make_train_step(model, tx, cfg.SOLVER.DO_GRAD_CLIP,
                                            cfg.SOLVER.GRAD_CLIP, apply_kwargs=static,
                                            stop_grad_prefixes=frozen))
    metrics = []
    for batch in loader:
        state, m = step(state, convert(batch, train=True), jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return variables, state, metrics


def c19_close(got: dict, want: dict, what: str, all_tol: float = 5e-3):
    num = den = 0.0
    for k, w in want.items():
        g, w = got[k].double().numpy(), w.double().numpy()
        assert np.isfinite(g).all(), (what, k)
        d2, w2 = ((g - w) ** 2).sum(), (w ** 2).sum()
        assert np.sqrt(d2) <= 1e-2 * np.sqrt(w2) + 1e-12, (what, k, np.sqrt(d2 / max(w2, 1e-30)))
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max() + 1e-12, (what, k)
        num, den = num + d2, den + w2
    assert np.sqrt(num / max(den, 1e-30)) <= all_tol, (what, np.sqrt(num / den))


def test_idispnet_loop_matches_jax(tmp_path):
    out = tmp_path / "idispnet"
    variables, state, jmetrics = jax_train_loop("idispnet", TINY_TRAIN, seed=21)
    cfg = trn.load_config(yaml("idispnet"), TINY_TRAIN + ["OUTPUT_DIR", str(out)], ITERS)
    model = load_jax_variables(trn.build_detection_model(cfg, device="cpu"), variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    res = trn.train(cfg, dataset=DATASET, static_hw=HW, device="cpu", model=model)
    want = state_dict_from_jax(model, {"params": state.params,
                                       "batch_stats": state.batch_stats})
    assert res["start_iter"] == 0 and res["iters"] == ITERS
    assert [it for it, _ in res["metrics"]] == list(range(ITERS))
    print("loss_psm", [m["loss_psm"] for _, m in res["metrics"]],
          [m["loss_psm"] for m in jmetrics])
    for (it, got), jm in zip(res["metrics"], jmetrics):
        for k in jm:
            if k.startswith("loss"):
                np.testing.assert_allclose(got[k], jm[k], rtol=1e-4 if it == 0 else 1e-2,
                                           err_msg=(it, k))
        assert got["skipped_nonfinite"] == jm["skipped_nonfinite"] == 0
        assert got["params_without_grad"] == 0
    model = res["model"]
    sd = model.state_dict()
    params = [n for n, _ in model.named_parameters()]
    stats = [n for n in sd if n.endswith(("running_mean", "running_var"))]
    assert len(stats) > 100 and res["optimizer"].count == ITERS
    c19_close({k: sd[k] for k in params}, {k: want[k] for k in params}, "parameters")
    c19_close({k: sd[k] - before[k] for k in params}, {k: want[k] - before[k] for k in params},
              "updates", all_tol=ITERS * 5e-3)
    c19_close({k: sd[k] for k in stats}, {k: want[k] for k in stats}, "BN statistics")
    assert all(not torch.equal(sd[k], before[k]) for k in params + stats)
    saved = Checkpointer(res["ckpt_dir"]).read()
    assert saved["step"] == res["final_step"] == ITERS and saved["optimizer"]["count"] == ITERS
    assert all(torch.equal(saved["model"][k], v) for k, v in sd.items())
