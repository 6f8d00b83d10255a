"""The port's standalone iDispNet trainer (engine/psm_trainer.py) against
the JAX package's PSMTrainer on the CPU: the same PSMNet weights (JAX's
init carried over by utils/weights.py::state_dict_from_jax), 4 synthetic
32^2 crops at +-16, batches of 2, 2 epochs of Adam over OneCycle.

Held, all float32 (Adam's first steps are about the gradients' signs, so
an entry whose gradient is float32 noise near 0 moves by up to 2 lr on
one side and not the other: after one update ~0.1% of the conv weights
differ so):
- each epoch's mean loss and validation EPE within 1e-2 relative, the
  first epoch's loss (its first step before any update) within 1e-4;
- the epochs at which the best model was saved, equal, and the saved
  file bit-equal to the model it saved;
- each parameter entry within 2 * (the sum of the steps' rates) of JAX's
  (each step moves an entry by about its rate at most, on each side), all
  parameters together within relative L2 5e-3 (ROADMAP C19); their
  updates (final - initial) together within relative L2 5e-2, and at most
  1% of the entries' updates off by more than a tenth of that sum (per
  tensor C19's 1e-2 does not hold under Adam: a zero-initialised BN shift
  is its update, and one flipped entry of 32 moves it by ~1/3);
- the BN running statistics together within relative L2 5e-3, each
  tensor within 5e-2 (the means start at 0, so they are the few steps'
  batch means and carry the parameters' differences at their own small
  scale), and every one moved;
- get_preds on the validation crops: mean |diff| within 2e-2 px (the
  EPE's tolerance) and no pixel off by more than 1 px.
"""
import numpy as np
import pytest
import torch

from disprcnn_tpu.data.datasets import kitti_roi as jroi
from disprcnn_tpu.engine.psm_trainer import PSMTrainer as JPSMTrainer
from disprcnn_tpu_torch.data.datasets import kitti_roi
from disprcnn_tpu_torch.engine.psm_trainer import PSMTrainer
from disprcnn_tpu_torch.models.psmnet.psmnet import PSMNet
from disprcnn_tpu_torch.solver.schedules import one_cycle
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from torch_train_helpers import torch_one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SIZE, MAXDISP, BS, EPOCHS = 32, 16, 2, 2


def recorded(trainer, log):
    """Wrap train_epoch and validate to record what fit reads from them."""
    train_epoch, validate = trainer.train_epoch, trainer.validate

    def train_rec(*a):
        log.setdefault("loss", []).append(train_epoch(*a))
        return log["loss"][-1]

    def val_rec(*a):
        log.setdefault("epe", []).append(validate(*a))
        return log["epe"][-1]

    trainer.train_epoch, trainer.validate = train_rec, val_rec


def rel_l2(got: dict, want: dict, keys) -> tuple:
    """-> (the worst tensor's relative L2 distance, all tensors')."""
    num = den = worst = 0.0
    for k in keys:
        g, w = got[k].double().numpy(), want[k].double().numpy()
        assert np.isfinite(g).all(), k
        d2, w2 = ((g - w) ** 2).sum(), (w ** 2).sum()
        worst = max(worst, np.sqrt(d2 / max(w2, 1e-30)))
        num, den = num + d2, den + w2
    return worst, np.sqrt(num / den)


def test_psm_trainer_fit_matches_jax(tmp_path):
    train = kitti_roi.SyntheticRoiDataset(4, SIZE, MAXDISP)
    val = kitti_roi.SyntheticRoiDataset(4, SIZE, MAXDISP, seed=1)
    jtrain = jroi.SyntheticRoiDataset(4, SIZE, MAXDISP)
    jval = jroi.SyntheticRoiDataset(4, SIZE, MAXDISP, seed=1)
    jt = JPSMTrainer(MAXDISP, -MAXDISP, SIZE, 1e-3, EPOCHS, BS, str(tmp_path / "jax"))
    init = {"params": jt.params, "batch_stats": jt.batch_stats}
    model = load_jax_variables(PSMNet(MAXDISP, -MAXDISP), init)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pt = PSMTrainer(MAXDISP, -MAXDISP, SIZE, 1e-3, EPOCHS, BS, str(tmp_path / "port"),
                    device="cpu", model=model)
    jlog, plog = {}, {}
    recorded(jt, jlog)
    recorded(pt, plog)
    jbest = jt.fit(jtrain, jval, jroi.collate_roi)
    best = pt.fit(train, val, kitti_roi.collate_roi)
    for key in ("loss", "epe"):
        assert len(plog[key]) == len(jlog[key]) == EPOCHS
        np.testing.assert_allclose(plog[key], jlog[key], rtol=1e-2, err_msg=key)
    np.testing.assert_allclose(plog["loss"][0], jlog["loss"][0], rtol=1e-4)
    np.testing.assert_allclose(best, jbest, rtol=1e-2)
    assert pt.ckpt.steps() == list(jt.ckpt.mngr.all_steps())
    assert [e for e, _, _ in pt.history] == list(range(EPOCHS))
    assert pt.optimizer.count == EPOCHS * len(train) // BS
    saved = pt.ckpt.read()["model"]
    if pt.ckpt.latest_step() == EPOCHS - 1:
        assert all(torch.equal(saved[k], v) for k, v in model.state_dict().items())

    want = state_dict_from_jax(model, {"params": jt.params, "batch_stats": jt.batch_stats})
    got = model.state_dict()
    params = [n for n, _ in model.named_parameters()]
    stats = [n for n in got if n.endswith(("running_mean", "running_var"))]
    travel = sum(one_cycle(1e-3, pt.optimizer.count)(i) for i in range(pt.optimizer.count))
    worst_entry = max(float((got[k] - want[k]).abs().max()) for k in params)
    _, p_all = rel_l2(got, want, params)
    delta = lambda sd: {k: sd[k] - before[k] for k in params}
    _, u_all = rel_l2(delta(got), delta(want), params)
    s_worst, s_all = rel_l2(got, want, stats)
    off = sum(int(((got[k] - want[k]).abs() > 0.1 * travel).sum()) for k in params) / sum(
        got[k].numel() for k in params)
    print(f"parameters: worst entry {worst_entry / travel:.3g} of the rates' sum, all "
          f"{p_all:.3g}; updates: all {u_all:.3g}, {100 * off:.3g}% of the entries off by "
          f"0.1 of it; BN statistics: worst {s_worst:.3g}, all {s_all:.3g}")
    assert worst_entry <= 2 * travel and p_all <= 5e-3 and u_all <= 5e-2 and off <= 1e-2
    assert s_worst <= 5e-2 and s_all <= 5e-3
    assert all(not torch.equal(got[k], before[k]) for k in stats)
    preds = pt.get_preds(val, kitti_roi.collate_roi)
    jpreds = jt.get_preds(jval, jroi.collate_roi)
    assert preds.shape == jpreds.shape == (4, SIZE, SIZE)
    diff = np.abs(preds - jpreds)
    print(f"get_preds: mean |diff| {diff.mean():.3g} px, max {diff.max():.3g} px; losses "
          f"{plog['loss']} vs {jlog['loss']}, EPE {plog['epe']} vs {jlog['epe']}")
    assert diff.mean() <= 2e-2 and diff.max() <= 1.0
