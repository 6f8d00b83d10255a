"""The iDispNet stage's train step (configs/kitti/car/vob/idispnet.yaml,
TRAIN_PSM) at its default TPU.COMPUTE_DTYPE bfloat16 (ROADMAP A8.4) against
the JAX package's bf16 step on the CPU, at test_torch_train.py's size (one
pair, 3 detections, 64^2 crops at +-16, one hourglass): the same weights,
batch and optimizer (SGD with OneCycle), JAX's DispRCNN3D(dtype=bfloat16)
with its Pallas kernels in interpret mode (_FORCE_INTERPRET) and its
cost-volume conv on its train route (the float32 decomposition, which the
real geometry takes: DISPRCNN_CVDEC_MIN_WD), run op by op as its source
rounds (jitted, XLA drops some of the roundings: ROADMAP C42); and the
build that train_net makes of idispnet.yaml.

Tolerances (tests/torch_bf16_helpers.py says why a bf16 step is held by
its distance from the float32 step of the same weights, draws and batch,
here the port's float32 step, itself within 2.3e-3 of JAX's in C19's form,
test_torch_train.py): the port's bf16 step's distance from it within a
factor STEP_BAND of JAX's bf16 step's on either side, for the gradients
(relative L2 over all tensors) and the BatchNorm running statistics; each
loss's within LOSS_BAND; at least TENSOR_SHARE of the tensors' own
distances within STEP_BAND of JAX's. The control: the port's float32 step,
held to the same band, must fail it.
"""
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as f32t
from disprcnn_tpu.engine import trainer as jtrainer
from disprcnn_tpu.models.detector import disprcnn3d as j3d
from disprcnn_tpu.models.psmnet import psmnet as jpsm
from disprcnn_tpu.solver import build as jbuild
from disprcnn_tpu.solver import schedules as jsched
from disprcnn_tpu.structures.stereo import StereoBoxes as JStereoBoxes
from disprcnn_tpu_torch.config import get_default_cfg
from disprcnn_tpu_torch.engine.trainer import make_train_step
from disprcnn_tpu_torch.models import build as tbuild
from disprcnn_tpu_torch.models.detector import disprcnn3d as t3d
from disprcnn_tpu_torch.solver import build as tsolver
from disprcnn_tpu_torch.solver import schedules as tsched
from disprcnn_tpu_torch.structures.stereo import StereoBoxes
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from torch_bf16_helpers import distances, in_band, report
from torch_eval_helpers import REPO
from torch_port_helpers import draw_variables
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

BF16 = torch.bfloat16
STEP_BAND = 1.5
LOSS_BAND = 3.0
TENSOR_SHARE = 0.9
MODEL = f32t.PSM_MODEL


def jax_step(v, batch, dtype):
    """JAX's make_train_step on the stage, op by op, at `dtype`, its
    kernels in interpret mode -> the losses, the gradients (the momentum
    trace after the first update, less weight decay) and the running
    statistics, as the port's state_dict names them."""
    jm = j3d.DispRCNN3D(**MODEL, det3d_on=False, dtype=dtype)
    cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(**f32t.SOLVER))
    sched = jsched.one_cycle(f32t.BASE_LR, f32t.MAX_ITER)
    tx = jbuild.make_optimizer(cfg, v["params"], sched,
                               momentum_schedule=jsched.one_cycle_momentum(f32t.MAX_ITER))
    step = jtrainer.make_train_step(jm, tx, apply_kwargs=dict(train_psm=True, train_pc=False))
    try:
        jpsm._FORCE_INTERPRET = True
        new_state, metrics = step(jtrainer.create_train_state(jm, tx, v), batch,
                                  jax.random.PRNGKey(0))
    finally:
        jpsm._FORCE_INTERPRET = False
    tm = t3d.DispRCNN3D(**MODEL, device="cpu")
    trace = state_dict_from_jax(tm, {"params": f32t.jax_trace(new_state.opt_state,
                                                               new_state.params),
                                     "batch_stats": v["batch_stats"]})
    old = state_dict_from_jax(tm, v)
    grads = {n: trace[n].numpy() - (0.0 if n.endswith(".bias") else 1e-4) * old[n].numpy()
             for n, _ in tm.named_parameters()}
    stats = state_dict_from_jax(tm, {"params": v["params"], "batch_stats": new_state.batch_stats})
    return {"loss": {"loss_psm": float(metrics["loss_psm"])}, "grads": grads,
            "stats": {n: stats[n].numpy() for n, _ in tm.named_buffers() if "running" in n}}


def port_step(v, tdets, raw, gt_disp, dtype):
    """The port's TrainStep on the stage at `dtype` -> as jax_step."""
    tm = load_jax_variables(t3d.DispRCNN3D(**MODEL, device="cpu", dtype=dtype), v)
    opt = tsolver.make_optimizer(tm, tsched.one_cycle(f32t.BASE_LR, f32t.MAX_ITER),
                                 tsched.one_cycle_momentum(f32t.MAX_ITER), momentum=0.9,
                                 weight_decay=1e-4, weight_decay_bias=0.0, bias_lr_factor=2.0)
    step = make_train_step(tm, opt, forward_kwargs=dict(train_psm=True))
    got = step(dict(left_img=torch.from_numpy(raw[0]), right_img=torch.from_numpy(raw[1]),
                    dets=tdets, gt_disp=torch.from_numpy(gt_disp)))
    assert float(got["skipped_nonfinite"]) == 0 and int(got["params_without_grad"]) == 0
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert all(g.dtype == np.float32 for g in grads.values())
    return {"loss": {"loss_psm": float(got["loss_psm"])}, "grads": grads,
            "stats": {n: b.numpy() for n, b in tm.named_buffers() if "running" in n}}


@pytest.fixture(scope="module")
def psm_steps():
    """JAX's bf16 step and the port's bf16 and float32 steps from the same
    numpy-drawn weights, on test_torch_train.psm_batch."""
    left, right, score, mask, raw, gt_disp = f32t.psm_batch()
    jd = JStereoBoxes(left=jnp.asarray(left), right=jnp.asarray(right),
                      score=jnp.asarray(score), valid=jnp.ones((1, 3), bool),
                      fields={"mask": jnp.asarray(mask)})
    calib = {k: jnp.ones((1,)) for k in t3d.CALIB_KEYS}
    v = draw_variables(j3d.DispRCNN3D(**MODEL, det3d_on=False), jnp.asarray(raw[0]),
                       jnp.asarray(raw[1]), jd, calib, seed=7, train=False)
    batch = dict(left_img=jnp.asarray(raw[0]), right_img=jnp.asarray(raw[1]), dets=jd,
                 calib=calib, gt_disp=jnp.asarray(gt_disp))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DISPRCNN_CVDEC_MIN_WD", "1")  # the float32 decomposition, as at 224^2
        jbf = jax_step(v, batch, jnp.bfloat16)
    tdets = StereoBoxes(left=torch.from_numpy(left), right=torch.from_numpy(right),
                        score=torch.from_numpy(score), valid=torch.ones(1, 3, dtype=torch.bool),
                        fields={"mask": torch.from_numpy(mask)})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pbf = port_step(v, tdets, raw, gt_disp, BF16)
        p32 = port_step(v, tdets, raw, gt_disp, torch.float32)
    finally:
        torch.set_num_threads(n)
    return dict(jax=jbf, port=pbf, f32=p32)


def test_psm_bf16_step_as_far_from_float32_as_jax(psm_steps):
    """One bf16 TRAIN_PSM step of the port (row 8's bf16 form, Flax's and
    _PackedBN's bf16 train BN, the bf16 regression, the loss's bf16 mask
    count) against JAX's bf16 step: their distances from the float32 step
    within the band; the port's float32 step (the control) outside it."""
    s = psm_steps
    port, jax_ = distances(s["port"], s["f32"]), distances(s["jax"], s["f32"])
    print(report("iDispNet bf16 step", port, jax_))
    assert not in_band(port, jax_, STEP_BAND, LOSS_BAND, TENSOR_SHARE)
    control = distances(s["f32"], s["f32"])
    assert in_band(control, jax_, STEP_BAND, LOSS_BAND, TENSOR_SHARE)
    for k in s["port"]["stats"]:  # the running statistics stay float32
        assert s["port"]["stats"][k].dtype == np.float32, k


def test_idispnet_yaml_trains_at_bf16_and_mask_yaml_logs_its_item(caplog):
    """build_detection_model(cfg, train=True), as tools/train_net builds a
    stage, gives DispRCNN3D at bf16 on idispnet.yaml (JAX's train_net builds
    at the config's dtype) with no pending item logged; mask.yaml's DispRCNN
    trains in float32 and logs its item (A8.2, then A8.5)."""
    cfg = get_default_cfg()
    cfg.merge_from_file(str(REPO / "configs/kitti/car/vob/idispnet.yaml"))
    cfg.freeze()
    with caplog.at_level(logging.INFO, logger="disprcnn_tpu_torch.models.build"):
        m = tbuild.build_detection_model(cfg, device="meta", train=True)
    assert m.idispnet.dtype == BF16 and "ROADMAP A8" not in caplog.text
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    mask = get_default_cfg()
    mask.merge_from_file(str(REPO / "configs/kitti/car/vob/mask.yaml"))
    mask.freeze()
    with caplog.at_level(logging.INFO, logger="disprcnn_tpu_torch.models.build"):
        tbuild.build_detection_model(mask, device="meta", train=True)
    assert "DispRCNN trains in float32" in caplog.text and "A8.2, then A8.5" in caplog.text
