"""The 3D stages' train steps at TPU.COMPUTE_DTYPE bfloat16 (ROADMAP A8.4)
against the JAX package's bf16 steps on the CPU, from the lifted clouds on
(the frozen iDispNet and the lift are float32 functions of the crops'
disparity that the port's other tests hold): at 2 clouds of 128 points and
the SA ladder 128/64/32/16,
- rpn.yaml's step (the RPN trains; RCNN off): JAX's PointRCNN(dtype=
  bfloat16) in train mode with its dropout masks recorded, the port's on
  the same clouds, ground truth and masks: the two RPN losses, every RPN
  gradient and the RPN's BatchNorm running statistics after the step;
- rcnn.yaml's step (the RCNN on a fixed RPN): the RCNN's loss and every
  RCNN gradient on the RCNN inputs and labels of JAX's proposal target
  layer (its RPN in eval, a proposal's pooling and sampling: the port's
  own are held to JAX's in tests/test_torch_rcnn_train.py); its BN-free SA
  scales take row 11's bf16 train form;
JAX's Pallas kernels in interpret mode (_FORCE_INTERPRET), jitted with
XLA's excess precision off, so that each bf16 value rounds where its
source rounds it (with it on, XLA drops roundings: ROADMAP C42; op by op,
the RPN step alone takes ~110 s). Also the SA-off route of a bf16 rcnn.yaml
PointRCNN (row 12's bf16 form on the CPU) against JAX's bf16 model with
DISPRCNN_PALLAS_DISABLE=sa, and the stage handoff: a stage-3 checkpoint of
a bf16 model loads into stage 4 at bf16 and at float32.

Tolerances: the steps in tests/torch_bf16_helpers.py's band form (each
step's distance from the port's float32 step of the same weights, inputs
and draws; the port's bf16 step's within a factor STEP_BAND of JAX's on
either side, the losses' within LOSS_BAND, TENSOR_SHARE of the tensors'
within STEP_BAND), with the port's float32 step as the control that must
fail; the RCNN step's gradients also directly, within RCNN_DIRECT of the
float32 step's distance from JAX's bf16 step (a BN-free network on shared
inputs keeps its roundings close: measured 2.3e-3 against 4.0e-2); the
SA-off forward as test_torch_bf16_pointrcnn.py holds the SA-on route: the
port's RPN features and head outputs no further from the port's float32
run than 1.25 times JAX's + 1e-3 of the float32 mean |x|.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.pointrcnn import point_rcnn as jpr
from disprcnn_tpu.models.pointrcnn import pointnet2 as jpn2
from disprcnn_tpu.models.pointrcnn import rcnn3d as jrcnn
from disprcnn_tpu_torch.config import get_default_cfg
from disprcnn_tpu_torch.models import build as tbuild
from disprcnn_tpu_torch.models.pointrcnn import point_rcnn as tpr
from disprcnn_tpu_torch.models.pointrcnn import rpn3d as trpn
from disprcnn_tpu_torch.ops.cuda import grouped_mlp as tgm
from disprcnn_tpu_torch.tools.bench_train import boxes_on_clouds
from disprcnn_tpu_torch.utils.checkpoint import Checkpointer, load_stage_weights
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from torch_bf16_helpers import distances, in_band, report
from torch_eval_helpers import REPO
from torch_port_helpers import draw_variables
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

BF16 = torch.bfloat16
R, N = 2, 128
SA_NPOINTS = (128, 64, 32, 16)
STEP_BAND = 1.5
LOSS_BAND = 3.0
TENSOR_SHARE = 0.8
# the RCNN step's gradients against JAX's bf16 step's: within this share of
# the float32 step's distance from JAX's
RCNN_DIRECT = 0.25
RCNN_MODEL = dict(npoints=N, sa_npoints=SA_NPOINTS, rpn_pre_nms_per_roi_train=64,
                  proposals_per_roi_train=16, rcnn_rois_per_instance=4,
                  rpn_nms_thresh_train=0.85)


def t(x):
    return torch.from_numpy(np.array(x))


def clouds():
    """Two canonical car-sized clouds, their angles and means, and a GT box
    on each (bench_train.boxes_on_clouds: points inside, in the 0.2 band and
    outside)."""
    rng = np.random.default_rng(30)
    pts = (rng.standard_normal((R, N, 3)) * np.array([1.2, 0.5, 1.8])).astype(np.float32)
    pts[:, 7] = pts[:, 3]
    valid = np.array([True, True])
    ang = np.array([0.1, -0.3], np.float32)
    mean = (rng.standard_normal((R, 3)) * 3 + np.array([0, 1, 15])).astype(np.float32)
    gt = boxes_on_clouds(t(pts), t(ang), t(mean)).numpy()
    return pts, valid, ang, mean, gt, np.array([True, True])


def recorder(record):
    """intercept_methods: every Dropout's output by module path."""
    def icpt(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            path = "/".join(context.module.scope.path)
            jax.debug.callback(lambda o: record.__setitem__(path, np.array(o)), out)
        return out
    return icpt


def source_jit(fn, *args):
    """fn(*args) jitted with XLA's excess precision off (ROADMAP C42)."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


def jax_grads(jm, v, inputs, loss_keys, trained, record, prepare=None):
    """JAX's bf16 PointRCNN in train mode (source_jit), its kernels in
    interpret mode, the RPN fixed unless it is the `trained` subtree
    ("rpn" or "rcnn"; the others' parameters held constant, as
    make_train_step's frozen prefixes hold them): the losses, the
    gradients of the trained subtree's parameters (the rest zero), the new
    batch statistics; `prepare` replaces the proposal target layer."""
    pts, valid, ang, mean, gt, ok = (jnp.asarray(a) for a in inputs)

    def loss(sub):
        params = dict(v["params"], **{trained: sub})
        out, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, pts, valid,
                            ang, mean, train=True, gt_boxes3d=gt, gt_ok=ok,
                            rpn_fixed=trained != "rpn", sampling_key=jax.random.PRNGKey(5),
                            rngs={"dropout": jax.random.PRNGKey(6)}, mutable=["batch_stats"])
        return sum(out[k] for k in loss_keys), (out, mut)

    try:
        jpn2._FORCE_INTERPRET = True
        with fnn.intercept_methods(recorder(record)), pytest.MonkeyPatch.context() as mp:
            if prepare is not None:
                mp.setattr(jrcnn, "prepare_rcnn_train_inputs", prepare)
            g, (out, mut) = source_jit(jax.grad(loss, has_aux=True), v["params"][trained])
    finally:
        jpn2._FORCE_INTERPRET = False
    grads = dict(jax.tree_util.tree_map(np.zeros_like, v["params"]), **{trained: g})
    return grads, {k: float(out[k]) for k in loss_keys}, mut["batch_stats"]


def port_model(v, dtype, **kw):
    return load_jax_variables(tpr.PointRCNN(dtype=dtype, **kw), v)


def grads_of(tm, prefix):
    return {n: p.grad.numpy() for n, p in tm.named_parameters()
            if n.startswith(prefix) and p.grad is not None}


@pytest.fixture(scope="module")
def rpn_steps():
    """rpn.yaml's step: JAX's bf16 step; the port's bf16 and float32 steps
    on JAX's clouds, GT and dropout masks."""
    inputs = clouds()
    jm = jpr.PointRCNN(npoints=N, sa_npoints=SA_NPOINTS, rcnn_enabled=False,
                       dtype=jnp.bfloat16)
    v = draw_variables(jm, *(jnp.asarray(a) for a in inputs[:4]), seed=31, train=False)
    record = {}
    jg, jl, jstats = jax_grads(jm, v, inputs, ("loss_rpn_cls", "loss_rpn_reg"), "rpn", record)
    keep = {h: record[f"rpn/{h}/Dropout_0"] != 0 for h in ("cls_head", "reg_head")}
    draws = trpn.RPNDraws(cls_keep=t(keep["cls_head"]), reg_keep=t(keep["reg_head"]))
    tm32 = port_model(v, torch.float32, npoints=N, sa_npoints=SA_NPOINTS, rcnn_enabled=False)
    ref = {"grads": {n: g.numpy() for n, g in state_dict_from_jax(
        tm32, {"params": jg, "batch_stats": v["batch_stats"]}).items()
        if n in dict(tm32.named_parameters())},
        "stats": {n: s.numpy() for n, s in state_dict_from_jax(
            tm32, {"params": v["params"], "batch_stats": jstats}).items() if "running" in n},
        "loss": jl}
    steps = {"jax": ref}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, dt in (("port", BF16), ("f32", torch.float32)):
            tm = port_model(v, dt, npoints=N, sa_npoints=SA_NPOINTS, rcnn_enabled=False).train()
            out = tm(*(t(a) for a in inputs), None, draws)
            (out["loss_rpn_cls"] + out["loss_rpn_reg"]).backward()
            steps[name] = {"grads": grads_of(tm, "rpn."),
                           "stats": {k: b.numpy() for k, b in tm.named_buffers()
                                     if "running" in k},
                           "loss": {k: float(out[k].detach()) for k in jl}}
    finally:
        torch.set_num_threads(n)
    return steps


def test_rpn_bf16_step_as_far_from_float32_as_jax(rpn_steps):
    """rpn.yaml's step at bf16 (the RPN's train BN on the plain grouped
    route at Flax's bf16 rounding points, the heads' dropout, the bf16 RPN
    losses) against JAX's bf16 step, in the band form; the port's float32
    step fails it (the control)."""
    s = rpn_steps
    assert set(s["port"]["grads"]) == set(s["jax"]["grads"]) and len(s["jax"]["grads"]) > 50
    port, jax_ = distances(s["port"], s["f32"]), distances(s["jax"], s["f32"])
    print(report("RPN bf16 step", port, jax_))
    assert not in_band(port, jax_, STEP_BAND, LOSS_BAND, TENSOR_SHARE)
    assert in_band(distances(s["f32"], s["f32"]), jax_, STEP_BAND, LOSS_BAND, TENSOR_SHARE)


@pytest.fixture(scope="module")
def rcnn_steps():
    """rcnn.yaml's step: JAX's bf16 step (its RPN fixed) with its proposal
    target layer's output recorded; the port's bf16 and float32 RCNN on that
    output."""
    inputs = clouds()
    jm = jpr.PointRCNN(**RCNN_MODEL, dtype=jnp.bfloat16)
    v = draw_variables(jm, *(jnp.asarray(a) for a in inputs[:4]), seed=32, train=False)
    out = v["params"]["rpn"]["reg_head"]["out"]  # car-sized proposals about their points
    bias = np.zeros_like(np.asarray(out["bias"]))
    nbin = jm.rpn_codec.per_loc_bin_num
    bias[[nbin // 2, nbin + nbin // 2]] = 2.0
    out["kernel"], out["bias"] = np.asarray(out["kernel"]) * 0.01, bias
    seen = {}
    orig = jrcnn.prepare_rcnn_train_inputs

    def prepare(key, rois, *a, **k):
        res = orig(key, rois, *a, **k)
        jax.debug.callback(lambda ro, *o: seen.update(rois=np.array(ro),
                                                      targets=[np.array(x) for x in o]),
                           rois, *res[:4])
        return res

    # each instance's GT: its best proposal (a first run's), so that the
    # sampler finds foreground
    jax_grads(jm, v, inputs, ("loss_box3d",), "rcnn", {}, prepare)
    inputs = inputs[:4] + (seen["rois"][:, 0], inputs[5])
    jg, jl, _ = jax_grads(jm, v, inputs, ("loss_box3d",), "rcnn", {}, prepare)
    pts_input, cls_label, reg_mask, gt_ct = seen["targets"]
    assert (cls_label > 0).any() and (reg_mask > 0).any() and (cls_label == 0).any()
    targets = {"pts_input": t(pts_input).reshape((-1,) + pts_input.shape[2:]),
               "cls_label": t(cls_label).reshape(-1), "reg_mask": t(reg_mask).reshape(-1),
               "gt_ct": t(gt_ct).reshape(-1, 7)}
    tm32 = port_model(v, torch.float32, **RCNN_MODEL)
    names = [n for n, _ in tm32.named_parameters() if n.startswith("rcnn.")]
    sd = state_dict_from_jax(tm32, {"params": jg, "batch_stats": v["batch_stats"]})
    steps = {"jax": {"grads": {n: sd[n].numpy() for n in names}, "stats": {}, "loss": jl}}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, dt in (("port", BF16), ("f32", torch.float32)):
            tm = port_model(v, dt, **RCNN_MODEL).train()
            loss = tm.rcnn_train_loss(targets)
            loss.backward()
            steps[name] = {"grads": grads_of(tm, "rcnn."), "stats": {},
                           "loss": {"loss_box3d": float(loss.detach())}}
    finally:
        torch.set_num_threads(n)
    return steps


def test_rcnn_bf16_step_as_far_from_float32_as_jax(rcnn_steps):
    """rcnn.yaml's step at bf16 (the RCNN's BN-free SA scales through row
    11's bf16 train form, the bf16 loss) on JAX's targets, in the band form
    over the RCNN's gradients and loss (no BN: no running statistics); and,
    a BN-free network on shared inputs keeping its roundings close, the
    port's gradients within RCNN_DIRECT of JAX's distance from float32 of
    JAX's own (relative L2 over all tensors). The port's float32 step fails
    both (the control)."""
    s = rcnn_steps
    direct, gap = distances(s["port"], s["jax"])["grads"], distances(s["f32"], s["jax"])["grads"]
    print(f"RCNN bf16 step: the port's gradients {direct:.4g} from JAX's (relative L2), "
          f"the float32 step's {gap:.4g}")
    assert direct <= RCNN_DIRECT * gap
    assert set(s["port"]["grads"]) == set(s["jax"]["grads"]) and len(s["jax"]["grads"]) > 20
    port, jax_ = distances(s["port"], s["f32"]), distances(s["jax"], s["f32"])
    port["stats"] = jax_["stats"] = 1.0  # no running statistics: read as in the band
    print(report("RCNN bf16 step", port, jax_))
    assert not in_band(port, jax_, STEP_BAND, LOSS_BAND, TENSOR_SHARE)
    control = distances(s["f32"], s["f32"])
    control["stats"] = 1.0
    assert in_band(control, jax_, STEP_BAND, LOSS_BAND, TENSOR_SHARE)


def test_bf16_sa_off_route_as_close_to_float32_as_jax(torch_one_thread, monkeypatch):
    """The SA-off route of a bf16 rcnn.yaml PointRCNN (every scale of 64+
    channels through row 12's bf16 form: its plain version on the CPU)
    against JAX's bf16 PointRCNN with DISPRCNN_PALLAS_DISABLE=sa (its
    grouped-MLP kernel in interpret mode, counted): the RPN's features, cls
    and reg no further from the port's float32 run than 1.25 times JAX's +
    1e-3 of the float32 mean |x|; the port's route took row 12 at each such
    scale and no SA kernel."""
    inputs = clouds()[:4]
    jm = jpr.PointRCNN(npoints=N, sa_npoints=SA_NPOINTS, proposals_per_roi=4,
                       dtype=jnp.bfloat16)
    v = draw_variables(jm, *(jnp.asarray(a) for a in inputs), seed=33, train=False)
    monkeypatch.setenv("DISPRCNN_PALLAS_DISABLE", "sa")
    calls = []
    orig = jpn2.SharedMLP._fused_pool
    monkeypatch.setattr(jpn2.SharedMLP, "_fused_pool",
                        lambda self, x: calls.append(x.shape) or orig(self, x))
    try:
        jpn2._FORCE_INTERPRET = True
        _, state = source_jit(lambda vv, *a: jm.apply(vv, *a, train=False,
                                                      capture_intermediates=True,
                                                      mutable=["intermediates"]),
                              v, *(jnp.asarray(a) for a in inputs))
    finally:
        jpn2._FORCE_INTERPRET = False
    jrpn_out = state["intermediates"]["rpn"]["__call__"][0]
    assert len(calls) >= 6
    port_calls = []
    monkeypatch.setattr(tgm, "grouped_mlp_max_bf16_plain",
                        lambda *a, f=tgm.grouped_mlp_max_bf16_plain: port_calls.append(
                            a[0].shape) or f(*a))
    rpn_out = {}
    with torch.no_grad():
        for dt in (BF16, torch.float32):
            tm = port_model(v, dt, npoints=N, sa_npoints=SA_NPOINTS, proposals_per_roi=4,
                            kernels_off={"sa"})
            tm.rpn.register_forward_hook(lambda _m, _i, o, dt=dt: rpn_out.__setitem__(dt, o))
            tm(*(t(a) for a in inputs))
    rpn16, rpn32 = rpn_out[BF16], rpn_out[torch.float32]
    assert len(port_calls) == len(calls)  # the RPN's 6 scales and the RCNN's 2
    for k in ("features", "cls", "reg"):
        ref = rpn32[k].numpy()
        port = rpn16[k].float().numpy()
        jk = np.asarray(jrpn_out[k], np.float32)
        assert rpn16[k].dtype == BF16 and jrpn_out[k].dtype == jnp.bfloat16, k
        d_port, d_jax = np.abs(port - ref).mean(), np.abs(jk - ref).mean()
        print(f"SA-off RPN {k}: mean |bf16 - float32| port {d_port:.5f}, JAX {d_jax:.5f}")
        assert d_jax > 0 and d_port <= 1.25 * d_jax + 1e-3 * np.abs(ref).mean(), (k, d_port,
                                                                                  d_jax)


def test_stage3_bf16_checkpoint_loads_into_stage4(tmp_path):
    """The handoff of train_net's stages at bf16: a stage-3 (rpn.yaml)
    model built to train at its default dtype saves float32 parameters and
    statistics; its checkpoint loads into rcnn.yaml's model built to train
    at bf16 and into one at float32 (the RCNN's entries kept at their init),
    bit-equal in every shared entry."""
    def build(stage, opts=()):
        cfg = get_default_cfg()
        cfg.merge_from_file(str(REPO / "configs/kitti/car/vob" / f"{stage}.yaml"))
        cfg.merge_from_list(["TPU.ROI_CROP_SIZE", "32", "MODEL.DISPNET.MAX_DISP", "16",
                             "MODEL.DISPNET.MIN_DISP", "-16", *opts])
        cfg.freeze()
        return tbuild.build_detection_model(cfg, device="cpu", train=True)

    rpn = build("rpn")
    assert rpn.idispnet.dtype == BF16 and rpn.pointrcnn.dtype == BF16
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in rpn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    sd = rpn.state_dict()
    assert {v.dtype for v in sd.values() if v.is_floating_point()} == {torch.float32}
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(1, rpn, None)
    for opts, dt in (((), BF16), (("TPU.COMPUTE_DTYPE", "float32"), torch.float32)):
        rcnn = build("rcnn", opts)
        assert rcnn.pointrcnn.dtype == dt
        kept = load_stage_weights(rcnn, str(tmp_path / "ckpt"))
        assert kept and all(k.startswith("pointrcnn.rcnn.") for k in kept)
        got = rcnn.state_dict()
        for k, v in sd.items():
            assert torch.equal(got[k], v), k
