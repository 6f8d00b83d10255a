"""The RPN and the RCNN trained in one step (RPN.FIXED False with the RCNN
enabled, JAX's default) against the JAX package on the CPU, at PointRCNN
level on tiny clouds: the three losses, every parameter gradient (the
RPN's included) and the RPN's BN statistics, and where loss_box3d's
gradient reaches the RPN (ROADMAP C36); and DispRCNN3D's joint train
forward. Row 14's train form and the RCNN's settings are in
test_torch_rcnn_options.py.

The JAX step runs jitted, with PointNet++'s max as an argmax gather
(test_torch_rpn_train.TieSafeMax, ROADMAP C25). The draws are JAX's own:
the heads' dropout masks copied out of the run, the proposal target
layer's uniforms recomputed from its key (test_torch_rcnn_train.jax_draws).

Decisions that can tip (C16): the proposals come from a train-mode RPN,
so a top-k, NMS, IoU or FPS decision could fall the other way on a float32
ulp. The clouds hold no coincident points and every FPS picks a strict
subset (SA ladder 64/32/16/8 over 128 points; the RCNN's 128 of 512
pooled points), so that no FPS chooses among exact ties, and the port's
proposals and their flags are held to JAX's (flags exactly) before any
loss or gradient is compared.

The gradients, as in test_torch_rpn_train's float64 witness (ROADMAP C26):
on these clouds JAX's jitted float32 gradients lie ~1.5e-2 (relative L2,
all tensors) from the port's float64 run, past C19's bound, while the
port's float32 ones lie within it (-s prints both readings). So the port's
float32 gradients are held to its float64 run on the same decisions (the
NMS's boxes rounded to float32, as the NMS takes them), and JAX's to the
same run within a looser bound and farther than the port's.

All float32 but the witness. Tolerances (stated in CHANGES.md):
- the joint step: the losses within 1e-5 relative of JAX's, and float64's
  within 1e-6 of float32's (no decision fell the other way); the port's
  float32 gradients in C19's L2 form of its float64 ones
  (test_torch_train.grads_close: per tensor relative L2 1e-2 and max
  |diff| 5e-2 * max, all tensors together 5e-3), JAX's within relative L2
  1e-1 per tensor and 3e-2 together, and farther than the port's; the
  RPN's BN running statistics 1e-4 * max + 1e-6 of JAX's and the
  proposals 1e-3 * max + 1e-4 (the train-mode RPN's float32 activations
  differ by up to ~2e-4 of their scale in its deepest levels: batch
  statistics summed in another order, layer upon layer);
- loss_box3d's gradient in the RPN alone (C36): zero in the
  classification head and nonzero in the backbone and the regression
  head, in JAX's and the port's; the port's in C19's form of its float64
  one and JAX's in the witness bound; the port's two routes sum to it
  within 1e-4 * max + 1e-7 (three float32 backward passes);
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
from disprcnn_tpu_torch.models.detector import disprcnn3d as t3d
from disprcnn_tpu_torch.models.pointrcnn import point_rcnn as tpr
from disprcnn_tpu_torch.models.pointrcnn import rcnn3d as trcnn
from disprcnn_tpu_torch.models.pointrcnn import rpn3d as trpn
from disprcnn_tpu_torch.structures.stereo import StereoBoxes
from disprcnn_tpu_torch.tools.bench_train import boxes_on_clouds
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from test_torch_rcnn_train import jax_draws, port_draws
from test_torch_rpn_train import TieSafeMax, dropout_recorder
from test_torch_train import close, grads_close
from torch_port_helpers import draw_variables
from torch_train_helpers import torch_one_thread  # noqa: F401  (fixture)

R, N, POST, K = 3, 128, 16, 4
# PointRCNN at test size: clouds of 128 points, SA ladder 64/32/16/8, the
# TRAIN proposals 64 -> 16 at rcnn.yaml's NMS 0.85, 4 RCNN rois an instance
# of 512 pooled points
MODEL = dict(npoints=N, sa_npoints=(64, 32, 16, 8), proposals_per_roi=8,
             proposals_per_roi_train=POST, rpn_pre_nms_per_roi_train=64,
             rcnn_rois_per_instance=K, rpn_nms_thresh_train=0.85)
SAMPLING_KEY, DROPOUT_KEY = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
# the functions port_joint wraps, as the package defines them
PREPARE, NMS = trcnn.prepare_rcnn_train_inputs, trpn.bev_nms_mask


def t(x):
    return torch.from_numpy(np.array(x))


def joint_inputs():
    """Three car-sized clouds (one without GT), each GT box on its cloud
    (bench_train.boxes_on_clouds)."""
    rng = np.random.default_rng(14)
    pts = (rng.standard_normal((R, N, 3)) * np.array([1.5, 0.6, 0.8])).astype(np.float32)
    valid = np.ones(R, bool)
    ang = np.array([0.1, -0.3, 0.5], np.float32)
    mean = (rng.standard_normal((R, 3)) * 5).astype(np.float32)
    gt = boxes_on_clouds(t(pts), t(ang), t(mean)).numpy()
    gt_ok = np.array([True, True, False])
    return pts, valid, ang, mean, gt, gt_ok


@pytest.fixture(scope="module")
def joint():
    """JAX's joint PointRCNN on numpy-drawn variables: its losses, the
    gradients of the RPN's two losses and of loss_box3d apart (one jitted
    forward, its backward vmapped over the two cotangents), the updated BN statistics, the dropout
    masks and the proposals it drew."""
    pts, valid, ang, mean, gt, gt_ok = joint_inputs()
    jm = jpr.PointRCNN(**MODEL)
    args = tuple(jnp.asarray(a) for a in (pts, valid, ang, mean))
    v = draw_variables(jm, *args, seed=5, train=False)
    drawn = {}
    orig = jrcnn.prepare_rcnn_train_inputs

    def prepare(key, rois, roi_valid, *a, **kw):
        jax.debug.callback(lambda ro, rv: drawn.update(rois=np.array(ro), valid=np.array(rv)),
                           rois, roi_valid)
        return orig(key, rois, roi_valid, *a, **kw)

    def losses(p):
        with fnn.intercept_methods(dropout_recorder(drawn)):
            out, new = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, *args,
                                train=True, gt_boxes3d=jnp.asarray(gt), gt_ok=jnp.asarray(gt_ok),
                                rpn_fixed=False, sampling_key=SAMPLING_KEY,
                                rngs={"dropout": DROPOUT_KEY}, mutable=["batch_stats"])
        return out, new["batch_stats"]

    @jax.jit
    def run(p):  # the two backward passes as one vmapped over the cotangents
        out, vjp, stats = jax.vjp(losses, p, has_aux=True)
        box = {k: jnp.asarray([0.0, 1.0] if k == "loss_box3d" else [1.0, 0.0], x.dtype)
               for k, x in out.items()}
        g, = jax.vmap(vjp)(box)
        return (out, jax.tree_util.tree_map(lambda x: x[0], g),
                jax.tree_util.tree_map(lambda x: x[1], g), stats)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpn2, "jnp", TieSafeMax())
        mp.setattr(jrcnn, "prepare_rcnn_train_inputs", prepare)
        out, g_rpn, g_box, stats = jax.block_until_ready(run(v["params"]))
    keep = {h: drawn[f"rpn/{h}/Dropout_0"] != 0 for h in ("cls_head", "reg_head")}
    return dict(v=v, inputs=(pts, valid, ang, mean, gt, gt_ok),
                out={k: float(x) for k, x in out.items()}, g_rpn=g_rpn, g_box=g_box,
                stats=stats, rpn_draws=trpn.RPNDraws(cls_keep=t(keep["cls_head"]),
                                                     reg_keep=t(keep["reg_head"])),
                draws=port_draws(jax_draws(SAMPLING_KEY, R, POST, K, 10)), drawn=drawn)


def port_joint(j, monkeypatch, detach=None, dtype=torch.float32):
    """The port's joint PointRCNN on JAX's variables and draws, train mode,
    in `dtype`; `detach` ("rois" or "features") cuts one of loss_box3d's
    two routes into the RPN. -> (model, losses, what
    prepare_rcnn_train_inputs got)."""
    tm = load_jax_variables(tpr.PointRCNN(**MODEL), j["v"]).to(dtype)
    assert not tm.rpn_fixed and tm.rcnn_enabled
    seen = {}

    def prepare(rois, roi_valid, gt, gt_ok, xyz, feats, *a, **kw):
        seen.update(rois=rois.detach().float().clone(), valid=roi_valid.clone())
        if detach == "rois":
            rois = rois.detach()
        if detach == "features":
            feats = feats.detach()
        return PREPARE(rois, roi_valid, gt, gt_ok, xyz, feats, *a, **kw)

    monkeypatch.setattr(trcnn, "prepare_rcnn_train_inputs", prepare)
    # the NMS takes float32 boxes: a float64 run's decisions on them
    monkeypatch.setattr(trpn, "bev_nms_mask", lambda b, s, v, th, rotated=False: NMS(
        b.float(), s.float(), v, th, rotated=rotated))
    tm.train()
    inputs = [t(a) for a in j["inputs"]]
    draws = type(j["draws"])(**{k: v.to(dtype) if v.is_floating_point() else v
                                 for k, v in vars(j["draws"]).items()})
    out = tm(*(a.to(dtype) if a.is_floating_point() else a for a in inputs), draws,
             j["rpn_draws"])
    return tm, out, seen


def check_proposals(j, seen):
    """The decisions that can tip (C16) fell as JAX's: every proposal flag
    equal, the proposals themselves close."""
    np.testing.assert_array_equal(seen["valid"].numpy(), j["drawn"]["valid"])
    close(seen["rois"].numpy(), j["drawn"]["rois"], 1e-3, 1e-4, "proposals")
    assert j["drawn"]["valid"].any(1).all()


def grads_of(tm, loss, retain_graph=False):
    tm.zero_grad(set_to_none=True)
    loss.backward(retain_graph=retain_graph)
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).double().numpy()
            for n, p in tm.named_parameters()}


@pytest.fixture(scope="module")
def port_runs(joint):
    """The port's joint step in float32 and float64 on JAX's variables and
    draws: its losses, and the gradients of their sum ("total") and of
    loss_box3d alone ("box"), by dtype; the float32 model."""
    mp, threads = pytest.MonkeyPatch(), torch.get_num_threads()
    torch.set_num_threads(1)
    runs = {}
    try:
        for dtype in (torch.float32, torch.float64):
            tm, out, seen = port_joint(joint, mp, dtype=dtype)
            check_proposals(joint, seen)
            box = grads_of(tm, out["loss_box3d"], retain_graph=True)
            runs[dtype] = ({k: float(v.detach()) for k, v in out.items()},
                           {"box": box, "total": grads_of(tm, sum(out.values()))}, tm)
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return runs


def l2_from(got: dict, ref: dict) -> tuple:
    """(the worst tensor's relative L2 distance, all tensors') of `got`
    from `ref`, over ref's nonzero tensors."""
    names = [n for n in ref if np.abs(ref[n]).max() > 0]
    per = [np.linalg.norm(got[n] - ref[n]) / np.linalg.norm(ref[n]) for n in names]
    num = sum(np.square(got[n] - ref[n]).sum() for n in names)
    return max(per), float(np.sqrt(num / sum(np.square(ref[n]).sum() for n in names)))


def witness(j, runs, which: str, jax_grads, what: str) -> dict:
    """The port's float32 and float64 gradients `which` ("total" or "box")
    and JAX's float32 ones (jax_grads), held as the module doc says. -> the
    port's float32 gradients by name."""
    (l32, g32, tm), (l64, g64, _) = runs[torch.float32], runs[torch.float64]
    g32, g64 = g32[which], g64[which]
    for k in l64:
        assert abs(l32[k] - l64[k]) <= 1e-6 * abs(l64[k]), (k, l32[k], l64[k])
    want = state_dict_from_jax(tm, {"params": jax_grads, "batch_stats": j["v"]["batch_stats"]})
    jg = {n: want[n].double().numpy() for n in g64}
    port_d, jax_d = l2_from(g32, g64), l2_from(jg, g64)
    print(f"{what}: relative L2 from the port's float64 gradients, worst tensor and all: "
          f"port float32 {port_d[0]:.3g} {port_d[1]:.3g}, JAX float32 {jax_d[0]:.3g} "
          f"{jax_d[1]:.3g}")
    live = [n for n in g64 if np.abs(g64[n]).max() > 0]
    grads_close({n: g32[n] for n in live}, {n: g64[n] for n in live})
    assert jax_d[0] <= 1e-1 and jax_d[1] <= 3e-2, jax_d
    assert port_d[1] < jax_d[1], (port_d, jax_d)
    for n in g64:  # JAX's zeros are the port's
        assert (np.abs(g64[n]).max() == 0) == (np.abs(jg[n]).max() == 0) \
            == (np.abs(g32[n]).max() == 0), n
    return g32


def test_joint_pointrcnn_matches_jax(joint, port_runs, monkeypatch, torch_one_thread):
    """The joint train step's three losses against JAX's, the gradient of
    their sum in every parameter (RPN and RCNN) against the port's float64
    run and JAX's (the witness), and the RPN's updated BN running
    statistics against JAX's, on the same variables and draws."""
    j = joint
    tm, out, seen = port_joint(j, monkeypatch)
    check_proposals(j, seen)
    assert set(out) == {"loss_rpn_cls", "loss_rpn_reg", "loss_box3d"}
    for k, w in j["out"].items():
        g = float(out[k].detach())
        assert w > 0 and abs(g - w) <= 1e-5 * w, (k, g, w)
    stats = state_dict_from_jax(tm, {"params": j["v"]["params"], "batch_stats": j["stats"]})
    running = [n for n, _ in tm.named_buffers() if "running" in n]
    assert len(running) > 50
    buffers = dict(tm.named_buffers())
    for n in running:
        close(buffers[n].numpy(), stats[n].numpy(), 1e-4, 1e-6, n)
    total = jax.tree_util.tree_map(lambda a, b: a + b, j["g_rpn"], j["g_box"])
    g = witness(j, port_runs, "total", total, "the joint step")
    for part in ("rpn.", "rcnn."):
        assert any(np.abs(v).max() > 0 for n, v in g.items() if n.startswith(part)), part


def test_joint_box_loss_reaches_the_rpn(joint, port_runs, monkeypatch, torch_one_thread):
    """ROADMAP C36: JAX's jax.grad sends loss_box3d's gradient into the RPN
    (the reference's torch.no_grad() does not): into the backbone and the
    regression head, not the classification head. The port's does the
    same (held as the module doc says), and it is the sum of its two
    routes: the pooled RPN features (rois detached) and the proposal boxes
    (features detached), each nonzero in the backbone."""
    j = joint
    g = witness(j, port_runs, "box", j["g_box"], "loss_box3d alone")
    rpn = {n: v for n, v in g.items() if n.startswith("rpn.")}
    routes = {}
    for detach in ("rois", "features"):
        tm, out, seen = port_joint(j, monkeypatch, detach)
        check_proposals(j, seen)
        routes[detach] = {n: v for n, v in grads_of(tm, out["loss_box3d"]).items() if n in rpn}

    def norm(grads, part):
        return float(np.sqrt(sum(np.square(a).sum() for n, a in grads.items() if part in n)))

    parts = ("backbone", "reg_head", "cls_head")
    print("C36: |d loss_box3d / d rpn| by part in the port: "
          + ", ".join(f"{p} {norm(rpn, p):.4g}" for p in parts)
          + "; through the pooled features "
          + ", ".join(f"{p} {norm(routes['rois'], p):.4g}" for p in parts)
          + "; through the proposals "
          + ", ".join(f"{p} {norm(routes['features'], p):.4g}" for p in parts))
    assert norm(rpn, "backbone") > 0 and norm(rpn, "reg_head") > 0 and norm(rpn, "cls_head") == 0
    for n, v in rpn.items():
        close(routes["rois"][n] + routes["features"][n], v, 1e-4, 1e-7, n)
    assert norm(routes["rois"], "backbone") > 0 and norm(routes["rois"], "reg_head") == 0
    assert norm(routes["features"], "backbone") > 0 and norm(routes["features"], "reg_head") > 0


def test_joint_disprcnn3d_draws_and_returns_three_losses(torch_one_thread):
    """DispRCNN3D(det3d_on=True) with the default rpn_fixed=False trains the
    RPN and the RCNN in one step: from one generator it draws the RCNN's
    and the RPN's draws, and returns all three losses, each with a
    gradient path (the RPN's parameters get one)."""
    m = t3d.DispRCNN3D(max_det=2, roi_size=32, maxdisp=16, mindisp=-16, det3d_on=True,
                       npoints=128, lift_grid=32, sa_npoints=(128, 64, 32, 16),
                       psm_hourglass=1, mask_thresh_train=0.5, rpn_pre_nms_per_roi_train=64,
                       proposals_per_roi_train=8, rcnn_rois_per_instance=4, device="cpu")
    assert not m.pointrcnn.rpn_fixed
    gen = torch.Generator().manual_seed(0)
    left = torch.tensor([[[10.3, 20.7, 70.2, 60.9], [80.5, 30.1, 131.4, 75.6]]])
    dets = StereoBoxes(left=left, right=left - torch.tensor([6.2, 0.0, 5.1, 0.0]),
                       score=torch.tensor([[0.9, 0.8]]), valid=torch.ones(1, 2, dtype=torch.bool),
                       fields={"mask": torch.rand(1, 2, 28, 28, generator=gen)})
    calib = dict(fu=721.5, fv=721.5, cu=80.0, cv=48.0, tx=0.0, ty=0.0, fuxb=389.6)
    m.train()
    out = m(torch.rand(1, 96, 160, 3, generator=gen), torch.rand(1, 96, 160, 3, generator=gen),
            dets, {k: torch.full((1,), v) for k, v in calib.items()}, generator=gen,
            train_pc=True, gt_left=left, gt_boxes3d=torch.zeros(1, 2, 7),
            gt_valid=torch.ones(1, 2, dtype=torch.bool))
    losses = {k: v for k, v in out.items() if k.startswith("loss")}
    assert set(losses) == {"loss_rpn_cls", "loss_rpn_reg", "loss_box3d"}
    assert all(torch.isfinite(v) for v in losses.values())
    sum(losses.values()).backward()
    assert all(p.grad is not None for p in m.pointrcnn.rpn.parameters())
    assert all(p.grad is None for p in m.idispnet.parameters())


def test_rpn_fixed_without_rcnn_raises():
    m = tpr.PointRCNN(npoints=64, sa_npoints=(64, 32, 16, 8), rcnn_enabled=False, rpn_fixed=True)
    m.train()
    with pytest.raises(ValueError, match="nothing to train"):
        m(torch.zeros(1, 64, 3), torch.ones(1, dtype=torch.bool), torch.zeros(1),
          torch.zeros(1, 3), torch.zeros(1, 7), torch.ones(1, dtype=torch.bool))
