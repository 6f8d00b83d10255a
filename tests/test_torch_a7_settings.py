"""The model and solver settings that no shipped config changes, against
the JAX package on the CPU: MODEL.BACKBONE.FREEZE_CONV_BODY_AT on a small
ResNet (which stages get a gradient, and its values), the SRPN's and the
ROI heads' matcher and sampler settings and RPN.STRADDLE_THRESH -1 in the
2D train step's losses (and that DispRCNN hands them on), and
SOLVER.UNCERT_LOSS_WEIGHT in make_train_step (the learned loss weights,
their optimizer and a non-finite step).

All float32. Tolerances (stated in CHANGES.md):
- freeze_at: the stages without a gradient exactly zero in both; the
  others within 1e-5 * max + 1e-6 of JAX's;
- the SRPN and ROI losses and sampling as test_torch_detector2d_train.py
  holds them: the losses and their gradients 1e-5 * max + 1e-7, labels,
  positives and sampled rows exactly, regression targets 1e-5 * max +
  1e-6;
- the train step: the losses, the weights u, the parameters and both
  momentum traces within 1e-6 * max + 1e-7 of optax's after each of four
  steps (one of them skipped), the update counts equal.
"""
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from disprcnn_tpu.engine import trainer as jtrainer
from disprcnn_tpu.models.backbone import resnet as jresnet
from disprcnn_tpu.models.roi_heads import box_head as jbh
from disprcnn_tpu.models.rpn import stereo_rpn as jsrpn
from disprcnn_tpu.models.rpn.anchors import AnchorGenerator as JAnchorGenerator
from disprcnn_tpu.solver import build as jbuild
from disprcnn_tpu.solver import schedules as jsched
from disprcnn_tpu.structures.stereo import StereoBoxes as JStereoBoxes
from disprcnn_tpu_torch.engine.trainer import make_train_step
from disprcnn_tpu_torch.models.backbone import resnet as tresnet
from disprcnn_tpu_torch.models.detector import disprcnn as tdet
from disprcnn_tpu_torch.models.roi_heads import box_head as tbh
from disprcnn_tpu_torch.models.rpn import anchors as tanchors
from disprcnn_tpu_torch.models.rpn import stereo_rpn as tsrpn
from disprcnn_tpu_torch.solver import build as tbuild
from disprcnn_tpu_torch.solver import schedules as tsched
from disprcnn_tpu_torch.structures.stereo import StereoBoxes
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from test_torch_detector2d_train import (B, HWS, M, TRAIN, gt_scene, rel, roi_proposals,
                                         sampler_uniforms, step_batch)
from test_torch_train import close, jax_trace
from torch_port_helpers import IMG_HW, draw_variables


def t(x):
    return torch.from_numpy(np.array(x))


# -- FREEZE_CONV_BODY_AT ---------------------------------------------------------

# a small ResNet: 1, 2, 1, 1 blocks, an 8-channel stem, 16 channels out of
# layer1 and bottlenecks 4 wide
SMALL_BODY = {"R-S": (1, 2, 1, 1)}
WIDTHS = dict(stem_out_channels=8, res2_out_channels=16, width_per_group=4)


@pytest.mark.parametrize("freeze_at", [0, 1, 3, 5])
def test_freeze_at_cuts_the_gradient_as_jax(freeze_at, monkeypatch):
    """freeze_at k: the stem gets no gradient from k = 1, layer i none from
    k = i + 1; the rest get JAX's gradient, under a non-uniform output
    gradient on all four maps."""
    for mod in (jresnet, tresnet):
        monkeypatch.setattr(mod, "STAGE_BLOCKS", {**mod.STAGE_BLOCKS, **SMALL_BODY})
    rng = np.random.default_rng(freeze_at)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = jresnet.ResNet(body="R-S", freeze_at=freeze_at, **WIDTHS)
    v = draw_variables(jm, jnp.asarray(x), seed=1)
    cts = [rng.standard_normal(o.shape).astype(np.float32)
           for o in jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x)))]

    def f(p):
        outs = jm.apply({**v, "params": p}, jnp.asarray(x))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts))

    want = jax.jit(jax.grad(f))(v["params"])
    tm = load_jax_variables(tresnet.ResNet(body="R-S", freeze_at=freeze_at, **WIDTHS), v)
    assert tm.freeze_at == freeze_at
    outs = tm(t(x).permute(0, 3, 1, 2))
    loss = sum((o * t(c).permute(0, 3, 1, 2)).sum() for o, c in zip(outs, cts))
    if freeze_at < 5:
        loss.backward()
    else:  # every map detached: nothing to differentiate
        assert not loss.requires_grad
    want = state_dict_from_jax(tm, {**v, "params": want})
    live = {}
    for n, p in tm.named_parameters():
        stage = 0 if n.startswith("stem.") else int(n[len("layer")])
        frozen = freeze_at >= 1 and stage < freeze_at
        live[stage] = not frozen
        if frozen:
            assert p.grad is None and float(want[n].abs().max()) == 0, n
        else:
            close(p.grad.numpy(), want[n].numpy(), 1e-5, 1e-6, n)
            assert float(p.grad.abs().max()) > 0, n
    assert [live[s] for s in range(5)] == [freeze_at == 0] + [freeze_at <= s for s in range(1, 5)]


# -- the SRPN's and the ROI heads' settings ---------------------------------------------

SRPN_SETTINGS = dict(fg_iou=0.6, bg_iou=0.4, batch_per_image=64, positive_fraction=0.25)
ROI_SETTINGS = dict(fg_iou=0.6, bg_iou=0.4, positive_fraction=0.5)


def test_srpn_loss_settings_and_straddle_match_jax():
    """The SRPN loss with MODEL.RPN.FG/BG_IOU_THRESHOLD 0.6/0.4,
    BATCH_SIZE_PER_IMAGE 64 and POSITIVE_FRACTION 0.25, every anchor
    counted (STRADDLE_THRESH -1): both losses and their gradients, on
    JAX's sampler uniforms; the visibility all True where the default
    leaves anchors across the border out."""
    gl, gr, _, valid, _ = gt_scene(4)
    gen = JAnchorGenerator(straddle_thresh=-1)
    anchors, vis = gen(IMG_HW, HWS)
    assert vis.all() and not JAnchorGenerator()(IMG_HW, HWS)[1].all()
    np.testing.assert_array_equal(tanchors.visibility(anchors, IMG_HW, -1), vis)
    np.testing.assert_array_equal(tanchors.visibility(t(anchors), IMG_HW, -1).numpy(), vis)
    rng = np.random.default_rng(5)
    n = anchors.shape[0]
    logits = rng.standard_normal((B, n, 2)).astype(np.float32)
    deltas = (0.3 * rng.standard_normal((B, n, 6))).astype(np.float32)
    key = jax.random.PRNGKey(11)
    s = SRPN_SETTINGS

    def f(lg, dl):
        o, b_ = jsrpn.loss(key, jnp.asarray(anchors), jnp.asarray(vis), lg, dl, jnp.asarray(gl),
                           jnp.asarray(gr), jnp.asarray(valid), s["fg_iou"], s["bg_iou"],
                           s["batch_per_image"], s["positive_fraction"])
        return o + 3.0 * b_, (o, b_)

    (_, want), (wgl, wgd) = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(
        jnp.asarray(logits), jnp.asarray(deltas))
    up, un = sampler_uniforms(key, B, n)
    tl, td = t(logits).requires_grad_(True), t(deltas).requires_grad_(True)
    got = tsrpn.loss(t(anchors), t(vis), tl, td, t(gl), t(gr), t(valid), up, un, **s)
    (got[0] + 3.0 * got[1]).backward()
    for g, w in zip(got, want):
        rel(g.detach().numpy(), w)
    rel(tl.grad.numpy(), wgl, what="d logits")
    rel(td.grad.numpy(), wgd, what="d deltas")
    default = tsrpn.loss(t(anchors), t(vis), t(logits), t(deltas), t(gl), t(gr), t(valid), up,
                         un)
    assert float(default[0]) != float(got[0].detach())
    sampled = (np.abs(np.asarray(wgl)).sum(-1) > 0).sum(1)
    assert (sampled <= s["batch_per_image"]).all() and (sampled > 0).all()


def test_roi_subsample_settings_match_jax():
    """ROI matching and sampling with MODEL.ROI_HEADS.FG/BG_IOU_THRESHOLD
    0.6/0.4 and POSITIVE_FRACTION 0.5 on JAX's uniforms: labels, matched
    GT, positives and sampled rows exactly, the regression targets to
    1e-5."""
    gl, gr, labels, valid, _ = gt_scene(6)
    p, roi_batch = 100, 64
    left, right, score, pvalid = roi_proposals(7, gl, gr, valid, p, 0.1, False)
    key = jax.random.PRNGKey(13)
    jp = JStereoBoxes(left=jnp.asarray(left), right=jnp.asarray(right), score=jnp.asarray(score),
                      valid=jnp.asarray(pvalid))
    s = ROI_SETTINGS
    want = jax.jit(lambda k, props: jax.vmap(
        lambda kk, pr, a, b_, c, d: jbh.subsample(kk, pr, a, b_, c, d, s["fg_iou"], s["bg_iou"],
                                                  roi_batch, s["positive_fraction"]))(
        jax.random.split(k, B), props, jnp.asarray(gl), jnp.asarray(gr), jnp.asarray(labels),
        jnp.asarray(valid)))(key, jp)
    up, un = sampler_uniforms(key, B, p + M)
    tp = StereoBoxes(left=t(left), right=t(right), score=t(score), valid=t(pvalid))
    got = tbh.subsample(tp, t(gl), t(gr), t(labels), t(valid), up, un, s["fg_iou"], s["bg_iou"],
                        roi_batch, s["positive_fraction"])
    for i in (0, 2, 3, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    close(got[1].numpy(), want[1], 1e-5, 1e-6)
    default = tbh.subsample(tp, t(gl), t(gr), t(labels), t(valid), up, un, batch_size=roi_batch)
    assert not torch.equal(default[2], got[2])  # the settings move the positives
    assert np.asarray(want[2]).any(1).all()


class _Stop(Exception):
    pass


def test_disprcnn_hands_the_settings_on(monkeypatch):
    """DispRCNN's train forward hands straddle_thresh to the anchors'
    visibility, the rpn_* settings to the SRPN loss and the roi_* ones to
    the ROI sampler, and its body takes freeze_at."""
    seen = {}

    def vis(anchors, hw, straddle_thresh):
        seen["straddle"] = straddle_thresh
        return tanchors.visibility(anchors, hw, straddle_thresh)

    srpn_loss = tsrpn.loss

    def loss(*a):
        seen["srpn"] = a[-4:]
        return srpn_loss(*a)

    def subsample(*a):
        seen["roi"] = a[-4:]
        raise _Stop

    monkeypatch.setattr(tdet, "visibility", vis)
    monkeypatch.setattr(tdet.stereo_rpn, "loss", loss)
    monkeypatch.setattr(tdet.bh, "subsample", subsample)
    tm = tdet.DispRCNN(**TRAIN, freeze_at=3, straddle_thresh=-1.0, rpn_fg_iou=0.6,
                       rpn_bg_iou=0.4, rpn_batch_per_image=64, rpn_positive_fraction=0.25,
                       roi_fg_iou=0.55, roi_bg_iou=0.45, roi_positive_fraction=0.5,
                       device="cpu")
    assert tm.backbone.body.freeze_at == 3
    tm.train()
    with torch.no_grad(), pytest.raises(_Stop):
        tm(**{k: t(x) for k, x in step_batch(3, 3).items()},
           generator=torch.Generator().manual_seed(0))
    assert seen == {"straddle": -1.0, "srpn": (0.6, 0.4, 64, 0.25),
                    "roi": (0.55, 0.45, TRAIN["roi_batch_per_image"], 0.5)}


# -- SOLVER.UNCERT_LOSS_WEIGHT ----------------------------------------------------------

class JLosses(fnn.Module):
    """Three losses of one dense layer, for the train steps."""

    @fnn.compact
    def __call__(self, x, scale, train=False):
        y = fnn.Dense(4, name="fc")(x)
        return {"loss_b": jnp.mean(jnp.abs(y - 1.0)), "loss_a": jnp.mean(y * y) * scale,
                "loss_c": jnp.mean(y[:, :2]) ** 2 + 0.5}


class TLosses(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 4)

    def forward(self, x, scale):
        y = self.fc(x)
        return {"loss_b": (y - 1.0).abs().mean(), "loss_a": (y * y).mean() * scale,
                "loss_c": y[:, :2].mean() ** 2 + 0.5}


SOLVER = dict(OPTIMIZER="SGD", MOMENTUM=0.9, WEIGHT_DECAY=1e-4, WEIGHT_DECAY_BIAS=0.0,
              BIAS_LR_FACTOR=2.0)
BASE_LR, MAX_ITER, CLIP = 0.5, 20, 0.3


def test_uncert_train_step_matches_jax():
    """make_train_step with 3 learned loss weights (UNCERT_LOSS_WEIGHT 3)
    against JAX's make_train_step with uncert_count 3 and tools/
    train_net's uncert_tx, from the same weights, over 4 steps whose
    second has a non-finite loss: the weighted loss sum(u) + sum(l_i
    exp(-u_i)) over the losses sorted by key, u from -1, u's update
    (momentum 0.9 on the OneCycle rate, no weight decay, its gradient not
    clipped with the parameters'), the parameters, both momentum traces
    and the update counts; the skipped step leaves all of them as they
    were."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    jm = JLosses()
    v = draw_variables(jm, jnp.asarray(x), 1.0, seed=3)
    cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(**SOLVER))
    sched = jsched.one_cycle(BASE_LR, MAX_ITER)
    tx = jbuild.make_optimizer(cfg, v["params"], sched,
                               momentum_schedule=jsched.one_cycle_momentum(MAX_ITER))
    utx = optax.chain(optax.trace(decay=SOLVER["MOMENTUM"]), optax.scale_by_learning_rate(sched))
    state = jtrainer.create_train_state(jm, tx, v, uncert_count=3, uncert_tx=utx)
    jstep = jax.jit(jtrainer.make_train_step(jm, tx, do_grad_clip=True, grad_clip=CLIP,
                                             uncert_tx=utx))

    tm = TLosses()
    with torch.no_grad():
        tm.fc.weight.copy_(t(np.asarray(v["params"]["fc"]["kernel"]).T))
        tm.fc.bias.copy_(t(v["params"]["fc"]["bias"]))
    opt = tbuild.make_optimizer(tm, tsched.one_cycle(BASE_LR, MAX_ITER),
                                tsched.one_cycle_momentum(MAX_ITER), (), momentum=0.9,
                                weight_decay=1e-4, weight_decay_bias=0.0, bias_lr_factor=2.0)
    uncert = tbuild.UncertWeights(3, tsched.one_cycle(BASE_LR, MAX_ITER), 0.9)
    assert torch.equal(uncert.u.detach(), torch.full((3,), -1.0))
    step = make_train_step(tm, opt, do_grad_clip=True, grad_clip=CLIP, uncert=uncert)
    clipped = False
    for i, scale in enumerate((1.0, float("nan"), 2.0, 0.5)):
        before = uncert.u.detach().clone()
        state, jmet = jstep(state, dict(x=jnp.asarray(x), scale=jnp.float32(scale)),
                            jax.random.PRNGKey(0))
        met = step(dict(x=t(x), scale=torch.tensor(scale)))
        skipped = not np.isfinite(scale)
        assert float(met["skipped_nonfinite"]) == float(jmet["skipped_nonfinite"]) == skipped
        if skipped:
            assert torch.equal(uncert.u.detach(), before)
        else:
            close(float(met["loss_total"]), jmet["loss_total"], 1e-6, 1e-7, f"loss {i}")
            assert not torch.equal(uncert.u.detach(), before)
        close(uncert.u.detach().numpy(), state.uncert, 1e-6, 1e-7, f"u {i}")
        close(tm.fc.weight.detach().numpy(), np.asarray(state.params["fc"]["kernel"]).T, 1e-6,
              1e-7, f"W {i}")
        close(tm.fc.bias.detach().numpy(), state.params["fc"]["bias"], 1e-6, 1e-7, f"b {i}")
        ustate = state.uncert_opt_state
        close(uncert.sgd.state[uncert.u]["momentum_buffer"].numpy(), ustate[0].trace, 1e-6,
              1e-7, f"u trace {i}")
        trace = jax_trace(state.opt_state, state.params)["fc"]
        momentum = opt.sgd.state
        close(momentum[tm.fc.weight]["momentum_buffer"].numpy(), np.asarray(trace["kernel"]).T,
              1e-6, 1e-7, f"W trace {i}")
        close(momentum[tm.fc.bias]["momentum_buffer"].numpy(), trace["bias"], 1e-6, 1e-7,
              f"b trace {i}")
        assert uncert.count == int(ustate[1].count) == opt.count
        if not skipped:  # the parameters' gradient was clipped to CLIP in place
            gnorm = float(torch.sqrt(sum(p.grad.square().sum() for p in tm.parameters())))
            assert abs(gnorm - CLIP) <= 1e-5 * CLIP, gnorm
    assert step.count == 4 and uncert.count == opt.count == 3
