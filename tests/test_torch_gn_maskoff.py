"""GroupNorm (MODEL.BACKBONE.USE_GN, MODEL.FPN.USE_GN) and MODEL.MASK_ON
False in the port's 2D detector against the JAX package on the CPU.

- The R-50 body and the FPN with GroupNorm (32 groups, eps 1e-5, Flax's
  E[x^2] - E[x]^2 variance; the FPN's convs without bias), each alone and
  both, on the port's seeded random weights carried to JAX by the inverse
  of state_dict_from_jax (tests/torch_jax_tree.py): features to 1e-4 of
  max |JAX| + 1e-4. Flax's auto-numbered GroupNorm_<i> load by
  state_dict_from_jax, which still raises on a key it leaves unused.
- MASK_ON False builds no mask head; its detections equal the mask_on
  model's on the same weights, and its train step has the four other
  losses, equal to the mask_on model's on the same draws.
- Traced through JAX (slow): one train step's losses and gradients of the
  detector with both GroupNorms and nothing frozen (ROADMAP C19's L2 form;
  the stem and layer1, behind freeze_at = 2, get none in the port and zero
  in JAX), and MASK_ON False in eval (detections) and train (losses and
  gradients).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.backbone.fpn import ResNetFPNBackbone as JBackbone
from disprcnn_tpu.models.detector import disprcnn as jdet
from disprcnn_tpu_torch.models.backbone.fpn import ResNetFPNBackbone
from disprcnn_tpu_torch.models.backbone.resnet import GroupNorm
from disprcnn_tpu_torch.models.detector import disprcnn as tdet
from disprcnn_tpu_torch.utils.weights import (init_random_, load_jax_variables,
                                              state_dict_from_jax)
from torch_jax_tree import jax_tree
from torch_port_helpers import IMG_HW, TINY, draw_variables, jax_variables
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

B = 2


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("gn_body, gn_fpn", [(True, False), (False, True), (True, True)])
def test_gn_backbone_matches_jax(gn_body, gn_fpn):
    tm = ResNetFPNBackbone("R-50", 64, use_gn_body=gn_body, use_gn_fpn=gn_fpn)
    init_random_(tm, torch.Generator().manual_seed(1))
    n_gn = sum(isinstance(m, GroupNorm) for m in tm.modules())
    assert n_gn == 53 * gn_body + 7 * gn_fpn
    assert all(getattr(tm.fpn, f"lateral{k}").bias is None for k in range(2, 6)) == gn_fpn
    tree = jax_tree(tm, tm.state_dict())
    x = np.random.default_rng(2).standard_normal((1, *IMG_HW, 3)).astype(np.float32)
    want = jax.jit(JBackbone(body="R-50", out_channels=64, use_gn_body=gn_body,
                             use_gn_fpn=gn_fpn).apply)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x.transpose(0, 3, 1, 2)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-4)


def test_gn_variables_load_by_flax_numbering():
    """The JAX backbone's own GroupNorm_<i> tree (drawn by numpy, no trace
    of a forward) loads into the port, each entry set once; an extra
    GroupNorm key raises."""
    jm = JBackbone(body="R-50", out_channels=64, use_gn_body=True, use_gn_fpn=True)
    v = draw_variables(jm, jnp.zeros((1, 64, 64, 3)), seed=3)
    assert set(v) == {"params"}
    tm = ResNetFPNBackbone("R-50", 64, use_gn_body=True, use_gn_fpn=True)
    sd = state_dict_from_jax(tm, v)
    gn = v["params"]["fpn"]
    np.testing.assert_array_equal(sd["fpn.lateral2_gn.weight"].numpy(), gn["GroupNorm_0"]["scale"])
    np.testing.assert_array_equal(sd["fpn.output4_gn.bias"].numpy(), gn["GroupNorm_4"]["bias"])
    np.testing.assert_array_equal(sd["fpn.output2_gn.bias"].numpy(), gn["GroupNorm_6"]["bias"])
    blk = v["params"]["body"]["layer1_0"]
    np.testing.assert_array_equal(sd["body.layer1_0.downsample_bn.weight"].numpy(),
                                  blk["GroupNorm_0"]["scale"])
    np.testing.assert_array_equal(sd["body.layer1_0.bn3.bias"].numpy(), blk["GroupNorm_3"]["bias"])
    extra = {"params": dict(v["params"], fpn=dict(gn, GroupNorm_7=gn["GroupNorm_0"]))}
    with pytest.raises(KeyError, match="GroupNorm_7"):
        state_dict_from_jax(tm, extra)
    frozen = ResNetFPNBackbone("R-50", 64)
    with pytest.raises(KeyError):
        state_dict_from_jax(frozen, v)


def images(seed):
    rng = np.random.default_rng(seed)
    return [t(rng.standard_normal((B, *IMG_HW, 3)).astype(np.float32)) for _ in range(2)]


def test_mask_off_runs_without_the_mask_head():
    """MASK_ON False: no mask head, the same detections as the mask_on
    model on the same weights, and in train the four other losses equal to
    the mask_on model's on the same draws (no gt_masks needed)."""
    import test_torch_detector2d_train as d2

    on = init_random_(tdet.DispRCNN(**d2.TRAIN, device="cpu"), torch.Generator().manual_seed(4))
    off = tdet.DispRCNN(**d2.TRAIN, mask_on=False, device="cpu")
    assert not hasattr(off, "mask_head")
    missing, unexpected = off.load_state_dict(on.state_dict(), strict=False)
    assert not missing and unexpected and all(k.startswith("mask_head.") for k in unexpected)
    left, right = images(5)
    with torch.no_grad():
        a, b = on(left, right), off(left, right)
    assert set(b) == {"detections"} and set(a) == {"detections", "masks"}
    for f in ("left", "right", "score", "valid"):
        assert torch.equal(getattr(a["detections"], f), getattr(b["detections"], f)), f
    batch = {k: t(x) for k, x in d2.step_batch().items()}
    draws = tdet.draw_det2d_draws(B, 2046, d2.TRAIN["post_nms_top_n_train"] + d2.M,
                                  d2.TRAIN["roi_batch_per_image"], d2.TRAIN["mlp_head_dim"],
                                  torch.Generator().manual_seed(6))
    on.train()
    off.train()
    with torch.no_grad():
        la = on(**batch, draws=draws)
        lb = off(**{k: v for k, v in batch.items() if k != "gt_masks"}, draws=draws)
    assert {k for k in lb if k.startswith("loss")} == {
        "loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg"}
    for k in lb:
        if k.startswith("loss"):
            assert torch.equal(la[k], lb[k]), k
    with pytest.raises(ValueError, match="gt_masks"):
        on(**{k: v for k, v in batch.items() if k != "gt_masks"}, draws=draws)


def jax_train_grads(jm, v, batch, keys_out, drawn):
    """The summed losses of one JAX train forward and their gradient in
    every parameter, with the sampling keys and dropout outputs copied out
    (as test_torch_detector2d_train.jax_step reads them)."""
    import flax.linen as fnn

    import test_torch_detector2d_train as d2

    orig_rng = fnn.Module.make_rng

    def make_rng(self, name="params"):
        k = orig_rng(self, name)
        if name == "sampling" and isinstance(self, jdet.DispRCNN):
            i = len(keys_out)
            keys_out[i] = None
            jax.debug.callback(lambda kk: keys_out.__setitem__(i, np.array(kk)), k)
        return k

    r1, r2 = jax.random.split(jax.random.PRNGKey(3))

    def loss(params):
        with fnn.intercept_methods(d2.dropout_recorder(drawn)):
            out = jm.apply({"params": params, "frozen": v.get("frozen", {})}, train=True,
                           rngs={"sampling": r1, "dropout": r2},
                           **{k: jnp.asarray(x) for k, x in batch.items()})
        losses = {k: x for k, x in out.items() if k.startswith("loss")}
        return sum(losses.values()), losses

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "make_rng", make_rng)
        (_, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
        jax.block_until_ready(grads)
    return {k: float(x) for k, x in losses.items()}, grads


def check_train_step(jm, v, tm_kwargs, batch):
    """The port's train forward and backward on JAX's draws against JAX's
    losses and gradients."""
    import test_torch_detector2d_train as d2
    from test_torch_train import grads_close

    keys, drawn = {}, {}
    want, wgrad = jax_train_grads(jm, v, batch, keys, drawn)
    draws = d2.port_draws([keys[i] for i in sorted(keys)], drawn, 2046)
    tm = load_jax_variables(tdet.DispRCNN(**tm_kwargs, device="cpu"), v)
    tm.train()
    out = tm(**{k: t(x) for k, x in batch.items()}, draws=draws)
    losses = {k: x for k, x in out.items() if k.startswith("loss")}
    assert set(losses) == set(want)
    for k, x in losses.items():
        np.testing.assert_allclose(float(x.detach()), want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    sum(losses.values()).backward()
    want_sd = state_dict_from_jax(tm, {"params": jax.tree_util.tree_map(np.asarray, wgrad),
                                       **({"frozen": v["frozen"]} if "frozen" in v else {})})
    params = dict(tm.named_parameters())
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
           for n, p in params.items()}
    grads_close(got, {n: want_sd[n].numpy() for n in params})
    return tm, want


@pytest.mark.slow
def test_gn_train_step_matches_jax():
    import test_torch_detector2d_train as d2

    gn = dict(use_gn=True, use_gn_fpn=True)
    jm = jdet.DispRCNN(**d2.JTRAIN, **gn)
    v = jax_variables(jm, seed=0)
    assert "frozen" not in v
    tm, _ = check_train_step(jm, v, dict(d2.TRAIN, **gn), d2.step_batch())
    no_grad = [n for n, p in tm.named_parameters() if p.grad is None]
    assert no_grad and all(n.startswith(("backbone.body.stem.", "backbone.body.layer1_"))
                           for n in no_grad)
    assert any(".bn1.weight" in n for n in no_grad)  # GroupNorm params before the boundary


@pytest.mark.slow
def test_mask_off_eval_and_train_match_jax():
    import test_torch_detector2d_train as d2

    jm = jdet.DispRCNN(**d2.JTRAIN, mask_on=False)
    v = jax_variables(jm, seed=0)
    assert "mask_head" not in v["params"]
    left, right = images(8)
    want = jax.jit(lambda vv, a, b: jm.apply(vv, a, b))(v, jnp.asarray(left.numpy()),
                                                          jnp.asarray(right.numpy()))
    tm = load_jax_variables(tdet.DispRCNN(**d2.TRAIN, mask_on=False, device="cpu"), v)
    with torch.no_grad():
        got = tm(left, right)
    assert set(got) == set(want) == {"detections"}
    np.testing.assert_array_equal(got["detections"].valid.numpy(),
                                  np.asarray(want["detections"].valid))
    np.testing.assert_allclose(got["detections"].left.numpy(),
                               np.asarray(want["detections"].left), rtol=0, atol=1e-3)
    batch = {k: x for k, x in d2.step_batch().items() if k != "gt_masks"}
    _, losses = check_train_step(jm, v, dict(d2.TRAIN, mask_on=False), batch)
    assert "loss_mask" not in losses
