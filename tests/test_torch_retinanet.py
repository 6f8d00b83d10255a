"""The port's RetinaNet (ops/losses.py's multi-class focal loss,
models/rpn/retinanet.py, models/detector/retinanet_det.py) against the JAX
package on the CPU.

- sigmoid_focal_loss with background, ignored (-1) and positive rows, and
  the losses' smooth_l1_loss and dice_loss: 1e-6 relative, gradients 1e-5.
- The octave anchors, exactly.
- The head (2 convs a tower, 16 channels) on two levels: 1e-4 of max
  |JAX| + 1e-4, its cls_logits bias at the prior -log(99) after
  init_random_ too.
- retinanet_loss on the same inputs: 1e-5 relative, gradients 1e-5 * max
  + 1e-7; retinanet_postprocess (tied scores included): validity and
  labels exact, boxes 1e-4 px, scores 1e-6.
- The whole detector (R-50-FPN over P3-P7, narrow FPN, 3 classes) on 2 x
  64 x 128 (slow: it traces the JAX model): eval detections as above
  (boxes 1e-3 px, scores 1e-5) and the train losses 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.detector.retinanet_det import RetinaNetDetector as JDetector
from disprcnn_tpu.models.rpn import retinanet as jrn
from disprcnn_tpu.ops import losses as jlosses
from disprcnn_tpu_torch.models.detector.retinanet_det import RetinaNetDetector
from disprcnn_tpu_torch.models.rpn import retinanet as trn
from disprcnn_tpu_torch.ops import losses as tlosses
from disprcnn_tpu_torch.utils.weights import init_random_, load_jax_variables
from test_torch_train import close
from torch_port_helpers import draw_variables
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

HW = (64, 128)
B = 2


def t(x):
    return torch.from_numpy(np.array(x))


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_sigmoid_focal_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = normal(rng, 40, 5, scale=3.0)
    targets = rng.integers(-1, 6, 40).astype(np.int32)
    assert {-1, 0}.issubset(set(targets)) and (targets > 0).any()

    def f(x):
        out = jlosses.sigmoid_focal_loss(x, jnp.asarray(targets), 2.0, 0.25)
        return jnp.sum(out * jnp.arange(1, 6)), out

    (_, want), wg = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    got = tlosses.sigmoid_focal_loss(x, t(targets).long(), 2.0, 0.25)
    (got * torch.arange(1, 6)).sum().backward()
    close(got.detach().numpy(), want, 1e-6, 0.0, "focal")
    assert not got.detach().numpy()[targets == -1].any()
    close(x.grad.numpy(), wg, 1e-5, 1e-7, "d focal")


def test_smooth_l1_and_dice_losses_match_jax():
    rng = np.random.default_rng(1)
    p, q = normal(rng, 30, 4), normal(rng, 30, 4)
    w = rng.uniform(0, 1, (30, 4)).astype(np.float32)
    want = jlosses.smooth_l1_loss(jnp.asarray(p), jnp.asarray(q), 0.11, jnp.asarray(w))
    close(tlosses.smooth_l1_loss(t(p), t(q), 0.11, t(w)).numpy(), want, 1e-6, 0.0)
    close(tlosses.smooth_l1_loss(t(p), t(q)).numpy(),
          jlosses.smooth_l1_loss(jnp.asarray(p), jnp.asarray(q)), 1e-6, 0.0)
    tg = (rng.uniform(0, 1, (30, 4)) > 0.7).astype(np.float32)
    close(float(tlosses.dice_loss(t(p), t(tg))),
          float(jlosses.dice_loss(jnp.asarray(p), jnp.asarray(tg))), 1e-6, 0.0)


def test_octave_anchors_match_jax():
    hws = [(8, 16), (4, 8), (2, 4), (1, 2), (1, 1)]
    want, _ = jrn.octave_anchor_generator()(HW, hws)
    gen = trn.octave_anchor_generator()
    assert gen.num_anchors_per_location == 9
    np.testing.assert_array_equal(gen(hws), want)


def head_feats(seed):
    rng = np.random.default_rng(seed)
    return [normal(rng, B, 8, 16, 16), normal(rng, B, 4, 8, 16)]


def test_head_matches_jax():
    feats = head_feats(2)
    jf = [jnp.asarray(f) for f in feats]
    jm = jrn.RetinaNetHead(num_classes=3, num_anchors=9, num_convs=2, channels=16)
    v = draw_variables(jm, jf, seed=3)
    want = jax.jit(jm.apply)(v, jf)
    tm = load_jax_variables(trn.RetinaNetHead(16, 3, 9, num_convs=2, channels=16), v)
    with torch.no_grad():
        got = tm([t(f.transpose(0, 3, 1, 2)) for f in feats])
    for (gc, gb), (wc, wb) in zip(got, want):
        for g, w in ((gc, wc), (gb, wb)):
            w = np.asarray(w)
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-4)
    # the prior bias: Flax's bias_init, the constructor's and init_random_'s
    prior = -np.log((1 - 0.01) / 0.01)
    init = jm.init(jax.random.PRNGKey(0), jf)["params"]["cls_logits"]["bias"]
    np.testing.assert_allclose(np.asarray(init), prior, rtol=1e-6)
    fresh = trn.RetinaNetHead(16, 3, 9, num_convs=2, channels=16)
    np.testing.assert_allclose(fresh.cls_logits.bias.detach().numpy(), prior, rtol=1e-6)
    init_random_(fresh, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(fresh.cls_logits.bias.detach().numpy(), prior, rtol=1e-6)


def loss_inputs(seed):
    hws = [(8, 16), (4, 8)]
    anchors, _ = jrn.octave_anchor_generator(sizes=(32, 64), strides=(8, 16))(HW, hws)
    n = anchors.shape[0]
    rng = np.random.default_rng(seed)
    cls = normal(rng, B, n, 3, scale=2.0)
    cls[1, ::5] = cls[1, 2]  # tied rows
    box = normal(rng, B, n, 4, scale=0.3)
    g = np.array([[[10.0, 8, 60, 50], [70, 20, 120, 60], [0, 0, 0, 0]],
                  [[30.0, 4, 90, 40], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    labels = np.array([[1, 3, 0], [2, 0, 0]], np.int32)
    valid = np.array([[True, True, False], [True, False, False]])
    return anchors, cls, box, g, labels, valid


def test_retinanet_loss_matches_jax():
    anchors, cls, box, g, labels, valid = loss_inputs(4)

    def f(c, b):
        cl, bl = jrn.retinanet_loss(None, jnp.asarray(anchors), c, b, jnp.asarray(g),
                                    jnp.asarray(labels), jnp.asarray(valid))
        return cl + 2 * bl, (cl, bl)

    (_, want), wg = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(jnp.asarray(cls),
                                                                         jnp.asarray(box))
    tc, tb = t(cls).requires_grad_(True), t(box).requires_grad_(True)
    got = trn.retinanet_loss(t(anchors), tc, tb, t(g), t(labels), t(valid))
    (got[0] + 2 * got[1]).backward()
    for gg, w in zip(got, want):
        assert float(w) > 0
        close(float(gg.detach()), float(w), 1e-5, 0.0)
    close(tc.grad.numpy(), wg[0], 1e-5, 1e-7, "d cls")
    close(tb.grad.numpy(), wg[1], 1e-5, 1e-7, "d box")


def test_retinanet_postprocess_matches_jax():
    anchors, cls, box, *_ = loss_inputs(5)
    want = jax.jit(jax.vmap(lambda c, b: jrn.retinanet_postprocess(
        jnp.asarray(anchors), c, b, HW, pre_nms_top_n=300, score_thresh=0.3,
        max_det=20)))(jnp.asarray(cls), jnp.asarray(box))
    got = trn.retinanet_postprocess_batched(t(anchors), t(cls), t(box), HW, 300, 0.3, 0.4, 20)
    ok = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), ok)
    assert ok.sum(1).min() > 3
    close(got.xyxy.numpy()[ok], np.asarray(want.xyxy)[ok], 0.0, 1e-4, "boxes")
    close(got.fields["scores"].numpy()[ok], np.asarray(want.fields["scores"])[ok], 0.0, 1e-6)
    np.testing.assert_array_equal(got.fields["labels"].numpy()[ok],
                                  np.asarray(want.fields["labels"])[ok])


@pytest.fixture(scope="module")
def pair():
    kw = dict(body="R-50", out_channels=32, num_classes=3, max_det=16)
    jm = JDetector(**kw)
    v = draw_variables(jm, jnp.zeros((1, *HW, 3)), seed=6, train=False)
    # the head's towers at 4 convs of 256 channels, as JAX's detector builds them
    tm = load_jax_variables(RetinaNetDetector(**kw, device="cpu"), v)
    return jm, v, tm


@pytest.mark.slow
def test_retinanet_detector_matches_jax(pair):
    jm, v, tm = pair
    rng = np.random.default_rng(7)
    x = normal(rng, B, *HW, 3)
    want = jax.jit(lambda a: jm.apply(v, a, train=False))(jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x))
    wd, gd = want["detections"], got["detections"]
    ok = np.asarray(wd.valid)
    np.testing.assert_array_equal(gd.valid.numpy(), ok)
    assert ok.any()
    close(gd.xyxy.numpy()[ok], np.asarray(wd.xyxy)[ok], 0.0, 1e-3, "boxes")
    close(gd.fields["scores"].numpy()[ok], np.asarray(wd.fields["scores"])[ok], 0.0, 1e-5)
    np.testing.assert_array_equal(gd.fields["labels"].numpy()[ok],
                                  np.asarray(wd.fields["labels"])[ok])
    _, _, _, g, labels, valid = loss_inputs(8)
    want = jax.jit(lambda a: jm.apply(v, a, train=True, gt_boxes=jnp.asarray(g),
                                      gt_labels=jnp.asarray(labels), gt_valid=jnp.asarray(valid),
                                      rngs={"sampling": jax.random.PRNGKey(0)}))(jnp.asarray(x))
    tm.train()
    try:
        with torch.no_grad():
            got = tm(t(x), t(g), t(labels), t(valid))
    finally:
        tm.eval()
    assert set(got) == set(want)
    for k in want:
        close(float(got[k]), float(want[k]), 1e-5, 0.0, k)
