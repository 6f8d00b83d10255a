"""Row 14's train form and the RCNN stage's settings against the JAX
package on the CPU: roipool3d_train (the pooled points' and features'
gradient) against autograd of its plain version and jax.vjp of JAX's CPU
roipool3d, the pooling's choice of it, RCNN.LOSS_CLS SigmoidFocalLoss
(and the names that raise), and the proposal target layer with AUG_DATA
False, ROI_FG_AUG_TIMES 5 and AUG_ROT_RANGE 9 on JAX's own draws
(test_torch_rcnn_train.jax_draws).

All float32. Tolerances (stated in CHANGES.md):
- row 14's train form: the Function against autograd of the plain version
  exactly (values) and within 1e-6 * max + 1e-7 (gradients); both against
  jax.vjp of JAX's CPU roipool3d within 1e-6 * max + 1e-7;
- rcnn_loss and the proposal target layer as test_torch_rcnn_train.py
  holds them: 1e-5 * max + 1e-5, labels and flags exactly.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.pointrcnn import rcnn3d as jrcnn
from disprcnn_tpu.ops.roipool3d import roipool3d as jroipool3d
from disprcnn_tpu_torch.models.pointrcnn import point_rcnn as tpr
from disprcnn_tpu_torch.models.pointrcnn import rcnn3d as trcnn
from disprcnn_tpu_torch.ops.cuda import roipool3d as croi
from test_torch_rcnn_train import ANCHOR, jax_draws, port_draws, rcnn_scene
from test_torch_train import close


def t(x):
    return torch.from_numpy(np.array(x))


# -- row 14's train form -----------------------------------------------------------

def pool_inputs(seed):
    """Clouds with feature channels, boxes with many points, few points (the
    tail cycles), none (empty) and overlapping ones."""
    rng = np.random.default_rng(seed)
    b, n, m, c = 2, 96, 5, 6
    pts = (rng.standard_normal((b, n, 3)) * [1.5, 0.5, 1.5]).astype(np.float32)
    pts[:, 5] = pts[:, 2]
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    boxes = np.zeros((b, m, 7), np.float32)
    boxes[:, :, 3:6] = [1.2, 1.5, 2.5]
    boxes[:, 0, :3] = [0.0, 0.5, 0.0]
    boxes[:, 0, 3:6] = [1.6, 3.0, 4.0]  # more points than slots
    boxes[:, 1, :3] = [0.5, 0.5, 0.3]
    boxes[:, 1, 3:6] = [1.0, 0.8, 1.0]  # a few points
    boxes[:, 2, :3] = [40.0, 0.0, 40.0]  # empty
    boxes[:, 3] = boxes[:, 0] + [0.3, 0, 0.2, 0, 0, 0, 0.7]
    boxes[:, 4, :3] = [-1.0, 0.4, -0.5]
    boxes[:, 4, 6] = -0.4
    return pts, feats, boxes, rng.standard_normal((b, m, 24, 3 + c)).astype(np.float32)


def test_roipool3d_train_matches_plain_and_jax(monkeypatch):
    """roipool3d_train's autograd Function (its launch point routed to the
    plain version, as on the CPU it cannot launch) against autograd of the
    plain version and jax.vjp of JAX's CPU roipool3d (the gather route JAX
    differentiates): the pooled rows and the empty flags equal, the
    gradients in the points and the features under a non-uniform output
    gradient, nothing from the empty box."""
    monkeypatch.setattr(croi, "roipool3d_train_cuda", croi.roipool3d_plain)
    pts, feats, boxes, ct = pool_inputs(3)
    s = 24
    runs = []
    for use_fn in (True, False):
        tp, tf = t(pts).requires_grad_(True), t(feats).requires_grad_(True)
        if use_fn:
            pooled, empty = croi._RoIPool3dTrain.apply(tp, tf, t(boxes), s, 10.0)
        else:
            pooled, empty = croi.roipool3d_plain(tp, tf, t(boxes), s)
        pooled.backward(t(ct))
        runs.append((pooled.detach(), empty, tp.grad, tf.grad))
    (fp, fe, fdp, fdf), (pp, pe, pdp, pdf) = runs
    assert torch.equal(fp, pp) and torch.equal(fe, pe)
    assert fe[:, 2].all() and not fe[:, [0, 1, 3, 4]].any()
    close(fdp.numpy(), pdp.numpy(), 1e-6, 1e-7, "d pts")
    close(fdf.numpy(), pdf.numpy(), 1e-6, 1e-7, "d feats")

    @jax.jit
    def jax_side(p, f, c):
        (out, empty), vjp = jax.vjp(lambda a, b: jroipool3d(a, b, jnp.asarray(boxes), s),
                                    p, f)
        return out, empty, vjp((c, np.zeros(empty.shape, jax.dtypes.float0)))

    wp, we, (wdp, wdf) = jax_side(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(ct))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(fe.numpy(), np.asarray(we))
    close(fdp.numpy(), wdp, 1e-6, 1e-7, "d pts vs JAX")
    close(fdf.numpy(), wdf, 1e-6, 1e-7, "d feats vs JAX")
    assert np.abs(np.asarray(wdf)).sum() > 0


def test_pool_takes_the_train_form_only_with_a_gradient(monkeypatch):
    """rcnn3d's pooling takes roipool3d_train where the features need a
    gradient and the eval wrapper otherwise (both CPU here: the plain
    version behind each)."""
    calls = []
    for name in ("roipool3d", "roipool3d_train"):
        orig = getattr(trcnn, name)
        monkeypatch.setattr(trcnn, name,
                            lambda *a, _n=name, _o=orig: calls.append(_n) or _o(*a))
    pts, feats, boxes, _ = pool_inputs(4)
    seg = torch.ones(pts.shape[:2])
    trcnn.pool_rcnn_inputs(t(pts), t(feats), seg, t(boxes), num_points=16)
    trcnn._pool(t(pts), t(feats).requires_grad_(True), seg, t(boxes), 16, 1.0)
    with torch.no_grad():
        trcnn._pool(t(pts), t(feats).requires_grad_(True), seg, t(boxes), 16, 1.0)
    assert calls == ["roipool3d", "roipool3d_train", "roipool3d"]


# -- the RCNN's loss forms and the proposal target layer's settings ---------------------

@pytest.mark.parametrize("with_fg", [True, False])
def test_rcnn_focal_loss_matches_jax(with_fg):
    """RCNN.LOSS_CLS SigmoidFocalLoss: the focal loss summed over the
    labelled rois and divided by the labelled foreground (at least 1), plus
    the bin-based terms, and its gradients."""
    rng = np.random.default_rng(16)
    n = 24
    cls = rng.standard_normal(n).astype(np.float32) * 2
    reg = rng.standard_normal((n, jrcnn.RCNN_CODEC.reg_channels)).astype(np.float32)
    label = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
    if not with_fg:
        label[label > 0] = 0.0  # the normalizer's floor of 1
    mask = (label > 0) & (rng.uniform(size=n) > 0.3)
    gt_ct = np.concatenate([rng.uniform(-1.5, 1.5, (n, 3)), rng.uniform(1, 4, (n, 3)),
                            rng.uniform(-1, 1, (n, 1))], -1).astype(np.float32)
    f = lambda c, g: jrcnn.rcnn_loss(c, g, jnp.asarray(label), jnp.asarray(mask),
                                     jnp.asarray(gt_ct), jnp.asarray(ANCHOR),
                                     loss_cls="SigmoidFocalLoss")
    want, (wc, wg) = jax.jit(jax.value_and_grad(f, (0, 1)))(jnp.asarray(cls), jnp.asarray(reg))
    tc, tg = t(cls).requires_grad_(True), t(reg).requires_grad_(True)
    got = trcnn.rcnn_loss(tc, tg, t(label), t(mask), t(gt_ct), t(ANCHOR),
                          loss_cls="SigmoidFocalLoss")
    got.backward()
    close(got.detach().numpy(), want, 1e-5, 1e-5)
    close(tc.grad.numpy(), wc, 1e-5, 1e-5)
    close(tg.grad.numpy(), wg, 1e-5, 1e-5)
    bce = trcnn.rcnn_loss(t(cls), t(reg), t(label), t(mask), t(gt_ct), t(ANCHOR))
    assert abs(float(bce) - float(want)) > 1e-3  # another loss than the BCE


def test_rcnn_loss_cls_other_names_raise():
    """The reference's CrossEntropy branch reads an undefined name; the JAX
    package leaves it out, and so does the port, at the loss and at the
    model."""
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="CrossEntropy"):
        trcnn.rcnn_loss(z, torch.zeros(2, 76), z, z > 0, torch.zeros(2, 7), t(ANCHOR),
                        loss_cls="CrossEntropy")
    with pytest.raises(ValueError, match="rcnn_loss_cls"):
        tpr.PointRCNN(npoints=64, sa_npoints=(64, 32, 16, 8), rcnn_loss_cls="CrossEntropy")


@pytest.mark.parametrize("setting", [dict(aug_data=False), dict(fg_aug_times=5),
                                     dict(aug_rot_range=9.0)], ids=str)
def test_proposal_target_layer_settings_match_jax(setting):
    """prepare_rcnn_train_inputs with AUG_DATA False (no noise, no rotation,
    scaling or flip), ROI_FG_AUG_TIMES 5 (5 noise trials) and
    AUG_ROT_RANGE 9 (rotations up to pi / 9), on the draws JAX takes from
    one key: the pooled inputs, labels, masks, canonical GT, rois and
    flags."""
    gt, rois, valid, gt_ok, xyz, feats, seg = rcnn_scene(4)
    r, m, k = rois.shape[0], rois.shape[1], 8
    times = setting.get("fg_aug_times", 10)
    key = jax.random.PRNGKey(21)
    draws = port_draws(jax_draws(key, r, m, k, times))
    J = jnp.asarray
    wp = jax.jit(partial(jrcnn.prepare_rcnn_train_inputs, rois_per_instance=k, num_points=64,
                         **setting))(key, J(rois), J(valid), J(gt), J(gt_ok), J(xyz), J(feats),
                                     J(seg))
    gp = trcnn.prepare_rcnn_train_inputs(t(rois), t(valid), t(gt), t(gt_ok), t(xyz), t(feats),
                                         t(seg), draws, rois_per_instance=k, num_points=64,
                                         **setting)
    close(gp[0].numpy(), wp[0], 1e-5, 1e-5)
    for g, w in zip(gp[1:3], wp[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(gp[3:5], wp[3:5]):
        close(g.numpy(), w, 1e-5, 1e-5)
    np.testing.assert_array_equal(gp[5].numpy(), np.asarray(wp[5]))
    assert np.asarray(wp[2]).any() and (np.asarray(wp[1]) == 0).any()
    # the setting changes the targets: against another value of it on the same draws
    other = {"aug_data": True, "fg_aug_times": 1, "aug_rot_range": 18.0}
    name, = setting
    moved = trcnn.prepare_rcnn_train_inputs(t(rois), t(valid), t(gt), t(gt_ok), t(xyz),
                                            t(feats), t(seg), draws, rois_per_instance=k,
                                            num_points=64, **{name: other[name]})
    assert not torch.equal(moved[3], gp[3]), name
