"""The port's 2D train step (stage 1, configs/kitti/car/vob/mask.yaml)
against the JAX package on the CPU, at the small detector configuration of
test_torch_detector2d.py (R-50-FPN, 32 channels, 64x128 pairs) with train
budgets that fit its 2046 anchors: the box codec's encoders, anchor
visibility, the matcher and the balanced sampler, the GT mask crops, the
SRPN loss, ROI subsampling and compaction, the box head's loss and
dropout, the mask loss, and whole steps against JAX's make_train_step on
the same weights and draws: mask.yaml's (backbone, RPN and box head frozen)
and one with nothing frozen (tools/bench_train.py bench_2d's form).

The JAX functions draw with jax.random from keys; the tests recompute the
samplers' uniforms from those keys (in a whole step, the two keys DispRCNN
takes with make_rng("sampling"), copied out of the run) and read the box
head's dropout masks from Flax's Dropout outputs, and hand both to the
port, whose draws are inputs (Det2DDraws).

JAX's CPU NMS (the XLA route) fills its empty slots with the lowest
non-kept indices, the port with n - 1 and ok False (ROADMAP C12): the
proposals and the ROIs are compared on valid or sampled rows only; the
other rows carry no loss weight, so losses and gradients are compared
whole.

All float32. Tolerances (stated in CHANGES.md): the encoders 1e-5 * max +
1e-6; the mask crops 1e-6; the SRPN loss, the reg targets, the head and
mask losses and their gradients 1e-5 relative (* max + 1e-7); visibility,
match codes, labels, sampled and positive masks, matched GT and the
compaction's indices exactly; the extractor's features as
test_torch_detector2d.py holds them (atol 1e-4 + rtol 1e-4); in a whole
step the losses 1e-4 * |JAX| + 1e-6, the proposals' coordinates 1e-3 px,
and the gradients and updates in ROADMAP C19's L2 form (per tensor
relative L2 1e-2 and max 5e-2 * max |JAX|, all tensors 5e-3).
"""
import types
from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.engine import trainer as jtrainer
from disprcnn_tpu.models.detector import disprcnn as jdet
from disprcnn_tpu.models.roi_heads import box_head as jbh
from disprcnn_tpu.models.roi_heads import mask_head as jmh
from disprcnn_tpu.models.rpn import box_coder as jbc
from disprcnn_tpu.models.rpn import matcher as jmatcher
from disprcnn_tpu.models.rpn import stereo_rpn as jsrpn
from disprcnn_tpu.models.rpn.anchors import AnchorGenerator as JAnchorGenerator
from disprcnn_tpu.ops import pairwise_iou as jpairwise_iou
from disprcnn_tpu.solver import build as jbuild
from disprcnn_tpu.solver import schedules as jsched
from disprcnn_tpu.structures.masks import crop_and_resize_mask as j_crop_and_resize_mask
from disprcnn_tpu.structures.stereo import StereoBoxes as JStereoBoxes
from disprcnn_tpu_torch.engine.trainer import make_train_step
from disprcnn_tpu_torch.models.detector import disprcnn as tdet
from disprcnn_tpu_torch.models.roi_heads import box_head as tbh
from disprcnn_tpu_torch.models.roi_heads import mask_head as tmh
from disprcnn_tpu_torch.models.rpn import box_coder as tbc
from disprcnn_tpu_torch.models.rpn import matcher as tmatcher
from disprcnn_tpu_torch.models.rpn import stereo_rpn as tsrpn
from disprcnn_tpu_torch.models.rpn import anchors as tanchors
from disprcnn_tpu_torch.ops.iou import pairwise_iou
from disprcnn_tpu_torch.solver import build as tbuild
from disprcnn_tpu_torch.solver import schedules as tsched
from disprcnn_tpu_torch.structures.masks import crop_and_resize_mask
from disprcnn_tpu_torch.structures.stereo import StereoBoxes
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from test_torch_train import close, grads_close, jax_trace
from torch_port_helpers import IMG_HW, TINY, jax_variables

# the detector at test size with train budgets for its 2046 anchors; the
# JAX model also takes its GT slot count, which the port reads off the GT
TRAIN = dict(TINY, pre_nms_top_n_train=300, post_nms_top_n_train=100, roi_batch_per_image=64)
B, M = 2, 4
JTRAIN = dict(TRAIN, max_gt=M)
HWS = [(16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]
# mask.yaml's SOLVER: BASE_LR 0.01, BIAS_LR_FACTOR 1, WEIGHT_DECAY 5e-4,
# OneCycle over MAX_ITER 4140, grad clip 10; the defaults' MOMENTUM 0.9 and
# WEIGHT_DECAY_BIAS 0
SOLVER = dict(OPTIMIZER="SGD", MOMENTUM=0.9, WEIGHT_DECAY=5e-4, WEIGHT_DECAY_BIAS=0.0,
              BIAS_LR_FACTOR=1.0)
MAX_ITER = 4140
MASK_YAML_FROZEN = ("backbone", "rpn_head", "box_extractor", "box_predictor")


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def t(x):
    return torch.from_numpy(np.array(x))


def rel(got, want, r=1e-5, what=""):
    close(got, want, r, 1e-7, what)


def gt_scene(seed, b=B, m=M, hw=IMG_HW):
    """GT pairs (3 valid in the first image, 2 in the second), the right
    box 2-12 px left of the left one, some across the image border, and
    filled ellipses inside each box as masks. -> numpy (gl, gr, labels,
    valid, masks)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    gl = np.zeros((b, m, 4), np.float32)
    valid = np.zeros((b, m), bool)
    for i in range(b):
        for j in range(3 - i):
            bw, bh = rng.uniform(24, 64), rng.uniform(18, 44)
            x1, y1 = rng.uniform(-6, w - bw + 6), rng.uniform(-4, h - bh + 4)
            gl[i, j] = (x1, y1, x1 + bw, y1 + bh)
            valid[i, j] = True
    disp = rng.uniform(2, 12, (b, m, 1)).astype(np.float32)
    gr = (gl - np.concatenate([disp, 0 * disp, disp, 0 * disp], -1)) * valid[..., None]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy = (gl[..., 0] + gl[..., 2]) / 2, (gl[..., 1] + gl[..., 3]) / 2
    ax, ay = 0.45 * (gl[..., 2] - gl[..., 0]), 0.45 * (gl[..., 3] - gl[..., 1])
    inside = ((xx - cx[..., None, None]) / np.maximum(ax, 1)[..., None, None]) ** 2 + \
        ((yy - cy[..., None, None]) / np.maximum(ay, 1)[..., None, None]) ** 2 <= 1
    masks = (inside & valid[..., None, None]).astype(np.float32)
    return gl, gr.astype(np.float32), valid.astype(np.int32), valid, masks


def sampler_uniforms(key, b, n):
    """The (pos, neg) uniforms (b, n) that balanced_sample draws in each of
    b images from jax.random.split(key, b)."""
    def one(k):
        kp, kn = jax.random.split(k)
        return jax.random.uniform(kp, (n,)), jax.random.uniform(kn, (n,))

    up, un = jax.jit(jax.vmap(one))(jax.random.split(key, b))
    return t(up), t(un)


# -- the box codec, anchors ---------------------------------------------------

def test_encoders_and_join_stereo_match_jax():
    rng = np.random.default_rng(0)
    n = 60
    prop = rng.uniform(0, 100, (n, 6)).astype(np.float32)
    prop[:, 2:4] = prop[:, 0:2] + rng.uniform(1, 80, (n, 2))
    prop[:, 5] = prop[:, 4] + rng.uniform(1, 80, n)
    ref = prop + rng.normal(0, 8, (n, 6)).astype(np.float32)
    ref[:, 2:4] = np.maximum(ref[:, 2:4], ref[:, 0:2] + 1)
    ref[:, 5] = np.maximum(ref[:, 5], ref[:, 4] + 1)
    w10 = (10.0, 10.0, 5.0, 5.0)
    cases = [(tbc.encode4(t(ref[:, :4]), t(prop[:, :4]), w10),
              jbc.encode4(ref[:, :4], prop[:, :4], w10)),
             (tbc.encode6(t(ref), t(prop[:, :4])), jbc.encode6(ref, prop[:, :4])),
             (tbc.encode6(t(ref), t(prop), w10), jbc.encode6(ref, prop, w10)),
             (tbc.join_stereo(t(ref[:, :4]), t(prop[:, :4])),
              jbc.join_stereo(ref[:, :4], prop[:, :4]))]
    for got, want in cases:
        close(got.numpy(), want, 1e-5, 1e-6)


@pytest.mark.parametrize("hw, hws", [
    (IMG_HW, HWS),
    ((384, 1248), [(96, 312), (48, 156), (24, 78), (12, 39), (6, 20)]),
    ((97, 31), [(25, 8), (13, 4), (7, 2), (4, 1), (2, 1)])])
def test_anchor_visibility_matches_jax(hw, hws):
    """The anchors and their visibility at the default STRADDLE_THRESH 0,
    on the port's anchors as numpy and as a tensor."""
    got_a = tanchors.AnchorGenerator()(hws)
    want_a, want_v = JAnchorGenerator()(hw, hws)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(tanchors.visibility(got_a, hw), want_v)
    np.testing.assert_array_equal(tanchors.visibility(t(got_a), hw).numpy(), want_v)
    assert want_v.any() and not want_v.all()


# -- the matcher and the sampler -------------------------------------------------

@pytest.mark.parametrize("low_quality", [True, False])
def test_match_matches_jax(low_quality):
    """GT against anchors, with an invalid GT, two identical GT (argmax
    ties) and a GT whose best IoU lies under both thresholds."""
    gl, gr, _, valid, _ = gt_scene(1, b=1)
    gt = np.concatenate([gl[0, :3], gl[0, :1], [[40.0, 20, 44, 23]]]).astype(np.float32)
    gv = np.array([True, True, False, True, True])
    anchors = tanchors.AnchorGenerator()(HWS)
    q = np.asarray(jpairwise_iou(jnp.asarray(gt), jnp.asarray(anchors)))
    got_q = pairwise_iou(t(gt), t(anchors)).numpy()
    np.testing.assert_array_equal(got_q, q)
    for hi, lo in ((0.7, 0.3), (0.5, 0.5)):
        want = np.asarray(jmatcher.match(jnp.asarray(q), jnp.asarray(gv), hi, lo, low_quality))
        got = tmatcher.match(t(q), t(gv), hi, lo, low_quality)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want == -1).any() and (want >= 0).any()
        assert not (want == 3).any()  # the duplicate of GT 0 never wins
        if hi > lo:
            assert (want == -2).any()
    want = np.asarray(jmatcher.match(jnp.asarray(q), jnp.asarray(gv), 0.7, 0.3, low_quality))
    batched = tmatcher.match(t(np.stack([q, q])), t(np.stack([gv, gv])), 0.7, 0.3, low_quality)
    np.testing.assert_array_equal(batched.numpy(), np.stack([want, want]))


@pytest.mark.parametrize("n_pos", [3, 400])
def test_balanced_sample_matches_jax(n_pos):
    """Fewer positives than the cap, and more: the same rows on JAX's own
    uniforms."""
    rng = np.random.default_rng(2)
    n = 2046
    labels = np.full(n, -1, np.int32)
    perm = rng.permutation(n)
    labels[perm[:n_pos]] = 1
    labels[perm[n_pos:n_pos + 900]] = 0
    key = jax.random.PRNGKey(7)
    wp, wn = jax.jit(partial(jmatcher.balanced_sample, batch_size=256,
                             positive_fraction=0.5))(key, jnp.asarray(labels))
    kp, kn = jax.random.split(key)
    up, un = (t(jax.random.uniform(k, (n,))) for k in (kp, kn))
    gp, gn = tmatcher.balanced_sample(t(labels), 256, 0.5, up, un)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert gp.sum() == min(n_pos, 128) and gp.sum() + gn.sum() == 256


# -- GT mask crops -----------------------------------------------------------------

def test_crop_and_resize_mask_matches_jax():
    """Boxes inside, across every border, wider than the image and
    thinner than a pixel, on soft and binary masks."""
    rng = np.random.default_rng(3)
    _, _, _, _, masks = gt_scene(3)
    masks = np.concatenate([masks.reshape(-1, *IMG_HW),
                            rng.uniform(size=(2, *IMG_HW)).astype(np.float32)])
    n = 40
    xy = rng.uniform(-30, 140, (n, 2)).astype(np.float32) * [1, 0.5]
    wh = rng.uniform(0.3, 90, (n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0] = (-20, -10, 150, 80)
    which = rng.integers(0, len(masks), n)
    # op by op: jitted, XLA turns the grid's division by out_size into a
    # product with its reciprocal and fuses box + grid * size into an FMA,
    # which moves a coordinate by an ulp (1.5e-5 px near 128) and a sample
    # of a binary mask by up to 7.6e-6
    want = jax.vmap(lambda i, b_: j_crop_and_resize_mask(jnp.asarray(masks)[i], b_, 28))(
        jnp.asarray(which), jnp.asarray(boxes))
    got = crop_and_resize_mask(t(masks), t(which), t(boxes), 28)
    close(got.numpy(), want, 0.0, 1e-6)
    assert 0 < (np.asarray(want) > 0.5).mean() < 1


# -- the SRPN loss -------------------------------------------------------------------

def test_srpn_loss_matches_jax():
    """Both losses and their gradients in the logits and deltas, on JAX's
    own sampler uniforms; positives from the 0.7 threshold and from
    low-quality matches, anchors across the border ignored."""
    gl, gr, _, valid, _ = gt_scene(4)
    anchors, vis = JAnchorGenerator()(IMG_HW, HWS)
    rng = np.random.default_rng(5)
    n = anchors.shape[0]
    logits = rng.standard_normal((B, n, 2)).astype(np.float32)
    deltas = (0.3 * rng.standard_normal((B, n, 6))).astype(np.float32)
    key = jax.random.PRNGKey(11)

    def f(lg, dl):
        o, b_ = jsrpn.loss(key, jnp.asarray(anchors), jnp.asarray(vis), lg, dl, jnp.asarray(gl),
                           jnp.asarray(gr), jnp.asarray(valid))
        return o + 3.0 * b_, (o, b_)

    (_, want), (wgl, wgd) = jax.jit(jax.value_and_grad(f, (0, 1), has_aux=True))(
        jnp.asarray(logits), jnp.asarray(deltas))
    up, un = sampler_uniforms(key, B, n)
    tl, td = t(logits).requires_grad_(True), t(deltas).requires_grad_(True)
    got = tsrpn.loss(t(anchors), t(vis), tl, td, t(gl), t(gr), t(valid), up, un)
    (got[0] + 3.0 * got[1]).backward()
    for g, w in zip(got, want):
        rel(g.detach().numpy(), w)
    rel(tl.grad.numpy(), wgl, what="d logits")
    rel(td.grad.numpy(), wgd, what="d deltas")
    assert float(want[1]) > 0 and (~vis).any()
    assert np.abs(np.asarray(wgd)).sum(-1).astype(bool).sum() > 2  # positives regress


# -- ROI subsampling and compaction --------------------------------------------------

def roi_proposals(seed, gl, gr, valid, p, invalid_frac, ties):
    """p proposals an image jittered about the GT pairs and random ones,
    the GT appended; `ties` makes every third proposal a copy of the one
    before and duplicates a GT slot."""
    rng = np.random.default_rng(seed)
    b, m = valid.shape
    src = rng.integers(0, 3, (b, p))
    base = gl[np.arange(b)[:, None], src]
    jit = rng.normal(0, 6, (b, p, 4)).astype(np.float32)
    left = np.where(rng.uniform(size=(b, p, 1)) < 0.6, base + jit,
                    rng.uniform(0, 100, (b, p, 4)) + [0, 0, 20, 20]).astype(np.float32)
    left[..., 2:] = np.maximum(left[..., 2:], left[..., :2] + 2)
    shift = rng.uniform(2, 12, (b, p, 1)).astype(np.float32)
    right = left - np.concatenate([shift, 0 * shift, shift, 0 * shift], -1)
    if ties:  # p = 100: rows 1, 4, ..., 97 copy rows 0, 3, ..., 96
        left[:, 1::3], right[:, 1::3] = left[:, 0:-1:3], right[:, 0:-1:3]
    pv = rng.uniform(size=(b, p)) >= invalid_frac
    return (np.concatenate([left, gl], 1), np.concatenate([right, gr], 1),
            np.concatenate([rng.uniform(size=(b, p)), np.ones((b, m))], 1).astype(np.float32),
            np.concatenate([pv, valid], 1))


@pytest.mark.parametrize("ties", [False, True])
def test_subsample_and_compaction_match_jax(ties):
    """subsample per image and the compaction on JAX's uniforms: labels,
    matched GT, positives, sampled rows and the compacted rows' indices
    exactly, the regression targets to 1e-5. ties: copied proposals and a
    duplicated GT (IoU ties in the matcher) and most proposals invalid,
    so that fewer rows are sampled than roi_batch and the compaction takes
    unsampled rows, all of one priority, in index order."""
    gl, gr, labels, valid, _ = gt_scene(6)
    if ties:
        gl[0, 3], gr[0, 3], labels[0, 3], valid[0, 3] = gl[0, 0], gr[0, 0], 1, True
    p, roi_batch = 100, 64
    left, right, score, pvalid = roi_proposals(7, gl, gr, valid, p, 0.8 if ties else 0.1, ties)
    key = jax.random.PRNGKey(13)
    jp = JStereoBoxes(left=jnp.asarray(left), right=jnp.asarray(right), score=jnp.asarray(score),
                      valid=jnp.asarray(pvalid),
                      fields={"index": jnp.broadcast_to(jnp.arange(p + M), (B, p + M))})

    @jax.jit
    def jax_side(key, props):
        out = jax.vmap(lambda k, pr, a, b_, c, d: jbh.subsample(k, pr, a, b_, c, d, batch_size=roi_batch))(
            jax.random.split(key, B), props, jnp.asarray(gl), jnp.asarray(gr),
            jnp.asarray(labels), jnp.asarray(valid))
        return out, jdet._compact_sampled(props, *out[:4], out[4], roi_batch)

    (wl, wr, wp, ws, wm), (wrois, wmeta) = jax_side(key, jp)
    up, un = sampler_uniforms(key, B, p + M)
    tp = StereoBoxes(left=t(left), right=t(right), score=t(score), valid=t(pvalid),
                     fields={"index": torch.arange(p + M).expand(B, -1)})
    lab, regt, pos, samp, mg = tbh.subsample(tp, t(gl), t(gr), t(labels), t(valid), up, un,
                                             batch_size=roi_batch)
    for g, w in ((lab, wl), (pos, wp), (samp, ws), (mg, wm)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sampled = np.asarray(ws)
    close(regt.numpy(), wr, 1e-5, 1e-6)
    rois, meta = tdet.compact_sampled(tp, lab, regt, pos, samp, mg, roi_batch)
    np.testing.assert_array_equal(rois.fields["index"].numpy(), np.asarray(wrois.fields["index"]))
    np.testing.assert_array_equal(rois.valid.numpy(), np.asarray(wrois.valid))
    np.testing.assert_array_equal(rois.left.numpy(), np.asarray(wrois.left))
    for k in ("labels", "pos", "sampled", "matched_gt"):
        np.testing.assert_array_equal(meta[k].numpy(), np.asarray(wmeta[k]), err_msg=k)
    close(meta["reg_targets"].numpy(), wmeta["reg_targets"], 1e-5, 1e-6)
    n_sampled = sampled.sum(1)
    assert np.asarray(wp).any(1).all()
    if ties:
        assert (n_sampled < roi_batch).all() and (np.asarray(wm)[0] == 3).sum() == 0


# -- the box head's and the mask head's losses -----------------------------------------

def test_head_and_mask_losses_match_jax():
    rng = np.random.default_rng(8)
    p = 40
    logits = rng.standard_normal((p, 2)).astype(np.float32)
    deltas = rng.standard_normal((p, 12)).astype(np.float32)
    labels = rng.choice([-1, 0, 1], p).astype(np.int32)
    sampled = labels >= 0
    pos = labels == 1
    regt = rng.standard_normal((p, 6)).astype(np.float32)
    mlog = (2 * rng.standard_normal((p, 28, 28, 2))).astype(np.float32)
    _, _, _, _, masks = gt_scene(9)
    masks = masks.reshape(-1, *IMG_HW)
    boxes = np.abs(rng.uniform(0, 100, (p, 4))).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(4, 60, (p, 2))
    mg = rng.integers(0, len(masks), p)

    def f(lg, dl, ml):
        c, b_ = jbh.head_loss(lg, dl, jnp.asarray(labels), jnp.asarray(regt), jnp.asarray(pos),
                              jnp.asarray(sampled))
        mk = jmh.mask_loss(ml, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(pos),
                           jnp.asarray(masks), jnp.asarray(mg))
        return c + 2 * b_ + 3 * mk, (c, b_, mk)

    (_, want), wg = jax.jit(jax.value_and_grad(f, (0, 1, 2), has_aux=True))(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(mlog))
    tl, td = t(logits).requires_grad_(True), t(deltas).requires_grad_(True)
    tm = t(mlog.transpose(0, 3, 1, 2)).requires_grad_(True)
    c, b_ = tbh.head_loss(tl, td, t(labels), t(regt), t(pos), t(sampled))
    mk = tmh.mask_loss(tm, t(boxes), t(labels), t(pos), t(masks), t(mg))
    (c + 2 * b_ + 3 * mk).backward()
    for g, w in zip((c, b_, mk), want):
        rel(g.detach().numpy(), w)
    rel(tl.grad.numpy(), wg[0], what="d logits")
    rel(td.grad.numpy(), wg[1], what="d deltas")
    rel(tm.grad.numpy().transpose(0, 2, 3, 1), wg[2], what="d mask logits")


def dropout_recorder(record):
    """A flax.linen.intercept_methods interceptor that copies every
    Dropout's output into `record` by module path when the run executes."""
    def icpt(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            path = "/".join(context.module.scope.path)
            jax.debug.callback(lambda o: record.__setitem__(path, np.array(o)), out)
        return out
    return icpt


def keep_masks(record, prefix=""):
    """The box head's two keep masks (R, mlp_dim) from recorded Dropout
    outputs (a dropped entry and a ReLU zero both read 0; either way the
    entry is 0 and passes no gradient)."""
    return tuple(t(record[f"{prefix}Dropout_{i}"] != 0).reshape(-1, TRAIN["mlp_head_dim"])
                 for i in range(2))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its numpy variables, the port model with them loaded)."""
    jm = jdet.DispRCNN(**JTRAIN)
    variables = jax_variables(jm, seed=0)
    tm = load_jax_variables(tdet.DispRCNN(**TRAIN, device="cpu"), variables)
    return jm, variables, tm


@pytest.mark.parametrize("m", [1, 4, 7])
def test_train_forward_draws_from_a_generator(pair, m):
    """Without draws the train forward draws them from `generator`, sized
    by the anchors and by the GT's m slots: the same losses and sampling as
    with draw_det2d_draws on a generator of the same seed; with neither it
    refuses."""
    tm = pair[2]
    batch = {k: t(x) for k, x in step_batch(20 + m, m).items()}
    tm.train()
    try:
        with torch.no_grad():
            got = tm(**batch, generator=torch.Generator().manual_seed(m))
            draws = tdet.draw_det2d_draws(
                B, 2046, TRAIN["post_nms_top_n_train"] + m, TRAIN["roi_batch_per_image"],
                TRAIN["mlp_head_dim"], torch.Generator().manual_seed(m))
            want = tm(**batch, draws=draws)
        with pytest.raises(ValueError, match="draws or a generator"):
            tm(**batch)
    finally:
        tm.eval()
    assert got["proposals"].left.shape[1] == got["roi_pos"].shape[1] == 100 + m
    for k in want:
        if k.startswith("loss"):
            assert torch.equal(got[k], want[k]) and torch.isfinite(got[k]), k
    assert torch.equal(got["roi_pos"], want["roi_pos"]) and got["roi_pos"].any(1).all()


def test_box_extractor_train_matches_jax(pair):
    """The extractor in train mode: dropout 0.2 after rcnn_top0 and
    rcnn_top1 on the masks JAX drew; the port refuses train mode without
    masks."""
    _, v, tm = pair
    rng = np.random.default_rng(10)
    feats = [[rng.standard_normal((B, 32, 64 // s, 128 // s)).astype(np.float32)
              for s in (4, 8, 16, 32)] for _ in range(2)]
    boxes = rng.uniform(0, 60, (2, B * 16, 4)).astype(np.float32)
    boxes[..., 2:] += rng.uniform(4, 60, (2, B * 16, 2)).astype(np.float32)
    bi = np.repeat(np.arange(B, dtype=np.int32), 16)
    props = JStereoBoxes(left=jnp.asarray(boxes[0]), right=jnp.asarray(boxes[1]),
                         score=jnp.ones(B * 16), valid=jnp.ones(B * 16, bool))
    ext = jbh.StereoBoxFeatureExtractor(mlp_dim=TRAIN["mlp_head_dim"])
    drawn = {}

    @jax.jit
    def run(p, lf, rf, pr, b_):
        with fnn.intercept_methods(dropout_recorder(drawn)):
            return ext.apply(p, lf, rf, pr, b_, train=True, rngs={"dropout": jax.random.PRNGKey(4)})

    nhwc = lambda fs: [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in fs]
    want = run({"params": v["params"]["box_extractor"]}, nhwc(feats[0]), nhwc(feats[1]), props,
               jnp.asarray(bi))
    jax.block_until_ready(want)
    keep = keep_masks(drawn)
    assert 0.3 < float(keep[0].float().mean()) < 0.8 and not keep[0].all()
    ext_t = tm.box_extractor
    ext_t.train()
    try:
        with pytest.raises(ValueError, match="keep masks"):
            ext_t([t(f) for f in feats[0]], [t(f) for f in feats[1]], t(boxes[0]),
                  t(boxes[1]), t(bi))
        with torch.no_grad():
            got = ext_t([t(f) for f in feats[0]], [t(f) for f in feats[1]], t(boxes[0]),
                        t(boxes[1]), t(bi), keep=keep)
    finally:
        ext_t.eval()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# -- whole train steps ----------------------------------------------------------------

def step_batch(seed=12, m=M):
    """Random images and gt_scene's GT in m slots (its first m where m < 3)."""
    rng = np.random.default_rng(seed)
    left, right = (rng.standard_normal((B, *IMG_HW, 3)).astype(np.float32) for _ in range(2))
    gl, gr, labels, valid, masks = (x[:, :m] for x in gt_scene(seed, m=max(m, 3)))
    return dict(left=left, right=right, gt_left=gl, gt_right=gr, gt_labels=labels,
                gt_valid=valid, gt_masks=masks)


def jax_step(jm, v, frozen):
    """JAX's make_train_step with mask.yaml's SOLVER and `frozen`, jitted,
    with the two sampling keys, the SRPN's proposals and the ROI sampler's
    outputs and the Dropout outputs copied out of the run."""
    drawn, keys = {}, {}
    orig_rng, orig_compact = fnn.Module.make_rng, jdet._compact_sampled

    def make_rng(self, name="params"):
        k = orig_rng(self, name)
        if name == "sampling" and isinstance(self, jdet.DispRCNN):
            i = len(keys)
            keys[i] = None
            jax.debug.callback(lambda kk: keys.__setitem__(i, np.array(kk)), k)
        return k

    def compact(proposals, labels, reg_targets, pos, sampled, matched_gt, roi_batch):
        jax.debug.callback(lambda *a: drawn.__setitem__("subsample", [np.array(x) for x in a]),
                           proposals.left, proposals.right, proposals.valid, labels,
                           reg_targets, pos, sampled, matched_gt)
        return orig_compact(proposals, labels, reg_targets, pos, sampled, matched_gt, roi_batch)

    cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(**SOLVER))
    sched = jsched.one_cycle(0.01, MAX_ITER)
    tx = jbuild.make_optimizer(cfg, v["params"], sched, frozen,
                               momentum_schedule=jsched.one_cycle_momentum(MAX_ITER))
    state = jtrainer.create_train_state(jm, tx, v)
    step = jtrainer.make_train_step(jm, tx, do_grad_clip=True, grad_clip=10.0,
                                    stop_grad_prefixes=frozen)

    def run(batch):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fnn.Module, "make_rng", make_rng)
            mp.setattr(jdet, "_compact_sampled", compact)

            @jax.jit
            def run_step(st, bb):
                with fnn.intercept_methods(dropout_recorder(drawn)):
                    return step(st, bb, jax.random.PRNGKey(3))

            out = run_step(state, {k: jnp.asarray(x) for k, x in batch.items()})
            jax.block_until_ready(out)
        return out, drawn, [keys[i] for i in sorted(keys)]

    return run, float(sched(0))


def port_draws(keys, drawn, n_anchors):
    """The port's Det2DDraws of a JAX step: the samplers' uniforms from the
    two sampling keys, the dropout masks from the Dropout outputs."""
    rpn_pos, rpn_neg = sampler_uniforms(jnp.asarray(keys[0]), B, n_anchors)
    roi_pos, roi_neg = sampler_uniforms(jnp.asarray(keys[1]), B,
                                        TRAIN["post_nms_top_n_train"] + M)
    keep0, keep1 = keep_masks(drawn, "box_extractor/")
    return tdet.Det2DDraws(rpn_pos, rpn_neg, roi_pos, roi_neg, keep0, keep1)


def check_2d_step(tm, old, opt, got, metrics, new_state, v, lr, without_grad=()):
    """A port TrainStep's results against JAX's make_train_step's, one step
    from the same weights: the losses, the gradients (JAX's momentum trace
    after its first update is g + wd * p, wd = 0 on the biases), the
    momentum buffers and the updated parameters; the frozen ones unchanged.
    `without_grad`: the parameters that the backward leaves without a
    gradient (the trainer gives them zeros), whose JAX gradient must be 0.
    -> the names of the trainable parameters."""
    assert float(metrics["skipped_nonfinite"]) == 0 and float(got["skipped_nonfinite"]) == 0
    assert int(got["params_without_grad"]) == len(without_grad) and opt.count == 1
    for k in metrics:
        if k.startswith("loss"):
            close(got[k].numpy(), metrics[k], 1e-4, 1e-6, k)
    sd = lambda params: state_dict_from_jax(tm, {"params": params, "frozen": v["frozen"]})
    trace = sd(jax_trace(new_state.opt_state, new_state.params))
    new = sd(new_state.params)
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    bias = {n: n.endswith(".bias") for n in names}
    params = dict(tm.named_parameters())
    wd = SOLVER["WEIGHT_DECAY"]
    want_g = {n: trace[n].numpy() - (0.0 if bias[n] else wd) * old[n].numpy() for n in names}
    for n in without_grad:
        assert not want_g[n].any(), n
    grads_close({n: params[n].grad.numpy() for n in names}, want_g)
    grads_close({n: opt.sgd.state[params[n]]["momentum_buffer"].numpy() for n in names},
                {n: trace[n].numpy() for n in names})
    for n in names:  # the update carries the gradient's tolerance times the rate
        close(params[n].detach().numpy(), new[n].numpy(), 1e-5,
              1e-7 + lr * 5e-2 * np.abs(trace[n].numpy()).max(), n)
    for n, p in tm.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p.detach(), old[n]), n
    return names


def run_port_step(v, batch, draws, frozen):
    tm = load_jax_variables(tdet.DispRCNN(**TRAIN, device="cpu"), v)
    opt = tbuild.make_optimizer(tm, tsched.one_cycle(0.01, MAX_ITER),
                                tsched.one_cycle_momentum(MAX_ITER), frozen, momentum=0.9,
                                weight_decay=5e-4, weight_decay_bias=0.0, bias_lr_factor=1.0)
    old = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step = make_train_step(tm, opt, do_grad_clip=True, grad_clip=10.0)
    seen = {}
    orig = tdet.compact_sampled

    def compact(proposals, *args):
        seen["subsample"] = (proposals,) + args[:5]
        return orig(proposals, *args)

    roi_pos = []
    tm.register_forward_hook(lambda mod, args, out: roi_pos.append(out["roi_pos"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdet, "compact_sampled", compact)
        got = step(dict({k: t(x) for k, x in batch.items()}, draws=draws))
    # the forward's roi_pos is the sampling's positive mask
    assert len(roi_pos) == 1 and torch.equal(roi_pos[0], seen["subsample"][3])
    return tm, opt, old, got, seen["subsample"]


def check_sampling(seen, drawn):
    """The port's proposals (valid rows, C12) and ROI sampling against
    JAX's."""
    props, labels, regt, pos, sampled, mg = seen
    wl, wr, wv, wlab, wregt, wpos, wsamp, wmg = drawn["subsample"]
    np.testing.assert_array_equal(props.valid.numpy(), wv)
    close(props.left.detach().numpy()[wv], wl[wv], 0.0, 1e-3, "proposals")
    close(props.right.detach().numpy()[wv], wr[wv], 0.0, 1e-3, "proposals")
    for g, w, k in ((labels, wlab, "labels"), (pos, wpos, "pos"), (sampled, wsamp, "sampled")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
    np.testing.assert_array_equal(mg.numpy()[wsamp], wmg[wsamp])
    close(regt.detach().numpy()[wsamp], wregt[wsamp], 1e-4, 1e-5, "reg_targets")
    assert wpos.any(1).all() and (wsamp.sum(1) == TRAIN["roi_batch_per_image"]).all()


def test_mask_yaml_step_matches_jax(pair):
    """mask.yaml's step: backbone, RPN and box head frozen, so only the
    mask head trains, while all five losses are computed (the box head's
    on its dropped features): the losses, the proposals and the ROI
    sampling, the mask head's gradients, momentum and update, the frozen
    parameters and FrozenBN constants unchanged."""
    jm, v, _ = pair
    batch = step_batch()
    run, lr = jax_step(jm, v, MASK_YAML_FROZEN)
    (new_state, metrics), drawn, keys = run(batch)
    draws = port_draws(keys, drawn, 2046)
    frozen = tbuild.frozen_path_prefixes(FIX_BACKBONE=True, FIX_RPN=True, FIX_BOX_HEAD=True)
    assert frozen == MASK_YAML_FROZEN
    tm, opt, old, got, seen = run_port_step(v, batch, draws, frozen)
    check_sampling(seen, drawn)
    assert set(metrics) - {"skipped_nonfinite"} == {
        "loss_total", "loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
        "loss_mask"}
    buffers = dict(tm.named_buffers())
    names = check_2d_step(tm, old, opt, got, metrics, new_state, v, lr)
    assert names and all(n.startswith("mask_head.") for n in names)
    assert len(names) == len(list(tm.mask_head.parameters()))
    want_buffers = state_dict_from_jax(tm, {"params": v["params"], "frozen": v["frozen"]})
    for n, b_ in buffers.items():
        assert torch.equal(b_, want_buffers[n]), n


def test_unfrozen_step_matches_jax(pair):
    """The step with nothing frozen (bench_2d's form, mask.yaml's SOLVER):
    every trainable tensor's gradient, momentum and update, the backbone
    included. The freeze_at = 2 boundary: the stem and layer1 get no
    gradient in the port and a zero one in JAX. The proposals' coordinates
    carry gradient into the RPN head through the box and mask losses in
    JAX (checked first, on a step of those three losses alone), and the
    port's gradient of those losses there is held to JAX's."""
    jm, v, _ = pair
    batch = step_batch()
    run, lr = jax_step(jm, v, ())
    (new_state, metrics), drawn, keys = run(batch)
    draws = port_draws(keys, drawn, 2046)

    # the same forward (the step's rngs for step 0) with the box and mask
    # losses alone, differentiated in the RPN head's parameters
    r1, r2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 0))
    heads = ("loss_classifier", "loss_box_reg", "loss_mask")

    @jax.jit
    def head_grad(rpn_params):
        def f(rp):
            params = dict(v["params"], rpn_head=rp)
            out = jm.apply({"params": params, "frozen": v["frozen"]}, train=True,
                           rngs={"sampling": r1, "dropout": r2},
                           **{k: jnp.asarray(x) for k, x in batch.items()})
            return sum(out[k] for k in heads)
        return jax.grad(f)(rpn_params)

    want_head = head_grad(v["params"]["rpn_head"])
    kernel = v["params"]["rpn_head"]["bbox_pred"]["kernel"]
    total = jax_trace(new_state.opt_state, new_state.params)["rpn_head"]["bbox_pred"]["kernel"] \
        - SOLVER["WEIGHT_DECAY"] * kernel
    through = np.linalg.norm(np.asarray(want_head["bbox_pred"]["kernel"]))
    print(f"rpn_head.bbox_pred: |grad of the box and mask losses| {through:.4g}, |clipped "
          f"grad of the step| {np.linalg.norm(total):.4g}")
    assert through > 0.05 * np.linalg.norm(total), (through, np.linalg.norm(total))

    tm, opt, old, got, seen = run_port_step(v, batch, draws, ())
    check_sampling(seen, drawn)
    no_grad = [n for n, _ in tm.named_parameters()
               if n.startswith(("backbone.body.stem.", "backbone.body.layer1_"))]
    assert no_grad
    names = check_2d_step(tm, old, opt, got, metrics, new_state, v, lr, without_grad=no_grad)
    assert len(names) == len(list(tm.parameters()))

    # the port's gradient of the box and mask losses in the RPN head
    tm2 = load_jax_variables(tdet.DispRCNN(**TRAIN, device="cpu"), v)
    tm2.train()
    out = tm2(**{k: t(x) for k, x in batch.items()}, draws=draws)
    sum(out[k] for k in heads).backward()
    sd = state_dict_from_jax(tm2, {"params": dict(v["params"], rpn_head=jax.tree_util.tree_map(
        np.asarray, want_head)), "frozen": v["frozen"]})
    # the objectness logits reach none of the three losses: no gradient
    rpn = {n: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
           for n, p in tm2.named_parameters() if n.startswith("rpn_head.")}
    grads_close(rpn, {n: sd[n].numpy() for n in rpn})
