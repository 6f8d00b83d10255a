"""The bf16 kernel forms of the train stages and of the SA-off route
(ROADMAP A8.3b, A8.4) on the CPU, against the JAX package: row 12's bf16
weight packing (the image its wgmma descriptors read), and the train forms
of rows 8, 11 and 14 on bf16 inputs (the port's plain versions, and their
autograd Functions with the card's launch points routed to those plain
versions) against packed_conv_train, sa_ball_mlp_max_train (Pallas
kernels in interpret mode, their XLA backwards) and JAX's RoI-pool
gradient; and the train-mode arithmetic around them at bf16: Flax's
BatchNorm(dtype=bfloat16), the JAX package's _PackedBN and the XLA
regression of PSMNet's deep supervision with jax.nn.softmax's gradient.

Tolerances, with their reasons:
- a bf16 output of the same arithmetic (one rounding of float32 sums):
  none more than one bf16 step apart beyond the float32 sums' floor
  (ops/cuda/conv3d.py::bf16_agreement; K F32_SUM_ERR of the sum of |terms|),
  at most one step where the floor is under a step;
- a float32 gradient built from bf16-rounded pieces (the weights' and the
  affine's), a rounding that falls the other way moves a few terms by a
  bf16 step: C19's L2 form, per tensor relative 2e-2 and max |diff| 5e-2 of
  max |JAX| (bf16 steps are 2^-8 relative, ~100x float32's), unless stated;
- the Functions against autograd of their plain versions: the same
  arithmetic, 1e-5 of max (float32) or bit-equal;
- row 14's rows: bit-equal; its bf16 feature gradient within one bf16 step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from disprcnn_tpu.models.psmnet import psmnet as jpsm
from disprcnn_tpu.ops.conv3d_packed import pack_depth, unpack_depth
from disprcnn_tpu.ops.pallas.packed_conv import packed_conv_train
from disprcnn_tpu.ops.pallas.sa_fused import sa_ball_mlp_max_train as jsa_train
from disprcnn_tpu.ops.roipool3d import roipool3d as jroipool3d
from disprcnn_tpu_torch.models.psmnet import psmnet as tpsm
from disprcnn_tpu_torch.ops.cuda import conv3d as cconv
from disprcnn_tpu_torch.ops.cuda import grouped_mlp as tgm
from disprcnn_tpu_torch.ops.cuda import roipool3d as croi
from disprcnn_tpu_torch.ops.cuda import sa as csa
from disprcnn_tpu_torch.ops.cuda.softargmin import softargmin_train_bf16
from disprcnn_tpu_torch.ops.losses import binary_cross_entropy
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

BF16 = torch.bfloat16


def t(x):
    return torch.from_numpy(np.array(x))


def tbf(x):
    return t(np.asarray(x, np.float32)).to(BF16)


def bf16_values(rng, *shape, scale=1.0):
    """float32 numbers that are bf16 values."""
    return tbf(rng.standard_normal(shape).astype(np.float32) * scale).float().numpy()


def within_step(got: torch.Tensor, want, floor, what=""):
    """got and want (bf16): none beyond a step and the floor, at most one
    step where the floor is under a step."""
    want = tbf(want) if not torch.is_tensor(want) else want
    assert got.dtype == BF16 and got.shape == want.shape, (what, got.shape, want.shape)
    agree = cconv.bf16_agreement(got, want, floor)
    assert agree["beyond"] == 0 and agree["max_ulps_clear"] <= 1, (what, agree)
    return agree


def l2_close(got, want, what="", rel=2e-2, peak=5e-2):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape and np.isfinite(g).all(), what
    d = np.sqrt(((g - w) ** 2).sum())
    assert d <= rel * np.sqrt((w ** 2).sum()) + 1e-12, (what, d / np.sqrt((w ** 2).sum()))
    assert np.abs(g - w).max() <= peak * np.abs(w).max() + 1e-12, what


# -- row 12: the bf16 form's weight image ---------------------------------------

@pytest.mark.parametrize("nc", tgm.CHUNKS)
@pytest.mark.parametrize("widths", [(64, 196, 256), (128, 128, 128), (65, 70, 33, 18),
                                    (256, 384, 512), (64, 96, 128)])
def test_pack_wgmma_chain_bf16_is_the_descriptor_layout(widths, nc):
    """pack_wgmma_chain_bf16: for each layer W (Ci, Co), chunk c of nc
    columns (width NCW, the last one narrower, widths padded to 32), slab s
    of 32 K values and k16 step kk, the image starts at the chunk's offset +
    32 NCW s + 16 NCW kk bf16 values; from there the descriptor (no
    swizzle, leading byte offset 128, stride byte offset 256) reads W[k, n]
    rounded to bf16 at byte 256 (n // 8) + 128 (k // 8) + 16 (n % 8) + 2 (k
    % 8) of the step (k, n within it): core matrices of 8 columns x 8 K
    values. Every other value is zero; two values a word, the lower K in
    the lower half."""
    rng = np.random.default_rng(len(widths) + nc)
    ws = [(torch.from_numpy(rng.standard_normal((ci, co)).astype(np.float32)), torch.zeros(co))
          for ci, co in zip(widths, widths[1:])]
    words = tgm.pack_wgmma_chain_bf16(ws, nc)
    assert words.dtype == torch.int32
    packed = words.view(BF16)
    seen = np.zeros(packed.shape, bool)
    off = 0
    for w, _ in ws:
        ci, co = w.shape
        kp, np_ = -(-ci // 32) * 32, -(-co // 32) * 32
        k, n = np.meshgrid(np.arange(ci), np.arange(co), indexing="ij")
        chunk, nn = n // nc, n % nc
        ncw = np.minimum(nc, np_ - chunk * nc)
        step = off + kp * nc * chunk + 32 * ncw * (k // 32) + 16 * ncw * (k % 32 // 16)
        at = step + (256 * (nn // 8) + 128 * (k % 16 // 8) + 16 * (nn % 8) + 2 * (k % 8)) // 2
        assert torch.equal(packed[torch.from_numpy(at)], w.to(BF16)[torch.from_numpy(k),
                                                                    torch.from_numpy(n)])
        assert not seen[at].any()
        seen[at] = True
        off += kp * np_
    assert off == packed.numel()
    assert not packed.float()[torch.from_numpy(~seen)].any()


# -- row 8: the stride-1 conv's bf16 train form ---------------------------------

def test_conv3d_train_bf16_matches_packed_conv_train(torch_one_thread):
    """packed_conv_train on a bf16 packed volume and the bf16 kernel (the
    Pallas forward in interpret mode, XLA's transpose backward, the
    cotangent at the conv's dtype) against conv3d_train on bf16 x (its plain
    version on the CPU) at a trunk site's channels and depth (32 channels,
    the 24 slices of +-48 in 4 groups), H x W cut to 6 x 8: the raw conv and
    dx within a bf16 step and the float32 sums' floor (27 Ci terms), dk
    (float32 of a bf16 gradient, a sum over N D H W positions) in the L2
    form. At the depth groups' edge slices JAX's dx rounds twice (ROADMAP
    C43): there the floor takes one more bf16 step of the sum's terms."""
    rng = np.random.default_rng(8)
    b, d, h, w, c, g = 2, 24, 6, 8, 32, 4
    x = bf16_values(rng, b, d, h, w, c)
    kern = (rng.standard_normal((3, 3, 3, c, c)) * 0.05).astype(np.float32)
    ct = bf16_values(rng, b, d, h, w, c)
    dg = d // g
    pack = lambda a: pack_depth(jnp.asarray(a, jnp.bfloat16), g).reshape(b * dg, h, w, g * c)
    unpack = lambda a: np.asarray(unpack_depth(a.reshape(b, dg, h, w, g * c), g), np.float32)
    y_j, vjp = jax.vjp(lambda x4, k: packed_conv_train(x4, k.astype(jnp.bfloat16), dg, g, 1, True),
                       pack(x), jnp.asarray(kern))
    assert y_j.dtype == jnp.bfloat16
    dx_j, dk_j = vjp(pack(ct))
    assert dx_j.dtype == jnp.bfloat16 and dk_j.dtype == jnp.float32
    ncdhw = lambda a: torch.from_numpy(a.transpose(0, 4, 1, 2, 3).copy())
    xt = ncdhw(x).to(BF16).requires_grad_(True)
    kt = torch.from_numpy(kern.transpose(4, 3, 0, 1, 2).copy()).requires_grad_(True)
    y = cconv.conv3d_train(xt, kt)
    assert y.dtype == BF16
    y.backward(ncdhw(ct).to(BF16))
    wa = kt.detach().to(BF16).float().abs()
    floor = 27 * c * cconv.F32_SUM_ERR * torch.nn.functional.conv3d(
        xt.detach().float().abs(), wa, padding=1)
    within_step(y.detach(), ncdhw(unpack(y_j)).to(BF16), floor, "y")
    mag = torch.nn.functional.conv3d(ncdhw(ct).abs(), cconv.flip_transpose(wa), padding=1)
    floor = 27 * c * cconv.F32_SUM_ERR * mag
    # JAX's dx is the transpose of its packed window (a group's slices and
    # its neighbours' edge slices) in bf16: at a group's first and last
    # slice it adds two partial sums, each rounded to bf16 (ROADMAP C43);
    # the port's is one rounding of the whole sum
    edge = torch.zeros(d, dtype=torch.bool)
    edge[0::g] = edge[g - 1::g] = True
    floor = floor + torch.where(edge[None, None, :, None, None], cconv.bf16_step(mag),
                                torch.zeros_like(mag))
    assert xt.grad.dtype == BF16
    within_step(xt.grad, ncdhw(unpack(dx_j)).to(BF16), floor, "dx")
    l2_close(kt.grad.numpy(), np.asarray(dk_j).transpose(4, 3, 0, 1, 2), "dk")


def test_conv3d_train_bf16_function_backward(monkeypatch):
    """The autograd Function that CUDA tensors take, on bf16 x, with its two
    launch points routed to the bf16 plain versions: dx the bf16 conv of dy
    with the flipped weights (bit-equal to autograd of the plain version:
    the same float32 conv, rounded once), dk PyTorch's on the bf16 tensors
    (the float32 sums over the positions in another order: 1e-5 of max
    before its bf16 rounding, so within a bf16 step)."""
    monkeypatch.setattr(cconv, "conv3d_train_cuda", cconv.conv3d_train_bf16_plain)
    monkeypatch.setattr(cconv, "conv3d_train_dx_cuda", cconv.conv3d_train_dx_bf16_plain)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 4, 6, 7, generator=gen).to(BF16)
    w = torch.randn(5, 5, 3, 3, 3, generator=gen) * 0.2
    dy = torch.randn(2, 5, 4, 6, 7, generator=gen).to(BF16)
    grads = []
    for fn in (cconv._Conv3dTrain.apply, cconv.conv3d_train_bf16_plain):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xx, ww)
        y.backward(dy)
        grads.append((y.detach(), xx.grad, ww.grad))
    (y0, dx0, dk0), (y1, dx1, dk1) = grads
    assert torch.equal(y0, y1) and torch.equal(dx0, dx1) and dx0.dtype == BF16
    assert dk0.dtype == torch.float32
    step = cconv.bf16_step(dk1)
    assert bool(((dk0 - dk1).abs() <= step + 1e-5 * dk1.abs().max()).all())


# -- row 11: one SA scale's bf16 train form -------------------------------------

def sa_bf16_inputs(seed, b=2, n=96, m=16, c0=64, chain=(64, 96)):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((b, n, 3)) * 0.4).astype(np.float32)
    xyz[:, 5] = xyz[:, 2]  # coincident points
    centers = xyz[:, :m] + (rng.standard_normal((b, m, 3)) * 0.05).astype(np.float32)
    centers[:, -1] = 9.0  # an empty ball
    v = bf16_values(rng, b, n, c0)
    w0x = (rng.standard_normal((3, c0)) * 0.5).astype(np.float32)
    mul0 = (1 + 0.3 * rng.standard_normal(c0)).astype(np.float32)
    add0 = (0.1 * rng.standard_normal(c0)).astype(np.float32)
    weights, cin = [], c0
    for co in chain:
        weights.append(((rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32),
                        (0.1 * rng.standard_normal(co)).astype(np.float32)))
        cin = co
    ct = bf16_values(rng, b, m, chain[-1])
    return (xyz, centers, v, w0x, mul0, add0, weights), ct


def test_sa_train_bf16_matches_jax(torch_one_thread):
    """sa_ball_mlp_max_train on a bf16 v, an RCNN scale's BN-free chain
    (the only scales JAX trains through it): JAX's (the Pallas kernel in
    interpret mode as the forward, jax.vjp of _sa_xla_oracle as the
    backward) against the port's on the CPU (the bf16 plain version and its
    autograd: the oracle's roundings). The value within a step and the
    chains' floor; v's gradient (bf16) within a step of JAX's beyond the
    float32 floor of its sums; every float32 gradient in the L2 form."""
    (xyz, centers, v, w0x, mul0, add0, weights), ct = sa_bf16_inputs(11)
    radius, s = 0.5, 16
    jargs = (jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(v, jnp.bfloat16),
             jnp.asarray(w0x), jnp.asarray(mul0), jnp.asarray(add0),
             tuple((jnp.asarray(w), jnp.asarray(bb)) for w, bb in weights))
    want, vjp = jax.vjp(lambda *a: jsa_train(*a, radius, s, True), *jargs)
    assert want.dtype == jnp.bfloat16
    want_g = vjp(jnp.asarray(ct, jnp.bfloat16))
    leaves = [t(xyz).requires_grad_(True), t(centers).requires_grad_(True),
              tbf(v).requires_grad_(True)] + [t(a).requires_grad_(True)
                                              for a in (w0x, mul0, add0)]
    tw = [(t(w).requires_grad_(True), t(bb).requires_grad_(True)) for w, bb in weights]
    got = csa.sa_ball_mlp_max_train(*leaves, tw, radius, s)
    assert got.dtype == BF16
    got.backward(tbf(ct))
    with torch.no_grad():
        floor = csa.sa_ball_mlp_max_bf16_plain(
            *(x.detach() for x in leaves), [(w.detach(), bb.detach()) for w, bb in tw], radius,
            s, chain=csa.bf16_chain_floor)
    within_step(got.detach(), np.asarray(want, np.float32), floor, "value")
    assert leaves[2].grad.dtype == BF16
    dv_j = tbf(np.asarray(want_g[2], np.float32))
    l2_close(leaves[2].grad.float().numpy(), dv_j.float().numpy(), "v")
    for name, g, w in zip(("xyz", "centers", "w0x", "mul0", "add0"),
                          leaves[:2] + leaves[3:], want_g[:2] + want_g[3:6]):
        l2_close(g.grad.numpy(), np.asarray(w, np.float32), name)
    for (gw, gb), (ww, wb) in zip(tw, want_g[6]):
        l2_close(gw.grad.numpy(), ww, "W")
        l2_close(gb.grad.numpy(), wb, "b")


def test_sa_train_bf16_function_backward(monkeypatch):
    """The autograd Function that CUDA tensors take, on a bf16 v, with its
    launch point routed to the bf16 plain version: its value and every
    gradient equal to autograd of the plain version (the backward
    recomputes it), v's gradient bf16."""
    monkeypatch.setattr(csa, "sa_ball_mlp_max_train_cuda", csa.sa_ball_mlp_max_bf16_plain)
    (xyz, centers, v, w0x, mul0, add0, weights), ct = sa_bf16_inputs(12, n=64)
    runs = []
    for fn in (lambda *a: csa._SATrain.apply(0.5, 16, *a[:6], *[x for p in a[6] for x in p]),
               lambda *a: csa.sa_ball_mlp_max_bf16_plain(*a, 0.5, 16)):
        leaves = [t(xyz).requires_grad_(True), t(centers).requires_grad_(True),
                  tbf(v).requires_grad_(True)] + [t(a).requires_grad_(True)
                                                  for a in (w0x, mul0, add0)]
        tw = [(t(w).requires_grad_(True), t(bb).requires_grad_(True)) for w, bb in weights]
        out = fn(*leaves, tw)
        out.backward(tbf(ct))
        runs.append([out.detach()] + [x.grad for x in leaves]
                    + [x.grad for pair in tw for x in pair])
    assert runs[0][3].dtype == BF16
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.allclose(a.float(), b.float(), rtol=0,
                                                     atol=1e-5 * float(b.float().abs().max()))


# -- row 14: the train form on bf16 features ------------------------------------

def roi_bf16_inputs(seed=14, b=2, n=300, c=8):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, (b, n, 3)).astype(np.float32)
    extra = np.stack([(rng.uniform(size=(b, n)) > 0.5).astype(np.float32),
                      rng.standard_normal((b, n)).astype(np.float32)], -1)
    feats = bf16_values(rng, b, n, c)
    boxes = np.tile(np.array([[0.0, 2.0, 0.0, 4.0, 4.0, 4.0, 0.4],
                              [1.0, 0.5, -1.0, 1.6, 2.0, 2.0, -0.8],
                              [50.0, 50.0, 50.0, 1.0, 1.0, 1.0, 0.0]], np.float32)[None],
                    (b, 1, 1))
    return pts, extra, feats, boxes, rng


def test_roipool3d_train_bf16_matches_jax():
    """roipool3d_train_bf16 (the RCNN's pooling of bf16 RPN features beside
    its float32 mask and depth, where the joint step differentiates it)
    against JAX's RoI pool on the CPU (the gather route its train step
    differentiates), on [extra, bf16 features] concatenated as JAX's
    prepare_rcnn_train_inputs concatenates them (promoted to float32): the
    rows and flags bit-equal; the gradients of the points and the float32
    channels equal, of the bf16 features bf16 and equal (the same float32
    sums, rounded once)."""
    pts, extra, feats, boxes, rng = roi_bf16_inputs()
    s = 64

    def f(p, e, fe):
        pooled, empty = jroipool3d(p, jnp.concatenate([e, fe], -1), jnp.asarray(boxes), s)
        return pooled, empty
    (want, wempty), vjp = jax.vjp(f, jnp.asarray(pts), jnp.asarray(extra),
                                  jnp.asarray(feats, jnp.bfloat16))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    dp_j, de_j, df_j = vjp((jnp.asarray(ct), np.zeros(wempty.shape, jax.dtypes.float0)))
    assert df_j.dtype == jnp.bfloat16
    tp, te, tf = t(pts).requires_grad_(True), t(extra).requires_grad_(True), \
        tbf(feats).requires_grad_(True)
    got, gempty = croi.roipool3d_train_bf16(tp, te, tf, t(boxes), s)
    assert gempty.any() and not gempty.all()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(gempty.numpy(), np.asarray(wempty))
    got.backward(t(ct))
    np.testing.assert_array_equal(tp.grad.numpy(), np.asarray(dp_j))
    np.testing.assert_array_equal(te.grad.numpy(), np.asarray(de_j))
    assert tf.grad.dtype == BF16
    np.testing.assert_array_equal(tf.grad.float().numpy(), np.asarray(df_j, np.float32))


def test_roipool3d_train_bf16_function_backward(monkeypatch):
    """The autograd Function that CUDA tensors take, its forward routed to
    the bf16 plain version: the rows equal, the scatter-add backward's
    gradients of the points and float32 channels within 1e-5 of max of
    autograd of the plain version's, the bf16 features' bf16 and within a
    step (the float32 sums of the slots in another order, rounded once)."""
    monkeypatch.setattr(croi, "roipool3d_train_bf16_cuda", croi.roipool3d_bf16_plain)
    pts, extra, feats, boxes, rng = roi_bf16_inputs(seed=15)
    runs = []
    for fn in (croi._RoIPool3dTrainBF16.apply, croi.roipool3d_bf16_plain):
        tp, te, tf = t(pts).requires_grad_(True), t(extra).requires_grad_(True), \
            tbf(feats).requires_grad_(True)
        pooled, empty = fn(tp, te, tf, t(boxes), 64, 10.0)
        if not runs:
            ct = torch.from_numpy(rng.standard_normal(pooled.shape).astype(np.float32))
        pooled.backward(ct)
        runs.append((pooled.detach(), empty, tp.grad, te.grad, tf.grad))
    (p0, e0, *g0), (p1, e1, *g1) = runs
    assert torch.equal(p0, p1) and torch.equal(e0, e1)
    for a, b in zip(g0[:2], g1[:2]):
        assert torch.allclose(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    assert g0[2].dtype == g1[2].dtype == BF16
    assert int(cconv.bf16_ulps(g0[2], g1[2]).max()) <= 1


# -- the train-mode arithmetic around them at bf16 ------------------------------

def test_batch_norm_train_bf16_matches_flax(torch_one_thread):
    """batch_norm_train on a bf16 x against Flax's train-mode
    BatchNorm(dtype=bfloat16) (momentum 0.9, eps 1e-5): the normalized
    output bf16 and within a step (its float32 statistics in another order
    of sums), the running statistics and every gradient (x's bf16) in the
    L2 form."""
    rng = np.random.default_rng(21)
    x = bf16_values(rng, 4, 6, 5, 16, scale=2.0) + 1.0
    x = tbf(x).float().numpy()
    scale = (1 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    mean0, var0 = (rng.standard_normal(16) * 0.1).astype(np.float32), \
        rng.uniform(0.5, 2, 16).astype(np.float32)
    ct = bf16_values(rng, 4, 6, 5, 16)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.bfloat16)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def f(xx, sc, bi):
        return bn.apply({"params": {"scale": sc, "bias": bi}, "batch_stats": v["batch_stats"]},
                        xx, mutable=["batch_stats"])

    (want, stats), vjp = jax.vjp(f, jnp.asarray(x, jnp.bfloat16), v["params"]["scale"],
                                 v["params"]["bias"])
    dx_j, ds_j, db_j = vjp((jnp.asarray(ct, jnp.bfloat16),
                            jax.tree_util.tree_map(jnp.zeros_like, stats)))
    tbn = torch.nn.BatchNorm1d(16, eps=1e-5)
    with torch.no_grad():
        tbn.weight.copy_(t(scale))
        tbn.bias.copy_(t(bias))
        tbn.running_mean.copy_(t(mean0))
        tbn.running_var.copy_(t(var0))
    xt = tbf(x).requires_grad_(True)
    y = tpsm.batch_norm_train(tbn, xt, axis=-1)
    assert y.dtype == BF16 and tbn.running_mean.dtype == torch.float32
    y.backward(tbf(ct))
    agree = cconv.bf16_agreement(y.detach(), tbf(np.asarray(want, np.float32)))
    assert agree["max_ulps"] <= 1 and agree["equal"] > 0.95, agree
    l2_close(tbn.running_mean.numpy(), stats["batch_stats"]["mean"], "mean", rel=1e-6)
    l2_close(tbn.running_var.numpy(), stats["batch_stats"]["var"], "var", rel=1e-6)
    l2_close(xt.grad.float().numpy(), np.asarray(dx_j, np.float32), "dx")
    l2_close(tbn.weight.grad.numpy(), ds_j, "dscale")
    l2_close(tbn.bias.grad.numpy(), db_j, "dbias")


def test_packed_batch_norm_train_bf16_matches_jax(torch_one_thread):
    """batch_norm_train(..., packed=True) on a bf16 volume against the JAX
    package's _PackedBN in train mode (the BN of its depth-packed trunk
    convs, deconvs and W-packed tower convs) on the same volume packed (G =
    4 slices in the channels): mul and add rounded to bf16, x * mul + add
    in bf16; the output within a step (the float32 statistics in another
    order), the running statistics (the variance not clipped) and the
    gradients in the L2 form."""
    rng = np.random.default_rng(22)
    b, d, h, w, c, g = 2, 8, 4, 6, 8, 4
    x = tbf(bf16_values(rng, b, d, h, w, c, scale=1.5) + 0.5).float().numpy()
    scale = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    mean0, var0 = np.zeros(c, np.float32), np.ones(c, np.float32)
    ct = bf16_values(rng, b, d, h, w, c)
    mod = jpsm._PackedBN(c, g, dtype=jnp.bfloat16)
    pack = lambda a: pack_depth(jnp.asarray(a, jnp.bfloat16), g).reshape(b * d // g, h, w, g * c)

    def f(xx, sc, bi):
        return mod.apply({"params": {"scale": sc, "bias": bi},
                          "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}},
                         xx, True, mutable=["batch_stats"])

    (want, stats), vjp = jax.vjp(f, pack(x), jnp.asarray(scale), jnp.asarray(bias))
    dx_j, ds_j, db_j = vjp((pack(ct), jax.tree_util.tree_map(jnp.zeros_like, stats)))
    unpack = lambda a: np.asarray(unpack_depth(a.reshape(b, d // g, h, w, g * c), g),
                                  np.float32).transpose(0, 4, 1, 2, 3)
    tbn = torch.nn.BatchNorm3d(c, eps=1e-5)
    with torch.no_grad():
        tbn.weight.copy_(t(scale))
        tbn.bias.copy_(t(bias))
    xt = tbf(x.transpose(0, 4, 1, 2, 3)).requires_grad_(True)
    y = tpsm.batch_norm_train(tbn, xt, packed=True)
    assert y.dtype == BF16
    y.backward(tbf(ct.transpose(0, 4, 1, 2, 3)))
    agree = cconv.bf16_agreement(y.detach(), tbf(unpack(want)))
    assert agree["max_ulps"] <= 1 and agree["equal"] > 0.95, agree
    l2_close(tbn.running_mean.numpy(), stats["batch_stats"]["mean"], "mean", rel=1e-6)
    l2_close(tbn.running_var.numpy(), stats["batch_stats"]["var"], "var", rel=1e-6)
    l2_close(xt.grad.float().numpy(), unpack(dx_j), "dx")
    l2_close(tbn.weight.grad.numpy(), ds_j, "dscale")
    l2_close(tbn.bias.grad.numpy(), db_j, "dbias")


def test_softargmin_train_bf16_matches_jax_regress(torch_one_thread):
    """softargmin_train_bf16 against the JAX package's train-mode
    regression of a bf16 PSMNet (psmnet.py:1001-1011, run op by op as its
    source rounds): the three interpolation contractions with bf16
    matrices, jax.nn.softmax (its custom gradient) and the expectation,
    on bf16 logits over a +-16 range at 8 x 8 from 2 x 2 x 8: the
    disparity bf16 within a step; the logits' gradient in the L2 form."""
    rng = np.random.default_rng(23)
    b, d4, h4, w4, hw, mind, maxd = 2, 8, 2, 2, (8, 8), -16, 16
    logits = bf16_values(rng, b, h4, w4, d4, scale=3.0)  # JAX's channels-last (B, H, W, D)
    ct = bf16_values(rng, b, *hw)

    def regress(c):
        md = jpsm._interp_matrix_align_corners(c.shape[-1], maxd - mind, c.dtype)
        mh = jpsm._interp_matrix_align_corners(c.shape[1], hw[0], c.dtype)
        mw = jpsm._interp_matrix_align_corners(c.shape[2], hw[1], c.dtype)
        c = jnp.einsum("bhwd,ed->bhwe", c, md)
        c = jnp.einsum("bhwd,eh->bewd", c, mh)
        c = jnp.einsum("bhwd,ew->bhed", c, mw)
        p = jax.nn.softmax(c, axis=-1)
        disp = jnp.arange(mind, maxd, dtype=p.dtype)
        return jnp.einsum("bhwd,d->bhw", p, disp)

    with jax.disable_jit():
        want, vjp = jax.vjp(regress, jnp.asarray(logits, jnp.bfloat16))
        (dl_j,) = vjp(jnp.asarray(ct, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    lt = tbf(logits.transpose(0, 3, 1, 2)).requires_grad_(True)
    got = softargmin_train_bf16(lt, hw, mind, maxd)
    assert got.dtype == BF16
    got.backward(tbf(ct))
    agree = cconv.bf16_agreement(got.detach(), tbf(np.asarray(want, np.float32)))
    assert agree["max_ulps"] <= 1, agree
    l2_close(lt.grad.float().numpy(), np.asarray(dl_j, np.float32).transpose(0, 3, 1, 2),
             "dlogits")


def test_bf16_bce_matches_jax_and_stays_finite():
    """binary_cross_entropy on bf16 logits (the RPN's and the RCNN's BCE at
    bf16) against JAX's expression on jax.nn.sigmoid, value and gradient,
    op by op, at logits from -120 to 120: bit-equal but where one side
    gives a denormal that XLA on the CPU flushes to zero (within the
    smallest normal number), and finite where exp(-x) overflows
    (lax.logistic's derivative, y (1 - y))."""
    x = np.concatenate([np.linspace(-120, 120, 97), [-100.0, -89.0, 0.0, 89.0]]).astype(
        np.float32)
    tgt = (np.arange(x.size) % 3 == 0).astype(np.float32)

    def jbce(z):
        p = jax.nn.sigmoid(z)
        tt = jnp.asarray(tgt, jnp.bfloat16)
        return -(tt * jnp.log(jnp.clip(p, 1e-12)) + (1 - tt) * jnp.log(jnp.clip(1 - p, 1e-12)))

    with jax.disable_jit():
        want, vjp = jax.vjp(jbce, jnp.asarray(x, jnp.bfloat16))
        (dwant,) = vjp(jnp.ones(x.shape, jnp.bfloat16))
    xt = tbf(x).requires_grad_(True)
    got = binary_cross_entropy(xt, tbf(tgt))
    got.sum().backward()
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tiny)
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(dwant, np.float32), rtol=0,
                               atol=tiny)
