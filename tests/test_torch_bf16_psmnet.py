"""The port's bf16 iDispNet (TPU.COMPUTE_DTYPE bfloat16) against the JAX
package on the CPU, at the sizes of test_torch_psmnet.py: each bf16 twin
(the plain PyTorch version of a kernel's bf16 form, ops/cuda/conv3d.py and
softargmin.py) against the JAX Pallas kernel it replaces, run in interpret
mode on bf16 inputs packed by the JAX package's own pack_depth /
pack_kernel* / wpack helpers; then the whole bf16 PSMNet eval forward
against JAX's PSMNet(dtype=jnp.bfloat16) on its kernel route; and the
bf16 model that build_detection_model makes of idispnet.yaml.

Tolerances, with their reasons:
- a twin against its Pallas kernel: every element at most one bf16 step
  apart. Both take the same bf16 values, form exact products in float32
  and sum them in float32 in other orders, then round once to bf16 (to
  nearest even); the float32 sums differ by ~1e-7 relative, so a rounding
  can fall on either side of a bf16 midpoint, never further. The
  classifier's conv rounds before the previous classifier's cost joins,
  and the sum rounds again, on both sides.
- the soft-argmin on bf16 logits: both read them as float32; 1e-4 px, the
  float32 form's tolerance (test_torch_psmnet.py), and one bf16 step of
  the disparity.
- the whole forward: bf16 rounds ~30 layers at other points than float32,
  and on random weights the soft-argmin sits on a near-uniform softmax, so
  the port and JAX are each held to a float64 run of the same weights (the
  port's PSMNet in float64): the port's mean |disparity - float64| at most
  1.25 times JAX's kernel route's plus 0.01 px.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.config import get_default_cfg as jax_default_cfg
from disprcnn_tpu.models import build as jbuild
from disprcnn_tpu.models.psmnet import psmnet as jpsm
from disprcnn_tpu.ops.conv3d_packed import (pack_depth, pack_kernel, pack_kernel_strided,
                                            pack_kernel_transposed, pack_kernel_w,
                                            unpack_depth, wpack, wunpack)
from disprcnn_tpu.ops.pallas.packed_conv import (cost_volume_conv_bn, packed_conv_bn,
                                                 packed_conv_bn_s2, packed_deconv_bn,
                                                 wpacked_conv_bn)
from disprcnn_tpu.ops.pallas.softargmin import fused_softargmin
from disprcnn_tpu_torch.config import get_default_cfg
from disprcnn_tpu_torch.models import build as tbuild
from disprcnn_tpu_torch.models.psmnet.psmnet import BasicBlock, PSMNet, bn_eval, conv_at
from disprcnn_tpu_torch.ops.cuda import conv3d as tconv
from disprcnn_tpu_torch.ops.cuda import softargmin as tsam
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from torch_eval_helpers import REPO
from torch_port_helpers import draw_variables
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

BF16 = torch.bfloat16
B, H, W = 2, 6, 10
IDISPNET_YAML = str(REPO / "configs/kitti/car/vob/idispnet.yaml")


def bf16_values(rng, *shape, scale=1.0):
    """float32 numpy values that are bf16 numbers (rounded to nearest even),
    so that JAX and torch take the same bf16 inputs."""
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return x.to(BF16).float().numpy()


def jbf(x):
    return jnp.asarray(x, jnp.bfloat16)


def tbf(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16)


def bn_affine(rng, co):
    return ((rng.standard_normal(co) * 0.5 + 1.0).astype(np.float32),
            (rng.standard_normal(co) * 0.1).astype(np.float32))


def kernel(rng, *shape):
    return (rng.standard_normal(shape) * 0.2).astype(np.float32)


def ncdhw(x):
    return x.transpose(0, 4, 1, 2, 3)


def unpack(y4, b, g):
    """Pallas output (B*Dg, H, W, G*Co) -> (B, Co, D, H, W) float32 numpy
    (bf16 values)."""
    y = jnp.asarray(y4).reshape(b, -1, *y4.shape[1:])
    return np.asarray(unpack_depth(y, g), np.float32).transpose(0, 4, 1, 2, 3)


def within_one_step(got: torch.Tensor, want: np.ndarray):
    """got (bf16) and want (bf16 values as float32) at most one bf16 step
    apart on every element."""
    assert got.dtype == BF16 and tuple(got.shape) == want.shape
    ulps = tconv.bf16_ulps(got, tbf(want))
    assert int(ulps.max()) <= 1, int(ulps.max())
    return float((ulps == 0).float().mean())


@pytest.mark.parametrize("mind4", [-4, 0])
def test_cost_volume_bf16_twin_matches_pallas(torch_one_thread, mind4):
    """Row 2: cost_volume_conv_bn on bf16 features and bf16 banded weights."""
    rng = np.random.default_rng(20 + mind4)
    c, co, g = 4, 4, 4
    maxd4 = mind4 + 8
    lf, rf = bf16_values(rng, B, H, W, c), bf16_values(rng, B, H, W, c)
    kern = kernel(rng, 3, 3, 3, 2 * c, co)
    mul, add = bn_affine(rng, co)
    want = cost_volume_conv_bn(
        jbf(lf), jbf(rf), pack_kernel(jbf(kern[:, :, :, :c]), g),
        pack_kernel(jbf(kern[:, :, :, c:]), g), jnp.tile(mul, g), jnp.tile(add, g),
        (maxd4 - mind4) // g, g, mind4, relu=True, interpret=True)
    assert want.dtype == jnp.bfloat16
    got = tconv.cost_volume_conv_bn(tbf(lf.transpose(0, 3, 1, 2)), tbf(rf.transpose(0, 3, 1, 2)),
                                    torch.from_numpy(np.ascontiguousarray(
                                        kern.transpose(4, 3, 0, 1, 2))),
                                    torch.from_numpy(mul), torch.from_numpy(add), mind4, maxd4)
    within_one_step(got, unpack(want, B, g))


def torch_weight(kern):
    """DHWIO (3, 3, 3, Ci, Co) -> OIDHW float32."""
    return torch.from_numpy(np.ascontiguousarray(kern.transpose(4, 3, 0, 1, 2)))


@pytest.mark.parametrize("residual,relu", [(False, True), (True, False), (True, True)])
def test_conv3d_bf16_twin_matches_pallas(torch_one_thread, residual, relu):
    """Row 3: packed_conv_bn on a bf16 volume, the residual (bf16) joined in
    float32 before the ReLU, across the depth halo's image boundary."""
    rng = np.random.default_rng(21)
    d, ci, co, g = 8, 4, 4, 4
    x = bf16_values(rng, B, d, H, W, ci)
    kern = kernel(rng, 3, 3, 3, ci, co)
    mul, add = bn_affine(rng, co)
    res = bf16_values(rng, B, d, H, W, co) if residual else None
    x4 = pack_depth(jbf(x), g).reshape(B * d // g, H, W, g * ci)
    res4 = None if res is None else pack_depth(jbf(res), g).reshape(B * d // g, H, W, g * co)
    want = packed_conv_bn(x4, pack_kernel(jbf(kern), g), jnp.tile(mul, g), jnp.tile(add, g),
                          d // g, g, relu=relu, residual=res4, interpret=True)
    got = tconv.conv3d_bn(tbf(ncdhw(x)), torch_weight(kern), torch.from_numpy(mul),
                          torch.from_numpy(add), None if res is None else tbf(ncdhw(res)), relu)
    within_one_step(got, unpack(want, B, g))


def test_conv3d_cl1_bf16_twin_matches_pallas_and_running_sum(torch_one_thread):
    """Row 4: the classifier's 32 -> 1 conv (packed_conv_bn at dg = 1,
    identity affine), then the running sum with the previous classifier's
    cost as JAX adds it: a bf16 add of the bf16 conv (psmnet.py:987-989).
    The port folds that add into the conv as its residual, rounding the
    conv first and the sum again."""
    rng = np.random.default_rng(22)
    d, ci = 8, 4
    x = bf16_values(rng, B, d, H, W, ci)
    kern = kernel(rng, 3, 3, 3, ci, 1)
    prev = bf16_values(rng, B, H, W, d)  # the previous classifier's cost, (B, H, W, D)
    x4 = pack_depth(jbf(x), d).reshape(B, H, W, d * ci)
    conv = packed_conv_bn(x4, pack_kernel(jbf(kern), d), jnp.ones(d), jnp.zeros(d), 1, d,
                          relu=False, interpret=True)
    assert conv.dtype == jnp.bfloat16
    want_sum = conv + jbf(prev)
    assert want_sum.dtype == jnp.bfloat16
    to_ncdhw = lambda a: np.asarray(a, np.float32).transpose(0, 3, 1, 2)[:, None]
    w = torch_weight(kern)
    within_one_step(tconv.conv3d_bn(tbf(ncdhw(x)), w), to_ncdhw(conv))
    within_one_step(tconv.conv3d_bn(tbf(ncdhw(x)), w, residual=tbf(to_ncdhw(prev))),
                    to_ncdhw(want_sum))


@pytest.mark.parametrize("relu", [True, False])
def test_conv3d_s2_bf16_twin_matches_pallas(torch_one_thread, relu):
    """Row 6: packed_conv_bn_s2 on a bf16 volume."""
    rng = np.random.default_rng(23)
    d, ci, co, g = 8, 4, 4, 4
    x = bf16_values(rng, B, d, H, W, ci)
    kern = kernel(rng, 3, 3, 3, ci, co)
    mul, add = bn_affine(rng, co)
    x4 = pack_depth(jbf(x), g).reshape(B * d // g, H, W, g * ci)
    want = packed_conv_bn_s2(x4, pack_kernel_strided(jbf(kern), g), jnp.tile(mul, g // 2),
                             jnp.tile(add, g // 2), d // g, g, relu=relu, interpret=True)
    got = tconv.conv3d_bn(tbf(ncdhw(x)), torch_weight(kern), torch.from_numpy(mul),
                          torch.from_numpy(add), relu=relu, stride=2)
    within_one_step(got, unpack(want, B, g // 2))


@pytest.mark.parametrize("residual,relu", [(True, True), (True, False), (False, False)])
def test_deconv3d_bf16_twin_matches_pallas(torch_one_thread, residual, relu):
    """Row 5: packed_deconv_bn on a bf16 volume (flax padding (1, 2); the
    torch weight flipped in space, as utils/weights.py maps it)."""
    rng = np.random.default_rng(24)
    d, h, w, ci, co, g = 4, 3, 5, 4, 4, 2
    x = bf16_values(rng, B, d, h, w, ci)
    kern = kernel(rng, 3, 3, 3, ci, co)
    mul, add = bn_affine(rng, co)
    res = bf16_values(rng, B, 2 * d, 2 * h, 2 * w, co) if residual else None
    x4 = pack_depth(jbf(x), g).reshape(B * d // g, h, w, g * ci)
    res4 = (None if res is None else
            pack_depth(jbf(res), 2 * g).reshape(B * d // g, 2 * h, 2 * w, 2 * g * co))
    want = packed_deconv_bn(x4, pack_kernel_transposed(jbf(kern), g), jnp.tile(mul, 2 * g),
                            jnp.tile(add, 2 * g), d // g, g, relu=relu, residual=res4,
                            interpret=True)
    weight = torch.from_numpy(np.ascontiguousarray(kern[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)))
    got = tconv.deconv3d_bn(tbf(ncdhw(x)), weight, torch.from_numpy(mul), torch.from_numpy(add),
                            None if res is None else tbf(ncdhw(res)), relu)
    within_one_step(got, unpack(want, B, 2 * g))


@pytest.mark.parametrize("residual,relu", [(False, True), (True, False), (True, True)])
def test_conv2d_bf16_twin_matches_pallas(torch_one_thread, residual, relu):
    """Row 7: wpacked_conv_bn on a bf16 W-packed image (G = 4)."""
    rng = np.random.default_rng(25)
    ci, co, g = 4, 4, 4
    x = bf16_values(rng, B, H, 2 * W, ci)
    kern = kernel(rng, 3, 3, ci, co)
    mul, add = bn_affine(rng, co)
    res = bf16_values(rng, B, H, 2 * W, co) if residual else None
    want = wpacked_conv_bn(wpack(jbf(x), g), pack_kernel_w(jbf(kern), g), jnp.tile(mul, g),
                           jnp.tile(add, g), g, relu=relu,
                           residual=None if res is None else wpack(jbf(res), g), interpret=True)
    weight = torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 2, 0, 1)))
    nchw = lambda a: tbf(a.transpose(0, 3, 1, 2))
    got = tconv.conv2d_bn(nchw(x), weight, torch.from_numpy(mul), torch.from_numpy(add),
                          None if res is None else nchw(res), relu)
    within_one_step(got, np.asarray(wunpack(want, g), np.float32).transpose(0, 3, 1, 2))


def test_softargmin_bf16_twin_matches_pallas(torch_one_thread):
    """Row 15 on bf16 logits: JAX's kernel route casts the classifier's bf16
    cost to float32 before fused_softargmin (psmnet.py:1008-1011); the
    port's bf16 form reads them as float32. Float32 disparity out."""
    rng = np.random.default_rng(26)
    c = bf16_values(rng, B, 7, 9, 4, scale=2.0)  # (B, h4, w4, D4)
    want = np.array(fused_softargmin(jbf(c).astype(jnp.float32), (27, 33), -8, 8,
                                     interpret=True))
    got = tsam.softargmin(tbf(c.transpose(0, 3, 1, 2)), (27, 33), -8, 8)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    assert err.max() <= 1e-4
    # one bf16 step of the disparity: 2^(floor(log2 |d|) - 7)
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (err <= step).all()


def images(seed, b, hw):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, *hw, 3)).astype(np.float32) for _ in range(2)]


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def bf16_forwards():
    """PSMNet at 2 ROIs of 64x64, disparity -16..16, 3 hourglasses, on one
    set of drawn weights: JAX's PSMNet(dtype=bfloat16) on its kernel route
    (_FORCE_INTERPRET, every Pallas kernel whose geometry gate opens at this
    size, interpreted) and on its XLA route, the port's bf16 eval forward,
    and the port's float64 forward (the reference both are held to)."""
    left, right = images(7, 2, (64, 64))
    jm = jpsm.PSMNet(maxdisp=16, mindisp=-16, num_hourglass=3, dtype=jnp.bfloat16)
    v = draw_variables(jm, jnp.asarray(left), jnp.asarray(right), seed=7, train=False)
    run = jax.jit(lambda vv, a, b: jm.apply(vv, a, b, train=False))
    xla = np.asarray(run(v, left, right), np.float32)
    try:
        jpsm._FORCE_INTERPRET = True
        kernel = np.asarray(jax.jit(lambda vv, a, b: jm.apply(vv, a, b, train=False))(
            v, left, right), np.float32)
    finally:
        jpsm._FORCE_INTERPRET = False
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            port = load_jax_variables(PSMNet(16, -16, 3, dtype=BF16), v)(nchw(left),
                                                                          nchw(right))
            f64 = load_jax_variables(PSMNet(16, -16, 3), v).double()(
                nchw(left).double(), nchw(right).double())
    finally:
        torch.set_num_threads(n)
    assert port.dtype == torch.float32
    return dict(kernel=kernel, xla=xla, port=port.numpy(), f64=f64.numpy())


def test_psmnet_bf16_eval_as_close_to_float64_as_jax(bf16_forwards):
    """The whole bf16 eval forward, held with JAX's kernel route to a
    float64 run of the same weights: the port's mean |disparity - float64|
    at most 1.25 times JAX's + 0.01 px. Measured here: the port 0.235 px
    from float64 (max 1.64), JAX's kernel route 0.307 (max 2.95); the port
    and JAX directly: mean 0.364, max 3.08 px (random weights: the softmax
    over disparity is near uniform, so each layer's bf16 roundings move the
    expectation; PSMNet in float32 agrees to 2e-3 px,
    test_torch_psmnet.py)."""
    f = bf16_forwards
    port, jk, ref = f["port"], f["kernel"], f["f64"]
    assert port.shape == jk.shape == ref.shape == (2, 64, 64)
    assert np.isfinite(port).all() and np.abs(ref).max() > 1.0
    d_port, d_jax = np.abs(port - ref).mean(), np.abs(jk - ref).mean()
    print(f"bf16 PSMNet mean |d - float64|: port {d_port:.4f} (max "
          f"{np.abs(port - ref).max():.4f}), JAX kernel route {d_jax:.4f} (max "
          f"{np.abs(jk - ref).max():.4f}); port vs JAX mean {np.abs(port - jk).mean():.4f}, "
          f"max {np.abs(port - jk).max():.4f}")
    assert d_port <= 1.25 * d_jax + 0.01, (d_port, d_jax)


def test_jax_bf16_routes_disagree(bf16_forwards):
    """ROADMAP C38: JAX's bf16 PSMNet has two routes that compute different
    functions. The XLA route (the CPU, and any kernel_disabled tag)
    interpolates, takes the softmax and the expectation in bf16
    (psmnet.py:1012-1020) and applies _PackedBN's affine in bf16; the
    kernel route casts the cost to float32 before fused_softargmin
    (:1008-1011) and applies the affine in float32 inside each kernel. The
    port follows the kernel route. At this size (64x64, +-16, random
    weights) the gap between the routes, printed, is mean 0.084 px, max
    0.84."""
    xla, jk, ref = bf16_forwards["xla"], bf16_forwards["kernel"], bf16_forwards["f64"]
    gap = np.abs(xla - jk)
    print(f"JAX bf16 XLA route vs kernel route: mean {gap.mean():.4f} px, max "
          f"{gap.max():.4f}; from float64: XLA {np.abs(xla - ref).mean():.4f}, kernel "
          f"{np.abs(jk - ref).mean():.4f}")
    assert np.isfinite(xla).all() and gap.max() > 0


def test_idispnet_yaml_builds_bf16_and_loads_jax_bf16_variables(caplog):
    """build_detection_model on idispnet.yaml at its default
    TPU.COMPUTE_DTYPE gives DispRCNN3D with a bf16 iDispNet, as the JAX
    build gives PSMNet(dtype=bfloat16); JAX's bf16 model keeps float32
    parameters and statistics (TPU.PARAM_DTYPE), so state_dict_from_jax
    loads them unchanged into the port's float32 parameters. Built to
    train (tools/train_net), it is bf16 too, with no pending item logged
    (A8.4: tests/test_torch_bf16_train.py); rcnn.yaml's model computes in
    bf16 too (its 3D stage since A8.3: tests/test_torch_bf16_pointrcnn.py)."""
    cfg, jcfg = get_default_cfg(), jax_default_cfg()
    for c in (cfg, jcfg):
        c.merge_from_file(IDISPNET_YAML)
        c.merge_from_list(["TPU.ROI_CROP_SIZE", "32", "MODEL.DISPNET.MAX_DISP", "16",
                           "MODEL.DISPNET.MIN_DISP", "-16"])
        c.freeze()
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16" and not cfg.MODEL.DET3D_ON
    jm = jbuild.build_detection_model(jcfg)
    assert jm.dtype == jnp.bfloat16
    tm = tbuild.build_detection_model(cfg, device="cpu")
    assert tm.idispnet.dtype == BF16
    x = jnp.zeros((1, 32, 32, 3))
    jpsm_bf16 = jpsm.PSMNet(maxdisp=16, mindisp=-16, dtype=jm.dtype)
    shapes = jax.eval_shape(lambda: jpsm_bf16.init(jax.random.PRNGKey(0), x, x))
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(shapes)} == {np.dtype("float32")}
    v = draw_variables(jpsm_bf16, x, x, seed=11, train=False)
    sd = state_dict_from_jax(tm, {coll: {"idispnet": tree} for coll, tree in v.items()})
    assert {t.dtype for t in sd.values() if t.is_floating_point()} == {torch.float32}
    tm.load_state_dict(sd, strict=True)
    want = state_dict_from_jax(load_jax_variables(PSMNet(16, -16), v), v)
    for k, t in tm.idispnet.state_dict().items():
        assert torch.equal(t, want[k]), k
    with caplog.at_level(logging.INFO, logger="disprcnn_tpu_torch.models.build"):
        assert tbuild.build_detection_model(cfg, device="meta", train=True).idispnet.dtype \
            == BF16
        rcnn = get_default_cfg()
        rcnn.merge_from_file(str(REPO / "configs/kitti/car/vob/rcnn.yaml"))
        assert tbuild.build_detection_model(rcnn, device="meta").idispnet.dtype == BF16
    assert "ROADMAP A8" not in caplog.text


def test_layer2_first_block_bf16_matches_jax(torch_one_thread):
    """ROADMAP C40: layer2's first BasicBlock (stride 2, the 1x1 downsample,
    32 -> 64 channels) at bf16. JAX packs no block that downsamples, so its
    second conv (3x3, 64 channels, stride 1) is XLA's on both of its routes,
    and its source rounds the conv, the BN and the residual add each to
    bf16. The port takes that conv the same way (cuDNN on bf16 tensors,
    bn_eval, the bf16 add). Held to JAX's block run op by op (each op
    rounded as the source writes it): every element within one bf16 step
    beyond the residual add's own rounding (one step of its larger term:
    each term is rounded before the add, on both sides, and a conv's
    float32 sums in another order may round one to a neighbouring value).
    Printed: how far the former route (row 7's bf16 form, one rounding
    after the fused BN and residual) lay from JAX, and how far jitted JAX
    lies from its own op-by-op run (ROADMAP C42: XLA keeps each conv's
    float32 output unrounded before the BN that follows it)."""
    rng = np.random.default_rng(40)
    x = bf16_values(rng, 2, 32, 40, 32, scale=0.5)  # NHWC, layer1's output
    jb = jpsm.BasicBlock(planes=64, stride=2, downsample=True, dtype=jnp.bfloat16)
    v = draw_variables(jb, jbf(x), seed=40, train=False)
    try:
        jpsm._FORCE_INTERPRET = True
        want = np.asarray(jb.apply(v, jbf(x), False), np.float32)  # op by op
        jitted = np.asarray(jax.jit(lambda vv, a: jb.apply(vv, a, False))(v, jbf(x)),
                            np.float32)
    finally:
        jpsm._FORCE_INTERPRET = False
    port = load_jax_variables(BasicBlock(32, 64, 2, 1, downsample=True, dtype=BF16), v)
    assert not port.ConvBN_1.fused
    xt = tbf(x.transpose(0, 3, 1, 2))
    with torch.no_grad():
        got = port(xt)
        cb = port.ConvBN_1
        out = port.ConvBN_0(xt, relu=True)
        terms = (bn_eval(cb.BatchNorm_0, conv_at(cb.Conv_0, out)).float().abs()
                 + bn_eval(port.BatchNorm_0, conv_at(port.Conv_0, xt)).float().abs())
        cb.fused = True  # the former route: row 7's bf16 form
        old = port(xt)
    want_t = tbf(want.transpose(0, 3, 1, 2))
    floor = tconv.bf16_step(terms)
    agree = tconv.bf16_agreement(got, want_t, floor)
    former = tconv.bf16_agreement(old, want_t, floor)
    gap = (old.float() - want_t.float()).abs()
    jgap = tconv.bf16_agreement(tbf(jitted.transpose(0, 3, 1, 2)), want_t, floor)
    print(f"C40: layer2's first block, the port vs JAX op by op: {agree}; the former route "
          f"(row 7): {former}, mean |diff| {float(gap.mean()):.3e}, max {float(gap.max()):.3e}; "
          f"jitted JAX vs JAX op by op: {jgap}")
    assert got.dtype == BF16 and agree["beyond"] == 0 and agree["max_ulps_clear"] <= 1, agree
    assert agree["equal"] >= 0.99, agree
    assert former["beyond"] > 0 and former["equal"] < agree["equal"], (former, agree)