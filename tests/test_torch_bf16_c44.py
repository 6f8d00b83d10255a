"""ROADMAP C44: the JAX package's default bf16 eval route at rows 5 and 7's
sites against the port's bf16 forms, on the CPU.

JAX's default bf16 model runs neither site through its Pallas kernel: the
W-packed tower conv takes XLA's conv because `wconv` is off by default
(disprcnn_tpu/ops/pallas/__init__.py:43), and the hourglass's transposed
conv at its 14^2 and 28^2 inputs takes XLA's below DISPRCNN_CONV3D_MIN_HW
(disprcnn_tpu/models/psmnet/psmnet.py:772-777). Both then apply _PackedBN's
eval arithmetic in bf16 (psmnet.py:442-484: mul and add rounded to bf16, x
* mul + add in bf16 ops on the conv rounded to bf16) and the residual add
in bf16, each op rounding. The port keeps the Pallas kernels' arithmetic
(float32 BN affine, residual and ReLU, one rounding), as its twins
conv2d_bn_bf16_plain and deconv3d_bn_bf16_plain compute it.

Each test runs one site both ways on the same bf16 values, JAX op by op
(un-jitted: ROADMAP C42, XLA on the CPU keeps a jitted conv's float32
output unrounded before the BN), prints the share of equal elements and the
count beyond one bf16 step and the float32 sums' floor, and asserts the
order it records (measured: 59% equal and 2408 of 24576 elements beyond at
the tower site; 84% and 1745, 71% and 1161 at the two transposed-conv
sites; at most 21 steps apart where both values share a binade and the
floor is under a step): the routes agree on most elements and part by more
than one step on some, by tens of steps at most.
"""
import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.psmnet import psmnet as jpsm
from disprcnn_tpu.ops.conv3d_packed import pack_depth, unpack_depth, wpack, wunpack
from disprcnn_tpu_torch.ops.cuda import conv3d as tconv
from torch_port_helpers import draw_variables
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

BF16 = torch.bfloat16


def bf16_values(rng, *shape, scale=1.0):
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return x.to(BF16).float().numpy()


def tbf(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16)


def folded(bn_vars, stats):
    """The BN's eval affine in float32, as the Pallas kernels fold it."""
    mul, add = jpsm._fold_bn_affine(bn_vars["scale"], bn_vars["bias"], stats["mean"],
                                    stats["var"])
    return torch.tensor(np.asarray(mul)), torch.tensor(np.asarray(add))


def compare(name, port, jax_route, terms, k):
    """bf16_agreement of the port's twin against JAX's route, with the
    float32 sums' floor over k terms of magnitude `terms`; printed."""
    agree = tconv.bf16_agreement(port, jax_route, k * tconv.F32_SUM_ERR * terms)
    print(f"C44 {name}: the port's twin vs JAX's default route op by op: {agree}")
    return agree


class DeconvBN(nn.Module):
    """The hourglass's deconv_bn on its XLA route (psmnet.py:781-803):
    _PackedDeconv, _PackedBN, the residual add, ReLU."""
    features: int
    g_in: int
    dg: int

    @nn.compact
    def __call__(self, v, residual, relu):
        dc = jpsm._PackedDeconv(self.features, self.g_in, self.dg, jnp.bfloat16,
                                in_features=v.shape[-1] // self.g_in, name="ConvTranspose_0")
        bn = jpsm._PackedBN(self.features, 2 * self.g_in, dtype=jnp.bfloat16,
                            name="BatchNorm_0")
        y = bn(dc(v), False)
        y = y + residual.astype(y.dtype)
        return nn.relu(y) if relu else y


def test_tower_conv_route_gap(torch_one_thread):
    """Row 7's site: layer1's 3x3 conv, 32 -> 32 channels, W-packed (G 4),
    with the block's residual, no ReLU (BasicBlock's second ConvBN)."""
    rng = np.random.default_rng(44)
    b, h, w, c, g = 2, 12, 32, 32, 4
    x = bf16_values(rng, b, h, w, c, scale=0.5)  # NHWC
    res = bf16_values(rng, b, h, w, c, scale=0.5)
    jb = jpsm.ConvBN(c, 3, 1, dims=2, dtype=jnp.bfloat16, wpack=g)
    xp, rp = wpack(jnp.asarray(x, jnp.bfloat16), g), wpack(jnp.asarray(res, jnp.bfloat16), g)
    v = draw_variables(jb, xp, seed=44, train=False)
    assert not jpsm._FORCE_INTERPRET  # the default route: XLA's conv, _PackedBN
    want = np.asarray(wunpack(jb.apply(v, xp, False, False, rp), g), np.float32)
    kern = np.asarray(v["params"]["Conv_0"]["kernel"])  # (3, 3, Ci, Co)
    mul, add = folded(v["params"]["BatchNorm_0"], v["batch_stats"]["BatchNorm_0"])
    weight = torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 2, 0, 1)))
    nchw = lambda a: tbf(a.transpose(0, 3, 1, 2))
    port = tconv.conv2d_bn_bf16_plain(nchw(x), weight, mul, add, nchw(res))
    terms = tconv.conv2d_bn_plain(nchw(x).float().abs(), weight.to(BF16).float().abs(),
                                  mul.abs(), torch.zeros_like(mul))
    agree = compare("row 7 (tower conv)", port, nchw(want), terms, 9 * c)
    assert 0.5 <= agree["equal"] < 0.99, agree
    assert agree["beyond"] > 0 and agree["max_ulps_clear"] <= 32, agree


@pytest.mark.parametrize("hw,ci,co,relu", [((7, 7), 64, 64, True), ((6, 6), 64, 32, False)])
def test_hourglass_deconv_route_gap(torch_one_thread, hw, ci, co, relu):
    """Row 5's sites: the hourglass's first transposed conv (64 -> 64, with
    the block's residual and ReLU) and its second (64 -> 32, residual, no
    ReLU), on depth-packed volumes (G 2) at small spatial sizes."""
    rng = np.random.default_rng(45 + co)
    b, d, g = 1, 4, 2
    x = bf16_values(rng, b, d, *hw, ci, scale=0.5)  # NDHWC
    res = bf16_values(rng, b, 2 * d, 2 * hw[0], 2 * hw[1], co, scale=0.5)
    x4 = pack_depth(jnp.asarray(x, jnp.bfloat16), g).reshape(b * d // g, *hw, g * ci)
    r4 = pack_depth(jnp.asarray(res, jnp.bfloat16), 2 * g).reshape(
        b * d // g, 2 * hw[0], 2 * hw[1], 2 * g * co)
    jm = DeconvBN(co, g, d // g)
    v = draw_variables(jm, x4, r4, relu, seed=45)
    want4 = jm.apply(v, x4, r4, relu)
    want = np.asarray(unpack_depth(jnp.asarray(want4).reshape(b, -1, *want4.shape[1:]), 2 * g),
                      np.float32).transpose(0, 4, 1, 2, 3)
    kern = np.asarray(v["params"]["ConvTranspose_0"]["kernel"])  # (3, 3, 3, Ci, Co)
    mul, add = folded(v["params"]["BatchNorm_0"], v["batch_stats"]["BatchNorm_0"])
    weight = torch.from_numpy(np.ascontiguousarray(kern[::-1, ::-1, ::-1].transpose(3, 4, 0, 1,
                                                                                   2)))
    ncdhw = lambda a: tbf(a.transpose(0, 4, 1, 2, 3))
    port = tconv.deconv3d_bn_bf16_plain(ncdhw(x), weight, mul, add, ncdhw(res), relu)
    terms = tconv.deconv3d_bn_plain(ncdhw(x).float().abs(), weight.to(BF16).float().abs(),
                                    mul.abs(), torch.zeros_like(mul))
    agree = compare(f"row 5 (transposed conv {ci} -> {co})", port, tbf(want), terms, 27 * ci)
    assert 0.5 <= agree["equal"] < 0.99, agree
    assert agree["beyond"] > 0 and agree["max_ulps_clear"] <= 32, agree
