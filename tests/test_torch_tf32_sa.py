"""The arithmetic of the set-abstraction kernel's tensor-core chain
(csrc/sa.cu with csrc/mlp_tc.cuh) on the CPU: the SA scale with its chain
in 3xTF32 (`sa_ball_mlp_max_3xtf32_plain`: each product lo*hi + hi*lo +
hi*hi of operands split by split_tf32) against the plain float32 version
and against the JAX Pallas kernel it replaces, and the packed weight
layout the kernel reads.

Tolerances: against the plain version, the card's kernel tolerance
CONV_RTOL/CONV_ATOL (bench.py: max |diff| <= 1e-4 * max |plain| + 1e-5),
which one TF32 product alone misses; against the Pallas kernel in
interpret mode, which rounds its features, weights and activations to bf16
inside, test_torch_points.py's 3e-2 * max |Pallas| + 1e-2 on inputs rounded
to bf16 first.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.ops.pallas.sa_fused import sa_ball_mlp_max
from disprcnn_tpu_torch.bench import CONV_ATOL, CONV_RTOL
from disprcnn_tpu_torch.ops import points as tpoints
from disprcnn_tpu_torch.ops.cuda import sa as tsa
from disprcnn_tpu_torch.ops.cuda.conv3d import split_tf32


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cuda.matmul.allow_tf32 = False


def sa_inputs(seed, b, n, m, c0, chain, radius, s):
    """Seeded clouds whose balls are empty (a far centre), partial and
    full, and a chain of non-trivial weights; the arguments of
    sa_ball_mlp_max as torch tensors."""
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((b, n, 3)) * 1.2 * radius * n ** (1 / 3) / 4).astype(np.float32)
    k = min(n - 8, s + 4)  # a dense cluster around point 0: a full ball
    xyz[:, 1:1 + k] = xyz[:, :1] + rng.standard_normal((b, k, 3)).astype(np.float32) * 1e-3
    xyz[:, k + 2] = xyz[:, k + 1]  # coincident points
    # three points around (30, 30, 30), the centre of a partial ball; a
    # centre far from every point, an empty ball
    xyz[:, n - 3:] = 30.0 + rng.standard_normal((b, 3, 3)).astype(np.float32) * 1e-3
    centers = np.concatenate([xyz[:, :m - 2], np.full((b, 1, 3), 30.0, np.float32),
                              np.full((b, 1, 3), 60.0, np.float32)], axis=1)
    v = rng.standard_normal((b, n, c0)).astype(np.float32)
    w0x = (rng.standard_normal((3, c0)) * 0.5 / radius).astype(np.float32)
    mul0 = rng.uniform(0.5, 1.5, c0).astype(np.float32)
    add0 = (rng.standard_normal(c0) * 0.1).astype(np.float32)
    ws, cin = [], c0
    for co in chain:
        ws.append((torch.from_numpy((rng.standard_normal((cin, co)) / np.sqrt(cin))
                                    .astype(np.float32)),
                   torch.from_numpy((rng.standard_normal(co) * 0.1).astype(np.float32))))
        cin = co
    t = torch.from_numpy
    return (t(xyz), t(np.ascontiguousarray(centers)), t(v), t(w0x), t(mul0), t(add0), ws,
            radius, s)


def ball_kinds(args):
    """(empty, partial, full) ball counts of the inputs."""
    xyz, centers, radius, s = args[0], args[1], args[7], args[8]
    cnt = (tpoints.sqdist(centers[:, :, None], xyz[:, None]) < radius * radius).sum(-1)
    cnt = cnt.clamp_max(s)
    return int((cnt == 0).sum()), int(((cnt > 0) & (cnt < s)).sum()), int((cnt == s).sum())


def within_tolerance(got, want):
    err = float((got - want).abs().max())
    return err, err <= CONV_RTOL * float(want.abs().max()) + CONV_ATOL


# (B, N, M, C0, chain after mlp0, radius, S): the SA sites' widths and ball
# sizes at a few clouds (pointnet2.py's RPN SA1-SA3, rcnn3d.py's SA0-SA1)
SITES = [
    (2, 96, 32, 64, (64, 128), 0.5, 16),     # RPN SA1 scale 0
    (2, 96, 32, 64, (96, 128), 1.0, 32),     # RPN SA1 scale 1
    (2, 64, 24, 128, (196, 256), 1.0, 16),   # RPN SA2: a 196-wide layer
    (1, 48, 8, 256, (384, 512), 4.0, 32),    # RPN SA3 scale 1, the widest chain
    (3, 128, 16, 128, (128, 128), 0.2, 64),  # RCNN SA0
    (2, 96, 8, 128, (128, 256), 0.4, 64),    # RCNN SA1
]


@pytest.mark.parametrize("b,n,m,c0,chain,radius,s", SITES)
def test_3xtf32_sa_matches_plain(b, n, m, c0, chain, radius, s):
    args = sa_inputs(b + n + m + s, b, n, m, c0, chain, radius, s)
    empty, partial, full = ball_kinds(args)
    assert empty and partial and full, (empty, partial, full)
    got = tsa.sa_ball_mlp_max_3xtf32_plain(*args)
    want = tsa.sa_ball_mlp_max_plain(*args)
    assert got.shape == (b, m, chain[-1])
    err, ok = within_tolerance(got, want)
    assert ok, err
    assert err <= 1e-5 * float(want.abs().max())  # float32-level, 10x inside


def test_one_tf32_product_chain_misses_the_tolerance():
    """Why the split: the chain with hi*hi alone (plain TF32) is off the
    float32 chain by more than the card tolerance."""
    args = sa_inputs(3, *SITES[3])

    def one_tf32(x, weights):
        for w, b in weights:
            x = torch.relu(split_tf32(x)[0] @ split_tf32(w)[0] + b)
        return x
    _, ok = within_tolerance(tsa.sa_ball_mlp_max_plain(*args, chain=one_tf32),
                             tsa.sa_ball_mlp_max_plain(*args))
    assert not ok


@pytest.mark.parametrize("chain,s", [((64, 64), 8), ((196,), 16)])
def test_3xtf32_sa_matches_pallas(chain, s):
    """The emulated kernel against sa_ball_mlp_max (the TPU kernel it
    replaces) in interpret mode, on bf16-rounded features and weights, with
    empty, partial and full balls; one chain 196 wide."""
    def bf16(x):
        return torch.from_numpy(np.array(jnp.asarray(x.numpy()).astype(jnp.bfloat16)
                                         .astype(jnp.float32)))

    xyz, centers, v, w0x, mul0, add0, ws, radius, _ = sa_inputs(11, 2, 64, 16, 64, chain, 1.2, s)
    v = bf16(v)
    ws = [(bf16(w), b) for w, b in ws]
    args = (xyz, centers, v, w0x, mul0, add0, ws, radius, s)
    empty, partial, full = ball_kinds(args)
    assert empty and partial and full, (empty, partial, full)
    want = np.asarray(sa_ball_mlp_max(
        *(jnp.asarray(a.numpy()) for a in (xyz, centers, v, w0x, mul0, add0)),
        tuple((jnp.asarray(w.numpy()), jnp.asarray(b.numpy())) for w, b in ws), radius, s,
        interpret=True), np.float32)
    got = tsa.sa_ball_mlp_max_3xtf32_plain(*args).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max() + 1e-2


@pytest.mark.parametrize("widths", [(64, 196, 256), (128, 128, 128), (64, 80, 70, 40)])
def test_pack_tf32_chain_is_the_b_fragment_layout(widths):
    """pack_tf32_chain: per layer W (Ci, Co) as (ceil(Ci / 8), ceil(Co / 8),
    32, 4), entry [kk, nt, l] = [hi, hi, lo, lo] of W at rows 8 kk + l % 4
    and 8 kk + l % 4 + 4, column 8 nt + l // 4 (mma.m16n8k8's B fragment),
    zero past W's rows and columns; the layers one after the other."""
    rng = np.random.default_rng(len(widths))
    ws = [(torch.from_numpy(rng.standard_normal((ci, co)).astype(np.float32)), torch.zeros(co))
          for ci, co in zip(widths, widths[1:])]
    packed = tsa.pack_tf32_chain(ws)
    off = 0
    for w, _ in ws:
        ci, co = w.shape
        k8, n8 = -(-ci // 8), -(-co // 8)
        layer = packed[off:off + k8 * n8 * 128].reshape(k8, n8, 32, 4)
        off += k8 * n8 * 128
        hi, lo = split_tf32(w)
        kk, nt, lane = np.meshgrid(np.arange(k8), np.arange(n8), np.arange(32), indexing="ij")
        col = 8 * nt + lane // 4
        for e, (part, half) in enumerate(((hi, 0), (hi, 1), (lo, 0), (lo, 1))):
            row = 8 * kk + lane % 4 + 4 * half
            inside = (row < ci) & (col < co)
            want = np.zeros(row.shape, np.float32)
            want[inside] = part.numpy()[row[inside], col[inside]]
            np.testing.assert_array_equal(layer[..., e].numpy(), want)
    assert off == packed.numel()
