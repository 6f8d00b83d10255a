"""The arithmetic of the feature-propagation kernel's tensor-core chain
(csrc/fp.cu with csrc/mlp_tc.cuh) on the CPU: FP with its chain in 3xTF32
(`fp_fused_3xtf32_plain`: each product lo*hi + hi*lo + hi*hi of operands
split by split_tf32) against the plain float32 version and against the JAX
Pallas kernel it replaces.

The shapes are narrow cuts of the three FP sites, and cases that reach the
kernel's edges: a first-layer input whose 128-column chunk boundary falls
inside the skip columns, a last row tile of fewer than 64 targets, widths
that are not multiples of 8 (and of 4, the kernel's scalar staging), and
one to four layers.

Tolerances: against the plain version, the card's kernel tolerance
CONV_RTOL/CONV_ATOL (bench.py: max |diff| <= 1e-4 * max |plain| + 1e-5),
which one TF32 product alone misses; against the Pallas kernel in
interpret mode, which rounds its features, weights and activations to bf16
inside, test_torch_tf32_sa.py's 3e-2 * max |Pallas| + 1e-2 on inputs
rounded to bf16 first.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.ops.pallas.fp_fused import fp_fused as jfp_fused
from disprcnn_tpu_torch.bench import CONV_ATOL, CONV_RTOL
from disprcnn_tpu_torch.ops.cuda import fp as tfp
from disprcnn_tpu_torch.ops.cuda.conv3d import split_tf32


@pytest.fixture(scope="module", autouse=True)
def full_float32():
    torch.backends.cuda.matmul.allow_tf32 = False


def fp_inputs(seed, b, nt, ns, c, cs, chain):
    """Seeded clouds with coincident sources (distance ties), a target on a
    source (distance 0), features and a chain of non-trivial weights; the
    arguments of fp_fused as torch tensors."""
    rng = np.random.default_rng(seed)
    unknown = (rng.standard_normal((b, nt, 3)) * 1.5).astype(np.float32)
    known = (rng.standard_normal((b, ns, 3)) * 1.5).astype(np.float32)
    known[:, 2] = known[:, 1]
    unknown[:, 0] = known[:, 2]
    kf = rng.standard_normal((b, ns, c)).astype(np.float32)
    uf = rng.standard_normal((b, nt, cs)).astype(np.float32)
    ws, cin = [], c + cs
    for co in chain:
        ws.append((torch.from_numpy((rng.standard_normal((cin, co)) / np.sqrt(cin))
                                    .astype(np.float32)),
                   torch.from_numpy((rng.standard_normal(co) * 0.1).astype(np.float32))))
        cin = co
    t = torch.from_numpy
    return t(unknown), t(known), t(kf), t(uf), ws


def within_tolerance(got, want):
    err = float((got - want).abs().max())
    return err, err <= CONV_RTOL * float(want.abs().max()) + CONV_ATOL


# (B, Nt, Ns, C, Cs, chain)
SHAPES = [
    (2, 64, 16, 256, 128, (128, 128)),  # fp3 cut: two chunks of interpolated columns, one skip
    (2, 96, 40, 128, 64, (128, 128)),   # fp2 cut: a tail tile (96 = 64 + 32 targets)
    (2, 70, 48, 128, 24, (64, 64)),     # fp1 cut: the last chunk all skip, 24 of 128 columns
    (1, 40, 9, 100, 60, (30, 20)),      # chunk boundary 128 inside the skip columns [100, 160);
                                        # widths 30, 20 not multiples of 8
    (3, 50, 9, 20, 12, (30, 20, 10)),   # three layers, C, Cs and widths not multiples of 4
    (2, 33, 5, 37, 11, (45, 17, 33, 9)),  # four layers, every width odd
    (2, 20, 3, 8, 4, (16,)),            # one layer, Ns = 3
]


@pytest.mark.parametrize("b,nt,ns,c,cs,chain", SHAPES)
def test_3xtf32_fp_matches_plain(b, nt, ns, c, cs, chain):
    args = fp_inputs(b + nt + ns, b, nt, ns, c, cs, chain)
    got = tfp.fp_fused_3xtf32_plain(*args)
    want = tfp.fp_fused_plain(*args)
    assert got.shape == (b, nt, chain[-1])
    err, ok = within_tolerance(got, want)
    assert ok, err
    assert err <= 1e-5 * float(want.abs().max())  # float32-level, 10x inside


def test_one_tf32_product_fp_misses_the_tolerance():
    """Why the split: the chain with hi*hi alone (plain TF32) is off the
    float32 chain by more than the card tolerance."""
    args = fp_inputs(5, *SHAPES[0])

    def one_tf32(x, weights):
        for w, bias in weights:
            x = torch.relu(split_tf32(x)[0] @ split_tf32(w)[0] + bias)
        return x
    _, ok = within_tolerance(tfp.fp_fused_plain(*args, chain=one_tf32),
                             tfp.fp_fused_plain(*args))
    assert not ok


@pytest.mark.parametrize("b,nt,ns,c,cs,chain", [SHAPES[0], SHAPES[3], SHAPES[4]])
def test_3xtf32_fp_matches_pallas(b, nt, ns, c, cs, chain):
    """The emulated kernel against fp_fused (the TPU kernel it replaces) in
    interpret mode, on bf16-rounded features and weights."""
    def bf16(x):
        return torch.from_numpy(np.array(jnp.asarray(x.numpy()).astype(jnp.bfloat16)
                                         .astype(jnp.float32)))

    unknown, known, kf, uf, ws = fp_inputs(11 + nt, b, nt, ns, c, cs, chain)
    kf, uf = bf16(kf), bf16(uf)
    ws = [(bf16(w), bias) for w, bias in ws]
    want = np.asarray(jfp_fused(
        *(jnp.asarray(a.numpy()) for a in (unknown, known, kf, uf)),
        tuple((jnp.asarray(w.numpy()), jnp.asarray(bias.numpy())) for w, bias in ws),
        interpret=True), np.float32)
    got = tfp.fp_fused_3xtf32_plain(unknown, known, kf, uf, ws).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max() + 1e-2
