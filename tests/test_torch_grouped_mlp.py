"""Row 12 of the kernel table, the grouped MLP + max, and the PointNet++
route that takes it when the SA family is off, against the JAX package on
the CPU.

- The plain version against ``grouped_mlp_max`` in interpret mode, which
  rounds x, the weights and every layer to bf16 inside (inputs rounded to
  bf16 first): 3e-2 relative + 2e-2 absolute; against the same chain in
  jnp float32: 1e-5.
- One SA scale with ``kernels_off={"sa"}`` against JAX's
  ``_fused_group_mlp`` routed to row 12 (DISPRCNN_PALLAS_DISABLE=sa, the
  Pallas kernels interpreted, a TPU backend faked), at the bf16 tolerance,
  and against JAX's XLA route at 2e-5; a call counter shows that the JAX
  side reached ``grouped_mlp_max`` and not ``sa_ball_mlp_max``.
- A small RPN3D and RCNNNet with ``kernels_off={"sa"}`` against JAX's XLA
  route at the port's float32 tolerance (1e-4 * max |JAX| + 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.pointrcnn import pointnet2 as jpn2
from disprcnn_tpu.models.pointrcnn import rcnn3d as jrcnn
from disprcnn_tpu.models.pointrcnn import rpn3d as jrpn
from disprcnn_tpu.ops.pallas import grouped_mlp as jgm
from disprcnn_tpu.ops.pallas import sa_fused as jsa
from disprcnn_tpu_torch.models.detector.disprcnn3d import DispRCNN3D
from disprcnn_tpu_torch.models.pointrcnn import pointnet2 as tpn2
from disprcnn_tpu_torch.models.pointrcnn import rcnn3d as trcnn
from disprcnn_tpu_torch.models.pointrcnn import rpn3d as trpn
from disprcnn_tpu_torch.ops.cuda import grouped_mlp as tgm
from disprcnn_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import draw_variables


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def close(got, want, rtol, atol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max() + atol, err


def chain_inputs(seed, g, s, c0, chain):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, s, c0)).astype(np.float32)
    mul0 = rng.uniform(0.5, 1.5, c0).astype(np.float32)
    add0 = (rng.standard_normal(c0) * 0.2).astype(np.float32)
    ws, cin = [], c0
    for co in chain:
        ws.append(((rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32),
                   (rng.standard_normal(co) * 0.1).astype(np.float32)))
        cin = co
    return x, mul0, add0, ws


def jnp_chain(x, mul0, add0, ws):
    y = jnp.maximum(jnp.asarray(x) * mul0 + add0, 0.0)
    for w, b in ws:
        y = jnp.maximum(jnp.dot(y, w, precision=jax.lax.Precision.HIGHEST) + b, 0.0)
    return jnp.max(y, axis=1)


def port(x, mul0, add0, ws):
    return tgm.grouped_mlp_max(t(x), t(mul0), t(add0), [(t(w), t(b)) for w, b in ws])


@pytest.mark.parametrize("g,s,chain", [
    (130, 1, (64,)),          # one layer; the JAX tile (128) does not divide G
    (37, 8, (96, 70)),        # two layers, a width not a multiple of 4
    (20, 16, (48, 80, 64)),   # three layers
])
def test_grouped_mlp_plain_matches_pallas_interpret(g, s, chain):
    x, mul0, add0, ws = chain_inputs(g + s, g, s, 64, chain)
    x = bf16(x)
    ws = [(bf16(w), b) for w, b in ws]
    want = jgm.grouped_mlp_max(jnp.asarray(x), jnp.asarray(mul0), jnp.asarray(add0),
                               tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in ws),
                               interpret=True)
    got = port(x, mul0, add0, ws)
    assert got.shape == (g, chain[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=3e-2, atol=2e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp_chain(x, mul0, add0, ws)),
                               rtol=1e-5, atol=1e-5)


def test_grouped_mlp_plain_chunks_like_whole(monkeypatch):
    """The plain version's group chunks (memory bound) change nothing."""
    args = chain_inputs(3, 23, 8, 64, (40, 24))
    whole = port(*args)
    monkeypatch.setattr(tgm, "PLAIN_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(port(*args).numpy(), whole.numpy())


def test_grouped_mlp_refuses_chains_the_kernel_does_not_hold():
    """JAX's kernel needs one layer (weights[-1]); the CUDA kernel holds at
    most four. Both raise on the CPU too, before any kernel would."""
    x, mul0, add0, ws = chain_inputs(4, 5, 4, 8, (8,) * 5)
    with pytest.raises(ValueError, match="layers"):
        port(x, mul0, add0, [])
    with pytest.raises(ValueError, match="layers"):
        port(x, mul0, add0, ws)


def counting(monkeypatch, module, name, counts):
    orig = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


def clouds(seed, b, n, scale=1.0):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((b, n, 3)) * scale).astype(np.float32)
    xyz[:, 5] = xyz[:, 2]  # coincident points
    return xyz


@pytest.mark.parametrize("use_bn", [True, False])
@pytest.mark.parametrize("with_feats", [True, False])
def test_sa_scale_with_sa_off_matches_jax_row12(monkeypatch, use_bn, with_feats):
    """One ball-grouped scale of 64+ channels with the SA family off: JAX's
    _fused_group_mlp takes row 12 (grouped_mlp_max, interpreted) and the
    port's ball_mlp_max its pool route; without input features JAX takes
    row 12 with SA on as well."""
    b, n, m, radius, s, mlp = 2, 48, 12, 0.9, 16, (64, 72, 80)
    xyz = clouds(20, b, n)
    nf = 24 if with_feats else 0
    feats = (np.random.default_rng(21).standard_normal((b, n, nf)).astype(np.float32)
             if with_feats else None)
    new_xyz = xyz[:, :m]
    jm = jpn2.SharedMLP(mlp, use_bn=use_bn)
    v = draw_variables(jm, jnp.zeros((b, m, s, 3 + nf)), False, seed=22)
    tm = load_jax_variables(tpn2.SharedMLP(mlp, 3 + nf, use_bn), v)
    jargs = (jnp.asarray(xyz), None if feats is None else jnp.asarray(feats),
             jnp.asarray(new_xyz), radius, s, True, use_bn, False)
    xla = jpn2._fused_group_mlp(jm.bind(v), *jargs)  # the CPU backend: no kernel

    counts, port_counts = {}, {}
    counting(monkeypatch, jgm, "grouped_mlp_max", counts)
    counting(monkeypatch, jsa, "sa_ball_mlp_max", counts)
    counting(monkeypatch, tpn2, "grouped_mlp_max", port_counts)
    counting(monkeypatch, tpn2, "sa_ball_mlp_max", port_counts)
    monkeypatch.setenv("DISPRCNN_PALLAS_DISABLE", "sa")
    monkeypatch.setattr(jpn2, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    row12 = jpn2._fused_group_mlp(jm.bind(v), *jargs)
    assert counts == {"grouped_mlp_max": 1}, counts

    with torch.no_grad():
        got = tpn2.ball_mlp_max(tm, t(xyz), None if feats is None else t(feats), t(new_xyz),
                                radius, s, tpn2.SA_MIN_C0, frozenset({"sa"}))
    assert port_counts == {"grouped_mlp_max": 1}, port_counts
    close(got, row12, rtol=3e-2, atol=2e-2)
    close(got, xla, rtol=2e-5, atol=2e-5)


def test_pool_route_chunks_like_whole(monkeypatch):
    """Forming the grouped pre-activation per chunk of clouds (memory
    bound) changes nothing."""
    xyz, feats = clouds(30, 5, 40), np.random.default_rng(30).standard_normal((5, 40, 8))
    tm = tpn2.SAModule(10, 0.8, 8, (64, 32), 8, kernels_off={"sa"})
    with torch.no_grad():
        whole = tm(t(xyz), t(feats))[1]
        monkeypatch.setattr(tpn2, "GROUPED_CHUNK_ELEMS", 1)
        np.testing.assert_array_equal(tm(t(xyz), t(feats))[1].numpy(), whole.numpy())


def test_rpn3d_with_sa_off_matches_jax_xla(monkeypatch):
    """RPN3D at npoints 128/64/32/16 with the SA family off: SA1-SA3 (six
    scales) through the pool route, against JAX's XLA route."""
    pts = clouds(40, 2, 128, 2.0)
    jm = jrpn.RPN3D(npoints=(128, 64, 32, 16))
    v = draw_variables(jm, jnp.asarray(pts), False, seed=41)
    want = jax.jit(lambda vv, p: jm.apply(vv, p, False))(v, jnp.asarray(pts))
    tm = load_jax_variables(trpn.RPN3D(npoints=(128, 64, 32, 16), kernels_off={"sa"}), v)
    counts = {}
    counting(monkeypatch, tpn2, "grouped_mlp_max", counts)
    with torch.no_grad():
        got = tm(t(pts))
    assert counts == {"grouped_mlp_max": 6}, counts
    np.testing.assert_array_equal(got["xyz"].numpy(), np.asarray(want["xyz"]))
    for k in ("features", "cls", "reg"):
        close(got[k], want[k], rtol=1e-4, atol=1e-4)


def test_rcnn_net_with_sa_off_matches_jax_xla(monkeypatch):
    """RCNNNet with the SA family off: SA0 and SA1 through the pool route
    (group-all plain), against JAX's XLA route."""
    pts_input = np.concatenate([clouds(50, 2, 256, 0.4),
                                np.random.default_rng(50).standard_normal((2, 256, 130))],
                               -1).astype(np.float32)
    jm = jrcnn.RCNNNet()
    v = draw_variables(jm, jnp.asarray(pts_input), False, seed=51)
    wc, wr = jax.jit(lambda vv, x: jm.apply(vv, x, False))(v, jnp.asarray(pts_input))
    tm = load_jax_variables(trcnn.RCNNNet(kernels_off={"sa"}), v)
    counts = {}
    counting(monkeypatch, tpn2, "grouped_mlp_max", counts)
    with torch.no_grad():
        gc, gr = tm(t(pts_input))
    assert counts == {"grouped_mlp_max": 2}, counts
    close(gc, wc, rtol=1e-4, atol=1e-4)
    close(gr, wr, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tags", [{"conv3d"}, {"sa", "satrain"}, {"SA"}])
def test_unknown_kernel_tag_raises(tags):
    """Only the PointNet++ families' tags are routes of the port."""
    with pytest.raises(ValueError, match="unknown kernel family"):
        tpn2.SAModule(8, 0.5, 8, (64, 64), 4, kernels_off=tags)
    with pytest.raises(ValueError, match="unknown kernel family"):
        DispRCNN3D(max_det=1, roi_size=32, maxdisp=8, mindisp=-8, det3d_on=True, npoints=32,
                   lift_grid=8, sa_npoints=(32, 16, 8, 4), kernels_off=tags, device="cpu")
    with pytest.raises(ValueError, match="unknown kernel family"):
        tpn2.set_kernels_off(tpn2.FPModule((8,), 8), tags)
