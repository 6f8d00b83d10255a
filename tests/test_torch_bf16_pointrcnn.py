"""The port's bf16 3D stage (TPU.COMPUTE_DTYPE bfloat16 with DET3D_ON,
rcnn.yaml) against the JAX package on the CPU: each bf16 twin of the
PointNet++ kernels (ops/cuda/sa.py, fp.py, grouped_mlp.py, roipool3d.py)
against the JAX Pallas kernel it replaces, run in interpret mode on bf16
inputs; PointRCNN(dtype=bfloat16) against JAX's PointRCNN(dtype=
jnp.bfloat16) on its kernel route (_FORCE_INTERPRET), at 2 clouds of 128
points, the SA ladder 128/64/32/16 and 4 proposals an instance; and the
bf16 model that build_detection_model makes of rcnn.yaml.

Tolerances, with their reasons:
- a twin of rows 10, 12 and 13 against its Pallas kernel: every element at
  most one bf16 step apart beyond ``bf16_agreement``'s floor (the last
  layer's float32 sums, in another order, and the hidden layers' outputs
  rounding to either side of a bf16 midpoint: sa.bf16_chain_floor); the
  first layer's input (row 10's x0, row 13's interpolation, row 12's
  affine) rounds at the same points on both sides.
- row 14 reading bf16 features: bit-equal to the Pallas kernel on the
  features widened to float32 (copies of the same values).
- the RPN's outputs: bf16 rounds every layer, so the port and JAX's
  kernel route are each held to the port's float32 run of the same
  weights (plain versions): the port's mean |x - float32| at most 1.25
  times JAX's plus 1e-3 of the float32 run's mean |x|.
- the proposal layer and the postprocess fed JAX's own bf16 head outputs:
  the kept proposals, their scores, `random` and the chosen score
  exactly, the boxes to 1e-5 (float32 decodes, as
  tests/test_torch_pointrcnn.py holds them); bf16 scores tie often, and
  ties go to the lowest index on both sides (ROADMAP C4). JAX's functions
  run op by op there, as their source rounds: jitted, XLA on the CPU
  computes a bf16 chain that ends in a float32 value (the sizes
  pred * anchor + anchor, concatenated into the float32 box) in float32
  (ROADMAP C42).
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.config import get_default_cfg as jax_default_cfg
from disprcnn_tpu.models import build as jbuild
from disprcnn_tpu.models.pointrcnn import bbox3d_codec as jcodec
from disprcnn_tpu.models.pointrcnn import point_rcnn as jpr
from disprcnn_tpu.models.pointrcnn import pointnet2 as jpn2
from disprcnn_tpu.models.pointrcnn import rcnn3d as jrcnn
from disprcnn_tpu.models.pointrcnn import rpn3d as jrpn
from disprcnn_tpu.models.psmnet import psmnet as jpsm
from disprcnn_tpu.ops.pallas.fp_fused import fp_fused as jfp_fused
from disprcnn_tpu.ops.pallas.grouped_mlp import grouped_mlp_max as jgrouped_mlp_max
from disprcnn_tpu.ops.pallas.roipool3d_fused import roipool3d_fused
from disprcnn_tpu.ops.pallas.sa_fused import sa_ball_mlp_max as jsa_ball_mlp_max
from disprcnn_tpu_torch.config import get_default_cfg
from disprcnn_tpu_torch.models import build as tbuild
from disprcnn_tpu_torch.models.pointrcnn import bbox3d_codec as tcodec
from disprcnn_tpu_torch.models.pointrcnn import point_rcnn as tpr
from disprcnn_tpu_torch.ops.losses import sigmoid
from disprcnn_tpu_torch.models.pointrcnn import rcnn3d as trcnn
from disprcnn_tpu_torch.models.pointrcnn import rpn3d as trpn
from disprcnn_tpu_torch.models.psmnet.psmnet import PSMNet
from disprcnn_tpu_torch.ops.cuda import conv3d as tconv
from disprcnn_tpu_torch.ops.cuda import fp as tfp
from disprcnn_tpu_torch.ops.cuda import grouped_mlp as tgm
from disprcnn_tpu_torch.ops.cuda import roipool3d as tcroi
from disprcnn_tpu_torch.ops.cuda import sa as tsa
from disprcnn_tpu_torch.utils.weights import load_jax_variables, state_dict_from_jax
from torch_eval_helpers import REPO
from torch_port_helpers import draw_variables
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

BF16 = torch.bfloat16
R, N = 2, 128
SA_NPOINTS = (128, 64, 32, 16)
POST = 4
RCNN_YAML = str(REPO / "configs/kitti/car/vob/rcnn.yaml")


def t(x):
    return torch.from_numpy(np.array(x))


def tbf(x):
    """A JAX bf16 array (or float32 numpy values that are bf16 numbers) as
    a torch bf16 tensor."""
    return t(np.asarray(x, np.float32)).to(BF16)


def jbf(x):
    return jnp.asarray(x, jnp.bfloat16)


def within_step_of_floor(got: torch.Tensor, want, floor: torch.Tensor) -> dict:
    """got (the twin, bf16) and want (the Pallas kernel's bf16 output):
    every element at most one bf16 step apart beyond the floor, and at most
    one step where the floor is under a step."""
    want = tbf(want)
    assert got.dtype == BF16 and got.shape == want.shape, (got.shape, want.shape)
    agree = tconv.bf16_agreement(got, want, floor)
    assert agree["beyond"] == 0 and agree["max_ulps_clear"] <= 1, agree
    return agree


def cloud(seed, b, n, scale=1.5):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n, 3)) * scale).astype(np.float32)
    x[:, 5] = x[:, 2]  # a distance tie
    return x


def chain_weights(rng, cin, chain):
    ws = []
    for co in chain:
        ws.append(((rng.standard_normal((cin, co)) / np.sqrt(cin)).astype(np.float32),
                   (rng.standard_normal(co) * 0.1).astype(np.float32)))
        cin = co
    return ws


def bf16_values(rng, *shape):
    return tbf(rng.standard_normal(shape).astype(np.float32)).float().numpy()


@pytest.mark.parametrize("chain,s", [((64, 128), 16), ((96, 128), 32)])
def test_sa_bf16_twin_matches_pallas(torch_one_thread, chain, s):
    """Row 10: the JAX kernel (_kernel_t) in interpret mode on bf16 v, the
    port's sa_ball_mlp_max_bf16_plain; the ball indices exactly (the x0
    rows round at the same points)."""
    rng = np.random.default_rng(len(chain) + s)
    b, n, m, c0 = 2, 96, 24, 64
    xyz = cloud(s, b, n)
    centers = np.concatenate([xyz[:, :m - 1], np.full((b, 1, 3), 50.0, np.float32)], 1)
    v = bf16_values(rng, b, n, c0)
    w0x = (rng.standard_normal((3, c0)) * 0.5).astype(np.float32)
    mul0 = rng.uniform(0.5, 1.5, c0).astype(np.float32)
    add0 = (rng.standard_normal(c0) * 0.1).astype(np.float32)
    ws = chain_weights(rng, c0, chain)
    want = jsa_ball_mlp_max(jnp.asarray(xyz), jnp.asarray(centers), jbf(v),
                            *(jnp.asarray(a) for a in (w0x, mul0, add0)),
                            tuple((jnp.asarray(w), jnp.asarray(bb)) for w, bb in ws), 1.2, s,
                            interpret=True)
    assert want.dtype == jnp.bfloat16
    args = (t(xyz), t(centers), tbf(v), t(w0x), t(mul0), t(add0),
            [(t(w), t(bb)) for w, bb in ws], 1.2, s)
    got = tsa.sa_ball_mlp_max(*args)
    within_step_of_floor(got, want, tsa.sa_ball_mlp_max_bf16_plain(
        *args, chain=tsa.bf16_chain_floor))


def test_fp_bf16_twin_matches_pallas(torch_one_thread):
    """Row 13: the JAX kernel in interpret mode on bf16 known and skip
    features, the port's fp_fused_bf16_plain."""
    rng = np.random.default_rng(13)
    b, nt, ns, c, cs = 2, 40, 12, 24, 16
    unknown, known = cloud(1, b, nt), cloud(2, b, ns)
    unknown[:, 0] = known[:, 4]  # a zero distance
    kf, uf = bf16_values(rng, b, ns, c), bf16_values(rng, b, nt, cs)
    ws = chain_weights(rng, c + cs, (32, 24))
    want = jfp_fused(jnp.asarray(unknown), jnp.asarray(known), jbf(kf), jbf(uf),
                     tuple((jnp.asarray(w), jnp.asarray(bb)) for w, bb in ws), interpret=True)
    assert want.dtype == jnp.bfloat16
    args = (t(unknown), t(known), tbf(kf), tbf(uf), [(t(w), t(bb)) for w, bb in ws])
    got = tfp.fp_fused(*args)
    within_step_of_floor(got, want, tfp.fp_fused_bf16_plain(*args, chain=tsa.bf16_chain_floor))


def test_grouped_mlp_bf16_twin_matches_pallas(torch_one_thread):
    """Row 12 (the SA-off route): the JAX kernel in interpret mode on a bf16
    grouped x, the port's grouped_mlp_max_bf16_plain (the CPU route of a
    bf16 model; on the card its kernel, ROADMAP A8.3b)."""
    rng = np.random.default_rng(12)
    g, s, c0 = 24, 16, 64
    x = bf16_values(rng, g, s, c0)
    mul0 = rng.uniform(0.5, 1.5, c0).astype(np.float32)
    add0 = (rng.standard_normal(c0) * 0.1).astype(np.float32)
    ws = chain_weights(rng, c0, (64, 96))
    want = jgrouped_mlp_max(jbf(x), jnp.asarray(mul0), jnp.asarray(add0),
                            tuple((jnp.asarray(w), jnp.asarray(bb)) for w, bb in ws),
                            interpret=True)
    assert want.dtype == jnp.bfloat16
    got = tgm.grouped_mlp_max(tbf(x), t(mul0), t(add0), [(t(w), t(bb)) for w, bb in ws])
    x0 = torch.relu(tbf(x).float() * t(mul0) + t(add0)).to(BF16)
    floor = tsa.bf16_chain_floor(x0, [(t(w), t(bb)) for w, bb in ws]).amax(dim=1)
    within_step_of_floor(got, want, floor)


def test_roipool3d_bf16_read_matches_pallas_bit_for_bit():
    """Row 14 reading bf16 features beside float32 mask and depth channels:
    the Pallas kernel (its production "f32dot" gather and the bf16 split
    one) in interpret mode on the features widened to float32."""
    rng = np.random.default_rng(14)
    b, n, s = 2, 300, 64
    pts = rng.uniform(-4, 4, (b, n, 3)).astype(np.float32)
    extra = np.stack([(rng.uniform(size=(b, n)) > 0.5).astype(np.float32),
                      rng.standard_normal((b, n)).astype(np.float32)], -1)
    feats = bf16_values(rng, b, n, 8)
    boxes = np.tile(np.array([[0.0, 2.0, 0.0, 4.0, 4.0, 4.0, 0.4],
                              [1.0, 0.5, -1.0, 1.6, 2.0, 2.0, -0.8],
                              [50.0, 50.0, 50.0, 1.0, 1.0, 1.0, 0.0]], np.float32)[None],
                    (b, 1, 1))
    wide = np.concatenate([extra, feats], -1)
    got, gempty = tcroi.roipool3d_bf16(t(pts), t(extra), tbf(feats), t(boxes), s)
    assert got.dtype == torch.float32 and gempty.any() and not gempty.all()
    for f32ch in ("f32dot", (1,)):  # the bf16 split: only depth needs the exact 3-split
        want, wempty = roipool3d_fused(jnp.asarray(pts), jnp.asarray(wide), jnp.asarray(boxes),
                                       s, interpret=True, f32_channels=f32ch)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gempty.numpy(), np.asarray(wempty))


# -- PointRCNN(dtype=bfloat16) against JAX's kernel route ----------------------


def _instances():
    rng = np.random.default_rng(20)
    pts = (rng.standard_normal((R, N, 3)) * np.array([1.5, 0.6, 0.8])).astype(np.float32)
    pts[:, 7] = pts[:, 3]
    valid = np.array([True, True])
    ang = np.array([0.1, -0.3], np.float32)
    mean = (rng.standard_normal((R, 3)) * 5 + np.array([0, 1, 20])).astype(np.float32)
    return pts, valid, ang, mean


def _intermediates(state):
    """JAX's captured module outputs: the RPN's dict and the RCNN's (cls,
    reg)."""
    inter = state["intermediates"]
    return inter["rpn"]["__call__"][0], inter["rcnn"]["__call__"][0]


@pytest.fixture(scope="module")
def bf16_pointrcnn():
    """One set of drawn variables; JAX's bf16 PointRCNN on its kernel route
    (every SA scale of 64+ channels and FP level 1-3 through the Pallas
    kernels, interpreted) and on its XLA route, with their RPN and RCNN
    outputs; the port's bf16 and float32 PointRCNN on the CPU (plain
    versions)."""
    args = _instances()
    jm = jpr.PointRCNN(npoints=N, sa_npoints=SA_NPOINTS, proposals_per_roi=POST,
                       dtype=jnp.bfloat16)
    jargs = tuple(jnp.asarray(a) for a in args)
    v = draw_variables(jm, *jargs, seed=21, train=False)
    def run(vv, *a):  # traced anew for each route: the gate is read at trace time
        return jm.apply(vv, *a, train=False, capture_intermediates=True,
                        mutable=["intermediates"])

    out = {}
    try:
        jpn2._FORCE_INTERPRET = True
        out["kernel"] = jax.jit(run)(v, *jargs)
    finally:
        jpn2._FORCE_INTERPRET = False
    out["xla"] = jax.jit(lambda vv, *a: run(vv, *a))(v, *jargs)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            for name, dt in (("port", BF16), ("f32", torch.float32)):
                tm = load_jax_variables(tpr.PointRCNN(npoints=N, sa_npoints=SA_NPOINTS,
                                                      proposals_per_roi=POST, dtype=dt), v)
                rpn = tm.rpn(t(args[0]))
                out[name] = (tm(*(t(a) for a in args)), rpn)
    finally:
        torch.set_num_threads(n)
    return dict(out=out, args=args, v=v, jm=jm)


def test_bf16_rpn_as_close_to_float32_as_jax(bf16_pointrcnn):
    """The RPN's features, cls and reg: the port's bf16 run against the
    port's float32 run, as close as JAX's kernel route is (1.25x + 1e-3 of
    the float32 mean magnitude); the points float32 and equal."""
    out = bf16_pointrcnn["out"]
    (_, jstate), (_, prpn), (_, frpn) = out["kernel"], out["port"], out["f32"]
    jrpn_out, _ = _intermediates(jstate)
    np.testing.assert_array_equal(prpn["xyz"].numpy(), np.asarray(jrpn_out["xyz"]))
    assert prpn["xyz"].dtype == torch.float32
    for k in ("features", "cls", "reg"):
        ref = frpn[k].numpy()
        port = prpn[k].float().numpy()
        jk = np.asarray(jrpn_out[k], np.float32)
        assert prpn[k].dtype == BF16 and jrpn_out[k].dtype == jnp.bfloat16, k
        d_port, d_jax = np.abs(port - ref).mean(), np.abs(jk - ref).mean()
        print(f"RPN {k}: mean |bf16 - float32| port {d_port:.5f}, JAX kernel route {d_jax:.5f} "
              f"(float32 mean |x| {np.abs(ref).mean():.4f}); port vs JAX mean "
              f"{np.abs(port - jk).mean():.5f}, max {np.abs(port - jk).max():.4f}")
        assert d_jax > 0 and d_port <= 1.25 * d_jax + 1e-3 * np.abs(ref).mean(), (k, d_port,
                                                                                  d_jax)


def test_bf16_proposals_and_postprocess_match_jax_on_its_head_outputs(bf16_pointrcnn):
    """propose and rcnn_postprocess fed JAX's own bf16 RPN and RCNN outputs:
    the kept proposals, scores and flags, `random` and the score exactly,
    the boxes to 1e-5; every output at JAX's dtype."""
    out, (pts, valid, ang, mean) = bf16_pointrcnn["out"], bf16_pointrcnn["args"]
    jout, jstate = out["kernel"]
    jrpn_out, (jcls, jreg) = _intermediates(jstate)
    anchor = jnp.asarray(tpr.MEAN_SIZE, jnp.bfloat16)
    tanchor = torch.tensor(tpr.MEAN_SIZE).to(BF16)
    np.testing.assert_array_equal(tanchor.float().numpy(), np.asarray(anchor, np.float32))
    assert tanchor.tolist() == [1.5234375, 1.625, 3.890625]
    w = jrpn.propose(jrpn_out["cls"], jrpn_out["reg"], jrpn_out["xyz"], anchor,
                     jcodec.CodecCfg(loc_scope=3.0, loc_bin_size=0.5, num_head_bin=12),
                     N, POST, 0.8)
    g = trpn.propose(tbf(jrpn_out["cls"]), tbf(jrpn_out["reg"]), t(jrpn_out["xyz"]), tanchor,
                     tcodec.CodecCfg(loc_scope=3.0, loc_bin_size=0.5, num_head_bin=12),
                     N, POST, 0.8)
    for a, b_ in zip(g, w):
        assert str(a.dtype).split(".")[-1] == jnp.dtype(b_.dtype).name
    np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
    np.testing.assert_array_equal(g[1].float().numpy(), np.asarray(w[1], np.float32))
    np.testing.assert_allclose(g[0].numpy(), np.asarray(w[0]), rtol=0, atol=1e-5)
    # the postprocess on the rois the model pooled and JAX's RCNN outputs
    rois = jpr._decanon_rois(w[0], jnp.asarray(ang), jnp.asarray(mean))
    ok = np.asarray(w[2]) & valid[:, None]
    cls, reg = jcls.reshape(R, POST), jreg.reshape(R, POST, -1)
    assert cls.dtype == reg.dtype == jnp.bfloat16
    wp = jrcnn.rcnn_postprocess(cls, reg, rois, jnp.asarray(ok), w[1], anchor)
    gp = trcnn.rcnn_postprocess(tbf(cls), tbf(reg), t(rois), t(ok), tbf(w[1]), tanchor)
    for a, b_ in zip(gp, wp):
        assert str(a.dtype).split(".")[-1] == jnp.dtype(b_.dtype).name
    np.testing.assert_array_equal(gp[2].numpy(), np.asarray(wp[2]))
    np.testing.assert_array_equal(gp[1].float().numpy(), np.asarray(wp[1], np.float32))
    np.testing.assert_allclose(gp[0].numpy(), np.asarray(wp[0]), rtol=0, atol=1e-5)
    # the model's own outputs: JAX's dtypes
    port, _ = out["port"]
    for k in ("box3d", "score3d", "random"):
        assert str(port[k].dtype).split(".")[-1] == jnp.dtype(jout[k].dtype).name, k
    assert port["score3d"].dtype == BF16 and port["box3d"].dtype == torch.float32


def test_bf16_mixed_dtype_ops_match_jax():
    """torch and JAX promote a bf16 tensor with a 0-dim float32 tensor
    differently (bf16 against float32); the mixed ops of the bf16 3D path
    give JAX's dtypes: the decode (float32 positions, bf16 sizes, a float32
    box), the segmentation mask (bf16 sigmoid compared in bf16), the pooled
    input (float32 from bf16 features, a bf16 mask and a float32 depth)."""
    rng = np.random.default_rng(30)
    pred = bf16_values(rng, 64, jcodec.CodecCfg().reg_channels)
    pred[:4, :6] = pred[:4, 6:12] = 1.0  # ties among the bins: the first wins
    base = rng.standard_normal((64, 3)).astype(np.float32)
    ry = rng.uniform(-3, 3, 64).astype(np.float32)
    anchor = jnp.asarray(tpr.MEAN_SIZE, jnp.bfloat16)
    for cfg, bry in ((jcodec.CodecCfg(), None), (jrcnn.RCNN_CODEC, ry)):
        w = jcodec.decode(jnp.asarray(base), jbf(pred[:, :cfg.reg_channels]), anchor, cfg,
                          base_ry=None if bry is None else jnp.asarray(bry))
        g = tcodec.decode(t(base), tbf(pred[:, :cfg.reg_channels]),
                          torch.tensor(tpr.MEAN_SIZE).to(BF16), tcodec.CodecCfg(*cfg),
                          base_ry=None if bry is None else t(bry))
        assert w.dtype == jnp.float32 and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    logits = bf16_values(rng, 2, 64) * 2
    logits[0, :4] = [-0.8515625, -0.84765625, 0.0, 1.0]  # sigmoids at bf16's 0.30078125
    wseg = (jax.nn.sigmoid(jbf(logits)) > 0.3).astype(jnp.bfloat16)
    gseg = (sigmoid(tbf(logits)) > 0.3).to(BF16)
    assert gseg.dtype == BF16 and wseg.dtype == jnp.bfloat16
    np.testing.assert_array_equal(gseg.float().numpy(), np.asarray(wseg, np.float32))
    xyz = cloud(31, 2, 64) * 0.5
    feats = bf16_values(rng, 2, 64, 8)
    rois = np.tile(np.array([[0.0, 0.5, 0.0, 1.5, 1.6, 3.9, 0.2]], np.float32)[None], (2, 2, 1))
    wp, we = jrcnn.pool_rcnn_inputs(jnp.asarray(xyz), jbf(feats), wseg, jnp.asarray(rois),
                                    num_points=32)
    gp, ge = trcnn.pool_rcnn_inputs(t(xyz), tbf(feats), gseg, t(rois), num_points=32)
    assert wp.dtype == jnp.float32 and gp.dtype == torch.float32
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-6)


def test_jax_bf16_pointrcnn_routes_differ(bf16_pointrcnn):
    """JAX's bf16 PointRCNN computes two functions (ROADMAP C41): its XLA
    route rounds mlp0's pre-activation, BN and every layer at Flax's points
    (bf16 BN output before the ReLU), its kernel route applies BN0's affine
    in float32 inside the kernels and rounds once after the ReLU, and FP
    interpolates in float32 before one rounding. The port follows the
    kernel route. Printed: the gap between the routes' RPN outputs and
    boxes."""
    out = bf16_pointrcnn["out"]
    (xo, xs), (ko, ks) = out["xla"], out["kernel"]
    xr, _ = _intermediates(xs)
    kr, _ = _intermediates(ks)
    for k in ("features", "cls", "reg"):
        a, b_ = np.asarray(xr[k], np.float32), np.asarray(kr[k], np.float32)
        print(f"JAX bf16 XLA route vs kernel route, RPN {k}: mean |diff| "
              f"{np.abs(a - b_).mean():.5f}, max {np.abs(a - b_).max():.4f} (mean |x| "
              f"{np.abs(b_).mean():.4f})")
        assert np.isfinite(a).all() and np.isfinite(b_).all()
    gap = np.abs(np.asarray(xo["box3d"]) - np.asarray(ko["box3d"]))
    print(f"JAX bf16 routes: box3d max |diff| {gap.max():.4f}, random "
          f"{np.asarray(xo['random']).tolist()} vs {np.asarray(ko['random']).tolist()}")
    assert np.abs(np.asarray(xr["features"], np.float32)
                  - np.asarray(kr["features"], np.float32)).max() > 0


def test_rcnn_yaml_builds_bf16_and_loads_jax_bf16_variables(caplog):
    """build_detection_model on rcnn.yaml at its default TPU.COMPUTE_DTYPE
    gives DispRCNN3D with iDispNet and PointRCNN both at bf16, as the JAX
    build gives DispRCNN3D(dtype=bfloat16); its parameters stay float32, so
    state_dict_from_jax loads the JAX bf16 model's variables unchanged.
    Built to train (tools/train_net) it is bf16 too, as JAX's train_net
    builds it (ROADMAP A8.4), and a bf16 PointRCNN in train mode asks for
    its ground truth."""
    opts = ["TPU.ROI_CROP_SIZE", "32", "MODEL.DISPNET.MAX_DISP", "16",
            "MODEL.DISPNET.MIN_DISP", "-16", "MODEL.POINTRCNN.RPN.NPOINTS", str(N),
            "MODEL.POINTRCNN.RPN.SA_CONFIG.NPOINTS", "[128, 64, 32, 16]",
            "MODEL.POINTRCNN.TEST.RPN_POST_NMS_TOP_N", str(POST)]
    cfg, jcfg = get_default_cfg(), jax_default_cfg()
    for c in (cfg, jcfg):
        c.merge_from_file(RCNN_YAML)
        c.merge_from_list(opts)
        c.freeze()
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16" and cfg.MODEL.DET3D_ON
    jm = jbuild.build_detection_model(jcfg)
    assert jm.dtype == jnp.bfloat16 and jm.det3d_on
    with caplog.at_level(logging.INFO, logger="disprcnn_tpu_torch.models.build"):
        tm = tbuild.build_detection_model(cfg, device="cpu")
    assert "ROADMAP A8" not in caplog.text
    assert tm.idispnet.dtype == BF16 and tm.pointrcnn.dtype == BF16
    assert tm.pointrcnn.rpn.backbone.sa1.mlp_scale0.dtype == BF16
    assert tm.pointrcnn.rcnn.dtype == BF16 and tm.pointrcnn.anchor.dtype == BF16
    x = jnp.zeros((1, 32, 32, 3))
    pv = draw_variables(jpsm.PSMNet(maxdisp=16, mindisp=-16, dtype=jnp.bfloat16), x, x, seed=3,
                        train=False)
    args = tuple(jnp.asarray(a) for a in _instances())
    rv = draw_variables(jpr.PointRCNN(npoints=N, sa_npoints=SA_NPOINTS, proposals_per_roi=POST,
                                      dtype=jnp.bfloat16), *args, seed=4, train=False)
    v = {coll: {"idispnet": pv[coll], "pointrcnn": rv[coll]} for coll in pv}
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(v)} == {np.dtype("float32")}
    sd = state_dict_from_jax(tm, v)
    assert {t_.dtype for t_ in sd.values() if t_.is_floating_point()} == {torch.float32}
    tm.load_state_dict(sd, strict=True)
    f32 = load_jax_variables(tpr.PointRCNN(npoints=N, sa_npoints=SA_NPOINTS,
                                           proposals_per_roi=POST), rv)
    want = f32.state_dict()
    for k, t_ in tm.pointrcnn.state_dict().items():
        assert torch.equal(t_, want[k]), k
    for k, t_ in load_jax_variables(PSMNet(16, -16), pv).state_dict().items():
        assert torch.equal(tm.idispnet.state_dict()[k], t_), k
    with caplog.at_level(logging.INFO, logger="disprcnn_tpu_torch.models.build"):
        trained = tbuild.build_detection_model(cfg, device="meta", train=True)
    assert trained.pointrcnn.dtype == BF16 and "ROADMAP A8" not in caplog.text
    tm.pointrcnn.train()
    with pytest.raises(ValueError, match="gt_boxes3d"):
        tm.pointrcnn(*(t(a) for a in _instances()))
