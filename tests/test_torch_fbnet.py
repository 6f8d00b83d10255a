"""The port's FBNet bodies (disprcnn_tpu_torch/models/backbone/fbnet.py)
against the JAX package on the CPU.

- The builder's arithmetic (_get_divisible_by, unify_arch_def) and each of
  the five archs' stage depths (the port's stage_channels, without a
  forward, against the JAX FBNet's output shapes) and parameter count
  (against the JAX FBNet's params), exactly.
- FBNet at scale 0.25 on even and odd sides (66x130 and 65x131: Flax's
  SAME padding of a stride-2 conv differs between the two) for `default`
  (3x3 depthwise convs) and `cham_v1a` (5x5 and 7x7), with the depthwise
  BN and ReLU on and off: every stage's map to 1e-4 of max |JAX| + 1e-4,
  on numpy-drawn JAX variables loaded by state_dict_from_jax.
- FBNet-FPN (ResNetFPNBackbone with an FBNet body) likewise, and the
  stereo detector on an FBNet body in eval (detections: boxes 1e-3 px,
  scores 1e-5, labels and validity exact; masks 1e-5).
- The norms never train: a train step leaves the running statistics as
  they were and moves the scale and bias.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disprcnn_tpu.models.backbone import fbnet as jfb
from disprcnn_tpu.models.backbone.fpn import ResNetFPNBackbone as JBackbone
from disprcnn_tpu.models.detector import disprcnn as jdet
from disprcnn_tpu_torch.models.backbone import fbnet as tfb
from disprcnn_tpu_torch.models.backbone.fpn import ResNetFPNBackbone
from disprcnn_tpu_torch.models.detector import disprcnn as tdet
from disprcnn_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import IMG_HW, TINY, draw_variables, jax_variables
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ARCHS = sorted(tfb.MODEL_ARCH)


def t(x):
    return torch.from_numpy(np.array(x))


def image(seed, hw):
    return np.random.default_rng(seed).standard_normal((1, *hw, 3)).astype(np.float32)


def nchw(x):
    return t(x.transpose(0, 3, 1, 2))


def close_maps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-4)


def test_builder_arithmetic_matches_jax():
    for num in (0, 1, 7, 8, 9.5, 12, 15.9, 16, 23, 24.5, 100):
        for div in (0, 1, 3, 8):
            assert tfb._get_divisible_by(num, div, div) == jfb._get_divisible_by(num, div, div)
    for arch in ARCHS:
        assert tfb.unify_arch_def(tfb.MODEL_ARCH[arch]) == jfb.unify_arch_def(
            jfb.MODEL_ARCH[arch])
    assert tfb.MODEL_ARCH == jfb.MODEL_ARCH


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_channels_and_param_count_match_jax(arch):
    """stage_channels at scale 1 and at (0.5, divisor 8) against the JAX
    FBNet's output depths, and the parameter count at both."""
    x = jnp.zeros((1, 64, 64, 3))
    for scale, div in ((1.0, 1), (0.5, 8)):
        jm = jfb.FBNet(arch=arch, scale_factor=scale, width_divisor=div)
        shapes, v = jax.eval_shape(lambda: jm.init_with_output(jax.random.PRNGKey(0), x))
        assert tfb.stage_channels(arch, scale, div) == tuple(s.shape[-1] for s in shapes)
        n_jax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(v["params"]))
        tm = tfb.FBNet(arch, scale_factor=scale, width_divisor=div)
        assert sum(p.numel() for p in tm.parameters()) == n_jax


def test_same_pads_match_xla():
    """Flax's SAME padding is XLA's: (0, 1) for 3x3/2 on an even side, (1, 1)
    on an odd one; a strided conv's output size ceil(n / s)."""
    assert tfb.same_pads(66, 3, 2) == (0, 1) and tfb.same_pads(65, 3, 2) == (1, 1)
    assert tfb.same_pads(66, 7, 2) == (2, 3) and tfb.same_pads(10, 5, 1) == (2, 2)
    for n in range(5, 40):
        for k in (1, 3, 5, 7):
            lo, hi = tfb.same_pads(n, k, 2)
            assert (n + lo + hi - k) // 2 + 1 == -(-n // 2)


@pytest.mark.parametrize("arch, hw, skip", [
    ("default", (66, 130), True), ("default", (65, 131), False),
    ("cham_v1a", (66, 130), False), ("cham_v1a", (65, 131), True)])
def test_fbnet_matches_jax(arch, hw, skip):
    """Every stage's map; `skip` is DW_CONV_SKIP_BN/RELU (False: the
    depthwise conv has its own BN and ReLU)."""
    jm = jfb.FBNet(arch=arch, scale_factor=0.25, dw_skip_bn=skip, dw_skip_relu=skip)
    x = image(1, hw)
    v = draw_variables(jm, jnp.asarray(x), seed=2)
    assert set(v) == {"params", "batch_stats"}
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = load_jax_variables(tfb.FBNet(arch, scale_factor=0.25, dw_skip_bn=skip,
                                      dw_skip_relu=skip), v)
    with torch.no_grad():
        got = tm(nchw(x))
    close_maps(got, want)
    assert [g.shape[-2:] for g in got][0] == (-(-hw[0] // 2), -(-hw[1] // 2))


def test_fbnet_fpn_matches_jax():
    """FBNet-cham_v1a-FPN at scale 0.25: P2-P6 (the FPN's in-channels from
    stage_channels, P6 the max pool)."""
    jm = JBackbone(body="FBNet-cham_v1a", out_channels=16, fbnet_scale_factor=0.25)
    x = image(3, (65, 131))
    v = draw_variables(jm, jnp.asarray(x), seed=4)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    tm = load_jax_variables(ResNetFPNBackbone("FBNet-cham_v1a", 16, fbnet_scale_factor=0.25), v)
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == 5
    close_maps(got, want)


def test_fbnet_norms_keep_running_statistics_in_train():
    """In train mode the maps are eval's; after a train step the running
    statistics are bit-equal and the BN scales and biases have moved."""
    tm = tfb.FBNet("default", scale_factor=0.25)
    jm = jfb.FBNet(arch="default", scale_factor=0.25)
    x = image(5, (66, 130))
    load_jax_variables(tm, draw_variables(jm, jnp.asarray(x), seed=6))
    stats = {n: b.clone() for n, b in tm.named_buffers()}
    with torch.no_grad():
        eval_out = tm(nchw(x))
    tm.train()
    opt = torch.optim.SGD(tm.parameters(), lr=0.1)
    out = tm(nchw(x))
    for g, w in zip(out, eval_out):
        assert torch.equal(g.detach(), w)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    sum(o.square().mean() for o in out).backward()
    opt.step()
    for n, b in tm.named_buffers():
        assert torch.equal(b, stats[n]), n
    bn = [n for n in before if ".bn." in n]
    assert bn and all(not torch.equal(dict(tm.named_parameters())[n], before[n]) for n in bn)


@pytest.fixture(scope="module")
def fbnet_pair():
    """The small stereo detector on an FBNet body (scale 0.25) in both
    packages, on one set of numpy-drawn variables."""
    kw = dict(TINY, body="FBNet", fbnet_scale_factor=0.25)
    jm = jdet.DispRCNN(**kw)
    v = jax_variables(jm, seed=7)
    tm = load_jax_variables(tdet.DispRCNN(**kw, device="cpu"), v)
    return jm, v, tm


def test_fbnet_disprcnn_eval_matches_jax(fbnet_pair):
    jm, v, tm = fbnet_pair
    rng = np.random.default_rng(8)
    left, right = (rng.standard_normal((1, *IMG_HW, 3)).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda a, b: jm.apply(v, a, b, train=False))(jnp.asarray(left),
                                                                jnp.asarray(right))
    with torch.no_grad():
        got = tm(t(left), t(right))
    wd, gd = want["detections"], got["detections"]
    ok = np.asarray(wd.valid)
    np.testing.assert_array_equal(gd.valid.numpy(), ok)
    assert ok.any()
    np.testing.assert_allclose(gd.left.numpy()[ok], np.asarray(wd.left)[ok], rtol=0, atol=1e-3)
    np.testing.assert_allclose(gd.right.numpy()[ok], np.asarray(wd.right)[ok], rtol=0, atol=1e-3)
    np.testing.assert_allclose(gd.score.numpy()[ok], np.asarray(wd.score)[ok], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(gd.fields["labels"].numpy()[ok],
                                  np.asarray(wd.fields["labels"])[ok])
    np.testing.assert_allclose(got["masks"].numpy()[ok], np.asarray(want["masks"])[ok],
                               rtol=0, atol=1e-5)
