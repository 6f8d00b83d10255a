"""The pieces of the port's train entry points against the JAX package on
the CPU: the Adam optimizer against optax, the ROI datasets and their
collate, the dataset containers and resolve_many, the train batch
converter, the checkpoint alignment and the stage handoff, the
Checkpointer, the MetricLogger and the TensorBoard writer.

Tolerances:
- Adam: parameters and both moments after each of 6 updates within 4
  float32 ulps of the tensor's scale, |diff| <= 4 * eps32 * max |optax
  tensor| (the scalars 1 - b^n and the rate are float32 on both sides;
  the powers may round differently by an ulp, and an entry that crosses
  0 keeps the rounding of its larger past);
- everything else exactly: the datasets, the converter and the alignment
  are the same arithmetic on the same arrays, the logger's text and the
  event file's bytes are equal.
"""
import os
import types

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from disprcnn_tpu.config import get_default_cfg as jax_default_cfg
from disprcnn_tpu.data import catalog as jcatalog
from disprcnn_tpu.data.datasets import concat as jconcat
from disprcnn_tpu.data.datasets import kitti_roi as jroi
from disprcnn_tpu.engine import batching as jbatching
from disprcnn_tpu.solver import build as jbuild
from disprcnn_tpu.solver import schedules as jsched
from disprcnn_tpu.utils import checkpoint as jckpt
from disprcnn_tpu.utils import logging as jlogging
from disprcnn_tpu.utils import tb as jtb
from disprcnn_tpu_torch.config import get_default_cfg
from disprcnn_tpu_torch.data import catalog
from disprcnn_tpu_torch.data.datasets import concat, kitti_roi
from disprcnn_tpu_torch.data.loader import StereoBatchLoader
from disprcnn_tpu_torch.engine import batching
from disprcnn_tpu_torch.models.detector.disprcnn3d import DispRCNN3D
from disprcnn_tpu_torch.solver import build as tbuild
from disprcnn_tpu_torch.solver import schedules as tsched
from disprcnn_tpu_torch.utils import checkpoint as tckpt
from disprcnn_tpu_torch.utils import logging as tlogging
from disprcnn_tpu_torch.utils import tb as ttb
from disprcnn_tpu_torch.utils.weights import init_random_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- Adam against optax ------------------------------------------------------

class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.enc = nn.Linear(3, 4)
        self.head = nn.Linear(4, 2)
        self.norm = nn.BatchNorm1d(2)


_JAX_LEAF = {"weight": "kernel", "bias": "bias"}


def _jax_name(name):
    mod, leaf = name.split(".")
    return mod, ("scale" if mod == "norm" and leaf == "weight" else _JAX_LEAF[leaf])


def _to_torch(a):
    a = np.asarray(a)
    return a.T if a.ndim == 2 else a


def _adam_states(state):
    """optax's ScaleByAdamState inside make_optimizer's chain."""
    found = []

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.append(node)
        elif hasattr(node, "inner_state"):
            walk(node.inner_state)
        elif isinstance(node, (tuple, list)):
            for sub in node:
                walk(sub)
        elif isinstance(node, dict):
            for sub in node.values():
                walk(sub)
    walk(state)
    assert len(found) == 1, found
    return found[0]


def _ulps_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= 4 * EPS32 * np.abs(want).max(), (what, err / np.abs(want).max() / EPS32)


@pytest.mark.parametrize("cycled", [False, True], ids=["b1_0.9", "b1_one_cycle"])
def test_adam_matches_optax(cycled):
    """Six Adam updates with the JAX package's groups: WEIGHT_DECAY on the
    weights, WEIGHT_DECAY_BIAS on the biases (BN's shift too), twice the
    rate on the biases, OneCycle rate (and b1, when cycled) over 8 steps,
    `enc` frozen: every parameter and both moments of each."""
    rng = np.random.default_rng(11)
    jparams = {"enc": {"kernel": normal(rng, 3, 4), "bias": normal(rng, 4)},
               "head": {"kernel": normal(rng, 4, 2), "bias": normal(rng, 2)},
               "norm": {"scale": normal(rng, 2), "bias": normal(rng, 2)}}
    model = _Tiny()
    with torch.no_grad():
        for n, p in model.named_parameters():
            mod, leaf = _jax_name(n)
            p.copy_(torch.from_numpy(np.ascontiguousarray(_to_torch(jparams[mod][leaf]))))
    solver = dict(OPTIMIZER="Adam", MOMENTUM=0.5, WEIGHT_DECAY=1e-2, WEIGHT_DECAY_BIAS=3e-3,
                  BIAS_LR_FACTOR=2.0)
    cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(**solver))
    frozen = ("enc",)
    tx = jbuild.make_optimizer(cfg, jparams, jsched.one_cycle(0.05, 8), frozen,
                               momentum_schedule=jsched.one_cycle_momentum(8) if cycled else None)
    # the schedules' values as JAX's float32 computes them (the port's own
    # schedules are held to JAX's in tests/test_torch_train.py, rtol 1e-6; an
    # ulp of b1 is 9 ulps of 1 - b1)
    lr, mom = jsched.one_cycle(0.05, 8), jsched.one_cycle_momentum(8)
    opt = tbuild.make_optimizer(model, lambda c: float(lr(c)),
                                (lambda c: float(mom(c))) if cycled else None, frozen,
                                momentum=0.5, weight_decay=1e-2, weight_decay_bias=3e-3,
                                bias_lr_factor=2.0, optimizer="Adam")
    assert isinstance(opt, tbuild.Adam)
    assert not model.enc.weight.requires_grad and model.head.weight.requires_grad
    state, jp = tx.init(jparams), jparams
    moments = {id(p): (k, i) for k, ps in opt.groups.items() for i, p in enumerate(ps)}
    for _ in range(6):
        g = jax.tree_util.tree_map(lambda a: normal(rng, *a.shape), jp)
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in model.named_parameters():
            mod, leaf = _jax_name(n)
            p.grad = torch.from_numpy(np.ascontiguousarray(_to_torch(g[mod][leaf])))
        opt.step()
        adam = _adam_states(state)
        for n, p in model.named_parameters():
            mod, leaf = _jax_name(n)
            _ulps_close(p.detach().numpy(), _to_torch(jp[mod][leaf]), n)
            if p.requires_grad:
                k, i = moments[id(p)]
                _ulps_close(opt.mu[k][i].numpy(), _to_torch(adam.mu[mod][leaf]), f"mu {n}")
                _ulps_close(opt.nu[k][i].numpy(), _to_torch(adam.nu[mod][leaf]), f"nu {n}")
    assert opt.count == 6


def test_make_optimizer_names():
    model = _Tiny()
    for name in ("SGD", "Adam"):
        assert tbuild.make_optimizer(model, tsched.constant(0.1), optimizer=name).count == 0
    cfg = types.SimpleNamespace(SOLVER=types.SimpleNamespace(
        OPTIMIZER="RMSProp", WEIGHT_DECAY=0.0, WEIGHT_DECAY_BIAS=0.0, BIAS_LR_FACTOR=1.0))
    with pytest.raises(NotImplementedError):
        jbuild.make_optimizer(cfg, {"w": np.zeros(2)}, jsched.constant(0.1))
    with pytest.raises(NotImplementedError):
        tbuild.make_optimizer(model, tsched.constant(0.1), optimizer="RMSProp")


# -- datasets ----------------------------------------------------------------

def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_samples_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_roi_datasets_and_collate_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    for split, n in (("train", 3), ("val", 2)):
        os.makedirs(tmp_path / split)
        for i in range(n):
            np.savez(tmp_path / split / f"{i:06d}.npz",
                     left=rng.integers(0, 255, (16, 16, 3)).astype(np.uint8) / 255.0,
                     right=rng.uniform(0, 1, (16, 16, 3)).astype(np.float32),
                     disparity=rng.uniform(-8, 8, (16, 16)),
                     mask=rng.uniform(size=(16, 16)) > 0.5)
    for split in ("train", "val"):
        for normalize in (True, False):
            got = kitti_roi.KittiRoiDataset(str(tmp_path), split, normalize)
            want = jroi.KittiRoiDataset(str(tmp_path), split, normalize)
            assert len(got) == len(want) > 0
            for i in range(len(want)):
                _assert_samples_equal(got[i], want[i])
            _assert_samples_equal(kitti_roi.collate_roi([got[i] for i in range(len(got))]),
                                  jroi.collate_roi([want[i] for i in range(len(want))]))
    got, want = kitti_roi.SyntheticRoiDataset(5, 32, 16, seed=3), jroi.SyntheticRoiDataset(
        5, 32, 16, seed=3)
    assert len(got) == len(want) == 5
    for i in range(5):
        _assert_samples_equal(got[i], want[i])
    _assert_samples_equal(kitti_roi.collate_roi([got[i] for i in (4, 0, 2)]),
                          jroi.collate_roi([want[i] for i in (4, 0, 2)]))


def test_concat_list_and_resolve_many_match_jax():
    samples = [{"x": np.full(2, i, np.float32)} for i in range(7)]
    double = lambda s: {"x": s["x"] * 2}
    parts = [(samples[:3], None), (samples[3:4], double), (samples[4:], None)]
    got = concat.ConcatDataset([concat.ListDataset(s, t) for s, t in parts])
    want = jconcat.ConcatDataset([jconcat.ListDataset(s, t) for s, t in parts])
    assert len(got) == len(want) == 7 and got.cumulative_sizes == want.cumulative_sizes
    for i in range(-7, 7):
        assert got.get_idxs(i % 7) == want.get_idxs(i % 7)
        _assert_samples_equal(got[i], want[i])
    with pytest.raises(AssertionError):
        concat.ConcatDataset([])
    cfg, jcfg = get_default_cfg(), jax_default_cfg()
    for c in (cfg, jcfg):
        c.merge_from_list(["TPU.MAX_GT", "4"])
    for names in (["synthetic_2"], ["synthetic_2", "synthetic3d_3"]):
        got = catalog.resolve_many(names, cfg, training=True)
        want = jcatalog.resolve_many(names, jcfg, training=True)
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want)
        for i in range(len(want)):
            _assert_samples_equal(got[i], want[i])


# -- the train batch converter -------------------------------------------------

TINY_3D = ["TPU.MAX_DETECTIONS", "4", "TPU.MAX_GT", "4", "TPU.ROI_CROP_SIZE", "32",
           "INPUT.DO_RESIZE", "False"]


@pytest.mark.parametrize("config", ["mask", "idispnet", "rpn", "rcnn"])
def test_train_converter_matches_jax(config):
    """convert(batch, train=True) and the static kwargs of both packages on
    one loader batch: the same keys, the same values, dtypes where the port
    keeps them (floats become float32 in both)."""
    path = os.path.join(REPO, "configs/kitti/car/vob", f"{config}.yaml")
    cfg, jcfg = get_default_cfg(), jax_default_cfg()
    for c in (cfg, jcfg):
        c.merge_from_file(path)
        c.merge_from_list(TINY_3D)
        c.freeze()
    name = "synthetic_2" if config == "mask" else "synthetic3d_2"
    batch = next(iter(StereoBatchLoader(catalog.resolve(name, cfg, training=True), 2,
                                        (96, 320), shuffle=False)))
    convert, static = batching.make_batch_converter(cfg, "cpu")
    jconvert, jstatic = jbatching.make_batch_converter(jcfg)
    assert static == jstatic
    for train in (True, False):
        got, want = convert(batch, train), jconvert(batch, train)
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        flat = {}
        for k, v in want.items():
            if k == "dets":
                flat.update({f"dets.{f}": getattr(v, f) for f in ("left", "right", "score",
                                                                   "valid")})
                flat.update({f"dets.{f}": v.fields[f] for f in v.fields})
            elif k == "calib":
                flat.update({f"calib.{c}": x for c, x in v.items()})
            else:
                flat[k] = v
        for k, w in flat.items():
            head, _, tail = k.partition(".")
            g = got[head]
            if head == "dets":
                g = getattr(g, tail) if tail in ("left", "right", "score", "valid") \
                    else g.fields[tail]
            elif head == "calib":
                g = g[tail]
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
            assert g.numpy().dtype == np.asarray(w).dtype, (k, g.dtype, np.asarray(w).dtype)
    if config != "mask":
        assert set(convert(batch, True)) - set(convert(batch, False)) == {
            "gt_disp", "gt_left", "gt_boxes3d", "gt_valid"}


# -- checkpoints ---------------------------------------------------------------

def test_align_and_update_params_matches_jax():
    """The longest dotted-suffix alignment on the same flat dicts: a prefix
    added and one taken away, two sources of equal suffix length (the
    first wins), an exact key beside a longer one that ends with it (a
    tie too), a shape mismatch left unmatched, and keys with no match."""
    rng = np.random.default_rng(13)
    a = lambda *s: normal(rng, *s)
    target = {"backbone.conv1.weight": a(4, 3), "backbone.conv1.bias": a(4),
              "module.head.fc.weight": a(2, 4), "x.weight": a(3), "cls.weight": a(5),
              "box.weight": a(2, 2), "alone.bias": a(1), "deep.stack.bn.running_mean": a(6)}
    source = {"model.backbone.conv1.weight": a(4, 3), "backbone.conv1.bias": a(4),
              "head.fc.weight": a(2, 4), "a.x.weight": a(3), "b.x.weight": a(3),
              "cls.weight": a(5), "z.cls.weight": a(5), "box.weight": a(3, 2),
              "stack.bn.running_mean": a(6), "bn.running_mean": a(6)}
    got, unmatched = tckpt.align_and_update_params(target, source)
    want, junmatched = jckpt.align_and_update_params(target, source)
    want = jckpt._flatten(want)
    assert unmatched == junmatched == ["box.weight", "alone.bias"]
    assert list(got) == list(target) and sorted(want) == sorted(target)
    for k in target:
        assert got[k] is want[k], k
    assert got["x.weight"] is source["a.x.weight"] and got["cls.weight"] is source["cls.weight"]
    assert got["deep.stack.bn.running_mean"] is source["stack.bn.running_mean"]


TINY_PSM = dict(max_det=2, roi_size=32, maxdisp=16, mindisp=-16, psm_hourglass=1)
TINY_PC = dict(TINY_PSM, npoints=128, sa_npoints=(128, 64, 32, 16), proposals_per_roi=8)


def _model(det3d_on, seed):
    kw = TINY_PC if det3d_on else TINY_PSM
    m = DispRCNN3D(**kw, det3d_on=det3d_on, rcnn_enabled=det3d_on, device="cpu")
    return init_random_(m, torch.Generator().manual_seed(seed))


def test_stage_handoff_fills_idispnet_and_keeps_pointrcnn(tmp_path):
    """Stage 2's DispRCNN3D (det3d_on False) saved by the Checkpointer, then
    loaded into stage 3's (det3d_on True): every idispnet.* entry, BN
    statistics included, bit-equal to the saved one; every pointrcnn.*
    entry at its init and reported unmatched; the same choice as the JAX
    package's alignment on the same keys."""
    stage2, stage3 = _model(False, 1), _model(True, 2)
    before = {k: v.clone() for k, v in stage3.state_dict().items()}
    ckpt = tckpt.Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(7, stage2)
    unmatched = tckpt.load_stage_weights(stage3, str(tmp_path / "ckpt"))
    saved, after = stage2.state_dict(), stage3.state_dict()
    assert sorted(unmatched) == sorted(k for k in after if k.startswith("pointrcnn."))
    for k, v in after.items():
        want = saved[k] if k.startswith("idispnet.") else before[k]
        assert v.dtype == want.dtype and torch.equal(v, want), k
    assert any("running_var" in k for k in saved)
    flat_t = {k: v.numpy() for k, v in before.items()}
    flat_s = {k: v.numpy() for k, v in saved.items()}
    jwant, junmatched = jckpt.align_and_update_params(flat_t, flat_s)
    assert junmatched == unmatched
    jwant = jckpt._flatten(jwant)
    for k, v in after.items():
        np.testing.assert_array_equal(v.numpy(), jwant[k], err_msg=k)
    # the file itself names the same state, and loading it is bit-equal
    fresh = _model(True, 3)
    assert tckpt.load_stage_weights(fresh, ckpt.path(7)) == unmatched
    assert all(torch.equal(fresh.state_dict()[k], saved[k]) for k in saved)


def test_checkpointer_roundtrip_keep_and_optimizer(tmp_path):
    model = _Tiny()
    opt = tbuild.make_optimizer(model, tsched.constant(0.01), optimizer="Adam")
    ckpt = tckpt.Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ckpt.latest_step() is None and ckpt.load(_Tiny(), None) == 0
    gen = torch.Generator().manual_seed(0)
    for step in (2, 4, 6):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
        ckpt.save(step, model, opt)
    assert ckpt.steps() == [4, 6] and ckpt.latest_step() == 6
    with open(tmp_path / "ck" / "last_checkpoint") as f:
        assert f.read() == "6"
    new = _Tiny()
    new_opt = tbuild.make_optimizer(new, tsched.constant(0.01), optimizer="Adam")
    assert ckpt.load(new, new_opt) == 6
    for (k, v), w in zip(new.state_dict().items(), model.state_dict().values()):
        assert torch.equal(v, w), k
    assert new_opt.count == 3
    for key in ("mu", "nu"):
        for k in opt.groups:
            for a, b in zip(getattr(new_opt, key)[k], getattr(opt, key)[k]):
                assert torch.equal(a, b)
    # SOLVER.LOAD_OPTIMIZER False: a fresh optimizer, the saved step all the same
    fresh_opt = tbuild.make_optimizer(_Tiny(), tsched.constant(0.01), optimizer="Adam")
    other = _Tiny()
    assert ckpt.load(other, fresh_opt, load_optimizer=False) == 6
    assert fresh_opt.count == 0 and all(
        not t.any() for ts in fresh_opt.mu.values() for t in ts)
    assert ckpt.load(other, None, step=4) == 4
    # SGD's state too
    sgd = tbuild.make_optimizer(model, tsched.constant(0.01), momentum=0.9)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    sgd.step()
    ckpt.save(8, model, sgd)
    sgd2 = tbuild.make_optimizer(new, tsched.constant(0.01), momentum=0.9)
    assert ckpt.load(new, sgd2) == 8 and sgd2.count == 1
    p0 = next(iter(model.parameters()))
    q0 = next(iter(new.parameters()))
    assert torch.equal(sgd2.sgd.state[q0]["momentum_buffer"],
                       sgd.sgd.state[p0]["momentum_buffer"])


def test_stage_weights_refuse_reference_layouts_and_missing(tmp_path, monkeypatch):
    model = _Tiny()
    for name in ("model.pth", "model.tar", "R-50.pkl"):
        (tmp_path / name).write_bytes(b"")  # read as the reference's layouts: empty, refused
        with pytest.raises(EOFError):
            tckpt.load_stage_weights(model, str(tmp_path / name))
    with pytest.raises(FileNotFoundError):
        tckpt.load_stage_weights(model, str(tmp_path / "absent"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tckpt.load_stage_weights(model, str(tmp_path / "empty"))
    monkeypatch.setenv("DISPRCNN_WEIGHTS", str(tmp_path))
    for weight in ("catalog://ImageNetPretrained/MSRA/R-50", "https://x.org/a/model.pth"):
        assert tckpt.resolve_weight(weight) == jckpt.resolve_weight(weight)
    with pytest.raises(FileNotFoundError):
        tckpt.resolve_weight("catalog://ImageNetPretrained/MSRA/R-152")
    with pytest.raises(EOFError):  # resolves to the empty R-50.pkl above
        tckpt.load_stage_weights(model, "catalog://ImageNetPretrained/MSRA/R-50")
    assert tckpt.resolve_weight("some/dir") == "some/dir"


# -- logging ---------------------------------------------------------------------

def test_metric_logger_matches_jax():
    got, want = tlogging.MetricLogger(), jlogging.MetricLogger(delimiter="  ")
    rng = np.random.default_rng(14)
    for _ in range(27):  # past the window of 20
        vals = {"loss_a": float(rng.uniform(0, 5)), "lr": float(rng.uniform(0, 1e-2)),
                "skipped": float(rng.integers(0, 2))}
        got.update(**vals)
        want.update(**vals)
    assert str(got) == str(want) and "loss_a: " in str(got)
    s, js = tlogging.SmoothedValue(), jlogging.SmoothedValue()
    for v in (3.0, 1.0, 2.0):
        s.update(v)
        js.update(v)
    assert (s.median, s.avg, s.global_avg) == (js.median, js.avg, js.global_avg) == (2.0, 2.0,
                                                                                      2.0)


def test_summary_writer_bytes_match_jax(tmp_path, monkeypatch):
    files = []
    for mod, sub in ((ttb, "port"), (jtb, "jax")):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
        w = mod.SummaryWriter(str(tmp_path / sub))
        w.add_scalars({"loss_total": 1.5, "lr": 0.01, "batch_time": 0.25}, 0)
        w.add_scalar("loss_total", float("nan"), 20)
        w.add_scalars({"loss_total": 0.75}, 40)
        w.close()
        w.add_scalars({"loss_total": 9.0}, 60)  # closed: dropped
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    with open(files[0], "rb") as f, open(files[1], "rb") as g:
        assert f.read() == g.read()
    read = jtb.read_scalars(files[0])
    assert [s for s, _ in read] == [0, 20, 40] and read[0][1]["lr"] == np.float32(0.01)
    assert np.isnan(read[1][1]["loss_total"]) and ttb.read_scalars(files[1])[2] == read[2]


# -- the train CLIs' settings ---------------------------------------------------

def test_train_clis_need_the_card_unless_told(tmp_path):
    """Both CLIs run on the card by default: without one they raise and do
    not carry on on the CPU. (SOLVER.UNCERT_LOSS_WEIGHT trains:
    test_torch_train_entry_uncert.py.)"""
    from disprcnn_tpu_torch.tools import train_idispnet, train_net
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    path = os.path.join(REPO, "configs/kitti/car/vob/idispnet.yaml")
    out = ["OUTPUT_DIR", str(tmp_path / "o")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net.run(["--config-file", path, "--max-iter", "1"] + out)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_idispnet.run(["--synthetic", "2", "--epochs", "1", "--output",
                            str(tmp_path / "p")])
    assert not os.path.exists(tmp_path / "o" / "ckpt")
