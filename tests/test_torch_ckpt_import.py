"""utils/torch_import.py and utils/checkpoint.py::load_stage_weights on the
reference's released layouts, held to the JAX package's importer.

tests/torch_ckpt_writer.py writes the layouts (the 2D detector's ``.pth``,
a Detectron ``.pkl``, PSMNet's bestmodel ``.tar``, ``pointrcnn.pth``, the
full 3D stage) from a port model filled with numpy-drawn JAX variables
(seed 2). The targets hold other variables (seed 1). Three things are held:

(i) JAX's ``import_*`` of each file, aligned by JAX's
    ``align_and_update_params`` on the JAX model's variables, leaves no
    variable unmatched (the writer's names against JAX's own regexes);
(ii) the port's ``load_stage_weights`` gives a state_dict ``torch.equal``
    to ``state_dict_from_jax`` of JAX's ``load_stage_weights`` on the
    same file;
(iii) both leave the same entries unmatched, by name, on partial and
    padded files too.

Small models only and no forward: R-50 with a narrow FPN, PSMNet,
PointRCNN and DispRCNN3D.
"""
import copy
import functools

import numpy as np
import pytest
import torch
from torch import nn

from disprcnn_tpu.utils import checkpoint as jckpt
from disprcnn_tpu.utils import torch_import as jti
from disprcnn_tpu_torch.models.detector.disprcnn import DispRCNN
from disprcnn_tpu_torch.models.backbone.resnet import FrozenBatchNorm, Stem
from disprcnn_tpu_torch.models.detector.disprcnn3d import DispRCNN3D
from disprcnn_tpu_torch.models.pointrcnn.point_rcnn import PointRCNN
from disprcnn_tpu_torch.models.psmnet.psmnet import PSMNet
from disprcnn_tpu_torch.utils import torch_import as ti
from disprcnn_tpu_torch.utils.checkpoint import load_stage_weights
from disprcnn_tpu_torch.utils.weights import _convert, init_random_, state_dict_from_jax
import torch_ckpt_writer as W
from torch_port_helpers import TINY
from torch_train_helpers import torch_one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SA_NPOINTS = (128, 64, 32, 16)
PORT = {
    "2d": lambda: DispRCNN(**TINY, device="cpu"),
    "psm": lambda: PSMNet(maxdisp=16, mindisp=-16),
    "pr": lambda: PointRCNN(npoints=128, sa_npoints=SA_NPOINTS),
    "3d": lambda: DispRCNN3D(max_det=4, roi_size=32, maxdisp=16, mindisp=-16, npoints=128,
                             sa_npoints=SA_NPOINTS, det3d_on=True, device="cpu"),
}


def _jax_tree(model, sd):
    """The JAX variables of which `sd` is ``state_dict_from_jax(model, .)``:
    its inverse, key by key (checked by a round trip in
    test_jax_trees_round_trip). The JAX model's variable names are the
    ones ``state_dict_from_jax`` maps one to one onto the port's entries
    (tests/test_torch_weights.py and the slices' parity tests load the JAX
    models' own trees through it), so no JAX model is traced here."""
    tree = {}
    for key, val in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        owner, leaf = key.rsplit(".", 1)
        parent, name = owner.rsplit(".", 1) if "." in owner else ("", owner)
        mod, arr = model.get_submodule(owner), val.numpy()
        if isinstance(mod, FrozenBatchNorm):
            holder = model.get_submodule(parent)
            order = ["bn1"] if isinstance(holder, Stem) else (
                (["downsample_bn"] if holder.downsample_bn is not None else [])
                + ["bn1", "bn2", "bn3"])
            coll, path = "frozen", f"{parent}.FrozenBatchNorm_{order.index(name)}.{_BN[leaf]}"
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            coll = "batch_stats" if leaf.startswith("running") else "params"
            path = f"{owner}.{_BN[leaf]}"
        elif leaf == "bias":
            coll, path = "params", key
        else:
            coll, path = "params", f"{owner}.kernel"
            if isinstance(mod, nn.ConvTranspose3d):
                arr = arr.transpose(2, 3, 4, 0, 1)[::-1, ::-1, ::-1]
            elif isinstance(mod, nn.ConvTranspose2d):
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                arr = arr.transpose(*range(2, arr.ndim), 1, 0)
            else:
                arr = arr.T
        node = tree.setdefault(coll, {})
        *dirs, last = path.split(".")
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = np.ascontiguousarray(arr)
    return tree


_BN = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def _drawn(kind, seed):
    return init_random_(PORT[kind](), torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def templates():
    """A port model of each kind, never changed (state_dict_from_jax's)."""
    return {kind: build() for kind, build in PORT.items()}


@pytest.fixture(scope="module")
def targets(templates):
    """{kind: JAX variables drawn from seed 1}."""
    return {kind: _jax_tree(m, _drawn(kind, 10 + i).state_dict())
            for i, (kind, m) in enumerate(templates.items())}


@pytest.fixture(scope="module")
def target_sds(templates, targets):
    return {kind: state_dict_from_jax(m, targets[kind]) for kind, m in templates.items()}


@pytest.fixture(scope="module")
def sources():
    """{kind: the state_dict of a port model drawn from seed 2}."""
    return {kind: _drawn(kind, 20 + i).state_dict() for i, kind in enumerate(PORT)}


@pytest.fixture(scope="module")
def files(sources, tmp_path_factory):
    """Each released layout, and the partial and padded variants, on disk."""
    d = tmp_path_factory.mktemp("released")
    p = lambda name: str(d / name)
    ref2d = W.reference_2d(sources["2d"])
    psm = W.ddp(W.reference_psmnet(sources["psm"]))
    pr = W.ddp(W.reference_pointrcnn(sources["pr"]))
    full = W.reference_disprcnn3d(sources["3d"])
    anchors = {f"rpn.anchor_generator.cell_anchors.{i}": torch.randn(3, 4) for i in range(5)}
    return {
        # the released layouts, each as the reference saves it
        "2d": W.write_pth(p("mrcnn.pth"), ref2d, optimizer={"state": {}}, iteration=5),
        "pkl": W.write_pkl(p("R-50.pkl"), {**W.c2_blobs(sources["2d"]),
                                           "pred_w": np.ones((3, 4), np.float32),
                                           "res2_0_branch2a_b_momentum": np.ones(2)}),
        "psm": W.write_pth(p("bestmodel.tar"), psm, wrapper="state_dict", epoch=3,
                           train_loss=0.5),
        "pr": W.write_pth(p("pointrcnn.pth"), pr, optimizer_state={"lr": 1.0}, it=9),
        "3d": W.write_pth(p("full.pth"), W.ddp(full)),
        # partial and padded files
        # no mask head; anchor buffers and an optimizer's state beside the
        # weights, under model_state
        "2d_partial": W.write_pth(p("partial.pth"), {
            **{k: v for k, v in ref2d.items() if not k.startswith("roi_heads.mask")},
            **anchors}, wrapper="model_state", optimizer={"param_groups": []}),
        "psm_bare": W.write_pth(p("bare.tar"), psm, wrapper=None),  # the dict itself
        "3d_inner_module": W.write_pth(p("inner.pth"), {
            k.replace(".", ".module.", 1): v for k, v in full.items()}),
    }


# (file, target model, the target's entries the file leaves unmatched):
# the layouts into their own models, a backbone .pkl, and files that fill
# part of a larger model
CASES = [("2d", "2d", ()), ("pkl", "2d", ("rpn_head.", "box_", "mask_head.")),
         ("psm", "psm", ()), ("pr", "pr", ()), ("3d", "3d", ()),
         ("2d_partial", "2d", ("mask_head.",)), ("psm_bare", "psm", ()),
         ("psm", "3d", ("pointrcnn.",)), ("pr", "3d", ("idispnet.",)),
         ("3d_inner_module", "3d", ())]


@functools.lru_cache(maxsize=None)
def _jax_sources(path):
    """JAX's import of `path` as its load_stage_weights sniffs it, by
    collection."""
    if path.endswith(".pkl"):
        p, f = jti.import_c2_backbone(path)
        return {"params": p, "frozen": f}
    sd = jti.load_torch_state_dict(path)
    if any(k.startswith(("dispnet.", "pcnet.")) for k in sd):
        p, s = jti.import_disprcnn3d(sd)
    elif any("backbone_net" in k for k in sd):
        p, s = jti.import_pointrcnn(sd)
    elif any(k.startswith("feature_extraction") for k in sd):
        p, s = jti.import_psmnet(sd)
    else:
        p, f = jti.import_disprcnn2d(path)
        return {"params": p, "frozen": f}
    return {"params": p, "batch_stats": s}


def _jax_unmatched(model, variables, path):
    """Every JAX variable that JAX's alignment leaves unmatched, as the
    port's state_dict key."""
    src = _jax_sources(path)
    out = set()
    for coll, tree in variables.items():
        _, missed = jckpt.align_and_update_params(tree, src.get(coll, {}))
        for name in missed:
            arr = np.asarray(jckpt._flatten(tree)[name])
            out.add(_convert(model, name.replace(".", "/"), arr, coll)[0])
    return out


@pytest.mark.parametrize("name", ["2d", "pkl", "psm", "pr", "3d"])
def test_jax_import_of_written_layout_leaves_nothing_unmatched(name, files, targets):
    kind = {"pkl": "2d"}.get(name, name)
    src = _jax_sources(files[name])
    missed = {c: jckpt.align_and_update_params(tree, src.get(c, {}))[1]
              for c, tree in targets[kind].items()}
    if name == "pkl":  # a backbone file: only the heads are left
        missed = {c: [m for m in v if m.startswith("backbone.")] for c, v in missed.items()}
    assert missed == {c: [] for c in targets[kind]}, missed


@pytest.mark.parametrize("name,kind,left", CASES)
def test_load_stage_weights_matches_jax(name, kind, left, files, templates, targets,
                                        target_sds, sources):
    path = files[name]
    model = copy.deepcopy(templates[kind])
    model.load_state_dict(target_sds[kind])
    unmatched = load_stage_weights(model, path)

    want = state_dict_from_jax(templates[kind], jckpt.load_stage_weights(targets[kind], path))
    got = model.state_dict()
    assert set(got) == set(want)
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad[:5]
    assert set(unmatched) == _jax_unmatched(templates[kind], targets[kind], path)
    # what is left: exactly the entries the file has no counterpart of
    assert len(unmatched) == len(set(unmatched))
    assert set(unmatched) == {k for k in got if k.startswith(left) and left
                              and not k.endswith("num_batches_tracked")}
    if name == "pkl":  # the backbone's weights are the source's, its statistics made up
        for k, v in sources["2d"].items():
            if k.startswith("backbone."):
                w = (torch.zeros_like(v) if k.endswith("running_mean") else
                     torch.ones_like(v) if k.endswith("running_var") else v)
                assert torch.equal(got[k], w), k


def test_sniffs_layouts_in_jax_order(files):
    assert [ti.import_released(files[n])[0] for n in ("2d", "psm", "pr", "3d")] == [
        "disprcnn2d", "psmnet", "pointrcnn", "disprcnn3d"]
    # "module." goes wherever it stands; counters and non-tensors are dropped
    sd = ti.load_torch_state_dict(files["3d_inner_module"])
    assert not any("module." in k for k in sd)
    assert set(sd) == set(ti.load_torch_state_dict(files["3d"]))
    assert not any(k.endswith("num_batches_tracked") for k in ti.import_released(files["3d"])[1])


@pytest.mark.parametrize("kind", list(PORT))
def test_jax_trees_round_trip(kind, targets):
    model = PORT[kind]()
    sd = state_dict_from_jax(model, targets[kind])  # raises on a stray or missing name
    assert _jax_tree(model, sd).keys() == targets[kind].keys()
    for coll, tree in targets[kind].items():
        flat = jckpt._flatten(_jax_tree(model, sd)[coll])
        assert flat.keys() == jckpt._flatten(tree).keys()
        assert all(np.array_equal(flat[k], v) for k, v in jckpt._flatten(tree).items())


def test_c2_and_conv_key_renames_match_jax():
    for k in ("conv1_w", "res_conv1_bn_s", "conv1_bn_b", "res3_4_branch2b_w",
              "res5_2_branch1_bn_s", "res4_22_branch2c_bn_b", "fpn_inner_res5_2_sum_w",
              "fpn_inner_res2_2_sum_lateral_b", "fpn_res4_22_sum_w", "fc1000_w", "pred_b",
              "res2_0_branch2a_bn_riv", "res2_0_branch2a_w_momentum"):
        assert ti.rename_c2_resnet_key(k) == jti.rename_c2_resnet_key(k), k
    for s, n in ((0, 1), (1, 1), (2, 1), (2, 2), (3, 2)):
        assert ti._head_idx(s, n) == jti._head_idx(s, n)


def test_missing_released_files_raise(tmp_path):
    """A released suffix whose file is absent raises FileNotFoundError
    naming it (no NotImplementedError is left for these suffixes)."""
    for suffix in (".pth", ".tar", ".pkl"):
        with pytest.raises(FileNotFoundError, match=f"missing{suffix}"):
            load_stage_weights(PORT["psm"](), str(tmp_path / f"missing{suffix}"))
