"""The port's config (disprcnn_tpu_torch/config) and model build
(disprcnn_tpu_torch/models/build.py) against the JAX package's.

Everything here is exact: the YAML reader's output equals yaml.safe_load's,
the merged trees equal the JAX package's CfgNode.to_dict() key for key and
value for value (PATHS_CATALOG names each package's own file), and every
hyperparameter the port's build passes equals the JAX module's field of
that name.
"""
import pathlib

import pytest
import torch
import yaml

from disprcnn_tpu.config import get_default_cfg as jax_default_cfg
from disprcnn_tpu.models import build as jbuild
from disprcnn_tpu_torch.config import get_default_cfg
from disprcnn_tpu_torch.config.node import load_yaml
from disprcnn_tpu_torch.engine.batching import make_batch_converter
from disprcnn_tpu_torch.models import build as tbuild
from disprcnn_tpu_torch.models.backbone.resnet import GroupNorm
from disprcnn_tpu_torch.models.pointrcnn import point_rcnn as tpoint_rcnn
from disprcnn_tpu_torch.models.pointrcnn import rcnn3d, rpn3d
from disprcnn_tpu_torch.tools import test_net, train_net

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))


def test_every_config_is_found():
    assert len(CONFIGS) == 20


@pytest.mark.parametrize("path", CONFIGS)
def test_reader_matches_pyyaml(path):
    text = (REPO / path).read_text()
    assert load_yaml(text, path) == yaml.safe_load(text)


SCALARS = ["1e-4", "1.0e-4", "1.5e+3", "1.e5", "1.0e5", "0.60", "-48", "+12", "0", "True",
           "False", "", "(600,)", "R-101-FPN", "models/kitti/%s/predictions",
           '"quoted # not a comment"', "'single'", "[[1.5, 1.6, 3.9]]",
           "[768, 512, 256, 64]", "[]", "[a, 'b c', 2.0]", "[1, 2,]", "1 # a comment", "a#b"]
# scalars that PyYAML reads as something other than a string, outside the
# subset, and quoted strings with escapes
OUTSIDE = ["010", "0x1F", "0b101", "1_000", "1:30", ".5", "-.inf", ".nan", "yes", "Off", "TRUE",
           "true", "~", "null", "'it''s'", '"a\\tb"', "[1, yes]"]


def test_reader_scalars_match_pyyaml():
    for s in SCALARS:
        text = f"KEY: {s}\n"
        assert load_yaml(text) == yaml.safe_load(text), s
    nested = "A:\n  B:\n    C: 1\n  D:\nE: 2  # c\n# whole-line comment\n\n"
    assert load_yaml(nested) == yaml.safe_load(nested)
    assert load_yaml("# nothing\n") is None and yaml.safe_load("# nothing\n") is None


@pytest.mark.parametrize("text", ["A:\n  - 1\n", "A: {b: 1}\n", "A: &x 1\n", "A: !!str 1\n",
                                  "A: |\n  text\n", "---\nA: 1\n", "A: b: c\n",
                                  "A:\n\tB: 1\n", "A: [1, 2\n", "A: 1\n   B: 2\n", 'A: "open\n']
                         + [f"A: {s}\n" for s in OUTSIDE])
def test_reader_raises_outside_the_subset(text):
    with pytest.raises(ValueError, match=r"<string>:\d"):
        load_yaml(text)


def _trees(path, opts=()):
    t, j = get_default_cfg(), jax_default_cfg()
    for cfg in (t, j):
        if path:
            cfg.merge_from_file(str(REPO / path))
        if opts:
            cfg.merge_from_list(list(opts))
    td, jd = t.to_dict(), j.to_dict()
    assert td.pop("PATHS_CATALOG").endswith("disprcnn_tpu_torch/config/catalog.py")
    assert jd.pop("PATHS_CATALOG").endswith("disprcnn_tpu/config/catalog.py")
    return td, jd


@pytest.mark.parametrize("path", [None] + CONFIGS)
def test_config_tree_matches_jax(path):
    td, jd = _trees(path)
    assert td == jd
    # equal values of equal types (1 == 1.0 == True in Python)
    flat = lambda d, p="": ([(p + k, type(v)) for k, v in d.items() if not isinstance(v, dict)]
                            + [x for k, v in d.items() if isinstance(v, dict)
                               for x in flat(v, p + k + ".")])
    assert flat(td) == flat(jd)


def test_merge_from_list_matches_jax():
    opts = ["SOLVER.BASE_LR", "1e-4", "INPUT.MIN_SIZE_TEST", "96", "INPUT.MIN_SIZE_TRAIN",
            "(600, 800)", "MODEL.POINTRCNN.RPN.SA_CONFIG.NPOINTS", "[128, 64, 32, 16]",
            "MODEL.MASK_ON", "True", "TPU.COMPUTE_DTYPE", "float32",
            "MODEL.ROI_BOX_HEAD.POOLER_SCALES", "(0.25,)", "SOLVER.WARMUP_FACTOR", "1",
            "DATASETS.TEST", "('synthetic_8',)", "MODEL.POINTRCNN.MEAN_SIZE", "[[1.0, 2.0, 3.0]]"]
    td, jd = _trees("configs/kitti/car/vob/rcnn.yaml", opts)
    assert td == jd
    assert td["SOLVER"]["BASE_LR"] == 1e-4 and td["INPUT"]["MIN_SIZE_TRAIN"] == (600, 800)
    for bad in (["SOLVER.NO_SUCH_KEY", "1"], ["SOLVER.BASE_LR", "abc"]):
        for cfg in (get_default_cfg(), jax_default_cfg()):
            with pytest.raises((AssertionError, TypeError)):
                cfg.merge_from_list(bad)
    # YAML 1.1's other booleans are outside the port's subset: they raise
    # rather than read as a string
    with pytest.raises(ValueError, match="<override>.*'true'"):
        get_default_cfg().merge_from_list(["MODEL.MASK_ON", "true"])


def _built(monkeypatch, path, opts=()):
    """The keyword arguments the port's build hands its constructor (built
    on the meta device), and the JAX build's module. path None is the bare
    default config."""
    cfg, jcfg = get_default_cfg(), jax_default_cfg()
    for c in (cfg, jcfg):
        if path:
            c.merge_from_file(str(REPO / path))
        c.merge_from_list(list(opts))
        c.freeze()
    seen = {}

    def recording(cls):
        def make(**kw):
            seen.update(kw)
            return cls(**kw)
        return make

    for name in ("DispRCNN", "DispRCNN3D", "GeneralizedRCNN", "RetinaNetDetector"):
        monkeypatch.setattr(tbuild, name, recording(getattr(tbuild, name)))
    model = tbuild.build_detection_model(cfg, device="meta")
    return model, seen, jbuild.build_detection_model(jcfg)


def _fields_match(model, kw, jmodel):
    """The port model is the JAX model's class, and every keyword argument
    the build passed equals the JAX module's field of that name."""
    assert type(model).__name__ == type(jmodel).__name__
    kw.pop("device")
    kw.pop("kernels_off", None)
    for name, value in kw.items():
        want = getattr(jmodel, name)
        if isinstance(want, tuple):
            value = tuple(value)
        assert value == want, (name, value, want)


@pytest.mark.parametrize("path", CONFIGS)
def test_built_model_matches_jax_fields(monkeypatch, path):
    model, kw, jmodel = _built(monkeypatch, path)
    _fields_match(model, kw, jmodel)
    if type(model).__name__ == "DispRCNN":
        assert (model.max_det, model.post_nms_top_n_test) == (32, 300)
    elif jmodel.det3d_on:
        prc = model.pointrcnn
        assert jmodel.rpn_nms_thresh_train == tpoint_rcnn.TRAIN_RPN_NMS_THRESH == 0.85
        # the port's rcnn_enabled stands for JAX's rpn_fixed too
        assert prc.rcnn_enabled == jmodel.rcnn_enabled == jmodel.rpn_fixed


UNSUPPORTED = [
    ("configs/kitti/car/vob/mask.yaml", ["MODEL.BACKBONE.FREEZE_CONV_BODY_AT", "3"],
     "FREEZE_CONV_BODY_AT", "A7"),
    ("configs/kitti/car/vob/mask.yaml", ["MODEL.META_ARCHITECTURE", "GeneralizedRCNN",
                                         "MODEL.STEREO_ON", "False",
                                         "MODEL.BACKBONE.FREEZE_CONV_BODY_AT", "1"],
     "FREEZE_CONV_BODY_AT", "A7"),
    ("configs/kitti/car/vob/mask.yaml", ["MODEL.RETINANET_ON", "True",
                                         "MODEL.BACKBONE.FREEZE_CONV_BODY_AT", "3"],
     "FREEZE_CONV_BODY_AT", "A7"),
    ("configs/kitti/car/vob/mask.yaml", ["MODEL.RPN.FG_IOU_THRESHOLD", "0.6"],
     "FG_IOU_THRESHOLD", "A7"),
    ("configs/kitti/car/vob/mask.yaml", ["MODEL.ROI_HEADS.POSITIVE_FRACTION", "0.5"],
     "POSITIVE_FRACTION", "A7"),
    ("configs/kitti/car/vob/mask.yaml", ["MODEL.RPN.STRADDLE_THRESH", "-1"], "STRADDLE",
     "A7"),
    ("configs/kitti/car/vob/rcnn.yaml", ["MODEL.POINTRCNN.RPN.FIXED", "False"], "FIXED",
     "A4.4"),
    ("configs/kitti/car/vob/rcnn.yaml", ["MODEL.POINTRCNN.AUG_DATA", "False"], "AUG_DATA",
     "A7"),
    ("configs/kitti/car/vob/rcnn.yaml", ["MODEL.POINTRCNN.RCNN.ROI_FG_AUG_TIMES", "5"],
     "ROI_FG_AUG_TIMES", "A7"),
    ("configs/kitti/car/vob/rcnn.yaml", ["MODEL.POINTRCNN.TRAIN.RPN_NMS_THRESH", "0.8"],
     "RPN_NMS_THRESH", "A7"),
]


@pytest.mark.parametrize("path,opts,key,item", UNSUPPORTED)
def test_unsupported_setting_raises(path, opts, key, item):
    cfg = get_default_cfg()
    cfg.merge_from_file(str(REPO / path))
    cfg.merge_from_list(opts)
    with pytest.raises(ValueError, match=rf"{key}.*ROADMAP {item}\)"):
        tbuild.build_detection_model(cfg, device="meta")


def _dispnet_fields(m):
    d = m.dispnet
    return dict(dispnet_on=m.dispnet_on, dispnet_maxdisp=d.maxdisp, dispnet_mindisp=d.mindisp,
                dispnet_resolution=d.resolution, dispnet_disp_resolution=d.disp_resolution,
                dispnet_conv_layers=d.conv_layers, dispnet_loss_weight=m.dispnet_loss_weight)


# the settings that the port once refused (ROADMAP A6 and A2, A4.1's loss
# forms), each with what the built model carries, as the JAX
# build_detection_model's fields: (config (None: the bare default), opts,
# the port model's values of JAX fields, or None to hold every keyword
# argument of the port's build to the JAX module's field of that name)
SUPPORTED = {
    "BACKBONE.USE_GN": ("configs/kitti/car/vob/mask.yaml", ["MODEL.BACKBONE.USE_GN", "True"],
                        lambda m: dict(use_gn=m.backbone.body.stem.bn1.__class__ is GroupNorm
                                       and m.backbone.body.layer4_2.bn3.__class__ is GroupNorm,
                                       use_gn_fpn=m.backbone.fpn.use_gn)),
    "FPN.USE_GN": ("configs/kitti/car/vob/mask.yaml", ["MODEL.FPN.USE_GN", "True"],
                   lambda m: dict(use_gn=any(isinstance(x, GroupNorm)
                                             for x in m.backbone.body.modules()),
                                  use_gn_fpn=m.backbone.fpn.use_gn
                                  and m.backbone.fpn.lateral2.bias is None)),
    "MASK_ON": ("configs/kitti/car/vob/mask.yaml", ["MODEL.MASK_ON", "False"],
                lambda m: dict(mask_on=m.mask_on and hasattr(m, "mask_head"))),
    "DISPNET_ON": ("configs/kitti/car/vob/mask.yaml",
                   ["MODEL.DISPNET_ON", "True", "MODEL.DISPNET.LOSS_WEIGHT", "0.5",
                    "MODEL.DISPNET.MAX_DISP", "64"], _dispnet_fields),
    "NMS_TYPE": ("configs/kitti/car/vob/rcnn.yaml", ["MODEL.POINTRCNN.RPN.NMS_TYPE", "rotate"],
                 lambda m: dict(rpn_nms_rotated=m.pointrcnn.rpn_nms_rotated,
                                rpn_distance_based=m.pointrcnn.rpn_distance_based)),
    "DISTANCE_BASED": ("configs/kitti/car/vob/rcnn.yaml",
                       ["MODEL.POINTRCNN.TEST.RPN_DISTANCE_BASED_PROPOSE", "True"],
                       lambda m: dict(rpn_nms_rotated=m.pointrcnn.rpn_nms_rotated,
                                      rpn_distance_based=m.pointrcnn.rpn_distance_based)),
    "FBNet-FPN (DispRCNN)": ("configs/kitti/car/vob/mask.yaml",
                             ["MODEL.BACKBONE.CONV_BODY", "FBNet-FPN"], None),
    "FBNet-cham_v1a-FPN (DispRCNN)": ("configs/kitti/car/vob/mask.yaml",
                                      ["MODEL.BACKBONE.CONV_BODY", "FBNet-cham_v1a-FPN",
                                       "MODEL.FBNET.SCALE_FACTOR", "0.5",
                                       "MODEL.FBNET.DW_CONV_SKIP_BN", "False"], None),
    "RETINANET_ON": (None, ["MODEL.RETINANET_ON", "True", "MODEL.BACKBONE.CONV_BODY",
                            "R-50-FPN-RETINANET", "MODEL.RETINANET.NUM_CLASSES", "5"], None),
    "STEREO_ON False, R-50-C4": (None, [], None),
    "STEREO_ON False, R-50-C5": (None, ["MODEL.BACKBONE.CONV_BODY", "R-50-C5"], None),
    "STEREO_ON False, R-50-FPN": (None, ["MODEL.BACKBONE.CONV_BODY", "R-50-FPN",
                                         "MODEL.MASK_ON", "True", "MODEL.RPN.ANCHOR_STRIDE",
                                         "(4, 8, 16, 32, 64)"], None),
    "RPN.LOSS_CLS SigmoidFocalLoss": ("configs/kitti/car/vob/rpn.yaml",
                                      ["MODEL.POINTRCNN.RPN.LOSS_CLS", "SigmoidFocalLoss"],
                                      lambda m: dict(rpn_loss_cls=m.pointrcnn.rpn_loss_cls)),
    "RPN.LOSS_CLS DiceLoss": ("configs/kitti/car/vob/rpn.yaml",
                              ["MODEL.POINTRCNN.RPN.LOSS_CLS", "DiceLoss"],
                              lambda m: dict(rpn_loss_cls=m.pointrcnn.rpn_loss_cls)),
}


@pytest.mark.parametrize("case", sorted(SUPPORTED))
def test_once_refused_setting_builds_as_jax(monkeypatch, case):
    """The setting builds, and the port's model carries what the JAX
    build_detection_model gives its model (each field against JAX's)."""
    path, opts, read = SUPPORTED[case]
    tm, kw, jm = _built(monkeypatch, path, opts)
    if read is None:
        _fields_match(tm, kw, jm)
        return
    got = read(tm)
    want = {k: getattr(jm, k) for k in got}
    assert got == want, case


@pytest.mark.parametrize("opts", [["MODEL.RETINANET_ON", "True"],
                                  ["MODEL.META_ARCHITECTURE", "GeneralizedRCNN",
                                   "MODEL.STEREO_ON", "False"]])
def test_models_off_the_port_raise(opts, tmp_path):
    """The single-view models build (test_once_refused_setting_builds_as_jax)
    but the CLIs refuse them, as the JAX package's CLIs do not run them
    either: test_net and train_net raise before building a model or a
    batch."""
    path = str(REPO / "configs/kitti/car/vob/mask.yaml")
    out = ["OUTPUT_DIR", str(tmp_path)]
    with pytest.raises(ValueError, match="single-view model.*build_detection_model"):
        test_net.run(path, opts + out, dataset="synthetic_8", device="cpu")
    with pytest.raises(ValueError, match="single-view model.*build_detection_model"):
        train_net.train(train_net.load_config(path, opts + out, 1), dataset="synthetic_8",
                        device="cpu")
    cfg = get_default_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(opts)
    with pytest.raises(ValueError, match="single-view model"):
        make_batch_converter(cfg, "cpu")


def test_settings_off_the_3d_stage_are_not_read():
    """idispnet.yaml has no 3D stage: the 3D train settings may be anything
    (the JAX model reads none of them there)."""
    cfg = get_default_cfg()
    cfg.merge_from_file(str(REPO / "configs/kitti/car/vob/idispnet.yaml"))
    cfg.merge_from_list(["MODEL.POINTRCNN.RPN.NMS_TYPE", "rotate",
                         "MODEL.POINTRCNN.RPN.LOSS_CLS", "SigmoidFocalLoss"])
    assert not tbuild.build_detection_model(cfg, device="meta").det3d_on


def test_rcnn_train_proposals_take_the_train_nms_threshold(monkeypatch):
    """rcnn.yaml's TRAIN.RPN_NMS_THRESH (0.85) reaches the RCNN train
    step's proposals, and TEST's (0.8) the eval proposals, as in the JAX
    package (point_rcnn.py:95-99)."""
    cfg = get_default_cfg()
    cfg.merge_from_file(str(REPO / "configs/kitti/car/vob/rcnn.yaml"))
    cfg.merge_from_list(["MODEL.POINTRCNN.RPN.NPOINTS", "64",
                         "MODEL.POINTRCNN.RPN.SA_CONFIG.NPOINTS", "[64, 32, 16, 8]",
                         "MODEL.POINTRCNN.TRAIN.RPN_POST_NMS_TOP_N", "4",
                         "MODEL.POINTRCNN.TEST.RPN_POST_NMS_TOP_N", "4"])
    prc = tbuild.build_detection_model(cfg, device="cpu").pointrcnn
    seen = []

    class Stop(Exception):
        pass

    def propose(*args, nms_thresh, **kwargs):
        seen.append(nms_thresh)
        raise Stop

    monkeypatch.setattr(rpn3d, "propose", propose)
    gen = torch.Generator().manual_seed(0)
    pts = torch.randn((2, 64, 3), generator=gen)
    ok, zeros = torch.ones(2, dtype=torch.bool), torch.zeros(2)
    draws = rcnn3d.draw_rcnn_draws(2, 4, prc.rcnn_rois_per_instance, rcnn3d.FG_AUG_TIMES, gen,
                                   "cpu")
    with torch.no_grad():
        with pytest.raises(Stop):
            prc.rcnn_targets(pts, ok, zeros, torch.zeros(2, 3), torch.zeros(2, 7), ok, draws)
        with pytest.raises(Stop):
            prc(pts, ok, zeros, torch.zeros(2, 3))
    assert seen == [0.85, 0.8]
