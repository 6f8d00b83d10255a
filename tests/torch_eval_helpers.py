"""The eval loop of tools/test_net run through the JAX package's modules and
through the port's, at small sizes, for tests/test_torch_eval_entry*.py."""
import os
import pathlib

import jax
import numpy as np
import pytest

from disprcnn_tpu.config import get_default_cfg as jax_default_cfg
from disprcnn_tpu.data import catalog as jcatalog
from disprcnn_tpu.data import loader as jloader
from disprcnn_tpu.data import transforms as jtransforms
from disprcnn_tpu.engine import batching as jbatching
from disprcnn_tpu.engine import inference as jinference
from disprcnn_tpu.evaluation import kitti_eval as jkitti_eval
from disprcnn_tpu.models import build as jbuild
from disprcnn_tpu.models.pointrcnn import lift as jlift
from disprcnn_tpu_torch.data import catalog
from disprcnn_tpu_torch.tools import test_net as tn
from disprcnn_tpu_torch.utils.weights import load_jax_variables
from torch_port_helpers import draw_variables

REPO = pathlib.Path(__file__).resolve().parents[1]
MASK_YAML = "configs/kitti/car/vob/mask.yaml"
RCNN_YAML = "configs/kitti/car/vob/rcnn.yaml"
# mask.yaml cut to test size: R-50, 32 FPN channels, the box head at 64,
# 48 proposals into 8 detections, the 192x640 images cropped to 96x320 by
# the loader. No resize: the port's and cv2's differ by a few ulps (held in
# tests/test_torch_data.py), so the loop compares the packages on
# bit-equal images.
TINY_MASK = ["MODEL.BACKBONE.CONV_BODY", "R-50-FPN", "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", "32",
             "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64", "MODEL.RPN.PRE_NMS_TOP_N_TEST", "200",
             "MODEL.RPN.POST_NMS_TOP_N_TEST", "48", "TPU.MAX_DETECTIONS", "8",
             "TEST.DETECTIONS_PER_IMG", "8", "TPU.MAX_GT", "4", "INPUT.DO_RESIZE", "False",
             "TEST.IMS_PER_BATCH", "2", "TPU.COMPUTE_DTYPE", "float32"]
MASK_HW = (96, 320)
# rcnn.yaml cut to test size: 4 detection slots, 32^2 ROIs at +-16, clouds
# of 128 points (SA ladder 128/64/32/16; TEST's 9000 pre-NMS proposals
# capped to them), 8 proposals an instance
TINY_RCNN = ["TPU.MAX_DETECTIONS", "4", "TPU.MAX_GT", "4", "TPU.ROI_CROP_SIZE", "32",
             "MODEL.DISPNET.MAX_DISP", "16", "MODEL.DISPNET.MIN_DISP", "-16",
             "MODEL.POINTRCNN.RPN.NPOINTS", "128",
             "MODEL.POINTRCNN.RPN.SA_CONFIG.NPOINTS", "[128, 64, 32, 16]",
             "MODEL.POINTRCNN.TEST.RPN_POST_NMS_TOP_N", "8", "TPU.COMPUTE_DTYPE", "float32"]
RCNN_HW = (192, 640)


def zero_box_regressors(variables):
    """The RPN's and the box head's regressors (bbox_pred) zero, as
    utils/weights.py::init_random_ draws them: random regressors on the
    BGR255 images put every detection on a sliver at the border and move
    it by float32's ~1e-5 relative differences (ROADMAP C15)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.zeros_like(x) if any(getattr(k, "key", None) == "bbox_pred" for k in p)
        else x, variables)


def jax_loop(path, opts, name, hw, out_dir, seed, prepare=lambda v: v):
    """tools/test_net.py's loop with the JAX package's modules (its
    predict functions, without the ROI buckets), on numpy-drawn variables
    (passed through `prepare`) and a fixed sampling key. -> (predictions,
    txt dir, variables, the lift's priorities of each batch)."""
    cfg = jax_default_cfg()
    cfg.merge_from_file(str(REPO / path))
    cfg.merge_from_list(opts)
    cfg.freeze()
    ds = jcatalog.resolve(name, cfg, training=False,
                          transforms=jtransforms.build_transforms(cfg, is_train=False))
    loader = jloader.StereoBatchLoader(
        ds, max(cfg.TEST.IMS_PER_BATCH, 1), hw, shuffle=False,
        size_divisibility=max(cfg.DATALOADER.SIZE_DIVISIBILITY, 32), pad_last=True)
    model = jbuild.build_detection_model(cfg)
    convert, static = jbatching.make_batch_converter(cfg)
    variables = prepare(draw_variables(model, seed=seed, train=False, **static,
                                       **convert(next(iter(loader)), train=False)))
    rng = jax.random.PRNGKey(0)
    apply = jax.jit(lambda vv, kw: model.apply(vv, train=False, rngs={"sampling": rng},
                                               **static, **kw))
    drawn = []
    if cfg.MODEL.META_ARCHITECTURE == "DispRCNN":
        def predict(batch):
            out = apply(variables, convert(batch, train=False))
            dets = out["detections"]
            return {"left_boxes": np.asarray(dets.left), "right_boxes": np.asarray(dets.right),
                    "scores": np.asarray(dets.score), "valid": np.asarray(dets.valid),
                    "labels": np.asarray(dets.fields["labels"]),
                    "masks": np.asarray(out["masks"])}
    else:
        def predict(batch):
            out = apply(variables, convert(batch, train=False))
            return {"left_boxes": batch["pred_left"], "right_boxes": batch["pred_right"],
                    "scores": batch["pred_score"], "labels": batch["pred_labels"],
                    "masks": batch["pred_mask"],
                    "valid": batch["pred_valid"] & np.asarray(out["roi_ok"]),
                    "box3d": np.asarray(out["box3d"], np.float32),
                    "score3d": np.asarray(out["score3d"], np.float32),
                    "random3d": np.asarray(out["random"])}
    orig = jlift.sample_fixed_points

    def sample_and_copy(key, pts, valid, npoints):
        r, c = valid.shape
        pri = jax.vmap(lambda k: jax.random.uniform(k, (c,)))(jax.random.split(key, r))
        jax.debug.callback(lambda p: drawn.append(np.array(p)), pri)
        return orig(key, pts, valid, npoints)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlift, "sample_fixed_points", sample_and_copy)
        preds = jinference.inference(predict, loader, name, out_dir)
    return preds, jkitti_eval.write_kitti_txt(preds, out_dir), variables, drawn


def port_loop(path, opts, name, hw, out_dir, variables, drawn):
    """The port's tools/test_net.run on the CPU with the JAX variables and,
    batch by batch, the JAX run's sampling priorities."""
    cfg = tn.get_default_cfg()
    cfg.merge_from_file(str(REPO / path))
    cfg.merge_from_list(opts)
    model = load_jax_variables(tn.build_detection_model(cfg, device="cpu"), variables)
    queue = list(drawn)
    run = tn.run(str(REPO / path), opts + ["OUTPUT_DIR", out_dir], dataset=name,
                 static_hw=hw, device="cpu", model=model,
                 priorities=(lambda batch: queue.pop(0)) if drawn else None)
    assert not queue
    return run["datasets"][name]


def check_keys_and_dtypes(got, want):
    assert sorted(got) == sorted(want)
    for imgid in want:
        assert sorted(got[imgid]) == sorted(want[imgid]), imgid
        for k, w in want[imgid].items():
            g = got[imgid][k]
            assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w), (imgid, k)


def write_gt_labels(gt_dir, name, opts):
    """The synthetic scenes' GT as KITTI label files."""
    cfg = tn.get_default_cfg()
    cfg.merge_from_list(opts)
    ds = catalog.resolve(name, cfg, training=False)
    os.makedirs(gt_dir, exist_ok=True)
    for i in range(len(ds)):
        s = ds[i]
        lines = [f"Car 0.00 0 -10 {' '.join(f'{v:.2f}' for v in b)} "
                 f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}"
                 for b, (x, y, z, h, w, l, ry), ok in zip(s["gt_left"], s["gt_box3d"],
                                                           s["gt_valid"]) if ok]
        with open(os.path.join(gt_dir, f"{s['imgid']}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
