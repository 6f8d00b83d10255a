"""The port's bench (disprcnn_tpu_torch/bench.py) and its train stages
(disprcnn_tpu_torch/tools/bench_train.py) on the CPU at a tiny geometry: the
canary's plain side, time_pipeline on both routes, the train stages and the
JSON line's keys. Times here are host times of the plain versions, not
card numbers."""
import json

import pytest
import torch

from disprcnn_tpu_torch import bench
from disprcnn_tpu_torch.models.detector.disprcnn import DispRCNN
from disprcnn_tpu_torch.models.detector.disprcnn3d import DispRCNN3D
from disprcnn_tpu_torch.models.pointrcnn import pointnet2 as tpn2
from disprcnn_tpu_torch.tools import bench_train
from disprcnn_tpu_torch.utils.weights import init_random_

IMG_HW = (64, 128)
# An untrained R-50 at 64x128 scores its boxes near the default 0.05
# threshold, so the tiny detector keeps every box (score_thresh 0); its
# weights come from a seed whose random iDispNet lifts points for every
# instance, so that PointRCNN runs (time_pipeline checks for it).
TINY_2D = dict(body="R-50", out_channels=32, mlp_head_dim=64, pre_nms_top_n_test=200,
               post_nms_top_n_test=48, max_det=4, detections_per_img=4, score_thresh=0.0)
TINY_3D = dict(max_det=4, roi_size=32, maxdisp=16, mindisp=-16, det3d_on=True, npoints=64,
               lift_grid=16, sa_npoints=(64, 32, 16, 8), psm_hourglass=1)
CALIB = dict(bench.CALIB, cu=IMG_HW[1] / 2.0, cv=IMG_HW[0] / 2.0)


@pytest.fixture(scope="module")
def tiny_models():
    gen = torch.Generator().manual_seed(1)
    return (init_random_(DispRCNN(**TINY_2D, device="cpu"), gen),
            init_random_(DispRCNN3D(**TINY_3D, device="cpu"), gen))


def test_canary_covers_every_kernel_row():
    """On the CPU each wrapper takes its plain version, so every row is
    exact; the canary names the 15 rows of the kernel table in order."""
    rows = bench.canary("cpu")
    assert [r["row"] for r in rows] == list(range(1, 16))
    assert all(r["max_abs_err"] == 0.0 for r in rows)


def test_canary_raises_on_a_mismatch(monkeypatch):
    """A kernel off its plain version stops the bench (no fallback)."""
    from disprcnn_tpu_torch.ops.cuda import grouped_mlp as cgm

    plain = cgm.grouped_mlp_max_plain
    monkeypatch.setattr(cgm, "grouped_mlp_max", lambda *a: plain(*a) + 1e-2)
    with pytest.raises(AssertionError, match="grouped_mlp"):
        bench.canary("cpu")


@pytest.mark.parametrize("kernels_off", [(), ("sa",)])
def test_time_pipeline_and_result_line(tiny_models, monkeypatch, kernels_off):
    """Both routes through predict at a tiny geometry; the SA-off route
    reaches row 12's wrapper (its plain version here)."""
    calls = {"n": 0}
    orig = tpn2.grouped_mlp_max

    def counted(*args):
        calls["n"] += 1
        return orig(*args)

    monkeypatch.setattr(tpn2, "grouped_mlp_max", counted)
    res = bench.time_pipeline(tiny_models, 1, "headline", kernels_off, iters=1, img_hw=IMG_HW,
                              calib=CALIB)
    assert (calls["n"] > 0) == ("sa" in kernels_off)
    assert res["iters"] == 1 and res["kernels_off"] == list(kernels_off)
    assert res["ms_min"] <= res["ms_median"] <= res["ms_max"]
    assert res["pairs_per_sec"] == pytest.approx(1e3 / res["ms_median"])
    line = bench.result_line({"headline": res}, {}, 1, kernels_off, "cpu")
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "pairs_per_step", "device",
                         "kernels_off", "budgets", "train"}
    assert line["metric"] == "stereo_pairs_per_sec_full_pipeline_headline_budget"
    assert line["unit"] == "pairs/s/card"
    assert line["vs_baseline"] == pytest.approx(res["pairs_per_sec"] / (3769 / 120.0 / 8.0))
    json.dumps(line)


def test_result_line_quotes_the_reference_budget():
    budgets = {"headline": {"pairs_per_sec": 9.0}, "reference": {"pairs_per_sec": 6.0}}
    line = bench.result_line(budgets, {}, 8, ("sa",), "card")
    assert line["metric"] == "stereo_pairs_per_sec_full_pipeline_reference_budget"
    assert line["value"] == 6.0 and line["kernels_off"] == ["sa"]


def test_train_stages_at_a_tiny_geometry():
    """The psm and pc steps of tools/bench_train.py built and timed on the
    CPU (one timed step each, after a warm-up)."""
    gen = torch.Generator().manual_seed(3)
    psm = bench_train.psm_stage(1, gen, dict(TINY_3D, det3d_on=False, roi_min_score=0.5,
                                             max_roi_train=3), (96, 160))
    assert psm.units == 3
    assert len(bench_train.time_steps(psm, 1)) == 1
    pc = bench_train.pc_stage(1, gen, dict(TINY_3D, mask_thresh_train=0.5,
                                           rpn_pre_nms_per_roi_train=64,
                                           proposals_per_roi_train=16,
                                           rcnn_rois_per_instance=4, rpn_fixed=True),
                              (96, 160), CALIB)
    assert pc.with_points > 0
    assert len(bench_train.time_steps(pc, 1)) == 1


def test_2d_train_stage_at_a_tiny_geometry():
    """The 2D step of tools/bench_train.py (mask.yaml's freezing) built and
    run on the CPU at the tests' small detector, one timed step: only the
    mask head changes."""
    cfg = dict(TINY_2D, pre_nms_top_n_train=300, post_nms_top_n_train=100,
               roi_batch_per_image=64)
    st = bench_train.det2d_stage(2, torch.Generator().manual_seed(4), cfg, (64, 128))
    assert st.batch["gt_valid"].sum(1).min() >= 2 and not st.record
    before = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    assert len(bench_train.time_steps(st, 1, warmup=0)) == 1
    pos = st.record["roi_pos"]
    assert pos.shape == (2, 100 + bench_train.DET2D_GT) and pos.any(1).all()
    moved = {n for n, p in st.model.named_parameters() if not torch.equal(p, before[n])}
    assert moved and all(n.startswith("mask_head.") for n in moved)
    assert bench_train.BENCH_PAIRS["2d"] == 4


def test_unported_and_unknown_train_stages_raise():
    """The bench times the 2d, psm and pc stages; "rpn" (stage 3's step,
    built by rpn_stage) is not one of them."""
    with pytest.raises(ValueError, match="unknown train stage"):
        bench.time_train_stage("rpn", "cpu")


def test_main_refuses_a_missing_card(monkeypatch, capsys):
    """--device cuda without a card exits non-zero and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--device", "cuda"]) != 0
    assert "{" not in capsys.readouterr().out
