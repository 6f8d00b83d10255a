"""The port's distribution layer on the CPU (parallel/, the loader's
shards, engine/inference.py's merge, tools/test_net.py over ranks): the
multi-rank runs are gloo subprocesses (tests/torch_dist_worker.py) with
torchrun's environment.

Held exactly: the merged predictions (every rank ends with the whole dict;
unequal shards, ids that are not numbers, a repeated id keeps rank 0's
row), the world-1 identities, each global step's samples over two ranks as
the one-process batch's, a two-rank test_net's predictions.pkl and AP as
the one-process run's (rcnn.yaml at test size, TEST.IMS_PER_BATCH 1, an odd
image count so that the last shard is padded), and the refusals: NCCL with
two ranks on one card, a global batch that does not split, a rank with no
prediction.
"""
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from disprcnn_tpu_torch.data.loader import StereoBatchLoader
from disprcnn_tpu_torch.engine import inference
from disprcnn_tpu_torch.parallel import mesh, multihost
from disprcnn_tpu_torch.tools import test_net as tn
from disprcnn_tpu_torch.tools.train_net import rank_batch
from torch_dist_helpers import run_ranks
from torch_eval_helpers import RCNN_HW, RCNN_YAML, REPO, TINY_RCNN, write_gt_labels
from torch_train_helpers import torch_one_thread  # noqa: F401

SHARDS = [  # rank 0: 3 images, one id not a number; rank 1: 2, one repeating rank 0's
    {"000001": {"box": [[1.0] * 4] * 2, "s": [0.9]}, "000003": {"box": [[3.0] * 4] * 2, "s": [0.8]},
     "seq_0005": {"box": [[5.0] * 4] * 2, "s": [0.7]}},
    {"000002": {"box": [[2.0] * 4] * 2, "s": [0.6]}, "000001": {"box": [[-1.0] * 4] * 2,
                                                              "s": [0.1]}},
]


def test_two_rank_merge_unequal_shards_and_string_ids(tmp_path):
    merged = run_ranks("merge", {"shards": SHARDS}, tmp_path)
    for m in merged:  # every rank ends with the whole dict
        assert sorted(m) == ["000001", "000002", "000003", "seq_0005"]
        for imgid in ("000002", "000003", "seq_0005"):
            shard = SHARDS[0] if imgid in SHARDS[0] else SHARDS[1]
            for k, v in shard[imgid].items():
                np.testing.assert_array_equal(m[imgid][k], np.asarray(v, np.float32))
        # the repeat (a padded shard's) keeps rank 0's row, the image's own
        np.testing.assert_array_equal(m["000001"]["box"], np.ones((2, 4), np.float32))


def test_world_one_is_the_identity(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.init_distributed("gloo", "cpu") == torch.device("cpu")
    assert not dist.is_initialized()
    assert (multihost.process_count(), multihost.process_index()) == (1, 0)
    assert multihost.is_main_process()
    local = {"a": {"x": np.ones(2)}}
    assert inference.merge_predictions_across_hosts(local) is local
    arrays = {"x": np.arange(3)}
    assert multihost.all_gather_predictions(arrays) is arrays
    x = torch.arange(6.0)
    assert mesh.sum_over_ranks(x) is x and mesh.sum_over_ranks_autograd(x) is x
    assert mesh.shard_batch(x, 3) is x
    multihost.synchronize()
    assert multihost.rank_device("cuda") == torch.device("cuda", 0)
    assert multihost.rank_device("cuda:3") == torch.device("cuda", 3)


@pytest.mark.parametrize("local_rank, device", [(1, None), (0, "cuda:0"), (1, "cuda:0")])
def test_nccl_refuses_two_ranks_on_one_card(monkeypatch, local_rank, device):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", str(local_rank))
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="nccl needs one card a rank"):
        multihost.init_distributed("nccl", device)
    assert not dist.is_initialized()


def test_shards_of_a_global_batch(monkeypatch):
    x = torch.arange(24.0).reshape(12, 2)  # 4 samples of 3 rows
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    parts = []
    for r in (0, 1):
        monkeypatch.setattr(mesh, "process_index", lambda r=r: r)
        parts.append(mesh.shard_batch({"a": x, "b": x[:4]}, 4))
    # global sample j * 2 + r is rank r's sample j
    for r in (0, 1):
        np.testing.assert_array_equal(parts[r]["a"], x.reshape(4, 3, 2)[r::2].reshape(6, 2))
        np.testing.assert_array_equal(parts[r]["b"], x[:4][r::2])
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(x, 3)
    assert [rank_batch(ims, 2) for ims in (1, 2, 4)] == [1, 1, 2]
    with pytest.raises(ValueError, match="does not split"):
        rank_batch(3, 2)
    monkeypatch.setattr(inference, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="0 predictions"):
        inference.merge_predictions_across_hosts({})


class _Scenes:
    """Samples of the loader's keys, landscape and portrait."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def image_sizes(self):
        return [(4, 8) if i % 3 else (8, 4) for i in range(self.n)]

    def __getitem__(self, i):
        z = np.zeros
        return {"imgid": f"{i:06d}", "left": z((4, 4, 3), np.float32),
                "right": z((4, 4, 3), np.float32), "gt_left": z((2, 4), np.float32),
                "gt_right": z((2, 4), np.float32), "gt_box3d": z((2, 7), np.float32),
                "gt_labels": z(2, np.int32), "gt_valid": z(2, bool)}


@pytest.mark.parametrize("n, ims", [(8, 4), (12, 2), (10, 4)])
def test_each_global_batch_is_the_one_process_batch(n, ims):
    """The ranks' shares of every step, as a set, are the one-process
    batch (shuffled, aspect-grouped, over epochs: the dataset's size a
    multiple of the ranks, as the reference's DistributedSampler pads it
    otherwise)."""
    kw = dict(shuffle=True, seed=5, max_iter=9, group_by_aspect=True)
    one = [b["imgid"] for b in StereoBatchLoader(_Scenes(n), ims, (32, 32), **kw)]
    ranks = [[b["imgid"] for b in StereoBatchLoader(_Scenes(n), ims // 2, (32, 32),
                                                    num_shards=2, shard_id=r, **kw)]
             for r in (0, 1)]
    assert len(one) == len(ranks[0]) == len(ranks[1]) == 9
    for step, batch in enumerate(one):
        assert sorted(batch) == sorted(ranks[0][step] + ranks[1][step]), step


@pytest.mark.usefixtures("torch_one_thread")  # as the ranks run: one thread each
def test_two_rank_test_net_equals_one_process(tmp_path):
    gt_dir = str(tmp_path / "gt")
    name = "synthetic3d_3"
    write_gt_labels(gt_dir, name, TINY_RCNN)
    args = dict(config_file=str(REPO / RCNN_YAML), dataset=name, static_hw=list(RCNN_HW),
                evaluate=True, gt_dir=gt_dir, seed=4)
    ranks = run_ranks("test_net", dict(args, opts=TINY_RCNN + [
        "OUTPUT_DIR", str(tmp_path / "two")]), tmp_path)
    one = tn.run(**dict(args, opts=TINY_RCNN + ["OUTPUT_DIR", str(tmp_path / "one")]),
                 device="cpu")["datasets"][name]
    two = ranks[0][name]
    assert "txt_dir" not in ranks[1][name] and "ap" not in ranks[1][name]
    with open(os.path.join(two["out_dir"], "predictions.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert sorted(saved) == sorted(one["predictions"]) and len(saved) == 3
    for got in (saved, two["predictions"], ranks[1][name]["predictions"]):
        for imgid, want in one["predictions"].items():
            assert sorted(got[imgid]) == sorted(want)
            for k, v in want.items():
                assert got[imgid][k].dtype == v.dtype, (imgid, k)
                np.testing.assert_array_equal(got[imgid][k], v, err_msg=(imgid, k))
    assert sorted(os.listdir(two["txt_dir"])) == sorted(os.listdir(one["txt_dir"]))
    assert two["ap"] == one["ap"]
