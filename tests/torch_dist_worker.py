"""One rank of the port's multi-rank CPU tests, started by
tests/torch_dist_helpers.py::run_ranks with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) on the gloo backend.
Imports nothing of JAX.

    python tests/torch_dist_worker.py JOB ARGS_JSON OUT_DIR

writes OUT_DIR/rank<RANK>.pkl. Jobs:
- merge: engine/inference.py::merge_predictions_across_hosts of this
  rank's dict in ARGS ("shards": one {imgid: {key: list}} a rank);
- train: tools/train_net of each run in ARGS["runs"] (torch_dist_helpers
  .train_stage's keywords), in one process group; ARGS["control"]
  "bn_local_grad" takes train BN's cross-rank gradient terms out;
- test_net: tools/test_net.run of ARGS (its keywords).
"""
import json
import os
import pickle
import sys

import numpy as np
import torch

torch.set_num_threads(1)


def job_merge(args):
    from disprcnn_tpu_torch.engine.inference import merge_predictions_across_hosts
    from disprcnn_tpu_torch.parallel.multihost import init_distributed

    init_distributed("gloo", "cpu")
    local = {i: {k: np.asarray(v, np.float32) for k, v in p.items()}
             for i, p in args["shards"][int(os.environ["RANK"])].items()}
    return merge_predictions_across_hosts(local)


def job_train(args):
    from torch_dist_helpers import train_stage

    if args.get("control") == "bn_local_grad":
        # a train BN whose forward takes the global moments but whose
        # gradient misses the other ranks' terms (a non-autograd sum)
        from disprcnn_tpu_torch.models.psmnet import psmnet
        from disprcnn_tpu_torch.parallel.mesh import sum_over_ranks

        psmnet.sum_over_ranks_autograd = lambda x: x + (sum_over_ranks(x) - x).detach()
    return [train_stage(**run) for run in args["runs"]]


def job_test_net(args):
    from disprcnn_tpu_torch.tools import test_net

    run = test_net.run(**args, device="cpu", dist_backend="gloo")
    return {name: {k: v for k, v in res.items() if k != "stats"}
            for name, res in run["datasets"].items()}


def main():
    job, args, out_dir = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
    res = {"merge": job_merge, "train": job_train, "test_net": job_test_net}[job](args)
    with open(os.path.join(out_dir, f"rank{os.environ['RANK']}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
