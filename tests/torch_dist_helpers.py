"""Several ranks of the port on the CPU, for tests/test_torch_dist*.py: each
rank a subprocess (tests/torch_dist_worker.py) on the gloo backend, with
torchrun's environment and a free port, as tests/test_multihost_merge.py
runs its JAX processes. Imports nothing of JAX: the workers import it.

The port is checked free here and bound later by rank 0's store, so
something else may take it in between: under pytest-xdist another worker's
ranks open gloo connections, each of which takes a port of the kernel's
ephemeral range (32768-60999 by default), and another worker may pick the
same port. So the port is drawn at random below that range, where no
outgoing connection is given one, and a run whose rank 0 finds it taken
(EADDRINUSE) is started again on another port."""
import contextlib
import json
import os
import pathlib
import pickle
import random
import socket
import subprocess
import sys

import torch

from disprcnn_tpu_torch.engine import batching, trainer
from disprcnn_tpu_torch.tools import train_net as trn

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(__file__).with_name("torch_dist_worker.py")
TIMEOUT_S = 300
# the ports free_port draws from: below Linux's default ephemeral range
PORTS = (20000, 32000)
# runs of run_ranks, the first included, while rank 0 finds its port taken
PORT_TRIES = 4


def free_port() -> int:
    """A port of PORTS that is free now, drawn at random."""
    rng = random.SystemRandom()
    for _ in range(200):
        port = rng.randrange(*PORTS)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free port in {PORTS}")


def _port_taken(out: str) -> bool:
    return "EADDRINUSE" in out or "address already in use" in out.lower()


def run_ranks(job: str, args: dict, out_dir, world: int = 2, timeout: float = TIMEOUT_S):
    """`world` ranks of the worker's `job` on `args`, each writing
    out_dir/rank{r}.pkl; every rank must exit 0 within `timeout` s. A run
    whose port was taken before rank 0 bound it is started again on another
    (at most PORT_TRIES runs). -> [each rank's pickled result]."""
    for _ in range(PORT_TRIES):
        procs, outs = _start_ranks(job, args, out_dir, world, timeout)
        if not any(p.returncode and _port_taken(o) for p, o in zip(procs, outs)):
            break
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{o[-4000:]}"
    res = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _start_ranks(job, args, out_dir, world, timeout):
    """One run of the ranks on a fresh port -> (processes, their output)."""
    env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(WORKER.parent),
                                           os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(WORKER), job, json.dumps(args),
                               str(out_dir)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


@contextlib.contextmanager
def first_step_capture(store: dict):
    """Inside the block, the first TrainStep call leaves in `store` its
    gradients ("grads": name -> the reduced, clipped gradient) and the
    model's buffers after it ("buffers")."""
    orig = trainer.TrainStep.__call__

    def call(self, batch):
        metrics = orig(self, batch)
        if not store:
            ids = {id(p) for p in self.optimizer.params}
            store["grads"] = {n: p.grad.detach().clone()
                              for n, p in self.model.named_parameters() if id(p) in ids}
            store["buffers"] = {n: b.detach().clone() for n, b in self.model.named_buffers()}
        return metrics

    trainer.TrainStep.__call__ = call
    try:
        yield store
    finally:
        trainer.TrainStep.__call__ = orig


@contextlib.contextmanager
def float64_batches():
    """Inside the block the batch converter makes float64 tensors of the
    float arrays (engine/batching.py::to_device)."""
    orig = batching.to_device

    def to_device(x, device):
        t = orig(x, device)
        return t.double() if t.is_floating_point() else t

    batching.to_device = to_device
    try:
        yield
    finally:
        batching.to_device = orig


def train_stage(stage: str, opts, out_dir, dataset: str, hw, max_iter: int, seed: int = 3,
                weights=None, dtype: str = "float32", dist_backend: str = "gloo") -> dict:
    """tools/train_net.train of configs/kitti/car/vob/<stage>.yaml with
    `opts` on the CPU, from the weights train_net draws from `seed` or from
    `weights` (a state_dict file), in `dtype` (float64: the model and the
    batches' floats). -> the first step's metrics, gradients and buffers,
    each iteration's metrics, the final state_dict, and the run's world,
    rank, pairs a rank and checkpoint directory."""
    cfg = trn.load_config(str(REPO / "configs/kitti/car/vob" / f"{stage}.yaml"),
                          list(opts) + ["OUTPUT_DIR", str(out_dir)], max_iter)
    model = trn.init_random_(trn.build_detection_model(cfg, device="cpu"),
                             torch.Generator().manual_seed(seed))
    if weights:
        model.load_state_dict(torch.load(weights))
    store = {}
    with first_step_capture(store), (float64_batches() if dtype == "float64"
                                     else contextlib.nullcontext()):
        res = trn.train(cfg, dataset=dataset, static_hw=tuple(hw), device="cpu", seed=seed,
                        model=model.to(getattr(torch, dtype)), dist_backend=dist_backend)
    return {"metrics": res["metrics"], "grads": store["grads"], "buffers": store["buffers"],
            "state": res["model"].state_dict(), "world": res["world"], "rank": res["rank"],
            "ims_per_rank": res["ims_per_rank"], "ckpt_dir": res["ckpt_dir"]}
