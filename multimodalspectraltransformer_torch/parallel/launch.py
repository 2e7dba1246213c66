"""Start N ranks, run one function in each, and collect what they return.

    results = launch("package.module:function", nprocs=2, args=(...))  # on the card
    results = launch("package.module:function", nprocs=2, args=(...), device="cpu")

Each rank is a subprocess running ``python -m
multimodalspectraltransformer_torch.parallel.launch <run directory>``, with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set as
``torchrun`` sets them. The ranks meet through a ``file://`` store in a
temporary directory of their own (no TCP port, so launches running side by
side never collide), join the world with ``init_distributed(backend,
device=device)``, call ``function(*args, **kwargs)`` and write its return
value to the run directory (``torch.save``), which the parent reads back in
rank order. On the CPU each rank runs torch on one intra-op thread.

The ranks import only the function's module: never the caller's module, so a
test that launches ranks does not bring JAX or its conftest into them. A rank
that exits with an error, or a launch that outlives ``timeout`` (every rank is
then killed), raises ``RuntimeError`` in the parent with the output of the
ranks that failed.
A function run under ``torchrun`` instead calls ``init_distributed`` itself.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch

from ..utils.device import DeviceLike, resolve_device


def launch(target: str, nprocs: int, args: Sequence = (), kwargs: Optional[dict] = None,
           device: DeviceLike = None, backend: Optional[str] = None,
           timeout: float = 600.0) -> list:
    """Run ``target`` ("module:function") in ``nprocs`` ranks on ``device``
    (CUDA unless ``"cpu"`` is asked for; raises without CUDA) over
    ``backend`` (gloo on the CPU and nccl on CUDA unless given); return each
    rank's return value, in rank order."""
    kind = resolve_device(device).type
    with tempfile.TemporaryDirectory(prefix="mmt_launch_") as run_dir:
        torch.save({"target": target, "args": tuple(args), "kwargs": dict(kwargs or {}),
                    "device": kind, "backend": backend}, os.path.join(run_dir, "spec.pt"))
        base = dict(os.environ)
        # the ranks import what this process can: its module search path
        base["PYTHONPATH"] = os.pathsep.join(p for p in [os.getcwd(), *sys.path] if p)
        procs, logs = [], []
        try:
            for rank in range(nprocs):
                rank_env = dict(base, RANK=str(rank), WORLD_SIZE=str(nprocs),
                                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
                out = open(os.path.join(run_dir, f"rank{rank}.log"), "w+")
                logs.append(out)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "multimodalspectraltransformer_torch.parallel.launch",
                     run_dir], env=rank_env, stdout=out, stderr=subprocess.STDOUT))
            _wait(procs, logs, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        return [torch.load(os.path.join(run_dir, f"result{r}.pt"), weights_only=False)
                for r in range(nprocs)]


def _tail(f, n: int = 6000) -> str:
    f.flush()
    f.seek(0)
    return f.read()[-n:]


def _wait(procs: list, logs: list, timeout: float) -> None:
    """Wait for every rank; raise with the output of every rank that failed
    (a failure usually takes the others' collectives down with it), or of
    every rank when the launch outlives ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            time.sleep(1.0)  # let the others fail or finish and write their output
            for p in procs:
                if p.poll() is None:
                    p.kill()
            failed = [(r, p.wait()) for r, p in enumerate(procs) if p.wait() != 0]
            outs = "\n".join(f"--- rank {r} of {len(procs)} exited with {code}:\n"
                             f"{_tail(logs[r])}" for r, code in failed)
            raise RuntimeError(f"ranks {[r for r, _ in failed]} failed\n{outs}")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            for p in procs:
                p.kill()
            outs = "\n".join(f"--- rank {r}:\n{_tail(f, 2000)}" for r, f in enumerate(logs))
            raise RuntimeError(f"launch of {len(procs)} ranks outlived {timeout} s\n{outs}")
        time.sleep(0.05)


def _rank_main(run_dir: str) -> None:
    import torch.distributed as dist

    from .mesh import init_distributed

    spec = torch.load(os.path.join(run_dir, "spec.pt"), weights_only=False)
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    module, _, name = spec["target"].partition(":")
    fn = getattr(importlib.import_module(module), name)
    init_distributed(spec["backend"], f"file://{os.path.join(run_dir, 'store')}", spec["device"])
    try:
        result = fn(*spec["args"], **spec["kwargs"])
        rank = dist.get_rank()
        tmp = os.path.join(run_dir, f"result{rank}.pt.tmp")
        torch.save(result, tmp)
        os.replace(tmp, os.path.join(run_dir, f"result{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
