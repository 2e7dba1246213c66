#!/usr/bin/env python3
"""Cold device times of the port's kernels K1, K2, K3 and E1, for one tree of
the port, so that two commits can be compared on one card.

    python3 scripts/torch_kernel_times.py [--pkg-root DIR] [--label NAME]
        [--kernels K1,K2,K3,E1] [--hsqc PATH] [--out FILE]

The kernels come from ``multimodalspectraltransformer_torch`` under
``--pkg-root`` (default: this repository), built there. The timers and the
timed shapes come from this repository's ``kernel_timing.py``, the ones
``chip_smoke.py`` times: ``graph_ms`` (one CUDA-graph replay over enough
input copies to exceed the L2, between CUDA events) and ``cuda_ms`` (eager
calls), at the shapes of ``k1_cases``, ``k2_cases``, ``k3_cases`` and
``e1_cases`` (E1: the stable sort and the kernel, as the wrapper runs them), and
for K2 also the main path's HSQC cost saved by ``chip_smoke.py --save-hsqc``
(``--hsqc``). K2's rows carry the rounds of the slowest problem (from the
plain version) and the time per round. A shape that the tree's wrapper
refuses (an older kernel's size limit) is written with its error.

Prints one JSON line per shape and appends them to ``--out``. Needs a CUDA
device. To compare a parent commit with this one, unpack the parent with
``git archive`` into an ignored directory and run parent, change, change,
parent in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pkg-root", default=REPO, help="directory holding the package to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--kernels", default="K1,K2,K3,E1",
                    help="comma-separated subset of K1,K2,K3,E1")
    ap.add_argument("--hsqc", help="HSQC cost tensor saved by chip_smoke.py --save-hsqc")
    ap.add_argument("--out", default="runs/torch_kernel_times.jsonl")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    # the package of --pkg-root first, then this repository's kernel_timing
    sys.path[:0] = [os.path.abspath(args.pkg_root), REPO]

    import torch

    import kernel_timing as kt

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from multimodalspectraltransformer_torch.decode import functional
    from multimodalspectraltransformer_torch.ops import _build
    from multimodalspectraltransformer_torch.ops import auction as k2
    from multimodalspectraltransformer_torch.ops import beam_attention as k3
    from multimodalspectraltransformer_torch.ops import decode_attention as k1
    from multimodalspectraltransformer_torch.rank import matching

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    _build.build(force=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def emit(kernel: str, shape: str, **numbers) -> None:
        row = dict(label=args.label, pkg=k1.__file__, card=card, kernel=kernel, shape=shape,
                   **numbers)
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")

    if "K1" in kernels:
        for label, q, kv, pos in kt.k1_cases(dev):
            emit("K1", label,
                 device_ms=kt.graph_ms(lambda q_, kv_: k1.decode_attention(q_, kv_, pos), (q, kv),
                                       200),
                 ms=kt.cuda_ms(lambda: k1.decode_attention(q, kv, pos), 200))

    if "K2" in kernels:
        costs = list(kt.k2_cases(dev, matching.pairwise_cost))
        if args.hsqc:
            costs.insert(0, ("main-path HSQC", torch.load(args.hsqc).to(dev)))
        for label, cost in costs:
            _, rounds = k2.auction_assignment_cost_plain(cost, return_iters=True)
            slowest = int(rounds.max().item())
            try:
                device_ms = kt.graph_ms(lambda c: k2.auction_assignment_cost(c), (cost,), 20)
            except ValueError as e:  # the tree's wrapper refuses this N
                emit("K2", f"{label} {list(cost.shape)}", refused=str(e), rounds_slowest=slowest)
                continue
            emit("K2", f"{label} {list(cost.shape)}", device_ms=device_ms,
                 ms=kt.cuda_ms(lambda: k2.auction_assignment_cost(cost), 20),
                 rounds_slowest=slowest, us_per_round=device_ms * 1e3 / slowest)

    if "K3" in kernels:
        for label, q, kv, bias, n_live in kt.k3_cases(dev, functional.ancestry_bias):
            emit("K3", label,
                 device_ms=kt.graph_ms(lambda q_, kv_, b_: k3.beam_attention(q_, kv_, b_, n_live),
                                       (q, kv, bias), 200),
                 ms=kt.cuda_ms(lambda: k3.beam_attention(q, kv, bias, n_live), 200))

    if "E1" in kernels:  # a tree from before E1 has no ops/embedding_grad.py
        from multimodalspectraltransformer_torch.ops import embedding_grad as e1

        for label, grad, ids, V in kt.e1_cases(dev):
            emit("E1", label,
                 device_ms=kt.graph_ms(lambda g_, i_: e1.embedding_grad(g_, i_, V), (grad, ids),
                                       200),
                 ms=kt.cuda_ms(lambda: e1.embedding_grad(grad, ids, V), 200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
