"""Readings for the limits that decide ``correct``: the numbers of a
training cell's first steps, or of a renderer cell's calls, on many seeds
in one process, for the sound program and for the controls and faults the
limits have to reject. No window is timed.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 \\
        --mode sound

Modes: ``sound`` (the program as the configuration states it);
``render_bf16`` (the program with its bf16 renderer mode switched on);
``nets_fp8`` (the reference with float8 operands in the program's place);
``half_batch`` (a step that leaves half its batch out and takes the mean
over the rest); ``half_loss`` (the same with every row rendered: half
the rows leave the gradient alone); ``no_exchange`` (the ranks' gradient exchange left out);
``unchanged`` (a step that returns the state unchanged); for a renderer
cell ``altered`` (one render's answer altered where it is produced). One
JSON line a seed: the mode, the seed and the numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from benchmark import faults, harness, manifest, run as entry


def train_numbers(r: harness.Run, mode: str) -> dict:
    import torch

    from benchmark import check
    from benchmark.drivers import train

    settings = r.cell.settings()
    if mode == "render_bf16":
        settings = {**settings, "pallas_acc_dtype": "bfloat16"}
    device = r.torch_device()
    p = train.build(r, settings, device)
    n = r.cell.traffic["check_steps"]
    rows = p.cfg.batch_size // r.world
    if mode == "nets_fp8":
        prog = train.reference(r.cell.settings(), p, n, r.world,
                               operand="float8")
    else:
        prog = train.first_steps(
            p, n, min(p.cfg.views_per_step, r.cell.traffic["views"]))
    p.state = p.named = p.steps = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not r.lead:
        return {}
    ref = train.reference(r.cell.settings(), p, n, r.world,
                          points=train.judged_points(prog, rows))
    grad, change = check.train_leaf_gaps(prog, ref, p.start)
    return {**check.train_numbers(prog, ref, p.start),
            "worst_grad_leaf": max(grad, key=grad.get),
            "worst_change_leaf": max(change, key=change.get)}


def main(argv=None) -> int:
    a = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    a.add_argument("--workload", required=True)
    a.add_argument("--seeds", required=True)
    a.add_argument("--mode", default="sound")
    a.add_argument("--root", default=str(manifest.ROOT))
    a.add_argument("--device", default="cuda")
    a.add_argument("--rank", type=int, default=0)
    a.add_argument("--world", type=int, default=0)
    a.add_argument("--port", type=int, default=0)
    a.add_argument("--seconds", type=float, default=2.0)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = a.parse_args(argv)
    cell = manifest.cell(args.workload, Path(args.root))
    r = harness.Run(cell=cell, seed=0, seconds=0, trace=False,
                    t_start=time.time(), rank=args.rank,
                    world=args.world or cell.chips, port=args.port,
                    device=args.device)
    procs = []
    if r.world > 1 and r.lead:
        r.port = r.port or entry.free_port()
        procs = entry.spawn(["-m", "benchmark.calibrate"], argv, r)
    try:
        r.join()
        for seed in [int(s) for s in args.seeds.split(",")]:
            r.seed, r.seconds = seed, args.seconds
            t0 = time.time()
            with faults.planted(args.mode):
                if cell.traffic["driver"] == "train":
                    numbers = train_numbers(r, args.mode)
                else:
                    numbers = faults.render_numbers(r, args.mode)
            if r.lead:
                print(json.dumps({"workload": args.workload,
                                  "mode": args.mode, "seed": seed,
                                  "seconds": time.time() - t0, **numbers}),
                      flush=True)
        r.leave()
    finally:
        codes = entry.reap(procs, entry.CHILD_WAIT_S)
    return 1 if any(codes) else 0


if __name__ == "__main__":
    sys.exit(main())
