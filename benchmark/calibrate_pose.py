"""Readings for the limits that decide a predicted-pose cell's ``correct``:
the numbers of its first steps (``benchmark/check_pose.py``) on many seeds
in one process, for the sound program and for the controls and faults the
limits have to reject. No window is timed.

    python3 -m benchmark.calibrate_pose --workload <name> --seeds 1,2,3 \\
        --mode sound

Modes: ``sound``; ``nets_fp8`` (the reference with float8 operands in the
program's place); ``render_bf16`` (the program with its renderer's bf16
mode); ``benchmark.faults_pose``'s ``argmax``, ``view0`` and
``live_teacher``; ``benchmark.faults``'s ``half_batch``, ``half_loss`` and
``unchanged``. One JSON line a seed: the mode, the seed and the numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from benchmark import check, check_pose, faults, faults_pose, harness, \
    manifest
from benchmark.drivers import train as gt
from benchmark.drivers import train_pose
from benchmark.reference import exact_f32
from benchmark.reference import pose as ref_pose


def fp8_program(settings: dict, p: gt.Program, n: int) -> dict:
    """The reference with float8 operands, recorded as ``first_steps``
    records the program."""
    with exact_f32():
        out = ref_pose.train_steps(settings, p.start, p.records, p.key, n,
                                   operand="float8",
                                   block_rows=train_pose.BLOCK_ROWS)
        first = ref_pose.first_outputs(settings, p.start, p.records, p.key,
                                       operand="float8",
                                       block_rows=train_pose.BLOCK_ROWS)
    return {**out, "first": first}


def numbers(r: harness.Run, mode: str) -> dict:
    import torch

    settings = r.cell.settings()
    run_settings = ({**settings, "pallas_acc_dtype": "bfloat16"}
                    if mode == "render_bf16" else settings)
    device = r.torch_device()
    p = gt.build(r, run_settings, device)
    n = r.cell.traffic["check_steps"]
    fan = settings["pose_predict_num_candidates"] * min(
        settings["views_per_step"], r.cell.traffic["views"])
    with faults.planted(mode), faults_pose.planted(mode):
        prog = (fp8_program(settings, p, n) if mode == "nets_fp8"
                else train_pose.first_steps(p, n, fan))
    p.state = p.named = p.steps = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = train_pose.reference(settings, p, n, 1, points=prog,
                               tie_margin=r.cell.workload["tie_margin"])
    grad, change = check.train_leaf_gaps(prog, ref, p.start)
    return {**check_pose.numbers(prog, ref, p.start),
            "worst_grad_leaf": max(grad, key=grad.get),
            "worst_change_leaf": max(change, key=change.get)}


def main(argv=None) -> int:
    a = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate_pose")
    a.add_argument("--workload", required=True)
    a.add_argument("--seeds", required=True)
    a.add_argument("--mode", default="sound")
    a.add_argument("--root", default=str(manifest.ROOT))
    a.add_argument("--device", default="cuda")
    args = a.parse_args(sys.argv[1:] if argv is None else argv)
    cell = manifest.cell(args.workload, Path(args.root))
    r = harness.Run(cell=cell, seed=0, seconds=0, trace=False,
                    t_start=time.time(), device=args.device)
    for seed in [int(s) for s in args.seeds.split(",")]:
        r.seed, t0 = seed, time.time()
        out = numbers(r, args.mode)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "seconds": time.time() - t0,
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
