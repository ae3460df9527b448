"""The readings a cell's limits are set from, in one process on the card:
for each seed the program against the reference (the lower readings),
and on the seeds asked for the control (the reference in TF32, the
precision below the configuration's float32 with TF32 off) and the
planted faults (``half_batch``, ``few_envs``, ``reset_skipped``: see the
kind's ``reference``), each against the float32 reference. The program runs as
in a benchmark run's set-up (its checked steps, then freed), so these are
the numbers a run compares.

    python3 -m benchmark.calibrate --workload go1_rough.train \
        --seeds 11,12,13 --control 11,12,13 --faults half_batch:11,12,13 \
        --out calibrate_go1_rough.train.jsonl

One JSON line per reading, also appended to ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

from benchmark import run, seeds as bench_seeds, spec


def _ints(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control", type=_ints, default=[])
    ap.add_argument("--faults", action="append", default=[],
                    help="name:seed,seed,...")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.use_checkout_caches()
    import torch

    cell = spec.load_cell(args.workload)
    kind = importlib.import_module("benchmark.kinds." + cell.kind)
    steps = args.steps or int(cell.limits.get("checked_steps", 3))
    faults = {}
    for item in args.faults:
        name, seeds = item.split(":")
        for s in _ints(seeds):
            faults.setdefault(s, []).append(name)
    device = torch.device("cuda")
    from legged_gym_tpu_torch.physics import chain_kernel
    chain_kernel.BUILD_DIR = run.KERNEL_BUILD
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")

    for seed in args.seeds:
        seeds = bench_seeds.from_seed(seed)
        t0 = time.perf_counter()
        program = kind.Program(cell, seeds, device, steps)
        readings, model_weights = program.readings, program.weights
        program.free()
        del program
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref = kind.reference(cell, seeds, device, steps, model_weights,
                           readings)
        t2 = time.perf_counter()
        emit({"workload": cell.name, "seed": seed, "side": "program",
              "numbers": kind.compare(kind.program_side(readings), ref),
              "program_s": t1 - t0,
              "reference_s": t2 - t1})
        runs = [("control", {"precision": "tf32"})] * (seed in args.control)
        runs += [(f, {"fault": f}) for f in faults.get(seed, [])]
        for side, kw in runs:
            t3 = time.perf_counter()
            other = kind.reference(cell, seeds, device, steps, model_weights,
                                   readings, **kw)
            emit({"workload": cell.name, "seed": seed, "side": side,
                  "numbers": kind.compare(other, ref),
                  "seconds": time.perf_counter() - t3})
    print(f"[calibrate] {run.smi()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
