"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload go1_rough.train --seed 7 \
        --seconds 30 --trace 0

On the card only: without CUDA, or with fewer cards than the cell asks
for, it exits with 2 and prints no result. A run: set-up (imports, CUDA,
the env and runner, the cell's kernel library built or loaded under
build/kernels/, the checked first steps) is ``setup_s``; the window
measures for ``--seconds``; ``--trace 1`` times the window with the
program's own spans on and then profiles a short stretch for the
per-layer metrics. Then the peak memory is read, the program's state is
freed, and the reference follows the checked steps: ``correct`` is every
compared number within its limit (limits/<cell>.json). The numbers and
their limits are the last lines on standard error and the last key of
the result, the last line on standard output. A run in whose process
JAX or the JAX package is loaded once the window has closed exits with 3
and prints no result.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import seeds as bench_seeds, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "legged_gym_tpu")
CACHE = os.path.join(spec.ROOT, "build", "bench_cache")
KERNEL_BUILD = os.path.join(spec.ROOT, "build", "kernels")


def use_checkout_caches():
    """Every compile cache at a fixed directory inside the checkout, and no
    library that would load JAX by itself."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def smi():
    """The card's name, clocks, power draw, power limit and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def kernel_libraries():
    """(built by this process, loaded) library keys of the port's physics
    kernel."""
    from legged_gym_tpu_torch.physics import chain_kernel
    return (sorted(map(str, chain_kernel.build_log)),
            sorted(map(str, getattr(chain_kernel, "_libs", {}))))


def run_cell(workload, seed, seconds, trace, device="cuda", num_envs=None,
             checked=None, t0=None):
    """One run of a cell; returns the result dict. ``device`` "cpu", with
    ``num_envs`` and ``checked`` small, is the tests' rehearsal: it runs
    every stage and reports no device metric."""
    import torch

    t0 = _T0 if t0 is None else t0
    cell = spec.load_cell(workload)
    if num_envs is not None:
        cell.mix = {**cell.mix, "num_envs": int(num_envs)}
    kind = importlib.import_module("benchmark.kinds." + cell.kind)
    seeds = bench_seeds.from_seed(seed)
    steps = int(checked or cell.limits.get("checked_steps", 3))
    device = torch.device(device)
    on_card = device.type == "cuda"

    from legged_gym_tpu_torch.physics import chain_kernel
    chain_kernel.BUILD_DIR = KERNEL_BUILD
    program = kind.Program(cell, seeds, device, steps)
    if on_card:
        # the peak of the window: what set-up's recording of the checked
        # steps held on the card for a moment is not the program's
        torch.cuda.reset_peak_memory_stats(device)
        built, loaded = kernel_libraries()
        log(f"kernel libraries built here: {built or 'none'}; loaded: "
            f"{loaded}")
        log(f"card before the window: {smi()}")
    setup_s = time.perf_counter() - t0
    log(f"{workload}: set-up {setup_s:.3f} s, window {seconds} s, seed "
        f"{seed}, trace {int(trace)}")
    record = program.window(seconds, spans=bool(trace))
    if on_card:
        log(f"card after the window: {smi()}")
    bundle = {"cell": cell, "record": record, "peaks": spec.peaks(),
              "work": cell.work(), "kernel_envs": cell.num_envs,
              "flops_per_unit": program.flops_per_unit(), "trace": None,
              "units": {}}
    if trace:
        from benchmark.trace import Profile
        profile = Profile(device)
        bundle["units"] = program.trace(profile)
        bundle["trace"] = profile.result
    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    end_to_end = {**program.metrics(record), "setup_s": setup_s}
    attempted, failed = program.attempted(record)

    # the reference runs once the program's state is freed
    readings, model_weights = program.readings, program.weights
    program.free()
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = kind.reference(cell, seeds, device, steps, model_weights,
                           readings)
    numbers = kind.compare(kind.program_side(readings), ref)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s over {steps} "
        f"steps")
    limits = cell.limits.get("numbers", {})
    checks = {name: {"value": value,
                     "limit": limits.get(name, {}).get("limit")}
              for name, value in numbers.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    metrics = {}
    if on_card:
        chosen = cell.per_layer if trace else cell.end_to_end
        for m in chosen:
            if trace:
                value = spec.metric_reader(m["name"])(bundle)
            else:
                value = end_to_end.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        log("no card: no device metric is reported")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and bundle["trace"] is not None:
        dev["busy_s"] = bundle["trace"]["busy_s"]
        dev["window_s"] = bundle["trace"]["window_s"]
        result["breakdown"] = bundle["trace"]["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()
    import torch

    cell = spec.load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA card(s); this machine "
            f"has {have}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)} (JAX or the JAX "
            "package); no result")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
