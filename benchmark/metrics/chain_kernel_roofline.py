"""Kernel layer (physics/chain_kernel.py + csrc/chain_step.cu): the least
time one launch could take over its mean device time in the traced
stretch, %. The least time is the larger of the launch's operations over
the card's float32 peak and its bytes over the HBM bandwidth, both from
the frozen work table (work/<name>.json) at the cell's env count. Silent
where no launch of the kernel ran."""


def read(bundle):
    trace, work = bundle.get("trace"), bundle.get("work")
    if not trace or not work:
        return None
    times = [d for r in trace["ranges"].values() for name, d in r["kernels"]
             if work["kernel"] in name]
    if not times:
        return None
    mean_s = 1e-6 * sum(times) / len(times)
    n, peaks = bundle["kernel_envs"], bundle["peaks"]
    ops = work["ops_per_env"] * n + work["ops_fixed"]
    least = max(ops / peaks["fp32_flops_per_s"],
                work["bytes_per_env"] * n / peaks["hbm_bytes_per_s"])
    return 100.0 * least / mean_s
