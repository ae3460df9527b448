"""The fused physics kernel against its plain PyTorch version, env by env,
at the main path's shape (go1, rough terrain, 1800 envs) on the card.

    python -m legged_gym_tpu_torch.scripts.kernel_numerics

For a fresh reset, the state after the reset step and a settled state
(30 zero-action steps), it prints per output the max / 99th percentile /
median over envs of |kernel - plain| and the envs over tolerance, for the
kernel built with and without fused multiply-add contraction, and for the
plain version run on the CPU (the spread of the reference itself). Also
holds the helpers that chip_smoke.py uses.
"""
from __future__ import annotations

import torch

from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.physics import chain_kernel, chain_step

NAMES = ("pos", "quat", "vel", "q", "qd", "tau", "body_f")
# pos, quat, vel, q, qd, tau: the JAX package's kernel-vs-twin tolerance
# (tests/test_chain_engine.py:140-144)
STATE_ATOL = 5e-3
# body_f (N): sums of up to 9 point forces of order 1e2 N; float32 rounding
# in another order, amplified by the stiff implicit contact law, stays far
# below 0.5 N (0.1% of a foot's standing load); more means a contact
# switched state between the two
BODY_F_ATOL = 0.5
# a settled stance: rounding is amplified by the regularized friction
# (slope mu*f_n/slip_velocity) over the 4 sim dts, and qd of a few envs in
# 1800 moves by up to 3e-3 even between the plain version on the CPU and on
# the card; tau = kp (target - q) - kd_eff qd carries it (kd_eff ~2), so
# settled states are held at 2e-2 on qd and tau
SETTLED_ATOL = {"qd": 2e-2, "tau": 2e-2}


def rough_cfg(n=1800):
    """bench.py:26-32: go1, heightfield with curriculum, 235-dim
    observations with the height scan."""
    cfg, _ = registry.get_cfgs("go1")
    cfg.env.num_envs = n
    cfg.env.num_observations = 235
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.measure_heights = True
    cfg.terrain.curriculum = True
    return cfg


def kernel_args(env, state):
    """Kernel arguments for ``state``: default-pose targets and the cached
    contact window (the center crop of the state's terrain window)."""
    lo = (env.patch_cache_S - env.contact_patch_S) // 2
    hi = lo + env.contact_patch_S
    patch = (state.patch_T[lo:hi, lo:hi].contiguous(), state.patch_r0 + lo,
             state.patch_c0 + lo)
    targets = env._dflt.expand(env.num_dof, state.n)
    return env.chain_engine.level_args(state.physics, state.link_params,
                                       state.friction, targets, patch)


def tolerances(settled):
    tol = {name: STATE_ATOL for name in NAMES[:6]}
    tol["body_f"] = BODY_F_ATOL
    if settled:
        tol.update(SETTLED_ATOL)
    return tol


def per_env_errors(ref, out):
    """name -> (N,) max |ref - out| over each env's entries."""
    return {name: (r - o).abs().reshape(-1, r.shape[-1]).amax(0)
            for name, r, o in zip(NAMES, ref, out)}


def over_tolerance(errs, tol):
    """Indices of envs with any output over its tolerance."""
    bad = None
    for name, e in errs.items():
        b = e > tol[name]
        bad = b if bad is None else bad | b
    return torch.nonzero(bad).flatten().tolist()


def cuda_ms(fn, reps, warmup=2):
    """Mean ms per call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def count_flops(fn):
    """Floating-point operations of ``fn`` (the plain version) by aten op:
    one per output element of each elementwise arithmetic op (sqrt,
    division and sin / cos count as one), n - 1 per n-element sum.
    Indexing, stacking, copies and comparisons count nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "mul", "div", "neg", "sqrt", "rsqrt", "sin",
             "cos", "reciprocal", "clamp", "clamp_min", "clamp_max",
             "minimum", "maximum", "floor", "where", "atan2", "exp"}
    total = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in arith and isinstance(out, torch.Tensor) \
                    and out.is_floating_point():
                total[0] += out.numel()
            elif name == "sum" and isinstance(args[0], torch.Tensor):
                total[0] += args[0].numel() - out.numel()
            return out

    with Counter():
        fn()
    return total[0]


def _report(tag, ref, out, settled):
    errs = per_env_errors(ref, out)
    bad = over_tolerance(errs, tolerances(settled))
    stats = ", ".join(
        f"{n} {float(e.max()):.2e}/{float(e.quantile(0.99)):.2e}/"
        f"{float(e.median()):.2e}" for n, e in errs.items())
    print(f"{tag}: envs over tolerance {len(bad)} {bad[:8]} | "
          f"max/p99/median {stats}", flush=True)


def main():
    env, _ = registry.make_env(cfg=rough_cfg(), device="cuda")
    cc = env.chain_engine.cc
    cv = chain_step.const_tensors(cc, "cuda")
    table = torch.as_tensor(chain_kernel.const_table(cc), device="cuda")
    libs = {"no-fma": chain_kernel.load_library("cuda"),
            "fma": chain_kernel.load_library("cuda", numerics=())}
    state = env.initial_state()
    zeros = torch.zeros((env.num_envs, env.num_actions), device="cuda")
    for label, steps in (("fresh reset", 0), ("reset step", 1),
                         ("settled", 29)):
        for _ in range(steps):
            state, _ = env.step(state, zeros)
        args = kernel_args(env, state)
        settled = label == "settled"
        ref = chain_step.run_decimation_chain(cc, *args, cv=cv)
        ref_cpu = chain_step.run_decimation_chain(cc, *[a.cpu()
                                                        for a in args])
        _report(f"[{label}] plain on CPU vs card", [r.cpu() for r in ref],
                ref_cpu, settled)
        for name, lib in libs.items():
            out = chain_kernel.launch(lib, cc, args, table)
            torch.cuda.synchronize()
            _report(f"[{label}] kernel {name} vs plain", ref, out, settled)
            ms = cuda_ms(lambda: chain_kernel.launch(lib, cc, args, table),
                         50)
            print(f"[{label}] kernel {name}: {ms:.4f} ms/launch", flush=True)


if __name__ == "__main__":
    main()
