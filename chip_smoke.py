"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. build the fused physics kernel (physics/csrc/chain_step.cu) with nvcc
     and print the build time and the assembler's register / stack report;
  2. hold the kernel against its plain PyTorch version on the card: go1 on
     rough terrain at 1800 envs, default-pose targets, the cached contact
     window, on a fresh reset and on a settled state (30 zero-action
     steps); time both with CUDA events and count the plain version's
     float operations for the bound;
  3. drive the main path: registry.make_env("go1", rough variant of
     bench.py, device="cuda"), a seeded ActorCritic sampling actions, 24-step
     rollouts (one PPO horizon); the kernel's launch count must equal the
     number of policy steps; obs / rewards finite; then the bench.py
     throughput (random normal actions) in env-steps/s;
  4. print the kernel table line, the card's name and power limit, and the
     result line.

Imports the port only (legged_gym_tpu_torch), never JAX.
"""
import json
import math
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
NUM_ENVS = 1800
HORIZON = 24            # one PPO rollout (RunnerCfg.num_steps_per_env)
ROLLOUTS = 3
BENCH_STEPS = 50        # bench.py: N_STEPS per timed call
BENCH_REPS = 2
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores


def fail(msg):
    print(f"CHIP SMOKE FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA card")
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.physics import chain_kernel, chain_step
    from legged_gym_tpu_torch.rl.networks import ActorCritic, sample_action
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    chain_kernel.load_library("cuda")
    print(f"phase 1: kernel built in {time.perf_counter() - t0:.1f} s "
          f"[{smi}]")
    for line in chain_kernel.build_log.get("cuda", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- phase 2: kernel vs plain version on the card ----
    env, _ = registry.make_env(cfg=kn.rough_cfg(NUM_ENVS), device=DEVICE)
    if env.num_envs != NUM_ENVS:
        fail(f"env simulates {env.num_envs} envs, not {NUM_ENVS}")
    cc = env.chain_engine.cc
    cv = chain_step.const_tensors(cc, DEVICE)
    table = torch.as_tensor(chain_kernel.const_table(cc), device=DEVICE)
    state = env.initial_state()
    zeros = torch.zeros((NUM_ENVS, env.num_actions), device=DEVICE)
    fresh_errs = None
    timings = {}
    for label, steps in (("fresh reset", 0), ("settled", 30)):
        for _ in range(steps):
            state, _ = env.step(state, zeros)
        args = kn.kernel_args(env, state)
        ref = chain_step.run_decimation_chain(cc, *args, cv=cv)
        out = chain_kernel.run_decimation_cuda(cc, *args, consts=table)
        torch.cuda.synchronize()
        for name, r, o in zip(kn.NAMES, ref, out):
            if tuple(r.shape) != tuple(o.shape):
                fail(f"{name}: kernel shape {tuple(o.shape)}, plain "
                     f"{tuple(r.shape)}")
            if not torch.isfinite(o).all():
                fail(f"{name}: kernel output not finite ({label})")
        errs = {k: float(v.max())
                for k, v in kn.per_env_errors(ref, out).items()}
        tol = kn.tolerances(settled=steps > 0)
        print(f"phase 2 [{label}]: max |kernel - plain| "
              + ", ".join(f"{k} {v:.3e} (tol {tol[k]:g})"
                          for k, v in errs.items()) + f" [{smi}]")
        for name, v in errs.items():
            if not v <= tol[name]:
                fail(f"{name} differs by {v:.3e} > {tol[name]} ({label})")
        if fresh_errs is None:
            fresh_errs = errs
        timings[label] = (
            kn.cuda_ms(lambda: chain_kernel.run_decimation_cuda(
                cc, *args, consts=table), reps=50),
            kn.cuda_ms(lambda: chain_step.run_decimation_chain(
                cc, *args, cv=cv), reps=3, warmup=1))
        print(f"phase 2 [{label}]: kernel {timings[label][0]:.4f} ms/launch,"
              f" plain version {timings[label][1]:.3f} ms/call [{smi}]")
    flops = kn.count_flops(lambda: chain_step.run_decimation_chain(
        cc, *args, cv=cv))
    in_bytes = sum(t.numel() * t.element_size() for t in args) \
        + table.numel() * table.element_size()
    out_bytes = sum(o.numel() * o.element_size() for o in out)
    bytes_ms = 1e3 * (in_bytes + out_bytes) / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / FP32_FLOPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    kernel_ms, plain_ms = timings["settled"]
    print(f"phase 2: bound {bound_ms:.4f} ms: {in_bytes + out_bytes} bytes "
          f"-> {bytes_ms:.4f} ms, {flops} fp32 ops -> {ops_ms:.4f} ms "
          f"({bound_by}); kernel at {100 * bound_ms / kernel_ms:.2f}% of "
          f"the bound [{smi}]")

    # ---- phase 3: the main path ----
    env, _ = registry.make_env("go1", cfg=kn.rough_cfg(NUM_ENVS), seed=0,
                               device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    policy = ActorCritic(env.obs_dim, env.num_actions,
                         generator=torch.Generator().manual_seed(0)).to(DEVICE)
    chain_kernel.run_decimation_cuda.launches = 0
    steps = 0
    all_done_steps = 0
    with torch.inference_mode():
        state, obs = env.reset()
        steps += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ROLLOUTS):
            for _ in range(HORIZON):
                action, logp, _, _ = sample_action(policy, obs, gen)
                state, tr = env.step(state, action)
                obs = tr.obs
                steps += 1
                all_done_steps += int(tr.done.all())
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - t0
    launches = chain_kernel.run_decimation_cuda.launches
    if launches != steps:
        fail(f"kernel launched {launches} times in {steps} policy steps")
    if tuple(obs.shape) != (NUM_ENVS, env.obs_dim):
        fail(f"obs shape {tuple(obs.shape)}")
    if not (torch.isfinite(obs).all() and torch.isfinite(tr.reward).all()
            and torch.isfinite(logp).all()):
        fail("non-finite obs, reward or log-prob")
    if all_done_steps:
        fail(f"every env terminated in {all_done_steps} steps")
    z = state.physics.pos[2] - state.env_origin[2]
    policy_sps = NUM_ENVS * ROLLOUTS * HORIZON / rollout_s
    print(f"phase 3: {steps} policy steps, {launches} kernel launches; "
          f"reward mean {float(tr.reward.mean()):.4f}, base height over "
          f"origin mean {float(z.mean()):.3f} m; rollout with policy "
          f"{policy_sps:.0f} env-steps/s [{smi}]")

    with torch.inference_mode():
        def bench_call():
            nonlocal state
            for _ in range(BENCH_STEPS):
                a = torch.randn((NUM_ENVS, env.num_actions), generator=gen,
                                device=DEVICE)
                state, tr_ = env.step(state, a)
            return tr_.reward.mean()

        float(bench_call())
        best = 0.0
        for _ in range(BENCH_REPS):
            t0 = time.perf_counter()
            float(bench_call())
            best = max(best, NUM_ENVS * BENCH_STEPS
                       / (time.perf_counter() - t0))
    print(f"phase 3: bench.py throughput {best:.0f} env-steps/s "
          f"(go1 rough, {NUM_ENVS} envs, random actions) [{smi}]")

    # ---- phase 4: kernel table, card, result ----
    if not all(math.isfinite(v) for v in (kernel_ms, plain_ms, bound_ms)):
        fail("non-finite timing")
    line = {"kernels": [{
        "name": "run_decimation_cuda",
        "route": "cuda",
        "source": "legged_gym_tpu_torch/physics/csrc/chain_step.cu",
        "replaces": "legged_gym_tpu/physics/pallas_step.py:67",
        "launches": launches,
        "max_abs_err": max(fresh_errs[n] for n in kn.NAMES[:6]),
        "body_f_max_abs_err": fresh_errs["body_f"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
