"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. build the fused physics kernel (physics/csrc/chain_step.cu) with nvcc,
     one library per robot layout (go1, aliengo, cassie, anymal_c, a1) and
     lane count per env (G_LANES 16 and 8), all compilers started
     together; print the build time, each build's shared memory per env
     and the assembler's register / stack / spill report, and the G_LANES
     each main path's launch takes (chain_kernel.launch_library);
  2. hold each kernel variant against its plain PyTorch version on the
     card, on a fresh reset and on a settled state (30 zero-action steps),
     time both with CUDA events (the kernel through the wrapper, which is
     the kernels line's ms, and alone, relaunched on buffers prepared
     once) and count the plain version's float operations for the bound,
     printed as the bound's share of the kernel's time:
       K1 — go1 on rough terrain at 1800 envs;
       K4 — aliengo at its own 4096 envs with warm-start friction anchors,
            anchors compared too;
       K2 — cassie (6 levels x 2 chains) at its own 4096 envs on trimesh
            10 x 20 with the wall rule, and once more (untimed) with the
            plane re-sampled every sim dt;
       K3 — anymal_c_rough at its own 4096 envs on trimesh: one SEA segment
            (one sim dt, 4 substeps) of held torques with friction anchors
            and the wall rule;
     all through chain_kernel.run_decimation, which counts launches per
     variant; the settled K2 / K3 states must have robots in contact and
     contacts that the wall rule changes; and K1 on a1's layout (no hip
     contact points) against plain, untimed;
  3. drive the rollout path: registry.make_env("go1", rough variant of
     bench.py, device="cuda"), a seeded ActorCritic sampling actions, one
     24-step rollout (one PPO horizon); the kernel's launch count must
     equal the number of policy steps; obs / rewards finite; then the
     bench.py throughput (random normal actions) in env-steps/s;
  4. drive the training path: registry.make_runner on the 1800-env rough
     go1 env, runner.learn(3, init_at_random_ep_len=True) at the full
     512-256-128 width (24 steps, 5 x 4 minibatches), K1 launches counted;
     then the same for aliengo (K4), cassie (K2) and anymal_c_rough (K3,
     four launches per policy step with the actuator LSTM between) at 4096
     envs, 2 iterations each, the variant's launches counted and every
     other variant's held at zero. Metrics finite, lr in [1e-5, 1e-2], actor and critic
     changed, a save / load round trip restores weights, moments and
     iteration; prints policy-steps/s (24 x num_envs x iterations / wall,
     synced) and the rollout / update split of an iteration;
  5. print the kernel table line, the card's name and power limit, and the
     result line.

Imports the port only (legged_gym_tpu_torch), never JAX.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

DEVICE = "cuda"
GO1_ENVS = 1800
ALIENGO_ENVS = 4096
TASK_ENVS = 4096        # cassie, anymal_c_rough, a1 as registered
HORIZON = 24            # one PPO rollout (RunnerCfg.num_steps_per_env)
BENCH_STEPS = 50        # bench.py: N_STEPS per timed call
GO1_TRAIN_ITERS = 3
ALIENGO_TRAIN_ITERS = 2
CASSIE_TRAIN_ITERS = 2
ANYMAL_TRAIN_ITERS = 2
ANCHOR_DIFF_MAX = 0     # anchor entries allowed to differ in live / sentinel
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores


def fail(msg):
    print(f"CHIP SMOKE FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check_kernel(tag, env, smi, variant, timed=True, switch_share=0.0,
                 **flags):
    """Phase 2 for one kernel variant: compare with the plain version on a
    fresh reset and a settled state, time both, compute the bound. Returns
    the measured part of the kernel's table entry (None when untimed).
    ``switch_share``: on the stiff trimesh paths, where float32 rounding in
    another order flips a contact in a few settled envs, a settled env
    passes when it is within tolerance of the plain version on the card or
    of the plain version on the CPU, and this share of the envs may fail
    both (kernel_numerics.SWITCH_ENVS_SHARE states the measurements); the
    fresh state is held against the card's plain version in full.
    ``flags`` replace fields of the env's step constants."""
    import dataclasses

    from legged_gym_tpu_torch.physics import chain_kernel, chain_step
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    n = env.num_envs
    cc = dataclasses.replace(kn.step_consts(env), **flags)
    anchored = env._warm_start
    if chain_step.variant(cc, anchored) != variant:
        fail(f"{tag}: the env's step is variant "
             f"{chain_step.variant(cc, anchored)}, not {variant}")
    cv = chain_step.const_tensors(cc, DEVICE)
    table = torch.as_tensor(chain_kernel.const_table(cc), device=DEVICE)
    lib = chain_kernel.launch_library(chain_kernel.model_layout(cc.cm), n,
                                      anchored)
    state = env.initial_state()
    zeros = torch.zeros((n, env.num_actions), device=DEVICE)

    def plain(args, anchors):
        return chain_step.run_decimation_chain(cc, *args, cv=cv,
                                               anchors=anchors)

    def kernel(args, anchors):
        return chain_kernel.run_decimation(cc, *args, anchors=anchors,
                                           consts=table)

    fresh_errs = None
    anchor_err = None
    timings = {}
    for label, steps in (("fresh reset", 0), ("settled", 30)):
        for _ in range(steps):
            state, _ = env.step(state, zeros)
        args = kn.kernel_args(env, state)
        anchors = state.contact_ws if anchored else None
        if anchored and anchors is None:
            fail(f"{tag}: the env carries no anchors")
        ref = plain(args, anchors)
        counted = chain_kernel.launches[variant]
        out = kernel(args, anchors)
        torch.cuda.synchronize()
        if chain_kernel.launches[variant] != counted + 1:
            fail(f"{tag}: the launch was not counted on {variant}")
        if len(ref) != len(out):
            fail(f"{tag}: kernel returns {len(out)} outputs, plain "
                 f"{len(ref)}")
        for name, r, o in zip(kn.NAMES + ("anchors",), ref, out):
            if tuple(r.shape) != tuple(o.shape):
                fail(f"{tag} {name}: kernel shape {tuple(o.shape)}, plain "
                     f"{tuple(r.shape)}")
            if not torch.isfinite(o).all():
                fail(f"{tag} {name}: kernel output not finite ({label})")
        settled = steps > 0
        errs = {k: float(v.max())
                for k, v in kn.per_env_errors(ref, out).items()}
        tol = kn.tolerances(settled)
        print(f"phase 2 {tag} [{label}]: max |kernel - plain| "
              + ", ".join(f"{k} {v:.3e} (tol {tol[k]:g})"
                          for k, v in errs.items()) + f" [{smi}]")
        over = kn.envs_over(ref, out, settled)
        allowed = 0
        if settled and switch_share:
            allowed = int(switch_share * n)
            ref_cpu = kn.plain_on_cpu(cc, args, anchors)
            spread = kn.envs_over(ref_cpu, [r.cpu() for r in ref], settled)
            in_contact = int(kn.contact_envs(ref).sum())
            walled = kn.wall_rule_envs(cc, cv, args)
            print(f"phase 2 {tag} [{label}]: {in_contact} of {n} envs in "
                  f"contact, {int(walled.sum())} where the wall rule "
                  f"changes a contact; over a tolerance: kernel vs plain "
                  f"on the card {len(over)} envs, plain on the CPU vs "
                  f"plain on the card {len(spread)} envs [{smi}]")
            if in_contact < n // 4 or int(walled.sum()) < 10:
                fail(f"{tag}: the settled state does not exercise contact "
                     f"on steep cells")
            over = kn.envs_over(ref, out, settled, ref_cpu)
            print(f"phase 2 {tag} [{label}]: kernel over a tolerance "
                  f"against both plain runs in {len(over)} envs "
                  f"({int(walled.cpu()[over].sum())} of them wall-rule "
                  f"envs; allowed {allowed}) [{smi}]")
        if len(over) > allowed:
            fail(f"{tag}: {len(over)} envs over a tolerance, {allowed} "
                 f"allowed ({label}): {errs}")
        if anchored:
            a_in_live = int((anchors < kn.ANCHOR_LIVE).sum())
            err, n_live, n_diff = kn.anchor_errors(ref[7], out[7])
            print(f"phase 2 {tag} [{label}]: anchors in: {a_in_live} of "
                  f"{anchors.numel()} entries live; out: {n_live} live in "
                  f"both, {n_diff} differ in live / sentinel state "
                  f"(allowed {ANCHOR_DIFF_MAX}); max |kernel - plain| "
                  f"{err:.3e} m (tol {kn.ANCHOR_ATOL:g}) [{smi}]")
            if n_diff > ANCHOR_DIFF_MAX:
                fail(f"{tag}: {n_diff} anchor entries differ in live / "
                     f"sentinel state ({label})")
            if not err <= kn.ANCHOR_ATOL:
                fail(f"{tag}: anchors differ by {err:.3e} m ({label})")
            if steps > 0 and a_in_live < 0.9 * anchors.numel():
                fail(f"{tag}: the settled state carries mostly sentinel "
                     f"anchors: the anchored law is not exercised")
            anchor_err = err if anchor_err is None else max(anchor_err, err)
        if fresh_errs is None:
            fresh_errs = errs
        if not timed:
            continue
        go, _ = chain_kernel.bind_launch(lib, cc, args, table, anchors)
        timings[label] = (
            kn.cuda_ms(lambda: kernel(args, anchors), reps=50),
            kn.cuda_ms(lambda: plain(args, anchors), reps=2, warmup=1),
            kn.cuda_ms(go, reps=200))
        print(f"phase 2 {tag} [{label}]: kernel {timings[label][0]:.4f} "
              f"ms/launch through the wrapper ({timings[label][2]:.4f} "
              f"alone, on buffers prepared once), plain version "
              f"{timings[label][1]:.3f} ms/call [{smi}]")
    if not timed:
        return None
    flops = kn.count_flops(lambda: plain(args, anchors))
    moved = [a for i, a in enumerate(args) if i != 4] + [table] + list(out)
    if anchored:
        moved.append(anchors)
    n_bytes = kn.launch_bytes(cc, moved)
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / FP32_FLOPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    kernel_ms, plain_ms, alone_ms = timings["settled"]
    print(f"phase 2 {tag}: bound {bound_ms:.4f} ms: {n_bytes} bytes -> "
          f"{bytes_ms:.4f} ms, {flops} fp32 ops -> {ops_ms:.4f} ms "
          f"({bound_by}); the bound is {100 * bound_ms / kernel_ms:.2f}% of "
          f"the kernel's time through the wrapper, "
          f"{100 * bound_ms / alone_ms:.2f}% of its time alone [{smi}]")
    if not all(math.isfinite(v)
               for v in (kernel_ms, plain_ms, alone_ms, bound_ms)):
        fail(f"{tag}: non-finite timing")
    entry = {
        "max_abs_err": max(fresh_errs[k] for k in kn.NAMES[:6]),
        "body_f_max_abs_err": fresh_errs["body_f"],
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}
    if anchored:
        entry["anchors_max_abs_err"] = anchor_err
    return entry


def train_path(tag, env, task, iterations, variant, smi, per_step=1):
    """Phase 4 for one task: a few PPO iterations through
    registry.make_runner, ``per_step`` launches counted on ``variant``
    per policy step and none on any other; returns the launch count."""
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.physics import chain_kernel

    n = env.num_envs
    _, tcfg = registry.get_cfgs(task)
    if list(tcfg.policy.actor_hidden_dims) != [512, 256, 128] \
            or tcfg.runner.num_steps_per_env != HORIZON \
            or (tcfg.algorithm.num_learning_epochs,
                tcfg.algorithm.num_mini_batches) != (5, 4):
        fail(f"{tag}: the training config is not the full-width one")
    runner, _ = registry.make_runner(env, train_cfg=tcfg, log_root=None)
    runner.learn_fn.profile = True
    model = runner.train_state.model
    before = [p.detach().clone() for p in model.parameters()]
    for name in chain_kernel.launches:
        chain_kernel.launches[name] = 0
    runner.learn(iterations, init_at_random_ep_len=True)
    torch.cuda.synchronize()
    counts = dict(chain_kernel.launches)
    launches = counts[variant]
    steps = 1 + iterations * HORIZON          # the reset step + rollouts
    if launches != per_step * steps:
        fail(f"{tag}: kernel {variant} launched {launches} times in {steps} "
             f"policy steps, {per_step} expected per step")
    for name, count in counts.items():
        if name != variant and count:
            fail(f"{tag}: kernel variant {name} was launched {count} "
                 f"times on {variant}'s path")
    m = runner.last_metrics
    flat = [v for v in m.values() if isinstance(v, float)]
    flat += list(m["episode"].values())
    if not all(math.isfinite(v) for v in flat):
        fail(f"{tag}: non-finite metric in {m}")
    if not 0.99e-5 <= m["lr"] <= 1e-2:
        fail(f"{tag}: lr {m['lr']} outside [1e-5, 1e-2]")
    if runner.current_iteration != iterations:
        fail(f"{tag}: iteration counter {runner.current_iteration}")
    names = [k for k, _ in model.named_parameters()]
    moved = {k: float((p.detach() - b).abs().max())
             for k, p, b in zip(names, model.parameters(), before)}
    if not (any(v > 0 for k, v in moved.items() if k.startswith("actor"))
            and any(v > 0 for k, v in moved.items()
                    if k.startswith("critic"))):
        fail(f"{tag}: weights did not change: {moved}")

    # save / load round trip into a second runner
    ts = runner.train_state
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"model_{iterations}.ckpt")
        runner.save(path)
        other_runner, _ = registry.make_runner(env, train_cfg=tcfg,
                                               log_root=None)
        other_runner.load(path)
    ts2 = other_runner.train_state
    same = all(torch.equal(a.detach(), b.detach())
               for a, b in zip(ts.params, ts2.params))
    same &= all(torch.equal(a, b) for a, b in zip(
        ts.opt_state.mu + ts.opt_state.nu,
        ts2.opt_state.mu + ts2.opt_state.nu))
    if not (same and ts2.opt_state.count == ts.opt_state.count
            == iterations * 20
            and other_runner.current_iteration == iterations
            and float(ts2.lr) == float(ts.lr)):
        fail(f"{tag}: save / load did not restore the train state")

    # steady-state throughput: a second, timed call (learn() ends by
    # fetching its last metrics, so the wall time is synced)
    runner.learn_fn.times.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.learn(iterations)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rollout_s = sum(t["rollout_s"] for t in runner.learn_fn.times)
    update_s = sum(t["update_s"] for t in runner.learn_fn.times)
    print(f"phase 4 {tag}: {iterations} iterations, {launches} {variant} "
          f"launches in {steps} policy steps; reward/step "
          f"{m['mean_step_reward']:.5f}, kl {m['kl']:.4f}, lr "
          f"{m['lr']:.2e}, noise std {m['noise_std']:.3f}; save / load "
          f"round trip ok [{smi}]")
    print(f"phase 4 {tag}: train {HORIZON * n * iterations / wall:.0f} "
          f"policy-steps/s ({n} envs, {iterations} timed iterations, "
          f"{wall / iterations:.3f} s each: rollout "
          f"{rollout_s / iterations:.3f} s, update "
          f"{update_s / iterations:.3f} s) [{smi}]")
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA card")
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.physics import chain_kernel
    from legged_gym_tpu_torch.rl.networks import ActorCritic, sample_action
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- phase 1: build, one library per layout, compilers in parallel ----
    go1_env, _ = registry.make_env(cfg=kn.rough_cfg(GO1_ENVS), device=DEVICE)
    ali_env, _ = registry.make_env("aliengo", device=DEVICE)
    cas_env, _ = registry.make_env("cassie", device=DEVICE)
    any_env, _ = registry.make_env("anymal_c_rough", device=DEVICE)
    a1_env, _ = registry.make_env("a1", device=DEVICE)
    if (go1_env.num_envs, ali_env.num_envs) != (GO1_ENVS, ALIENGO_ENVS):
        fail(f"envs simulate {go1_env.num_envs} and {ali_env.num_envs} envs")
    for e in (cas_env, any_env, a1_env):
        if e.num_envs != TASK_ENVS:
            fail(f"{e.cfg.asset.name} simulates {e.num_envs} envs")
    for e in (cas_env, any_env):
        if e.cfg.terrain.mesh_type != "trimesh" or e.grid.wall_thresh <= 0 \
                or (e.cfg.terrain.num_rows, e.cfg.terrain.num_cols) \
                != (10, 20):
            fail(f"{e.cfg.asset.name} is not on the 10 x 20 trimesh")
    layouts = [chain_kernel.model_layout(e.chain_engine.cm)
               for e in (go1_env, ali_env, cas_env, any_env, a1_env)]
    if len(set(layouts)) != len(layouts):
        fail(f"two robots share one layout: {layouts}")
    builds = [(layout, g) for layout in layouts
              for g in chain_kernel.LANE_CHOICES]
    t0 = time.perf_counter()
    libs = chain_kernel.build_libraries([b[0] for b in builds],
                                        lanes=[b[1] for b in builds])
    print(f"phase 1: {len(builds)} kernel libraries ({len(layouts)} "
          f"layouts {layouts} x G_LANES {chain_kernel.LANE_CHOICES}) built "
          f"in {time.perf_counter() - t0:.1f} s [{smi}]")
    for (layout, g), lib in zip(builds, libs):
        lay = chain_kernel.library_layout(lib)
        print(f"  {layout} G_LANES {lay['G_LANES']}: "
              f"{lay['SHARED_PER_ENV']} bytes of shared memory per env")
        log = chain_kernel.build_log.get(chain_kernel.library_key(
            "cuda", chain_kernel.CUDA_NUMERICS, layout, g), "")
        for line in kn.ptxas_report(log):
            print(f"    ptxas: {line}")
    for e, layout in zip((go1_env, ali_env, cas_env, any_env, a1_env),
                         layouts):
        n, warm = e.num_envs, e._warm_start
        fits = {g: chain_kernel.library_fit(chain_kernel.load_library(
            layout=layout, lanes=g), n, warm)
            for g in chain_kernel.LANE_CHOICES}
        g = chain_kernel.library_layout(chain_kernel.launch_library(
            layout, n, warm))["G_LANES"]
        print(f"  {e.cfg.asset.name} at {n} envs: G_LANES {g} (warps "
              f"started / held at once: " + ", ".join(
                  f"G {k} {a} / {b}" for k, (a, b) in fits.items())
              + ")")

    # ---- phase 2: each kernel variant vs its plain version ----
    entry_k1 = check_kernel("K1 go1 rough 1800", go1_env, smi, "K1")
    entry_k4 = check_kernel("K4 aliengo 4096", ali_env, smi, "K4")
    entry_k2 = check_kernel("K2 cassie trimesh 4096", cas_env, smi, "K2",
                            switch_share=kn.SWITCH_ENVS_SHARE)
    check_kernel("K2 cassie, plane per sim dt", cas_env, smi, "K2",
                 timed=False, switch_share=kn.SWITCH_ENVS_SHARE,
                 plane_per_step=False)
    entry_k3 = check_kernel("K3+K4+wall anymal_c_rough 4096", any_env, smi,
                            "K3", switch_share=kn.SWITCH_ENVS_SHARE)
    check_kernel("K1 a1 layout 4096", a1_env, smi, "K1", timed=False)
    del a1_env

    # ---- phase 3: the rollout path ----
    env, _ = registry.make_env("go1", cfg=kn.rough_cfg(GO1_ENVS), seed=0,
                               device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    policy = ActorCritic(env.obs_dim, env.num_actions,
                         generator=torch.Generator().manual_seed(0)).to(DEVICE)
    for name in chain_kernel.launches:
        chain_kernel.launches[name] = 0
    steps = 0
    all_done_steps = 0
    with torch.no_grad():
        state, obs = env.reset()
        steps += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HORIZON):
            action, logp, _, _ = sample_action(policy, obs, gen)
            state, tr = env.step(state, action)
            obs = tr.obs
            steps += 1
            all_done_steps += int(tr.done.all())
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - t0
    rollout_launches = chain_kernel.launches["K1"]
    if sum(chain_kernel.launches.values()) != rollout_launches \
            or rollout_launches != steps:
        fail(f"kernel launches {chain_kernel.launches} in {steps} policy "
             f"steps of the K1 path")
    if tuple(obs.shape) != (GO1_ENVS, env.obs_dim):
        fail(f"obs shape {tuple(obs.shape)}")
    if not (torch.isfinite(obs).all() and torch.isfinite(tr.reward).all()
            and torch.isfinite(logp).all()):
        fail("non-finite obs, reward or log-prob")
    if all_done_steps:
        fail(f"every env terminated in {all_done_steps} steps")
    z = state.physics.pos[2] - state.env_origin[2]
    policy_sps = GO1_ENVS * HORIZON / rollout_s
    print(f"phase 3: {steps} policy steps, {rollout_launches} kernel "
          f"launches; reward mean {float(tr.reward.mean()):.4f}, base "
          f"height over origin mean {float(z.mean()):.3f} m; rollout with "
          f"policy {policy_sps:.0f} env-steps/s [{smi}]")

    with torch.no_grad():
        def bench_call():
            nonlocal state
            for _ in range(BENCH_STEPS):
                a = torch.randn((GO1_ENVS, env.num_actions), generator=gen,
                                device=DEVICE)
                state, tr_ = env.step(state, a)
            return tr_.reward.mean()

        float(bench_call())
        t0 = time.perf_counter()
        float(bench_call())
        sps = GO1_ENVS * BENCH_STEPS / (time.perf_counter() - t0)
    print(f"phase 3: bench.py throughput {sps:.0f} env-steps/s "
          f"(go1 rough, {GO1_ENVS} envs, random actions) [{smi}]")

    # ---- phase 4: the training path, go1 rough then aliengo ----
    k1_train = train_path("go1 rough 1800", env, "go1", GO1_TRAIN_ITERS,
                          "K1", smi)
    k4_train = train_path("aliengo 4096", ali_env, "aliengo",
                          ALIENGO_TRAIN_ITERS, "K4", smi)
    k2_train = train_path("cassie 4096", cas_env, "cassie",
                          CASSIE_TRAIN_ITERS, "K2", smi)
    k3_train = train_path("anymal_c_rough 4096", any_env, "anymal_c_rough",
                          ANYMAL_TRAIN_ITERS, "K3", smi,
                          per_step=any_env.cfg.control.decimation)

    # ---- phase 5: kernel table, card, result ----
    line = {"kernels": [
        dict({"name": "run_decimation (K1)",
              "route": "cuda",
              "source": "legged_gym_tpu_torch/physics/csrc/chain_step.cu",
              "replaces": "legged_gym_tpu/physics/pallas_step.py:67",
              "config": "K1",
              "launches": rollout_launches + k1_train,
              "launches_rollout": rollout_launches,
              "launches_train": k1_train}, **entry_k1),
        dict({"name": "run_decimation (K4)",
              "route": "cuda",
              "source": "legged_gym_tpu_torch/physics/csrc/chain_step.cu",
              "replaces": "legged_gym_tpu/physics/pallas_step.py:67",
              "config": "K4",
              "launches": k4_train,
              "launches_train": k4_train}, **entry_k4),
        dict({"name": "run_decimation (K2)",
              "route": "cuda",
              "source": "legged_gym_tpu_torch/physics/csrc/chain_step.cu",
              "replaces": "legged_gym_tpu/physics/pallas_step.py:67",
              "config": "K2",
              "launches": k2_train,
              "launches_train": k2_train}, **entry_k2),
        dict({"name": "run_decimation (K3)",
              "route": "cuda",
              "source": "legged_gym_tpu_torch/physics/csrc/chain_step.cu",
              "replaces": "legged_gym_tpu/physics/pallas_step.py:67",
              "config": "K3",
              "launches": k3_train,
              "launches_train": k3_train}, **entry_k3)]}
    for k in line["kernels"]:
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on the main path")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
