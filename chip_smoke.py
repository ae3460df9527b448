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
     other variant's held at zero; anymal_c_rough then steps 4 more times
     under torch.profiler, its physics a replay of its CUDA graph, and
     the trace must hold four chain_step_kernel launches a step, as many
     as the counter adds. Metrics finite, lr in [1e-5, 1e-2], actor and critic
     changed, a save / load round trip restores weights, moments and
     iteration; prints policy-steps/s (24 x num_envs x iterations / wall,
     synced) and the rollout / update split of an iteration;
  5. the general stacked engine (physics/engine.py, plain torch ops):
     (a) with ``use_chain_engine=False``, 30 zero-action steps on the
         general engine, then the general engine held against the kernel
         with the plane re-sampled per sim dt (the general engine's
         semantics) from that settled state, with phase 2's settled
         tolerances and its contact-flip rule (an env passes within
         tolerance of the general engine on the card or on the CPU;
         kernel_numerics.SWITCH_ENVS_SHARE of the envs may fail both);
         both timed with CUDA events:
           go1 rough at 1800 envs, P drive, one policy step against K2;
           anymal_c_rough at its own 4096 envs on trimesh with friction
           anchors (compared too) and the wall rule, one SEA segment (one
           sim dt, the net's torque held over it, as in phase 2) against
           K3, at one substep per sim dt: at its registered four the
           kernel holds each point's tangent plane over the sim dt's
           substeps while the general engine samples the surface every
           substep, two laws on rough terrain; at one they are one law;
     (b) anymal_c_flat as registered (4096 envs, 150 self-collision pairs,
         SEA LSTM, friction anchors) trains through registry.make_runner,
         1 warm and 1 timed iteration at its registered 128-64-32 width,
         with every kernel variant's launch count held at zero; then six
         steps of wide random actions and that state's self-contact
         forces on the card against the same call on the CPU; then two
         rollout steps under torch.profiler: device launches, busy time
         and host-to-device copies per policy step (and the same for go1
         rough's chain path, for the copies);
     (c) go1 as registered (4096 envs on the plane) with the V drive, the
         T drive, an applied UniNet and body damping: each builds on the
         card, takes the general engine, resets and steps twice with
         finite observations, the second step timed;
  6. the MPC planners (legged_gym_tpu_torch/mpc), each phase's wall time
     printed:
     (a) go1 as bench_mpc.py builds it (1 env, trimesh 4 x 4 with
         curriculum, 235-dim obs, noise and pushes off), settled with 25
         zero-action steps: one MPC policy step at K = 8192 on the
         planner's tiled inputs (the shared contact window tiled over K)
         through K2 with go1's layout and the wall rule, against the plain
         version on the card and on the CPU under phase 2's settled rule,
         from that stance and from a stance on a stair riser (at least 10
         envs where the wall rule changes a contact), the second timed,
         with its bound; MPPI at K = 8192, H = 16, one warm and 5
         timed solves (solves/s, rollout-steps/s, 16 K2 launches per solve,
         no other variant); CEM (5 iterations, 5% elites), the MPPI, CEM
         and zero plans under one common evaluator and bench_mpc.py's gate;
         one MPPI solve under torch.profiler (launches, busy, idle share);
         the evaluator's one-env K2 step against its plain version;
     (b) aliengo on its plane, settled: one MPPI solve at K = 4096, H = 16
         from the env's current friction anchors tiled over K: 16 K4
         launches, finite costs;
     (c) GradientMPC on go1 heightfield (tests/test_mpc.py's slow config),
         cut to H = 4 and 2 Adam iterations: the plain chain step
         differentiated on the card, no kernel launch, a finite non-zero
         gradient, time per iteration;
  7. go1 rough at 1800 envs with the recurrent policy (LSTM 512, one
     layer) and the asymmetric critic (249 privileged observations) trains
     through registry.make_runner, 2 warm and 2 timed iterations, K1
     launches counted as in phase 4 (one more policy step for the
     privileged pack), the LSTMs changed, save / load exact; the stateful
     inference policy restarts from a zero carry after reset_memory();
  8. scripts.play.play (50 steps, 25 envs) on the card from phase 4's and
     phase 7's checkpoints under a temporary log root: K1 launches, the
     exported .npz has the JAX package's key set and, evaluated by a plain
     numpy function, gives the inference policy's actions within 1e-5;
     then teleop's env (1 env): set_commands(0.5, 0.0, 0.2) and 25 policy
     steps keep the commands; a K1 step at play's 25 envs and at
     teleop's 1 env held against the plain version under phase 2's
     settled rule;
  9. the env axis split over ranks (legged_gym_tpu_torch/parallel), each
     sub-phase's wall time printed:
     (a) go1 rough at 1800 global envs on 2 ranks of a gloo group on the
         one card (900 each), through registry.make_env(mesh=) and
         PPORunner on that env, spawned by parallel.run_ranks: 1 + 1
         iterations (the second timed with the all-reduces' host time),
         1 + 48 K1 launches per rank, the ranks' parameters equal; first
         the actor's rows at 1800 against the same rows in two parts of
         900 are printed: they need not agree to the bit, and Adam's first
         step moves a parameter whose gradient is zero up to rounding by a
         rounding-decided amount, so the whole run's drift from the
         unsharded run of the same seed is printed and the two halves are
         held apart: each rank's env replayed with the unsharded rollout's
         actions against its envs of it (STATE_ATOL per env, the flip
         share of phase 2), and each rank's update of the second
         iteration from the unsharded checkpoint on the unsharded batch
         at tests/test_sharding.py's tolerances (loss 1e-4 relative,
         parameters 1e-4); K1 at 900 envs held against its plain version
         (phase 2's settled rule) and timed with its bound;
     (b) one rank of an NCCL group: its initial observations and
         parameters equal the unsharded run's to the bit (the actor's
         rows on them, in the rank and again in the parent on a copy,
         printed); its own first iteration against the unsharded one:
         the rollout per env under phase 2's flip rule, the update at
         (a)'s tolerances; the replay and the second update held as in
         (a);
     (c) MPPI at K = 8192 (4096 per rank) and one CEM solve over the two
         ranks from phase 6's planner stance against the unsharded plans
         (rtol 2e-4, atol 2e-5), 16 K2 launches per rank per MPPI solve,
         the MPPI solve timed on 2 ranks and unsharded; K2 at 4096
         candidates of go1's layout from phase 6's riser stance held
         against its plain version (walled floor) and timed;
     (d) scripts.bench_scaling at 1 and 2 ranks (go1, 4096 envs);
     (e) the general tree: a model with a prismatic joint and the hopper
         with the explicit spring law, 3 general-engine sim dts on the card
         against the CPU;
 10. print the kernel table line (launch counts of phases 3-9), the card's
     wall time for the whole run, the card's name and power limit, and the
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
T_START = time.perf_counter()
GO1_ENVS = 1800
ALIENGO_ENVS = 4096
TASK_ENVS = 4096        # cassie, anymal_c_rough, a1 as registered
HORIZON = 24            # one PPO rollout (RunnerCfg.num_steps_per_env)
BENCH_STEPS = 50        # bench.py: N_STEPS per timed call
GO1_TRAIN_ITERS = 3
ALIENGO_TRAIN_ITERS = 2
CASSIE_TRAIN_ITERS = 2
ANYMAL_TRAIN_ITERS = 2
FLAT_TRAIN_ITERS = 1    # anymal_c_flat on the general engine: 20-29 s each
PROFILED_STEPS = 2      # rollout steps under torch.profiler in phase 5
SC_ATOL, SC_RTOL = 1e-4, 1e-5   # self-contact forces [N], card vs CPU
ANCHOR_DIFF_MAX = 0     # anchor entries allowed to differ in live / sentinel
MPC_K = 8192            # bench_mpc.py: candidate rollouts per solve
MPC_HORIZON = 16        # policy steps per rollout (bench_mpc.py --horizon)
MPC_SOLVES = 5          # timed MPPI solves after one warm solve
ALIENGO_MPC_K = 4096
RISER_ENVS = 64         # go1 stances tried across the stair risers of
RISER_CELL = (3, 1)     # the 4 x 4 trimesh's row 3 (0.185 m), column 1
GRAD_HORIZON, GRAD_ITERS = 4, 2   # GradientMPC on the card, cut from 16 / 8
GO1_ROUGH_PRIV = 235 + 2 + 12     # obs + friction, base mass + feet forces
LSTM_ITERS = 2          # then as many timed
PLAY_STEPS = 50         # under the Logger's plot at step 100: no matplotlib
EXPORT_ATOL = 1e-5      # exported actor (numpy) vs the inference policy
TELEOP_STEPS = 25       # policy steps of teleop's env after set_commands
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores


def fail(msg):
    print(f"CHIP SMOKE FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def reset_launches():
    """Every kernel variant's launch count to 0."""
    from legged_gym_tpu_torch.physics import chain_kernel
    for name in chain_kernel.launches:
        chain_kernel.launches[name] = 0


def hold_kernel(tag, variant, cc, args, anchors, smi, settled,
                switch_share=0.0, floors=None):
    """One launch of the kernel (variant ``variant`` of ``cc``) on
    ``args`` and ``anchors`` held against its plain version. A fresh state
    (``settled`` False) is held against the card's plain run at the fresh
    tolerances. A settled state gets the settled tolerances and, with
    ``switch_share``, the contact-flip rule: on the stiff trimesh paths,
    where float32 rounding in another order flips a contact in a few
    settled envs, an env passes when it is within tolerance of the plain
    version on the card or of the plain version on the CPU, and this share
    of the envs may fail both (kernel_numerics.SWITCH_ENVS_SHARE states the
    measurements). ``floors``: (envs in contact, envs where the wall rule
    changes a contact) that a settled state under the flip rule must
    reach. Returns (max error per output, the anchors' max error or
    None)."""
    from legged_gym_tpu_torch.physics import chain_kernel, chain_step
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    anchored = anchors is not None
    if chain_step.variant(cc, anchored) != variant:
        fail(f"{tag}: the step is variant "
             f"{chain_step.variant(cc, anchored)}, not {variant}")
    n = args[0].shape[-1]
    cv = chain_step.const_tensors(cc, DEVICE)
    table = torch.as_tensor(chain_kernel.const_table(cc), device=DEVICE)
    ref = chain_step.run_decimation_chain(cc, *args, cv=cv, anchors=anchors)
    counted = chain_kernel.launches[variant]
    out = chain_kernel.run_decimation(cc, *args, anchors=anchors,
                                      consts=table)
    torch.cuda.synchronize()
    if chain_kernel.launches[variant] != counted + 1:
        fail(f"{tag}: the launch was not counted on {variant}")
    if len(ref) != len(out):
        fail(f"{tag}: kernel returns {len(out)} outputs, plain {len(ref)}")
    for name, r, o in zip(kn.NAMES + ("anchors",), ref, out):
        if tuple(r.shape) != tuple(o.shape):
            fail(f"{tag} {name}: kernel shape {tuple(o.shape)}, plain "
                 f"{tuple(r.shape)}")
        if not torch.isfinite(o).all():
            fail(f"{tag} {name}: kernel output not finite")
    errs = {k: float(v.max())
            for k, v in kn.per_env_errors(ref, out).items()}
    tol = kn.tolerances(settled)
    print(f"{tag}: max |kernel - plain| "
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
        print(f"{tag}: {in_contact} of {n} envs in contact, "
              f"{int(walled.sum())} where the wall rule changes a contact; "
              f"over a tolerance: kernel vs plain on the card {len(over)} "
              f"envs, plain on the CPU vs plain on the card {len(spread)} "
              f"envs [{smi}]")
        if floors and (in_contact < floors[0]
                       or int(walled.sum()) < floors[1]):
            fail(f"{tag}: the settled state does not exercise contact on "
                 f"steep cells ({in_contact} envs in contact, "
                 f"{int(walled.sum())} walled; {floors} needed)")
        over = kn.envs_over(ref, out, settled, ref_cpu)
        print(f"{tag}: kernel over a tolerance against both plain runs in "
              f"{len(over)} envs ({int(walled.cpu()[over].sum())} of them "
              f"wall-rule envs; allowed {allowed}) [{smi}]")
    if len(over) > allowed:
        fail(f"{tag}: {len(over)} envs over a tolerance, {allowed} "
             f"allowed: {errs}")
    if not anchored:
        return errs, None
    a_in_live = int((anchors < kn.ANCHOR_LIVE).sum())
    err, n_live, n_diff = kn.anchor_errors(ref[7], out[7])
    print(f"{tag}: anchors in: {a_in_live} of {anchors.numel()} entries "
          f"live; out: {n_live} live in both, {n_diff} differ in live / "
          f"sentinel state (allowed {ANCHOR_DIFF_MAX}); max |kernel - "
          f"plain| {err:.3e} m (tol {kn.ANCHOR_ATOL:g}) [{smi}]")
    if n_diff > ANCHOR_DIFF_MAX:
        fail(f"{tag}: {n_diff} anchor entries differ in live / sentinel "
             f"state")
    if not err <= kn.ANCHOR_ATOL:
        fail(f"{tag}: anchors differ by {err:.3e} m")
    if settled and a_in_live < 0.9 * anchors.numel():
        fail(f"{tag}: the settled state carries mostly sentinel anchors: "
             f"the anchored law is not exercised")
    return errs, err


def time_kernel(tag, cc, args, anchors, smi):
    """The kernel on ``args`` timed with CUDA events through the wrapper
    (the kernels line's ms) and alone (relaunched on buffers prepared
    once), the plain version timed, and the bound: the bytes one launch
    must move and the plain version's float operations, printed as the
    bound's share of the kernel's time. Returns the timed part of the
    kernel's table entry."""
    from legged_gym_tpu_torch.physics import chain_kernel, chain_step
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    n = args[0].shape[-1]
    cv = chain_step.const_tensors(cc, DEVICE)
    table = torch.as_tensor(chain_kernel.const_table(cc), device=DEVICE)
    lib = chain_kernel.launch_library(chain_kernel.model_layout(cc.cm), n,
                                      anchors is not None)

    def plain():
        return chain_step.run_decimation_chain(cc, *args, cv=cv,
                                               anchors=anchors)

    def kernel():
        return chain_kernel.run_decimation(cc, *args, anchors=anchors,
                                           consts=table)

    go, _ = chain_kernel.bind_launch(lib, cc, args, table, anchors)
    kernel_ms = kn.cuda_ms(kernel, reps=50)
    plain_ms = kn.cuda_ms(plain, reps=2, warmup=1)
    alone_ms = kn.cuda_ms(go, reps=200)
    flops = kn.count_flops(plain)
    moved = [a for i, a in enumerate(args) if i != 4] + [table] \
        + list(kernel())
    if anchors is not None:
        moved.append(anchors)
    n_bytes = kn.launch_bytes(cc, moved)
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / FP32_FLOPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"{tag}: kernel {kernel_ms:.4f} ms/launch through the wrapper "
          f"({alone_ms:.4f} alone, on buffers prepared once), plain "
          f"version {plain_ms:.3f} ms/call; bound {bound_ms:.4f} ms: "
          f"{n_bytes} bytes -> {bytes_ms:.4f} ms, {flops} fp32 ops -> "
          f"{ops_ms:.4f} ms ({bound_by}); the bound is "
          f"{100 * bound_ms / kernel_ms:.2f}% of the kernel's time through "
          f"the wrapper, {100 * bound_ms / alone_ms:.2f}% of its time alone "
          f"[{smi}]")
    if not all(math.isfinite(v)
               for v in (kernel_ms, plain_ms, alone_ms, bound_ms)):
        fail(f"{tag}: non-finite timing")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def check_kernel(tag, env, smi, variant, timed=True, switch_share=0.0,
                 **flags):
    """Phase 2 for one kernel variant: hold_kernel on a fresh reset and on
    a settled state (30 zero-action steps; ``switch_share`` as
    hold_kernel's, with floors of a quarter of the envs in contact and 10
    walled envs), then time_kernel on the settled state. Returns the
    kernel's table entry (None when untimed). ``flags`` replace fields of
    the env's step constants."""
    import dataclasses

    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    n = env.num_envs
    cc = dataclasses.replace(kn.step_consts(env), **flags)
    anchored = env._warm_start
    state = env.initial_state()
    zeros = torch.zeros((n, env.num_actions), device=DEVICE)
    errs, anchor_errs = {}, []
    for label, steps in (("fresh reset", 0), ("settled", 30)):
        for _ in range(steps):
            state, _ = env.step(state, zeros)
        args = kn.kernel_args(env, state)
        anchors = state.contact_ws if anchored else None
        if anchored and anchors is None:
            fail(f"{tag}: the env carries no anchors")
        errs[label], a_err = hold_kernel(
            f"phase 2 {tag} [{label}]", variant, cc, args, anchors, smi,
            settled=steps > 0, switch_share=switch_share,
            floors=(n // 4, 10))
        anchor_errs.append(a_err)
    if not timed:
        return None
    entry = time_kernel(f"phase 2 {tag} [settled]", cc, args, anchors, smi)
    fresh = errs["fresh reset"]
    entry.update(max_abs_err=max(fresh[k] for k in kn.NAMES[:6]),
                 body_f_max_abs_err=fresh["body_f"])
    if anchored:
        entry["anchors_max_abs_err"] = max(anchor_errs)
    return entry


def train_path(tag, env, task, iterations, variant, smi, per_step=1,
               width=(512, 256, 128)):
    """Phase 4 for one task: a few PPO iterations through
    registry.make_runner, ``per_step`` launches counted on ``variant``
    per policy step and none on any other; returns (the launch count, the
    runner). ``variant`` None: a path without the kernel (the general
    engine), where every variant's count must stay 0. ``width``: the
    task's registered actor widths. The same number of iterations is then
    timed in a second call. An env with privileged
    observations takes one more policy step (the runner's first pack);
    a recurrent policy's LSTMs must change too."""
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.physics import chain_kernel

    n = env.num_envs
    _, tcfg = registry.get_cfgs(task)
    if list(tcfg.policy.actor_hidden_dims) != list(width) \
            or tcfg.runner.num_steps_per_env != HORIZON \
            or (tcfg.algorithm.num_learning_epochs,
                tcfg.algorithm.num_mini_batches) != (5, 4):
        fail(f"{tag}: the training config is not the full-width one")
    runner, _ = registry.make_runner(env, train_cfg=tcfg, log_root=None)
    runner.learn_fn.profile = True
    model = runner.train_state.model
    before = [p.detach().clone() for p in model.parameters()]
    reset_launches()
    runner.learn(iterations, init_at_random_ep_len=True)
    torch.cuda.synchronize()
    counts = dict(chain_kernel.launches)
    launches = counts[variant] if variant else 0
    # the reset step (and the privileged pack's step) + rollouts
    steps = 1 + (env.num_privileged_obs is not None) + iterations * HORIZON
    if variant and launches != per_step * steps:
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
    parts = ("actor", "critic") + (("memory_a", "memory_c")
                                   if runner.recurrent else ())
    if not all(any(v > 0 for k, v in moved.items() if k.startswith(part))
               for part in parts):
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
    print(f"phase 4 {tag}: {iterations} iterations, {launches} "
          f"{variant or 'kernel'} launches in {steps} policy steps; "
          f"reward/step "
          f"{m['mean_step_reward']:.5f}, kl {m['kl']:.4f}, lr "
          f"{m['lr']:.2e}, noise std {m['noise_std']:.3f}; save / load "
          f"round trip ok [{smi}]")
    print(f"phase 4 {tag}: train {HORIZON * n * iterations / wall:.0f} "
          f"policy-steps/s ({n} envs, {iterations} timed iterations, "
          f"{wall / iterations:.3f} s each: rollout "
          f"{rollout_s / iterations:.3f} s, update "
          f"{update_s / iterations:.3f} s) [{smi}]")
    return launches, runner


def replayed_launches(tag, env, state, variant, per_step, smi,
                      steps=4):
    """``steps`` policy steps of ``env`` from ``state`` (random normal
    actions) under torch.profiler, each a replay of its physics graph
    (span ``physics.graph``): the trace must hold ``per_step``
    ``chain_step_kernel`` launches a step, and ``chain_kernel.launches``
    must add as many on ``variant``; the count of its physics graph's
    recorded launches is thus read from the card, not assumed."""
    from legged_gym_tpu_torch.physics import chain_kernel
    from legged_gym_tpu_torch.utils import profiling

    gen = torch.Generator(device=DEVICE).manual_seed(2)

    def one_step():
        nonlocal state
        state, _ = env.step(state, torch.randn(
            (env.num_envs, env.num_actions), generator=gen, device=DEVICE))

    with torch.no_grad():
        one_step()
        counted = chain_kernel.launches[variant]
        with profiling.recording() as rec:
            _, _, _, _, kernels = device_profile(one_step, steps)
    counted = chain_kernel.launches[variant] - counted
    traced = sum(c for name, (c, _) in kernels.items()
                 if "chain_step_kernel" in name)
    replays = rec.summary().get("physics.graph", {"n": 0})["n"]
    if not traced == counted == per_step * steps or replays != steps:
        fail(f"{tag}: {steps} replayed steps ({replays} replays) traced "
             f"{traced} chain_step_kernel launches, counted {counted}, "
             f"{per_step * steps} expected")
    print(f"phase 4 {tag}: {steps} policy steps replayed the physics "
          f"graph, {traced} chain_step_kernel launches in the trace, "
          f"{counted} {variant} counted [{smi}]")


def device_profile(fn, reps):
    """``reps`` calls of ``fn`` under torch.profiler (device activity
    only): (device launches (kernels, copies, fills) per call, busy ms per
    call, wall ms per call, host-to-device copies per call, {name: (count,
    us)} over all calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    launches = sum(c for c, _ in kernels.values()) / reps
    busy_ms = 1e-3 * sum(t for _, t in kernels.values()) / reps
    htod = sum(c for name, (c, _) in kernels.items()
               if "HtoD" in name) / reps
    return launches, busy_ms, 1e3 * wall / reps, htod, kernels


def print_top(kernels, reps, k=6):
    for name, (c, t) in sorted(kernels.items(),
                               key=lambda kv: -kv[1][1])[:k]:
        print(f"    {t / reps:9.1f} us {c / reps:8.1f}x  {name[:80]}")


def profile_steps(tag, env, state, smi, steps=PROFILED_STEPS):
    """Rollout steps under torch.profiler (device activity only) with
    random normal actions: device launches (kernels, copies, fills), busy
    ms and host-to-device copies per policy step, and the top ops by
    device time."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    def one_step():
        nonlocal state
        state, _ = env.step(state, torch.randn(
            (env.num_envs, env.num_actions), generator=gen, device=DEVICE))

    with torch.no_grad():
        one_step()
        launches, busy_ms, wall_ms, htod, kernels = device_profile(one_step,
                                                                   steps)
    if not launches:
        fail(f"{tag}: the profiler saw no device work")
    print(f"phase 5 {tag}: {launches:.0f} device launches per policy step "
          f"({htod:.0f} host-to-device copies), busy {busy_ms:.3f} ms of "
          f"{wall_ms:.1f} ms wall (profiler on), idle share "
          f"{1 - busy_ms / wall_ms:.3f} [{smi}]")
    print_top(kernels, steps)
    return launches, htod


def other_drive(over, smi):
    """Phase 5c: go1 as registered (4096 envs on the plane) with ``over``
    (dotted config paths -> values) builds on the card, takes the general
    engine and steps under random actions with finite observations and
    rewards; the reset and the first step warm up, the second is timed."""
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.physics import chain_kernel

    cfg, _ = registry.get_cfgs("go1")
    for path, value in over.items():
        obj = cfg
        *head, last = path.split(".")
        for h in head:
            obj = getattr(obj, h)
        setattr(obj, last, value)
    env, _ = registry.make_env(cfg=cfg, device=DEVICE)
    n = env.num_envs
    if n != TASK_ENVS or env.chain_engine is not None \
            or not env.general_reasons:
        fail(f"go1 {over}: {n} envs, not on the general engine")
    before = dict(chain_kernel.launches)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    steps = 2
    with torch.no_grad():
        state, obs = env.reset()
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, tr = env.step(state, torch.randn(
                (n, env.num_actions), generator=gen, device=DEVICE))
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
    if not (torch.isfinite(tr.obs).all() and torch.isfinite(tr.reward).all()
            and torch.isfinite(tr.torques).all()):
        fail(f"go1 {over}: non-finite step outputs")
    if dict(chain_kernel.launches) != before:
        fail(f"go1 {over}: the kernel was launched")
    print(f"phase 5 go1 {over} ({env.general_reasons[0]}), {n} envs: a "
          f"reset and {steps} steps on the card, the last "
          f"{1e3 * step_s:.1f} ms wall; |tau| max "
          f"{float(tr.torques.abs().max()):.2f} N*m, base height mean "
          f"{float(state.physics.pos[2].mean()):.3f} m [{smi}]")


def check_general(tag, env, smi, variant):
    """Phase 5a: from a settled state, the general engine against the
    kernel with the plane re-sampled every sim dt (plane_per_step off, the
    general engine's semantics): go1 rough's P drive over one policy step
    against K2, and anymal_c_rough's SEA drive over one segment (one sim
    dt, the SEA net's torque held over it, as phase 2's K3 gate) against
    K3 with friction anchors and the wall rule, the anchors compared too.
    Phase 2's settled tolerances and contact-flip rule: an env passes
    within tolerance of the general engine on the card or on the CPU, and
    kernel_numerics.SWITCH_ENVS_SHARE of the envs may fail both. Both
    sides timed with CUDA events."""
    import numpy as np

    from legged_gym_tpu_torch.physics import chain_kernel, chain_step
    from legged_gym_tpu_torch.physics.chain_engine import ChainEngine
    from legged_gym_tpu_torch.physics.contact import ANCHOR_SENTINEL
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn
    from legged_gym_tpu_torch.terrain.heightfield import TerrainPatch

    n = env.num_envs
    if env.chain_engine is not None \
            or env.general_reasons != ["use_chain_engine off"]:
        fail(f"{tag}: the env is not on the general engine "
             f"({env.general_reasons})")
    sea, anchored = env._sea is not None, env._warm_start
    # the SEA path: one segment (one sim dt, one K3 launch), as phase 2
    decimation = 1 if sea else env.cfg.control.decimation
    ce = ChainEngine(env.engine, decimation=decimation,
                     patch_S=env.contact_patch_S, plane_per_step=False)
    ce.bind_grid(env.grid)
    if chain_step.variant(ce.cc_sea if sea else ce.cc, anchored) != variant:
        fail(f"{tag}: the comparison step is not {variant}")
    launches = 1
    state = env.initial_state()
    zeros = torch.zeros((n, env.num_actions), device=DEVICE)
    with torch.no_grad():
        for _ in range(30):
            state, _ = env.step(state, zeros)
    phys, lp, fric = state.physics, state.link_params, state.friction
    targets = env._dflt.expand(env.num_dof, n)
    cpatch = None                   # on a plane: the chain's zero window
    if env.grid is not None:
        lo = (env.patch_cache_S - env.contact_patch_S) // 2
        hi = lo + env.contact_patch_S
        cpatch = (state.patch_T[lo:hi, lo:hi].contiguous(),
                  state.patch_r0 + lo, state.patch_c0 + lo)
    if anchored:
        # the engine's (3, P, N) anchors <-> the kernel's packed points
        idx = np.concatenate([g.cp_index.reshape(-1)
                              for g in ce.cm.groups])
        live = torch.as_tensor(idx >= 0, device=DEVICE)
        src = torch.as_tensor(idx[idx >= 0], device=DEVICE)
        packed = torch.full((3, len(idx), n), ANCHOR_SENTINEL,
                            device=DEVICE)
        packed[:, live] = state.contact_ws[:, src]

    if sea:
        # the SEA net's torque at the settled state, held over the segment
        with torch.no_grad():
            sea_tau, _ = env._sea_tau_fn(zeros.T, n)(phys.q, phys.qd,
                                               state.actuator_state)

    def general(device):
        def on(t):
            return t.to(device)
        p = type(phys)(*(on(t) for t in (phys.pos, phys.quat, phys.vel,
                                          phys.q, phys.qd)))
        patch = None
        if env.grid is not None:
            patch = TerrainPatch(h=on(state.patch), r0=on(state.patch_r0),
                                 c0=on(state.patch_c0))
        ws = on(state.contact_ws) if anchored else None
        info = None
        for _ in range(decimation):
            if sea:
                out = env.engine.step_torques(p, on(lp), on(fric),
                                              on(sea_tau), patch=patch,
                                              f_ws=ws)
            else:
                out = env.engine.step_pos_targets(
                    p, on(lp), on(fric), on(targets), patch=patch, f_ws=ws)
            p, info = out[0], out[1]
            if anchored:
                ws = out[2]
        return [p.pos, p.quat, p.vel, p.q, p.qd, info.torques,
                info.body_forces] + ([ws] if anchored else [])

    def kernel():
        if sea:
            out = ce.step_decimation_torque_fn(
                phys, lp, fric, lambda q, qd, c: (sea_tau, c), None,
                contact_patch=cpatch, anchors=packed if anchored else None)
            ws = out[4] if anchored else None
        else:
            out = ce.step_decimation_pos(phys, lp, fric, targets,
                                         contact_patch=cpatch)
        p, tau, body_f = out[:3]
        res = [p.pos, p.quat, p.vel, p.q, p.qd, tau, body_f]
        if anchored:
            back = torch.full_like(state.contact_ws, ANCHOR_SENTINEL)
            back[:, src] = ws[:, live]
            res.append(back)
        return res

    def over(ref, out):
        """Envs over a tolerance of ``out`` against ``ref``: the seven
        outputs, and the anchors (live / sentinel state, kn.ANCHOR_ATOL
        where both are live)."""
        bad = set(kn.envs_over(ref[:7], out[:7], True))
        if anchored:
            r, o = ref[7], out[7]
            live_r, live_o = r < kn.ANCHOR_LIVE, o < kn.ANCHOR_LIVE
            err = ((r - o).abs() * (live_r & live_o)).flatten(0, 1).amax(0)
            diff = (live_r != live_o).flatten(0, 1).any(0)
            bad |= set(torch.nonzero(diff | (err > kn.ANCHOR_ATOL))
                       .flatten().tolist())
        return bad

    with torch.no_grad():
        ref = general(DEVICE)
        counted = chain_kernel.launches[variant]
        out = kernel()
        torch.cuda.synchronize()
        if chain_kernel.launches[variant] != counted + launches:
            fail(f"{tag}: {launches} {variant} launches were not counted")
        ref_cpu = general("cpu")
    for name, r, o in zip(kn.NAMES + ("anchors",), ref, out):
        if tuple(r.shape) != tuple(o.shape) or not torch.isfinite(r).all():
            fail(f"{tag} {name}: general engine {tuple(r.shape)} (finite: "
                 f"{bool(torch.isfinite(r).all())}), kernel "
                 f"{tuple(o.shape)}")
    errs = {k: float(v.max())
            for k, v in kn.per_env_errors(ref[:7], out[:7]).items()}
    tol = kn.tolerances(settled=True)
    in_contact = int(kn.contact_envs(ref).sum())
    out_cpu = [o.cpu() for o in out]
    over_card = over(ref, out)
    spread = over(ref_cpu, [r.cpu() for r in ref])
    over_both = over_card & over(ref_cpu, out_cpu)
    allowed = int(kn.SWITCH_ENVS_SHARE * n)
    print(f"phase 5 {tag}: max |{variant} - general engine| "
          + ", ".join(f"{k} {v:.3e} (tol {tol[k]:g})"
                      for k, v in errs.items())
          + f"; {in_contact} of {n} envs in contact; over a tolerance: "
          f"against the card's general run {len(over_card)} envs, the CPU's "
          f"vs the card's general run {len(spread)}, against both "
          f"{len(over_both)} (allowed {allowed}) [{smi}]")
    if anchored:
        err, n_live, n_diff = kn.anchor_errors(ref[7], out[7])
        a_in_live = int((state.contact_ws < kn.ANCHOR_LIVE).sum())
        print(f"phase 5 {tag}: anchors in: {a_in_live} of "
              f"{state.contact_ws.numel()} entries live; out: {n_live} live "
              f"in both, {n_diff} differ in live / sentinel state; max "
              f"|{variant} - general engine| {err:.3e} m (tol "
              f"{kn.ANCHOR_ATOL:g}) [{smi}]")
        if a_in_live < 0.9 * state.contact_ws.numel():
            fail(f"{tag}: the settled state carries mostly sentinel "
                 f"anchors: the anchored law is not exercised")
    if in_contact < n // 2:
        fail(f"{tag}: the settled state is not in contact")
    if len(over_both) > allowed:
        fail(f"{tag}: {len(over_both)} envs over a tolerance, {allowed} "
             f"allowed: {errs}")
    with torch.no_grad():
        general_ms = kn.cuda_ms(lambda: general(DEVICE), reps=3, warmup=1)
        kernel_ms = kn.cuda_ms(kernel, reps=20)
    print(f"phase 5 {tag}: {'one sim dt' if sea else 'one policy step'} "
          f"of physics, general engine "
          f"{general_ms:.2f} ms, {variant} through the wrapper "
          f"{kernel_ms:.4f} ms ({general_ms / kernel_ms:.0f}x) [{smi}]")


def check_self_collision(tag, env, state, smi, steps=6, action_std=5.0):
    """Phase 5b: from ``state``, ``steps`` policy steps of random normal
    actions with standard deviation ``action_std`` (swings wide enough to
    bring legs together), then that state's self-contact forces on the
    card against the same call on the CPU (the port against itself: the
    law is held against the JAX package by the CPU tests), at the CPU
    tests' law tolerances; some env must have pairs in contact."""
    from legged_gym_tpu_torch.physics.kinematics import (
        contact_point_kinematics, forward_kinematics)

    eng = env.engine
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    with torch.no_grad():
        for _ in range(steps):
            state, _ = env.step(state, action_std * torch.randn(
                (env.num_envs, env.num_actions), generator=gen,
                device=DEVICE))
        cp_pos, cp_vel = contact_point_kinematics(
            eng.model, forward_kinematics(eng.model, state.physics))
        f = eng.consts(torch.float32, DEVICE)["sc"](cp_pos, cp_vel,
                                                    eng.dt_inner)
        f_cpu = eng.consts(torch.float32, "cpu")["sc"](
            cp_pos.cpu(), cp_vel.cpu(), eng.dt_inner)
    torch.cuda.synchronize()
    err = (f.cpu() - f_cpu).abs()
    bad = int((err > SC_ATOL + SC_RTOL * f_cpu.abs()).sum())
    touching = int((f_cpu.abs().amax(dim=(0, 1)) > 0).sum())
    print(f"phase 5 {tag}: self-contact forces in {touching} of "
          f"{state.n} envs, max {float(f_cpu.abs().max()):.1f} N; max "
          f"|card - CPU| {float(err.max()):.3e} N, {bad} entries over "
          f"{SC_ATOL:g} N + {SC_RTOL:g} rel [{smi}]")
    if not touching:
        fail(f"{tag}: no self-contact in the state")
    if bad or not torch.isfinite(f).all():
        fail(f"{tag}: self-contact forces differ between card and CPU")


# ---------------------------------------------------------------- phase 6

def launches_only(tag, variant, expect):
    """The launch counts since reset_launches(): ``expect`` on ``variant``
    (None: no variant), none on any other."""
    from legged_gym_tpu_torch.physics import chain_kernel
    counts = dict(chain_kernel.launches)
    for name, count in counts.items():
        want = expect if name == variant else 0
        if count != want:
            fail(f"{tag}: kernel {name} launched {count} times, {want} "
                 f"expected: {counts}")


def mpc_env(task, mesh=None, rows=4, curriculum=True, settle=25,
            num_envs=1):
    """One env of ``task`` on the card for the planners, settled with
    ``settle`` zero-action steps: bench_mpc.py:build_env (go1 on trimesh
    4 x 4 with curriculum, 235-dim obs), or ``mesh`` None for the task's
    own plane; noise and pushes off. Returns (env, state)."""
    from legged_gym_tpu_torch import registry

    cfg, _ = registry.get_cfgs(task)
    cfg.env.num_envs = num_envs
    if mesh is not None:
        cfg.env.num_observations = 235
        cfg.terrain.mesh_type = mesh
        cfg.terrain.measure_heights = True
        cfg.terrain.curriculum = curriculum
        cfg.terrain.num_rows = cfg.terrain.num_cols = rows
    cfg.noise.add_noise = False
    cfg.domain_rand.push_robots = False
    env, _ = registry.make_env(cfg=cfg, device=DEVICE)
    zeros = torch.zeros((num_envs, env.num_actions), device=DEVICE)
    with torch.no_grad():
        state, _ = env.reset()
        for _ in range(settle):
            state, tr = env.step(state, zeros)
            if bool(tr.done.any()):
                fail(f"{task}: the robot fell while settling")
    return env, state


def riser_stance(smi):
    """A 1-env go1 stance on bench_mpc.py's 4 x 4 trimesh with a foot in a
    cell whose corners the wall rule flattens: RISER_ENVS envs of the same
    config placed along a line across the stair risers of RISER_CELL (x
    1.2-2.4 m out from the cell's origin), settled with 25 zero-action
    steps; the first env that stayed up, is in contact and has a contact
    the wall rule changes. Returns (env, its N=1 (physics, link params,
    friction))."""
    import dataclasses

    from legged_gym_tpu_torch.physics import chain_step
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    env, _ = mpc_env("go1", "trimesh", settle=0, num_envs=RISER_ENVS)
    state = env.initial_state()
    p = state.physics
    ox, oy, oz = (float(v) for v in env.terrain_origins[RISER_CELL])
    pos = torch.stack([
        ox + torch.linspace(1.2, 2.4, RISER_ENVS, device=DEVICE),
        torch.full((RISER_ENVS,), oy, device=DEVICE),
        torch.full((RISER_ENVS,), oz + 0.5, device=DEVICE)])
    state = dataclasses.replace(state, physics=dataclasses.replace(
        p, pos=env._depenetrate_spawn(pos, p.quat, p.q)))
    zeros = torch.zeros((RISER_ENVS, env.num_actions), device=DEVICE)
    fell = torch.zeros(RISER_ENVS, dtype=torch.bool, device=DEVICE)
    with torch.no_grad():
        for _ in range(25):
            state, tr = env.step(state, zeros)
            fell |= tr.done
        cc = env.chain_engine.cc
        cv = chain_step.const_tensors(cc, DEVICE)
        args = kn.kernel_args(env, state)
        ok = kn.wall_rule_envs(cc, cv, args) & ~fell & kn.contact_envs(
            chain_step.run_decimation_chain(cc, *args, cv=cv))
    if not bool(ok.any()):
        fail("riser stance: no settled go1 env has a walled contact")
    i = int(torch.nonzero(ok)[0])
    print(f"phase 6 riser stance: {int(ok.sum())} of {RISER_ENVS} settled "
          f"envs stand with a walled contact; env {i}, base "
          f"{float(state.physics.pos[0, i]) - ox:.2f} m out from the stair "
          f"cell's origin [{smi}]")
    one = slice(i, i + 1)
    p = state.physics
    phys = type(p)(*(t[..., one].contiguous() for t in (
        p.pos, p.quat, p.vel, p.q, p.qd)))
    return env, (phys, state.link_params[..., one].contiguous(),
                 state.friction[one].contiguous())


def mpc_step_args(env, phys, lp, fr, gen, k=MPC_K):
    """The kernel arguments of one MPC policy step at K = k: the N=1
    stance tiled over K as the planner tiles it (SamplingMPC._tiled, the
    shared contact window tiled), seeded random actions of the planner's
    0.3 std."""
    from legged_gym_tpu_torch.mpc import MPCConfig, SamplingMPC

    mpc = SamplingMPC(env, MPCConfig(horizon=MPC_HORIZON, num_samples=k))
    phys_k, lp_k, fr_k, cpatch, _ = mpc._tiled(phys, lp, fr, None, k)
    a = 0.3 * torch.randn((env.num_actions, k), generator=gen,
                          device=DEVICE)
    targets = torch.clamp(a * env.cfg.control.action_scale + env._dflt,
                          env._soft_lo, env._soft_hi)
    return env.chain_engine.level_args(phys_k, lp_k, fr_k, targets, cpatch)


def check_mpc_kernel(env, state, smi):
    """Phase 6a: one MPC policy step at K = 8192 on the planner's tiled
    inputs through K2 with go1's layout and the wall rule, held against
    its plain version on the card and on the CPU under phase 2's settled
    rule (hold_kernel): from the planner's own settled stance, and from a
    stance on a stair riser (riser_stance), which must have its K envs in
    contact and at least 10 where the wall rule changes a contact; the
    second timed with its bound. Returns (the entry's MPC-shape numbers,
    the riser stance: its env and N=1 (physics, link params, friction))."""
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    cc = env.chain_engine.cc
    if cc.wall_thresh <= 0:
        fail(f"go1 MPC: wall_thresh {cc.wall_thresh}: no wall rule")
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    tag = f"phase 6 K2 go1 trimesh MPC step, {MPC_K} rollouts"
    with torch.no_grad():
        args = mpc_step_args(env, state.physics, state.link_params,
                             state.friction, gen)
        hold_kernel(f"{tag} [the planner's stance]", "K2", cc, args, None,
                    smi, settled=True, switch_share=kn.SWITCH_ENVS_SHARE,
                    floors=(MPC_K // 2, 0))
        # the same config at RISER_ENVS envs: the same step constants
        r_env, stance = riser_stance(smi)
        cc = r_env.chain_engine.cc
        args = mpc_step_args(r_env, *stance, gen)
        errs, _ = hold_kernel(f"{tag} [riser stance]", "K2", cc, args, None,
                              smi, settled=True,
                              switch_share=kn.SWITCH_ENVS_SHARE,
                              floors=(MPC_K // 2, 10))
        entry = time_kernel(f"{tag} [riser stance]", cc, args, None, smi)
    return {"mpc_shape": f"go1 trimesh, {MPC_K} envs, riser stance",
            "mpc_max_abs_err": max(errs[k] for k in kn.NAMES[:6]),
            "mpc_ms": entry["ms"], "mpc_plain_ms": entry["plain_ms"],
            "mpc_bound_ms": entry["bound_ms"],
            "mpc_bound_by": entry["bound_by"]}, (r_env, stance)


def mpc_go1(env, state, smi):
    """Phase 6a: MPPI at K = 8192, H = 16 on go1 trimesh (bench_mpc.py's
    planner settings): one warm and MPC_SOLVES timed solves, each synced
    by reading its best cost, 16 K2 launches per solve; then CEM (5 refit
    iterations, 5% elites), the three plans' costs under one common
    evaluator and bench_mpc.py's gate (:122-126): within 10% of the best,
    or the best beats the zero plan; one MPPI solve under torch.profiler.
    Then the evaluator's one-env step held against its plain version
    (hold_kernel, phase 2's settled rule). Returns the K2 launch count of
    the phase."""
    from legged_gym_tpu_torch.mpc import MPCConfig, SamplingMPC
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    cfg = MPCConfig(horizon=MPC_HORIZON, num_samples=MPC_K, noise_std=0.3,
                    temperature=0.05, cem_iters=5, cem_elite_frac=0.05)
    mppi = SamplingMPC(env, cfg, method="mppi")
    cem = SamplingMPC(env, cfg, method="cem")
    phys, lp, fr = state.physics, state.link_params, state.friction
    commands = torch.tensor([0.8, 0.0, 0.0], device=DEVICE)  # walk forward
    gen = torch.Generator(device=DEVICE).manual_seed(1)

    def solve(planner):
        seq, info = planner.plan(gen, phys, lp, fr, commands)
        best = float(info["best_cost"])           # the read syncs
        if not (math.isfinite(best) and torch.isfinite(seq).all()):
            fail(f"go1 MPC {planner.method}: non-finite plan or cost")
        return seq

    reset_launches()
    solve(mppi)
    t0 = time.perf_counter()
    for _ in range(MPC_SOLVES):
        solve(mppi)
    dt = (time.perf_counter() - t0) / MPC_SOLVES
    launches_only("go1 MPPI", "K2", MPC_HORIZON * (1 + MPC_SOLVES))
    print(f"phase 6 go1 MPPI K={MPC_K} H={MPC_HORIZON}: "
          f"{1.0 / dt:.3f} solves/s, {MPC_K * MPC_HORIZON / dt:.1f} "
          f"rollout-steps/s ({1e3 * dt:.2f} ms per solve, "
          f"{MPC_HORIZON * (1 + MPC_SOLVES)} K2 launches in "
          f"{1 + MPC_SOLVES} solves) [{smi}]")

    seq_m = solve(mppi)
    t0 = time.perf_counter()
    seq_c = solve(cem)
    cem_s = time.perf_counter() - t0
    cp1 = mppi._shared_patch(phys, 1)
    with torch.no_grad():
        def cost(seq):
            return float(mppi.rollout_cost(phys, lp, fr, commands,
                                           seq[:, :, None],
                                           contact_patch=cp1)[0])
        c_m, c_c, c_z = cost(seq_m), cost(seq_c), cost(torch.zeros_like(seq_m))
    mae = float((seq_m - seq_c).abs().mean())
    best = min(c_m, c_c)
    within = abs(c_m - c_c) <= 0.10 * max(abs(best), 1e-6) + 1e-6 \
        or best < c_z
    k2 = MPC_HORIZON * (2 + MPC_SOLVES + cfg.cem_iters + 3)
    launches_only("go1 MPPI + CEM + evaluator", "K2", k2)
    print(f"phase 6 go1 CEM ({cfg.cem_iters} iterations, "
          f"{max(1, int(MPC_K * cfg.cem_elite_frac))} elites) "
          f"{cem_s:.3f} s; common evaluator: cost MPPI {c_m:.4f}, CEM "
          f"{c_c:.4f}, zero plan {c_z:.4f}; MPPI-CEM plan MAE {mae:.4f}; "
          f"planners agree or beat the zero plan: {within} [{smi}]")
    if not all(math.isfinite(v) for v in (c_m, c_c, c_z, mae)):
        fail("go1 MPC: non-finite evaluator cost")
    if not within:
        fail(f"go1 MPC: bench_mpc.py's planner gate failed: MPPI {c_m}, "
             f"CEM {c_c}, zero {c_z}")

    with torch.no_grad():
        launches, busy_ms, wall_ms, htod, kernels = device_profile(
            lambda: solve(mppi), 1)
    k2 += MPC_HORIZON
    print(f"phase 6 go1 MPPI under the profiler: {launches:.0f} device "
          f"launches per solve ({launches / MPC_HORIZON:.1f} per horizon "
          f"step, {htod:.0f} host-to-device copies), busy {busy_ms:.3f} ms "
          f"of {wall_ms:.1f} ms wall (profiler on), idle share "
          f"{1 - busy_ms / wall_ms:.3f}; against the timed solves' "
          f"{1e3 * dt:.2f} ms (profiler off) {1 - busy_ms / (1e3 * dt):.3f} "
          f"[{smi}]")
    print_top(kernels, 1)
    host_profile(lambda: solve(mppi), smi)
    k2 += MPC_HORIZON
    launches_only("go1 MPC phase", "K2", k2)

    # the common evaluator's shape: K2 at one env, the MPPI plan's first
    # step from the settled stance
    targets = torch.clamp(seq_m[0][:, None] * env.cfg.control.action_scale
                          + env._dflt, env._soft_lo, env._soft_hi)
    with torch.no_grad():
        hold_kernel("phase 6 K2 go1 MPC evaluator step, 1 env", "K2",
                    env.chain_engine.cc,
                    env.chain_engine.level_args(phys, lp, fr, targets, cp1),
                    None, smi, settled=True,
                    switch_share=kn.SWITCH_ENVS_SHARE)
    return k2


HOST_FUNCS = ("rollout_cost", "step_decimation_pos", "level_args",
              "run_decimation", "_prepare", "launch_library", "from_level",
              "rotate_inverse")


def host_profile(fn, smi, top=8):
    """One call of ``fn`` under cProfile: the host's time in the functions
    of HOST_FUNCS (cumulative) and the top ``top`` by self time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    with torch.no_grad():
        prof.enable()
        fn()
        prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(tt for _, _, tt, _, _ in stats.values())
    cum = {}
    for (_, _, name), (_, nc, _, ct, _) in stats.items():
        if name in HOST_FUNCS:
            calls, t = cum.get(name, (0, 0.0))
            cum[name] = (calls + nc, t + ct)
    print(f"phase 6 go1 MPPI host profile (cProfile on, one solve): "
          f"{1e3 * total:.1f} ms of host time; cumulative: "
          + ", ".join(f"{name} {1e3 * t:.1f} ms / {n}"
                      for name, (n, t) in sorted(cum.items(),
                                                 key=lambda kv: -kv[1][1]))
          + f" [{smi}]")
    for (path, line, name), (_, nc, tt, _, _) in sorted(
            stats.items(), key=lambda kv: -kv[1][2])[:top]:
        print(f"    {1e3 * tt:8.2f} ms self {nc:6d} calls  "
              f"{os.path.basename(path)}:{line} {name}")


def mpc_aliengo(smi):
    """Phase 6b: aliengo on its plane, settled; one MPPI solve at K = 4096,
    H = 16 from the env's current friction anchors tiled over K: 16 K4
    launches, finite costs. Returns the launch count."""
    from legged_gym_tpu_torch.mpc import MPCConfig, SamplingMPC
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    t0 = time.perf_counter()
    env, state = mpc_env("aliengo")
    anchors = state.contact_ws
    live = int((anchors < kn.ANCHOR_LIVE).sum())
    if not env._warm_start or live == 0:
        fail(f"aliengo MPC: no live anchors to start from ({live})")
    mppi = SamplingMPC(env, MPCConfig(horizon=MPC_HORIZON,
                                      num_samples=ALIENGO_MPC_K))
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    reset_launches()
    seq, info = mppi.plan(gen, state.physics, state.link_params,
                          state.friction,
                          torch.tensor([0.5, 0.0, 0.0], device=DEVICE),
                          anchors=anchors)
    best, mean = float(info["best_cost"]), float(info["cost"])
    launches_only("aliengo MPPI", "K4", MPC_HORIZON)
    if not (math.isfinite(best) and math.isfinite(mean)
            and torch.isfinite(seq).all()):
        fail("aliengo MPPI: non-finite plan or costs")
    print(f"phase 6 aliengo MPPI K={ALIENGO_MPC_K} H={MPC_HORIZON} from "
          f"{live} of {anchors.numel()} live anchor entries: "
          f"{MPC_HORIZON} K4 launches, best cost {best:.4f}, weighted "
          f"{mean:.4f}; {time.perf_counter() - t0:.1f} s with the env "
          f"[{smi}]")
    return MPC_HORIZON


def mpc_gradient(smi):
    """Phase 6c: GradientMPC on go1 heightfield (tests/test_mpc.py:126-135,
    settled 15 steps), cut to H = 4 and 2 Adam iterations: the plain chain
    step differentiated on the card, no kernel launch, a finite non-zero
    gradient and a finite cost trace."""
    from legged_gym_tpu_torch.mpc import GradientMPC, MPCConfig

    env, state = mpc_env("go1", "heightfield", rows=2, curriculum=False,
                         settle=15)
    gm = GradientMPC(env, MPCConfig(horizon=GRAD_HORIZON,
                                    gd_iters=GRAD_ITERS))
    phys, lp, fr = state.physics, state.link_params, state.friction
    commands = torch.tensor([0.5, 0.0, 0.0], device=DEVICE)
    reset_launches()
    cost, grad = gm.cost_and_grad(
        torch.zeros((GRAD_HORIZON, env.num_actions), device=DEVICE), phys,
        lp, fr, commands, contact_patch=gm._shared_patch(phys, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq, info = gm.plan(None, phys, lp, fr, commands)
    trace = info["cost_trace"].tolist()
    per_iter = (time.perf_counter() - t0) / GRAD_ITERS
    launches_only("GradientMPC", None, 0)
    g = float(grad.abs().max())
    if not (torch.isfinite(grad).all() and g > 0 and math.isfinite(
            float(cost)) and all(math.isfinite(v) for v in trace)
            and torch.isfinite(seq).all()):
        fail(f"GradientMPC: gradient max {g}, cost trace {trace}")
    print(f"phase 6 go1 GradientMPC (cut: horizon {GRAD_HORIZON} of "
          f"{MPCConfig().horizon}, {GRAD_ITERS} of {MPCConfig().gd_iters} "
          f"Adam iterations; heightfield 2 x 2): 0 kernel launches, "
          f"|grad| max {g:.3e}, cost trace "
          + ", ".join(f"{v:.4f}" for v in trace)
          + f"; {per_iter:.2f} s per iteration [{smi}]")


# ---------------------------------------------------------- phases 7 and 8

def go1_rough_lstm():
    """go1 rough at 1800 envs (phase 4's cell) with the recurrent policy
    (LSTM 512, one layer, 512-256-128 heads) and the asymmetric critic
    (249 privileged observations)."""
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    cfg = kn.rough_cfg(GO1_ENVS)
    cfg.env.num_privileged_obs = GO1_ROUGH_PRIV
    _, tcfg = registry.get_cfgs("go1")
    tcfg.runner.policy_class_name = "ActorCriticRecurrent"
    tcfg.policy.rnn_hidden_size = 512
    tcfg.policy.rnn_num_layers = 1
    return cfg, tcfg


def go1_rough():
    """Phase 4's go1 rough cell as a registered task, for scripts.play."""
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    return kn.rough_cfg(GO1_ENVS), registry.get_cfgs("go1")[1]


def play_path(task, runner, root, smi):
    """Phase 8 for one checkpoint: ``runner`` saved under the log root
    ``root``, then scripts.play.play on the card for PLAY_STEPS steps: K1
    launches counted, the export's keys are the JAX package's, the
    exported actor evaluated in numpy gives the inference policy's
    actions, the rollout is finite; then one step from the rollout's last
    state held against the plain version (hold_at). Returns the K1 launch
    count."""
    from legged_gym_tpu_torch.scripts.play import exported_policy, play
    from legged_gym_tpu_torch.utils import helpers

    runner.save(os.path.join(root, "smoke",
                             f"model_{runner.current_iteration}.ckpt"))
    args = helpers.get_args(["--task", task, "--device", DEVICE])
    reset_launches()
    t0 = time.perf_counter()
    out = play(args, num_steps=PLAY_STEPS, log_root=root)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_only(f"play {task}", "K1", PLAY_STEPS + 1)
    keys = {f"{w}{i}" for w in "wb" for i in range(4)} | {"activation"}
    if runner.recurrent:
        keys |= {"lstm_w0", "lstm_b0", "rnn_hidden_size", "rnn_num_layers"}
    import numpy as np
    with np.load(out["export"]) as z:
        if set(z.files) != keys:
            fail(f"play {task}: export keys {sorted(z.files)}")
    obs = out["obs"]
    if not (torch.isfinite(obs).all()
            and torch.isfinite(out["state"].physics.pos).all()):
        fail(f"play {task}: non-finite rollout")
    plain = exported_policy(out["export"])
    policy = out["runner"].get_inference_policy()
    err = 0.0
    for _ in range(2):
        want = policy(obs).cpu().numpy()
        err = max(err, float(np.abs(plain(obs.cpu().numpy()) - want).max()))
    if not err <= EXPORT_ATOL:
        fail(f"play {task}: exported actor differs by {err}")
    print(f"phase 8 play {task}: {out['env'].num_envs} envs, {PLAY_STEPS} "
          f"steps, {PLAY_STEPS + 1} K1 launches, {wall:.1f} s with the env "
          f"and the export; export keys ok, exported actor vs inference "
          f"policy max |diff| {err:.2e} (tol {EXPORT_ATOL:g}) [{smi}]")
    hold_at(f"phase 8 K1 play {task}", out["env"], out["state"], smi)
    return PLAY_STEPS + 1


def hold_at(tag, env, state, smi):
    """One K1 step of ``env`` from ``state`` (default-pose targets, the
    cached contact window) held against its plain version under phase 2's
    settled rule (hold_kernel), half the envs (at least one) in contact:
    the play and teleop shapes."""
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    with torch.no_grad():
        hold_kernel(f"{tag}, {env.num_envs} envs", "K1", kn.step_consts(env),
                    kn.kernel_args(env, state), None, smi, settled=True,
                    switch_share=kn.SWITCH_ENVS_SHARE,
                    floors=(max(1, env.num_envs // 2), 0))


def mpc_phase(smi):
    """Phase 6: returns (the K2 entry's MPC-shape numbers, K2 launches,
    K4 launches, the stances phase 9 plans from: {"planner": the
    planner's settled N=1 (physics, link params, friction), "riser": the
    riser stance's env and N=1 stance})."""
    t6 = time.perf_counter()
    env, state = mpc_env("go1", "trimesh")
    mpc_entry, riser = check_mpc_kernel(env, state, smi)
    k2_mpc = mpc_go1(env, state, smi)
    stances = {"planner": (state.physics, state.link_params,
                           state.friction), "riser": riser}
    del env
    k4_mpc = mpc_aliengo(smi)
    mpc_gradient(smi)
    print(f"phase 6: {time.perf_counter() - t6:.1f} s [{smi}]")
    return mpc_entry, k2_mpc, k4_mpc, stances


def lstm_phase(smi):
    """Phase 7: go1 rough trains with the recurrent policy and the
    asymmetric critic; the stateful inference policy restarts from a zero
    carry. Returns (K1 launches, the runner)."""
    from legged_gym_tpu_torch import registry

    t7 = time.perf_counter()
    registry.register("go1_rough_lstm", go1_rough_lstm)
    env, _ = registry.make_env("go1_rough_lstm", device=DEVICE)
    if (env.num_envs, env.num_privileged_obs) != (GO1_ENVS, GO1_ROUGH_PRIV):
        fail(f"go1 rough LSTM: {env.num_envs} envs, "
             f"{env.num_privileged_obs} privileged obs")
    k1_lstm, runner = train_path(
        f"go1 rough {GO1_ENVS}, LSTM 512 + asymmetric critic", env,
        "go1_rough_lstm", LSTM_ITERS, "K1", smi)
    model = runner.train_state.model
    if not runner.recurrent or model.critic[0].in_features != 512 \
            or model.memory_c.w[0].shape[0] != GO1_ROUGH_PRIV + 512:
        fail("go1 rough LSTM: not the recurrent asymmetric model")
    policy = runner.get_inference_policy()
    obs = runner.obs[0][0]
    first = policy(obs)
    second = policy(obs)
    policy.reset_memory()
    if not torch.equal(first, policy(obs)) or torch.equal(first, second):
        fail("go1 rough LSTM: the stateful policy does not restart from "
             "a zero carry after reset_memory()")
    print(f"phase 7: the stateful inference policy restarts after "
          f"reset_memory(); {time.perf_counter() - t7:.1f} s [{smi}]")
    return k1_lstm, runner


def play_phase(go1_runner, lstm_runner, smi):
    """Phase 8: scripts.play from phase 4's and phase 7's checkpoints, then
    teleop's set_commands and TELEOP_STEPS steps of the policy, the
    commands held after the first and the last, and one step from the
    last of those states from which the step ends on the ground held
    against the plain version (hold_at). Returns the K1 launches."""
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.physics import chain_step
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn
    from legged_gym_tpu_torch.scripts.teleop import teleop_cfg

    t8 = time.perf_counter()
    registry.register("go1_rough", go1_rough)
    with tempfile.TemporaryDirectory() as tmp:
        k1_play = sum(play_path(task, runner, os.path.join(tmp, task), smi)
                      for task, runner in (("go1_rough", go1_runner),
                                           ("go1_rough_lstm", lstm_runner)))
    cfg, _ = teleop_cfg("go1_rough")
    env, _ = registry.make_env(cfg=cfg, device=DEVICE)
    policy = go1_runner.get_inference_policy()
    set_to = torch.tensor([0.5, 0.0, 0.2], device=DEVICE)
    states = []
    reset_launches()
    with torch.no_grad():
        state, obs = env.reset()
        state = env.set_commands(state, 0.5, 0.0, 0.2)
        for i in range(TELEOP_STEPS):
            state, tr = env.step(state, policy(obs))
            obs = tr.obs
            states.append(state)
            got = state.commands[:3, 0]
            if i in (0, TELEOP_STEPS - 1) and not torch.equal(got, set_to):
                fail(f"teleop: commands {got.tolist()} after {i + 1} "
                     f"steps, (0.5, 0, 0.2) set")
    launches_only("teleop", "K1", 1 + TELEOP_STEPS)
    if not torch.isfinite(tr.obs).all():
        fail("teleop: non-finite observations")
    print(f"phase 8 teleop go1_rough: set_commands(0.5, 0.0, 0.2), "
          f"{TELEOP_STEPS} steps: commands "
          f"{[round(v, 6) for v in got.tolist()]}, {1 + TELEOP_STEPS} K1 "
          f"launches [{smi}]")
    # the last state from which the hold's step (default-pose targets)
    # ends on the ground
    cc = kn.step_consts(env)
    cv = chain_step.const_tensors(cc, DEVICE)
    with torch.no_grad():
        held = next((i for i in reversed(range(TELEOP_STEPS))
                     if bool(kn.contact_envs(chain_step.run_decimation_chain(
                         cc, *kn.kernel_args(env, states[i]), cv=cv)).all())),
                    None)
    if held is None:
        fail("teleop: no state from which a step ends on the ground")
    hold_at(f"phase 8 K1 teleop, the state after step {held + 1}", env,
            states[held], smi)
    print(f"phase 8: {time.perf_counter() - t8:.1f} s [{smi}]")
    return k1_play + 1 + TELEOP_STEPS


# ---------------------------------------------------------------- phase 9

SHARD_RANKS = 2         # ranks on the one card (gloo)
SHARD_SEED = 5          # the sharded runs' and their references' seed
SHARD_TIMEOUT_S = 300.0
SHARD_PARAM_ATOL = 1e-4         # tests/test_sharding.py:83-91
SHARD_LOSS_RTOL = 1e-4
PLAN_RTOL, PLAN_ATOL = 2e-4, 2e-5   # tests/test_mpc.py:172-215
SHARD_MPC_TIMED = 3     # timed MPPI solves after the compared one
SCALING_ENVS = 4096     # bench_scaling's go1 at its registered size
TREE_STEPS = 3          # general-engine sim dts, card vs CPU
TREE_ATOL = 5e-3        # tests/test_chain_engine.py:140-144
# a slider (prismatic) with a knee after it and a tail on the base; the
# 2-dof hopper of tests/test_torch_mpc.py (tests/test_torch_general_tree.py
# holds both against the JAX package)
SLIDER_URDF = """<robot name="slider">
<link name="base"><inertial><mass value="2.0"/><origin xyz="0 0 0"/>
<inertia ixx="0.02" iyy="0.03" izz="0.02" ixy="0" ixz="0" iyz="0"/></inertial>
<collision><origin xyz="0 0 0"/><geometry><sphere radius="0.08"/></geometry></collision></link>
<link name="carriage"><inertial><mass value="0.4"/><origin xyz="0 0 -0.02"/>
<inertia ixx="0.001" iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial></link>
<joint name="slide_joint" type="prismatic"><parent link="base"/><child link="carriage"/>
<origin xyz="0.02 0 -0.05"/><axis xyz="0 0.6 0.8"/>
<limit lower="-0.1" upper="0.1" effort="60" velocity="3"/></joint>
<link name="leg_foot"><inertial><mass value="0.2"/><origin xyz="0 0 -0.1"/>
<inertia ixx="0.001" iyy="0.001" izz="0.0002" ixy="0" ixz="0" iyz="0"/></inertial>
<collision><origin xyz="0 0 -0.2"/><geometry><sphere radius="0.03"/></geometry></collision></link>
<joint name="knee_joint" type="revolute"><parent link="carriage"/><child link="leg_foot"/>
<origin xyz="0 0 -0.05"/><axis xyz="0 1 0"/>
<limit lower="-1.5" upper="1.5" effort="30" velocity="20"/></joint>
<link name="tail"><inertial><mass value="0.3"/><origin xyz="-0.1 0 0"/>
<inertia ixx="0.0005" iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial></link>
<joint name="tail_joint" type="revolute"><parent link="base"/><child link="tail"/>
<origin xyz="-0.1 0 0"/><axis xyz="0 0 1"/>
<limit lower="-1.0" upper="1.0" effort="10" velocity="20"/></joint>
</robot>"""
HOPPER_URDF = """<robot name="hopper">
<link name="base"><inertial><mass value="3.0"/><origin xyz="0 0 0"/>
<inertia ixx="0.02" iyy="0.02" izz="0.02" ixy="0" ixz="0" iyz="0"/></inertial>
<collision><origin xyz="0 0 0"/><geometry><sphere radius="0.08"/></geometry></collision></link>
<link name="thigh"><inertial><mass value="0.5"/><origin xyz="0 0 -0.1"/>
<inertia ixx="0.002" iyy="0.002" izz="0.0005" ixy="0" ixz="0" iyz="0"/></inertial></link>
<joint name="hip_joint" type="revolute"><parent link="base"/><child link="thigh"/>
<origin xyz="0 0 -0.05"/><axis xyz="0 1 0"/>
<limit lower="-1.5" upper="1.5" effort="30" velocity="20"/></joint>
<link name="shank_foot"><inertial><mass value="0.2"/><origin xyz="0 0 -0.1"/>
<inertia ixx="0.001" iyy="0.001" izz="0.0002" ixy="0" ixz="0" iyz="0"/></inertial>
<collision><origin xyz="0 0 -0.2"/><geometry><sphere radius="0.03"/></geometry></collision></link>
<joint name="knee_joint" type="revolute"><parent link="thigh"/><child link="shank_foot"/>
<origin xyz="0 0 -0.2"/><axis xyz="0 1 0"/>
<limit lower="-2.0" upper="2.0" effort="30" velocity="20"/></joint>
</robot>"""


def require_built(layout):
    """A spawned rank loads the kernel libraries phase 1 built and never
    builds one: raises when a library of ``layout`` is missing."""
    from legged_gym_tpu_torch.physics import chain_kernel as ck

    for g in ck.LANE_CHOICES:
        if g >= layout[1]:
            out = ck._build_spec("cuda", ck.CUDA_NUMERICS, layout, g,
                                 ck.SOURCE)[1]
            if not os.path.isfile(out):
                raise RuntimeError(f"no kernel library {out}: phase 1 "
                                   f"builds it before the ranks start")


def go1_rough_shard():
    """go1 rough at 1800 global envs (phase 4's cell) and its train
    config."""
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    return kn.rough_cfg(GO1_ENVS), registry.get_cfgs("go1")[1]


class CollectiveClock:
    """Host seconds spent inside torch.distributed.all_reduce (the wait
    for the card's pending work included: gloo copies a CUDA tensor to
    the host), and the calls."""

    def __init__(self):
        import torch.distributed as dist
        self.seconds, self.calls, self._inner = 0.0, 0, dist.all_reduce
        dist.all_reduce = self

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self._inner(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


def update_from(env, tcfg, mesh, ckpt, batch):
    """The PPO update from checkpoint ``ckpt`` on ``batch`` (cut to this
    rank's envs): (metrics, parameters on the CPU, lr)."""
    from legged_gym_tpu_torch.rl.ppo import batch_envs
    from legged_gym_tpu_torch.rl.runner import PPORunner, fetch_metrics

    runner = PPORunner(env, tcfg, seed=SHARD_SEED)
    runner.load(ckpt)
    if mesh is not None:
        batch = batch_envs(batch, mesh.env_slice(GO1_ENVS))
    metrics = fetch_metrics(runner.learn_fn.update(runner.train_state,
                                                   batch))
    ts = runner.train_state
    return metrics, [p.detach().cpu() for p in ts.params], float(ts.lr)


def replay(env, start, gen_start, files, mine):
    """The env stepped from ``start`` (its generator at ``gen_start``)
    with the unsharded rollout's actions, cut to the envs ``mine``:
    per-step (obs, reward, done) on the CPU."""
    actions = torch.load(files["actions"], map_location=env.device)
    env.generator.set_state(gen_start)
    state, steps = start, []
    with torch.no_grad():
        for t in range(HORIZON):
            state, tr = env.step(state, actions[t][mine])
            steps.append((tr.obs, tr.reward, tr.done))
    return {k: torch.stack([s[i] for s in steps]).cpu()
            for i, k in enumerate(("obs", "reward", "done"))}


def sharded_rank(mesh, files, smi):
    """Phase 9a and 9c on one rank of a gloo group on the card.

    9a: go1 rough's share of 1800 envs through registry.make_env(mesh=) and
    PPORunner: 1 + 1 iterations from randomized episode lengths
    (the second timed, the all-reduces' host time counted), the K1
    launches of the run; then the env replayed from its start with the
    unsharded rollout's actions, and the update of the unsharded run's
    second iteration (from its checkpoint, on its batch); rank 0 holds K1
    at its share against the plain version and times it while the other
    ranks wait. 9c: MPPI and CEM at K = MPC_K over the ranks from phase
    6's planner stance, the K2 launches counted."""
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.mpc import MPCConfig, SamplingMPC
    from legged_gym_tpu_torch.physics import chain_kernel
    from legged_gym_tpu_torch.rl.runner import PPORunner
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    dev = mesh.device
    out = {"rank": mesh.rank}
    cfg, tcfg = go1_rough_shard()
    t0 = time.perf_counter()
    env, _ = registry.make_env(cfg=cfg, mesh=mesh)
    require_built(chain_kernel.model_layout(env.chain_engine.cm))
    runner = PPORunner(env, tcfg, seed=SHARD_SEED)
    out["build_s"] = time.perf_counter() - t0
    reset_launches()
    with torch.no_grad():
        runner._ensure_env_state(init_at_random_ep_len=True)
    start, gen_start = runner.env_state, env.generator.get_state()
    runner.learn(1)
    clock = CollectiveClock()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    runner.learn(1)
    torch.cuda.synchronize(dev)
    out["iter_s"] = time.perf_counter() - t0
    out["all_reduce_s"], out["all_reduce_calls"] = clock.seconds, clock.calls
    out["launches"] = dict(chain_kernel.launches)
    out["metrics"] = runner.last_metrics
    out["params"] = [p.detach().cpu() for p in runner.train_state.params]

    # the env's part of the rollout: replayed with the unsharded actions
    out["replay"] = replay(env, start, gen_start, files,
                           mesh.env_slice(GO1_ENVS))
    out["update"] = update_from(env, tcfg, mesh, files["ckpt"],
                                torch.load(files["batch"], map_location=dev))

    # K1 at the rank's share: held and timed on rank 0 alone
    if mesh.rank == 0:
        with torch.no_grad():
            hold_at("phase 9a K1 at a rank's share, after the run", env,
                    runner.env_state, smi)
            out["k1"] = time_kernel(
                f"phase 9a K1 go1 rough, {env.num_envs} envs (1 of "
                f"{mesh.world_size} ranks)", kn.step_consts(env),
                kn.kernel_args(env, runner.env_state), None, smi)
    mesh.all_sum(torch.zeros(1, device=dev))
    del runner, env

    # 9c: the planners over the ranks
    menv, _ = mpc_env("go1", "trimesh", settle=0)
    stance = load_stance(files["stance"], dev)
    commands = torch.tensor([0.8, 0.0, 0.0], device=dev)
    mcfg = MPCConfig(horizon=MPC_HORIZON, num_samples=MPC_K,
                     noise_std=0.3, temperature=0.05, cem_iters=5,
                     cem_elite_frac=0.05)
    gen = torch.Generator(device=dev).manual_seed(SHARD_SEED)
    plans = {}
    reset_launches()
    for method in ("mppi", "cem"):
        seq, info = SamplingMPC(menv, mcfg, method, mesh=mesh).plan(
            gen, stance[0], *stance[1:], commands)
        plans[method] = (seq.cpu(), float(info["best_cost"]))
    out["plans"] = plans
    out["mpc_launches"] = dict(chain_kernel.launches)
    mppi = SamplingMPC(menv, mcfg, "mppi", mesh=mesh)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(SHARD_MPC_TIMED):
        float(mppi.plan(gen, stance[0], *stance[1:], commands)[1]
              ["best_cost"])
    out["mppi_s"] = (time.perf_counter() - t0) / SHARD_MPC_TIMED
    out["mpc_launches_all"] = dict(chain_kernel.launches)
    return out


def nccl_rank(mesh, files):
    """Phase 9b on a 1-rank NCCL group: the first rollout of go1 rough at
    1800 envs from the common start (the actor's first means and the
    rollout's drift returned), the env replayed from that start with the
    unsharded actions, and the second iteration's update from the
    unsharded checkpoint on the unsharded batch. The rank's initial
    observations and parameters must be the parent's to the bit; the
    actor is evaluated on the parent's saved observations too."""
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.physics import chain_kernel
    from legged_gym_tpu_torch.rl import networks as nets
    from legged_gym_tpu_torch.rl.runner import PPORunner, fetch_metrics

    cfg, tcfg = go1_rough_shard()
    env, _ = registry.make_env(cfg=cfg, mesh=mesh)
    require_built(chain_kernel.model_layout(env.chain_engine.cm))
    runner = PPORunner(env, tcfg, seed=SHARD_SEED)
    reset_launches()
    parent = torch.load(files["inputs"])
    with torch.no_grad():
        runner._ensure_env_state(init_at_random_ep_len=True)
        model = runner.train_state.model
        if not torch.equal(runner.obs.cpu(), parent["obs"]):
            raise AssertionError("phase 9b: the rank's initial observations "
                                 "are not the unsharded run's")
        if not all(torch.equal(p.detach().cpu(), q) for p, q in
                   zip(runner.train_state.params, parent["params"])):
            raise AssertionError("phase 9b: the rank's initial parameters "
                                 "are not the unsharded run's")
        first_mean = nets.actor_mean(model, runner.obs).cpu()
        on_parent_obs = nets.actor_mean(
            model, parent["obs"].to(mesh.device)).cpu()
    start, gen_start = runner.env_state, env.generator.get_state()
    ts = runner.train_state
    _, _, batch = runner.learn_fn.rollout(ts, start, runner.obs)
    launches = dict(chain_kernel.launches)
    rollout = {k: batch[k].cpu() for k in ("obs", "action", "reward",
                                           "done")}
    own = (fetch_metrics(runner.learn_fn.update(ts, batch)),
           [p.detach().cpu() for p in ts.params], float(ts.lr))
    return {"first_mean": first_mean, "on_parent_obs": on_parent_obs,
            "rollout": rollout, "own_update": own, "launches": launches,
            "replay": replay(env, start, gen_start, files,
                             slice(None)),
            "update": update_from(env, tcfg, mesh, files["ckpt"],
                                  torch.load(files["batch"],
                                             map_location=mesh.device))}


def unsharded_reference(tmp, stance, smi):
    """Phase 9's references on the parent, unsharded, on the card: go1
    rough at 1800 envs from the same seed and start, its first rollout
    (kept: actions, obs, rewards, dones), its first update, the checkpoint,
    its second rollout's batch and update (timed); the actor's row
    difference at half the rows; MPPI and CEM from phase 6's stance with
    the ranks' draws. Files for the ranks go to ``tmp``."""
    from legged_gym_tpu_torch import registry
    from legged_gym_tpu_torch.mpc import MPCConfig, SamplingMPC
    from legged_gym_tpu_torch.rl import networks as nets
    from legged_gym_tpu_torch.rl.runner import PPORunner, fetch_metrics

    cfg, tcfg = go1_rough_shard()
    env, _ = registry.make_env(cfg=cfg, device=DEVICE)
    runner = PPORunner(env, tcfg, seed=SHARD_SEED)
    ts, fn = runner.train_state, runner.learn_fn
    with torch.no_grad():
        runner._ensure_env_state(init_at_random_ep_len=True)
        # the finding behind phase 9a's design: the actor's rows at 900
        # and at 1800 rows
        obs = runner.obs
        half = GO1_ENVS // SHARD_RANKS
        whole = nets.actor_mean(ts.model, obs)
        parts = torch.cat([nets.actor_mean(ts.model, obs[:half]),
                           nets.actor_mean(ts.model, obs[half:])])
        row_diff = float((whole - parts).abs().max())
        first_mean = whole.cpu()
        # phase 9b's inputs: the initial observations and parameters, and
        # the actor again in this process on a copy of the observations
        inputs = {"obs": obs.cpu(),
                  "params": [p.detach().cpu() for p in ts.params]}
        again = nets.actor_mean(ts.model, inputs["obs"].to(DEVICE)).cpu()
    print(f"phase 9a actor mean at {GO1_ENVS} rows vs in {SHARD_RANKS} "
          f"parts of {half} rows: max |diff| {row_diff:.3e} "
          f"({int((whole != parts).any(dim=1).sum())} of {GO1_ENVS} rows "
          f"differ) [{smi}]")
    env_state, obs_pack, first = fn.rollout(ts, runner.env_state,
                                            runner.obs)
    metrics1 = fetch_metrics(fn.update(ts, first))
    first_update = {"metrics": metrics1, "lr": float(ts.lr),
                    "params": [p.detach().cpu() for p in ts.params]}
    files = {k: os.path.join(tmp, f"{k}.pt") for k in
             ("actions", "batch", "stance", "ckpt", "inputs")}
    torch.save(inputs, files["inputs"])
    runner.save(files["ckpt"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, second = fn.rollout(ts, env_state, obs_pack)
    metrics = fetch_metrics(fn.update(ts, second))
    iter_s = time.perf_counter() - t0
    torch.save(first["action"].cpu(), files["actions"])
    torch.save({k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in second.items() if k != "ep_sums"}
               | {"ep_sums": {k: v.cpu()
                              for k, v in second["ep_sums"].items()}},
               files["batch"])
    phys, lp, fr = stance
    torch.save({"pos": phys.pos, "quat": phys.quat, "vel": phys.vel,
                "q": phys.q, "qd": phys.qd, "lp": lp, "fr": fr},
               files["stance"])
    ref = {"first": {k: first[k].cpu() for k in ("obs", "action", "reward",
                                                  "done", "value")},
           "metrics": metrics, "iter_s": iter_s,
           "params": [p.detach().cpu() for p in ts.params],
           "lr": float(ts.lr), "row_diff": row_diff,
           "first_mean": first_mean, "first_mean_again": again,
           "first_update": first_update}
    del runner, env

    menv, _ = mpc_env("go1", "trimesh", settle=0)
    commands = torch.tensor([0.8, 0.0, 0.0], device=DEVICE)
    mcfg = MPCConfig(horizon=MPC_HORIZON, num_samples=MPC_K,
                     noise_std=0.3, temperature=0.05, cem_iters=5,
                     cem_elite_frac=0.05)
    gen = torch.Generator(device=DEVICE).manual_seed(SHARD_SEED)
    ref["plans"] = {}
    with torch.no_grad():
        for method in ("mppi", "cem"):
            seq, info = SamplingMPC(menv, mcfg, method).plan(
                gen, stance[0], *stance[1:], commands)
            ref["plans"][method] = (seq.cpu(), float(info["best_cost"]))
        mppi = SamplingMPC(menv, mcfg, "mppi")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SHARD_MPC_TIMED):
            float(mppi.plan(gen, stance[0], *stance[1:], commands)[1]
                  ["best_cost"])
    ref["mppi_s"] = (time.perf_counter() - t0) / SHARD_MPC_TIMED
    return ref, files


def load_stance(path, dev):
    """An N=1 (physics, link params, friction) saved by
    unsharded_reference."""
    from legged_gym_tpu_torch.physics.state import PhysicsState

    d = torch.load(path, map_location=dev)
    return (PhysicsState(d["pos"], d["quat"], d["vel"], d["q"], d["qd"]),
            d["lp"], d["fr"])


def max_param_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def check_update(tag, got, ref, smi,
                 what="update of the second iteration from the unsharded "
                      "checkpoint on the unsharded batch"):
    """One rank's update against the unsharded one: loss within 1e-4
    relative, every parameter within 1e-4, the same learning rate."""
    metrics, params, lr = got
    loss, ref_loss = metrics["loss"], ref["metrics"]["loss"]
    err = max_param_diff(params, ref["params"])
    print(f"{tag}: {what}: loss {loss:.7f} vs "
          f"{ref_loss:.7f}, max parameter diff {err:.3e} (tol "
          f"{SHARD_PARAM_ATOL:g}), lr {lr:.3e} vs {ref['lr']:.3e}, kl "
          f"{metrics['kl']:.5f} vs {ref['metrics']['kl']:.5f} [{smi}]")
    if not (abs(loss - ref_loss) < SHARD_LOSS_RTOL * max(1.0, abs(ref_loss))
            and err < SHARD_PARAM_ATOL and lr == ref["lr"]):
        fail(f"{tag}: the sharded update differs from the unsharded one")
    return params


def row_diff(mean, ref):
    """The actor's means against the parent's first ones, for a print."""
    d = mean - ref["first_mean"]
    return (f"max |diff| {float(d.abs().max()):.3e} "
            f"({int((d != 0).any(dim=1).sum())} of {d.shape[0]} rows "
            f"differ)")


def check_rollout(tag, got, ref, n_envs, smi, shift):
    """A rank's rollout outputs against its envs of the unsharded ones:
    per env, obs and rewards within STATE_ATOL and the same dones; at most
    SWITCH_ENVS_SHARE of the envs over (phase 2's rule for a contact that
    rounding flips). ``shift``: the observations are the step's outputs
    (the unsharded batch's next step's inputs)."""
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    obs_ref = ref["obs"][shift:]
    obs_got = got["obs"][:obs_ref.shape[0]]
    e_obs = (obs_got - obs_ref).abs().amax(dim=(0, 2))
    e_rew = (got["reward"] - ref["reward"]).abs().amax(dim=0)
    done_diff = (got["done"] != ref["done"]).any(dim=0)
    over = int(((e_obs > kn.STATE_ATOL) | (e_rew > kn.STATE_ATOL)
                | done_diff).sum())
    allowed = int(kn.SWITCH_ENVS_SHARE * n_envs)
    print(f"{tag}: {HORIZON} steps, {n_envs} envs: max |obs diff| "
          f"{float(e_obs.max()):.3e}, max |reward diff| "
          f"{float(e_rew.max()):.3e}, dones differ in "
          f"{int(done_diff.sum())} envs; envs over {kn.STATE_ATOL:g}: "
          f"{over} (allowed {allowed}) [{smi}]")
    if over > allowed:
        fail(f"{tag}: {over} envs off the unsharded rollout")


def general_tree_on_card(smi):
    """Phase 9e: the prismatic slider (implicit law) and the hopper with
    the explicit spring law, TREE_STEPS general-engine sim dts from a
    seeded stance on the plane, on the card against the same on the
    CPU."""
    import numpy as np

    from legged_gym_tpu_torch.model.robot import compile_model
    from legged_gym_tpu_torch.physics.contact import ContactConfig
    from legged_gym_tpu_torch.physics.engine import Engine, SimConfig
    from legged_gym_tpu_torch.physics.params import broadcast_nominal
    from legged_gym_tpu_torch.physics.state import PhysicsState

    n = 256
    with tempfile.TemporaryDirectory() as tmp:
        for name, urdf, implicit, z in (("slider", SLIDER_URDF, True, 0.385),
                                        ("hopper", HOPPER_URDF, False,
                                         0.475)):
            path = os.path.join(tmp, f"{name}.urdf")
            with open(path, "w") as f:
                f.write(urdf)
            model = compile_model(path)
            eng = Engine(model, SimConfig(
                contact=ContactConfig(implicit=implicit)),
                kp=np.full(model.nq, 40.0), kd=np.full(model.nq, 1.0))
            g = torch.Generator().manual_seed(3)
            quat = torch.zeros((4, n))
            quat[3] = 1.0
            st = {"pos": torch.stack([0.1 * torch.randn(n, generator=g),
                                      0.1 * torch.randn(n, generator=g),
                                      torch.full((n,), z)]),
                  "quat": quat,
                  "vel": 0.2 * torch.randn((6, n), generator=g),
                  "q": 0.05 * torch.randn((model.nq, n), generator=g),
                  "qd": 0.3 * torch.randn((model.nq, n), generator=g)}
            outs = {}
            for dev in ("cpu", DEVICE):
                phys = PhysicsState(**{k: v.to(dev) for k, v in st.items()})
                lp = broadcast_nominal(model, n, device=dev)
                fr = torch.ones(n, device=dev)
                targets = torch.zeros((model.nq, n), device=dev)
                with torch.no_grad():
                    for _ in range(TREE_STEPS):
                        phys, info = eng.step_pos_targets(phys, lp, fr,
                                                          targets)[:2]
                outs[dev] = [t.cpu() for t in (phys.pos, phys.quat,
                                               phys.vel, phys.q, phys.qd,
                                               info.torques,
                                               info.body_forces)]
            err = max(float((a - b).abs().max())
                      for a, b in zip(outs["cpu"], outs[DEVICE]))
            touching = int((outs[DEVICE][6][2].sum(dim=0) > 1.0).sum())
            print(f"phase 9e {name} ({'prismatic joint, implicit' if implicit else 'explicit spring'} "
                  f"law), {n} envs, {TREE_STEPS} general-engine sim dts: "
                  f"max |card - CPU| {err:.3e} (tol {TREE_ATOL:g}), "
                  f"{touching} envs touching [{smi}]")
            if not err <= TREE_ATOL or touching == 0:
                fail(f"phase 9e {name}: card vs CPU {err}, {touching} "
                     f"envs touching")


def sharded_phase(stances, smi):
    """Phase 9: the env axis split over ranks. Returns the K1 and K2
    entries' sharded fields."""
    from legged_gym_tpu_torch.parallel import run_ranks
    from legged_gym_tpu_torch.scripts import bench_scaling
    from legged_gym_tpu_torch.scripts import kernel_numerics as kn

    t9 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ref, files = unsharded_reference(tmp, stances["planner"], smi)
        print(f"phase 9 references (unsharded, on the card): "
              f"{time.perf_counter() - t9:.1f} s [{smi}]")

        # 9a + 9c: 2 ranks of a gloo group on the one card
        t0 = time.perf_counter()
        ranks = run_ranks(sharded_rank, SHARD_RANKS, backend="gloo",
                          device=DEVICE, timeout_s=SHARD_TIMEOUT_S,
                          args=(files, smi))
        wall_a = time.perf_counter() - t0
        half = GO1_ENVS // SHARD_RANKS
        for r in ranks:
            tag = f"phase 9a rank {r['rank']} of {SHARD_RANKS} (gloo)"
            launches = r["launches"]
            want = 1 + 2 * HORIZON
            if launches["K1"] != want or sum(launches.values()) != want:
                fail(f"{tag}: kernel launches {launches} in {want} policy "
                     f"steps")
            m = r["metrics"]
            flat = [v for v in m.values() if isinstance(v, float)]
            if not all(math.isfinite(v) for v in
                       flat + list(m["episode"].values())):
                fail(f"{tag}: non-finite metrics {m}")
            lo = r["rank"] * half
            mine = {k: v[:, lo:lo + half] for k, v in ref["first"].items()}
            check_rollout(f"{tag}: the env replayed with the unsharded "
                          f"actions", r["replay"], mine, half, smi, shift=1)
            check_update(tag, r["update"], ref, smi)
        params = [r["params"] for r in ranks]
        if not all(torch.equal(a, b) for p in params[1:]
                   for a, b in zip(params[0], p)):
            fail("phase 9a: the ranks' parameters differ")
        drift = max_param_diff(params[0], ref["params"])
        iter_s = max(r["iter_s"] for r in ranks)
        share = max(r["all_reduce_s"] / r["iter_s"] for r in ranks)
        print(f"phase 9a: the whole run (2 iterations, 2 ranks): parameters "
              f"equal on the ranks; against the unsharded run max parameter "
              f"drift {drift:.3e}, loss {ranks[0]['metrics']['loss']:.7f} vs "
              f"{ref['metrics']['loss']:.7f}; K1 {want} launches per rank "
              f"[{smi}]")
        print(f"phase 9a: the second iteration {iter_s:.3f} s on "
              f"{SHARD_RANKS} ranks = {HORIZON * GO1_ENVS / iter_s:.0f} "
              f"policy-steps/s, unsharded {ref['iter_s']:.3f} s = "
              f"{HORIZON * GO1_ENVS / ref['iter_s']:.0f}; all-reduce host "
              f"time {share:.3f} of the iteration ("
              f"{ranks[0]['all_reduce_calls']} calls, {ranks[0]['all_reduce_s']:.3f} s on rank 0); "
              f"ranks built in {max(r['build_s'] for r in ranks):.1f} s "
              f"[{smi}]")

        # 9c: the planners over the ranks
        for method in ("mppi", "cem"):
            seq_ref, best_ref = ref["plans"][method]
            for r in ranks:
                seq, best = r["plans"][method]
                err = float((seq - seq_ref).abs().max())
                if not (torch.allclose(seq, seq_ref, rtol=PLAN_RTOL,
                                       atol=PLAN_ATOL)
                        and abs(best - best_ref) <= PLAN_ATOL
                        + PLAN_RTOL * abs(best_ref)):
                    fail(f"phase 9c {method} rank {r['rank']}: plan off "
                         f"the unsharded one by {err}, best cost {best} vs "
                         f"{best_ref}")
            print(f"phase 9c {method.upper()} K={MPC_K} over {SHARD_RANKS} "
                  f"ranks ({MPC_K // SHARD_RANKS} each): plan vs unsharded "
                  f"max |diff| {err:.3e} (rtol {PLAN_RTOL:g}, atol "
                  f"{PLAN_ATOL:g}), best cost {best:.5f} vs {best_ref:.5f} "
                  f"[{smi}]")
        k2_sharded = 0
        for r in ranks:
            want = MPC_HORIZON * (1 + 5)        # one MPPI, 5 CEM refits
            got = r["mpc_launches"]
            if got["K2"] != want or sum(got.values()) != want:
                fail(f"phase 9c rank {r['rank']}: launches {got}, {want} "
                     f"K2 expected")
            k2_sharded += r["mpc_launches_all"]["K2"]
        mppi_s = max(r["mppi_s"] for r in ranks)
        print(f"phase 9c: MPPI solve {1e3 * mppi_s:.2f} ms on "
              f"{SHARD_RANKS} ranks, {1e3 * ref['mppi_s']:.2f} ms "
              f"unsharded; {MPC_HORIZON} K2 launches per rank per MPPI "
              f"solve; 9a + 9c {wall_a:.1f} s [{smi}]")

        # 9b: a 1-rank NCCL group
        t0 = time.perf_counter()
        (one,) = run_ranks(nccl_rank, 1, backend="nccl", device=DEVICE,
                           timeout_s=SHARD_TIMEOUT_S, args=(files,))
        want = 1 + HORIZON
        if one["launches"]["K1"] != want \
                or sum(one["launches"].values()) != want:
            fail(f"phase 9b: launches {one['launches']}")
        first = ref["first"]
        check_rollout("phase 9b 1 rank (NCCL): the env replayed with the "
                      "unsharded actions", one["replay"], first, GO1_ENVS,
                      smi, shift=1)
        check_update("phase 9b 1 rank (NCCL)", one["update"], ref, smi)
        drift = {k: float((one["rollout"][k].float()
                           - first[k].float()).abs().max())
                 for k in ("action", "obs", "reward")}
        off = int((one["rollout"]["done"] != first["done"]).any(dim=0)
                  .sum())
        print(f"phase 9b: the rank's initial observations and parameters "
              f"equal the parent's to the bit; the actor at those "
              f"{GO1_ENVS} rows against the parent's: the rank on its own "
              f"observations {row_diff(one['first_mean'], ref)}, the rank "
              f"on the parent's saved observations "
              f"{row_diff(one['on_parent_obs'], ref)}, the parent again on "
              f"a copy of its observations "
              f"{row_diff(ref['first_mean_again'], ref)} [{smi}]")
        print(f"phase 9b: the rank's own rollout (policy and "
              f"draws) against the unsharded one: max |diff| "
              + ", ".join(f"{k} {v:.3e}" for k, v in drift.items())
              + f", dones differ in {off} envs [{smi}]")
        # the rank's own first iteration equals the unsharded one
        check_rollout("phase 9b 1 rank (NCCL): its own first rollout",
                      one["rollout"], first, GO1_ENVS, smi, shift=0)
        check_update("phase 9b 1 rank (NCCL)", one["own_update"],
                     ref["first_update"], smi,
                     what="its own first update")
        print(f"phase 9b: {time.perf_counter() - t0:.1f} s [{smi}]")

    # 9d: bench_scaling on the card
    t0 = time.perf_counter()
    scaling = bench_scaling.run(SCALING_ENVS, [1, SHARD_RANKS],
                                device=DEVICE, timeout_s=SHARD_TIMEOUT_S)
    print(f"phase 9d bench_scaling go1 {SCALING_ENVS} envs: "
          + "; ".join(f"{nr} ranks {v['env_steps_per_s']:.0f} env-steps/s "
                      f"({v['backend']})" for nr, v in scaling.items())
          + f"; {time.perf_counter() - t0:.1f} s [{smi}]")

    # 9e: the general tree on the card
    t0 = time.perf_counter()
    general_tree_on_card(smi)
    print(f"phase 9e: {time.perf_counter() - t0:.1f} s [{smi}]")

    # K2 at a rank's share of the candidates, from the riser stance
    r_env, stance = stances["riser"]
    k = MPC_K // SHARD_RANKS
    tag = f"phase 9c K2 go1 trimesh MPC step, {k} rollouts (1 of {SHARD_RANKS} ranks)"
    gen = torch.Generator(device=DEVICE).manual_seed(SHARD_SEED)
    cc = r_env.chain_engine.cc
    with torch.no_grad():
        args = mpc_step_args(r_env, *stance, gen, k=k)
        errs, _ = hold_kernel(f"{tag} [riser stance]", "K2", cc, args, None,
                              smi, settled=True,
                              switch_share=kn.SWITCH_ENVS_SHARE,
                              floors=(k // 2, 10))
        k2 = time_kernel(f"{tag} [riser stance]", cc, args, None, smi)
    k1 = ranks[0]["k1"]
    print(f"phase 9: {time.perf_counter() - t9:.1f} s [{smi}]")
    return ({"launches_sharded": sum(r["launches"]["K1"] for r in ranks)
             + one["launches"]["K1"],
             "sharded_shape": f"go1 rough, {half} envs (1 of "
                              f"{SHARD_RANKS} ranks)",
             "sharded_ms": k1["ms"], "sharded_plain_ms": k1["plain_ms"],
             "sharded_bound_ms": k1["bound_ms"],
             "sharded_bound_by": k1["bound_by"]},
            {"launches_sharded": k2_sharded,
             "mpc_sharded_shape": f"go1 trimesh, {k} envs (1 of "
                                  f"{SHARD_RANKS} ranks), riser stance",
             "mpc_sharded_max_abs_err": max(errs[n] for n in kn.NAMES[:6]),
             "mpc_sharded_ms": k2["ms"],
             "mpc_sharded_plain_ms": k2["plain_ms"],
             "mpc_sharded_bound_ms": k2["bound_ms"],
             "mpc_sharded_bound_by": k2["bound_by"]})


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
    reset_launches()
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
    k1_train, go1_runner = train_path("go1 rough 1800", env, "go1",
                                      GO1_TRAIN_ITERS, "K1", smi)
    k4_train, _ = train_path("aliengo 4096", ali_env, "aliengo",
                             ALIENGO_TRAIN_ITERS, "K4", smi)
    k2_train, _ = train_path("cassie 4096", cas_env, "cassie",
                             CASSIE_TRAIN_ITERS, "K2", smi)
    k3_train, any_runner = train_path(
        "anymal_c_rough 4096", any_env, "anymal_c_rough",
        ANYMAL_TRAIN_ITERS, "K3", smi,
        per_step=any_env.cfg.control.decimation)
    replayed_launches("anymal_c_rough 4096", any_env, any_runner.env_state,
                      "K3", any_env.cfg.control.decimation, smi)
    del any_runner
    del ali_env, cas_env, any_env

    # ---- phase 5: the general stacked engine ----
    gen_cfg = kn.rough_cfg(GO1_ENVS)
    gen_cfg.sim.use_chain_engine = False
    gen_env, _ = registry.make_env(cfg=gen_cfg, device=DEVICE)
    check_general("go1 rough 1800, general engine vs K2", gen_env, smi, "K2")
    # one substep per sim dt: the kernel's plane per sim dt is then the
    # general engine's per-substep sample (at 4 they are two laws on rough
    # terrain: the chain holds each point's tangent plane for 4 substeps)
    gen_cfg, _ = registry.get_cfgs("anymal_c_rough")
    gen_cfg.sim.use_chain_engine = False
    gen_cfg.sim.substeps = 1
    gen_env, _ = registry.make_env(cfg=gen_cfg, device=DEVICE)
    if gen_env.num_envs != TASK_ENVS or gen_env.grid.wall_thresh <= 0:
        fail(f"anymal_c_rough: {gen_env.num_envs} envs, not on trimesh "
             f"with the wall rule")
    check_general("anymal_c_rough 4096 (1 substep), general engine vs "
                  "K3+K4+wall", gen_env, smi, "K3")
    del gen_env
    flat_env, _ = registry.make_env("anymal_c_flat", device=DEVICE)
    if flat_env.num_envs != TASK_ENVS or flat_env.chain_engine is not None \
            or flat_env.general_reasons != ["self-collision"] \
            or len(flat_env.engine.sc_pairs) != 150:
        fail(f"anymal_c_flat: {flat_env.num_envs} envs, physics path "
             f"{flat_env.general_reasons}")
    _, flat_runner = train_path(
        "anymal_c_flat 4096 (general engine)", flat_env, "anymal_c_flat",
        FLAT_TRAIN_ITERS, None, smi, width=(128, 64, 32))
    check_self_collision("anymal_c_flat 4096", flat_env,
                         flat_runner.env_state, smi)
    reset_launches()
    profile_steps("anymal_c_flat 4096 (general engine)", flat_env,
                  flat_runner.env_state, smi)
    if any(chain_kernel.launches.values()):
        fail(f"anymal_c_flat launched the kernel: {chain_kernel.launches}")
    profile_steps("go1 rough 1800 (chain path, K1)", env,
                  go1_runner.env_state, smi)
    for over in ({"control.control_type": "V"},
                 {"control.control_type": "T"},
                 {"control.actuator_net_discard_output": False},
                 {"asset.linear_damping": 0.1, "asset.angular_damping": 0.1}):
        other_drive(over, smi)

    # ---- phases 6-8: MPC, the recurrent policy, play / export / teleop ----
    mpc_entry, k2_mpc, k4_mpc, stances = mpc_phase(smi)
    k1_lstm, lstm_runner = lstm_phase(smi)
    k1_play = play_phase(go1_runner, lstm_runner, smi)
    del go1_runner, lstm_runner, env, flat_env, flat_runner, go1_env

    # ---- phase 9: the env axis split over ranks, the general tree ----
    k1_sharded, k2_sharded = sharded_phase(stances, smi)

    # ---- phase 10: kernel table, card, result ----
    line = {"kernels": [
        dict({"name": "run_decimation (K1)",
              "route": "cuda",
              "source": "legged_gym_tpu_torch/physics/csrc/chain_step.cu",
              "replaces": "legged_gym_tpu/physics/pallas_step.py:67",
              "config": "K1",
              "launches": rollout_launches + k1_train + k1_lstm + k1_play
              + k1_sharded["launches_sharded"],
              "launches_rollout": rollout_launches,
              "launches_train": k1_train,
              "launches_train_lstm": k1_lstm,
              "launches_play_teleop": k1_play}, **entry_k1, **k1_sharded),
        dict({"name": "run_decimation (K4)",
              "route": "cuda",
              "source": "legged_gym_tpu_torch/physics/csrc/chain_step.cu",
              "replaces": "legged_gym_tpu/physics/pallas_step.py:67",
              "config": "K4",
              "launches": k4_train + k4_mpc,
              "launches_train": k4_train,
              "launches_mpc": k4_mpc}, **entry_k4),
        dict({"name": "run_decimation (K2)",
              "route": "cuda",
              "source": "legged_gym_tpu_torch/physics/csrc/chain_step.cu",
              "replaces": "legged_gym_tpu/physics/pallas_step.py:67",
              "config": "K2",
              "launches": k2_train + k2_mpc
              + k2_sharded["launches_sharded"],
              "launches_train": k2_train,
              "launches_mpc": k2_mpc}, **entry_k2, **mpc_entry,
             **k2_sharded),
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
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s on the card "
          f"machine, kernel builds included")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
