"""The fused physics kernel against its plain PyTorch version, env by env,
at the main paths' shapes on the card: K1 for go1 on rough terrain at 1800
envs, K4 (friction anchors) for aliengo on the plane, K2 (trimesh wall
rule) for cassie and K3 + K4 + wall rule (one SEA segment of held torques)
for anymal_c_rough, each at its own 4096 envs.

    python -m legged_gym_tpu_torch.scripts.kernel_numerics \
        [--task aliengo|cassie|anymal_c_rough]
    python -m legged_gym_tpu_torch.scripts.kernel_numerics \
        --sweep [--parent OTHER.cu]

For a fresh reset, the state after the reset step and a settled state
(30 zero-action steps), it prints per output the max / 99th percentile /
median over envs of |kernel - plain| and the envs over tolerance, for the
kernel built with and without fused multiply-add contraction, and for the
plain version run on the CPU (the spread of the reference itself). With
``--seeds N`` it instead sweeps env seeds 0 .. N-1 on the settled state
(seed_sweep). With ``--sweep`` it times, on the settled state, for K1 (go1
rough, 1800 and 4096 envs), K4 (aliengo, 4096), K2 (cassie, 4096 and
1800), K3 + K4 (anymal_c_rough, 4096) and K1 on a1's layout (4096), the
kernel built with each candidate lane count per env (G_LANES) and, with ``--parent``, another revision of the .cu source
built by the same wrapper with the same flags, in turns (parent, this
source, this source, parent); every build is first held against the plain
version (lane_sweep). Also holds the helpers that chip_smoke.py uses.
"""
from __future__ import annotations

import dataclasses
import os

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
# a contact that switches state one substep apart (depth > 0, v_n < 5 cm/s
# are thresholds) changes that substep's force by the whole contact force,
# so among 4096 settled envs of a heavy robot on stiff contacts (anymal:
# 52 kg, 4 substeps per sim dt; cassie mid-fall on two toes) float32
# rounding in another order moves a few envs by far more than rounding.
# The plain version does that to itself: run on the CPU and on the card
# for the same inputs it differs in 1-3 cassie envs and 22-33 anymal envs
# (body_f up to 324 N, q up to 1.1e-2), and the kernel differs from the
# card's run in 1-2 and 19-23 envs, from the CPU's run in 0-2 and 3-13
# (``--seeds 4`` of this script on an NVIDIA H100 80GB HBM3, 700 W, env
# seeds 0-3 of cassie and anymal_c_rough). An env where rounding flips a
# contact is one where the two plain runs disagree, and there the kernel
# follows one of them: over those 8 x 4096 envs it was over tolerance
# against both plain runs in 1 env (none on 7 of the 8 seeds). So on those
# paths a settled env passes when every output is within tolerance of the
# plain version on the card or of the plain version on the CPU, and at
# most this share of the envs (2 of 4096) may fail both
SWITCH_ENVS_SHARE = 0.0005


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


def step_consts(env):
    """The ChainConsts of one kernel launch on the env's path: the engine's
    own, or its torque-drive twin (one sim dt) where the SEA net drives."""
    ce = env.chain_engine
    return ce.cc_sea if env._sea is not None else ce.cc


def kernel_args(env, state, sea_seed=0):
    """Kernel arguments for ``state``: default-pose targets and the cached
    contact window (the center crop of the state's terrain window; on a
    plane the engine's zero window). On the SEA path the targets are held
    torques of the net's order, normal with 40 N*m standard deviation from
    ``sea_seed`` (some beyond the effort limit, so the clip is exercised)."""
    patch = None
    if env.grid is not None:
        lo = (env.patch_cache_S - env.contact_patch_S) // 2
        hi = lo + env.contact_patch_S
        patch = (state.patch_T[lo:hi, lo:hi].contiguous(),
                 state.patch_r0 + lo, state.patch_c0 + lo)
    targets = env._dflt.expand(env.num_dof, state.n)
    if env._sea is not None:
        gen = torch.Generator(device=env.device).manual_seed(sea_seed)
        targets = 40.0 * torch.randn((env.num_dof, state.n), generator=gen,
                                     device=env.device, dtype=env.dtype)
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


# anchors [m]: positions of contact points, carried like pos
ANCHOR_ATOL = STATE_ATOL
# an anchor below this is live; the sentinel is 1e6
ANCHOR_LIVE = 1e5


def anchor_errors(ref, out):
    """Packed anchors (3, n_points, N) of the plain version and the kernel:
    (max |ref - out| where both are live, entries live in both, entries
    whose live / sentinel state differs)."""
    live_r, live_o = ref < ANCHOR_LIVE, out < ANCHOR_LIVE
    both = live_r & live_o
    err = float(((ref - out).abs() * both).max()) if both.any() else 0.0
    return err, int(both.sum()), int((live_r != live_o).sum())


def over_tolerance(errs, tol):
    """Indices of envs with any output over its tolerance."""
    bad = None
    for name, e in errs.items():
        b = e > tol[name]
        bad = b if bad is None else bad | b
    return torch.nonzero(bad).flatten().tolist()


def contact_envs(out):
    """(N,) bool: envs whose contact sensor reads more than 1 N upward in
    ``out`` (the 7 outputs of a step)."""
    return out[6][2].sum(dim=0) > 1.0


def wall_rule_envs(cc, cv, args):
    """(N,) bool: envs where, at the entry state of ``args``, the trimesh
    wall rule changes a contact: some contact point lies over a query cell
    whose corners spread more than ``cc.wall_thresh`` and below the
    bilinear surface there, so it touches with the rule off and touches
    less, or not at all, against the rule's flat floor."""
    ph, r0, c0 = args[4:7]
    fk = chain_step.fk_chain(cc, cv, *args[7:12])
    no_wall = dataclasses.replace(cc, wall_thresh=0.0)
    hit = torch.zeros(ph.shape[-1], dtype=torch.bool, device=ph.device)
    for gi in range(len(cc.cm.groups)):
        p, _ = chain_step.contact_points_group(cc, cv, fk, gi)
        h, _, _ = chain_step.sample_patch_plane(cc, cv, ph, r0, c0, p[0],
                                                p[1])
        h0, _, _ = chain_step.sample_patch_plane(no_wall, cv, ph, r0, c0,
                                                 p[0], p[1])
        hit |= ((h < h0) & (p[2] < h0)).flatten(0, -2).any(dim=0)
    return hit


def plain_on_cpu(cc, args, anchors):
    """The plain version's outputs for card inputs, computed on the CPU:
    beside its outputs on the card they show what float32 rounding in
    another order alone does to this state."""
    return chain_step.run_decimation_chain(
        cc, *[a.cpu() for a in args],
        anchors=None if anchors is None else anchors.cpu())


def envs_over(ref, out, settled, ref_cpu=None):
    """Envs where some output of ``out`` is over its tolerance against
    ``ref`` and, when ``ref_cpu`` (plain_on_cpu) is given, against that
    too."""
    tol = tolerances(settled)
    bad = set(over_tolerance(per_env_errors(ref, out), tol))
    if ref_cpu is not None and bad:
        out_cpu = [o.cpu() for o in out[:7]]
        bad &= set(over_tolerance(per_env_errors(ref_cpu, out_cpu), tol))
    return sorted(bad)


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


def launch_bytes(cc, tensors):
    """Bytes one launch must move: each tensor of ``tensors`` (inputs
    without the contact patch, constant table, outputs, anchors both ways)
    once, and of each env's contact patch only the cells a launch can
    read: the four corners of the query cell of each contact point, once
    per plane sampling (one, or one per sim dt)."""
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    samplings = 1 if cc.plane_per_step else cc.decimation
    cells = min(cc.patch_S ** 2, 4 * chain_step.n_points(cc.cm) * samplings)
    n = tensors[0].shape[-1]
    return n_bytes + 4 * cells * n


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


def seed_sweep(task, seeds):
    """For each env seed: the settled state's envs over tolerance and the
    largest errors of the kernel against the plain version on the card
    and on the CPU, beside the plain version against itself, with the envs
    in contact and the envs where the wall rule changes a contact.
    SWITCH_ENVS_SHARE is set from this."""
    for seed in seeds:
        env, _ = registry.make_env(task, seed=seed, device="cuda")
        cc = step_consts(env)
        cv = chain_step.const_tensors(cc, "cuda")
        state = env.initial_state()
        zeros = torch.zeros((env.num_envs, env.num_actions), device="cuda")
        for _ in range(30):
            state, _ = env.step(state, zeros)
        args = kernel_args(env, state, sea_seed=seed)
        anchors = state.contact_ws
        ref = chain_step.run_decimation_chain(cc, *args, cv=cv,
                                              anchors=anchors)
        out = chain_kernel.run_decimation(cc, *args, anchors=anchors)
        torch.cuda.synchronize()
        tol = tolerances(settled=True)
        wall = wall_rule_envs(cc, cv, args) if cc.wall_thresh > 0 else None
        print(f"[{task} seed {seed}] {int(contact_envs(ref).sum())} of "
              f"{env.num_envs} envs in contact, "
              f"{0 if wall is None else int(wall.sum())} where the wall "
              f"rule changes a contact", flush=True)
        ref_cpu = plain_on_cpu(cc, args, anchors)
        out_cpu = [o.cpu() for o in out]
        pairs = (("kernel vs plain", per_env_errors(ref, out)),
                 ("kernel vs plain on the CPU",
                  per_env_errors(ref_cpu, out_cpu)),
                 ("plain CPU vs card",
                  per_env_errors(ref_cpu, [r.cpu() for r in ref])))
        print(f"[{task} seed {seed}] envs where the kernel is over "
              f"tolerance against both plain runs: "
              f"{envs_over(ref, out, True, ref_cpu)}")
        for tag, errs in pairs:
            bad = over_tolerance(errs, tol)
            n_wall = 0 if wall is None else int(wall.cpu()[bad].sum())
            print(f"[{task} seed {seed}] {tag}: {len(bad)} envs over "
                  f"tolerance ({n_wall} of them wall-rule envs); max "
                  + ", ".join(f"{k} {float(v.max()):.3e}"
                              for k, v in errs.items()), flush=True)


# lane counts per env timed by --sweep, by chain count, and the rows:
# (task, variant, envs) at each main path's env count, and go1 / cassie at
# the other one, where the launch's choice of G flips (launch_library)
SWEEP_LANES = {2: (2, 4, 8, 16), 4: (8, 16, 32)}
SWEEP_ROWS = (("go1", "K1", 1800), ("go1", "K1", 4096),
              ("aliengo", "K4", 4096), ("cassie", "K2", 4096),
              ("cassie", "K2", 1800), ("anymal_c_rough", "K3", 4096),
              ("a1", "K1", 4096))


def ptxas_report(log):
    """The assembler's register / stack / spill report of a build log, one
    line per kernel instantiation (``WARM=0``: K1 / K2 / K3 without
    anchors, ``WARM=1``: with them)."""
    out, name, props = [], None, []
    for line in log.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            sym = line.split("Function properties for")[-1].strip()
            name = ("chain_step_kernel<WARM=1>" if "ILb1E" in sym else
                    "chain_step_kernel<WARM=0>" if "ILb0E" in sym else sym)
            props = []
        elif "spill" in line:
            props.append(line)
        elif "registers" in line:
            regs = line.split("Used", 1)[-1].split(",")[0].strip()
            out.append(f"{name or 'kernel'}: {regs}, "
                       + ", ".join(props + [line.split(", ")[-1]]))
            name, props = None, []
    return out


def sweep_env(task, n):
    """The env of one sweep row: go1 as rough_cfg, any other task as
    registered, at n envs."""
    if task == "go1":
        cfg = rough_cfg(n)
    else:
        cfg, _ = registry.get_cfgs(task)
        cfg.env.num_envs = n
    return registry.make_env(cfg=cfg, device="cuda")[0]


def lane_sweep(parent=None, reps=200, out_path=None):
    """Build every candidate G_LANES of each row's layout (and ``parent``,
    another .cu revision) in one parallel build, hold each build against
    the plain version on the fresh and the settled state, then time them
    on the settled state, the kernel alone on buffers prepared once: the
    sweep, and parent / this / this / parent turns at the G the launch
    takes (chain_kernel.launch_library). Returns the records (also written
    as JSON to ``out_path``)."""
    import json
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    envs = [sweep_env(task, n) for task, _, n in SWEEP_ROWS]
    builds = {}     # (layout, lanes, source) -> label
    for env in envs:
        layout = chain_kernel.model_layout(step_consts(env).cm)
        for g in SWEEP_LANES[layout[1]]:
            builds[(layout, g, chain_kernel.SOURCE)] = f"G={g}"
        if parent:
            builds[(layout, 1, parent)] = "parent"
    keys = list(builds)
    libs = dict(zip(keys, chain_kernel.build_libraries(
        [k[0] for k in keys], lanes=[k[1] for k in keys],
        source=[k[2] for k in keys])))
    records = []
    for (layout, g, src), lib in libs.items():
        log = chain_kernel.build_log.get(chain_kernel.library_key(
            "cuda", chain_kernel.CUDA_NUMERICS, layout, g, src), "")
        lay = chain_kernel.library_layout(lib)
        rec = dict(layout=list(layout), build=builds[(layout, g, src)],
                   G_LANES=lay["G_LANES"],
                   shared_bytes_per_env=lay["SHARED_PER_ENV"],
                   ptxas=ptxas_report(log))
        records.append(rec)
        print(f"[{layout} {rec['build']}] shared/env "
              f"{lay['SHARED_PER_ENV']} B; " + " | ".join(rec["ptxas"]),
              flush=True)
    for (task, variant, n), env in zip(SWEEP_ROWS, envs):
        row = f"{task} {n}"
        cc = step_consts(env)
        layout = chain_kernel.model_layout(cc.cm)
        cands = [(builds[k], lib) for k, lib in libs.items()
                 if k[0] == layout]
        cv = chain_step.const_tensors(cc, "cuda")
        table = torch.as_tensor(chain_kernel.const_table(cc), device="cuda")
        state = env.initial_state()
        zeros = torch.zeros((env.num_envs, env.num_actions), device="cuda")
        chosen = "G=%d" % chain_kernel.library_layout(
            chain_kernel.launch_library(layout, n, env._warm_start)
        )["G_LANES"]
        share = SWITCH_ENVS_SHARE if variant in ("K2", "K3") else 0.0
        rows = {label: dict(row=row, variant=variant, build=label)
                for label, _ in cands}
        for label_s, steps in (("fresh", 0), ("settled", 30)):
            for _ in range(steps):
                state, _ = env.step(state, zeros)
            args = kernel_args(env, state)
            anchors = state.contact_ws
            settled = steps > 0
            ref = chain_step.run_decimation_chain(cc, *args, cv=cv,
                                                  anchors=anchors)
            ref_cpu = plain_on_cpu(cc, args, anchors) \
                if settled and share else None
            for label, lib in cands:
                out = chain_kernel.launch(lib, cc, args, table, anchors)
                torch.cuda.synchronize()
                over = envs_over(ref, out, settled, ref_cpu)
                errs = {k: float(v.max())
                        for k, v in per_env_errors(ref, out).items()}
                entry = dict(envs_over=len(over),
                             allowed=int(share * env.num_envs)
                             if settled else 0,
                             max_err=errs)
                if anchors is not None:
                    err, _, n_diff = anchor_errors(ref[7], out[7])
                    entry.update(anchor_err=err, anchor_live_diff=n_diff)
                rows[label][label_s] = entry
                print(f"[{row} {label} {label_s}] envs over "
                      f"{len(over)} (allowed {entry['allowed']}), "
                      + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                      + (f", anchors {entry['anchor_err']:.2e} m / "
                         f"{entry['anchor_live_diff']} live diff"
                         if anchors is not None else ""), flush=True)
        # settled state: the sweep (the kernel alone and through the
        # wrapper), then the turns
        alone = {label: chain_kernel.bind_launch(lib, cc, args, table,
                                                 anchors)[0]
                 for label, lib in cands}
        for label, lib in cands:
            rec = rows[label]
            rec["ms"] = cuda_ms(alone[label], reps)
            rec["wrapper_ms"] = cuda_ms(lambda: chain_kernel.launch(
                lib, cc, args, table, anchors), reps)
            print(f"[{row} {label}] kernel alone {rec['ms']:.4f} "
                  f"ms/launch, through the wrapper {rec['wrapper_ms']:.4f} "
                  f"[{smi}]", flush=True)
        fastest = min(rows, key=lambda lb: rows[lb]["ms"]
                      if lb != "parent" else float("inf"))
        print(f"[{row}] the launch takes {chosen}; fastest {fastest}",
              flush=True)
        records += list(rows.values())
        if parent:
            turns = [(label, cuda_ms(alone[label], reps))
                     for label in ("parent", chosen, chosen, "parent")]
            new = [t for lb, t in turns if lb != "parent"]
            old = [t for lb, t in turns if lb == "parent"]
            print(f"[{row} {variant} turns, kernel alone] " + ", ".join(
                f"{lb} {t:.4f}" for lb, t in turns)
                + f" ms/launch: parent / this = "
                f"{sum(old) / sum(new):.2f}x [{smi}]", flush=True)
            records.append(dict(row=row, variant=variant, turns=turns,
                                chosen=chosen, fastest=fastest,
                                speedup=sum(old) / sum(new), card=smi))
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(dict(card=smi, reps=reps, records=records), f,
                      indent=1)
    return records


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="go1",
                    help="go1: K1 on rough terrain at 1800 envs; any other "
                         "registered task as it is (aliengo: K4; cassie: "
                         "K2; anymal_c_rough: K3 + K4 + wall rule)")
    ap.add_argument("--seeds", type=int, default=0,
                    help="instead: the settled-state comparison for env "
                         "seeds 0 .. SEEDS-1 (seed_sweep)")
    ap.add_argument("--sweep", action="store_true",
                    help="instead: time each task's candidate lane counts "
                         "per env (lane_sweep)")
    ap.add_argument("--parent", default=None,
                    help="with --sweep: another revision of the .cu "
                         "source, timed in turns against this one")
    ap.add_argument("--out", default="chiprun_out/lane_sweep.json",
                    help="with --sweep: where the records go (JSON)")
    ns = ap.parse_args(argv)
    task = ns.task
    if ns.sweep:
        return lane_sweep(ns.parent, out_path=ns.out)
    if ns.seeds:
        return seed_sweep(task, range(ns.seeds))
    if task == "go1":
        env, _ = registry.make_env(cfg=rough_cfg(), device="cuda")
    else:
        env, _ = registry.make_env(task, device="cuda")
    cc = step_consts(env)
    print(f"{task}: kernel variant "
          f"{chain_step.variant(cc, env._warm_start)}, layout "
          f"{chain_kernel.model_layout(cc.cm)}, {env.num_envs} envs")
    layout = chain_kernel.model_layout(cc.cm)
    cv = chain_step.const_tensors(cc, "cuda")
    table = torch.as_tensor(chain_kernel.const_table(cc), device="cuda")
    no_fma = chain_kernel.launch_library(layout, env.num_envs,
                                         env._warm_start)
    lanes = chain_kernel.library_layout(no_fma)["G_LANES"]
    libs = {"no-fma": no_fma,
            "fma": chain_kernel.load_library("cuda", numerics=(),
                                             layout=layout, lanes=lanes)}
    print(f"G_LANES {lanes}")
    for line in ptxas_report(chain_kernel.build_log.get(
            chain_kernel.library_key("cuda", chain_kernel.CUDA_NUMERICS,
                                     layout, lanes), "")):
        print(f"ptxas: {line}")
    state = env.initial_state()
    zeros = torch.zeros((env.num_envs, env.num_actions), device="cuda")
    for label, steps in (("fresh reset", 0), ("reset step", 1),
                         ("settled", 29)):
        for _ in range(steps):
            state, _ = env.step(state, zeros)
        args = kernel_args(env, state)
        anchors = state.contact_ws
        settled = label == "settled"
        ref = chain_step.run_decimation_chain(cc, *args, cv=cv,
                                              anchors=anchors)
        ref_cpu = plain_on_cpu(cc, args, anchors)
        _report(f"[{label}] plain on CPU vs card", [r.cpu() for r in ref],
                ref_cpu, settled)
        for name, lib in libs.items():
            out = chain_kernel.launch(lib, cc, args, table, anchors)
            torch.cuda.synchronize()
            _report(f"[{label}] kernel {name} vs plain", ref, out, settled)
            if anchors is not None:
                err, n_live, n_diff = anchor_errors(ref[7], out[7])
                print(f"[{label}] kernel {name} anchors: max err {err:.2e} "
                      f"over {n_live} live entries, {n_diff} differ in "
                      f"live / sentinel state", flush=True)
            ms = cuda_ms(lambda: chain_kernel.launch(lib, cc, args, table,
                                                     anchors), 50)
            print(f"[{label}] kernel {name}: {ms:.4f} ms/launch", flush=True)


if __name__ == "__main__":
    main()
