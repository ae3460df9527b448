"""Training cells: full PPO iterations through ``PPORunner.learn``, the
users' path (``registry.make_env`` / ``make_runner``, no run dir).

Set-up builds the env and the runner, loads the benchmark's weights, and
drives the runner through its first ``checked_steps`` iterations in one
``learn`` call, the schedule of the window (its depth-1 pipelined metrics
fetch included): these warm up every shape the window uses, and they are
the iterations the check follows. While the call runs the harness copies
on the card, with no wait for it, at the env's ``step`` every call's
actions and outputs and for a sample of calls drawn from the seed the
state going in (and the env's generator), and before each iteration the
train state (weights, Adam's moments, the learning rate, the noise and
minibatch generators); the copies come to the host once the call has
returned. The window then drives the same runner with ``learn(k)``, k
estimated from the checked call so that a window takes as few calls as
it can; the rate counts the whole iterations of every call over the time
to the end of the last (``learn`` ends by fetching its last metrics, so
each call ends synced).

The check follows the program step by step from its own state, since the
env is chaotic (a contact that rounding flips in one env of thousands
moves a whole rollout): the reference (reference/, the port's plain path
frozen, the physics step in plain PyTorch) takes each recorded state and
input and computes the same step.
- The start and the env steps: the reference's own reset from the seed,
  and each sampled env step from the program's state with its actions
  and generator: ``env_gap``, ``env_miss_share`` and ``reset_gap``
  (``follow.env_numbers``).
- Each iteration: the reference's rollout policy (forward pass, action
  draw) over the program's observations, with the program's transitions
  replayed as its env, then GAE and the PPO update from the program's
  train state. ``action_gap``: the largest difference of an action;
  ``loss_gap``: the largest gap of an iteration's mean loss over the mean
  size of the reference's; ``grad_gap``: after the first iteration,
  Adam's first moment (the gradients as the optimizer holds them), worst
  leaf: the gap of the leaf's norms over the larger of the reference
  leaf's norm and the median leaf's; ``change_gap``: the parameters'
  change over the checked iterations, worst leaf, the same measure.
  Leaves whose reference moment is under a thousandth of the median
  leaf's (gradients nought to rounding) are left out of the leaf
  measures.
"""
from __future__ import annotations

import time

import torch

from benchmark import follow, spec, weights as bench_weights
from benchmark.work import flops

SMALL_LEAF = 1e-3


def _train_state(ts):
    """A copy of the program's train state, left on the device (weights,
    Adam's moments, the learning rate) with the generators' states."""
    return {"params": follow.device_copy(list(ts.model.parameters())),
            "mu": follow.device_copy(ts.opt_state.mu),
            "nu": follow.device_copy(ts.opt_state.nu),
            "count": ts.opt_state.count, "lr": follow.device_copy(ts.lr),
            "noise": ts.noise_generator.get_state(),
            "perm": ts.perm_generator.get_state()}


def _record(runner, env, model_weights, iterations, sample):
    """Run the checked iterations in one ``learn`` call, the schedule of
    the window, recording what the check follows. The runner's
    ``learn_fn`` and ``_log`` are wrapped for the call (both put back
    after it): the first copies the train state going into each
    iteration, the second keeps each iteration's logged loss as the
    runner's pipelined fetch brings it. Every copy stays on the card
    until the call has returned."""
    runner.train_state.model.load_state_dict(model_weights, strict=True)
    names = [n for n, _ in runner.train_state.model.named_parameters()]
    real_learn, real_log = runner.learn_fn, runner._log
    before, losses = [], []

    def learn_iteration(ts, env_state, obs):
        before.append((_train_state(ts), recorder.count))
        return real_learn(ts, env_state, obs)

    def log(metrics, it):
        losses.append(float(metrics["loss"]))
        real_log(metrics, it)

    with follow.Recorder(env, sample) as recorder:
        runner.learn_fn, runner._log = learn_iteration, log
        try:
            t0 = time.perf_counter()
            runner.learn(iterations, init_at_random_ep_len=True)
            seconds = time.perf_counter() - t0
        finally:
            runner.learn_fn = real_learn
            del runner._log
        after = _train_state(runner.train_state)
        calls_after = [c for _, c in before[1:]] + [recorder.count]
    rec = {"names": names, "calls": recorder.host(),
           "iteration_s": seconds / iterations,
           "iterations": [{"before": follow.host(state), "calls_after": c,
                           "loss": loss}
                          for (state, _), c, loss in zip(before, calls_after,
                                                         losses)],
           "after": follow.host(after)}
    # Adam's first moment after the first iteration
    rec["moment"] = (rec["iterations"][1]["before"]["mu"] if iterations > 1
                     else rec["after"]["mu"])
    return rec


class Program:
    """The port's runner for one cell, from set-up to the end of the
    window."""

    def __init__(self, cell, seeds, device, iterations):
        from legged_gym_tpu_torch import config as port_config, registry

        self.cell = cell
        self.device = torch.device(device)
        env_cfg, train_cfg = spec.build_cfgs(port_config, cell.config,
                                             cell.num_envs)
        train_cfg.seed = seeds.train
        self.env, _ = registry.make_env(cfg=env_cfg, seed=seeds.env,
                                        device=device)
        self.runner, _ = registry.make_runner(self.env, train_cfg=train_cfg,
                                              log_root=None)
        self.weights = bench_weights.make(
            self.runner.train_state.model, seeds.weights,
            cell.config["policy"]["init_noise_std"], device)
        self.steps_per_iteration = (cell.config["runner"]["num_steps_per_env"]
                                    * cell.num_envs)
        calls = 1 + iterations * cell.config["runner"]["num_steps_per_env"]
        self.readings = _record(self.runner, self.env, self.weights,
                                iterations, follow.sampled_calls(
                                    seeds.traffic, calls))
        self.readings["steps"] = cell.config["runner"]["num_steps_per_env"]

    def window(self, seconds, spans=False):
        """Drive ``learn`` for ``seconds``. Returns the window's record:
        its time, iterations, steps and (``spans``) the PPO halves' synced
        times from ``learn_iteration.profile``."""
        learn_fn = self.runner.learn_fn
        learn_fn.profile = spans
        learn_fn.times.clear()
        per_iteration = max(self.readings["iteration_s"], 1e-3)
        iterations = 0
        t0 = time.perf_counter()
        while True:
            remaining = seconds - (time.perf_counter() - t0)
            if iterations and remaining < 0.5 * per_iteration:
                break
            k = max(1, round(remaining / per_iteration))
            self.runner.learn(k)
            iterations += k
        elapsed = time.perf_counter() - t0
        learn_fn.profile = False
        return {"seconds": elapsed, "iterations": iterations,
                "units": iterations,
                "steps": iterations * self.steps_per_iteration,
                "spans": list(learn_fn.times)}

    def flops_per_unit(self):
        """Counted operations of one iteration (work/flops.py)."""
        return flops.train_iteration_flops(self.cell.config, self.cell.work(),
                                           self.cell.num_envs)

    def metrics(self, record):
        return {"train_steps_per_s": record["steps"] / record["seconds"]}

    def attempted(self, record):
        return record["iterations"], 0

    def trace(self, profile):
        """One iteration as its two halves under ``profile``, each ended
        by a sync: the rollout (``num_steps_per_env`` env steps with the
        policy) and the update."""
        runner = self.runner
        learn_fn, ts = runner.learn_fn, runner.train_state
        with profile:
            with profile.range("rollout"):
                env_state, obs, batch = learn_fn.rollout(
                    ts, runner.env_state, runner.obs)
                follow.sync(self.device)
            with profile.range("update"):
                learn_fn.update(ts, batch)
                follow.sync(self.device)
        runner.env_state, runner.obs = env_state, obs
        return {"rollout": self.cell.config["runner"]["num_steps_per_env"]}

    def free(self):
        """Drop the env and the runner (the weights and the records stay
        for the reference)."""
        del self.runner, self.env


# ------------------------------------------------------------- reference

class _Replay:
    """The program's transitions as the reference rollout's env: each
    ``step`` keeps the reference's action (by the call it replays) and
    returns the program's transition."""

    def __init__(self, calls, first, device, num_envs, num_actions, actions):
        self.calls, self.at, self.device = calls, first, device
        self.num_envs, self.num_actions = num_envs, num_actions
        self.num_privileged_obs = None
        self.actions = actions

    def step(self, state, actions):
        self.actions[self.at] = follow.host(actions)
        self.at += 1
        return None, follow.on(self.device, self.calls[self.at - 1]["tr"])


def _ref_train_state(ref_ppo, model, saved, device):
    """A reference TrainState holding the program's saved state."""
    with torch.no_grad():
        for p, v in zip(model.parameters(), saved["params"]):
            p.copy_(v.to(device))
    noise = torch.Generator(device=device)
    noise.set_state(saved["noise"])
    perm = torch.Generator(device=device)
    perm.set_state(saved["perm"])
    return ref_ppo.TrainState(
        model=model,
        opt_state=ref_ppo.AdamState(
            count=saved["count"],
            mu=[t.to(device, copy=True) for t in saved["mu"]],
            nu=[t.to(device, copy=True) for t in saved["nu"]]),
        lr=saved["lr"].to(device, copy=True), noise_generator=noise,
        perm_generator=perm)


def reference(cell, seeds, device, iterations, model_weights, readings,
              precision="float32", fault=None):
    """Follow the program's recorded steps with the reference; returns its
    readings. ``precision``: "float32" (TF32 off) or "tf32" (the control).
    ``fault``, planted in the reference put in the program's place:
    "half_batch", each update runs on half of the rollout's envs (the mean
    over the rest) and each env step leaves half of the envs' observations
    as they came in; "few_envs" and "reset_skipped" as in
    ``follow.env_steps``."""
    from benchmark.reference import config as ref_config
    from benchmark.reference.envs.legged_env import LeggedEnv
    from benchmark.reference.rl import networks as nets, ppo as ref_ppo

    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    if fault not in follow.FAULTS:
        raise ValueError(f"fault {fault!r}")
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        env_cfg, train_cfg = spec.build_cfgs(ref_config, cell.config,
                                             cell.num_envs)
        env = LeggedEnv(env_cfg, seed=seeds.env, device=device)
        calls = readings["calls"]
        # the start and the sampled env steps from the program's states
        env_out = follow.env_steps(env, calls, device, fault=fault)
        n_env, n_act = env.num_envs, env.num_actions
        obs_dim = env.obs_dim
        del env

        # each iteration from the program's state, its transitions replayed
        model = nets.ActorCritic.from_cfg(obs_dim, n_act, train_cfg.policy
                                          ).to(device)
        steps = cell.config["runner"]["num_steps_per_env"]
        losses, actions, moment = [], {}, None
        for k, it in enumerate(readings["iterations"]):
            first_call = it["calls_after"] - steps
            replay = _Replay(calls, first_call, device, n_env, n_act,
                             actions)
            learn_fn = ref_ppo.make_learn_fn(replay, train_cfg.policy,
                                             train_cfg.algorithm, steps)
            ts = _ref_train_state(ref_ppo, model, it["before"], device)
            obs = calls[first_call - 1]["tr"].obs.to(device)
            _, _, batch = learn_fn.rollout(ts, None, obs)
            if fault == "half_batch":
                batch = ref_ppo.batch_envs(batch, slice(0, n_env // 2))
            metrics = learn_fn.update(ts, batch)
            losses.append(float(metrics["loss"]))
            if k == 0:
                moment = _norms(ts.opt_state.mu)
        start = readings["iterations"][0]["before"]["params"]
        change = _norms([p.detach().cpu() - p0
                         for p, p0 in zip(model.parameters(), start)])
        return {"names": [n for n, _ in model.named_parameters()],
                "loss": losses, "moment": moment, "change": change,
                "env_out": env_out, "actions": actions}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _norms(tensors):
    """Each tensor's norm, taken on the host (one reduction order for both
    sides)."""
    return [float(t.detach().cpu().norm()) for t in tensors]


def program_side(readings):
    """The program's readings in the form ``reference`` returns."""
    start = readings["iterations"][0]["before"]["params"]
    calls = readings["calls"]
    steps = readings["steps"]
    rollout = {i for it in readings["iterations"]
               for i in range(it["calls_after"] - steps, it["calls_after"])}
    return {"names": readings["names"],
            "loss": [it["loss"] for it in readings["iterations"]],
            "moment": _norms(readings["moment"]),
            "change": _norms([p - p0 for p, p0 in
                              zip(readings["after"]["params"], start)]),
            "env_out": follow.program_env_steps(calls),
            "actions": {i: calls[i]["actions"] for i in sorted(rollout)}}


def _leaf_gap(prog, ref, counted):
    floor = sorted(ref[i] for i in counted)[len(counted) // 2]
    return max(abs(prog[i] - ref[i]) / max(ref[i], floor, 1e-30)
               for i in counted)


def compare(side, ref):
    """The numbers the check holds against their limits: ``side`` (the
    program's, the control's or a fault's readings) against the
    reference's."""
    if side["names"] != ref["names"]:
        raise ValueError(f"parameter leaves differ: {side['names']} against "
                         f"{ref['names']}")
    median = sorted(ref["moment"])[len(ref["moment"]) // 2]
    counted = [i for i, m in enumerate(ref["moment"])
               if m >= SMALL_LEAF * median]
    scale = sum(abs(v) for v in ref["loss"]) / len(ref["loss"])
    return {
        **follow.env_numbers(side["env_out"], ref["env_out"]),
        "action_gap": follow.action_gap(side["actions"], ref["actions"]),
        "loss_gap": max(abs(p - r) for p, r in zip(side["loss"], ref["loss"]))
        / max(scale, 1e-30),
        "grad_gap": _leaf_gap(side["moment"], ref["moment"], counted),
        "change_gap": _leaf_gap(side["change"], ref["change"], counted),
    }
