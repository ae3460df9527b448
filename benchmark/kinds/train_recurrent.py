"""Recurrent training cells: the full PPO iterations of ``train`` (kinds/
train.py: set-up, the window of ``learn`` calls, the traced iteration,
the rate) with a recurrent actor-critic (an LSTM in front of each head,
the update's loss unrolled over each env's whole window: BPTT) and an
asymmetric critic reading the env's privileged observations.

What the runner carries between iterations is then (obs, privileged obs)
and the LSTMs' carries {"a", "c"}. Set-up records, besides what ``train``
records, that carried pack going into each iteration and after the last,
copied on the card with no wait as the rest.

The check holds every number of ``train`` (the env steps, the actions,
the losses, Adam's first moment, the parameters' change), the reference
rollout replaying the program's transitions with their privileged
observations and starting each iteration from the program's recorded
carries, and adds:
- ``priv_gap``: per env the largest difference of the privileged
  observations over a sampled step, the mean over the envs, the worst
  step (the start and the sampled steps ``env_gap`` follows);
- ``carry_gap``: the largest difference between the carries the program
  hands to each next iteration (after the last: holds for the next
  ``learn`` call) and those the reference's rollout of the iteration
  ends with.
"""
from __future__ import annotations

import math
import time

import torch

from benchmark import follow, spec, weights as bench_weights
from benchmark.kinds import train
from benchmark.kinds.train import _norms
from benchmark.work import flops_recurrent


def _record(runner, env, model_weights, iterations, sample):
    """``train._record`` with the carried pack (obs, privileged obs,
    carries) going into each iteration and after the last."""
    runner.train_state.model.load_state_dict(model_weights, strict=True)
    names = [n for n, _ in runner.train_state.model.named_parameters()]
    real_learn, real_log = runner.learn_fn, runner._log
    before, losses = [], []

    def learn_iteration(ts, env_state, obs):
        before.append((train._train_state(ts), follow.device_copy(obs),
                       recorder.count))
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
        after = train._train_state(runner.train_state)
        carried_after = follow.device_copy(runner.obs)
        calls_after = [c for _, _, c in before[1:]] + [recorder.count]
    rec = {"names": names, "calls": recorder.host(),
           "iteration_s": seconds / iterations,
           "iterations": [{"before": follow.host(state),
                           "carried": follow.host(carried),
                           "calls_after": c, "loss": loss}
                          for (state, carried, _), c, loss
                          in zip(before, calls_after, losses)],
           "after": follow.host(after),
           "carried_after": follow.host(carried_after)}
    rec["moment"] = (rec["iterations"][1]["before"]["mu"] if iterations > 1
                     else rec["after"]["mu"])
    return rec


class Program(train.Program):
    """The port's runner for one recurrent cell, from set-up to the end of
    the window (``window``, ``metrics``, ``attempted``, ``free`` as in
    ``train``)."""

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
        steps = cell.config["runner"]["num_steps_per_env"]
        self.steps_per_iteration = steps * cell.num_envs
        # the reset's step, with privileged observations the runner's
        # zero-action step, then the iterations' steps
        first = 1 + (self.env.num_privileged_obs is not None)
        self.readings = _record(self.runner, self.env, self.weights,
                                iterations, follow.sampled_calls(
                                    seeds.traffic, first + iterations * steps))
        self.readings["steps"] = steps

    def flops_per_unit(self):
        """Counted operations of one iteration (work/flops_recurrent.py)."""
        return flops_recurrent.train_iteration_flops(
            self.cell.config, self.cell.work(), self.cell.num_envs)

    def trace(self, profile):
        """``train``'s traced iteration; the update range's unit is a
        minibatch step."""
        units = super().trace(profile)
        alg = self.cell.config["algorithm"]
        units["update"] = (alg["num_learning_epochs"]
                           * alg["num_mini_batches"])
        return units


# ------------------------------------------------------------- reference

class _Replay(train._Replay):
    """``train._Replay`` for an env with privileged observations."""

    def __init__(self, *args, num_privileged_obs):
        super().__init__(*args)
        self.num_privileged_obs = num_privileged_obs


def _privileged(calls, env_out_calls, captured, fault):
    """The reference's privileged observations of the followed steps,
    {call: (N, P) on the host}, from ``captured`` (each env step's
    (privileged obs, done) in the order ``follow.env_steps`` took them),
    with ``fault``'s envs keeping those they came in with, as
    ``follow.env_steps`` leaves their observations."""
    out = {}
    for i, (priv, done) in zip(env_out_calls, captured):
        if fault is not None and i != 0:
            n = priv.shape[0]
            left_out = {"half_batch": slice(n // 2, n),
                        "few_envs": slice(0, math.ceil(follow.FEW_SHARE
                                                       * n))}
            envs = left_out.get(fault, done)
            priv = priv.clone()
            priv[envs] = calls[i - 1]["tr"].privileged_obs.to(priv.device)[
                envs]
        out[i] = follow.host(priv)
    return out


def reference(cell, seeds, device, iterations, model_weights, readings,
              precision="float32", fault=None):
    """Follow the program's recorded steps with the reference (as
    ``train.reference``: ``precision`` "float32", TF32 off, or the "tf32"
    control; the planted ``fault`` "half_batch", "few_envs" or
    "reset_skipped"); each iteration's rollout starts from the program's
    carried pack going into it. Returns the reference's readings."""
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
        # the start and the sampled env steps from the program's states,
        # each step's privileged observations kept as it returns them
        captured, real_step = [], env.step

        def step(state, actions):
            out, tr = real_step(state, actions)
            captured.append((tr.privileged_obs, tr.done))
            return out, tr

        env.step = step
        env_out = follow.env_steps(env, calls, device, fault=fault)
        priv = _privileged(calls, sorted(env_out), captured, fault)
        n_env, n_act = env.num_envs, env.num_actions
        obs_dim, n_priv = env.obs_dim, env.num_privileged_obs
        del env, captured

        model = nets.ActorCritic.from_cfg(
            obs_dim, n_act, train_cfg.policy, critic_obs_dim=n_priv
        ).to(device)
        steps = cell.config["runner"]["num_steps_per_env"]
        losses, actions, moment, carries = [], {}, None, []
        for k, it in enumerate(readings["iterations"]):
            first_call = it["calls_after"] - steps
            replay = _Replay(calls, first_call, device, n_env, n_act,
                             actions, num_privileged_obs=n_priv)
            learn_fn = ref_ppo.make_learn_fn(replay, train_cfg.policy,
                                             train_cfg.algorithm, steps)
            ts = train._ref_train_state(ref_ppo, model, it["before"], device)
            _, (_, memory), batch = learn_fn.rollout(
                ts, None, follow.on(device, it["carried"]))
            carries.append(follow.host(memory))
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
                "env_out": env_out, "actions": actions, "priv": priv,
                "carries": carries}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def program_side(readings):
    """The program's readings in the form ``reference`` returns."""
    side = train.program_side(readings)
    calls = readings["calls"]
    side["priv"] = {i: calls[i]["tr"].privileged_obs for i in side["env_out"]}
    handed = [it["carried"] for it in readings["iterations"][1:]]
    side["carries"] = [c[1] for c in handed + [readings["carried_after"]]]
    return side


def _carry_gap(side, ref):
    """The largest difference of a carry over the iterations."""
    return max(float((a[k] - b[k]).abs().max())
               for a, b in zip(side, ref) for k in b)


def compare(side, ref):
    """``train.compare``'s numbers with ``priv_gap`` and ``carry_gap``."""
    if side["priv"].keys() != ref["priv"].keys():
        raise ValueError("the two sides followed different steps")
    priv_gap = max(float((side["priv"][i] - ref["priv"][i]).abs()
                         .amax(dim=1).mean()) for i in ref["priv"])
    return {**train.compare(side, ref), "priv_gap": priv_gap,
            "carry_gap": _carry_gap(side["carries"], ref["carries"])}
