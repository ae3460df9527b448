"""PPO: rollout (a loop over env.step) + GAE + clipped surrogate update with
adaptive-KL learning rate, for a feed-forward or recurrent (LSTM) policy
with a symmetric or asymmetric critic.

The port of the JAX package's ``rl/ppo.py`` (itself a functional re-design
of rsl_rl as the reference trains with it; hyperparameters
legged_robot_config.py:212-247). Semantics mirrored:
- timeout bootstrapping: rewards += gamma * V(s) on time_out steps, with
  the value of the state BEFORE the step;
- GAE(gamma, lam) with advantage normalization over the whole batch
  (population standard deviation);
- clipped surrogate + clipped value loss + entropy bonus;
- gradient clipping by global norm as optax does it (scale by max / norm
  only when norm >= max), then bias-corrected Adam (b1 0.9, b2 0.999,
  eps 1e-8), update = -lr * u;
- adaptive LR from THIS minibatch's KL(old || new) before the step:
  lr /= 1.5 above 2x desired_kl, lr *= 1.5 below 0.5x (and kl > 0),
  clamped to [1e-5, 1e-2];
- one index permutation, truncated to mb_size * n_mb, shared by all epochs
  (rsl_rl's mini_batch_generator): 5 epochs x 4 minibatches;
- asymmetric critic: when the env has privileged observations, the carried
  obs is the pair (obs, privileged_obs) and the critic reads the second;
- recurrent policy: the carried obs is (obs[, privileged_obs], memory),
  memory the actor / critic LSTM carries {"a", "c"} (N, L, 2, h), zeroed
  on done. Minibatches split the ENV axis, and the loss re-runs the LSTM
  over the whole T-step window from the window-start carry, zeroing at
  dones: BPTT through the window, as the JAX package does it.

Split over ranks (the env's ``mesh``, parallel/sharding.py), each rank
rolls out its envs and the update gives the unsharded one's numbers to
reduction order: the action noise is drawn for the global envs and cut to
the rank's; advantages are normalized by the global mean and population
std; the minibatches are the unsharded run's global index sets (one
permutation, the same on every rank), of which each rank takes the rows it
holds; the loss terms are local sums over the global minibatch size, and
the gradients, the loss terms and the KL are summed over ranks before the
clip, the adaptive learning rate and the Adam step, so parameters, moments
and the learning rate stay replicated; the metrics are global.

PyTorch idiom: the policy is an ``nn.Module`` updated in place by
autograd; the rollout runs under ``torch.no_grad()`` (not inference mode:
its tensors feed the update); the learning rate and every metric stay on
the device, so an iteration makes no device-to-host read — the runner
fetches the metrics once per iteration. Where CUDA graphs apply
(``utils.cuda_graph``: a card, no mesh) the update's time is the card's
and not the host's dispatch: the whole minibatch step (gather, loss with
the recurrent unroll, backward, clip, adaptive lr, Adam;
``minibatch_step``) replays as one CUDA graph, for a feed-forward and a
recurrent policy alike. GAE, the permutation and the metrics stay eager,
once per iteration, and so does the whole update on the CPU and split
over ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from legged_gym_tpu_torch.parallel.sharding import all_sum, shard_batch
from legged_gym_tpu_torch.rl import networks as nets
from legged_gym_tpu_torch.utils import cuda_graph, profiling

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LR_MIN, LR_MAX = 1e-5, 1e-2
# lr / 1.5 as XLA evaluates it in the JAX package: a division by a constant
# becomes a multiplication by its float32 reciprocal. Doing the same keeps
# the two packages' learning rates equal to the bit over an iteration.
INV_1_5 = float(np.float32(1.0) / np.float32(1.5))


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: step count and the two moments, one
    tensor per parameter in ``model.parameters()`` order."""
    count: int
    mu: list
    nu: list


@dataclasses.dataclass
class TrainState:
    """What training carries between iterations. ``learn_iteration``
    updates it in place (the JAX package returns a new one)."""
    model: nets.ActorCritic
    opt_state: AdamState
    lr: torch.Tensor                  # () adaptive learning rate, on device
    noise_generator: torch.Generator  # action noise
    perm_generator: torch.Generator   # minibatch permutation

    @property
    def params(self):
        return list(self.model.parameters())


def bias_corrections(count):
    """Adam's bias corrections (bc1, bc2) after ``count`` steps, in float32
    as optax computes them (host floats)."""
    return (float(np.float32(1.0) - np.float32(ADAM_B1) ** count),
            float(np.float32(1.0) - np.float32(ADAM_B2) ** count))


def bias_correction_table(count, steps):
    """(steps, 2, 2) float32, a row per step after ``count``: for each of
    Adam's bias corrections (``bias_corrections``) the correction and its
    float32 reciprocal (the replayed update's table of an iteration)."""
    bc = np.array([bias_corrections(c)
                   for c in range(count + 1, count + steps + 1)],
                  dtype=np.float32)
    return np.stack([bc, np.float32(1.0) / bc], axis=-1)


def unbias(moments, bc):
    """``torch._foreach_div(moments, bc)`` for a host float ``bc``. For
    ``bc`` a device tensor [correction, its float32 reciprocal] (a row of
    ``bias_correction_table``), the bits the host float gives on the
    moments' device: a card's kernels divide by a host scalar as a
    multiplication by its float32 reciprocal, the CPU's divide."""
    if not isinstance(bc, torch.Tensor):
        return torch._foreach_div(moments, bc)
    if bc.device.type == "cuda":
        return torch._foreach_mul(moments, bc[1])
    return torch._foreach_div(moments, bc[0])


class Optimizer:
    """optax.chain(clip_by_global_norm(max_norm), scale_by_adam()): turns
    gradients into update directions ``u``; the caller applies -lr * u."""

    def __init__(self, max_grad_norm):
        self.max_grad_norm = float(max_grad_norm)

    def init(self, params) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    def update(self, grads, state: AdamState):
        """Clips ``grads`` (in place), advances ``state`` (in place) and
        returns the list of update directions."""
        state.count += 1
        return self.directions(grads, state, *bias_corrections(state.count))

    def directions(self, grads, state: AdamState, bc1, bc2):
        """``update`` with the step count advanced by the caller and its
        bias corrections given: host floats, or rows of
        ``bias_correction_table`` on the device (a replayed step reads them
        from a buffer), applied with the same bits (``unbias``)."""
        # optax.clip_by_global_norm: untouched below the threshold, scaled
        # to exactly max_norm at or above it
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(g_norm < self.max_grad_norm,
                             torch.ones_like(g_norm),
                             self.max_grad_norm / g_norm)
        torch._foreach_mul_(grads, [factor] * len(grads))
        # optax.scale_by_adam
        torch._foreach_mul_(state.mu, ADAM_B1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(state.nu, ADAM_B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - ADAM_B2)
        denom = unbias(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        updates = unbias(state.mu, bc1)
        torch._foreach_div_(updates, denom)
        return updates


def make_optimizer(alg):
    return Optimizer(alg.max_grad_norm)


def init_train_state(seed, obs_dim, num_actions, policy_cfg, alg_cfg,
                     critic_obs_dim=None, device="cuda"):
    """A fresh TrainState on ``device``: weights drawn from a generator
    seeded with ``seed`` (on the CPU, so they do not depend on the device),
    zero Adam moments, lr = alg_cfg.learning_rate, and two device
    generators seeded from ``seed`` for the action noise and the minibatch
    permutation. ``critic_obs_dim``: the critic's input width when it
    reads privileged observations."""
    device = torch.device(device)
    model = nets.ActorCritic.from_cfg(
        obs_dim, num_actions, policy_cfg,
        generator=torch.Generator().manual_seed(seed),
        critic_obs_dim=critic_obs_dim).to(device)
    noise = torch.Generator(device=device).manual_seed(seed + 1)
    perm = torch.Generator(device=device).manual_seed(seed + 2)
    return TrainState(
        model=model,
        opt_state=make_optimizer(alg_cfg).init(list(model.parameters())),
        lr=torch.tensor(alg_cfg.learning_rate, dtype=torch.float32,
                        device=device),
        noise_generator=noise, perm_generator=perm)


def bootstrap_timeouts(reward, value, time_out, gamma):
    """rewards += gamma * V(s) on time_out steps, V of the state BEFORE the
    step (rsl_rl's timeout bootstrap; all (T, N))."""
    return reward + gamma * value * time_out.to(reward.dtype)


def compute_gae(reward, value, not_done, last_value, gamma, lam):
    """reward / value / not_done (T, N), last_value (N,) -> advantages
    (T, N), by the backward recursion."""
    adv = torch.empty_like(reward)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(reward.shape[0] - 1, -1, -1):
        delta = reward[t] + gamma * v_next * not_done[t] - value[t]
        adv_next = delta + gamma * lam * not_done[t] * adv_next
        adv[t] = adv_next
        v_next = value[t]
    return adv


def bptt(model, obs, cobs, done, mem_a0, mem_c0):
    """The recurrent loss's unroll: both LSTMs and heads over the window
    (T, N, ...) from the window-start carries ``mem_a0`` / ``mem_c0``,
    each carry zeroed after the step where its episode ended. Returns
    (action means (T, N, A), values (T, N))."""
    ma, mc = mem_a0, mem_c0
    means, values = [], []
    for t in range(obs.shape[0]):
        mean_t, ma = nets.actor_mean_rnn(model, obs[t], ma)
        value_t, mc = nets.critic_value_rnn(model, cobs[t], mc)
        keep = (1.0 - done[t])[:, None, None, None]
        ma, mc = ma * keep, mc * keep
        means.append(mean_t)
        values.append(value_t)
    return torch.stack(means), torch.stack(values)


def ppo_loss(model, mb, alg_cfg, recurrent=False, asym=False, size=None):
    """(loss, (surrogate, value_loss, kl)) of one minibatch. Recurrent: the
    minibatch is time-major (T, N_mb, ...) with the window-start carries
    ``mem_a0`` / ``mem_c0``, and ``bptt`` runs the LSTMs over the window
    from them, zeroed where an episode ended (the span ``ppo.bptt``, on
    the eager runs). ``size``: the count the mean-reduced terms' sums
    divide by (default: the minibatch's own samples); a rank's part of a
    split minibatch divides by the whole minibatch's."""
    cobs = mb["cobs"] if asym else mb["obs"]
    if recurrent:
        with profiling.span("ppo.bptt"):
            act_mean, value = bptt(model, mb["obs"], cobs, mb["done"],
                                   mb["mem_a0"], mb["mem_c0"])
    else:
        act_mean = nets.actor_mean(model, mb["obs"])
        value = nets.critic_value(model, cobs)
    std = model.std.expand_as(act_mean)
    logp = nets.gaussian_log_prob(mb["action"], act_mean, std)
    entropy = nets.gaussian_entropy(std)

    ratio = torch.exp(logp - mb["logp"])
    s1 = -mb["adv"] * ratio
    s2 = -mb["adv"] * torch.clamp(ratio, 1.0 - alg_cfg.clip_param,
                                  1.0 + alg_cfg.clip_param)
    def mean(x):
        return x.sum() / (x.numel() if size is None else size)

    surrogate = mean(torch.maximum(s1, s2))

    if alg_cfg.use_clipped_value_loss:
        v_clip = mb["value"] + torch.clamp(
            value - mb["value"], -alg_cfg.clip_param, alg_cfg.clip_param)
        v_loss = mean(torch.maximum(torch.square(value - mb["returns"]),
                                    torch.square(v_clip - mb["returns"])))
    else:
        v_loss = mean(torch.square(value - mb["returns"]))

    loss = (surrogate + alg_cfg.value_loss_coef * v_loss
            - alg_cfg.entropy_coef * mean(entropy))
    with torch.no_grad():
        kl = mean(nets.gaussian_kl(mb["mean"], mb["std"], act_mean, std))
    return loss, (surrogate.detach(), v_loss.detach(), kl)


def minibatch_step(ts, mb, lr, bc, alg_cfg, recurrent=False, asym=False,
                   size=None, summed=None):
    """One minibatch step of the update on the minibatch ``mb``: the loss
    (``ppo_loss``), its gradients, their sum over ranks (``summed``, the
    update's; None in one process), the adaptive lr from this minibatch's
    KL, the clip and Adam with this step's bias corrections ``bc`` =
    (bc1, bc2), then -lr x the directions added to the parameters. The
    parameters and Adam's moments change in place; the step count is the
    caller's. Returns (the stats row [loss, surrogate, value loss, KL],
    the new lr)."""
    params = ts.params
    loss, (s_loss, v_loss, kl) = ppo_loss(ts.model, mb, alg_cfg, recurrent,
                                          asym, size)
    grads = list(torch.autograd.grad(loss, params))
    with torch.no_grad():
        loss = loss.detach()
        if summed is not None:
            grads, (loss, s_loss, v_loss, kl) = summed(
                grads, [loss, s_loss, v_loss, kl])
        if alg_cfg.schedule == "adaptive" and alg_cfg.desired_kl > 0:
            lr = torch.where(kl > alg_cfg.desired_kl * 2.0,
                             torch.clamp_min(lr * INV_1_5, LR_MIN), lr)
            lr = torch.where((kl < alg_cfg.desired_kl / 2.0) & (kl > 0.0),
                             torch.clamp_max(lr * 1.5, LR_MAX), lr)
        updates = make_optimizer(alg_cfg).directions(grads, ts.opt_state,
                                                     *bc)
        torch._foreach_mul_(updates, [-lr] * len(updates))
        torch._foreach_add_(params, updates)
        return torch.stack([loss, s_loss, v_loss, kl]), lr


def minibatch(flat, idx, mem=None):
    """The minibatch of rows ``idx`` of the update's batch ``flat``: the
    flattened (T * N, ...) rows, or, for a recurrent policy (``mem``, the
    window-start carries {"a", "c"} (N, ...)), the envs ``idx`` of the
    time-major (T, N, ...) windows with their carries as ``mem_a0`` /
    ``mem_c0``."""
    if mem is None:
        return {k: v[idx] for k, v in flat.items()}
    mb = {k: v[:, idx] for k, v in flat.items()}
    mb["mem_a0"], mb["mem_c0"] = mem["a"][idx], mem["c"][idx]
    return mb


def make_learn_fn(env, policy_cfg, alg_cfg, num_steps):
    """Returns ``learn_iteration(train_state, env_state, obs, noise=None,
    perm=None)`` -> (train_state, env_state, obs, metrics): ``num_steps``
    env steps, GAE and the PPO update. ``metrics`` holds 0-d tensors on
    the device (``episode`` a dict of them). ``obs`` is the carried pack:
    the (N, obs_dim) observations, or (obs, privileged_obs) when the env
    has privileged observations, and with a recurrent policy that wrapped
    as (obs_pack, memory) (``networks.init_memory``).

    ``noise`` (num_steps, N, num_actions) standard-normal draws and
    ``perm`` (a permutation of num_steps * N, or of N for a recurrent
    policy) replace the generators' draws; the parity tests replay the JAX
    package's with them.

    With the env split over ranks (``env.mesh``), ``noise`` and ``perm``
    are the global ones (num_steps, N_global, num_actions) and a
    permutation of num_steps * N_global (N_global for a recurrent policy);
    each rank takes its part.

    The two halves are ``learn_iteration.rollout(train_state, env_state,
    obs, noise=None)`` -> (env_state, obs, batch) and
    ``learn_iteration.update(train_state, batch, perm=None)`` -> metrics;
    ``batch_envs`` cuts a rollout's batch to a range of envs.

    Set ``learn_iteration.profile = True`` to synchronize at the phase
    boundaries and append {"rollout_s", "update_s", "spans"} of each
    iteration to ``learn_iteration.times``: the halves' times (host
    clock) and the summary of the spans the iteration opened
    (``utils.profiling.Recording.summary``: ``env.*``, ``terrain.refresh``,
    ``actuator.sea``, ``kernel.chain_step``, ``ppo.act`` per rollout step,
    ``ppo.minibatch`` per minibatch step and inside it ``ppo.graph`` where
    the step replays its CUDA graph or, for a recurrent policy run
    eagerly, ``ppo.bptt``: the loss's unroll of both LSTMs and heads over
    the window).
    """
    n_mb = alg_cfg.num_mini_batches
    n_ep = alg_cfg.num_learning_epochs
    gamma, lam = alg_cfg.gamma, alg_cfg.lam
    recurrent = nets.is_recurrent(policy_cfg)
    # asymmetric critic (rsl_rl's critic_obs routing, on_policy_runner.py)
    asym = getattr(env, "num_privileged_obs", None) is not None
    mesh = getattr(env, "mesh", None)
    world = 1 if mesh is None else mesh.world_size

    def step_noise(noise, t, ts, ref):
        """The standard-normal action draw of rollout step ``t``, drawn or
        given for the global envs and cut to this rank's (``ref``: this
        rank's observations)."""
        full = noise[t] if noise is not None else torch.randn(
            (ref.shape[0] * world, env.num_actions),
            generator=ts.noise_generator, dtype=ref.dtype, device=ref.device)
        return shard_batch(full, mesh)

    def rows_held(idx, n_env):
        """The local rows of the global minibatch rows ``idx`` that this
        rank holds: global row t * N_global + n (an env index n for a
        recurrent policy) is local row t * n_env + n - start."""
        if mesh is None:
            return idx
        n_glob = n_env * world
        start = mesh.env_slice(n_glob).start
        env_idx = idx % n_glob
        held = (env_idx >= start) & (env_idx < start + n_env)
        return ((idx // n_glob) * n_env + env_idx - start)[held]

    def summed(grads, scalars):
        """Gradients and 0-d terms summed over the ranks, one
        all-reduce."""
        if mesh is None:
            return grads, scalars
        flat = mesh.all_sum(torch.cat([g.reshape(-1) for g in grads]
                                      + [torch.stack(scalars)]))
        parts = torch.split(flat, [g.numel() for g in grads]
                            + [len(scalars)])
        return ([p.view_as(g) for p, g in zip(parts, grads)],
                parts[-1].unbind())

    step_graph = {}            # the minibatch step's cuda_graph.Graphs

    def clock(device):
        if learn_iteration.profile and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def rollout(ts: TrainState, env_state, obs, noise=None):
        """``num_steps`` env steps under the current policy, no update.
        Returns (env_state, obs, batch): ``batch`` holds the per-step
        tensors (T, N, ...) (obs, [cobs,] action, logp, mean, std, value,
        reward, done, time_out), ``last_value`` (N,), the recurrent
        window-start carries ``memory`` {"a", "c"} (N, ...) and the env's
        episode statistics, which are global: ``ep_count`` and
        ``ep_len_sum`` (T,), ``ep_sums`` {name: (T,)}, and the last step's
        ``terrain_level`` and ``max_command_x``."""
        model = ts.model
        memory = None
        if recurrent:
            obs, memory = obs
        # the window-start carries: the update re-runs each minibatch's
        # window from them
        mem_start = memory
        steps = []
        with torch.no_grad():
            for t in range(num_steps):
                aobs, cobs = obs if asym else (obs, obs)
                with profiling.span("ppo.act"):
                    eps = step_noise(noise, t, ts, aobs)
                    if recurrent:
                        mean, mem_a = nets.actor_mean_rnn(model, aobs,
                                                          memory["a"])
                        action, logp = nets.sample_around(
                            model, mean, ts.noise_generator, eps)
                        std = model.std.expand_as(mean)
                        value, mem_c = nets.critic_value_rnn(model, cobs,
                                                             memory["c"])
                    else:
                        action, logp, mean, std = nets.sample_action(
                            model, aobs, ts.noise_generator, eps)
                        value = nets.critic_value(model, cobs)
                env_state, tr = env.step(env_state, action)
                steps.append(dict(
                    obs=aobs, cobs=cobs, action=action, logp=logp,
                    mean=mean, std=std, value=value, reward=tr.reward,
                    done=tr.done, time_out=tr.time_out,
                    ep_sums=tr.episode_sums, ep_count=tr.episode_count,
                    ep_len_sum=tr.episode_length_sum))
                if recurrent:
                    # rsl_rl resets the hidden states of finished envs
                    keep = (~tr.done).to(mem_a.dtype)[:, None, None, None]
                    memory = {"a": mem_a * keep, "c": mem_c * keep}
                obs = (tr.obs, tr.privileged_obs) if asym else tr.obs

            def stacked(name):
                return torch.stack([s[name] for s in steps])

            names = ["obs", "action", "logp", "mean", "std", "value",
                     "reward", "done", "time_out", "ep_count", "ep_len_sum"]
            batch = {name: stacked(name)
                     for name in names + ["cobs"] * asym}
            batch["ep_sums"] = {name: torch.stack([s["ep_sums"][name]
                                                   for s in steps])
                                for name in steps[-1]["ep_sums"]}
            batch["terrain_level"] = tr.terrain_level_mean
            batch["max_command_x"] = tr.max_command_x
            last_cobs = obs[1] if asym else obs
            if recurrent:
                batch["last_value"], _ = nets.critic_value_rnn(
                    model, last_cobs, memory["c"])
                batch["memory"] = mem_start
                obs = (obs, memory)
            else:
                batch["last_value"] = nets.critic_value(model, last_cobs)
        return env_state, obs, batch

    def update(ts: TrainState, batch, perm=None):
        """GAE and the PPO update (epochs x minibatches) on a rollout's
        ``batch``, the train state updated in place. Returns the metrics
        (0-d tensors on the device)."""
        model = ts.model
        device = batch["reward"].device
        mem_start = batch.get("memory")
        with torch.no_grad():
            # ---- timeout bootstrap + GAE ----
            dtype = batch["reward"].dtype
            reward = bootstrap_timeouts(batch["reward"], batch["value"],
                                        batch["time_out"], gamma)
            not_done = 1.0 - batch["done"].to(dtype)
            advantages = compute_gae(reward, batch["value"], not_done,
                                     batch["last_value"], gamma, lam)
            returns = advantages + batch["value"]
            # the global mean, then the global population std
            count = advantages.numel() * world
            adv_mean = all_sum(advantages.sum(), mesh) / count
            adv_var = all_sum(torch.square(advantages - adv_mean).sum(),
                              mesh) / count
            adv_norm = (advantages - adv_mean) / (torch.sqrt(adv_var) + 1e-8)

            # ---- minibatching ----
            # feed-forward: flatten (T, N, ...) and permute once; recurrent:
            # split the env axis and keep the windows time-major
            t_len, n_env = reward.shape
            flat = {"obs": batch["obs"], "action": batch["action"],
                    "logp": batch["logp"], "mean": batch["mean"],
                    "std": batch["std"], "value": batch["value"],
                    "returns": returns, "adv": adv_norm}
            if asym:
                flat["cobs"] = batch["cobs"]
            n_all = n_env * world
            if recurrent:
                flat["done"] = batch["done"].to(dtype)
                n_rows = n_all
            else:
                n_rows = t_len * n_all
                flat = {k: v.reshape((t_len * n_env,) + v.shape[2:])
                        for k, v in flat.items()}
            mb_size = n_rows // n_mb
            if perm is None:
                perm = torch.randperm(n_rows, generator=ts.perm_generator,
                                      device=device)
            # each rank's rows of the global minibatches; the loss
            # divides by the global minibatch's samples
            mb_idx = [rows_held(idx, n_env) for idx in
                      perm[: mb_size * n_mb].reshape(n_mb, mb_size)]
            size = mb_size * (t_len if recurrent else 1)

        # ---- update: epochs reuse the permutation ----
        lr = ts.lr
        steps = n_ep * n_mb
        graph = None
        if cuda_graph.applies(device, mesh):
            # the iteration's bias corrections, a row per step, sent from
            # a fresh block of pinned memory with no wait for the card
            table = torch.from_numpy(bias_correction_table(
                ts.opt_state.count, steps))
            if device.type == "cuda":
                table = table.pin_memory()
            table = table.to(device, non_blocking=True)
            inputs = {"batch": {"flat": flat, "mem": mem_start, "lr": lr},
                      "step": {"idx": mb_idx[0], "bc": table[0]}}
            held = ts.params + ts.opt_state.mu + ts.opt_state.nu

            def section(v):
                row, lr = minibatch_step(
                    ts, minibatch(v["flat"], v["idx"], v["mem"]),
                    v["lr"], (v["bc"][0], v["bc"][1]), alg_cfg,
                    recurrent, asym, size)
                if lr is not v["lr"]:
                    v["lr"].copy_(lr)              # the next step's lr
                return {"row": row, "lr": lr}

            graph = step_graph["graph"] = cuda_graph.reuse(
                step_graph.get("graph"), lambda: [section], inputs,
                held=held)
            graph.stage("batch")
        stats = []
        for step in range(steps):
            idx = mb_idx[step % n_mb]
            with profiling.span("ppo.minibatch"):
                ts.opt_state.count += 1
                if graph is None:
                    row, lr = minibatch_step(
                        ts, minibatch(flat, idx, mem_start), lr,
                        bias_corrections(ts.opt_state.count), alg_cfg,
                        recurrent, asym, size, summed=summed)
                else:
                    graph.stage("step", {"idx": idx, "bc": table[step]})
                    _, out = graph.run(span="ppo.graph", stage=False)
                    row, lr = out["row"], out["lr"]
            stats.append(row)
        ts.lr = lr

        with torch.no_grad():
            stats = torch.stack(stats)                     # (n_ep*n_mb, 4)
            mean_stats = stats.mean(dim=0)
            # the env's episode statistics are global already
            ep_count = batch["ep_count"].sum()
            mean_reward = all_sum(batch["reward"].sum(), mesh) / (
                t_len * n_all)
            denom = torch.clamp_min(ep_count, 1.0)
            return {
                "loss": mean_stats[0],
                "surrogate_loss": mean_stats[1],
                "value_loss": mean_stats[2],
                "kl": mean_stats[3],
                "kl_max": stats[:, 3].max(),
                "noise_std": model.std.detach().mean(),
                "lr": ts.lr,
                "mean_step_reward": mean_reward,
                "episode_count": ep_count,
                "mean_episode_length": batch["ep_len_sum"].sum() / denom,
                "terrain_level": batch["terrain_level"],
                "max_command_x": batch["max_command_x"],
                "episode": {name: v.sum() / denom
                            for name, v in batch["ep_sums"].items()},
            }

    def learn_iteration(ts: TrainState, env_state, obs, noise=None,
                        perm=None):
        device = obs
        while isinstance(device, tuple):        # the carried pack
            device = device[0]
        device = device.device
        with (profiling.recording() if learn_iteration.profile
              else contextlib.nullcontext()) as rec:
            t0 = clock(device)
            env_state, obs, batch = rollout(ts, env_state, obs, noise)
            t1 = clock(device)
            metrics = update(ts, batch, perm)
            if rec is not None:
                t2 = clock(device)
        if rec is not None:
            learn_iteration.times.append({"rollout_s": t1 - t0,
                                          "update_s": t2 - t1,
                                          "spans": rec.summary()})
        return ts, env_state, obs, metrics

    learn_iteration.rollout = rollout
    learn_iteration.update = update
    learn_iteration.profile = False
    learn_iteration.times = []
    return learn_iteration


def batch_envs(batch, envs):
    """The envs ``envs`` (a slice) of a rollout batch: the per-step
    tensors along their env axis (1), ``last_value`` and the carries along
    theirs (0); the global episode statistics as they are."""
    per_env = ("obs", "cobs", "action", "logp", "mean", "std", "value",
               "reward", "done", "time_out")
    out = dict(batch)
    for k in per_env:
        if k in batch:
            out[k] = batch[k][:, envs].contiguous()
    out["last_value"] = batch["last_value"][envs].contiguous()
    if batch.get("memory") is not None:
        out["memory"] = {k: v[envs].contiguous()
                         for k, v in batch["memory"].items()}
    return out
