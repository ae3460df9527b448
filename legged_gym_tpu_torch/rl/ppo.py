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

PyTorch idiom: the policy is an ``nn.Module`` updated in place by
autograd; the rollout runs under ``torch.no_grad()`` (not inference mode:
its tensors feed the update); the learning rate and every metric stay on
the device, so an iteration makes no device-to-host read — the runner
fetches the metrics once per iteration.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from legged_gym_tpu_torch.rl import networks as nets

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
        # optax.clip_by_global_norm: untouched below the threshold, scaled
        # to exactly max_norm at or above it
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(g_norm < self.max_grad_norm,
                             torch.ones_like(g_norm),
                             self.max_grad_norm / g_norm)
        torch._foreach_mul_(grads, [factor] * len(grads))
        # optax.scale_by_adam
        state.count += 1
        torch._foreach_mul_(state.mu, ADAM_B1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(state.nu, ADAM_B2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - ADAM_B2)
        # bias corrections in float32, as optax computes them
        bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** state.count)
        bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** state.count)
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        updates = torch._foreach_div(state.mu, bc1)
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


def ppo_loss(model, mb, alg_cfg, recurrent=False, asym=False):
    """(loss, (surrogate, value_loss, kl)) of one minibatch. Recurrent: the
    minibatch is time-major (T, N_mb, ...) with the window-start carries
    ``mem_a0`` / ``mem_c0``, and the LSTMs run over the window from them,
    zeroed where an episode ended."""
    cobs = mb["cobs"] if asym else mb["obs"]
    if recurrent:
        ma, mc = mb["mem_a0"], mb["mem_c0"]
        means, values = [], []
        for t in range(mb["obs"].shape[0]):
            mean_t, ma = nets.actor_mean_rnn(model, mb["obs"][t], ma)
            value_t, mc = nets.critic_value_rnn(model, cobs[t], mc)
            keep = (1.0 - mb["done"][t])[:, None, None, None]
            ma, mc = ma * keep, mc * keep
            means.append(mean_t)
            values.append(value_t)
        mean, value = torch.stack(means), torch.stack(values)
    else:
        mean = nets.actor_mean(model, mb["obs"])
        value = nets.critic_value(model, cobs)
    std = model.std.expand_as(mean)
    logp = nets.gaussian_log_prob(mb["action"], mean, std)
    entropy = nets.gaussian_entropy(std)

    ratio = torch.exp(logp - mb["logp"])
    s1 = -mb["adv"] * ratio
    s2 = -mb["adv"] * torch.clamp(ratio, 1.0 - alg_cfg.clip_param,
                                  1.0 + alg_cfg.clip_param)
    surrogate = torch.maximum(s1, s2).mean()

    if alg_cfg.use_clipped_value_loss:
        v_clip = mb["value"] + torch.clamp(
            value - mb["value"], -alg_cfg.clip_param, alg_cfg.clip_param)
        v_loss = torch.maximum(torch.square(value - mb["returns"]),
                               torch.square(v_clip - mb["returns"])).mean()
    else:
        v_loss = torch.square(value - mb["returns"]).mean()

    loss = (surrogate + alg_cfg.value_loss_coef * v_loss
            - alg_cfg.entropy_coef * entropy.mean())
    with torch.no_grad():
        kl = nets.gaussian_kl(mb["mean"], mb["std"], mean, std).mean()
    return loss, (surrogate.detach(), v_loss.detach(), kl)


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

    Set ``learn_iteration.profile = True`` to synchronize at the phase
    boundaries and append {"rollout_s", "update_s"} (host clock) of each
    iteration to ``learn_iteration.times``.
    """
    opt = make_optimizer(alg_cfg)
    n_mb = alg_cfg.num_mini_batches
    n_ep = alg_cfg.num_learning_epochs
    gamma, lam = alg_cfg.gamma, alg_cfg.lam
    adaptive = alg_cfg.schedule == "adaptive" and alg_cfg.desired_kl > 0
    recurrent = nets.is_recurrent(policy_cfg)
    # asymmetric critic (rsl_rl's critic_obs routing, on_policy_runner.py)
    asym = getattr(env, "num_privileged_obs", None) is not None

    def clock(device):
        if learn_iteration.profile and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def learn_iteration(ts: TrainState, env_state, obs, noise=None,
                        perm=None):
        model = ts.model
        memory = None
        if recurrent:
            obs, memory = obs
        # the window-start carries: the update re-runs each minibatch's
        # window from them
        mem_start = memory
        device = (obs[0] if asym else obs).device
        t0 = clock(device)

        # ---- rollout ----
        steps = []
        with torch.no_grad():
            for t in range(num_steps):
                aobs, cobs = obs if asym else (obs, obs)
                eps = None if noise is None else noise[t]
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
                    ep_len_sum=tr.episode_length_sum,
                    terrain_level=tr.terrain_level_mean,
                    max_command_x=tr.max_command_x))
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

            # ---- timeout bootstrap + GAE ----
            last_cobs = obs[1] if asym else obs
            if recurrent:
                last_value, _ = nets.critic_value_rnn(model, last_cobs,
                                                      memory["c"])
            else:
                last_value = nets.critic_value(model, last_cobs)
            dtype = batch["reward"].dtype
            reward = bootstrap_timeouts(batch["reward"], batch["value"],
                                        batch["time_out"], gamma)
            not_done = 1.0 - batch["done"].to(dtype)
            advantages = compute_gae(reward, batch["value"], not_done,
                                     last_value, gamma, lam)
            returns = advantages + batch["value"]
            adv_norm = ((advantages - advantages.mean())
                        / (advantages.std(unbiased=False) + 1e-8))

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
            if recurrent:
                flat["done"] = batch["done"].to(dtype)
                n_rows = n_env
            else:
                n_rows = t_len * n_env
                flat = {k: v.reshape((n_rows,) + v.shape[2:])
                        for k, v in flat.items()}
            mb_size = n_rows // n_mb
            if perm is None:
                perm = torch.randperm(n_rows, generator=ts.perm_generator,
                                      device=device)
            mb_idx = perm[: mb_size * n_mb].reshape(n_mb, mb_size)
        t1 = clock(device)

        # ---- update: epochs reuse the permutation ----
        params = ts.params
        lr = ts.lr
        stats = []
        for _ in range(n_ep):
            for idx in mb_idx:
                if recurrent:
                    mb = {k: v[:, idx] for k, v in flat.items()}
                    mb["mem_a0"] = mem_start["a"][idx]
                    mb["mem_c0"] = mem_start["c"][idx]
                else:
                    mb = {k: v[idx] for k, v in flat.items()}
                loss, (s_loss, v_loss, kl) = ppo_loss(model, mb, alg_cfg,
                                                      recurrent, asym)
                grads = list(torch.autograd.grad(loss, params))
                with torch.no_grad():
                    if adaptive:
                        lr = torch.where(kl > alg_cfg.desired_kl * 2.0,
                                         torch.clamp_min(lr * INV_1_5,
                                                         LR_MIN), lr)
                        lr = torch.where(
                            (kl < alg_cfg.desired_kl / 2.0) & (kl > 0.0),
                            torch.clamp_max(lr * 1.5, LR_MAX), lr)
                    updates = opt.update(grads, ts.opt_state)
                    torch._foreach_mul_(updates, [-lr] * len(updates))
                    torch._foreach_add_(params, updates)
                stats.append(torch.stack([loss.detach(), s_loss, v_loss,
                                          kl]))
        ts.lr = lr

        with torch.no_grad():
            stats = torch.stack(stats)                     # (n_ep*n_mb, 4)
            mean_stats = stats.mean(dim=0)
            ep_count = batch["ep_count"].sum()
            denom = torch.clamp_min(ep_count, 1.0)
            last = steps[-1]
            metrics = {
                "loss": mean_stats[0],
                "surrogate_loss": mean_stats[1],
                "value_loss": mean_stats[2],
                "kl": mean_stats[3],
                "kl_max": stats[:, 3].max(),
                "noise_std": model.std.detach().mean(),
                "lr": lr,
                "mean_step_reward": batch["reward"].mean(),
                "episode_count": ep_count,
                "mean_episode_length": batch["ep_len_sum"].sum() / denom,
                "terrain_level": last["terrain_level"],
                "max_command_x": last["max_command_x"],
                "episode": {
                    name: torch.stack([s["ep_sums"][name]
                                       for s in steps]).sum() / denom
                    for name in last["ep_sums"]},
            }
        if learn_iteration.profile:
            t2 = clock(device)
            learn_iteration.times.append({"rollout_s": t1 - t0,
                                          "update_s": t2 - t1})
        if recurrent:
            obs = (obs, memory)
        return ts, env_state, obs, metrics

    learn_iteration.profile = False
    learn_iteration.times = []
    return learn_iteration
