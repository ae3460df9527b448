"""Host-side training runner (the rsl_rl ``OnPolicyRunner`` equivalent,
interface per task_registry.py:160-167 / train.py:43).

The iteration itself is rl/ppo.py's ``learn_iteration``; this class
orchestrates: iteration loop, steps/s metering, checkpoint save / load
(``torch.save``), scalar logging (plain JSONL in the JAX package's layout,
plus tensorboardX if it is installed), the inference policy and the policy
export.

Split over ranks (``mesh``, the env's): every rank runs this loop on its
envs; the weights start from rank 0's, the episode-length randomization
is drawn for the global envs and cut, only rank 0 writes metrics, logs and
checkpoints, every rank reads a checkpoint, and steps/s counts the global
env-steps.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from legged_gym_tpu_torch.parallel.sharding import replicate, shard_batch
from legged_gym_tpu_torch.rl import networks as nets
from legged_gym_tpu_torch.rl.ppo import init_train_state, make_learn_fn


def _flatten_metrics(metrics):
    """(names, 0-d tensors) of a metrics dict, ``episode`` entries as
    ("episode", name)."""
    names, values = [], []
    for k, v in metrics.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                names.append((k, k2))
                values.append(v2)
        else:
            names.append(k)
            values.append(v)
    return names, values


def fetch_metrics(metrics):
    """Device metrics -> nested dict of floats, with ONE device-to-host
    copy for the whole dict."""
    names, values = _flatten_metrics(metrics)
    flat = torch.stack([v.detach().to(torch.float32) for v in values]
                       ).tolist()
    out = {}
    for name, v in zip(names, flat):
        if isinstance(name, tuple):
            out.setdefault(name[0], {})[name[1]] = v
        else:
            out[name] = v
    for k, v in metrics.items():
        if isinstance(v, dict) and not v:
            out[k] = {}
    return out


class PPORunner:
    def __init__(self, env, train_cfg, log_dir=None, seed=None):
        """Runs on ``env.device``. With the env split over ranks (its
        ``mesh``, parallel/sharding.py) it trains on every rank of the
        split, and ``log_dir`` is used by rank 0 only."""
        mesh = getattr(env, "mesh", None)
        self.env = env
        self.cfg = train_cfg
        self.mesh = mesh
        self.chief = mesh is None or mesh.rank == 0
        self.log_dir = log_dir if self.chief else None
        log_dir = self.log_dir
        self.device = torch.device(env.device)
        seed = train_cfg.seed if seed is None else seed

        # ActorCriticRecurrent selection (reference runner
        # policy_class_name, legged_robot_config.py:241)
        if ("Recurrent" in getattr(train_cfg.runner, "policy_class_name",
                                   "ActorCritic")
                and train_cfg.policy.rnn_type is None):
            train_cfg.policy.rnn_type = "lstm"
        self.recurrent = nets.is_recurrent(train_cfg.policy)

        self.train_state = init_train_state(
            seed, env.obs_dim, env.num_actions, train_cfg.policy,
            train_cfg.algorithm,
            critic_obs_dim=getattr(env, "num_privileged_obs", None),
            device=self.device)
        if mesh is not None:
            # equal already (one seed); broadcast so they start equal
            # whatever the ranks' initialization did
            replicate(self.train_state.model, mesh)
        self.reset_generator = torch.Generator(
            device=self.device).manual_seed(seed + 3)
        self.learn_fn = make_learn_fn(
            env, train_cfg.policy, train_cfg.algorithm,
            train_cfg.runner.num_steps_per_env)
        self.env_state = None
        self.obs = None
        self.current_iteration = 0
        self.last_metrics = None      # the newest logged metrics (floats)
        self._log_fh = None
        self._tb = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._log_fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(log_dir=log_dir, flush_secs=10)
            except ImportError:
                pass  # JSONL remains the source of truth

    # ------------------------------------------------------------ learning

    def _ensure_env_state(self, init_at_random_ep_len=False):
        if self.env_state is None:
            with torch.no_grad():
                self.env_state, self.obs = self.env.reset()
                if getattr(self.env, "num_privileged_obs", None) is not None:
                    # asymmetric critic: carry the (obs, privileged_obs)
                    # pack, from one more zero-action step
                    self.env_state, tr = self.env.step(
                        self.env_state, torch.zeros(
                            (self.env.num_envs, self.env.num_actions),
                            device=self.device))
                    self.obs = (tr.obs, tr.privileged_obs)
            if self.recurrent:
                self.obs = (self.obs, nets.init_memory(
                    self.env.num_envs, self.cfg.policy, device=self.device))
            if init_at_random_ep_len:
                # reference train.py:43 randomizes initial episode
                # progress to decorrelate resets
                # (drawn for the global envs, this rank's kept)
                n_all = getattr(self.env, "num_envs_global",
                                self.env.num_envs)
                lengths = shard_batch(torch.randint(
                    0, self.env.max_episode_length, (n_all,),
                    generator=self.reset_generator, device=self.device,
                    dtype=torch.int32), self.mesh)
                self.env_state = dataclasses.replace(
                    self.env_state, episode_length=lengths)

    def learn(self, num_iterations, init_at_random_ep_len=False):
        self._ensure_env_state(init_at_random_ep_len)
        steps_per_iter = (self.cfg.runner.num_steps_per_env
                          * getattr(self.env, "num_envs_global",
                                    self.env.num_envs))

        # Depth-1 pipelined metrics fetch: iteration i+1 is enqueued
        # BEFORE iteration i's metrics are read (one device-to-host copy
        # for the whole dict), so the read never waits for the card.
        pending = None  # (iteration, device metrics)

        def fetch_and_log(it, dev_metrics, dt):
            metrics = fetch_metrics(dev_metrics)
            metrics["iteration"] = it
            metrics["steps_per_s"] = steps_per_iter / dt
            self._log(metrics, it)

        t_prev = time.time()
        for it in range(self.current_iteration,
                        self.current_iteration + num_iterations):
            self.train_state, self.env_state, self.obs, metrics = \
                self.learn_fn(self.train_state, self.env_state, self.obs)
            self.current_iteration = it + 1
            if pending is not None:
                # dispatch-to-dispatch delta = steady-state wall/iter
                t_now = time.time()
                fetch_and_log(pending[0], pending[1], t_now - t_prev)
                t_prev = t_now
            pending = (it, metrics)
            if (self.log_dir is not None
                    and (it + 1) % self.cfg.runner.save_interval == 0):
                self.save(os.path.join(self.log_dir,
                                       f"model_{it + 1}.ckpt"))
        if pending is not None:
            fetch_and_log(pending[0], pending[1], time.time() - t_prev)
        if self.log_dir is not None:
            self.save(os.path.join(self.log_dir,
                                   f"model_{self.current_iteration}.ckpt"))

    def _log(self, metrics, it):
        self.last_metrics = metrics
        if self._log_fh is not None:
            self._log_fh.write(json.dumps(metrics) + "\n")
            self._log_fh.flush()
        if self._tb is not None:
            # rsl_rl's tag layout (on_policy_runner.py log()) so existing
            # TensorBoard dashboards work unchanged
            w = self._tb
            for name, v in metrics.get("episode", {}).items():
                w.add_scalar(f"Episode/rew_{name}", v, it)
            w.add_scalar("Loss/value_function", metrics["value_loss"], it)
            w.add_scalar("Loss/surrogate", metrics["surrogate_loss"], it)
            w.add_scalar("Loss/learning_rate", metrics["lr"], it)
            w.add_scalar("Policy/mean_noise_std",
                         metrics.get("noise_std", 0.0), it)
            w.add_scalar("Perf/total_fps", metrics["steps_per_s"], it)
            w.add_scalar("Train/mean_reward",
                         metrics["mean_step_reward"], it)
            w.add_scalar("Train/mean_episode_length",
                         metrics.get("mean_episode_length", 0.0), it)
        if it % 10 == 0 and self.chief:
            ep = metrics.get("episode", {})
            track = ep.get("tracking_lin_vel", 0.0)
            print(f"it {it:5d} | {metrics['steps_per_s']:.0f} steps/s | "
                  f"rew/step {metrics['mean_step_reward']:.5f} | "
                  f"eplen {metrics.get('mean_episode_length', 0):.0f} | "
                  f"track {track:.3f} | kl {metrics['kl']:.4f} | "
                  f"lr {metrics['lr']:.2e}")

    # ---------------------------------------------------------- checkpoint

    def save(self, path):
        """``torch.save`` of (params, Adam moments and count, lr,
        generator states, iteration) — the model_<it>.pt analog
        (reference save cadence legged_robot_config.py:248). Split over
        ranks, only rank 0 writes (the state is replicated)."""
        if not self.chief:
            return
        ts = self.train_state
        ckpt = {
            "params": ts.model.state_dict(),
            "opt_state": {"count": ts.opt_state.count,
                          "mu": ts.opt_state.mu, "nu": ts.opt_state.nu},
            "lr": ts.lr,
            "generators": {
                "noise": ts.noise_generator.get_state(),
                "perm": ts.perm_generator.get_state(),
                "env": self.env.generator.get_state()},
            "iteration": self.current_iteration,
        }
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        torch.save(ckpt, path)

    def load(self, path, load_optimizer=True):
        """Restore a ``save`` file; split over ranks every rank reads it,
        so weights, moments, lr, generators and the iteration are equal
        on all."""
        ckpt = torch.load(path, map_location=self.device,
                          weights_only=True)
        ts = self.train_state
        ts.model.load_state_dict(ckpt["params"])
        if load_optimizer:
            opt = ckpt["opt_state"]
            ts.opt_state.count = int(opt["count"])
            for dst, src in zip(ts.opt_state.mu, opt["mu"]):
                dst.copy_(src)
            for dst, src in zip(ts.opt_state.nu, opt["nu"]):
                dst.copy_(src)
        ts.lr = ckpt["lr"].to(self.device, torch.float32)
        gens = ckpt["generators"]
        # generator states are byte tensors that live on the CPU
        ts.noise_generator.set_state(gens["noise"].cpu())
        ts.perm_generator.set_state(gens["perm"].cpu())
        self.env.generator.set_state(gens["env"].cpu())
        self.current_iteration = int(ckpt["iteration"])
        return ckpt

    # ----------------------------------------------------------- inference

    def get_inference_policy(self):
        """Deterministic actor: obs (N, D) -> actions (N, na) (rsl_rl
        get_inference_policy equivalent, play.py:66).

        A recurrent policy is a STATEFUL callable holding the LSTM carry
        across calls, zeroed on first use — the reference's
        PolicyExporterLSTM (helpers.py:193-219, persistent hidden / cell
        state buffers); call ``policy.reset_memory()`` between episodes."""
        model = self.train_state.model
        if not self.recurrent:
            def policy(obs):
                with torch.no_grad():
                    return nets.actor_mean(model, obs)
            return policy
        return _StatefulPolicy(model, self.cfg.policy)

    def export_policy(self, path):
        """Serialize the actor for deployment (the TorchScript export of
        helpers.py:180-219, LSTM exporter included) as the JAX package's
        ``.npz``: ``w{i}`` (in, out) / ``b{i}`` per actor layer and
        ``activation``; a recurrent actor adds ``lstm_w{i}`` (in + h, 4h) /
        ``lstm_b{i}`` (torch gate order i, f, g, o), ``rnn_hidden_size``
        and ``rnn_num_layers``."""
        model = self.train_state.model
        linears = [m for m in model.actor if isinstance(m, torch.nn.Linear)]

        def host(t):
            return t.detach().cpu().numpy()

        flat = {}
        for i, lin in enumerate(linears):
            flat[f"w{i}"] = host(lin.weight).T
            flat[f"b{i}"] = host(lin.bias)
        flat["activation"] = np.asarray(self.cfg.policy.activation)
        if self.recurrent:
            for i, (w, b) in enumerate(zip(model.memory_a.w,
                                           model.memory_a.b)):
                flat[f"lstm_w{i}"] = host(w)
                flat[f"lstm_b{i}"] = host(b)
            flat["rnn_hidden_size"] = np.asarray(
                self.cfg.policy.rnn_hidden_size)
            flat["rnn_num_layers"] = np.asarray(
                self.cfg.policy.rnn_num_layers)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez(path, **flat)
        return path


class _StatefulPolicy:
    """The recurrent inference policy: the actor LSTM's carry lives here
    between calls."""

    def __init__(self, model, policy_cfg):
        self.model = model
        self.policy_cfg = policy_cfg
        self.carry = None

    def reset_memory(self):
        self.carry = None

    def __call__(self, obs):
        with torch.no_grad():
            if self.carry is None:
                self.carry = nets.init_memory(
                    obs.shape[0], self.policy_cfg, obs.dtype,
                    obs.device)["a"]
            action, self.carry = nets.actor_mean_rnn(self.model, obs,
                                                     self.carry)
        return action
