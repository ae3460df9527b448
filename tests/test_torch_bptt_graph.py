"""The recurrent update on the CUDA-graph path (rl/ppo.py, the capture
helper utils/cuda_graph.py): where graphs apply, the recurrent
minibatch step replays as the one step graph the feed-forward step
replays (its CPU and card tests: tests/test_torch_update_graph.py).

On the CPU: a recurrent + asymmetric update never captures."""
from __future__ import annotations

import dataclasses

import torch

from legged_gym_tpu_torch.config import AlgorithmCfg, PolicyCfg
from legged_gym_tpu_torch.envs.legged_env import Transition
from legged_gym_tpu_torch.rl import networks as nets, ppo
from legged_gym_tpu_torch.utils import cuda_graph

STEPS = 24
OBS, PRIV, ACTIONS = 235, 249, 12


def _policy(hidden):
    return PolicyCfg(rnn_type="lstm", rnn_hidden_size=hidden,
                     rnn_num_layers=1)


def _transitions(n, device, seed=11):
    """``STEPS`` seeded transitions of ``n`` envs, dones and timeouts
    among them."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for t in range(STEPS):
        done = torch.rand(n, generator=gen) < 0.08
        done[t % n] = t in (5, 13)
        out.append(Transition(
            obs=torch.randn((n, OBS), generator=gen),
            reward=0.1 * torch.randn(n, generator=gen), done=done,
            time_out=done & (torch.rand(n, generator=gen) < 0.5),
            episode_sums={"tracking": torch.rand((), generator=gen)},
            episode_count=done.sum().float(),
            episode_length_sum=torch.rand((), generator=gen),
            terrain_level_mean=torch.zeros(()),
            max_command_x=torch.ones(()), torques=torch.zeros(()),
            feet_contact_z=torch.zeros(()),
            privileged_obs=torch.randn((n, PRIV), generator=gen)))
    return [dataclasses.replace(
        tr, **{f.name: _to(getattr(tr, f.name), device)
               for f in dataclasses.fields(tr)}) for tr in out]


def _to(x, device):
    if isinstance(x, dict):
        return {k: v.to(device) for k, v in x.items()}
    return x.to(device)


@dataclasses.dataclass
class _Replay:
    """The same transitions every window; the actions sent are kept."""
    transitions: list
    num_envs: int
    num_actions: int = ACTIONS
    num_privileged_obs: int = PRIV

    def __post_init__(self):
        self.actions = []

    def step(self, state, actions):
        self.actions.append(actions.clone())
        return state, self.transitions[(len(self.actions) - 1) % STEPS]


def test_a_cpu_update_never_captures(monkeypatch):
    def capture(*args, **kw):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", capture)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(cuda_graph, "Graphs", capture)
    policy = _policy(8)
    alg = AlgorithmCfg(num_learning_epochs=1, num_mini_batches=2)
    env = _Replay(_transitions(4, "cpu"), num_envs=4)
    ts = ppo.init_train_state(0, OBS, ACTIONS, policy, alg,
                              critic_obs_dim=PRIV, device="cpu")
    obs = ((env.transitions[0].obs, env.transitions[0].privileged_obs),
           nets.init_memory(4, policy))
    learn = ppo.make_learn_fn(env, policy, alg, STEPS)
    _, _, _, metrics = learn(ts, None, obs)
    assert torch.isfinite(metrics["loss"])
