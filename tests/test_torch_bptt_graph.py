"""The recurrent update's unroll as CUDA graphs (rl/ppo.py: ``bptt``,
``Unroll``, the update's ``unroll_for``).

On the CPU: ``Unroll`` holds the model's LSTM and head parameters (not
its std) and gives ``bptt``'s outputs and gradients to the bit, with a
done inside the window; a CPU update never captures.

On the card (marker ``cuda``, skipped without one): two recurrent +
asymmetric PPO iterations at legged_gym's widths (LSTM 512, heads
512-256-128, 235 / 249 obs) on 64 envs of replayed transitions, the
graphed unroll against the same update with the capture turned into a
plain call: every action, minibatch loss, Adam moment and parameter
equal to the bit, one capture for both iterations, and ``ppo.bptt``
still opened once per minibatch step. No JAX here: the card runs this
file with ``--noconftest``."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from legged_gym_tpu_torch.config import AlgorithmCfg, PolicyCfg
from legged_gym_tpu_torch.envs.legged_env import Transition
from legged_gym_tpu_torch.rl import networks as nets, ppo
from legged_gym_tpu_torch.utils import profiling

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


def _window(n, hidden, device, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return {"obs": torch.randn((STEPS, n, OBS), generator=gen).to(device),
            "cobs": torch.randn((STEPS, n, PRIV), generator=gen).to(device),
            "done": (torch.rand((STEPS, n), generator=gen) < 0.1).float(
                ).to(device),
            "mem_a0": torch.randn((n, 1, 2, hidden), generator=gen).to(
                device),
            "mem_c0": torch.randn((n, 1, 2, hidden), generator=gen).to(
                device)}


def test_unroll_is_bptt_over_the_models_lstms_and_heads():
    policy = _policy(16)
    ts = ppo.init_train_state(0, OBS, ACTIONS, policy, AlgorithmCfg(),
                              critic_obs_dim=PRIV, device="cpu")
    model = ts.model
    unroll = ppo.Unroll(model)
    held = {id(p) for p in unroll.parameters()}
    assert held == {id(p) for n, p in model.named_parameters()
                    if n != "std"}
    w = _window(8, 16, "cpu")
    assert w["done"].sum() > 0
    args = (w["obs"], w["cobs"], w["done"], w["mem_a0"], w["mem_c0"])
    got = unroll(*args)
    want = ppo.bptt(model, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    params = list(unroll.parameters())
    g_got = torch.autograd.grad(got[0].sum() + got[1].square().sum(), params)
    g_want = torch.autograd.grad(want[0].sum() + want[1].square().sum(),
                                 params)
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))


def test_a_cpu_update_never_captures(monkeypatch):
    def capture(*args, **kw):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(torch.cuda, "make_graphed_callables", capture)
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


def _two_iterations(graphed, monkeypatch):
    """Two iterations on the card from one seed; (actions, losses, Adam
    moments, parameters, captures, ppo.bptt spans, minibatch spans)."""
    real = torch.cuda.make_graphed_callables
    captures = []

    def capture(module, args, **kw):
        captures.append(tuple(a.shape for a in args))
        return real(module, args, **kw) if graphed else module

    monkeypatch.setattr(torch.cuda, "make_graphed_callables", capture)
    losses = []
    real_loss = ppo.ppo_loss

    def ppo_loss(*args, **kw):
        out = real_loss(*args, **kw)
        losses.append(out[0].detach().clone())
        return out

    monkeypatch.setattr(ppo, "ppo_loss", ppo_loss)
    n, policy, alg = 64, _policy(512), AlgorithmCfg()
    env = _Replay(_transitions(n, "cuda"), num_envs=n)
    ts = ppo.init_train_state(5, OBS, ACTIONS, policy, alg,
                              critic_obs_dim=PRIV, device="cuda")
    gen = torch.Generator().manual_seed(9)
    obs = ((torch.randn((n, OBS), generator=gen).cuda(),
            torch.randn((n, PRIV), generator=gen).cuda()),
           {k: 0.3 * torch.randn((n, 1, 2, 512), generator=gen).cuda()
            for k in ("a", "c")})
    learn = ppo.make_learn_fn(env, policy, alg, STEPS)
    with profiling.recording() as rec:
        for _ in range(2):
            ts, _, obs, _ = learn(ts, None, obs)
    torch.cuda.synchronize()
    names = [s[0] for s in rec.spans]
    return (env.actions, losses, [m.clone() for m in ts.opt_state.mu],
            [p.detach().clone() for p in ts.model.parameters()], captures,
            names.count("ppo.bptt"), names.count("ppo.minibatch"))


@pytest.mark.cuda
def test_graphed_unroll_equals_the_eager_unroll_to_the_bit(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = _two_iterations(True, monkeypatch)
    monkeypatch.undo()
    e = _two_iterations(False, monkeypatch)
    (g_act, g_loss, g_mu, g_par, g_cap, g_bptt, g_mb) = g
    (e_act, e_loss, e_mu, e_par, e_cap, e_bptt, e_mb) = e
    assert len(g_act) == len(e_act) == 2 * STEPS
    assert all(torch.equal(a, b) for a, b in zip(g_act, e_act))
    assert len(g_loss) == len(e_loss) == 2 * 20
    assert all(torch.equal(a, b) for a, b in zip(g_loss, e_loss))
    assert all(torch.equal(a, b) for a, b in zip(g_mu, e_mu))
    assert all(torch.equal(a, b) for a, b in zip(g_par, e_par))
    # one capture of the (24, 16, ...) minibatch serves both iterations
    assert len(g_cap) == 1
    assert g_bptt == g_mb == e_bptt == e_mb == 40
