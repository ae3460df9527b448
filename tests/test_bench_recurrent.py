"""The benchmark's recurrent training cell (``go1_rough_lstm.train``) on
the CPU, its parts: the plain reference's LSTM (benchmark/reference/rl/
networks.py) against ``torch.nn.LSTM``; one recurrent PPO iteration with
privileged observations, the port's ``make_learn_fn`` against the
reference's on the same weights, transitions and generators; the counted
operations of the configuration (benchmark/work/flops_recurrent.py); the
port's ``ppo.bptt`` span, once per minibatch step of a recurrent policy
and never on an MLP's."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import spec, weights as bench_weights
from benchmark.reference import config as ref_config
from benchmark.reference.rl import networks as ref_nets, ppo as ref_ppo
from benchmark.work import flops_recurrent
from legged_gym_tpu_torch import config as port_config
from legged_gym_tpu_torch.envs.legged_env import Transition
from legged_gym_tpu_torch.rl import ppo
from legged_gym_tpu_torch.utils import profiling

CELL = "go1_rough_lstm.train"
ENVS, STEPS = 16, 24
OBS, PRIV, ACTIONS = 235, 249, 12


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def config():
    return spec.load_cell(CELL).config


def test_reference_lstm_is_the_published_cell():
    """The reference's LSTM at hidden 512 over a 24-step sequence from a
    nonzero carry, the carry zeroed after step 11 in half of the envs,
    against ``torch.nn.LSTM`` (gate order i, f, g, o; ``w`` is
    [W_ih; W_hh] transposed, ``b`` = b_ih + b_hh) run over each segment:
    to 1e-6, float32 rounding of gate sums over 747 terms."""
    hidden, n_in, n = 512, OBS, 4
    gen = torch.Generator().manual_seed(3)
    ref = ref_nets.LSTM(n_in, hidden, 1, generator=gen)
    lstm = torch.nn.LSTM(n_in, hidden, 1)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
        ref.w[0].copy_(torch.cat([lstm.weight_ih_l0, lstm.weight_hh_l0],
                                 dim=1).T)
        ref.b[0].copy_(lstm.bias_ih_l0 + lstm.bias_hh_l0)
    x = torch.randn((STEPS, n, n_in), generator=gen)
    carry0 = 0.5 * torch.randn((n, 1, 2, hidden), generator=gen)
    done = torch.zeros((STEPS, n))
    done[11, :2] = 1.0

    with torch.no_grad():
        carry, outs = carry0, []
        for t in range(STEPS):
            out, carry = ref(x[t], carry)
            carry = carry * (1.0 - done[t])[:, None, None, None]
            outs.append(out)
        got = torch.stack(outs)
        h0, c0 = carry0[:, 0, 0][None], carry0[:, 0, 1][None]
        first, (h, c) = lstm(x[:12], (h0, c0))
        keep = (1.0 - done[11])[None, :, None]
        second, _ = lstm(x[12:], (h * keep, c * keep))
        want = torch.cat([first, second])
    assert got.shape == want.shape == (STEPS, n, hidden)
    assert float((got - want).abs().max()) < 1e-6


@dataclasses.dataclass
class _Replay:
    """The same seeded transitions, step after step, for either side; the
    actions each side sent are kept."""
    transitions: list
    num_envs: int = ENVS
    num_actions: int = ACTIONS
    num_privileged_obs: int = PRIV

    def __post_init__(self):
        self.actions = []

    def step(self, state, actions):
        self.actions.append(actions.clone())
        return state, self.transitions[len(self.actions) - 1]


def _transitions(seed):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for t in range(STEPS):
        done = torch.rand(ENVS, generator=gen) < 0.08
        done[t % ENVS] = t in (5, 13)      # a done mid-window, surely
        out.append(Transition(
            obs=torch.randn((ENVS, OBS), generator=gen),
            reward=0.1 * torch.randn(ENVS, generator=gen), done=done,
            time_out=done & (torch.rand(ENVS, generator=gen) < 0.5),
            episode_sums={"tracking": torch.rand((), generator=gen)},
            episode_count=done.sum().float(),
            episode_length_sum=torch.rand((), generator=gen),
            terrain_level_mean=torch.zeros(()),
            max_command_x=torch.ones(()), torques=torch.zeros(()),
            feet_contact_z=torch.zeros(()),
            privileged_obs=torch.randn((ENVS, PRIV), generator=gen)))
    return out


def _iteration(ppo_module, cfg_module, model_cls_from_cfg, config, weights,
               start, monkeypatch):
    """One recurrent + asymmetric iteration of ``ppo_module`` from the
    weights and the carried pack ``start``: (actions, each minibatch's
    loss, Adam's first moment)."""
    _, train_cfg = spec.build_cfgs(cfg_module, config, ENVS)
    env = _Replay(_transitions(11))
    model = model_cls_from_cfg(OBS, ACTIONS, train_cfg.policy,
                               critic_obs_dim=PRIV)
    model.load_state_dict(weights, strict=True)
    ts = ppo_module.TrainState(
        model=model,
        opt_state=ppo_module.make_optimizer(train_cfg.algorithm).init(
            list(model.parameters())),
        lr=torch.tensor(train_cfg.algorithm.learning_rate),
        noise_generator=torch.Generator().manual_seed(21),
        perm_generator=torch.Generator().manual_seed(22))
    losses = []
    real_loss = ppo_module.ppo_loss

    def ppo_loss(*args, **kw):
        out = real_loss(*args, **kw)
        losses.append(out[0].detach().clone())
        return out

    monkeypatch.setattr(ppo_module, "ppo_loss", ppo_loss)
    learn = ppo_module.make_learn_fn(env, train_cfg.policy,
                                     train_cfg.algorithm, STEPS)
    learn(ts, None, start)
    return env.actions, losses, [m.clone() for m in ts.opt_state.mu]


def test_one_recurrent_iteration_equals_the_reference(config, monkeypatch):
    """16 envs at the configuration's widths (LSTM 512, 235 / 249 obs):
    the rollout's 24 actions, the 20 minibatch losses and Adam's first
    moment after the iteration, the port against the reference. Both run
    the same float32 operations in the same order in this process, so
    the tolerance is none: equal to the bit."""
    from legged_gym_tpu_torch.rl import networks as port_nets

    _, train_cfg = spec.build_cfgs(port_config, config, ENVS)
    probe = port_nets.ActorCritic.from_cfg(OBS, ACTIONS, train_cfg.policy,
                                           critic_obs_dim=PRIV)
    weights = bench_weights.make(probe, 5, 1.0, "cpu")
    gen = torch.Generator().manual_seed(9)
    start = ((torch.randn((ENVS, OBS), generator=gen),
              torch.randn((ENVS, PRIV), generator=gen)),
             {k: 0.3 * torch.randn((ENVS, 1, 2, 512), generator=gen)
              for k in ("a", "c")})
    port = _iteration(ppo, port_config, port_nets.ActorCritic.from_cfg,
                      config, weights, start, monkeypatch)
    ref = _iteration(ref_ppo, ref_config, ref_nets.ActorCritic.from_cfg,
                     config, weights, start, monkeypatch)
    (p_act, p_loss, p_mu), (r_act, r_loss, r_mu) = port, ref
    assert len(p_act) == len(r_act) == STEPS
    assert all(torch.equal(a, b) for a, b in zip(p_act, r_act))
    assert len(p_loss) == len(r_loss) == 20
    assert all(torch.equal(a, b) for a, b in zip(p_loss, r_loss))
    assert len(p_mu) == len(r_mu)
    assert all(torch.equal(a, b) for a, b in zip(p_mu, r_mu))
    # a moment of every leaf, the LSTMs' gate weights included
    assert all(float(m.abs().max()) > 0 for m in p_mu)


def test_counted_operations_of_the_recurrent_configuration(config):
    work = spec.load_cell(CELL).work()
    actor, critic = flops_recurrent.policy_flops(config)
    assert actor == 2 * (235 + 512) * 2048 + 2 * (512 * 512 + 512 * 256
                                                  + 256 * 128 + 128 * 12)
    assert critic == 2 * (249 + 512) * 2048 + 2 * (512 * 512 + 512 * 256
                                                   + 256 * 128 + 128)
    assert actor + critic == 7_884_032
    n = 4096
    assert flops_recurrent.update_flops(config, n) == 5 * 98_304 * 3 * (
        actor + critic)
    total = flops_recurrent.train_iteration_flops(config, work, n)
    assert total == pytest.approx(12.42e12, rel=1e-3)
    # the update's share, as the cell's why has it
    assert flops_recurrent.update_flops(config, n) / total == pytest.approx(
        0.935, abs=5e-3)
    # without rnn_type the MLP count of work/flops.py
    mlp = spec.load_cell("go1_rough.train").config
    from benchmark.work import flops
    assert flops_recurrent.policy_flops(mlp) == flops.policy_flops(mlp)
    assert flops_recurrent.train_iteration_flops(
        mlp, work, n) == flops.train_iteration_flops(mlp, work, n)


@pytest.mark.parametrize("recurrent", [True, False])
def test_bptt_span_once_per_minibatch_step_inside_it(recurrent):
    """Small widths: the port's update records ``ppo.bptt`` once per
    minibatch step, its parent a ``ppo.minibatch`` span, with a recurrent
    policy; never with an MLP."""
    from legged_gym_tpu_torch.config import AlgorithmCfg, PolicyCfg
    from legged_gym_tpu_torch.rl import networks as port_nets

    policy = PolicyCfg(actor_hidden_dims=[16], critic_hidden_dims=[16],
                       rnn_type="lstm" if recurrent else None,
                       rnn_hidden_size=8, rnn_num_layers=1)
    alg = AlgorithmCfg(num_learning_epochs=2, num_mini_batches=4)
    env = _Replay(_transitions(4))
    ts = ppo.init_train_state(0, OBS, ACTIONS, policy, alg,
                              critic_obs_dim=PRIV, device="cpu")
    obs = (env.transitions[0].obs, env.transitions[0].privileged_obs)
    if recurrent:
        obs = (obs, port_nets.init_memory(ENVS, policy))
    learn = ppo.make_learn_fn(env, policy, alg, STEPS)
    with profiling.recording() as rec:
        learn(ts, None, obs)
    names = [s[0] for s in rec.spans]
    bptt = [s for s in rec.spans if s[0] == "ppo.bptt"]
    assert names.count("ppo.minibatch") == 8
    assert len(bptt) == (8 if recurrent else 0)
    assert all(rec.spans[parent][0] == "ppo.minibatch"
               for _, _, _, parent in bptt)
    assert len({parent for *_, parent in bptt}) == len(bptt)
