"""The PPO update's minibatch step as one CUDA graph (rl/ppo.py:
``minibatch_step``, ``minibatch``; the capture helper
utils/cuda_graph.py: ``applies``, ``Graphs``).

On the CPU: the step as factored for capture (the static buffers, the
bias corrections read from the iteration's table, the lr carried in a
buffer), run through ``Graphs`` (which runs it eagerly where there are
no CUDA graphs) in place of the capture and of each replay, gives the
old inline minibatch loop's stats rows, lr, Adam moments and parameters
to the bit over two iterations, for a feed-forward and a recurrent
policy with a symmetric and an asymmetric critic, and the metrics it
hands out alias none of its buffers; the table holds the optimizer's
float32 bias corrections for counts 1-40 beside their float32
reciprocals, and the directions from its rows are ``Optimizer.update``'s
to the bit; the selection rule (``applies``, and the env's rule on a
step with no push or curriculum); ``Graphs.fits`` refuses a replaced
held tensor, a new storage, another stride and another generator; the
graphs keep no batch past its iteration; a new lr tensor is copied in, while new moments, a new parameter storage or a
new model capture again; a CPU update never captures and never opens
``ppo.graph``.

On the card (marker ``cuda``, skipped without one): the directions from
the table's rows are ``Optimizer.update``'s to the bit at legged_gym's
widths (a card divides by a host float as a multiplication by its
float32 reciprocal); a dead reference cycle holding captured graphs is
not collected inside another capture (which it would invalidate); three iterations at legged_gym's widths
(512-256-128, 235 obs; 249 privileged obs for the critic; LSTM 512 in
front of each head for the recurrent case) on 128 envs of replayed
transitions through a ``PPORunner``, the third after ``PPORunner.load``
of the checkpoint saved after the first, the graphed update against the
same update forced eager: every minibatch's stats row and lr, the Adam
moments, the parameters and the lr after each iteration equal to the
bit, each iteration's metrics unchanged by the later iterations, the
loaded iteration equal to the second, one capture for all three,
``ppo.graph`` opened once per minibatch step that replayed, and
``ppo.bptt`` only where the recurrent step ran eagerly. No JAX here: the
card runs this file with ``--noconftest``.

The benchmark's reader of ``update_graph_share.train``
(benchmark/metrics/update_graph_share.py) over hand-made span summaries:
the ``ppo.graph`` count over the ``ppo.minibatch`` count x 100, and
nothing without summaries or where the span never opened."""
from __future__ import annotations

import dataclasses
import functools
import gc
import types
import weakref

import numpy as np
import pytest
import torch

import legged_gym_tpu_torch
from benchmark import spec
from legged_gym_tpu_torch.config import AlgorithmCfg, PolicyCfg, TrainCfg
from legged_gym_tpu_torch.envs.legged_env import LeggedEnv, Transition
from legged_gym_tpu_torch.rl import networks as nets, ppo
from legged_gym_tpu_torch.rl.runner import PPORunner
from legged_gym_tpu_torch.utils import cuda_graph, profiling

STEPS = 24
ACTIONS = 12


def _transitions(n, obs, priv, device, seed=11):
    """``STEPS`` seeded transitions of ``n`` envs, dones and timeouts
    among them."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for t in range(STEPS):
        done = torch.rand(n, generator=gen) < 0.08
        done[t % n] = t in (5, 13)
        out.append(Transition(
            obs=torch.randn((n, obs), generator=gen),
            reward=0.1 * torch.randn(n, generator=gen), done=done,
            time_out=done & (torch.rand(n, generator=gen) < 0.5),
            episode_sums={"tracking": torch.rand((), generator=gen)},
            episode_count=done.sum().float(),
            episode_length_sum=torch.rand((), generator=gen),
            terrain_level_mean=torch.zeros(()),
            max_command_x=torch.ones(()), torques=torch.zeros(()),
            feet_contact_z=torch.zeros(()),
            privileged_obs=(torch.randn((n, priv), generator=gen)
                            if priv else None)))
    return [dataclasses.replace(
        tr, **{f.name: _to(getattr(tr, f.name), device)
               for f in dataclasses.fields(tr)}) for tr in out]


def _to(x, device):
    if isinstance(x, dict):
        return {k: v.to(device) for k, v in x.items()}
    return None if x is None else x.to(device)


class _Replay:
    """The same transitions every window, as a runner's env."""
    max_episode_length = 1000

    def __init__(self, n, obs, priv, device):
        self.transitions = _transitions(n, obs, priv, device)
        self.num_envs, self.num_actions, self.obs_dim = n, ACTIONS, obs
        self.num_privileged_obs = priv
        self.device = torch.device(device)
        self.generator = torch.Generator(device=device).manual_seed(0)
        self.calls = 0

    def reset(self):
        return None, self.transitions[-1].obs

    def step(self, state, actions):
        self.calls += 1
        return state, self.transitions[(self.calls - 1) % STEPS]

    def start(self):
        last = self.transitions[-1]
        return (last.obs, last.privileged_obs) if self.num_privileged_obs \
            else last.obs


# ----------------------------------------------------------------- CPU

def _policy(hidden, rnn=None):
    """An MLP policy, or with ``rnn`` an LSTM of that width in front of
    each head."""
    return PolicyCfg(actor_hidden_dims=[hidden, hidden // 2],
                     critic_hidden_dims=[hidden, hidden // 2],
                     rnn_type=rnn and "lstm", rnn_hidden_size=rnn or 512)


def _start(env, policy):
    """The carried obs of the first iteration: the env's pack, with zero
    carries for a recurrent policy."""
    if nets.is_recurrent(policy):
        return env.start(), nets.init_memory(env.num_envs, policy,
                                             device=env.device)
    return env.start()


def _inline_loop(ts, batch, idxs, alg, asym):
    """The update's minibatch loop as it was written inline before the
    step was factored for capture, on the staged batch ``batch`` ({"flat",
    "mem"}) and the rows ``idxs`` of each step. Returns the stats rows."""
    opt = ppo.make_optimizer(alg)
    params, lr, rows = ts.params, ts.lr, []
    flat, mem = batch["flat"], batch["mem"]
    for idx in idxs:
        if mem is None:
            mb, size = {k: v[idx] for k, v in flat.items()}, idx.numel()
        else:
            mb = {k: v[:, idx] for k, v in flat.items()}
            mb["mem_a0"], mb["mem_c0"] = mem["a"][idx], mem["c"][idx]
            size = idx.numel() * STEPS
        loss, (s_loss, v_loss, kl) = ppo.ppo_loss(
            ts.model, mb, alg, mem is not None, asym, size)
        grads = list(torch.autograd.grad(loss, params))
        with torch.no_grad():
            lr = torch.where(kl > alg.desired_kl * 2.0,
                             torch.clamp_min(lr * ppo.INV_1_5, ppo.LR_MIN),
                             lr)
            lr = torch.where((kl < alg.desired_kl / 2.0) & (kl > 0.0),
                             torch.clamp_max(lr * 1.5, ppo.LR_MAX), lr)
            updates = opt.update(grads, ts.opt_state)
            torch._foreach_mul_(updates, [-lr] * len(updates))
            torch._foreach_add_(params, updates)
        rows.append(torch.stack([loss.detach(), s_loss, v_loss, kl]))
    ts.lr = lr
    return rows


def _state(ts):
    return ([p.detach().clone() for p in ts.params],
            [m.clone() for m in ts.opt_state.mu],
            [v.clone() for v in ts.opt_state.nu], ts.lr.clone(),
            ts.opt_state.count)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return None if x is None else x.clone()


@pytest.mark.parametrize("priv, rnn", [(None, None), (7, None), (None, 6),
                                       (7, 6)],
                         ids=["symmetric", "asymmetric",
                              "recurrent-symmetric", "recurrent-asymmetric"])
def test_the_factored_step_is_the_inline_loop_to_the_bit(priv, rnn,
                                                         monkeypatch):
    obs, n = 9, 8
    policy = _policy(16, rnn)
    alg = AlgorithmCfg(learning_rate=3e-3)
    env = _Replay(n, obs, priv, "cpu")
    ts = ppo.init_train_state(4, obs, ACTIONS, policy, alg,
                              critic_obs_dim=priv, device="cpu")
    ref = ppo.init_train_state(4, obs, ACTIONS, policy, alg,
                               critic_obs_dim=priv, device="cpu")
    staged, loads, rows = [], [], []
    real_stage, real_outputs = cuda_graph.Graphs.stage, cuda_graph.Graphs.outputs

    def stage(self, group=None, tree=None):
        real_stage(self, group, tree)
        if group == "batch":
            staged.append(_clone({"flat": self._ns["flat"],
                                  "mem": self._ns["mem"]}))
        else:
            loads.append(self._ns["idx"].clone())

    def outputs(self):
        out = real_outputs(self)
        rows.append(out["row"])
        return out

    monkeypatch.setattr(cuda_graph, "applies", lambda *args: True)
    monkeypatch.setattr(cuda_graph.Graphs, "stage", stage)
    monkeypatch.setattr(cuda_graph.Graphs, "outputs", outputs)
    learn = ppo.make_learn_fn(env, policy, alg, STEPS)
    steps = alg.num_learning_epochs * alg.num_mini_batches
    start, handed, held = _start(env, policy), [], []
    for it in range(2):
        _, _, start, m = learn(ts, None, start)
        m = {k: v for k, v in m.items() if k != "episode"}
        handed.append(m)
        held.append({k: v.clone() for k, v in m.items()})
        assert len(staged) == it + 1 and len(loads) == steps * (it + 1)
        want = _inline_loop(ref, staged[it], loads[steps * it:], alg,
                            priv is not None)
        assert ts.opt_state.count == ref.opt_state.count == steps * (it + 1)
        assert _same(_state(ts), _state(ref))
        assert _same(rows[steps * it:], want)
        assert torch.equal(m["loss"], torch.stack(want).mean(0)[0])
        assert torch.equal(m["lr"], ref.lr)
    # the first iteration's metrics alias no buffer the second overwrote
    assert not torch.equal(held[0]["lr"], held[1]["lr"])
    assert _same(list(handed[0].values()), list(held[0].values()))
    # the recurrent windows start from the rollout's carries
    assert (staged[1]["mem"] is None) == (rnn is None)
    if rnn:
        assert staged[1]["mem"]["a"].abs().sum() > 0


def _directions_from_the_table(device, shapes):
    """40 optimizer steps on ``device``, ``Optimizer.update`` (host float
    corrections) beside ``directions`` from the rows of the table."""
    table = torch.from_numpy(ppo.bias_correction_table(0, 40)).to(device)
    gen = torch.Generator().manual_seed(2)
    opt = ppo.Optimizer(1.0)
    host = opt.init([torch.zeros(s, device=device) for s in shapes])
    read = opt.init([torch.zeros(s, device=device) for s in shapes])
    for count in range(1, 41):
        grads = [0.3 * torch.randn(s, generator=gen).to(device)
                 for s in shapes]
        want = opt.update([g.clone() for g in grads], host)
        got = opt.directions([g.clone() for g in grads], read,
                             table[count - 1, 0], table[count - 1, 1])
        assert host.count == count
        assert _same(got, want)
        assert _same(read.mu, host.mu) and _same(read.nu, host.nu)


def test_the_bias_correction_table_is_the_optimizers():
    table = ppo.bias_correction_table(0, 40)
    assert table.dtype == np.float32 and table.shape == (40, 2, 2)
    for count in range(1, 41):
        want = (float(np.float32(1.0) - np.float32(ppo.ADAM_B1) ** count),
                float(np.float32(1.0) - np.float32(ppo.ADAM_B2) ** count))
        assert tuple(float(x) for x in table[count - 1, :, 0]) == want
        assert np.array_equal(table[count - 1, :, 1],
                              np.float32(1.0) / np.float32(want))
    assert np.array_equal(ppo.bias_correction_table(17, 3), table[17:20])
    # Optimizer.update (host floats) and directions from the table's rows
    _directions_from_the_table("cpu", [(5, 3), (3,), (1,)])


@pytest.mark.cuda
def test_the_tables_corrections_are_the_host_floats_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _directions_from_the_table("cuda", [(512, 235), (512,), (12, 128),
                                        (12,)])


@pytest.mark.parametrize("device, mesh, recurrent, graphed", [
    ("cuda", None, False, True), ("cpu", None, False, False),
    ("cuda", "split", False, False), ("cuda", None, True, True)])
def test_the_selection_rule(device, mesh, recurrent, graphed):
    # the policy's kind is no clause: a recurrent update replays its
    # whole step as a feed-forward one does
    device = torch.device(device)
    assert cuda_graph.applies(device, mesh) is graphed
    # the env's rule on a step that neither pushes nor runs the curriculum
    env = types.SimpleNamespace(device=device, mesh=mesh,
                                _push_step=lambda step: False,
                                _curriculum_step=lambda step: False)
    env._graphs_apply = functools.partial(LeggedEnv._graphs_apply, env)
    assert LeggedEnv._graph_step(env, 1, torch.zeros(2, ACTIONS)) is graphed


def _fits_case(graphs, x, gen, held, change):
    if change == "held":
        held = [held[0].clone()] + held[1:]
    elif change == "storage":
        held[0].data = held[0].data.clone()
    elif change == "stride":
        x = x.t().contiguous().t()
    else:
        gen = torch.Generator().manual_seed(0)
    return graphs.fits({"a": {"x": x}}, gen, held)


@pytest.mark.parametrize("change", ["held", "storage", "stride",
                                    "generator"])
def test_fits_refuses_what_the_graphs_cannot_run(change):
    gen = torch.Generator().manual_seed(0)
    x, held = torch.randn(4, 3), [torch.zeros(3), torch.zeros(2)]
    graphs = cuda_graph.Graphs([lambda v: {"y": v["x"] + 1.0}],
                               {"a": {"x": x}}, gen, held)
    assert graphs.fits({"a": {"x": torch.randn(4, 3)}}, gen, list(held))
    assert not _fits_case(graphs, x, gen, list(held), change)


def test_reuse_keeps_what_fits_and_run_captures_then_replays():
    x = torch.randn(4, 3)
    made = []

    def sections():
        made.append(None)
        return [lambda v: {"y": v["x"] + 1.0}, lambda v: {"z": 2.0 * v["y"]}]

    graphs = cuda_graph.reuse(None, sections, {"a": {"x": x}})
    with profiling.recording() as rec:
        for step in range(3):
            x = torch.randn(4, 3)
            again = cuda_graph.reuse(graphs, sections, {"a": {"x": x}})
            assert again is graphs
            replayed, out = graphs.run(spans=("one", "two"), span="all")
            assert replayed is (step > 0)
            assert torch.equal(out["z"], 2.0 * (x + 1.0))
    spans = rec.summary()
    assert (spans["all"]["n"], spans["one"]["n"], spans["two"]["n"]) == (
        2, 3, 3)
    # a new layout builds new graphs, which capture again
    other = cuda_graph.reuse(graphs, sections, {"a": {"x": x.t()}})
    assert other is not graphs and len(made) == 2
    assert other.run()[0] is False
    # staged by the caller
    other.stage("a", {"x": (x + 1.0).t()})
    replayed, out = other.run(stage=False)
    assert replayed and torch.equal(out["z"], 2.0 * ((x + 1.0).t() + 1.0))


@pytest.mark.cuda
def test_no_graph_is_collected_inside_a_capture():
    """A dead reference cycle that holds captured graphs (as a dead env's
    sections hold the env) is not collected while other graphs record."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    x = torch.arange(8.0, device="cuda")
    old = cuda_graph.Graphs([lambda v: {"y": 2.0 * v["x"]}],
                            {"a": {"x": x}})
    old.stage()
    old.capture()
    spare, calls = [old], []
    del old

    def section(v):
        calls.append(None)
        if len(calls) == 2:                    # the recording
            cycle = types.SimpleNamespace(graphs=spare.pop())
            cycle.me = cycle
            del cycle
            # enough new containers for several young-generation passes
            junk = [[] for _ in range(4 * gc.get_threshold()[0])]
            del junk
        return {"y": v["x"] + 1.0}

    graphs = cuda_graph.Graphs([section], {"a": {"x": x}})
    graphs.stage()
    graphs.capture()
    graphs.stage("a", {"x": x + 5.0})
    graphs.replay(0)
    assert torch.equal(graphs.outputs()["y"], x + 6.0)
    assert len(calls) == 2 and not spare


def test_the_graphs_keep_no_batch_past_the_iteration(monkeypatch):
    batches = []
    real_stage = cuda_graph.Graphs.stage

    def stage(self, group=None, tree=None):
        if group == "batch":
            batches.append(weakref.ref(self._given["batch"][0]))
        return real_stage(self, group, tree)

    monkeypatch.setattr(cuda_graph, "applies", lambda *args: True)
    monkeypatch.setattr(cuda_graph.Graphs, "stage", stage)
    obs, n = 9, 8
    policy = _policy(16)
    alg = AlgorithmCfg(num_learning_epochs=1, num_mini_batches=2)
    env = _Replay(n, obs, None, "cpu")
    ts = ppo.init_train_state(0, obs, ACTIONS, policy, alg, device="cpu")
    learn = ppo.make_learn_fn(env, policy, alg, STEPS)
    start = env.start()
    for _ in range(2):
        _, _, start, _ = learn(ts, None, start)
        # the staged batch's first tensor, the rollout's obs, is gone
        assert len(batches) and batches[-1]() is None


def test_new_state_tensors_capture_again(monkeypatch):
    captures = []
    real_capture = cuda_graph.Graphs.capture

    def capture(self, spans=None):
        # the iteration's step at which the capture happens, and the graphs
        captures.append(((ts.opt_state.count - 1) % 2, self))
        return real_capture(self, spans)

    monkeypatch.setattr(cuda_graph, "applies", lambda *args: True)
    monkeypatch.setattr(cuda_graph.Graphs, "capture", capture)
    obs, n = 9, 8
    policy = _policy(16)
    alg = AlgorithmCfg(num_learning_epochs=1, num_mini_batches=2)
    env = _Replay(n, obs, None, "cpu")
    ts = ppo.init_train_state(0, obs, ACTIONS, policy, alg, device="cpu")
    learn = ppo.make_learn_fn(env, policy, alg, STEPS)
    start = env.start()
    # a new lr tensor is copied in; new moments, new parameter storage
    # and a new model each need a new graph
    changes = [lambda: None,
               lambda: setattr(ts, "lr", ts.lr.clone()),
               lambda: setattr(ts, "opt_state",
                               ppo.make_optimizer(alg).init(ts.params)),
               lambda: setattr(ts.params[0], "data",
                               ts.params[0].data.clone()),
               lambda: setattr(ts, "model", ppo.init_train_state(
                   1, obs, ACTIONS, policy, alg, device="cpu").model)]
    for change in changes:
        change()
        _, _, start, _ = learn(ts, None, start)
    assert len(captures) == 4 and {k for k, _ in captures} == {0}
    assert len({id(g) for _, g in captures}) == 4


def test_a_cpu_update_never_captures(monkeypatch):
    def capture(*args, **kw):
        raise AssertionError("captured on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", capture)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    monkeypatch.setattr(cuda_graph, "Graphs", capture)
    obs, n = 9, 8
    policy = _policy(16)
    alg = AlgorithmCfg()
    env = _Replay(n, obs, None, "cpu")
    ts = ppo.init_train_state(0, obs, ACTIONS, policy, alg, device="cpu")
    learn = ppo.make_learn_fn(env, policy, alg, STEPS)
    with profiling.recording() as rec:
        _, _, _, metrics = learn(ts, None, env.start())
    names = [s[0] for s in rec.spans]
    assert names.count("ppo.minibatch") == 20 and "ppo.graph" not in names
    assert torch.isfinite(metrics["loss"])


# ---------------------------------------------------------------- card

def _three_iterations(graphed, priv, rnn, tmp_path, monkeypatch):
    """Three iterations on the card, the third after loading the
    checkpoint saved after the first (and the obs carried after it).
    Returns (per-step (row, lr), the state and metrics after each
    iteration, the metrics as read at the end, captures, ppo.graph,
    ppo.minibatch and ppo.bptt spans)."""
    steps = []
    captures = []
    if graphed:
        real_capture, real_outputs = (cuda_graph.Graphs.capture,
                                      cuda_graph.Graphs.outputs)

        def capture(self, spans=None):
            captures.append(len(steps) % 20)   # the iteration's step
            return real_capture(self, spans)

        def outputs(self):
            out = real_outputs(self)
            steps.append((out["row"].clone(), out["lr"].clone()))
            return out

        monkeypatch.setattr(cuda_graph.Graphs, "capture", capture)
        monkeypatch.setattr(cuda_graph.Graphs, "outputs", outputs)
    else:
        real_step = ppo.minibatch_step

        def minibatch_step(*args, **kw):
            row, lr = real_step(*args, **kw)
            steps.append((row.clone(), lr.clone()))
            return row, lr

        monkeypatch.setattr(cuda_graph, "applies", lambda *args: False)
        monkeypatch.setattr(ppo, "minibatch_step", minibatch_step)
    env = _Replay(128, 235, priv, "cuda")
    cfg = TrainCfg(seed=5)
    if rnn:
        cfg.policy.rnn_type, cfg.policy.rnn_hidden_size = "lstm", rnn
    runner = PPORunner(env, cfg, log_dir=None)
    runner._ensure_env_state()
    path = str(tmp_path / f"first_{graphed}.ckpt")
    after, read = [], []
    with profiling.recording() as rec:
        for it in range(3):
            if it == 2:
                runner.load(path)
                runner.obs = kept
            ts, runner.env_state, runner.obs, m = runner.learn_fn(
                runner.train_state, runner.env_state, runner.obs)
            torch.cuda.synchronize()
            m = {k: v for k, v in m.items() if k != "episode"}
            read.append(m)
            after.append((_state(ts), {k: v.clone() for k, v in m.items()}))
            if it == 0:
                runner.save(path)
                kept = runner.obs
    torch.cuda.synchronize()
    names = [s[0] for s in rec.spans]
    return (steps, after, read, captures, names.count("ppo.graph"),
            names.count("ppo.minibatch"), names.count("ppo.bptt"))


@pytest.mark.cuda
@pytest.mark.parametrize("priv, rnn", [(None, None), (249, None),
                                       (249, 512)],
                         ids=["symmetric", "asymmetric", "recurrent"])
def test_graphed_update_equals_the_eager_update_to_the_bit(priv, rnn,
                                                           tmp_path,
                                                           monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    legged_gym_tpu_torch.set_full_fp32()
    g = _three_iterations(True, priv, rnn, tmp_path, monkeypatch)
    monkeypatch.undo()
    e = _three_iterations(False, priv, rnn, tmp_path, monkeypatch)
    g_steps, g_after, g_read, g_cap, g_graph, g_mb, g_bptt = g
    e_steps, e_after, e_read, e_cap, e_graph, e_mb, e_bptt = e
    assert len(g_steps) == len(e_steps) == 60
    assert _same(g_steps, e_steps)
    for (g_state, g_m), (e_state, e_m) in zip(g_after, e_after):
        assert _same(g_state, e_state)
        assert _same(list(g_m.values()), list(e_m.values()))
    # the metrics read at the end are those read after their iteration
    for read, (_, m) in zip(g_read, g_after):
        assert _same(list(read.values()), list(m.values()))
    # the loaded iteration repeats the second
    assert _same(g_steps[40:], g_steps[20:40])
    assert _same(g_after[2], g_after[1])
    # one capture (the first step) serves the three iterations
    assert g_cap == [0] and e_cap == []
    assert (g_graph, g_mb, e_graph, e_mb) == (59, 60, 0, 60)
    # the unroll's span opens on the eager runs only: the capture step's
    # real call and its recording, or every eager step
    assert (g_bptt, e_bptt) == ((2, 60) if rnn else (0, 0))


# ---------------------------------------------------- benchmark reader

def _span_record(graphed_per_iteration, summaries=True):
    """A window of two iterations of 20 minibatch steps each, of which
    ``graphed_per_iteration[i]`` replayed."""
    times = [{"rollout_s": 0.5, "update_s": 0.1},
             {"rollout_s": 0.7, "update_s": 0.3}]
    if summaries:
        for t, graphed in zip(times, graphed_per_iteration):
            t["spans"] = {"ppo.minibatch": {"n": 20, "total_s": 0.02,
                                            "self_s": 0.01}}
            if graphed:
                t["spans"]["ppo.graph"] = {"n": graphed,
                                           "total_s": 1e-4 * graphed,
                                           "self_s": 1e-4 * graphed}
    return {"record": {"seconds": 10.0, "units": 2, "spans": times}}


@pytest.mark.parametrize("graphed, share", [((20, 20), 100.0),
                                            ((19, 20), 97.5),
                                            ((20, 0), 50.0),
                                            ((0, 0), None)])
def test_update_graph_share_reads_the_replayed_steps_share(graphed, share):
    read = spec.metric_reader("update_graph_share.train")
    got = read(_span_record(graphed))
    assert got == (share if share is None else pytest.approx(share))


def test_update_graph_share_reads_nothing_without_summaries():
    read = spec.metric_reader("update_graph_share.train")
    for bundle in (_span_record((20, 20), summaries=False),
                   {"record": {"spans": []}}, {"record": {}}):
        assert read(bundle) is None
    m = {m["name"]: m for m in spec.benchmark_file()["per_layer"]}[
        "update_graph_share.train"]
    assert (m["source"], m["better"], m["moves"], m["unit"], m["layer"],
            m["workloads"]) == ("program_span", "higher", "train_steps_per_s",
                                "%", "PPO (rl/ppo.py)",
                                ["go1_rough.train", "anymal_c_rough.train"])
