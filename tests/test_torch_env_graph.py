"""The env step's post-physics tail replayed as CUDA graphs
(``LeggedEnv._tail``) and the SEA torque drive's physics replayed as one
(``LeggedEnv._sea_physics_replayed``), on the capture helper
utils/cuda_graph.py.

On the CPU: the selection rule runs the tail eagerly on a CPU device,
with a mesh, on push and command-curriculum steps and when the actions
ask for a gradient; the physics rule graphs the SEA drive on a card,
never the position drive, and keeps the CPU, a mesh and actions that ask
for a gradient eager; a physics replay counts the kernel launches its
capture recorded; a CPU env never captures; a state survives the
flattening the graphs stage their inputs by; the tail (go1) and the tail
and SEA physics (anymal_c_rough, anchors on) through the helper's
capture, staging, replays (run eagerly where there are no CUDA graphs)
and fresh outputs equal the eager ones to the bit over a run with
pushes, curriculum steps, terrain-window refreshes and timeouts, and
keep no input past their step.

On the card (marker ``cuda``, skipped without one): go1 and
anymal_c_rough on rough trimesh at 512 envs over 44 steps, with pushes,
terrain-window refreshes, command-curriculum steps and timeouts inside
the run, against the same env forced eager (tail and physics): every
step's transition, new state, physics outputs (state, torques, contact
forces, SEA carry, anchors) and generator state equal to the bit, the
outputs of a step unchanged by the next, no input kept past its step,
the ``env.graph`` span counted once per step whose tail replayed and
``physics.graph`` once per step whose physics replayed (anymal; never on
go1), and four K3 launches counted per anymal step, replayed or not,
those of a replay being the four its capture recorded. No
JAX here: the card runs this file with ``--noconftest``.

The benchmark's readers of ``env_graph_share.train`` and
``physics_graph_share.train`` (benchmark/metrics/) over hand-made span
summaries: the ``env.graph`` count over the ``env.step`` count, and the
``physics.graph`` count over the ``env.physics`` count, x 100, and
nothing without summaries or where the span never opened."""
from __future__ import annotations

import weakref

import pytest
import torch

from benchmark import spec
from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.physics import chain_kernel
from legged_gym_tpu_torch.utils import cuda_graph, profiling
from legged_gym_tpu_torch.utils.cuda_graph import flatten, unflatten

PUSH = 13          # policy steps between pushes
EPISODE = 20       # policy steps of an episode: the command curriculum's
                   # period, and timeouts from step 21
STEPS = 44


def _cfg(task, num_envs):
    """Rough trimesh with the height scan, a push every PUSH steps and the
    command curriculum every EPISODE steps."""
    cfg, _ = registry.get_cfgs(task)
    cfg.env.num_envs = num_envs
    cfg.terrain.mesh_type = "trimesh"
    cfg.terrain.measure_heights = True
    cfg.terrain.curriculum = True
    cfg.terrain.num_rows = 4
    cfg.terrain.num_cols = 4
    cfg.env.num_observations = 235
    policy_dt = cfg.control.decimation * cfg.sim.dt
    cfg.domain_rand.push_robots = True
    cfg.domain_rand.push_interval_s = PUSH * policy_dt
    cfg.env.episode_length_s = EPISODE * policy_dt
    cfg.commands.curriculum = True
    return cfg


def test_the_selection_rule_runs_eager_where_graphs_do_not_apply(
        monkeypatch):
    cfg = _cfg("go1", 4)
    cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    env, _ = registry.make_env(cfg=cfg, device="cpu")
    assert (env.push_interval, env.max_episode_length) == (PUSH, EPISODE)
    a = torch.zeros((env.num_envs, env.num_actions))
    assert not env._graph_step(1, a)                       # a CPU device
    monkeypatch.setattr(env, "device", torch.device("cuda"))
    assert env._graph_step(1, a)
    assert not env._graph_step(PUSH, a)                    # a push step
    assert not env._graph_step(EPISODE, a)                 # the curriculum
    assert env._graph_step(PUSH + 1, a)
    with torch.enable_grad():
        assert not env._graph_step(1, a.clone().requires_grad_())
    monkeypatch.setattr(env, "mesh", object())             # split over ranks
    assert not env._graph_step(1, a)


def test_the_physics_rule_graphs_the_sea_drive_on_a_card(monkeypatch):
    envs = {}
    for task in ("anymal_c_rough", "go1"):
        cfg = _cfg(task, 4)
        cfg.terrain.num_rows = cfg.terrain.num_cols = 2
        envs[task], _ = registry.make_env(cfg=cfg, device="cpu")
    sea, pos = envs["anymal_c_rough"], envs["go1"]
    a = torch.zeros((sea.num_envs, sea.num_actions))
    assert sea._sea is not None and pos._sea is None
    assert not sea._physics_graph(a)                      # a CPU device
    for env in (sea, pos):
        monkeypatch.setattr(env, "device", torch.device("cuda"))
    assert sea._physics_graph(a)
    assert not pos._physics_graph(a)                      # the P drive
    with torch.enable_grad():
        assert not sea._physics_graph(a.clone().requires_grad_())
    monkeypatch.setattr(sea, "mesh", object())            # split over ranks
    assert not sea._physics_graph(a)


def test_a_cpu_env_never_captures():
    cfg = _cfg("go1", 4)
    cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    env, _ = registry.make_env(cfg=cfg, device="cpu")
    state, _ = env.reset()
    with profiling.recording() as rec, torch.no_grad():
        for _ in range(3):
            state, _ = env.step(state, torch.zeros((env.num_envs,
                                                    env.num_actions)))
    assert env._graphs is None and env._physics_graphs is None
    assert rec.summary()["env.step"]["n"] == 3
    assert "env.graph" not in rec.summary()
    assert "physics.graph" not in rec.summary()


def test_flatten_rebuilds_a_state_from_its_tensors():
    cfg = _cfg("anymal_c_rough", 2)
    cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    env, _ = registry.make_env(cfg=cfg, device="cpu")
    state = env.initial_state()
    leaves, spec = flatten(state)
    again = unflatten(spec, leaves)
    assert type(again) is type(state) and again.common_step == 0
    got, _ = flatten(again)
    assert len(got) == len(leaves) and all(
        a is b for a, b in zip(got, leaves))
    assert set(again.actuator_state) == {"h", "c"}
    assert again.contact_ws is state.contact_ws


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _same(a, b):
    """Equal to the bit, tensor by tensor, with equal structures."""
    la, sa = flatten(a)
    lb, sb = flatten(b)
    return sa == sb and len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _copy(x):
    leaves, spec = flatten(x)
    return unflatten(spec, [t.clone() for t in leaves])


def _graphed_against_eager(cfg, device, monkeypatch, steps=STEPS):
    """``steps`` steps of two envs from one seed, one graphed where its
    rules allow and one forced eager (tail and physics), compared step by
    step, the physics' outputs too; no tail input that the step does not
    hand on, and no contact window given to the physics, outlives the
    step. Returns the kinds of steps seen, the count of steps whose tail
    replayed, the span summary, the count of steps whose physics replayed
    and, per graphed step, the K3 launches counted and those a capture
    recorded."""
    graphed, _ = registry.make_env(cfg=cfg, seed=7, device=device)
    eager, _ = registry.make_env(cfg=cfg, seed=7, device=device)
    monkeypatch.setattr(eager, "_graph_step", lambda *args: False)
    monkeypatch.setattr(eager, "_physics_graph", lambda *args: False)
    contact_f, windows, physics = [], [], {}
    real_tail = graphed._tail

    def tail(x, *args):
        contact_f.append(weakref.ref(x["contact_f"]))
        return real_tail(x, *args)

    def spy(env, key):
        real = env._chain_physics

        def chain_physics(state, a, contact_patch, *args):
            windows.append(weakref.ref(contact_patch[0]))
            physics[key] = real(state, a, contact_patch, *args)
            return physics[key]

        monkeypatch.setattr(env, "_chain_physics", chain_physics)

    monkeypatch.setattr(graphed, "_tail", tail)
    spy(graphed, "graphed")
    spy(eager, "eager")
    draws = torch.Generator(device=device)
    draws.manual_seed(11)
    replayed, physics_replayed, k3, kinds = 0, 0, [], set()
    with torch.no_grad():
        s_g, obs_g = graphed.reset()
        s_e, obs_e = eager.reset()
        assert torch.equal(obs_g, obs_e)
        kept = None
        with profiling.recording() as rec:
            for _ in range(steps):
                a = 0.5 * torch.randn((graphed.num_envs, graphed.num_actions),
                                      generator=draws, device=device)
                step = s_g.common_step + 1
                rule = graphed._graph_step(step, a)
                if step % PUSH == 0:
                    kinds.add("push")
                if step % EPISODE == 0:
                    kinds.add("curriculum")
                if s_g.common_step % graphed.patch_refresh == 0:
                    kinds.add("refresh")
                physics_rule = graphed._physics_graph(a)
                before = graphed._graphs
                physics_before = graphed._physics_graphs
                launched = chain_kernel.launches["K3"]
                recorded = chain_kernel.recorded["K3"]
                out_g = graphed.step(s_g, a)
                k3.append((chain_kernel.launches["K3"] - launched,
                           chain_kernel.recorded["K3"] - recorded))
                out_e = eager.step(s_e, a)
                if rule and before is not None and graphed._graphs is before:
                    replayed += 1
                if (physics_rule and physics_before is not None
                        and graphed._physics_graphs is physics_before):
                    physics_replayed += 1
                assert _same(physics["graphed"], physics["eager"]), step
                assert _same(out_g, out_e), step
                assert torch.equal(graphed.generator.get_state(),
                                   eager.generator.get_state()), step
                if out_e[1].done.any():
                    kinds.add("reset")
                if kept is not None:
                    # the previous step's outputs, after this step
                    assert _same(kept[0], kept[1]), step
                kept = (out_g, _copy(out_g))
                s_g, s_e = out_g[0], out_e[0]
                del physics["graphed"], physics["eager"]
                assert contact_f[-1]() is None, step
                assert all(w() is None for w in windows[-2:]), step
    return kinds, replayed, rec.summary(), physics_replayed, k3


def test_the_tail_through_the_helper_equals_the_eager_tail_on_the_cpu(
        monkeypatch):
    cfg = _cfg("go1", 4)
    cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    monkeypatch.setattr(cuda_graph, "applies", lambda *args: True)
    kinds, replayed, spans, _, _ = _graphed_against_eager(
        cfg, "cpu", monkeypatch, EPISODE + 4)
    assert kinds == {"push", "curriculum", "refresh", "reset"}
    # eager: 1 push, 1 curriculum step, and the steps that captured
    assert replayed >= EPISODE + 4 - 1 - 1 - 2
    assert spans["env.graph"]["n"] == replayed
    # one span per section on every step, graphed or not
    for name in ("env.rewards", "env.reset", "env.obs"):
        assert spans[name]["n"] == 2 * (EPISODE + 4)


def test_the_sea_physics_through_the_helper_equals_eager_on_the_cpu(
        monkeypatch):
    cfg = _cfg("anymal_c_rough", 4)
    cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    assert cfg.sim.contact_warm_start                      # the anchors
    monkeypatch.setattr(cuda_graph, "applies", lambda *args: True)
    kinds, replayed, spans, physics_replayed, k3 = _graphed_against_eager(
        cfg, "cpu", monkeypatch, EPISODE + 4)
    assert kinds == {"push", "curriculum", "refresh", "reset"}
    # the physics replays on push and curriculum steps too; it captured on
    # the reset's step (a broadcast spawn quaternion) and the first after
    assert physics_replayed == EPISODE + 4 - 1
    assert spans["physics.graph"]["n"] == physics_replayed
    assert spans["env.physics"]["n"] == 2 * (EPISODE + 4)
    assert replayed >= EPISODE + 4 - 1 - 1 - 2
    assert spans["env.graph"]["n"] == replayed
    assert k3 == [(0, 0)] * (EPISODE + 4)                  # no card, no K3


def test_a_physics_replay_counts_what_its_capture_recorded(monkeypatch):
    cfg = _cfg("anymal_c_rough", 4)
    cfg.terrain.num_rows = cfg.terrain.num_cols = 2
    monkeypatch.setattr(cuda_graph, "applies", lambda *args: True)
    monkeypatch.setattr(chain_kernel, "launches", dict.fromkeys("AB", 0))
    monkeypatch.setattr(chain_kernel, "recorded", dict.fromkeys("AB", 0))
    env, _ = registry.make_env(cfg=cfg, device="cpu")
    capturing, real_capture = [], cuda_graph.Graphs.capture

    def capture(self, *args, **kwargs):
        capturing.append(None)
        try:
            return real_capture(self, *args, **kwargs)
        finally:
            capturing.pop()

    real_physics = env._sea_physics

    def sea_physics(x):
        if capturing:                          # as a card's capture records
            chain_kernel.recorded["A"] += 3
        return real_physics(x)

    monkeypatch.setattr(cuda_graph.Graphs, "capture", capture)
    monkeypatch.setattr(env, "_sea_physics", sea_physics)
    counted = []
    with torch.no_grad(), profiling.recording() as rec:
        state, _ = env.reset()
        for _ in range(5):
            before = chain_kernel.launches["A"]
            state, _ = env.step(state, torch.zeros((env.num_envs,
                                                    env.num_actions)))
            counted.append(chain_kernel.launches["A"] - before)
    # the reset's step (inside reset) and the first step capture; each
    # replay counts the three launches its capture recorded, and no more
    assert counted == [0, 3, 3, 3, 3]
    assert env._physics_launches == {"A": 3, "B": 0}
    assert rec.summary()["physics.graph"]["n"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["go1", "anymal_c_rough"])
def test_graphed_tail_equals_the_eager_tail_to_the_bit(task, monkeypatch):
    _need_card()
    kinds, replayed, spans, physics_replayed, k3 = _graphed_against_eager(
        _cfg(task, 512), "cuda", monkeypatch)
    torch.cuda.synchronize()
    assert kinds == {"push", "curriculum", "refresh", "reset"}
    # eager: 3 pushes, 2 curriculum steps, and the steps that captured
    # (the reset's, whose inputs come from initial_state, and the next)
    assert replayed >= STEPS - 3 - 2 - 2
    assert spans["env.graph"]["n"] == replayed
    assert spans["env.step"]["n"] == 2 * STEPS
    if task == "go1":                                      # the P drive
        assert physics_replayed == 0 and "physics.graph" not in spans
        assert k3 == [(0, 0)] * STEPS
    else:
        # captured on the reset's step (a broadcast spawn quaternion) and
        # the first after it, replayed on every later step
        assert physics_replayed == STEPS - 1
        assert spans["physics.graph"]["n"] == physics_replayed
        # four launches a step: those run, and per replay those its
        # capture recorded (the step that captured ran and recorded four)
        assert k3 == [(4, 4)] + [(4, 0)] * (STEPS - 1)


def _span_record(graphed_per_iteration, summaries=True):
    """A window of two iterations of 24 env steps each, whose tails
    replayed in ``graphed_per_iteration[i]`` of them."""
    times = [{"rollout_s": 0.5, "update_s": 0.1},
             {"rollout_s": 0.7, "update_s": 0.3}]
    if summaries:
        for t, graphed in zip(times, graphed_per_iteration):
            t["spans"] = {"env.step": {"n": 24, "total_s": 0.48,
                                       "self_s": 0.0}}
            if graphed:
                t["spans"]["env.graph"] = {"n": graphed,
                                           "total_s": 1e-3 * graphed,
                                           "self_s": 0.0}
    return {"record": {"seconds": 10.0, "units": 2, "spans": times}}


@pytest.mark.parametrize("graphed, share", [((24, 24), 100.0),
                                            ((23, 23), 100.0 * 46 / 48),
                                            ((24, 0), 50.0),
                                            ((0, 0), None)])
def test_env_graph_share_reads_the_graphed_steps_share(graphed, share):
    got = spec.metric_reader("env_graph_share.train")(_span_record(graphed))
    assert got == (share if share is None else pytest.approx(share))


def _physics_record(graphed_per_iteration, summaries=True):
    """A window of two iterations of 24 env steps each, whose physics
    replayed in ``graphed_per_iteration[i]`` of them."""
    times = [{"rollout_s": 0.5, "update_s": 0.1},
             {"rollout_s": 0.7, "update_s": 0.3}]
    if summaries:
        for t, graphed in zip(times, graphed_per_iteration):
            t["spans"] = {"env.step": {"n": 24, "total_s": 0.48,
                                       "self_s": 0.0},
                          "env.physics": {"n": 24, "total_s": 0.12,
                                          "self_s": 0.0}}
            if graphed:
                t["spans"]["physics.graph"] = {"n": graphed,
                                               "total_s": 1e-4 * graphed,
                                               "self_s": 0.0}
    return {"record": {"seconds": 10.0, "units": 2, "spans": times}}


@pytest.mark.parametrize("graphed, share", [((24, 24), 100.0),
                                            ((22, 24), 100.0 * 46 / 48),
                                            ((0, 12), 25.0),
                                            ((0, 0), None)])
def test_physics_graph_share_reads_the_replayed_physics_share(graphed,
                                                              share):
    got = spec.metric_reader("physics_graph_share.train")(
        _physics_record(graphed))
    assert got == (share if share is None else pytest.approx(share))


def test_physics_graph_share_reads_nothing_without_summaries():
    read = spec.metric_reader("physics_graph_share.train")
    for bundle in (_physics_record((24, 24), summaries=False),
                   {"record": {"spans": []}}, {"record": {}}):
        assert read(bundle) is None
    m = {m["name"]: m for m in spec.benchmark_file()["per_layer"]}[
        "physics_graph_share.train"]
    assert (m["source"], m["better"], m["moves"], m["unit"], m["layer"],
            m["workloads"]) == ("program_span", "higher",
                                "train_steps_per_s", "%",
                                "env step (envs/legged_env.py)",
                                ["anymal_c_rough.train"])


def test_env_graph_share_reads_nothing_without_summaries():
    read = spec.metric_reader("env_graph_share.train")
    for bundle in (_span_record((24, 24), summaries=False),
                   {"record": {"spans": []}}, {"record": {}}):
        assert read(bundle) is None
    m = {m["name"]: m for m in spec.benchmark_file()["per_layer"]}[
        "env_graph_share.train"]
    assert (m["source"], m["better"], m["moves"], m["unit"],
            m["workloads"]) == ("program_span", "higher", "train_steps_per_s",
                                "%", ["go1_rough.train",
                                      "anymal_c_rough.train",
                                      "go1_rough_lstm.train"])
