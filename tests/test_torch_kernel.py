"""The fused physics kernel (physics/csrc/chain_step.cu) against its plain
PyTorch version (physics/chain_step.py).

- On the CPU: the kernel source built with the host C++ compiler runs the
  same per-env arithmetic as the card, lane group by lane group (any
  G_LANES the source takes), and the wrapper's contract (device dispatch,
  one launch count per variant, refused models) is checked.
- On the card (marker ``cuda``, skipped without one): the CUDA build at
  the main paths' shapes — K1 at 1800 rough-terrain go1 envs and on a1's
  layout, K4 (friction anchors) at 4096 aliengo envs, K2 at 4096 cassie
  envs on trimesh, K3 + K4 at 4096 anymal_c_rough envs — on a fresh reset
  and on a settled state, each with the lane group its launch takes
  (``chain_kernel.launch_library``). Run there without the JAX-side conftest:
  ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py``.

This file imports no JAX.
"""
import dataclasses
import shutil

import pytest
import torch

from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.physics import chain_kernel, chain_step
from legged_gym_tpu_torch.scripts.kernel_numerics import (SWITCH_ENVS_SHARE,
                                                        anchor_errors,
                                                        contact_envs,
                                                        envs_over,
                                                        kernel_args,
                                                        per_env_errors,
                                                        plain_on_cpu,
                                                        rough_cfg,
                                                        tolerances,
                                                        wall_rule_envs)


HAS_CXX = bool(shutil.which("c++") or shutil.which("g++"))


def _assert_close(ref, out, settled):
    """Every output within its tolerance (scripts/kernel_numerics.py states
    each with its reason); returns the max errors."""
    errs = {k: float(v.max()) for k, v in per_env_errors(ref, out).items()}
    tol = tolerances(settled)
    for name, v in errs.items():
        assert v <= tol[name], (name, errs)
    return errs


# ------------------------------------------------------------- CPU checks

def _small_rough(cfg):
    cfg.terrain.num_rows = 3
    cfg.terrain.num_cols = 2
    cfg.terrain.border_size = 5.0
    return cfg


@pytest.fixture(scope="module")
def cpu_env():
    env, _ = registry.make_env(cfg=_small_rough(rough_cfg(8)), device="cpu")
    return env


def _zero_steps(env, state, n):
    zeros = torch.zeros((env.num_envs, env.num_actions))
    for _ in range(n):
        state, _ = env.step(state, zeros)
    return state


@pytest.fixture(scope="module")
def cpu_states(cpu_env):
    """go1 on rough terrain: the fresh reset, 12 zero-action steps later
    (down onto the terrain) and 30 (settled), made once for the file."""
    fresh = cpu_env.initial_state()
    contact = _zero_steps(cpu_env, fresh, 12)
    return {"fresh": fresh, "contact": contact,
            "settled": _zero_steps(cpu_env, contact, 18)}


def test_host_build_matches_plain(cpu_env, cpu_states):
    if not HAS_CXX:
        pytest.skip("no host C++ compiler")
    env = cpu_env
    cc = env.chain_engine.cc
    for settled in (False, True):
        args = kernel_args(env, cpu_states["settled" if settled else "fresh"])
        ref = chain_step.run_decimation_chain(cc, *args)
        out = chain_kernel.run_decimation_host(cc, *args)
        errs = _assert_close(ref, out, settled)
        # same arithmetic on the host: rounding-level agreement
        assert errs["q"] < 1e-4, errs


@pytest.mark.parametrize("lanes", [4, 32, 16, 8],
                         ids=["G4", "G32", "chosen", "G8"])
def test_lane_group_host_build_matches_plain(cpu_env, cpu_states, lanes):
    """The source built with G_LANES lanes per env on go1's layout (4: each
    lane a chain and 23 points; 32: a whole warp per env, some lanes
    idle; 16, the G go1's 1800 envs take on the H100, and 8, the G of
    4096 envs), on the settled state with the robots on the terrain: q
    within 1e-4 of the plain version, every output within its tolerance
    (body_f 0.5 N)."""
    if not HAS_CXX:
        pytest.skip("no host C++ compiler")
    env = cpu_env
    cc = env.chain_engine.cc
    args = kernel_args(env, cpu_states["settled"])
    ref = chain_step.run_decimation_chain(cc, *args)
    assert int(contact_envs(ref).sum()) == env.num_envs    # all in contact
    out = chain_kernel.run_decimation_host(cc, *args, lanes=lanes)
    errs = _assert_close(ref, out, settled=True)
    assert errs["q"] < 1e-4, errs
    lay = chain_kernel.library_layout(chain_kernel.load_library(
        "host", layout=chain_kernel.model_layout(cc.cm), lanes=lanes))
    assert lay["G_LANES"] == lanes and lay["NPTS"] == 92


def test_lane_choice_takes_the_largest_group_that_fits_one_wave():
    """A launch takes the largest G of LANE_CHOICES whose warps the card
    holds at once, else the smallest; the host build reports the warps a
    launch starts (32 / G envs a warp) and holds none."""
    pick = chain_kernel.pick_lanes
    assert chain_kernel.LANE_CHOICES == (16, 8)
    # the H100's counts at 168 registers: 12 warps an SM of 132
    assert pick({16: (900, 1584), 8: (450, 1584)}) == 16      # go1, 1800
    assert pick({16: (2048, 1584), 8: (1024, 1584)}) == 8     # 4096 envs
    assert pick({16: (8192, 1584), 8: (4096, 1584)}) == 8     # no fit
    if not HAS_CXX:
        pytest.skip("no host C++ compiler")
    for g in (16, 8):
        lib = chain_kernel.load_library("host", layout=chain_kernel.GO1_LAYOUT,
                                        lanes=g)
        assert chain_kernel.library_fit(lib, 1800, False) == (
            -(-1800 // (32 // g)), 0)


def test_lane_group_host_build_with_anchors_matches_plain():
    """aliengo's layout with friction anchors (K4) at G_LANES = 4, each
    lane owning 21 of the 84 points' planes and anchors: 12 steps down
    onto the plane, then the anchors out within 5e-3 m of the plain
    version's, none live in one and sentinel in the other, and q within
    1e-4."""
    if not HAS_CXX:
        pytest.skip("no host C++ compiler")
    cfg, _ = registry.get_cfgs("aliengo")
    cfg.env.num_envs = 4
    env, _ = registry.make_env(cfg=cfg, device="cpu")
    cc = env.chain_engine.cc
    state = _zero_steps(env, env.initial_state(), 12)
    args = kernel_args(env, state)
    anchors = state.contact_ws
    assert float((anchors < 1e5).float().mean()) > 0.9      # live anchors
    ref = chain_step.run_decimation_chain(cc, *args, anchors=anchors)
    out = chain_kernel.run_decimation_host(cc, *args, anchors=anchors,
                                           lanes=4)
    assert int(contact_envs(ref).sum()) == env.num_envs
    errs = _assert_close(ref[:7], out[:7], settled=True)
    assert errs["q"] < 1e-4, errs
    err, n_live, n_diff = anchor_errors(ref[7], out[7])
    assert n_diff == 0 and n_live > 0 and err <= 5e-3, (err, n_diff)


def test_cpu_tensors_run_the_plain_version(cpu_env):
    env = cpu_env
    state = env.initial_state()
    args = kernel_args(env, state)
    before = dict(chain_kernel.launches)
    out = chain_kernel.run_decimation(env.chain_engine.cc, *args)
    ref = chain_step.run_decimation_chain(env.chain_engine.cc, *args)
    assert chain_kernel.launches == before
    for r, o in zip(ref, out):
        torch.testing.assert_close(o, r, rtol=0, atol=0)


@pytest.mark.parametrize("flag", [
    {"plane_per_step": False}, {"wall_thresh": 0.075},
    {"torque_mode": True}, {"warm_start": True, "plane_per_step": False}])
def test_every_variant_selects_and_host_build_matches_plain(cpu_env,
                                                            cpu_states,
                                                            flag):
    """Each flag of K2 / K3 (and K4 + K2) is accepted, selects its
    variant, counts no launch on CPU tensors, and the kernel source's host
    build agrees with the plain version on robots in contact."""
    env = cpu_env
    cc = dataclasses.replace(env.chain_engine.cc, **flag)
    state = cpu_states["contact"]
    args = kernel_args(env, state)
    anchors = None
    if cc.warm_start:
        anchors = chain_step.init_anchors(cc.cm, env.num_envs, "cpu")
    if cc.torque_mode:
        args[3] = 20.0 * torch.randn(
            args[3].shape, generator=torch.Generator().manual_seed(0))
    name = chain_step.variant(cc, anchored=anchors is not None)
    assert name == ("K3" if cc.torque_mode else "K2")
    chain_step.check_variant(cc)
    before = dict(chain_kernel.launches)
    ref = chain_kernel.run_decimation(cc, *args, anchors=anchors)
    assert len(ref) == (7 if anchors is None else 8)
    assert chain_kernel.launches == before       # CPU: the plain version
    assert int((ref[6][2].sum(0) > 10.0).sum()) >= 6    # robots in contact
    if not HAS_CXX:
        pytest.skip("no host C++ compiler")
    host = chain_kernel.run_decimation_host(cc, *args, anchors=anchors)
    errs = _assert_close(ref[:7], host[:7], settled=True)
    assert errs["q"] < 1e-4, errs
    if cc.torque_mode:      # tau out is the torque clipped to effort
        lim = torch.as_tensor(cc.effort, dtype=torch.float32)[..., None]
        torch.testing.assert_close(host[5], torch.clamp(args[3], -lim, lim))
    # (tests/test_torch_trimesh.py holds K2 on terrain where the wall rule
    # and the per-sim-dt plane change the result, against the JAX package)


def test_wrapper_refuses_device_mix_and_other_models(cpu_env):
    env = cpu_env
    cc = env.chain_engine.cc
    args = kernel_args(env, env.initial_state())
    mixed = list(args)
    mixed[7] = mixed[7].to("meta")
    with pytest.raises(ValueError):
        chain_kernel.run_decimation(cc, *mixed)
    layout = dict(L=3, K=2, NG=4, S=(8, 4, 8, 9), NB=17, N_CONST=0,
                  N_SCALAR=chain_kernel.N_SCALAR,
                  JSTRIDE=chain_kernel.JSTRIDE, PSTRIDE=chain_kernel.PSTRIDE)
    with pytest.raises(NotImplementedError):
        chain_kernel.check_model(cc, layout)
    layout["K"] = 4
    chain_kernel.check_model(cc, layout)


# ------------------------------------------------------------ card checks

@pytest.fixture(scope="module")
def cuda_env():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    env, _ = registry.make_env(cfg=rough_cfg(1800), device="cuda")
    return env


def _assert_lane_group(cc, n, anchored=False):
    """A launch of n envs of this model runs one env on a lane group (G_LANES
    > 1): the largest of LANE_CHOICES whose warps fit the card at once."""
    layout = chain_kernel.model_layout(cc.cm)
    lay = chain_kernel.library_layout(chain_kernel.launch_library(
        layout, n, anchored))
    fits = {g: chain_kernel.library_fit(chain_kernel.load_library(
        "cuda", layout=layout, lanes=g), n, anchored)
        for g in chain_kernel.LANE_CHOICES}
    assert all(held > 0 for _, held in fits.values())
    assert lay["G_LANES"] == chain_kernel.pick_lanes(fits) > 1


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_env):
    env = cuda_env
    cc = env.chain_engine.cc
    state = env.initial_state()
    zeros = torch.zeros((env.num_envs, env.num_actions), device="cuda")
    for settled in (False, True):
        args = kernel_args(env, state)
        ref = chain_step.run_decimation_chain(cc, *args)
        out = chain_kernel.run_decimation(cc, *args)
        torch.cuda.synchronize()
        _assert_close(ref, out, settled)
        for _ in range(30):
            state, _ = env.step(state, zeros)
    _assert_lane_group(cc, env.num_envs)


@pytest.mark.cuda
def test_env_step_launches_the_kernel(cuda_env):
    env = cuda_env
    state = env.initial_state()
    zeros = torch.zeros((env.num_envs, env.num_actions), device="cuda")
    before = dict(chain_kernel.launches)
    for _ in range(3):
        state, tr = env.step(state, zeros)
    torch.cuda.synchronize()
    assert chain_kernel.launches == dict(before, K1=before["K1"] + 3)
    assert torch.isfinite(tr.obs).all()


@pytest.mark.cuda
def test_every_variant_launches_on_card_and_is_counted(cuda_env):
    """Every variant's flags launch the kernel on the card, counted on the
    variant's own count and no other, within the card's tolerances of the
    plain version; a device mix is refused."""
    env = cuda_env
    state = env.initial_state()
    args = kernel_args(env, state)
    for flag in ({"plane_per_step": False}, {"torque_mode": True},
                 {"warm_start": True, "torque_mode": True},
                 {"wall_thresh": 0.075}):
        cc = dataclasses.replace(env.chain_engine.cc, **flag)
        anchors = None
        if cc.warm_start:
            anchors = chain_step.init_anchors(cc.cm, env.num_envs, "cuda")
        name = chain_step.variant(cc, anchored=anchors is not None)
        before = dict(chain_kernel.launches)
        out = chain_kernel.run_decimation(cc, *args, anchors=anchors)
        ref = chain_step.run_decimation_chain(cc, *args, anchors=anchors)
        torch.cuda.synchronize()
        assert chain_kernel.launches == dict(before, **{name: before[name] + 1})
        _assert_close(ref[:7], out[:7], settled=False)
    mixed = list(args)
    mixed[7] = mixed[7].cpu()
    with pytest.raises(ValueError):
        chain_kernel.run_decimation(env.chain_engine.cc, *mixed)


@pytest.mark.cuda
def test_k4_kernel_matches_plain_on_card():
    """Kernel variant K4 (warm-start friction anchors) at aliengo's own
    4096 envs: outputs at the card's tolerances, anchors within 5e-3 m,
    every anchor live in both; the env step launches it once per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    env, _ = registry.make_env("aliengo", device="cuda")
    cc = env.chain_engine.cc
    state = env.initial_state()
    zeros = torch.zeros((env.num_envs, env.num_actions), device="cuda")
    for settled in (False, True):
        args = kernel_args(env, state)
        ref = chain_step.run_decimation_chain(cc, *args,
                                              anchors=state.contact_ws)
        out = chain_kernel.run_decimation(cc, *args,
                                          anchors=state.contact_ws)
        torch.cuda.synchronize()
        _assert_close(ref[:7], out[:7], settled)
        err, _, n_diff = anchor_errors(ref[7], out[7])
        assert err <= 5e-3 and n_diff == 0
        before = dict(chain_kernel.launches)
        for _ in range(30):
            state, _ = env.step(state, zeros)
        assert chain_kernel.launches == dict(before, K4=before["K4"] + 30)
    _assert_lane_group(cc, env.num_envs, anchored=True)


# ------------------- card checks of the trimesh and torque-drive paths

def _card_check(task, variant, n, share=0.0, **flags):
    """Fresh: every output of every env within its tolerance of the plain
    version. Settled, on the paths where rounding flips contacts
    (``share`` > 0, scripts/kernel_numerics.py says why): within tolerance
    of the plain version on the card or on the CPU, but for ``share`` of
    the envs. The env step counts one launch on ``variant``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    cfg, _ = registry.get_cfgs(task)
    cfg.env.num_envs = n
    env, _ = registry.make_env(cfg=cfg, device="cuda")
    cc = dataclasses.replace(env.chain_engine.cc, **flags)
    assert chain_step.variant(cc) == variant
    state = env.initial_state()
    zeros = torch.zeros((n, env.num_actions), device="cuda")
    for settled in (False, True):
        args = kernel_args(env, state)
        ref = chain_step.run_decimation_chain(cc, *args)
        before = dict(chain_kernel.launches)
        out = chain_kernel.run_decimation(cc, *args)
        torch.cuda.synchronize()
        assert chain_kernel.launches == dict(
            before, **{variant: before[variant] + 1})
        ref_cpu = plain_on_cpu(cc, args, None) if settled and share else None
        allowed = int(share * n) if settled else 0
        assert len(envs_over(ref, out, settled, ref_cpu)) <= allowed
        if settled and cc.wall_thresh > 0:
            cv = chain_step.const_tensors(cc, "cuda")
            assert int(contact_envs(ref).sum()) >= n // 4
            assert int(wall_rule_envs(cc, cv, args).sum()) >= 10
        before = dict(chain_kernel.launches)
        for _ in range(30):
            state, _ = env.step(state, zeros)
        name = chain_step.variant(env.chain_engine.cc)
        assert chain_kernel.launches == dict(
            before, **{name: before[name] + 30})
    _assert_lane_group(cc, n)


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_card():
    """K2 (trimesh wall rule) on cassie at its own 4096 envs."""
    _card_check("cassie", "K2", 4096, share=SWITCH_ENVS_SHARE)


@pytest.mark.cuda
def test_k2_kernel_with_plane_per_sim_dt_matches_plain_on_card():
    """K2 with the plane re-sampled every sim dt, and the wall rule."""
    _card_check("cassie", "K2", 4096, share=SWITCH_ENVS_SHARE,
                plane_per_step=False)


@pytest.mark.cuda
def test_k1_kernel_on_a1_layout_matches_plain_on_card():
    _card_check("a1", "K1", 4096)


@pytest.mark.cuda
def test_k3_k4_kernel_matches_plain_on_card():
    """K3 + K4 + the wall rule on anymal_c_rough at its own 4096 envs, one
    SEA segment with live anchors, fresh and settled; the env step launches
    it four times per policy step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    env, _ = registry.make_env("anymal_c_rough", device="cuda")
    cc = env.chain_engine.cc_sea
    n = env.num_envs
    state = env.initial_state()
    zeros = torch.zeros((n, env.num_actions), device="cuda")
    for settled in (False, True):
        args = kernel_args(env, state)
        anchors = state.contact_ws
        ref = chain_step.run_decimation_chain(cc, *args, anchors=anchors)
        out = chain_kernel.run_decimation(cc, *args, anchors=anchors)
        torch.cuda.synchronize()
        # settled: every env within tolerance of the plain version on the
        # card or on the CPU, but for 2 of 4096 (rounding flips contacts,
        # scripts/kernel_numerics.py)
        ref_cpu = plain_on_cpu(cc, args, anchors) if settled else None
        allowed = int(SWITCH_ENVS_SHARE * n) if settled else 0
        assert len(envs_over(ref, out, settled, ref_cpu)) <= allowed
        err, _, n_diff = anchor_errors(ref[7], out[7])
        assert err <= 5e-3 and n_diff == 0
        if settled:
            cv = chain_step.const_tensors(cc, "cuda")
            assert int(contact_envs(ref).sum()) >= n // 4
            assert int(wall_rule_envs(cc, cv, args).sum()) >= 10
        before = dict(chain_kernel.launches)
        for _ in range(30):
            state, _ = env.step(state, zeros)
        assert chain_kernel.launches == dict(before, K3=before["K3"] + 4 * 30)
    _assert_lane_group(cc, n, anchored=True)
