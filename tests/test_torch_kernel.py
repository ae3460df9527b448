"""The fused physics kernel (physics/csrc/chain_step.cu) against its plain
PyTorch version (physics/chain_step.py).

- On the CPU: the kernel source built with the host C++ compiler runs the
  same per-env arithmetic as the card, and the wrapper's contract
  (device dispatch, one launch count per variant, refused models) is
  checked.
- On the card (marker ``cuda``, skipped without one): the CUDA build at
  the main paths' shapes — K1 at 1800 rough-terrain go1 envs and on a1's
  layout, K4 (friction anchors) at 4096 aliengo envs, K2 at 4096 cassie
  envs on trimesh, K3 + K4 at 4096 anymal_c_rough envs — on a fresh reset
  and on a settled state. Run there without the JAX-side conftest:
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


def _assert_close(ref, out, settled):
    """Every output within its tolerance (scripts/kernel_numerics.py states
    each with its reason); returns the max errors."""
    errs = {k: float(v.max()) for k, v in per_env_errors(ref, out).items()}
    tol = tolerances(settled)
    for name, v in errs.items():
        assert v <= tol[name], (name, errs)
    return errs


# ------------------------------------------------------------- CPU checks

@pytest.fixture(scope="module")
def cpu_env():
    cfg = rough_cfg(8)
    cfg.terrain.num_rows = 3
    cfg.terrain.num_cols = 2
    cfg.terrain.border_size = 5.0
    env, _ = registry.make_env(cfg=cfg, device="cpu")
    return env


def test_host_build_matches_plain(cpu_env):
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    env = cpu_env
    cc = env.chain_engine.cc
    state = env.initial_state()
    zeros = torch.zeros((env.num_envs, env.num_actions))
    for settled in (False, True):
        args = kernel_args(env, state)
        ref = chain_step.run_decimation_chain(cc, *args)
        out = chain_kernel.run_decimation_host(cc, *args)
        errs = _assert_close(ref, out, settled)
        # same arithmetic on the host: rounding-level agreement
        assert errs["q"] < 1e-4, errs
        for _ in range(30):
            state, _ = env.step(state, zeros)


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
def test_wrapper_refuses_unported_variants(cpu_env, flag):
    """Named for what it once held, a refusal of K2 / K3 (and K4 + K2); no
    variant is unported now. Each flag is accepted, selects its variant,
    counts no launch on CPU tensors, and the kernel source's host build
    agrees with the plain version on robots in contact."""
    env = cpu_env
    cc = dataclasses.replace(env.chain_engine.cc, **flag)
    state = env.initial_state()
    for _ in range(12):                 # down onto the terrain
        state, _ = env.step(state, torch.zeros((env.num_envs,
                                                env.num_actions)))
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
    if shutil.which("c++") is None and shutil.which("g++") is None:
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
def test_wrapper_refuses_on_card(cuda_env):
    """Named for what it once held (K2 / K3 refused on the card). Every
    variant's flags launch the kernel on the card, counted on the variant's
    own count and no other, within the card's tolerances of the plain
    version; a device mix is refused."""
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
