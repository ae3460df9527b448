"""The fused physics kernel (physics/csrc/chain_step.cu) against its plain
PyTorch version (physics/chain_step.py).

- On the CPU: the kernel source built with the host C++ compiler runs the
  same per-env arithmetic as the card, and the wrapper's contract
  (device dispatch, refused variants and models) is checked.
- On the card (marker ``cuda``, skipped without one): the CUDA build at
  the main path's shape, 1800 rough-terrain go1 envs, on a fresh reset and
  on a settled state. Run there without the JAX-side conftest:
  ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py``.

This file imports no JAX.
"""
import dataclasses
import shutil

import pytest
import torch

from legged_gym_tpu_torch import registry
from legged_gym_tpu_torch.physics import chain_kernel, chain_step
from legged_gym_tpu_torch.scripts.kernel_numerics import (kernel_args,
                                                        per_env_errors,
                                                        rough_cfg,
                                                        tolerances)


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
    before = chain_kernel.run_decimation_cuda.launches
    out = chain_kernel.run_decimation_cuda(env.chain_engine.cc, *args)
    ref = chain_step.run_decimation_chain(env.chain_engine.cc, *args)
    assert chain_kernel.run_decimation_cuda.launches == before
    for r, o in zip(ref, out):
        torch.testing.assert_close(o, r, rtol=0, atol=0)


@pytest.mark.parametrize("flag", [
    {"plane_per_step": False}, {"wall_thresh": 0.075},
    {"torque_mode": True}, {"warm_start": True}])
def test_wrapper_refuses_unported_variants(cpu_env, flag):
    env = cpu_env
    cc = dataclasses.replace(env.chain_engine.cc, **flag)
    args = kernel_args(env, env.initial_state())
    with pytest.raises(NotImplementedError):
        chain_kernel.run_decimation_cuda(cc, *args)


def test_wrapper_refuses_device_mix_and_other_models(cpu_env):
    env = cpu_env
    cc = env.chain_engine.cc
    args = kernel_args(env, env.initial_state())
    mixed = list(args)
    mixed[7] = mixed[7].to("meta")
    with pytest.raises(ValueError):
        chain_kernel.run_decimation_cuda(cc, *mixed)
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
        out = chain_kernel.run_decimation_cuda(cc, *args)
        torch.cuda.synchronize()
        _assert_close(ref, out, settled)
        for _ in range(30):
            state, _ = env.step(state, zeros)


@pytest.mark.cuda
def test_env_step_launches_the_kernel(cuda_env):
    env = cuda_env
    state = env.initial_state()
    zeros = torch.zeros((env.num_envs, env.num_actions), device="cuda")
    before = chain_kernel.run_decimation_cuda.launches
    for _ in range(3):
        state, tr = env.step(state, zeros)
    torch.cuda.synchronize()
    assert chain_kernel.run_decimation_cuda.launches == before + 3
    assert torch.isfinite(tr.obs).all()


@pytest.mark.cuda
def test_wrapper_refuses_on_card(cuda_env):
    env = cuda_env
    args = kernel_args(env, env.initial_state())
    for flag in ({"plane_per_step": False}, {"torque_mode": True},
                 {"warm_start": True}, {"wall_thresh": 0.075}):
        cc = dataclasses.replace(env.chain_engine.cc, **flag)
        with pytest.raises(NotImplementedError):
            chain_kernel.run_decimation_cuda(cc, *args)
    mixed = list(args)
    mixed[7] = mixed[7].cpu()
    with pytest.raises(ValueError):
        chain_kernel.run_decimation_cuda(env.chain_engine.cc, *mixed)
