"""The fused physics step as a hand-written CUDA kernel (csrc/chain_step.cu).

Replaces the TPU kernel ``legged_gym_tpu/physics/pallas_step.py::
run_decimation_pallas`` (its body is ``chain_step.one_sim_dt``) in the
configuration of the main path, K1: position drive, contact plane sampled
once per policy step, no friction anchors, no trimesh wall rule.

Bound and design: a launch moves about 3.4 KB per env (the 24x24 contact
patch is most of it), about 6 MB at 1800 envs, which is 2 us at 3.35 TB/s;
its arithmetic is a long serial chain of 3x3 / 6x6 algebra per env, so the
launch is bounded by latency. The kernel runs one thread per env with the
whole state in registers and thread-local memory across the decimation
loop, and reads the constants through the cache (see the note at the top
of the .cu source for the next steps).

Contract: :func:`run_decimation_cuda` takes and returns what
``chain_step.run_decimation_chain`` does. Tensors on the CPU go to that
plain version; tensors on one CUDA device launch the kernel or raise;
anything else raises. There is no fallback from the card to the plain
version.

Build: at first use, ``nvcc`` compiles the source into a shared library
with a plain C interface under ``build/kernels/`` beside the package
(``-gencode arch=compute_90a,code=sm_90a``), loaded with ctypes. The same
source compiles with the host C++ compiler (:func:`run_decimation_host`),
which lets the CPU tests check the kernel's own arithmetic without a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

from legged_gym_tpu_torch.physics import chain_step

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "chain_step.cu")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# No fused multiply-add contraction: the contact law switches
# discontinuously (depth > 0, v_n < 0.05 m/s) and the regularized friction
# amplifies rounding, so FMA's other rounding flips a contact in about one
# env of 1800 on a fresh reset (vel off by 2e-2, body_f by 15 N) where the
# kernel without contraction stays within 1e-4 of the plain version
# (scripts/kernel_numerics.py on the card). Costs about 8% per launch.
CUDA_NUMERICS = ("-fmad=false",)
HOST_FLAGS = ["-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC"]

# constant-table layout, mirrored by the #defines of chain_step.cu and
# checked against the built library's chain_step_layout()
N_SCALAR = 32
JSTRIDE = 42
PSTRIDE = 11

_libs = {}
_build_lock = threading.Lock()
build_log = {}          # kind -> compiler output of the last build


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernel builds on a "
                           "machine with the CUDA toolkit")
    return found


def load_library(kind="cuda", numerics=CUDA_NUMERICS):
    """Build (at first use) and load the kernel library: 'cuda' with nvcc
    (``numerics``: the floating-point contraction flags), 'host' with the
    C++ compiler. The build goes to build/kernels/, keyed by a hash of
    source and flags."""
    key = (kind, tuple(numerics) if kind == "cuda" else ())
    with _build_lock:
        if key in _libs:
            return _libs[key]
        with open(SOURCE, "rb") as f:
            src = f.read()
        if kind == "cuda":
            cmd0, flags = [_nvcc()], NVCC_FLAGS + list(numerics)
        else:
            cmd0, flags = [shutil.which("c++") or "g++"], HOST_FLAGS
        tag = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:12]
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = os.path.join(BUILD_DIR, f"libchain_step_{kind}_{tag}.so")
        if not os.path.isfile(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run(cmd0 + flags + ["-o", tmp, SOURCE],
                                  capture_output=True, text=True)
            build_log[kind] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE} ({kind}) failed:\n"
                                   f"{build_log[kind]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        lib.chain_step_layout.argtypes = [ctypes.POINTER(ctypes.c_int),
                                          ctypes.c_int]
        lib.chain_step_layout.restype = ctypes.c_int
        lib.chain_step_run.argtypes = ([ctypes.c_void_p] * 20
                                       + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p])
        lib.chain_step_run.restype = ctypes.c_int
        _libs[key] = lib
        return lib


def library_layout(lib):
    """(L, K, NG, group sizes, n_bodies, N_CONST, N_SCALAR, JSTRIDE,
    PSTRIDE) the library was built for."""
    buf = (ctypes.c_int * 64)()
    m = lib.chain_step_layout(buf, 64)
    v = list(buf[:m])
    L, K, ng = v[0], v[1], v[2]
    sizes = tuple(v[3:3 + ng])
    nb, n_const, n_scalar, jstride, pstride = v[3 + ng:8 + ng]
    return dict(L=L, K=K, NG=ng, S=sizes, NB=nb, N_CONST=n_const,
                N_SCALAR=n_scalar, JSTRIDE=jstride, PSTRIDE=pstride)


def check_model(cc, layout):
    """Raise unless the chain model is the one the library was built for."""
    cm = cc.cm
    levels = tuple(g.level for g in cm.groups)
    sizes = tuple(g.offs.shape[0] for g in cm.groups)
    widths = tuple(g.offs.shape[1] for g in cm.groups)
    want_levels = (-1,) + tuple(range(layout["L"]))
    want_widths = (1,) + (layout["K"],) * layout["L"]
    if (cm.L, cm.K) != (layout["L"], layout["K"]) \
            or levels != want_levels or widths != want_widths \
            or sizes != layout["S"] or cm.n_bodies != layout["NB"] \
            or not all(g.active.all() for g in cm.groups) \
            or (N_SCALAR, JSTRIDE, PSTRIDE) != (
                layout["N_SCALAR"], layout["JSTRIDE"], layout["PSTRIDE"]):
        raise NotImplementedError(
            f"the chain kernel is built for L={layout['L']}, "
            f"K={layout['K']}, point groups {layout['S']} and "
            f"{layout['NB']} report bodies; this model has L={cm.L}, "
            f"K={cm.K}, groups {tuple(zip(levels, sizes, widths))} and "
            f"{cm.n_bodies} bodies")


def const_table(cc) -> np.ndarray:
    """The kernel's constant table (float32): scalars, one record per joint
    (l, k), one per contact point, in the order of chain_step.cu. Array
    values come from chain_step.const_values, so they are the plain
    version's to the bit."""
    cm = cc.cm
    cv = chain_step.const_values(cc)
    dt = cc.dt_inner
    scal = np.zeros(N_SCALAR, np.float64)
    scal[0] = dt
    scal[1:4] = cc.gravity
    scal[4] = cc.limit_stiffness
    scal[5] = cc.limit_damping
    scal[6] = cc.base_ang_cap
    scal[7] = cc.base_lin_cap
    scal[8] = cc.mu_terrain
    scal[9] = cc.slip_velocity
    scal[10] = cc.baumgarte
    scal[11] = cc.border_size
    scal[12] = cc.horizontal_scale
    scal[13] = 1.0 / cc.horizontal_scale
    scal[14] = dt * (cc.limit_damping + dt * cc.limit_stiffness)
    scal[15] = float(np.any(cm.damping != 0.0))
    scal[16] = 0.5 * dt
    scal[17] = cc.patch_S - 1.001
    parts = [scal.astype(np.float32)]
    for l in range(cm.L):
        for k in range(cm.K):
            parts.append(np.concatenate([
                cv["RjA"][l, :, :, k, 0].ravel(),
                cv["RjB"][l, :, :, k, 0].ravel(),
                cv["RjC"][l, :, :, k, 0].ravel(),
                cv["ax"][l, :, k, 0], cv["pj"][l, :, k, 0],
                [cv[name][l, k, 0] for name in (
                    "kp", "kd_eff", "effort", "implicit_d", "lower",
                    "upper", "qd_cap", "damping", "armature")],
            ]).astype(np.float32))
    for gi, g in enumerate(cm.groups):
        S, K = g.offs.shape[:2]
        for s in range(S):
            for k in range(K):
                parts.append(np.concatenate([
                    cv[f"goff{gi}"][:, s, k, 0],
                    [cv[f"{name}{gi}"][s, k, 0] for name in (
                        "grad", "gimn", "gimt", "gmet", "gvp", "gks",
                        "gact")],
                    [float(g.body[s, k])],
                ]).astype(np.float32))
    return np.concatenate(parts)


def _prepare(cc, args, lib, consts=None):
    """Validate the inputs against the kernel's contract and allocate the
    outputs; returns (inputs, outputs, consts)."""
    chain_step.check_k1(cc)
    layout = library_layout(lib)
    check_model(cc, layout)
    (lp_base, lp_lvl, mu, targets, ph, r0, c0, pos, quat, vel, q, qd) = args
    cm = cc.cm
    L, K = cm.L, cm.K
    n = pos.shape[-1]
    S = cc.patch_S
    want = [(10, n), (L, 10, K, n), (n,), (L, K, n), (S, S, n), (n,), (n,),
            (3, n), (4, n), (6, n), (L, K, n), (L, K, n)]
    names = ["lp_base", "lp_lvl", "mu", "targets", "ph", "r0", "c0", "pos",
             "quat", "vel", "q", "qd"]
    for name, t, shape in zip(names, args, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {shape}")
        dtype = torch.int32 if name in ("r0", "c0") else torch.float32
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = pos.device
    if consts is None:
        consts = torch.as_tensor(const_table(cc), device=dev)
    if tuple(consts.shape) != (layout["N_CONST"],) \
            or consts.dtype != torch.float32 or consts.device != dev:
        raise ValueError(f"constant table: {tuple(consts.shape)} "
                         f"{consts.dtype} on {consts.device}, the kernel "
                         f"expects ({layout['N_CONST']},) float32 on {dev}")
    outs = [torch.empty((3, n), device=dev),
            torch.empty((4, n), device=dev),
            torch.empty((6, n), device=dev),
            torch.empty((L, K, n), device=dev),
            torch.empty((L, K, n), device=dev),
            torch.empty((L, K, n), device=dev),
            torch.empty((3, cm.n_bodies, n), device=dev)]
    return list(args), outs, consts


def launch(lib, cc, args, consts=None):
    """Run ``lib``'s chain step on ``args`` (all on one device: the CUDA
    build on the current stream of a CUDA device, the host build on the
    CPU); validates the contract, allocates and returns the 7 outputs."""
    ins, outs, consts = _prepare(cc, args, lib, consts)
    stream = None
    dev = ins[7].device
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in ins] + [consts.data_ptr()] + \
        [t.data_ptr() for t in outs]
    err = lib.chain_step_run(*ptrs, ins[7].shape[-1], cc.patch_S,
                             cc.decimation, cc.substeps, stream)
    if err != 0:
        raise RuntimeError(f"chain_step kernel launch failed: CUDA error "
                           f"{err}")
    return tuple(outs)


def run_decimation_cuda(cc, lp_base, lp_lvl, mu, targets, ph, r0, c0,
                        pos, quat, vel, q, qd, cv=None, consts=None):
    """One policy step of physics for N envs (kernel variant K1).

    Shapes: lp_base (10,N), lp_lvl (L,10,K,N), mu (N,), targets (L,K,N),
    ph (S,S,N), r0/c0 (N,) int32, pos (3,N), quat (4,N), vel (6,N),
    q/qd (L,K,N); all float32 but r0/c0, contiguous.
    Returns (pos, quat, vel, q, qd, tau (L,K,N), body_f (3,n_bodies,N)).

    CPU tensors run the plain version (chain_step.run_decimation_chain,
    ``cv`` its cached constants); tensors on one CUDA device launch the
    kernel on the current stream (``consts``: the cached const_table() on
    that device), and each launch adds one to
    ``run_decimation_cuda.launches``.
    """
    args = (lp_base, lp_lvl, mu, targets, ph, r0, c0, pos, quat, vel, q, qd)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return chain_step.run_decimation_chain(cc, *args, cv=cv)
    if dev.type != "cuda":
        raise ValueError(f"no chain kernel for device {dev}")
    with torch.cuda.device(dev):
        out = launch(load_library("cuda"), cc, args, consts)
    run_decimation_cuda.launches += 1
    return out


run_decimation_cuda.launches = 0


def run_decimation_host(cc, *args):
    """The kernel source built with the host C++ compiler and run over CPU
    tensors: the same per-env arithmetic as the card, for tests."""
    if any(t.device.type != "cpu" for t in args):
        raise ValueError("run_decimation_host takes CPU tensors")
    return launch(load_library("host"), cc, args)
