"""The fused physics step as a hand-written CUDA kernel (csrc/chain_step.cu).

Replaces the TPU kernel ``legged_gym_tpu/physics/pallas_step.py::
run_decimation_pallas`` (its body is ``chain_step.one_sim_dt``) in all
four of its configurations, behind one wrapper, :func:`run_decimation`,
that keeps a launch count per variant (``launches``, keyed by
``chain_step.variant``):

- K1: position drive, contact plane sampled once per policy step, no
  friction anchors, no trimesh wall rule (go1, a1);
- K4: K1 with warm-start friction anchors, one (3,) anchor per contact
  point carried in and out (aliengo);
- K2: the plane re-sampled at the first substep of every sim dt and / or
  the trimesh wall rule (cassie), with or without anchors;
- K3: ``targets`` is a held torque clipped to the effort limits (the SEA
  drive of anymal, one launch per sim dt), with or without anchors, the
  wall rule and per-sim-dt planes.

Bound and design: a launch must move about 2.6 KB per env on go1 (1.1 KB
of state, link parameters and outputs, and of the 24x24 contact patch the
four corners of each of the 92 contact points' query cells), about 4.7 MB
at 1800 envs, which is 1.4 us at 3.35 TB/s; its arithmetic is a long
chain of dependent 3x3 / 6x6 algebra per env, so the launch is bounded by
latency. A group of G lanes of a warp runs one env (``-DG_LANES``, per
launch the larger of 16 and 8 whose warps the card holds at once:
:func:`launch_library`): one lane per chain for FK and the ABA
passes, the contact points spread over the group with each point's plane
and (K4) anchor in its owner lane's registers for the whole launch, the
exchanges through a per-env record in shared memory, every sum in a fixed
order (the note at the top of the .cu source gives the details).

The model's shape (levels, chains, point-group sizes, report bodies) is
compiled in (``-D`` defines): one library per layout, built at first use
and picked by the model (:func:`model_layout`).

Contract: the wrapper takes and returns what
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
from legged_gym_tpu_torch.utils import profiling

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
MAX_LVL = 8

# (L, K, S_BASE, (S_0 .. S_{L-1}), n_bodies) of the source's defaults
GO1_LAYOUT = (3, 4, 8, (4, 8, 9), 17)
# lanes per env (G_LANES) a launch on the card may take, largest first: it
# takes the largest whose warps the card holds at once (one wave), else the
# last (pick_lanes). On the H100 an SM holds 8-16 warps of this kernel; the
# sweep of PERF.md §6 (scripts/kernel_numerics.py --sweep) found G 16
# fastest where its warps fit one wave (go1 and cassie at 1800 envs) and
# G 8 where they do not (4096 envs, 2,048 warps at G 16), but for anymal
# at 4096, where both fit and 8 is 2% faster; G 32, and 2 or 4 for
# cassie, lost everywhere. Any power of two from K to 32 builds.
LANE_CHOICES = (16, 8)
# the lanes of a library loaded without a choice, as the host build is:
# its arithmetic, and so its results, do not depend on G
DEFAULT_LANES = LANE_CHOICES[-1]
# flags of chain_step_run, mirrored by the #defines of chain_step.cu
FLAG_WARM, FLAG_TORQUE, FLAG_PLANE_PER_DT = 1, 2, 4

_libs = {}
# (layout, n, anchored, device index) -> the library launch_library picked
_launch_libs = {}
# per-launch lookups, kept off the hot path: id(chain model) -> (model,
# layout), id(library) -> its layout dict
_model_layouts = {}
_lib_layouts = {}
_build_lock = threading.Lock()
# compiler output of each build made by this process, by library_key(...)
build_log = {}


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


def _group_shape(cm):
    """(levels, slots, widths) of the chain model's point groups."""
    return (tuple(g.level for g in cm.groups),
            tuple(g.offs.shape[0] for g in cm.groups),
            tuple(g.offs.shape[1] for g in cm.groups))


def model_layout(cm):
    """(L, K, S_BASE, (S_0 .. S_{L-1}), n_bodies) of a chain model: the -D
    defines its library is built with. A level (or the base) without
    contact points has size 0. Raises NotImplementedError for a model the
    source cannot be built for: a chain shorter than L, a point group that
    is not one slot row per chain, or a padded (inactive) point slot."""
    hit = _model_layouts.get(id(cm))
    if hit is not None and hit[0] is cm:
        return hit[1]
    levels, slots, widths = _group_shape(cm)
    ok = (bool(np.all(cm.active))
          and list(levels) == sorted(set(levels))
          and all(-1 <= lv < cm.L for lv in levels)
          and all(w == (1 if lv < 0 else cm.K)
                  for lv, w in zip(levels, widths))
          and all(bool(g.active.all()) for g in cm.groups))
    if not ok:
        raise NotImplementedError(
            f"the chain kernel is written for K chains of L joints each "
            f"and point groups filled on every chain; this model has "
            f"L={cm.L}, K={cm.K}, joints active {cm.active.tolist()} and "
            f"groups (level, slots, width) "
            f"{tuple(zip(levels, slots, widths))}")
    size = dict(zip(levels, slots))
    layout = (int(cm.L), int(cm.K), size.get(-1, 0),
              tuple(size.get(lv, 0) for lv in range(cm.L)), int(cm.n_bodies))
    _model_layouts[id(cm)] = (cm, layout)
    return layout


def pick_lanes(fits):
    """The lanes per env of a launch: the first of ``fits`` (G -> (warps
    the launch starts, warps of it the card holds at once), largest G
    first) whose launch fits one wave, else the last."""
    for g, (need, held) in fits.items():
        if need <= held:
            return g
    return g


def library_key(kind, numerics, layout, lanes=DEFAULT_LANES, source=SOURCE):
    """The key of one library in ``_libs`` and ``build_log``."""
    L, K, s_base, s_lvls, nb = layout
    return (kind, tuple(numerics) if kind == "cuda" else (),
            (L, K, s_base, tuple(s_lvls), nb), lanes, source)


def _build_spec(kind, numerics, layout, lanes, source):
    """(command without the output, output path) of one library."""
    L, K, s_base, s_lvls, nb = layout
    if len(s_lvls) != L:
        raise ValueError(f"layout {layout}: {len(s_lvls)} level sizes for "
                         f"L={L}")
    if L > MAX_LVL:
        raise NotImplementedError(f"the chain kernel takes at most "
                                  f"{MAX_LVL} levels, this model has {L}")
    # one define per level (nvcc splits a -D value at its commas); levels
    # the model does not have are 0
    sizes = tuple(s_lvls) + (0,) * (MAX_LVL - L)
    defines = [f"-DL_LVL={L}", f"-DK_CH={K}", f"-DS_BASE={s_base}"] \
        + [f"-DS_L{l}={v}" for l, v in enumerate(sizes)] \
        + [f"-DNB={nb}", f"-DG_LANES={lanes}"]
    if kind == "cuda":
        cmd0, flags = [_nvcc()], NVCC_FLAGS + list(numerics) + defines
    else:
        cmd0, flags = [shutil.which("c++") or "g++"], HOST_FLAGS + defines
    with open(source, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libchain_step_{kind}_{tag}.so")
    return cmd0 + flags, out


def _finish_build(key, proc_out, returncode, tmp, out):
    kind, _, _, lanes, source = key
    build_log[key] = proc_out
    if returncode != 0:
        raise RuntimeError(f"building {source} ({kind}, G_LANES={lanes}) "
                           f"failed:\n{proc_out}")
    os.replace(tmp, out)


def _bind(out):
    lib = ctypes.CDLL(out)
    lib.chain_step_layout.argtypes = [ctypes.POINTER(ctypes.c_int),
                                      ctypes.c_int]
    lib.chain_step_layout.restype = ctypes.c_int
    lib.chain_step_run.argtypes = ([ctypes.c_void_p] * 22
                                   + [ctypes.c_int] * 5
                                   + [ctypes.c_void_p])
    lib.chain_step_run.restype = ctypes.c_int
    if hasattr(lib, "chain_step_fit"):      # not in sources before it
        lib.chain_step_fit.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.chain_step_fit.restype = ctypes.c_int
    return lib


def load_library(kind="cuda", numerics=CUDA_NUMERICS, layout=GO1_LAYOUT,
                 lanes=DEFAULT_LANES, source=SOURCE):
    """Build (at first use) and load the kernel library for one model
    layout (``model_layout``): 'cuda' with nvcc (``numerics``: the
    floating-point contraction flags), 'host' with the C++ compiler;
    ``lanes``: G_LANES (a launch on the card takes launch_library's
    choice); ``source``: the .cu file (another revision of it, to time two
    designs in one run). The build goes to build/kernels/, keyed by a hash
    of source and flags."""
    key = library_key(kind, numerics, layout, lanes, source)
    lib = _libs.get(key)        # the hot path: one dict lookup per launch
    if lib is not None:
        return lib
    return build_libraries([layout], kind, numerics, [lanes], source)[0]


def build_libraries(layouts, kind="cuda", numerics=CUDA_NUMERICS,
                    lanes=None, source=SOURCE):
    """Build the libraries of several layouts at once, one compiler
    process each, all started together; returns the loaded libraries in
    the order of ``layouts``. ``lanes``: G_LANES per layout (default
    DEFAULT_LANES); ``source``: one .cu path, or one per layout.
    ``build_log[library_key(...)]`` keeps the compiler's output of each
    build."""
    if lanes is None:
        lanes = [DEFAULT_LANES] * len(layouts)
    sources = [source] * len(layouts) if isinstance(source, str) else source
    keys = [library_key(kind, numerics, layout, g, src)
            for layout, g, src in zip(layouts, lanes, sources)]
    with _build_lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        running = {}
        for key in keys:
            layout, g, source = key[2:]
            cmd, out = _build_spec(kind, numerics, layout, g, source)
            if key in _libs or key in running or os.path.isfile(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            running[key] = (tmp, out, subprocess.Popen(
                cmd + ["-o", tmp, source], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for key, (tmp, out, proc) in running.items():
            text, _ = proc.communicate()
            _finish_build(key, text, proc.returncode, tmp, out)
        for key in keys:
            if key not in _libs:
                _libs[key] = _bind(_build_spec(kind, numerics, *key[2:])[1])
    return [_libs[key] for key in keys]


def library_fit(lib, n, anchored):
    """(warps a launch of ``lib`` for n envs starts, warps of it the
    current device holds at once; 0 in the host build)."""
    out = (ctypes.c_int * 2)()
    err = lib.chain_step_fit(n, FLAG_WARM * bool(anchored), out)
    if err != 0:
        raise RuntimeError(f"chain_step occupancy query failed: CUDA error "
                           f"{err}")
    return out[0], out[1]


def launch_library(layout, n, anchored):
    """The card's library for a launch of n envs of ``layout`` (with or
    without anchors) on the current device: of the builds for LANE_CHOICES
    (made at first use, in parallel), the one pick_lanes takes by
    library_fit. Cached per (layout, n, anchored, device)."""
    key = (layout, n, bool(anchored), torch.cuda.current_device())
    lib = _launch_libs.get(key)     # the hot path: one dict lookup a launch
    if lib is None:
        choices = [g for g in LANE_CHOICES if g >= layout[1]]
        libs = build_libraries([layout] * len(choices), lanes=choices)
        fits = {g: library_fit(lb, n, anchored)
                for g, lb in zip(choices, libs)}
        lib = libs[choices.index(pick_lanes(fits))]
        _launch_libs[key] = lib
    return lib


def library_layout(lib):
    """(L, K, NG, group sizes, n_bodies, N_CONST, N_SCALAR, JSTRIDE,
    PSTRIDE, NPTS, G_LANES, bytes of shared memory per env) the library
    was built for (a source of one thread per env reports G_LANES 1)."""
    hit = _lib_layouts.get(id(lib))
    if hit is not None and hit[0] is lib:
        return hit[1]
    buf = (ctypes.c_int * 64)()
    m = lib.chain_step_layout(buf, 64)
    v = list(buf[:m])
    L, K, ng = v[0], v[1], v[2]
    sizes = tuple(v[3:3 + ng])
    nb, n_const, n_scalar, jstride, pstride, npts = v[3 + ng:9 + ng]
    lanes, env_bytes = v[9 + ng:11 + ng] if m >= 11 + ng else (1, 0)
    layout = dict(L=L, K=K, NG=ng, S=sizes, NB=nb, N_CONST=n_const,
                  N_SCALAR=n_scalar, JSTRIDE=jstride, PSTRIDE=pstride,
                  NPTS=npts, G_LANES=lanes, SHARED_PER_ENV=env_bytes)
    _lib_layouts[id(lib)] = (lib, layout)
    return layout


def check_model(cc, layout):
    """Raise unless the chain model is the one the library was built for
    (``layout``: library_layout())."""
    cm = cc.cm
    levels, slots, widths = _group_shape(cm)
    try:
        L, K, s_base, s_lvls, nb = model_layout(cm)
        same = ((L, K, nb) == (layout["L"], layout["K"], layout["NB"])
                and (s_base,) + s_lvls == tuple(layout["S"]))
    except NotImplementedError:
        same = False
    if not same or (N_SCALAR, JSTRIDE, PSTRIDE) != (
            layout["N_SCALAR"], layout["JSTRIDE"], layout["PSTRIDE"]):
        raise NotImplementedError(
            f"the chain kernel is built for L={layout['L']}, "
            f"K={layout['K']}, point groups {layout['S']} and "
            f"{layout['NB']} report bodies; this model has L={cm.L}, "
            f"K={cm.K}, groups {tuple(zip(levels, slots, widths))} and "
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
    scal[18] = cc.anchor_beta
    scal[19] = cc.anchor_vmax
    scal[20] = cc.anchor_stale2
    scal[21] = cc.anchor_release_depth
    scal[22] = cc.wall_thresh
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


def _prepare(cc, args, lib, consts=None, anchors=None):
    """Validate the inputs against the kernel's contract and allocate the
    outputs; returns (inputs, outputs, consts, anchors out or None)."""
    chain_step.check_variant(cc)
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
    checked = list(zip(names, args, want))
    if anchors is not None:
        if not cc.warm_start:
            raise ValueError("anchors given but cc.warm_start is off")
        checked.append(("anchors", anchors, (3, layout["NPTS"], n)))
    for name, t, shape in checked:
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
    anchors_out = None if anchors is None else torch.empty_like(anchors)
    return list(args), outs, consts, anchors_out


def bind_launch(lib, cc, args, consts=None, anchors=None):
    """Validate the contract and allocate the outputs of one launch of
    ``lib``'s chain step on ``args``; returns (go, outputs): go() launches
    the kernel on those buffers (again on each call, raising if a launch
    fails), so a timing loop can leave out the checks and allocations."""
    ins, outs, consts, anchors_out = _prepare(cc, args, lib, consts, anchors)
    stream = None
    dev = ins[7].device
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev).cuda_stream
    warm = anchors is not None
    flags = (FLAG_WARM * warm + FLAG_TORQUE * bool(cc.torque_mode)
             + FLAG_PLANE_PER_DT * (not cc.plane_per_step))
    ptrs = [t.data_ptr() for t in ins] + [consts.data_ptr()] + \
        [t.data_ptr() for t in outs] + \
        [anchors.data_ptr() if warm else None,
         anchors_out.data_ptr() if warm else None]
    tail = (ins[7].shape[-1], cc.patch_S, cc.decimation, cc.substeps, flags,
            stream)

    def go():
        err = lib.chain_step_run(*ptrs, *tail)
        if err != 0:
            raise RuntimeError(f"chain_step kernel launch failed: CUDA "
                               f"error {err}")

    # the tensors behind ptrs live as long as go
    go.buffers = (ins, outs, consts, anchors, anchors_out)

    return go, tuple(outs) + ((anchors_out,) if warm else ())


def launch(lib, cc, args, consts=None, anchors=None):
    """Run ``lib``'s chain step on ``args`` (all on one device: the CUDA
    build on the current stream of a CUDA device, the host build on the
    CPU) in the configuration ``cc`` selects; validates the contract,
    allocates and returns the 7 outputs, and the new anchors (a buffer of
    their own, never the input's) as an 8th when ``anchors`` is given."""
    go, outs = bind_launch(lib, cc, args, consts, anchors)
    go()
    return outs


def _one_device(tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devices))}")
    return devices.pop()


# kernel launches that ran, per variant ("K1", "K4", "K2", "K3":
# chain_step.variant): run_decimation adds one where it launches the kernel;
# where a CUDA graph captures the stream the launch only records, and
# run_decimation adds it to ``recorded`` instead: whoever replays such a
# graph adds what its capture recorded to ``launches`` (count_replay)
launches = {"K1": 0, "K4": 0, "K2": 0, "K3": 0}
recorded = {"K1": 0, "K4": 0, "K2": 0, "K3": 0}


def count_replay(tally):
    """Count the launches of one replay of a graph whose capture recorded
    ``tally`` ({variant: launches}, the growth of ``recorded`` over the
    capture)."""
    for variant, n in tally.items():
        launches[variant] += n


def run_decimation(cc, lp_base, lp_lvl, mu, targets, ph, r0, c0, pos, quat,
                   vel, q, qd, anchors=None, cv=None, consts=None):
    """One policy step of physics for N envs (``cc.decimation`` sim dts of
    ``cc.substeps`` substeps) in the configuration ``cc`` selects.

    Shapes: lp_base (10,N), lp_lvl (L,10,K,N), mu (N,), targets (L,K,N),
    ph (S,S,N), r0/c0 (N,) int32, pos (3,N), quat (4,N), vel (6,N),
    q/qd (L,K,N); all float32 but r0/c0, contiguous. ``targets`` is a joint
    position, or with ``cc.torque_mode`` a held torque that is clipped to
    the effort limits (the SEA path calls with decimation 1, once per sim
    dt, the actuator net in between). ``anchors`` (needs ``cc.warm_start``):
    (3, n_points, N) float32 contiguous, packed in the kernel's point order
    (chain_step.split_anchors gives the per-group views).
    Returns (pos, quat, vel, q, qd, tau (L,K,N), body_f (3,n_bodies,N)) and,
    with ``anchors``, the new anchors (3, n_points, N) as an 8th.

    CPU tensors run the plain version (chain_step.run_decimation_chain,
    ``cv`` its cached constants); tensors on one CUDA device launch the
    kernel on the current stream (``consts``: the cached const_table() on
    that device), and each launch adds one to
    ``launches[chain_step.variant(cc, anchored)]``, or to ``recorded``
    where a CUDA graph captures the stream: that launch only records, and
    each replay of the graph counts it (``count_replay``). The call, checks
    aside, is the span ``kernel.chain_step`` (utils/profiling.py).
    """
    if anchors is not None and not cc.warm_start:
        raise ValueError("anchors given but cc.warm_start is off")
    with profiling.span("kernel.chain_step"):
        args = (lp_base, lp_lvl, mu, targets, ph, r0, c0, pos, quat, vel, q,
                qd)
        dev = _one_device(args if anchors is None else args + (anchors,))
        if dev.type == "cpu":
            return chain_step.run_decimation_chain(cc, *args, cv=cv,
                                                   anchors=anchors)
        if dev.type != "cuda":
            raise ValueError(f"no chain kernel for device {dev}")
        with torch.cuda.device(dev):
            lib = launch_library(model_layout(cc.cm), pos.shape[-1],
                                 anchors is not None)
            out = launch(lib, cc, args, consts, anchors)
            tally = (recorded if torch.cuda.is_current_stream_capturing()
                     else launches)
            tally[chain_step.variant(cc, anchored=anchors is not None)] += 1
        return out


def run_decimation_host(cc, *args, anchors=None, lanes=DEFAULT_LANES):
    """The kernel source built with the host C++ compiler and run over CPU
    tensors: the same per-env arithmetic, in the same order, as the card,
    for tests, in the configuration ``cc`` selects; ``lanes``: G_LANES.
    With ``anchors`` it returns the new anchors as an 8th output."""
    tensors = args if anchors is None else args + (anchors,)
    if any(t.device.type != "cpu" for t in tensors):
        raise ValueError("run_decimation_host takes CPU tensors")
    lib = load_library("host", layout=model_layout(cc.cm), lanes=lanes)
    return launch(lib, cc, args, anchors=anchors)
