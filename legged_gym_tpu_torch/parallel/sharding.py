"""Multi-device scaling: the env axis split over ranks of a
``torch.distributed`` process group.

The port of the JAX package's ``parallel/sharding.py``. There the env axis
is a mesh axis and XLA's partitioner inserts the collectives; here each
rank is one process that simulates a contiguous range of the global envs
(``EnvMesh.env_slice``), and the code that needs a global value asks for
it (``EnvMesh.all_sum``, ``EnvMesh.gather_envs``):
- the env computes its host-side layout (origins, terrain types) and takes
  every random draw at the global env count, then keeps its range, so a
  rank's envs get the numbers the unsharded env gives them; the episode
  statistics and the command curriculum's decision are summed over ranks;
- PPO draws its action noise and its minibatch permutation globally, sums
  the loss terms and the gradients over ranks, and keeps the parameters,
  the Adam moments and the learning rate replicated;
- the planners roll out K / world candidates per rank and gather the
  (K,) cost vector.

Collectives are ``all_reduce(SUM)`` and ``broadcast`` only: gloo carries
both on CUDA tensors (through the host), NCCL on distinct cards. A gather
is the all-reduce of a zero-filled global buffer in which each rank has
written its own slice; adding zeros is exact, so the gather is bitwise.
Batch-last tensors (physics and env state) hold the env axis last,
batch-first tensors (observations, actions) first.

The reference's only parallelism is the env batch on one GPU (its
``--horovod`` flag is dead code, helpers.py:162).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """A 1-D split of the env axis over the ranks of the default process
    group: this process's rank, the world size and the device this rank
    simulates on."""
    rank: int
    world_size: int
    device: torch.device

    def local_count(self, num_envs):
        """The envs each rank holds; raises unless ``num_envs`` divides by
        the world size (torch has no uneven shards)."""
        if num_envs % self.world_size:
            raise ValueError(f"{num_envs} envs do not divide over "
                             f"{self.world_size} ranks")
        return num_envs // self.world_size

    def env_slice(self, num_envs):
        """This rank's contiguous range of the ``num_envs`` global envs."""
        n = self.local_count(num_envs)
        return slice(self.rank * n, (self.rank + 1) * n)

    def all_sum(self, x):
        """The sum of ``x`` over the ranks, as a new tensor (every rank
        gets the same bits)."""
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def gather_envs(self, x, num_envs):
        """This rank's share of an env axis (the last of ``x``) placed
        into the global axis of ``num_envs``: every rank gets the whole."""
        full = torch.zeros(x.shape[:-1] + (num_envs,), dtype=x.dtype,
                           device=x.device)
        full[..., self.env_slice(num_envs)] = x.detach()
        dist.all_reduce(full, op=dist.ReduceOp.SUM)
        return full

    def broadcast_(self, x):
        """``x`` (in place) to rank 0's value on every rank."""
        dist.broadcast(x, src=0)
        return x


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, backend="nccl"):
    """Join a multi-process run with ``torch.distributed`` (the live
    replacement of the reference's dead ``--horovod`` flag). With no
    arguments the rendezvous comes from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); across nodes without
    torchrun pass all three: ``coordinator_address`` host:port of rank 0,
    the process count and this process's rank. ``backend``: "nccl" (one
    card per rank) or "gloo" (CPU ranks, or several ranks on one card).
    Returns (rank, world size)."""
    given = [a is not None for a in (coordinator_address, num_processes,
                                     process_id)]
    if any(given) and not all(given):
        raise ValueError("init_multihost: pass coordinator_address, "
                         "num_processes and process_id together, or none "
                         "of them (torchrun's environment)")
    if all(given):
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    else:
        dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def env_mesh(device=None):
    """The 1-D env split over the initialized (default) process group.
    ``device``: this rank's device; None or "cuda" takes
    ``cuda:<local rank>`` (torchrun's LOCAL_RANK, else the rank modulo the
    card count) and makes it the current card; "cpu" asks for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError(
            "env_mesh needs a torch.distributed process group: launch with "
            "torchrun (python -m torch.distributed.run --nproc_per_node=<n> "
            "...) or call init_multihost() first")
    rank = dist.get_rank()
    world = dist.get_world_size()
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    return EnvMesh(rank=rank, world_size=world, device=device)


def all_sum(x, mesh):
    """The sum of ``x`` over the ranks of ``mesh``; ``x`` itself without a
    mesh (one process holds every env)."""
    return x if mesh is None else mesh.all_sum(x)


def _tree_map(fn, x):
    """``fn`` on every tensor of a tree of dataclasses, dicts, lists and
    tuples; other leaves unchanged."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def _cut(x, sl, dim):
    index = [slice(None)] * x.dim()
    index[dim] = sl
    return x[tuple(index)].clone(memory_format=torch.contiguous_format)


def shard_env_state(state, mesh, num_envs):
    """This rank's part of a GLOBAL batch-last state (an EnvState, a
    PhysicsState or any tree of them): tensors whose last axis is the env
    axis (``num_envs`` long) are cut to the rank's range, everything else
    is kept (the JAX package's ``_spec_for`` rule). Without a mesh the
    state itself."""
    if mesh is None:
        return state
    sl = mesh.env_slice(num_envs)

    def cut(x):
        if x.dim() and x.shape[-1] == num_envs:
            return _cut(x, sl, -1)
        return x
    return _tree_map(cut, state)


def shard_batch(x, mesh):
    """This rank's rows of GLOBAL batch-first tensors (observations,
    actions): the first axis of every tensor of the tree is cut to the
    rank's range. Without a mesh ``x`` itself."""
    if mesh is None:
        return x

    def cut(a):
        if not a.dim():
            return a
        return _cut(a, mesh.env_slice(a.shape[0]), 0)
    return _tree_map(cut, x)


def replicate(x, mesh):
    """Rank 0's values on every rank, in place: every tensor of a tree, or
    the parameters and buffers of an ``nn.Module``. Returns ``x``."""
    tensors = ([t.data for t in list(x.parameters()) + list(x.buffers())]
               if isinstance(x, torch.nn.Module) else x)
    _tree_map(mesh.broadcast_, tensors)
    return x


# --------------------------------------------------------------- spawning

def _rank_main(fn, args, rank, world_size, backend, device, init_file,
               results):
    """One spawned rank: join the group, build the mesh, run ``fn(mesh,
    *args)`` and send back ("ok", rank, pickled result) or ("error", rank,
    traceback); the group is torn down in every case."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world_size)
        try:
            dev = torch.device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            out = fn(env_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        results.put(("ok", rank, pickle.dumps(out)))
    except Exception:             # noqa: BLE001 -- reported to the parent
        results.put(("error", rank, traceback.format_exc()))
        sys.exit(1)


def run_ranks(fn, world_size, backend, device="cuda", timeout_s=60.0,
              args=()):
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned ranks of one
    process group and return the ranks' results in rank order.

    ``fn`` must be importable by its module path (the spawned children
    import its module afresh, so that module should not import JAX) and
    return picklable data (tensors on the CPU). ``backend``: "gloo" or
    "nccl", always given. ``device``: each rank's, "cuda" (the card rank %
    count; the default), "cuda:k" or "cpu". The rendezvous is a file in
    a temporary directory. Each rank runs with one torch thread. Raises RuntimeError with the rank's
    traceback when a rank fails (with the other ranks' reports of the
    next few seconds: a rank waiting in a collective then fails too; the
    rest are stopped), and TimeoutError when the ranks have not all
    finished within ``timeout_s``."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="lgt_ranks_")
    procs = []
    try:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, args, r, world_size, backend, device, init_file, results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        out, errors = {}, {}
        while len(out) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if errors:
                left = min(left, grace_end - time.monotonic())
            if left <= 0:
                break
            try:
                status, rank, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in out and r not in errors \
                            and p.exitcode not in (None, 0):
                        errors[r] = f"exited with code {p.exitcode} and " \
                                    f"no report"
                        grace_end = time.monotonic() + 5.0
                continue
            if status == "error":
                errors[rank] = payload
                grace_end = time.monotonic() + 5.0
            else:
                out[rank] = pickle.loads(payload)
        if errors:
            raise RuntimeError("run_ranks: " + "\n".join(
                f"rank {r} of {world_size} failed:\n{errors[r]}"
                for r in sorted(errors)))
        if len(out) < world_size:
            raise TimeoutError(
                f"run_ranks: {world_size - len(out)} of {world_size} "
                f"ranks did not finish within {timeout_s} s")
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
