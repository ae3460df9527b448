"""Scaling benchmark: go1 rollout throughput with the env axis split over
1, 2, 4, ... ranks (the JAX package's scripts/bench_scaling.py).

    python -m legged_gym_tpu_torch.scripts.bench_scaling --num_envs 1024 \\
        --ranks 1,2 [--device cpu]

Each world size runs in its own spawned process group
(parallel.run_ranks): every rank builds go1 with its share of
``num_envs``, steps it with random normal actions once (warm) and then
``steps`` times under the clock, synced at the end. One JSON line per
world size: the global env-steps/s (num_envs x steps over the slowest
rank's time) and, where the ranks have a card each, ``efficiency``
(rate / (ranks x the first size's per-rank rate)). Where they share a
device (CPU ranks, or more ranks than cards) more ranks cannot add
compute, and the line gives
``sharding_speedup_vs_unsharded`` instead: the rate over the first size's,
which says what the split's collectives and layout cost. Runs on the card
unless ``--device cpu``; the backend is NCCL when each rank has a card of
its own, else gloo.
"""
import argparse
import json
import time

import torch

from legged_gym_tpu_torch.parallel import run_ranks


def rank_rate(mesh, num_envs, steps):
    """One rank's part: go1 at its share of ``num_envs``, one warm step
    call, then ``steps`` steps timed. Returns the seconds."""
    from legged_gym_tpu_torch import registry

    cfg, _ = registry.get_cfgs("go1")
    cfg.env.num_envs = num_envs
    env, _ = registry.make_env(cfg=cfg, mesh=mesh)
    gen = torch.Generator(device=env.device).manual_seed(1 + mesh.rank)
    cuda = env.device.type == "cuda"

    def roll(state, n):
        for _ in range(n):
            a = torch.randn((env.num_envs, env.num_actions), generator=gen,
                            device=env.device)
            state, tr = env.step(state, a)
        float(tr.reward.mean())              # the read syncs
        return state

    with torch.no_grad():
        state = roll(env.initial_state(), 1)
        if cuda:
            torch.cuda.synchronize(env.device)
        t0 = time.perf_counter()
        roll(state, steps)
        if cuda:
            torch.cuda.synchronize(env.device)
        return time.perf_counter() - t0


def backend_for(device, ranks):
    """NCCL when each rank has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" \
            and ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def run(num_envs, ranks_list=(1, 2), steps=20, device="cuda",
        timeout_s=600.0):
    """The sweep: one process group per world size of ``ranks_list``.
    Returns {ranks: result dict}, each also printed as a JSON line."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("bench_scaling: no card (--device cpu runs on "
                           "the CPU)")
    results = {}
    base = None
    for nr in ranks_list:
        backend = backend_for(device, nr)
        secs = run_ranks(rank_rate, nr, backend=backend, device=device,
                         timeout_s=timeout_s, args=(num_envs, steps))
        rate = num_envs * steps / max(secs)
        if base is None:
            base = rate / nr
        res = {"env_steps_per_s": rate, "backend": backend,
               "device": torch.cuda.get_device_name(0) if cuda else "cpu"}
        if not cuda or nr > torch.cuda.device_count():
            res["sharding_speedup_vs_unsharded"] = rate / (
                base * ranks_list[0])
        else:
            res["efficiency"] = rate / (nr * base)
        results[nr] = res
        print(json.dumps({"ranks": nr, "num_envs": num_envs, **res}),
              flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser("bench_scaling")
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--ranks", type=str, default="1,2",
                   help="comma-separated world sizes")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (rank r on card r modulo the cards) or cpu")
    a = p.parse_args(argv)
    run(a.num_envs, [int(r) for r in a.ranks.split(",")], a.steps,
        a.device)


if __name__ == "__main__":
    main()
