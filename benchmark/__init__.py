"""The benchmark of the PyTorch / CUDA port (legged_gym_tpu_torch).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json once on the card and prints one JSON
result line. Everything a cell needs is data found by name: the
configuration (configs/<config>.json), the traffic mix
(mixes/<traffic>.json, read by the module of its ``kind`` in kinds/), the
limits of its correctness check (limits/<cell>.json), the kernel's frozen
work (work/<name>.json) and one reader per per-layer metric
(metrics/<metric>.py). The plain reference (reference/) is a frozen copy
of the port's plain path; nothing here imports JAX or the JAX package.
"""
