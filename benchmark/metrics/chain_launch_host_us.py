"""Kernel layer (physics/chain_kernel.py): host us per call of the kernel
wrapper ``chain_kernel.run_decimation`` (the ``kernel.chain_step``
span: library lookup, argument binding, the launch). Split by the
end-to-end metric it moves: ``.train`` (train_steps_per_s)."""
from benchmark.metrics.env_step_host_ms import per_call


def read(bundle):
    return per_call(bundle, "kernel.chain_step", 1e6)
