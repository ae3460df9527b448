"""legged_gym_tpu_torch: the PyTorch / CUDA port of the JAX package
(legged_gym_tpu/).

Same module names and batch-last layout as the JAX package; the fused
physics step runs as a hand-written CUDA kernel on the card
(physics/chain_kernel.py) and as its plain PyTorch version on the CPU.
Imports torch and numpy only.
"""


def set_full_fp32():
    """Keep float32 matrix products and convolutions in full float32 on the
    card (TF32 off), as the parity tests assume."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
