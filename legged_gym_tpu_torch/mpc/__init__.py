from legged_gym_tpu_torch.mpc.sampling import (GradientMPC, MPCConfig,
                                               SamplingMPC)

__all__ = ["MPCConfig", "SamplingMPC", "GradientMPC"]
