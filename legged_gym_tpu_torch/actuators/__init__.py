"""Actuator networks evaluated between physics launches."""
from legged_gym_tpu_torch.actuators.sea_lstm import SEANet

__all__ = ["SEANet"]
