"""Actuator networks evaluated between physics steps."""
from legged_gym_tpu_torch.actuators.sea_lstm import SEANet
from legged_gym_tpu_torch.actuators.uninet import UniNet

__all__ = ["SEANet", "UniNet"]
