"""Per-robot config factories. Each returns ``(LeggedRobotCfg, TrainCfg)``
freshly built, so a caller may mutate the result freely."""
from legged_gym_tpu_torch.robots.aliengo import aliengo
from legged_gym_tpu_torch.robots.go1 import go1

__all__ = ["aliengo", "go1"]
