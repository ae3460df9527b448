"""Per-robot config factories. Each returns ``(LeggedRobotCfg, TrainCfg)``
freshly built, so a caller may mutate the result freely."""
from legged_gym_tpu_torch.robots.a1 import a1, a1_src
from legged_gym_tpu_torch.robots.aliengo import aliengo
from legged_gym_tpu_torch.robots.anymal import (anymal_b, anymal_c_flat,
                                                anymal_c_rough)
from legged_gym_tpu_torch.robots.cassie import cassie
from legged_gym_tpu_torch.robots.go1 import go1

__all__ = ["a1", "a1_src", "aliengo", "anymal_b", "anymal_c_flat",
           "anymal_c_rough", "cassie", "go1"]
