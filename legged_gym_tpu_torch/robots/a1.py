"""Unitree A1 variants (reference a1_config.py:33-96,
a1_src_config.py:34-98)."""
from legged_gym_tpu_torch.config import LeggedRobotCfg, TrainCfg

_A1_JOINT_ANGLES = {
    "FL_hip_joint": 0.1, "RL_hip_joint": 0.1,
    "FR_hip_joint": -0.1, "RR_hip_joint": -0.1,
    "FL_thigh_joint": 0.8, "RL_thigh_joint": 1.0,
    "FR_thigh_joint": 0.8, "RR_thigh_joint": 1.0,
    "FL_calf_joint": -1.5, "RL_calf_joint": -1.5,
    "FR_calf_joint": -1.5, "RR_calf_joint": -1.5,
}


def _a1_base():
    cfg = LeggedRobotCfg()
    cfg.init_state.pos = [0.0, 0.0, 0.42]
    cfg.init_state.default_joint_angles = dict(_A1_JOINT_ANGLES)

    cfg.control.control_type = "P"
    cfg.control.stiffness = {"joint": 40.0}
    cfg.control.damping = {"joint": 1.0}
    cfg.control.action_scale = 0.25

    cfg.asset.foot_name = "foot"
    cfg.asset.penalize_contacts_on = ["thigh", "calf"]
    cfg.asset.terminate_after_contacts_on = ["base"]
    cfg.asset.self_collisions = 1

    cfg.rewards.soft_dof_pos_limit = 0.9
    cfg.rewards.base_height_target = 0.25
    cfg.rewards.scales["dof_pos_limits"] = -10.0
    return cfg


def a1():
    cfg = _a1_base()
    cfg.asset.file = "{ASSETS}/robots/a1/urdf/a1.urdf"
    cfg.asset.name = "a1"
    cfg.rewards.scales["torques"] = -0.0002
    train = TrainCfg()
    train.runner.experiment_name = "rough_a1"
    return cfg, train


def a1_src():
    cfg = _a1_base()
    cfg.asset.file = "{ASSETS}/robots/a1_src/urdf/a1.urdf"
    cfg.asset.name = "a1_src"
    cfg.rewards.scales["torques"] = -0.00001
    train = TrainCfg()
    train.runner.experiment_name = "rough_a1_src"
    return cfg, train
