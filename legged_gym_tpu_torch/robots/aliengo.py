"""Unitree Aliengo (reference aliengo_config.py:34-114)."""
from legged_gym_tpu_torch.config import LeggedRobotCfg, TrainCfg


def aliengo():
    cfg = LeggedRobotCfg()
    cfg.env.num_observations = 48

    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False

    cfg.init_state.pos = [0.0, 0.0, 0.32]
    cfg.init_state.default_joint_angles = {
        "FL_hip_joint": 0.0, "RL_hip_joint": 0.0,
        "FR_hip_joint": -0.1, "RR_hip_joint": -0.1,
        "FL_thigh_joint": 0.6, "RL_thigh_joint": 0.8,
        "FR_thigh_joint": 0.6, "RR_thigh_joint": 0.8,
        "FL_calf_joint": -0.7, "RL_calf_joint": -0.7,
        "FR_calf_joint": -0.7, "RR_calf_joint": -0.7,
    }

    cfg.control.control_type = "P"
    cfg.control.stiffness = {"hip_joint": 30.0, "thigh_joint": 50.0,
                             "calf_joint": 50.0}
    cfg.control.damping = {"hip_joint": 2.0, "thigh_joint": 2.0,
                           "calf_joint": 2.0}
    cfg.control.action_scale = 0.25
    cfg.control.use_actuator_network = True
    # aliengo's wide near-straight stance needs ~15 N of STATIC lateral
    # friction per foot; the capped regularized law creeps and the stance
    # collapses. Anchored static friction (implicit anchor impulses) holds
    # it: kernel variant K4 of the fused chain step.
    cfg.sim.contact_warm_start = True
    # survive landing micro-hops without re-snapping anchors at displaced
    # positions (the spawn transient is violent: the calf default sits
    # 0.054 rad from its hard stop)
    cfg.sim.contact_anchor_release_depth = 0.02
    cfg.control.actuator_net_file = "{ASSETS}/actuator_nets/go1_net.pt"

    cfg.asset.file = "{ASSETS}/robots/aliengo/urdf/aliengo.urdf"
    cfg.asset.name = "aliengo"
    cfg.asset.foot_name = "foot"
    cfg.asset.penalize_contacts_on = ["thigh", "calf"]
    cfg.asset.terminate_after_contacts_on = ["base"]
    cfg.asset.self_collisions = 1

    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = [-1.0, 1.0]
    cfg.domain_rand.randomize_limb_mass = True
    cfg.domain_rand.added_limb_percentage = [-0.2, 0.2]

    cfg.rewards.soft_dof_pos_limit = 0.9
    cfg.rewards.base_height_target = 0.5
    cfg.rewards.scales["torques"] = -0.00025
    cfg.rewards.scales["dof_pos_limits"] = -10.0

    train = TrainCfg()
    train.runner.experiment_name = "rough_aliengo"
    return cfg, train
