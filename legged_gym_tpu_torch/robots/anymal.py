"""ANYbotics ANYmal B / C (reference anymal_c_rough_config.py:33-103,
anymal_c_flat_config.py:33-74, anymal_b_config.py:33-47)."""
from legged_gym_tpu_torch.config import LeggedRobotCfg, TrainCfg


def anymal_c_rough():
    cfg = LeggedRobotCfg()
    cfg.terrain.mesh_type = "trimesh"

    cfg.init_state.pos = [0.0, 0.0, 0.6]
    cfg.init_state.default_joint_angles = {
        "LF_HAA": 0.0, "LH_HAA": 0.0, "RF_HAA": -0.0, "RH_HAA": -0.0,
        "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
        "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8,
    }

    cfg.control.stiffness = {"HAA": 80.0, "HFE": 80.0, "KFE": 80.0}
    cfg.control.damping = {"HAA": 2.0, "HFE": 2.0, "KFE": 2.0}
    cfg.control.action_scale = 0.5
    cfg.control.use_actuator_network = True
    cfg.control.actuator_net_file = \
        "{ASSETS}/actuator_nets/anydrive_v3_lstm.pt"
    # ANYmal's SEA torques are APPLIED in the reference (anymal.py:71-78
    # returns the LSTM output), unlike go1/aliengo whose net output is
    # discarded — the global discard-quirk default must not silence it
    cfg.control.actuator_net_discard_output = False
    # the SEA net's velocity-feedback (damping) component is an EXPLICIT
    # torque here (PhysX absorbs applied-torque stiffness in its TGS
    # iterations); at 5 ms it sits on the explicit-stability boundary
    # for the light knee and rattles it at the velocity cap (measured
    # |qd|~10 rad/s standing). 4 substeps puts the margin at 4x; the SEA
    # net itself still advances once per sim dt (reference cadence).
    cfg.sim.substeps = 4
    # anchored static friction: the ~87 N*m/rad SEA drive cannot hold the
    # 52 kg stance against regularized-friction creep — feet slide out
    # (foot x 0.46 -> 0.71 m measured), HAA splays ~0.3 rad, the shanks
    # ground and the collision penalty zero-clips every reward. The
    # anchors hold the loaded stance exactly as they do for aliengo
    # (kernel variant K4, here combined with the torque drive K3).
    cfg.sim.contact_warm_start = True
    # survive the spawn-landing rebounds (~1-2 cm hops at 52 kg) without
    # re-snapping the anchors at displaced positions
    cfg.sim.contact_anchor_release_depth = 0.02

    cfg.asset.file = "{ASSETS}/robots/anymal_c/urdf/anymal_c.urdf"
    cfg.asset.name = "anymal_c"
    cfg.asset.foot_name = "FOOT"
    cfg.asset.penalize_contacts_on = ["SHANK", "THIGH"]
    cfg.asset.terminate_after_contacts_on = ["base"]
    cfg.asset.self_collisions = 1

    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = [-5.0, 5.0]

    cfg.rewards.base_height_target = 0.5
    cfg.rewards.max_contact_force = 500.0
    cfg.rewards.only_positive_rewards = True

    train = TrainCfg()
    train.runner.experiment_name = "rough_anymal_c"
    return cfg, train


def anymal_c_flat():
    cfg, train = anymal_c_rough()
    cfg.env.num_observations = 48
    cfg.terrain.mesh_type = "plane"
    cfg.terrain.measure_heights = False
    cfg.asset.self_collisions = 0
    cfg.rewards.max_contact_force = 350.0
    cfg.rewards.scales["orientation"] = -5.0
    cfg.rewards.scales["torques"] = -0.000025
    cfg.rewards.scales["feet_air_time"] = 2.0
    cfg.commands.heading_command = False
    cfg.commands.resampling_time = 4.0
    cfg.commands.ranges["ang_vel_yaw"] = [-1.5, 1.5]
    cfg.domain_rand.friction_range = [0.0, 1.5]

    train.policy.actor_hidden_dims = [128, 64, 32]
    train.policy.critic_hidden_dims = [128, 64, 32]
    train.runner.experiment_name = "flat_anymal_c"
    train.runner.max_iterations = 300
    return cfg, train


def anymal_b():
    cfg, train = anymal_c_rough()
    cfg.asset.file = "{ASSETS}/robots/anymal_b/urdf/anymal_b.urdf"
    cfg.asset.name = "anymal_b"
    cfg.asset.foot_name = "FOOT"
    train.runner.experiment_name = "rough_anymal_b"
    return cfg, train
