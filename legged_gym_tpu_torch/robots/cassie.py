"""Agility Cassie biped (reference cassie_config.py:33-111; adds the
``no_fly`` reward, cassie.py:43-46)."""
from legged_gym_tpu_torch.config import LeggedRobotCfg, TrainCfg


def cassie():
    cfg = LeggedRobotCfg()
    cfg.env.num_observations = 169
    # reference cassie inherits the BASE terrain (trimesh + curriculum,
    # legged_robot_config.py:45); its 169-dim obs = 48 + the 11x11 scan
    cfg.terrain.mesh_type = "trimesh"
    cfg.terrain.measure_heights = True
    cfg.terrain.measured_points_x = [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0,
                                     0.1, 0.2, 0.3, 0.4, 0.5]
    cfg.terrain.measured_points_y = [-0.5, -0.4, -0.3, -0.2, -0.1, 0.0,
                                     0.1, 0.2, 0.3, 0.4, 0.5]

    cfg.init_state.pos = [0.0, 0.0, 1.0]
    cfg.init_state.default_joint_angles = {
        "hip_abduction_left": 0.1, "hip_rotation_left": 0.0,
        "hip_flexion_left": 1.0, "thigh_joint_left": -1.8,
        "ankle_joint_left": 1.57, "toe_joint_left": -1.57,
        "hip_abduction_right": -0.1, "hip_rotation_right": 0.0,
        "hip_flexion_right": 1.0, "thigh_joint_right": -1.8,
        "ankle_joint_right": 1.57, "toe_joint_right": -1.57,
    }

    cfg.control.stiffness = {
        "hip_abduction": 100.0, "hip_rotation": 100.0,
        "hip_flexion": 200.0, "thigh_joint": 200.0, "ankle_joint": 200.0,
        "toe_joint": 40.0}
    cfg.control.damping = {
        "hip_abduction": 3.0, "hip_rotation": 3.0, "hip_flexion": 6.0,
        "thigh_joint": 6.0, "ankle_joint": 6.0, "toe_joint": 1.0}
    cfg.control.action_scale = 0.5

    cfg.asset.file = "{ASSETS}/robots/cassie/urdf/cassie.urdf"
    cfg.asset.name = "cassie"
    cfg.asset.foot_name = "toe"
    cfg.asset.terminate_after_contacts_on = ["pelvis"]
    cfg.asset.flip_visual_attachments = False
    cfg.asset.self_collisions = 1

    cfg.rewards.soft_dof_pos_limit = 0.95
    cfg.rewards.soft_dof_vel_limit = 0.9
    cfg.rewards.soft_torque_limit = 0.9
    cfg.rewards.max_contact_force = 300.0
    cfg.rewards.only_positive_rewards = False
    cfg.rewards.scales.update(
        termination=-200.0, tracking_ang_vel=1.0, torques=-5.0e-6,
        dof_acc=-2.0e-7, lin_vel_z=-0.5, feet_air_time=5.0,
        dof_pos_limits=-1.0, no_fly=0.25, dof_vel=-0.0, ang_vel_xy=-0.0,
        feet_contact_forces=-0.0)

    train = TrainCfg()
    train.runner.experiment_name = "rough_cassie"
    return cfg, train
