"""Configuration trees for envs and training.

Plain mutable dataclasses (host-side only; never traced). The reference
expresses configs as nested classes with inheritance
(base_config.py:33-55); here robot variants are factory functions that
mutate a fresh default tree (see robots/*). Field names and
default values mirror the reference's ``LeggedRobotCfg`` /
``LeggedRobotCfgPPO`` (legged_robot_config.py:34-249) so a legged_gym user
finds every knob in the same place.

Reward scales live in a dict: every entry with a nonzero value binds the
reward term of the same name (the reference's reflection scheme,
legged_robot.py:574-598).
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Optional


def _d(**kw):
    return field(default_factory=lambda: dict(kw))


def _l(*items):
    return field(default_factory=lambda: list(items))


@dataclass
class EnvCfg:
    num_envs: int = 4096
    num_observations: int = 235
    num_privileged_obs: Optional[int] = None   # asymmetric-critic obs size
    num_actions: int = 12
    env_spacing: float = 3.0                   # grid spacing (plane/none only)
    send_timeouts: bool = True                 # expose time_outs for bootstrap
    episode_length_s: float = 20.0


@dataclass
class TerrainCfg:
    mesh_type: str = "plane"           # none | plane | heightfield | trimesh
    horizontal_scale: float = 0.1      # [m]
    vertical_scale: float = 0.005      # [m]
    border_size: float = 25.0          # [m]
    curriculum: bool = True
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    # rough terrain only:
    measure_heights: bool = True
    measured_points_x: list = _l(-0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2,
                                 -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6,
                                 0.7, 0.8)
    measured_points_y: list = _l(-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1,
                                 0.2, 0.3, 0.4, 0.5)
    selected: bool = False
    terrain_kwargs: Optional[dict] = None
    max_init_terrain_level: int = 5
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10                 # curriculum levels
    num_cols: int = 20                 # terrain types
    # [smooth slope, rough slope, stairs up, stairs down, discrete]
    terrain_proportions: list = _l(0.1, 0.1, 0.35, 0.25, 0.2)
    slope_treshold: float = 0.75       # trimesh vertical-face correction


@dataclass
class CommandsCfg:
    curriculum: bool = False
    max_curriculum: float = 1.0
    num_commands: int = 4      # lin_vel_x, lin_vel_y, ang_vel_yaw, heading
    resampling_time: float = 10.0      # [s]
    heading_command: bool = True       # yaw command from heading error
    ranges: dict = _d(lin_vel_x=[-1.0, 1.0], lin_vel_y=[-1.0, 1.0],
                      ang_vel_yaw=[-1.0, 1.0], heading=[-3.14, 3.14])


@dataclass
class InitStateCfg:
    pos: list = _l(0.0, 0.0, 1.0)
    rot: list = _l(0.0, 0.0, 0.0, 1.0)          # xyzw
    lin_vel: list = _l(0.0, 0.0, 0.0)
    ang_vel: list = _l(0.0, 0.0, 0.0)
    default_joint_angles: dict = _d()           # name -> angle at action=0
    # spawn randomization (reference hardcodes these: dof_pos = default
    # x U(0.5, 1.5), _reset_dofs:399-413; root vel U(-0.5, 0.5),
    # _reset_root_states:414-434). Exposed so curricula recipes (e.g.
    # biped balance-first, tools/train_cassie.py) can narrow them.
    dof_spawn_range: list = _l(0.5, 1.5)
    spawn_vel: float = 0.5


@dataclass
class ControlCfg:
    control_type: str = "P"            # P (position), V (velocity), T (torque)
    stiffness: dict = _d()             # joint-name substring -> kp [N*m/rad]
    damping: dict = _d()               # joint-name substring -> kd [N*m*s/rad]
    action_scale: float = 0.5          # target = scale * action + default
    decimation: int = 4                # control updates per policy step
    use_actuator_network: bool = False
    actuator_net_file: str = ""
    # fork quirk flag: the reference Go1/Aliengo UniNet output is computed
    # then discarded (go1.py:68-76). True reproduces that (plain PD);
    # False actually applies the network correction.
    actuator_net_discard_output: bool = True


@dataclass
class AssetCfg:
    file: str = ""
    name: str = "legged_robot"
    foot_name: str = "None"            # substring of the feet bodies
    penalize_contacts_on: list = _l()
    terminate_after_contacts_on: list = _l()
    disable_gravity: bool = False
    collapse_fixed_joints: bool = True
    fix_base_link: bool = False
    self_collisions: int = 0
    replace_cylinder_with_capsule: bool = True
    flip_visual_attachments: bool = True
    armature: float = 0.0
    angular_damping: float = 0.0
    linear_damping: float = 0.0


@dataclass
class DomainRandCfg:
    randomize_friction: bool = True
    friction_range: list = _l(0.5, 1.25)
    num_friction_buckets: int = 64     # reference PhysX bucketing quirk
    randomize_base_mass: bool = False
    added_mass_range: list = _l(-1.0, 1.0)
    randomize_limb_mass: bool = False
    added_limb_percentage: list = _l(-0.2, 0.2)
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0
    # extension: redraw friction/mass at every reset
    # (reference draws once at env creation, legged_robot.py:259-335)
    resample_on_reset: bool = False


@dataclass
class RewardsCfg:
    # nonzero entry <name> binds method _reward_<name>; scales are
    # multiplied by policy dt at parse time (legged_robot.py:584)
    scales: dict = _d(
        termination=-0.0,
        tracking_lin_vel=1.0,
        tracking_ang_vel=0.5,
        lin_vel_z=-4.0,
        ang_vel_xy=-0.01,
        orientation=-0.0,
        torques=-0.00001,
        dof_vel=-0.0,
        dof_acc=-2.5e-7,
        base_height=-0.0,
        feet_air_time=1.0,
        collision=-1.0,
        feet_stumble=-0.0,
        action_rate=-0.01,
    )
    only_positive_rewards: bool = True
    tracking_sigma: float = 0.25       # tracking reward = exp(-err^2/sigma)
    soft_dof_pos_limit: float = 1.0    # fraction of URDF range
    soft_dof_vel_limit: float = 1.0
    soft_torque_limit: float = 1.0
    base_height_target: float = 1.0
    max_contact_force: float = 100.0


@dataclass
class NormalizationCfg:
    obs_scales: dict = _d(lin_vel=2.0, ang_vel=0.25, dof_pos=1.0,
                          dof_vel=0.05, height_measurements=5.0)
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@dataclass
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0
    noise_scales: dict = _d(dof_pos=0.01, dof_vel=1.5, lin_vel=0.1,
                            ang_vel=0.2, gravity=0.05,
                            height_measurements=0.1)


@dataclass
class ViewerCfg:
    ref_env: int = 0
    pos: list = _l(10.0, 0.0, 6.0)
    lookat: list = _l(11.0, 5.0, 3.0)


@dataclass
class SimCfg:
    dt: float = 0.005                  # [s] one engine step
    # inner contact substeps: the inelastic impulse contact law is stable
    # at 1 substep = the reference's exact PhysX cadence
    # (legged_robot_config.py:193-194: dt 0.005, 1 substep)
    substeps: int = 1
    gravity: list = _l(0.0, 0.0, -9.81)
    dtype: str = "float32"
    # fused chain-layout physics (physics/chain_engine.py): the whole
    # decimation loop as one CUDA kernel launch on the card, the plain
    # PyTorch version on the CPU. False runs the general stacked engine
    # (physics/engine.py, plain torch ops) instead.
    use_chain_engine: bool = True
    # anchored static friction (contact.ContactConfig.warm_start):
    # carries per-point tangential anchors across substeps so loaded
    # stances stick instead of creeping; supported by both engines
    contact_warm_start: bool = False
    # geometric anchor-release clearance [m]: anchors survive hops up to
    # this height (heavy robots rebound harder at spawn — widen it so
    # landing micro-hops don't re-snap anchors at displaced positions)
    contact_anchor_release_depth: float = 0.005
    # contact-plane cadence in the fused chain path: True = sample the
    # terrain planes once per POLICY step (PhysX broadphase-ish, 4x
    # fewer sampler instructions — the bench default), False = per sim
    # dt (higher stair-edge fidelity for swing-foot landings: a foot
    # moves up to ~8 cm per policy step and can land on a stale plane)
    contact_plane_per_step: bool = True


@dataclass
class LeggedRobotCfg:
    env: EnvCfg = field(default_factory=EnvCfg)
    terrain: TerrainCfg = field(default_factory=TerrainCfg)
    commands: CommandsCfg = field(default_factory=CommandsCfg)
    init_state: InitStateCfg = field(default_factory=InitStateCfg)
    control: ControlCfg = field(default_factory=ControlCfg)
    asset: AssetCfg = field(default_factory=AssetCfg)
    domain_rand: DomainRandCfg = field(default_factory=DomainRandCfg)
    rewards: RewardsCfg = field(default_factory=RewardsCfg)
    normalization: NormalizationCfg = field(default_factory=NormalizationCfg)
    noise: NoiseCfg = field(default_factory=NoiseCfg)
    viewer: ViewerCfg = field(default_factory=ViewerCfg)
    sim: SimCfg = field(default_factory=SimCfg)

    def copy(self):
        return copy.deepcopy(self)


# ---------------------------------------------------------------- training

@dataclass
class PolicyCfg:
    init_noise_std: float = 1.0
    actor_hidden_dims: list = _l(512, 256, 128)
    critic_hidden_dims: list = _l(512, 256, 128)
    activation: str = "elu"
    # only for ActorCriticRecurrent (legged_robot_config.py:221-224);
    # rnn_type is set from runner.policy_class_name by the runner, or
    # directly ("lstm") for explicit control
    rnn_type: Optional[str] = None
    rnn_hidden_size: int = 512
    rnn_num_layers: int = 1


@dataclass
class AlgorithmCfg:
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 6.0e-4
    schedule: str = "adaptive"         # adaptive (KL) | fixed
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0


@dataclass
class RunnerCfg:
    # ActorCritic | ActorCriticRecurrent (legged_robot_config.py:241);
    # Recurrent selects the LSTM memory per PolicyCfg.rnn_* fields
    policy_class_name: str = "ActorCritic"
    algorithm_class_name: str = "PPO"
    num_steps_per_env: int = 24
    max_iterations: int = 800
    save_interval: int = 50
    experiment_name: str = "test"
    run_name: str = ""
    resume: bool = False
    load_run: str = "-1"               # -1 = latest run
    checkpoint: int = -1               # -1 = latest checkpoint
    resume_path: Optional[str] = None


@dataclass
class TrainCfg:
    seed: int = 1
    policy: PolicyCfg = field(default_factory=PolicyCfg)
    algorithm: AlgorithmCfg = field(default_factory=AlgorithmCfg)
    runner: RunnerCfg = field(default_factory=RunnerCfg)

    def copy(self):
        return copy.deepcopy(self)


def config_to_dict(cfg):
    """Recursively convert a config tree to plain dicts (the reference's
    class_to_dict, helpers.py:41-56) — used for run-dir snapshots."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, dict):
        return {k: config_to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    return cfg
