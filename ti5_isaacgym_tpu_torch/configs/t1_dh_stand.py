"""Task + training configuration for ``t1_dh_stand``.

This package's copy of ``ti5_isaacgym_tpu/configs/t1_dh_stand.py``: frozen
dataclasses with the same fields and defaults (the task's published
hyperparameters).  The ``sim.megakernel*`` switches select the env's
decimation path; see ``envs/t1_dh_stand.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from ..terrain.terrain import TerrainCfg


@dataclass(frozen=True)
class EnvSection:
    frame_stack: int = 66                 # long obs history
    short_frame_stack: int = 5            # short history for the estimator
    c_frame_stack: int = 3                # critic history
    num_single_obs: int = 47
    single_num_privileged_obs: int = 73
    num_actions: int = 12
    num_envs: int = 4096
    episode_length_s: float = 24.0
    use_ref_actions: bool = False
    single_linvel_index: int = 53
    num_commands: int = 5                 # obs command block: sin,cos,vx,vy,wyaw
    send_timeouts: bool = True
    env_spacing: float = 3.0

    @property
    def num_observations(self) -> int:
        return self.frame_stack * self.num_single_obs

    @property
    def num_privileged_obs(self) -> int:
        # with measure_heights each stacked privileged frame widens by the
        # 187-point scan (reference t1_dh_stand_env.py:466-468,
        # dh_on_policy_runner.py:47-49)
        return self.c_frame_stack * self.priv_frame_dim

    # set by T1EnvCfg.__post_init__ when terrain.measure_heights is on
    num_height_points: int = 0

    @property
    def priv_frame_dim(self) -> int:
        return self.single_num_privileged_obs + self.num_height_points

    @property
    def num_short_obs(self) -> int:
        return self.short_frame_stack * self.num_single_obs


@dataclass(frozen=True)
class SafetySection:
    pos_limit: float = 1.0
    vel_limit: float = 1.0
    torque_limit: float = 0.85


@dataclass(frozen=True)
class AssetSection:
    name: str = "t1"
    # model-spec JSON under ti5_isaacgym_tpu/resources/ (produced by
    # tools/extract_model.py from the robot URDF)
    model_spec: str = "t1_model.json"
    foot_name: str = "6_link"
    knee_name: str = "4_link"
    terminate_after_contacts_on: Tuple[str, ...] = ("base_link",)
    penalize_contacts_on: Tuple[str, ...] = ("base_link",)
    fix_base_link: bool = False


@dataclass(frozen=True)
class NoiseScales:
    dof_pos: float = 0.02
    dof_vel: float = 1.5
    ang_vel: float = 0.2
    lin_vel: float = 0.1
    quat: float = 0.1
    gravity: float = 0.05
    height_measurements: float = 0.1


@dataclass(frozen=True)
class NoiseSection:
    add_noise: bool = True
    noise_level: float = 1.5
    noise_scales: NoiseScales = field(default_factory=NoiseScales)


@dataclass(frozen=True)
class InitStateSection:
    pos: Tuple[float, float, float] = (0.0, 0.0, 1.1)
    # joint order: leg_l1..l6, leg_r1..r6 (init_angle = 0.3)
    default_joint_angles: Tuple[float, ...] = (
        0.0, 0.0, -0.3, 0.6, -0.3, 0.0,
        0.0, 0.0, -0.3, 0.6, -0.3, 0.0,
    )


@dataclass(frozen=True)
class ControlSection:
    control_type: str = "P"
    # per joint class 1..6, replicated left/right
    stiffness: Tuple[float, ...] = (50, 70, 90, 120, 50, 30, 50, 70, 90, 120, 50, 30)
    damping: Tuple[float, ...] = (5, 7, 9, 12, 5, 3, 5, 7, 9, 12, 5, 3)
    action_scale: float = 0.5
    decimation: int = 10                  # 100 Hz policy over 1 kHz physics


@dataclass(frozen=True)
class SimSection:
    dt: float = 0.001
    gravity: float = -9.81
    # TPU engine solver knobs (the PhysX block of the reference maps to these)
    contact_kp: float = 2.0e6
    contact_kd: float = 2.0e4
    contact_kt: float = 2.0e6
    contact_kdt: float = 2.0e4
    max_depenetration_depth: float = 0.05
    joint_limit_kp: float = 500.0
    joint_limit_kd: float = 10.0
    # run the whole decimation loop as one CUDA kernel launch
    # (physics/megakernel.py) when the env lives on a card; False takes the
    # per-substep loop (the JAX package's lax.scan path) everywhere
    megakernel: bool = True
    # on the CPU the per-substep loop is the default; True sends CPU envs
    # through the kernel path's pack/unpack with the kernel's plain version
    # (the JAX package's megakernel_interpret switch)
    megakernel_interpret: bool = False


@dataclass(frozen=True)
class DomainRandSection:
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.2, 1.3)
    restitution_range: Tuple[float, float] = (0.0, 0.4)

    push_robots: bool = False
    push_interval_s: float = 6.0
    update_step: int = 2500 * 24
    push_duration: Tuple[float, ...] = (0, 0.05, 0.1, 0.15, 0.2, 0.25, 0.3)
    max_push_vel_xy: float = 0.2
    max_push_ang_vel: float = 0.2

    add_ext_force: bool = True
    ext_force_max_x: float = 600.0
    ext_force_max_y: float = 400.0
    ext_force_max_z: float = 5.0
    ext_torque_max: float = 0.0
    ext_force_interval_s: float = 4.0
    add_update_step: int = 4000 * 24
    add_duration: Tuple[float, ...] = (0.0, 0.05, 0.1, 0.15)

    randomize_base_mass: bool = True
    added_mass_range: Tuple[float, float] = (-2.5, 2.5)
    randomize_com: bool = True
    com_displacement_range: Tuple[Tuple[float, float], ...] = (
        (-0.05, 0.05), (-0.05, 0.05), (-0.05, 0.05))
    randomize_link_mass: bool = True
    added_link_mass_range: Tuple[float, float] = (0.9, 1.1)

    randomize_gains: bool = True
    stiffness_multiplier_range: Tuple[float, float] = (0.8, 1.2)
    damping_multiplier_range: Tuple[float, float] = (0.8, 1.2)
    randomize_torque: bool = True
    torque_multiplier_range: Tuple[float, float] = (0.8, 1.2)
    randomize_motor_offset: bool = True
    motor_offset_range: Tuple[float, float] = (-0.035, 0.035)

    randomize_joint_armature: bool = True
    randomize_joint_armature_each_joint: bool = True
    joint_armature_range: Tuple[float, float] = (0.001, 0.05)
    # per-joint armature ranges 1..12 (reference :273-285)
    joint_armature_ranges: Tuple[Tuple[float, float], ...] = (
        (0.15 * 0.8, 0.15 * 1.2), (0.15 * 0.8, 0.15 * 1.2),
        (3.6 * 0.5, 3.6 * 1.0), (3.6 * 0.5, 3.6 * 1.0),
        (0.1 * 0.5, 0.1 * 1.1), (0.028 * 0.5, 0.028 * 1.5),
        (0.15 * 0.8, 0.15 * 1.2), (0.15 * 0.8, 0.15 * 1.2),
        (3.6 * 0.5, 3.6 * 1.0), (3.6 * 0.5, 3.6 * 1.0),
        (0.1 * 0.5, 0.1 * 1.1), (0.028 * 0.5, 0.028 * 1.5),
    )

    add_lag: bool = True
    randomize_lag_timesteps: bool = True
    randomize_lag_timesteps_perstep: bool = False
    lag_timesteps_range: Tuple[int, int] = (0, 30)

    add_dof_lag: bool = True
    randomize_dof_lag_timesteps: bool = True
    randomize_dof_lag_timesteps_perstep: bool = False
    dof_lag_timesteps_range: Tuple[int, int] = (0, 30)

    add_dof_pos_vel_lag: bool = False
    randomize_dof_pos_lag_timesteps: bool = True
    randomize_dof_pos_lag_timesteps_perstep: bool = False
    dof_pos_lag_timesteps_range: Tuple[int, int] = (7, 25)
    randomize_dof_vel_lag_timesteps: bool = True
    randomize_dof_vel_lag_timesteps_perstep: bool = False
    dof_vel_lag_timesteps_range: Tuple[int, int] = (7, 25)

    add_imu_lag: bool = True
    randomize_imu_lag_timesteps: bool = True
    randomize_imu_lag_timesteps_perstep: bool = False
    imu_lag_timesteps_range: Tuple[int, int] = (0, 10)

    randomize_coulomb_friction: bool = True
    joint_coulomb_range: Tuple[float, float] = (0.1, 1.0)
    joint_viscous_range: Tuple[float, float] = (0.1, 0.9)


@dataclass(frozen=True)
class CommandRanges:
    lin_vel_x: Tuple[float, float] = (-0.5, 0.5)
    lin_vel_y: Tuple[float, float] = (-0.5, 0.5)
    ang_vel_yaw: Tuple[float, float] = (-0.5, 0.5)
    heading: Tuple[float, float] = (-3.14, 3.14)


@dataclass(frozen=True)
class CommandsSection:
    curriculum: bool = True
    max_curriculum: float = 1.5
    num_commands: int = 4
    resampling_time: float = 25.0
    gait: Tuple[str, ...] = ("walk_omnidirectional", "stand", "walk_omnidirectional")
    gait_time_range: Tuple[Tuple[float, float], ...] = ((4, 6), (2, 3), (4, 6))
    heading_command: bool = False
    stand_com_threshold: float = 0.05
    sw_switch: bool = True
    ranges: CommandRanges = field(default_factory=CommandRanges)


@dataclass(frozen=True)
class RewardsSection:
    base_height_target: float = 0.965
    foot_min_dist: float = 0.15
    foot_max_dist: float = 0.45
    knee_min_dist: float = 0.12
    knee_max_dist: float = 0.35
    target_joint_pos_scale: float = 0.3
    target_feet_height: float = 0.02
    target_feet_height_max: float = 0.08
    cycle_time: float = 0.8
    only_positive_rewards: bool = True
    tracking_sigma: float = 5.0
    max_contact_force: float = 500.0
    soft_dof_vel_limit: float = 1.0
    scales: Tuple[Tuple[str, float], ...] = (
        ("joint_pos", 4.0),
        ("feet_clearance", 1.0),
        ("feet_contact_number", 1.2),
        ("feet_air_time", 1.0),
        ("foot_slip", -0.5),
        ("feet_distance", 0.2),
        ("knee_distance", 0.2),
        ("feet_rotation", 0.8),
        ("feet_contact_forces", -0.01),
        ("tracking_lin_vel", 1.5),
        ("tracking_ang_vel", 0.8),
        ("vel_mismatch_exp", 0.5),
        ("low_speed", 0.2),
        ("track_vel_hard", 0.5),
        ("default_joint_pos", 1.0),
        ("orientation", 1.0),
        ("base_height", 0.2),
        ("base_acc", 0.2),
        ("action_smoothness", -0.03),
        ("torques", -2e-7),
        ("dof_vel", -2e-5),
        ("dof_acc", -5e-7),
        ("collision", -1.0),
        ("stand_still", 2.5),
    )


@dataclass(frozen=True)
class ObsScales:
    lin_vel: float = 2.0
    ang_vel: float = 1.0
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    quat: float = 1.0
    height_measurements: float = 5.0


@dataclass(frozen=True)
class NormalizationSection:
    obs_scales: ObsScales = field(default_factory=ObsScales)
    clip_observations: float = 100.0
    clip_actions: float = 100.0


@dataclass(frozen=True)
class T1EnvCfg:
    """Task/env config (reference ``t1_dh_stand_config.py``).

    ``__post_init__`` wires ``env.num_height_points`` from the terrain
    section so every consumer of ``env.num_privileged_obs`` (network build,
    runner buffers) agrees with the env's widened privileged frame when
    ``terrain.measure_heights`` is enabled."""

    env: EnvSection = field(default_factory=EnvSection)
    safety: SafetySection = field(default_factory=SafetySection)
    asset: AssetSection = field(default_factory=AssetSection)
    terrain: TerrainCfg = field(default_factory=lambda: TerrainCfg(
        mesh_type="heightfield",
        curriculum=True,
        measure_heights=False,
        static_friction=0.6,
        dynamic_friction=0.6,
        terrain_length=8.0,
        terrain_width=8.0,
        num_rows=20,
        num_cols=20,
        max_init_terrain_level=5,
        platform=3.0,
        terrain_proportions=(0.5, 0.3, 0.1, 0.1, 0, 0, 0, 0, 0, 0),
        rough_flat_range=(0.005, 0.01),
        slope_range=(0.0, 0.1),
        rough_slope_range=(0.005, 0.02),
        stair_width_range=(0.25, 0.25),
        stair_height_range=(0.01, 0.1),
        discrete_height_range=(0.0, 0.01),
    ))
    noise: NoiseSection = field(default_factory=NoiseSection)
    init_state: InitStateSection = field(default_factory=InitStateSection)
    control: ControlSection = field(default_factory=ControlSection)
    sim: SimSection = field(default_factory=SimSection)
    domain_rand: DomainRandSection = field(default_factory=DomainRandSection)
    commands: CommandsSection = field(default_factory=CommandsSection)
    rewards: RewardsSection = field(default_factory=RewardsSection)
    normalization: NormalizationSection = field(default_factory=NormalizationSection)

    def __post_init__(self):
        import dataclasses

        nhp = (self.terrain.num_height_points
               if self.terrain.measure_heights else 0)
        if self.env.num_height_points != nhp:
            object.__setattr__(
                self, "env",
                dataclasses.replace(self.env, num_height_points=nhp))


# --- training config (reference DHT1StandCfgPPO) ---


@dataclass(frozen=True)
class PolicyCfg:
    init_noise_std: float = 1.0
    actor_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    critic_hidden_dims: Tuple[int, ...] = (768, 256, 128)
    state_estimator_hidden_dims: Tuple[int, ...] = (256, 128, 64)
    kernel_size: Tuple[int, ...] = (6, 4)
    filter_size: Tuple[int, ...] = (32, 16)
    stride_size: Tuple[int, ...] = (3, 2)
    lh_output_dim: int = 64
    in_channels: int = 66


@dataclass(frozen=True)
class AlgorithmCfg:
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.001
    num_learning_epochs: int = 2
    num_mini_batches: int = 4
    learning_rate: float = 1e-5
    schedule: str = "adaptive"
    gamma: float = 0.994
    lam: float = 0.9
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    # 73 * (3 - 1) + 53 = 199: base-lin-vel slice in the newest critic frame
    lin_vel_idx: int = 199


@dataclass(frozen=True)
class RunnerCfg:
    policy_class_name: str = "ActorCriticDH"
    algorithm_class_name: str = "DHPPO"
    num_steps_per_env: int = 24
    max_iterations: int = 30001
    save_interval: int = 500
    experiment_name: str = "t1_dh_stand"
    run_name: str = "ti5"
    resume: bool = False
    load_run: object = -1
    checkpoint: object = -1
    resume_path: Optional[str] = None


@dataclass(frozen=True)
class T1TrainCfg:
    seed: int = 5
    runner_class_name: str = "DHOnPolicyRunner"
    policy: PolicyCfg = field(default_factory=PolicyCfg)
    algorithm: AlgorithmCfg = field(default_factory=AlgorithmCfg)
    runner: RunnerCfg = field(default_factory=RunnerCfg)
