"""Environment state containers (port of ``ti5_isaacgym_tpu/envs/types.py``).

Every field is a ``[num_envs, ...]`` tensor on the env's device, except the
scalar counters and the random generator.  Resets are ``torch.where``
masking, as in the JAX package, so a state can be compared field by field
with the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..physics.dynamics import DynamicsParams
from ..physics.engine import PhysicsState


@dataclass
class EnvParams:
    """Per-env randomized physical and actuation parameters."""

    dynamics: DynamicsParams          # mass/com/inertia [N,nb,...], armature [N,12]
    friction: torch.Tensor            # [N] ground friction coefficient
    restitution: torch.Tensor         # [N] contact restitution
    body_mass: torch.Tensor           # [N] base mass incl. payload (priv obs)
    p_gains: torch.Tensor             # [N,12]
    d_gains: torch.Tensor             # [N,12]
    motor_offsets: torch.Tensor       # [N,12]
    joint_coulomb: torch.Tensor       # [N,12]
    joint_viscous: torch.Tensor       # [N,12]
    lag_steps: torch.Tensor           # [N] action lag (1 kHz substeps)
    dof_lag_steps: torch.Tensor       # [N] dof sensor lag
    imu_lag_steps: torch.Tensor       # [N] imu lag
    dof_pos_lag_steps: torch.Tensor   # [N] separate dof-pos sensor lag
    dof_vel_lag_steps: torch.Tensor   # [N] separate dof-vel sensor lag

    def replace(self, **kw) -> "EnvParams":
        return replace(self, **kw)


@dataclass
class EnvState:
    """Full environment state for the vectorized task."""

    phys: PhysicsState
    params: EnvParams
    rng: torch.Generator              # the env's random stream (on its device)
    terrain_height: torch.Tensor      # [rows, cols] meters

    # episode machinery
    episode_length: torch.Tensor      # [N] int32
    phase_length: torch.Tensor        # [N] int32
    gait_start: torch.Tensor          # [N] float (0 or 0.5)
    gait_time: torch.Tensor           # [N, n_gaits] int32 segment boundaries
    commands: torch.Tensor            # [N, 4] vx, vy, wyaw, heading
    common_step: torch.Tensor         # scalar int32

    # curricula
    terrain_level: torch.Tensor       # [N] int32
    terrain_type: torch.Tensor        # [N] int32
    env_origin: torch.Tensor          # [N, 3]
    cmd_vx_range: torch.Tensor        # [2]

    # control / history buffers
    actions: torch.Tensor             # [N,12]
    last_actions: torch.Tensor
    last_last_actions: torch.Tensor
    torques: torch.Tensor             # [N,12] (last substep)
    last_dof_vel: torch.Tensor
    last_root_vel: torch.Tensor       # [N,6] world lin+ang
    lag_buffer: torch.Tensor          # [N,12,L] action lag ring, index 0 newest
    dof_lag_buffer: torch.Tensor      # [N,24,Ld] dof pos+vel lag ring
    imu_lag_buffer: torch.Tensor      # [N,6,Li] angvel+euler lag ring

    # contact / gait trackers
    contact_forces: torch.Tensor      # [N,nb,3] world (net, last substep)
    feet_air_time: torch.Tensor       # [N,2]
    last_contacts: torch.Tensor       # [N,2] bool
    feet_height: torch.Tensor         # [N,2]
    last_feet_z: torch.Tensor         # [N,2]

    # reference motion (computed with the obs, consumed by the next rewards)
    ref_dof_pos: torch.Tensor         # [N,12]
    ref_action: torch.Tensor          # [N,12]

    # perturbation events
    push_force: torch.Tensor          # [N,3]
    push_torque: torch.Tensor
    ext_force: torch.Tensor
    ext_torque: torch.Tensor
    ext_force_apply: torch.Tensor
    ext_torque_apply: torch.Tensor
    is_first_push: torch.Tensor       # scalar bool
    is_first_add_force: torch.Tensor  # scalar bool

    # observation history, flat and bf16 as in the JAX package (oldest first)
    obs_hist: torch.Tensor            # [N, 66*47] bf16
    critic_hist: torch.Tensor         # [N, 3*73] bf16

    # logging
    episode_sums: torch.Tensor        # [N, n_reward_terms]
    reset_buf: torch.Tensor           # [N] bool
    time_out_buf: torch.Tensor        # [N] bool

    def replace(self, **kw) -> "EnvState":
        return replace(self, **kw)

