"""T1 "DH stand" task environment (port of ``ti5_isaacgym_tpu/envs/t1_dh_stand.py``).

Omnidirectional walking and standing with a gait-phase reference motion,
actuator and sensor lag, domain randomization, terrain and command curricula,
and the 47-dim observation stacked 66 deep / 73-dim privileged observation
stacked 3 deep.  ``step`` keeps the reference's call order:

  substeps -> counters -> callback (phase/commands/events) -> termination ->
  rewards -> masked reset -> observations -> last_* rollover

The decimation loop takes one of two paths (the JAX rule at
``t1_dh_stand.py:546-553``): on a card, the whole loop is one launch of the
CUDA kernel (:mod:`..physics.megakernel`), with the action lag resolved
before the launch and the sensor lag rings rebuilt from the kernel's
snapshots after it; on the CPU, and wherever the action lag is re-drawn every
substep, a Python loop over :func:`..physics.engine_core.substep_batched`
(the JAX package's ``lax.scan`` path).
"""
from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..configs.t1_dh_stand import T1EnvCfg
from ..physics import dynamics as dyn
from ..physics import spatial as sp
from ..physics.contact import (ContactOpts, build_supertable, flat_cell_cache, flat_terrain,
                               gather_cells_supercell, sample_height_min3)
from ..physics.engine import (PhysicsState, SolverOpts, probe_contact_masses, root_world_vel,
                              set_root_world_vel)
from ..physics.engine_core import (contact_point_xy, ctx_kinematics, ctx_row_layout,
                                   model_consts, substep_batched)
from ..physics.megakernel import run_decimation
from ..physics.model import RESOURCES, RobotModel
from ..physics.model import load as load_model
from ..terrain.terrain import Terrain
from ..utils.device import resolve_device
from . import legged
from .types import EnvParams, EnvState


class StepCtx(NamedTuple):
    """Derived quantities shared by termination, rewards and observations."""

    base_lin_vel: torch.Tensor      # [N,3] base frame
    base_ang_vel: torch.Tensor      # [N,3] base frame
    base_euler: torch.Tensor        # [N,3]
    projected_gravity: torch.Tensor # [N,3]
    root_vel_world: torch.Tensor    # [N,6] lin+ang world
    feet_pos: torch.Tensor          # [N,2,3]
    feet_euler: torch.Tensor        # [N,2,3]
    feet_angvel_xy: torch.Tensor    # [N,2,2]
    knee_xy: torch.Tensor           # [N,2,2]
    contact: torch.Tensor           # [N,2] bool, fz > 5 N
    stand_command: torch.Tensor     # [N] bool


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class T1DHStandEnv:
    """Vectorized T1 walking/standing task on one device (``cuda`` unless the
    caller asks for ``cpu``)."""

    def __init__(self, cfg: T1EnvCfg, model: Optional[RobotModel] = None,
                 terrain: Optional[Terrain] = None, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        dev = self.device
        self.cfg = cfg
        self.model = model if model is not None else load_model(
            os.path.join(RESOURCES, getattr(cfg.asset, "model_spec", "t1_model.json")))
        self.mc = model_consts(self.model)
        # the width init_state builds; under data parallelism every rank
        # builds the global state and keeps its slice, so a state's own
        # width is the rank's (step and reset read the width of the state)
        self.num_envs = cfg.env.num_envs
        # the ranks the command curriculum reduces over (None: this process
        # alone); set by parallel.trainer.ShardedRunner
        self.group = None
        self.num_actions = cfg.env.num_actions
        self.dt = cfg.control.decimation * cfg.sim.dt
        self.max_episode_length_s = cfg.env.episode_length_s
        self.max_episode_length = int(np.ceil(self.max_episode_length_s / self.dt))

        if cfg.terrain.mesh_type in ("heightfield", "trimesh"):
            self.terrain = terrain if terrain is not None else Terrain(cfg.terrain, seed=seed)
            self.heightfield = self.terrain.heightfield(dev)
            self.terrain_origins = self.terrain.origins_device(dev)
            self.custom_origins = True
            # one patch per env holds every contact point's cell; the margin
            # is the largest reach of any collision point from the base
            self.supertable = build_supertable(
                self.terrain.height_field_raw.astype(np.float32) * cfg.terrain.vertical_scale,
                self.heightfield.hscale, self.heightfield.offset, supercell=16,
                margin_m=self._max_cp_reach() + 0.1, device=dev)
        else:
            self.terrain = None
            self.heightfield = flat_terrain(dev)
            self.terrain_origins = None
            self.custom_origins = False
            self.supertable = None

        self.default_dof_pos = _f32(cfg.init_state.default_joint_angles, dev)
        self.p_gains_nom = _f32(cfg.control.stiffness, dev)
        self.d_gains_nom = _f32(cfg.control.damping, dev)
        self.torque_limits = _f32(self.model.dof_effort * cfg.safety.torque_limit, dev)
        self.dof_vel_limits = _f32(self.model.dof_velocity * cfg.safety.vel_limit, dev)
        os_ = cfg.normalization.obs_scales
        self.commands_scale = _f32([os_.lin_vel, os_.lin_vel, os_.ang_vel], dev)
        self.copts = ContactOpts(kp=cfg.sim.contact_kp, kd=cfg.sim.contact_kd,
                                 kt=cfg.sim.contact_kt, kdt=cfg.sim.contact_kdt,
                                 max_depth=cfg.sim.max_depenetration_depth, dt=cfg.sim.dt)
        self.sopts = SolverOpts(dt=cfg.sim.dt, gravity=cfg.sim.gravity,
                                limit_kp=cfg.sim.joint_limit_kp,
                                limit_kd=cfg.sim.joint_limit_kd)
        # contact-point apparent masses probed at the nominal standing pose
        # (host constants, computed on the CPU)
        nominal = dyn.nominal_params(self.model).replace(armature=torch.tensor(
            [(a + b) / 2 for a, b in cfg.domain_rand.joint_armature_ranges], dtype=torch.float32))
        ncp = self.model.ncp
        probe_state = PhysicsState(
            base_pos=torch.tensor([0.0, 0.0, 0.95]), base_quat=torch.tensor([1.0, 0, 0, 0]),
            base_vel=torch.zeros(6), qpos=self.default_dof_pos.cpu(),
            qvel=torch.zeros(self.num_actions), cp_anchor=torch.zeros((ncp, 3)))
        cp_meff = probe_contact_masses(self.model, nominal, probe_state)
        # divide by the static per-body point count once more: all points of a
        # body push it at once, so the collective implicit solve stays
        # conservative (the JAX env's rule, t1_dh_stand.py:152-174)
        counts = np.bincount(self.model.cp_body, minlength=self.model.nb).astype(np.float32)
        self.cp_meff = (cp_meff / counts[self.model.cp_body][:, None]).astype(np.float32)

        self.reward_names = tuple(n for n, s in cfg.rewards.scales if s != 0)
        self.reward_scales_dt = {n: s * self.dt for n, s in cfg.rewards.scales if s != 0}
        self.n_rewards = len(self.reward_names)
        self._reward_scales = _f32([self.reward_scales_dt[n] for n in self.reward_names], dev)

        ns = cfg.noise.noise_scales
        nv = np.zeros(cfg.env.num_single_obs, np.float32)
        nc, na = cfg.env.num_commands, self.num_actions
        nv[nc:nc + na] = ns.dof_pos * os_.dof_pos
        nv[nc + na:nc + 2 * na] = ns.dof_vel * os_.dof_vel
        nv[nc + 3 * na:nc + 3 * na + 3] = ns.ang_vel * os_.ang_vel
        nv[nc + 3 * na + 3:nc + 3 * na + 6] = ns.quat * os_.quat
        self.noise_scale_vec = _f32(nv, dev)

        self.push_interval = int(np.ceil(cfg.domain_rand.push_interval_s / self.dt))
        self.ext_force_interval = int(np.ceil(cfg.domain_rand.ext_force_interval_s / self.dt))
        self.priv_frame_dim = (cfg.env.single_num_privileged_obs
                               + (cfg.terrain.num_height_points
                                  if cfg.terrain.measure_heights else 0))
        gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                             np.asarray(cfg.terrain.measured_points_y), indexing="ij")
        self.height_points = _f32(
            np.stack([gx.ravel(), gy.ravel(), np.zeros_like(gx).ravel()], -1), dev)

        dr = cfg.domain_rand
        # the kernel runs for envs on a card; CPU envs take the per-substep
        # loop unless sim.megakernel_interpret sends them through the kernel
        # path's plain version; per-substep action-lag re-draws need the loop
        self.use_kernel_path = (
            getattr(cfg.sim, "megakernel", True)
            and not (dr.add_lag and dr.randomize_lag_timesteps_perstep)
            and (dev.type == "cuda" or getattr(cfg.sim, "megakernel_interpret", False)))

    def _max_cp_reach(self) -> float:
        """Upper bound on |collision point - base| over all joint configs."""
        m = self.model
        depth = np.zeros(m.nb, np.float64)
        for i in range(1, m.nb):
            depth[i] = depth[m.parent[i]] + float(np.linalg.norm(m.joint_pos[i]))
        cp_norm = np.linalg.norm(m.cp_pos, axis=-1)
        return float(np.max(depth[m.cp_body] + cp_norm))

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def init_state(self, seed: int = 0) -> EnvState:
        cfg, n, na, dev = self.cfg, self.num_envs, self.num_actions, self.device
        nb, ncp = self.model.nb, self.model.ncp
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731

        dparams, friction, body_mass, restitution = legged.sample_rigid_body_params(
            cfg, self.model, gen, n)
        p, d, offs, coul, visc, arm = legged.sample_dof_params(
            cfg, gen, n, self.p_gains_nom, self.d_gains_nom)
        lag, dof_lag, imu_lag, dp_lag, dv_lag = legged.sample_lag_steps(cfg, gen, n)
        params = EnvParams(
            dynamics=dparams.replace(armature=arm), friction=friction,
            restitution=restitution, body_mass=body_mass, p_gains=p, d_gains=d,
            motor_offsets=offs, joint_coulomb=coul, joint_viscous=visc, lag_steps=lag,
            dof_lag_steps=dof_lag, imu_lag_steps=imu_lag, dof_pos_lag_steps=dp_lag,
            dof_vel_lag_steps=dv_lag)

        if self.custom_origins:
            max_init = (cfg.terrain.max_init_terrain_level if cfg.terrain.curriculum
                        else cfg.terrain.num_rows - 1)
            level = legged.randint(gen, (n,), 0, max_init + 1)
            ttype = (torch.arange(n, device=dev) // max(n / cfg.terrain.num_cols, 1)).to(torch.int32)
            ttype = torch.clamp(ttype, 0, cfg.terrain.num_cols - 1)
            origin = legged.origin_at(self.terrain_origins, level, ttype)
        else:
            level = torch.zeros((n,), dtype=torch.int32, device=dev)
            ttype = torch.zeros((n,), dtype=torch.int32, device=dev)
            ncols = int(np.floor(np.sqrt(n)))
            xx, yy = torch.meshgrid(torch.arange((n + ncols - 1) // ncols, device=dev),
                                    torch.arange(ncols, device=dev), indexing="ij")
            origin = torch.stack([cfg.env.env_spacing * xx.reshape(-1)[:n],
                                  cfg.env.env_spacing * yy.reshape(-1)[:n],
                                  torch.zeros(n, device=dev)], -1).to(torch.float32)

        phys = PhysicsState(
            base_pos=_f32(cfg.init_state.pos, dev) + origin,
            base_quat=_f32([1.0, 0, 0, 0], dev).expand(n, 4).clone(),
            base_vel=zeros(n, 6), qpos=self.default_dof_pos.expand(n, na).clone(),
            qvel=zeros(n, na), cp_anchor=zeros(n, ncp, 3))

        dr = cfg.domain_rand
        L = dr.lag_timesteps_range[1] + 1
        Ld = dr.dof_lag_timesteps_range[1] + 1
        if dr.add_dof_pos_vel_lag:
            Ld = max(Ld, dr.dof_pos_lag_timesteps_range[1] + 1,
                     dr.dof_vel_lag_timesteps_range[1] + 1)
        Li = dr.imu_lag_timesteps_range[1] + 1
        state = EnvState(
            phys=phys, params=params, rng=gen, terrain_height=self.heightfield.height,
            episode_length=torch.zeros((n,), dtype=torch.int32, device=dev),
            phase_length=torch.zeros((n,), dtype=torch.int32, device=dev),
            gait_start=legged.randint(gen, (n,), 0, 2).to(torch.float32) * 0.5,
            gait_time=torch.zeros((n, len(cfg.commands.gait)), dtype=torch.int32, device=dev),
            commands=zeros(n, 4),
            common_step=torch.zeros((), dtype=torch.int32, device=dev),
            terrain_level=level, terrain_type=ttype, env_origin=origin,
            cmd_vx_range=_f32(cfg.commands.ranges.lin_vel_x, dev),
            actions=zeros(n, na), last_actions=zeros(n, na), last_last_actions=zeros(n, na),
            torques=zeros(n, na), last_dof_vel=zeros(n, na), last_root_vel=zeros(n, 6),
            lag_buffer=zeros(n, na, L), dof_lag_buffer=zeros(n, 2 * na, Ld),
            imu_lag_buffer=zeros(n, 6, Li), contact_forces=zeros(n, nb, 3),
            feet_air_time=zeros(n, 2),
            last_contacts=torch.zeros((n, 2), dtype=torch.bool, device=dev),
            feet_height=zeros(n, 2), last_feet_z=zeros(n, 2),
            ref_dof_pos=self.default_dof_pos.expand(n, na).clone(), ref_action=zeros(n, na),
            push_force=zeros(n, 3), push_torque=zeros(n, 3), ext_force=zeros(n, 3),
            ext_torque=zeros(n, 3), ext_force_apply=zeros(n, 3), ext_torque_apply=zeros(n, 3),
            is_first_push=torch.tensor(True, device=dev),
            is_first_add_force=torch.tensor(True, device=dev),
            obs_hist=torch.zeros((n, cfg.env.frame_stack * cfg.env.num_single_obs),
                                 dtype=torch.bfloat16, device=dev),
            critic_hist=torch.zeros((n, cfg.env.c_frame_stack * self.priv_frame_dim),
                                    dtype=torch.bfloat16, device=dev),
            episode_sums=zeros(n, self.n_rewards),
            reset_buf=torch.zeros((n,), dtype=torch.bool, device=dev),
            time_out_buf=torch.zeros((n,), dtype=torch.bool, device=dev),
        )
        state = self._generate_gait_time(state, torch.ones((n,), dtype=torch.bool, device=dev))
        return self._resample_gait_commands(state)

    def reset(self, state: EnvState):
        """Reset all envs, then one zero-action step gives the first
        observations."""
        n = state.episode_length.shape[0]
        state = self._reset_idx(state, torch.ones((n,), dtype=torch.bool, device=self.device),
                                force_all=True)
        state, obs, priv, _, _, _ = self.step(
            state, torch.zeros((n, self.num_actions), device=self.device))
        return state, obs, priv

    # ------------------------------------------------------------------
    # gait phase machinery
    # ------------------------------------------------------------------

    def _stand_command(self, commands):
        return torch.linalg.norm(commands[:, :3], dim=-1) <= self.cfg.commands.stand_com_threshold

    def _phase(self, state: EnvState, phase_length):
        cyc = self.cfg.rewards.cycle_time
        if self.cfg.commands.sw_switch:
            stand = self._stand_command(state.commands)
            return (torch.remainder(phase_length * self.dt / cyc, 1.0) + state.gait_start) * (~stand)
        return torch.remainder(state.episode_length * self.dt / cyc, 1.0) + state.gait_start

    def _gait_stance_mask(self, phase):
        sin_pos = torch.sin(2 * math.pi * phase)
        left = (sin_pos >= 0).to(torch.float32)
        stance = torch.stack([left, 1.0 - left], -1)
        return torch.where((torch.abs(sin_pos) < 0.1)[:, None], 1.0, stance)

    def _compute_ref_state(self, state: EnvState, phase):
        scale_1 = self.cfg.rewards.target_joint_pos_scale
        scale_2 = 2 * scale_1
        sin_pos = torch.sin(2 * math.pi * phase)
        sin_l = torch.clamp_max(sin_pos, 0.0)
        sin_r = torch.clamp_min(sin_pos, 0.0)
        ref = torch.zeros((sin_pos.shape[0], self.num_actions), device=self.device)
        ref[:, 2] = sin_l * scale_1
        ref[:, 3] = -sin_l * scale_2
        ref[:, 4] = sin_l * scale_1
        ref[:, 8] = -sin_r * scale_1
        ref[:, 9] = sin_r * scale_2
        ref[:, 10] = -sin_r * scale_1
        ref = torch.where((torch.abs(sin_pos) < 0.1)[:, None], 0.0, ref)
        return ref + self.default_dof_pos, 2.0 * ref

    def _generate_gait_time(self, state: EnvState, mask):
        """Random segmentation of the episode into gait phases."""
        cfg = self.cfg.commands
        n = state.gait_time.shape[0]
        ranges = _f32(cfg.gait_time_range, self.device)
        r = legged.uniform(state.rng, (n, len(cfg.gait)), ranges[:, 0], ranges[:, 1])
        scaled = r * (self.max_episode_length / torch.sum(r, dim=1, keepdim=True))
        shifted = torch.cat([torch.zeros((n, 1), device=self.device), scaled[:, :-1]], dim=1)
        gait_time = torch.cumsum(shifted, dim=1).to(torch.int32)
        return state.replace(gait_time=torch.where(mask[:, None], gait_time, state.gait_time))

    def _resample_gait_commands(self, state: EnvState) -> EnvState:
        """At each segment boundary, resample the command per the segment's
        gait type."""
        cfg = self.cfg.commands
        n, gen, dev = state.commands.shape[0], state.rng, self.device
        cmds = state.commands
        z = torch.zeros(n, device=dev)
        for i, name in enumerate(cfg.gait):
            mask = state.episode_length == state.gait_time[:, i]
            vx = legged.uniform(gen, (n,), state.cmd_vx_range[0], state.cmd_vx_range[1])
            vy = legged.uniform(gen, (n,), *cfg.ranges.lin_vel_y)
            wz = legged.uniform(gen, (n,), *cfg.ranges.ang_vel_yaw)
            h = legged.uniform(gen, (n,), *cfg.ranges.heading)
            if name == "stand":
                new = torch.stack([z, z, z], -1)
            elif name == "walk_sagittal":
                new = torch.stack([vx, z, z], -1)
            elif name == "walk_lateral":
                new = torch.stack([z, vy, z], -1)
            elif name == "rotate":
                new = torch.stack([z, z, wz], -1)
            else:  # walk_omnidirectional
                new = torch.stack([vx, vy, wz], -1)
            if cfg.heading_command and name != "stand":
                # heading mode: sample a world-frame heading target; the yaw
                # rate is recomputed from the heading error every step
                new4 = torch.cat([new[:, :2], z[:, None], h[:, None]], -1)
            else:
                new4 = torch.cat([new, cmds[:, 3:]], -1)
            cmds = torch.where(mask[:, None], new4, cmds)
        return state.replace(commands=cmds)

    # ------------------------------------------------------------------
    # perturbation events
    # ------------------------------------------------------------------

    def _events(self, state: EnvState) -> EnvState:
        dr = self.cfg.domain_rand
        n, gen = state.commands.shape[0], state.rng
        if dr.push_robots:
            i = torch.clamp_max(state.common_step // dr.update_step, len(dr.push_duration) - 1)
            duration = _f32(dr.push_duration, self.device)[i.long()] / self.dt
            window = (state.common_step % self.push_interval) <= duration
            force = legged.uniform(gen, (n, 2), -dr.max_push_vel_xy, dr.max_push_vel_xy)
            torque = legged.uniform(gen, (n, 3), -dr.max_push_ang_vel, dr.max_push_ang_vel)
            push_force = torch.where(window, torch.cat([force, state.push_force[:, 2:]], -1), 0.0)
            push_torque = torch.where(window, torque, 0.0)
            # velocity set (not impulse): overwrite world lin xy and ang vel
            linv, angv = root_world_vel(state.phys)
            linv = torch.where(window, torch.cat([push_force[:, :2], linv[:, 2:]], -1), linv)
            angv = torch.where(window, push_torque, angv)
            state = state.replace(phys=set_root_world_vel(state.phys, linv, angv),
                                  push_force=push_force, push_torque=push_torque,
                                  is_first_push=~window)
        if dr.add_ext_force:
            i = torch.clamp_max(state.common_step // dr.add_update_step, len(dr.add_duration) - 1)
            duration = _f32(dr.add_duration, self.device)[i.long()] / self.dt
            window = (state.common_step % self.ext_force_interval) <= duration
            fx = legged.uniform(gen, (n, 1), -dr.ext_force_max_x / 2, dr.ext_force_max_x)
            fy = legged.uniform(gen, (n, 1), -dr.ext_force_max_y, dr.ext_force_max_y)
            fz = legged.uniform(gen, (n, 1), -dr.ext_force_max_z, dr.ext_force_max_z)
            new_force = torch.cat([fx, fy, fz], -1)
            new_torque = legged.uniform(gen, (n, 3), -dr.ext_torque_max, dr.ext_torque_max)
            sample_now = window & state.is_first_add_force
            ext_force = torch.where(window, torch.where(sample_now, new_force, state.ext_force), 0.0)
            ext_torque = torch.where(window, torch.where(sample_now, new_torque, state.ext_torque), 0.0)
            # applied from the second window step on, to standing envs only,
            # for one substep (the first of the next policy step)
            stand = self._stand_command(state.commands)[:, None]
            on = window & ~state.is_first_add_force
            state = state.replace(
                ext_force=ext_force, ext_torque=ext_torque,
                ext_force_apply=torch.where(on, ext_force * stand, 0.0),
                ext_torque_apply=torch.where(on, ext_torque * stand, 0.0),
                is_first_add_force=~window)
        return state

    # ------------------------------------------------------------------
    # the step pipeline
    # ------------------------------------------------------------------

    def step(self, state: EnvState, actions: torch.Tensor):
        cfg = self.cfg
        if cfg.env.use_ref_actions:
            actions = actions + state.ref_action
        clip_a = cfg.normalization.clip_actions
        actions = torch.clamp(actions.to(torch.float32), -clip_a, clip_a)
        state = state.replace(actions=actions)

        # record_function spans name the step's phases in a torch.profiler
        # trace (scripts/profile_rollout.py); without a profiler they cost
        # about a microsecond each
        with record_function("env.contact_cells"):
            cells = self.contact_cells(state)
        kin_rows = None
        if self.use_kernel_path:
            phys, lagb, dof_lagb, imu_lagb, torques, cforces, kin_rows = \
                self._decimation_megakernel(state, actions, cells)
            state = state.replace(phys=phys, lag_buffer=lagb, dof_lag_buffer=dof_lagb,
                                  imu_lag_buffer=imu_lagb, torques=torques,
                                  contact_forces=cforces)
        else:
            with record_function("env.decimation_loop"):
                state = self._decimation_loop(state, actions, cells)
        with record_function("env.post_physics"):
            state, obs, priv_obs, rew, extras = self._post_physics_step(state, kin_rows=kin_rows)
        return state, obs, priv_obs, rew, state.reset_buf, extras

    def contact_cells(self, state: EnvState):
        """Frozen-cell contact: each point's bilinear terrain cell, picked once
        per policy step ([ncp, N] fields)."""
        px0, py0 = contact_point_xy(self.model, state.phys)
        if self.terrain is None:
            return flat_cell_cache(px0, py0)
        return gather_cells_supercell(self.supertable, state.phys.base_pos[:, 0],
                                      state.phys.base_pos[:, 1], px0, py0)

    def _decimation_loop(self, state: EnvState, actions, cells) -> EnvState:
        """Per-substep path (the JAX ``lax.scan`` path, ``:570-612``)."""
        cfg, dr = self.cfg, self.cfg.domain_rand
        params = state.params
        phys, lagb = state.phys, state.lag_buffer
        dof_lagb, imu_lagb = state.dof_lag_buffer, state.imu_lag_buffer
        lag_steps, torques, cforces = params.lag_steps, state.torques, state.contact_forces
        for idx in range(cfg.control.decimation):
            torques, lagb, lag_steps = legged.compute_torques(
                cfg, params.replace(lag_steps=lag_steps), self.torque_limits,
                self.default_dof_pos, lagb, actions, phys.qpos, phys.qvel, state.rng)
            # the external wrench acts on the first substep only
            on = 1.0 if idx == 0 else 0.0
            phys, cforces = substep_batched(
                self.model, params.dynamics, self.copts, self.sopts, self.heightfield.hscale,
                phys, torques, params.friction, self.cp_meff, cells,
                state.ext_force_apply * on, state.ext_torque_apply * on,
                restitution=params.restitution)
            if dr.add_dof_lag or dr.add_dof_pos_vel_lag:
                dof_lagb = legged.push_ring(dof_lagb, torch.cat([phys.qpos, phys.qvel], -1))
            if dr.add_imu_lag:
                euler = sp.quat_to_euler_xyz(phys.base_quat)
                imu_lagb = legged.push_ring(imu_lagb, torch.cat([phys.base_vel[:, :3], euler], -1))
        return state.replace(phys=phys, lag_buffer=lagb, dof_lag_buffer=dof_lagb,
                             imu_lag_buffer=imu_lagb, torques=torques,
                             params=params.replace(lag_steps=lag_steps),
                             contact_forces=cforces)

    def pack_decimation(self, state: EnvState, actions, cells):
        """Row-major [rows, N] inputs of one decimation and the action ring
        after it: (inputs dict for :func:`run_decimation`, new lag ring)."""
        cfg, dr = self.cfg, self.cfg.domain_rand
        mc, dec = self.mc, cfg.control.decimation
        nd, nb, ncp = mc.nd, mc.nb, mc.ncp
        n, dev = actions.shape[0], self.device
        phys, params = state.phys, state.params
        dyn_p = params.dynamics

        def rows(*xs):
            return torch.cat(xs, dim=-1).T.contiguous()

        state_rows = rows(phys.base_pos, phys.base_quat, phys.base_vel, phys.qpos, phys.qvel)
        anchor_rows = phys.cp_anchor.permute(2, 1, 0).reshape(3 * ncp, n).contiguous()
        cell_rows = torch.cat([cells.x0, cells.y0, cells.h00, cells.h10, cells.h01, cells.h11],
                              dim=0).contiguous()
        dyn_rows = rows(dyn_p.mass, dyn_p.com.reshape(n, 3 * nb),
                        dyn_p.inertia.reshape(n, 9 * nb), dyn_p.armature,
                        params.friction[:, None], params.restitution[:, None])
        ctrl_rows = rows(params.p_gains, params.d_gains, params.motor_offsets,
                         params.joint_coulomb, params.joint_viscous)

        a_scaled = actions * cfg.control.action_scale                 # [N, nd]
        if dr.add_lag:
            lagged_rows, new_lagb = legged.resolve_action_lag(
                a_scaled, state.lag_buffer, params.lag_steps, dec)
        else:
            lagged_rows, new_lagb = rows(*([a_scaled] * dec)), state.lag_buffer
        if dr.randomize_torque:
            lo, hi = dr.torque_multiplier_range
            noise_rows = legged.uniform(state.rng, (dec * nd, n), lo, hi)
        else:
            noise_rows = torch.ones((dec * nd, n), device=dev)
        extw_rows = rows(state.ext_force_apply, state.ext_torque_apply)
        inputs = dict(state_rows=state_rows, anchor_rows=anchor_rows, cell_rows=cell_rows,
                      dyn_rows=dyn_rows, ctrl_rows=ctrl_rows, lagged_rows=lagged_rows,
                      noise_rows=noise_rows, extw_rows=extw_rows)
        return inputs, new_lagb

    def decimation_args(self) -> dict:
        """The static arguments of :func:`run_decimation` for this env."""
        dr = self.cfg.domain_rand
        return dict(mc=self.mc, hscale=self.heightfield.hscale, copts=self.copts,
                    sopts=self.sopts, decimation=self.cfg.control.decimation,
                    default_q=np.asarray(self.cfg.init_state.default_joint_angles, np.float32),
                    torque_limits=(self.model.dof_effort * self.cfg.safety.torque_limit
                                   ).astype(np.float32),
                    cp_meff=self.cp_meff, use_coulomb=dr.randomize_coulomb_friction,
                    use_noise=dr.randomize_torque, feet_bodies=list(self.model.feet_bodies),
                    knee_bodies=list(self.model.knee_bodies))

    def _decimation_megakernel(self, state: EnvState, actions, cells):
        """Pack, one kernel launch for the whole decimation, unpack, and
        rebuild the sensor lag rings from the per-substep snapshots (the JAX
        kernel path, ``:619-750``)."""
        n = actions.shape[0]
        with record_function("env.pack"):
            inputs, new_lagb = self.pack_decimation(state, actions, cells)
        with record_function("env.decimation_kernel"):
            st, an, fo, tq, ds, iss, cx = run_decimation(**self.decimation_args(), **inputs)
        with record_function("env.unpack"):
            return self._unpack_decimation(state, new_lagb, n, st, an, fo, tq, ds, iss, cx)

    def _unpack_decimation(self, state, new_lagb, n, st, an, fo, tq, ds, iss, cx):
        """Kernel rows back to [N, ...] tensors; the sensor lag rings rebuilt
        from the per-substep snapshots."""
        dr, dec = self.cfg.domain_rand, self.cfg.control.decimation
        nd, nb, ncp = self.mc.nd, self.mc.nb, self.mc.ncp
        stT = st.T
        phys = state.phys.replace(
            base_pos=stT[:, 0:3], base_quat=stT[:, 3:7], base_vel=stT[:, 7:13],
            qpos=stT[:, 13:13 + nd], qvel=stT[:, 13 + nd:13 + 2 * nd],
            cp_anchor=an.reshape(3, ncp, n).permute(2, 1, 0))
        cforces = fo.T.reshape(n, nb, 3)
        torques = tq.T

        # lag rings: snapshots are newest last; ring index 0 is the newest
        dof_lagb = state.dof_lag_buffer
        if dr.add_dof_lag or dr.add_dof_pos_vel_lag:
            Ld = dof_lagb.shape[-1]
            snaps = ds.T.reshape(n, dec, 2 * nd).flip(1).transpose(1, 2)   # [N, 24, dec]
            dof_lagb = torch.cat([snaps[..., :min(dec, Ld)], dof_lagb[..., :max(Ld - dec, 0)]], -1)
        imu_lagb = state.imu_lag_buffer
        if dr.add_imu_lag:
            Li = imu_lagb.shape[-1]
            snaps = iss.T.reshape(n, dec, 7)
            euler = sp.quat_to_euler_xyz(snaps[..., 3:7])
            snaps = torch.cat([snaps[..., :3], euler], -1).flip(1).transpose(1, 2)
            imu_lagb = torch.cat([snaps[..., :min(dec, Li)], imu_lagb[..., :max(Li - dec, 0)]], -1)
        return phys, new_lagb, dof_lagb, imu_lagb, torques, cforces, cx

    def _make_ctx(self, state: EnvState, kin_rows=None, phys_for_kin=None) -> StepCtx:
        model = self.model
        feet = list(model.feet_bodies)
        n = state.phys.base_pos.shape[0]
        if kin_rows is not None:
            # feet/knee kinematics emitted by the kernel: FK of the pre-event
            # post-step state (engine_core.ctx_row_layout rows)
            k2 = kin_rows
            nf, nk = len(feet), len(model.knee_bodies)
            lo = ctx_row_layout(nf, nk)
            feet_pos = torch.stack([k2[lo["pos"] + 3 * f: lo["pos"] + 3 * f + 3].T
                                    for f in range(nf)], dim=-2)
            eulers = []
            for f in range(nf):
                r00, r10, r20, r21, r22 = (k2[lo["rot"] + 5 * f + i] for i in range(5))
                eulers.append(torch.stack([torch.atan2(r21, r22),
                                           torch.asin(torch.clamp(-r20, -1.0, 1.0)),
                                           torch.atan2(r10, r00)], -1))
            feet_euler = torch.stack(eulers, -2)
            feet_angvel_xy = torch.stack([k2[lo["angvel"] + 2 * f: lo["angvel"] + 2 * f + 2].T
                                          for f in range(nf)], -2)
            knee_xy = torch.stack([k2[lo["knee"] + 2 * q: lo["knee"] + 2 * q + 2].T
                                   for q in range(nk)], -2)
        else:
            k = ctx_kinematics(model, phys_for_kin if phys_for_kin is not None else state.phys)
            feet_pos, feet_euler = k["feet_pos"], k["feet_euler"]
            feet_angvel_xy, knee_xy = k["feet_angvel_xy"], k["knee_xy"]
        # root velocity from the live (post-event) state
        root_vel_world = self._root_vel_world(state)
        grav = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand(n, 3)
        return StepCtx(
            base_lin_vel=state.phys.base_vel[:, 3:], base_ang_vel=state.phys.base_vel[:, :3],
            base_euler=sp.quat_to_euler_xyz(state.phys.base_quat),
            projected_gravity=sp.quat_rotate_inverse(state.phys.base_quat, grav),
            root_vel_world=root_vel_world, feet_pos=feet_pos, feet_euler=feet_euler,
            feet_angvel_xy=feet_angvel_xy, knee_xy=knee_xy,
            contact=state.contact_forces[:, feet, 2] > 5.0,
            stand_command=self._stand_command(state.commands))

    def _post_physics_step(self, state: EnvState, kin_rows=None):
        cfg = self.cfg
        state = state.replace(episode_length=state.episode_length + 1,
                              common_step=state.common_step + 1,
                              phase_length=state.phase_length + 1)
        state = self._resample_gait_commands(state)
        if cfg.commands.heading_command:
            n = state.commands.shape[0]
            fwd = sp.quat_rotate(state.phys.base_quat,
                                 torch.tensor([1.0, 0.0, 0.0], device=self.device).expand(n, 3))
            heading = torch.atan2(fwd[:, 1], fwd[:, 0])
            wz = torch.clamp(0.5 * sp.wrap_to_pi(state.commands[:, 3] - heading), -1.0, 1.0)
            state = state.replace(commands=torch.cat(
                [state.commands[:, :2], wz[:, None], state.commands[:, 3:]], -1))
        if cfg.commands.sw_switch:
            stand = self._stand_command(state.commands)
            state = state.replace(phase_length=torch.where(stand, 0, state.phase_length))
        # the feet/knee reward context sees the pre-event physics
        pre_event_phys = state.phys
        state = self._events(state)
        ctx = self._make_ctx(state, kin_rows=kin_rows, phys_for_kin=pre_event_phys)

        term = list(self.model.termination_bodies)
        contact_term = torch.any(
            torch.linalg.norm(state.contact_forces[:, term], dim=-1) > 1.0, dim=-1)
        time_out = state.episode_length > self.max_episode_length
        reset_buf = contact_term | time_out
        state = state.replace(reset_buf=reset_buf, time_out_buf=time_out)

        state, rew = self._compute_rewards(state, ctx)
        extras = self._build_extras(state, reset_buf)
        state = self._reset_idx(state, reset_buf)
        state, obs, priv_obs = self._compute_observations(state)
        state = state.replace(
            last_last_actions=state.last_actions, last_actions=state.actions,
            last_dof_vel=torch.where(reset_buf[:, None], 0.0, state.phys.qvel),
            last_root_vel=self._root_vel_world(state))
        return state, obs, priv_obs, rew, extras

    def _root_vel_world(self, state: EnvState):
        lin, ang = root_world_vel(state.phys)
        return torch.cat([lin, ang], -1)

    # ------------------------------------------------------------------
    # rewards
    # ------------------------------------------------------------------

    def _compute_rewards(self, state: EnvState, ctx: StepCtx):
        R = self.cfg.rewards
        dev = self.device
        q, dq, cmds = state.phys.qpos, state.phys.qvel, state.commands
        stand = ctx.stand_command
        phase = self._phase(state, state.phase_length)
        stance_mask = self._gait_stance_mask(phase)
        norm = lambda x: torch.linalg.norm(x, dim=-1)  # noqa: E731
        values: Dict[str, torch.Tensor] = {}

        target = torch.where(stand[:, None], self.default_dof_pos, state.ref_dof_pos)
        diff_n = norm(q - target)
        r = torch.exp(-2.0 * diff_n) - 0.2 * torch.clamp(diff_n, 0.0, 0.5)
        values["joint_pos"] = torch.where(stand, 1.0, r)

        def dist_band(xy, dmin, dmax):
            d = norm(xy[:, 0] - xy[:, 1])
            d_min = torch.clamp(d - dmin, -0.5, 0.0)
            d_max = torch.clamp(d - dmax, 0.0, 0.5)
            return (torch.exp(-torch.abs(d_min) * 100) + torch.exp(-torch.abs(d_max) * 100)) / 2.0

        values["feet_distance"] = dist_band(ctx.feet_pos[..., :2], R.foot_min_dist, R.foot_max_dist)
        values["knee_distance"] = dist_band(ctx.knee_xy, R.knee_min_dist, R.knee_max_dist)

        slip = torch.sqrt(norm(ctx.feet_angvel_xy))
        values["foot_slip"] = torch.sum(slip * ctx.contact, dim=-1)

        stance_or = torch.where((norm(cmds[:, :3]) < 0.05)[:, None], 1.0, stance_mask)
        contact_filt = ctx.contact | (stance_or > 0.5) | state.last_contacts
        first_contact = (state.feet_air_time > 0.0) * contact_filt
        feet_air_time = state.feet_air_time + self.dt
        values["feet_air_time"] = torch.sum(
            torch.clamp(feet_air_time, 0.0, 0.5) * first_contact, dim=-1)
        feet_air_time = feet_air_time * (~contact_filt)
        state = state.replace(feet_air_time=feet_air_time, last_contacts=ctx.contact)

        stance_eq = torch.where(stand[:, None], 1.0, stance_mask)
        agree = torch.where(ctx.contact == (stance_eq > 0.5), 1.0, -0.3)
        values["feet_contact_number"] = torch.mean(agree, dim=-1)

        quat_mismatch = torch.exp(-torch.sum(torch.abs(ctx.base_euler[:, :2]), dim=-1) * 10)
        orient = torch.exp(-norm(ctx.projected_gravity[:, :2]) * 20)
        values["orientation"] = (quat_mismatch + orient) / 2.0

        feet = list(self.model.feet_bodies)
        fnorm = norm(state.contact_forces[:, feet])
        values["feet_contact_forces"] = torch.sum(
            torch.clamp(fnorm - R.max_contact_force, 0.0, 400.0), dim=-1)

        joint_diff = q - self.default_dof_pos
        yaw_roll = norm(joint_diff[:, [0, 1, 5]]) + norm(joint_diff[:, [6, 7, 11]])
        yaw_roll = torch.clamp(yaw_roll - 0.1, 0.0, 50.0)
        values["default_joint_pos"] = torch.exp(-yaw_roll * 100) - 0.01 * norm(joint_diff)

        stance_sum = torch.sum(stance_mask, dim=-1)
        measured = torch.sum(ctx.feet_pos[..., 2] * stance_mask, dim=-1) / torch.clamp_min(stance_sum, 1e-6)
        base_h = state.phys.base_pos[:, 2] - (measured - 0.05)
        values["base_height"] = torch.exp(-torch.abs(base_h - R.base_height_target) * 100)

        root_acc = state.last_root_vel - ctx.root_vel_world
        values["base_acc"] = torch.exp(-norm(root_acc) * 3)

        lin_mismatch = torch.exp(-torch.square(ctx.base_lin_vel[:, 2]) * 10)
        ang_mismatch = torch.exp(-norm(ctx.base_ang_vel[:, :2]) * 5.0)
        values["vel_mismatch_exp"] = (lin_mismatch + ang_mismatch) / 2.0

        lin_err = norm(cmds[:, :2] - ctx.base_lin_vel[:, :2])
        ang_err = torch.abs(cmds[:, 2] - ctx.base_ang_vel[:, 2])
        values["track_vel_hard"] = ((torch.exp(-lin_err * 10) + torch.exp(-ang_err * 10)) / 2.0
                                    - 0.2 * (lin_err + ang_err))

        sig = R.tracking_sigma
        lin_sq = torch.sum(torch.square(cmds[:, :2] - ctx.base_lin_vel[:, :2]), dim=-1)
        lin_abs = torch.sum(torch.abs(cmds[:, :2] - ctx.base_lin_vel[:, :2]), dim=-1)
        values["tracking_lin_vel"] = torch.where(
            stand, torch.exp(-lin_abs * sig * 2), torch.exp(-lin_sq * sig))
        ang_sq = torch.square(cmds[:, 2] - ctx.base_ang_vel[:, 2])
        ang_abs = torch.abs(cmds[:, 2] - ctx.base_ang_vel[:, 2])
        values["tracking_ang_vel"] = torch.where(
            stand, torch.exp(-ang_abs * sig * 2), torch.exp(-ang_sq * sig))

        feet_z = ctx.feet_pos[..., 2]
        feet_height = state.feet_height + (feet_z - state.last_feet_z)
        rew_pos = ((feet_height > R.target_feet_height)
                   & (feet_height < R.target_feet_height_max)).to(torch.float32)
        values["feet_clearance"] = torch.sum(rew_pos * (1.0 - stance_mask), dim=-1)
        feet_height = feet_height * (~ctx.contact)
        state = state.replace(feet_height=feet_height, last_feet_z=feet_z)

        abs_speed = torch.abs(ctx.base_lin_vel[:, 0])
        abs_cmd = torch.abs(cmds[:, 0])
        too_low = abs_speed < 0.5 * abs_cmd
        too_high = abs_speed > 1.2 * abs_cmd
        desired = ~(too_low | too_high)
        mismatch = torch.sign(ctx.base_lin_vel[:, 0]) != torch.sign(cmds[:, 0])
        r = torch.where(too_low, -1.0, 0.0)
        r = torch.where(desired, 1.2, r)
        r = torch.where(mismatch, -2.0, r)
        values["low_speed"] = r * (abs_cmd > 0.05)

        values["torques"] = torch.sum(torch.square(state.torques), dim=-1)
        values["dof_vel"] = torch.sum(torch.square(dq), dim=-1)
        values["dof_acc"] = torch.sum(torch.square((state.last_dof_vel - dq) / self.dt), dim=-1)

        pen = list(self.model.penalized_bodies)
        values["collision"] = torch.sum(
            (norm(state.contact_forces[:, pen]) > 0.1).to(torch.float32), dim=-1)

        d1 = state.last_actions - state.actions
        d2 = state.actions + state.last_last_actions - 2 * state.last_actions
        values["action_smoothness"] = (torch.sum(torch.square(d1), dim=-1)
                                       + torch.sum(torch.square(d2), dim=-1)
                                       + 0.05 * torch.sum(torch.abs(state.actions), dim=-1))

        w = torch.tensor([2.0, 2.0, 1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 1.0, 1.0], device=dev)
        err = torch.cat([(q - self.default_dof_pos)[:, [0, 1, 2, 3, 5, 6, 7, 8]],
                         ctx.feet_euler[:, :, 1]], dim=-1) * w
        values["stand_still"] = torch.where(stand, torch.exp(-torch.sum(torch.square(err), dim=-1)), 0.0)

        sym_err = q[:, [0, 1, 2, 3]] - q[:, [5, 6, 7, 8]]
        values["stand_sysmetry"] = torch.where(
            stand, torch.exp(-torch.sum(torch.square(sym_err), dim=-1)), 0.0)

        rot = torch.sum(torch.square(ctx.feet_euler[:, :, 1]), dim=-1)
        values["feet_rotation"] = torch.exp(-torch.square(rot))

        values["termination"] = (state.reset_buf & ~state.time_out_buf).to(torch.float32)
        values["feet_stumble"] = torch.any(
            norm(state.contact_forces[:, feet, :2]) > 5 * torch.abs(state.contact_forces[:, feet, 2]),
            dim=-1).to(torch.float32)

        lim = self.dof_vel_limits.clone()
        lim[[4, 9]] = 10.0          # the reference hard-codes the knee limit
        values["dof_vel_limits"] = torch.sum(
            torch.clamp(torch.abs(dq) - lim * R.soft_dof_vel_limit, 0.0, 1.0), dim=-1)

        terms = torch.stack([values[name] for name in self.reward_names], dim=-1)
        terms = terms * self._reward_scales
        rew = torch.sum(terms, dim=-1)
        if R.only_positive_rewards:
            rew = torch.clamp_min(rew, 0.0)
        if "termination" in self.reward_scales_dt:
            rew = rew + values["termination"] * self.reward_scales_dt["termination"]
        state = state.replace(episode_sums=state.episode_sums + terms)
        return state, rew

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------

    def _compute_observations(self, state: EnvState):
        cfg = self.cfg
        dr, os_ = cfg.domain_rand, cfg.normalization.obs_scales
        q, dq = state.phys.qpos, state.phys.qvel
        gen = state.rng

        phase = self._phase(state, state.phase_length)
        ref_dof_pos, ref_action = self._compute_ref_state(state, phase)
        state = state.replace(ref_dof_pos=ref_dof_pos, ref_action=ref_action)

        sin_pos = torch.sin(2 * math.pi * phase)[:, None]
        cos_pos = torch.cos(2 * math.pi * phase)[:, None]
        stance_mask = self._gait_stance_mask(phase)
        feet = list(self.model.feet_bodies)
        contact_mask = (state.contact_forces[:, feet, 2] > 5.0).to(torch.float32)
        command_input = torch.cat([sin_pos, cos_pos, state.commands[:, :3] * self.commands_scale], -1)

        base_euler = sp.quat_to_euler_xyz(state.phys.base_quat)
        if dr.add_ext_force:
            pf = state.ext_force[:, :2] / (dr.ext_force_max_x + 0.1)
            pt = state.ext_torque / (dr.ext_torque_max + 0.1)
        else:
            pf, pt = state.push_force[:, :2], state.push_torque
        priv = [command_input, (q - self.default_dof_pos) * os_.dof_pos, dq * os_.dof_vel,
                state.actions, q - ref_dof_pos, state.phys.base_vel[:, 3:] * os_.lin_vel,
                state.phys.base_vel[:, :3] * os_.ang_vel, base_euler * os_.quat, pf, pt,
                state.params.friction[:, None], state.params.body_mass[:, None] / 30.0,
                stance_mask, contact_mask]
        if cfg.terrain.measure_heights:
            priv.append(torch.clamp(state.phys.base_pos[:, 2:3] - 0.5 - self.measured_heights(state),
                                    -1.0, 1.0) * os_.height_measurements)
        priv_frame = torch.cat(priv, -1)

        # actor frame: lagged sensors (per-step lag re-draws clamp at +1)
        params = state.params
        na = self.num_actions
        if dr.add_dof_lag:
            steps = params.dof_lag_steps
            if dr.randomize_dof_lag_timesteps and dr.randomize_dof_lag_timesteps_perstep:
                steps = legged.perstep_lag_update(gen, steps, dr.dof_lag_timesteps_range)
                params = params.replace(dof_lag_steps=steps)
            lagged = legged.read_ring(state.dof_lag_buffer, steps)
            lag_q, lag_dq = lagged[:, :na], lagged[:, na:]
        elif dr.add_dof_pos_vel_lag:
            p_steps, v_steps = params.dof_pos_lag_steps, params.dof_vel_lag_steps
            if dr.randomize_dof_pos_lag_timesteps and dr.randomize_dof_pos_lag_timesteps_perstep:
                p_steps = legged.perstep_lag_update(gen, p_steps, dr.dof_pos_lag_timesteps_range)
                params = params.replace(dof_pos_lag_steps=p_steps)
            if dr.randomize_dof_vel_lag_timesteps and dr.randomize_dof_vel_lag_timesteps_perstep:
                v_steps = legged.perstep_lag_update(gen, v_steps, dr.dof_vel_lag_timesteps_range)
                params = params.replace(dof_vel_lag_steps=v_steps)
            lag_q = legged.read_ring(state.dof_lag_buffer[:, :na], p_steps)
            lag_dq = legged.read_ring(state.dof_lag_buffer[:, na:], v_steps)
        else:
            lag_q, lag_dq = q, dq
        if dr.add_imu_lag:
            steps = params.imu_lag_steps
            if dr.randomize_imu_lag_timesteps and dr.randomize_imu_lag_timesteps_perstep:
                steps = legged.perstep_lag_update(gen, steps, dr.imu_lag_timesteps_range)
                params = params.replace(imu_lag_steps=steps)
            imu = legged.read_ring(state.imu_lag_buffer, steps)
            lag_ang_vel, lag_euler = imu[:, :3], imu[:, 3:]
        else:
            lag_ang_vel, lag_euler = state.phys.base_vel[:, :3], base_euler
        state = state.replace(params=params)

        obs_frame = torch.cat([command_input, (lag_q - self.default_dof_pos) * os_.dof_pos,
                               lag_dq * os_.dof_vel, state.actions, lag_ang_vel * os_.ang_vel,
                               lag_euler * os_.quat], -1)
        if cfg.noise.add_noise:
            noise = 2.0 * torch.rand(obs_frame.shape, generator=gen, device=gen.device) - 1.0
            obs_frame = obs_frame + noise * self.noise_scale_vec * cfg.noise.noise_level

        # clip per frame, then store in bf16: the frame in the history is
        # exactly what the policy consumes
        clip_o = cfg.normalization.clip_observations
        obs_frame = torch.clamp(obs_frame, -clip_o, clip_o).to(torch.bfloat16)
        priv_frame = torch.clamp(priv_frame, -clip_o, clip_o).to(torch.bfloat16)
        k_o, k_p = cfg.env.num_single_obs, self.priv_frame_dim
        obs_hist = torch.cat([state.obs_hist[:, k_o:], obs_frame], dim=1)
        critic_hist = torch.cat([state.critic_hist[:, k_p:], priv_frame], dim=1)
        state = state.replace(obs_hist=obs_hist, critic_hist=critic_hist)
        return state, obs_hist, critic_hist

    def measured_heights(self, state: EnvState) -> torch.Tensor:
        """Yaw-rotated height scan around the base (off for t1)."""
        n, npts = state.phys.base_quat.shape[0], self.height_points.shape[0]
        pts = sp.quat_apply_yaw(state.phys.base_quat[:, None, :].expand(n, npts, 4),
                                self.height_points[None].expand(n, npts, 3))
        pts = pts + state.phys.base_pos[:, None, :]
        return sample_height_min3(self.heightfield.replace(height=state.terrain_height), pts[..., :2])

    # ------------------------------------------------------------------
    # masked reset
    # ------------------------------------------------------------------

    def _reset_idx(self, state: EnvState, done: torch.Tensor, force_all: bool = False) -> EnvState:
        cfg = self.cfg
        n, gen, dev = done.shape[0], state.rng, self.device
        m1 = done[:, None]

        if cfg.terrain.curriculum and self.custom_origins and not force_all:
            level, origin = legged.terrain_curriculum_update(
                cfg, gen, done, state.phys.base_pos[:, :2], state.env_origin, state.commands,
                state.terrain_level, state.terrain_type, self.terrain_origins)
            state = state.replace(terrain_level=level, env_origin=origin)
        if cfg.commands.curriculum and not force_all and "tracking_lin_vel" in self.reward_names:
            t_idx = self.reward_names.index("tracking_lin_vel")
            state = state.replace(cmd_vx_range=legged.command_curriculum_update(
                cfg, done, state.common_step, state.episode_sums[:, t_idx], state.cmd_vx_range,
                float(self.max_episode_length), self.reward_scales_dt["tracking_lin_vel"],
                group=self.group))

        new_q, new_dq = legged.sample_reset_dofs(cfg, gen, n, self.default_dof_pos)
        new_pos = legged.sample_reset_root(cfg, gen, n, state.env_origin, self.custom_origins)
        ph = state.phys
        phys = ph.replace(
            base_pos=torch.where(m1, new_pos, ph.base_pos),
            base_quat=torch.where(m1, torch.tensor([1.0, 0, 0, 0], device=dev), ph.base_quat),
            base_vel=torch.where(m1, 0.0, ph.base_vel),
            qpos=torch.where(m1, new_q, ph.qpos), qvel=torch.where(m1, new_dq, ph.qvel),
            cp_anchor=torch.where(done[:, None, None], 0.0, ph.cp_anchor))

        p, d, offs, coul, visc, arm = legged.sample_dof_params(
            cfg, gen, n, self.p_gains_nom, self.d_gains_nom)
        lag, dof_lag, imu_lag, dp_lag, dv_lag = legged.sample_lag_steps(cfg, gen, n)
        pr = state.params
        params = pr.replace(
            p_gains=torch.where(m1, p, pr.p_gains), d_gains=torch.where(m1, d, pr.d_gains),
            motor_offsets=torch.where(m1, offs, pr.motor_offsets),
            joint_coulomb=torch.where(m1, coul, pr.joint_coulomb),
            joint_viscous=torch.where(m1, visc, pr.joint_viscous),
            lag_steps=torch.where(done, lag, pr.lag_steps),
            dof_lag_steps=torch.where(done, dof_lag, pr.dof_lag_steps),
            imu_lag_steps=torch.where(done, imu_lag, pr.imu_lag_steps),
            dof_pos_lag_steps=torch.where(done, dp_lag, pr.dof_pos_lag_steps),
            dof_vel_lag_steps=torch.where(done, dv_lag, pr.dof_vel_lag_steps),
            dynamics=pr.dynamics.replace(armature=torch.where(m1, arm, pr.dynamics.armature)))

        gait_start = legged.randint(gen, (n,), 0, 2).to(torch.float32) * 0.5
        state = state.replace(
            phys=phys, params=params,
            actions=torch.where(m1, 0.0, state.actions),
            last_actions=torch.where(m1, 0.0, state.last_actions),
            last_last_actions=torch.where(m1, 0.0, state.last_last_actions),
            last_dof_vel=torch.where(m1, 0.0, state.last_dof_vel),
            last_root_vel=torch.where(m1, 0.0, state.last_root_vel),
            feet_air_time=torch.where(m1, 0.0, state.feet_air_time),
            episode_length=torch.where(done, 0, state.episode_length),
            phase_length=torch.where(done, 0, state.phase_length),
            gait_start=torch.where(done, gait_start, state.gait_start),
            lag_buffer=torch.where(done[:, None, None], 0.0, state.lag_buffer),
            dof_lag_buffer=torch.where(done[:, None, None], 0.0, state.dof_lag_buffer),
            imu_lag_buffer=torch.where(done[:, None, None], 0.0, state.imu_lag_buffer),
            obs_hist=torch.where(m1, 0.0, state.obs_hist),
            critic_hist=torch.where(m1, 0.0, state.critic_hist),
            episode_sums=torch.where(m1, 0.0, state.episode_sums))
        state = self._generate_gait_time(state, done)
        return self._resample_gait_commands(state)

    def _build_extras(self, state: EnvState, done) -> Dict[str, torch.Tensor]:
        walked = torch.linalg.norm(state.phys.base_pos[:, :2] - state.env_origin[:, :2], dim=-1)
        extras = {
            "time_outs": state.time_out_buf,
            "done_count": torch.sum(done),
            "episode_sums_done": torch.sum(torch.where(done[:, None], state.episode_sums, 0.0),
                                           dim=0) / self.max_episode_length_s,
            "episode_length_sum": torch.sum(torch.where(done, state.episode_length, 0)),
            "walked_distance_sum": torch.sum(torch.where(done, walked, 0.0)),
            "max_command_x": state.cmd_vx_range[1],
        }
        if self.custom_origins:
            extras["terrain_level_mean"] = torch.mean(state.terrain_level.to(torch.float32))
        return extras
