"""Generic legged-robot machinery (port of ``ti5_isaacgym_tpu/envs/legged.py``).

Batched functions over ``[num_envs, ...]`` tensors: domain-randomization
sampling, the lag rings, the PD torque law with actuator lag, terrain and
command curricula, and reset-state sampling.  Random draws come from an
explicit ``torch.Generator`` on the tensors' device; the numbers differ from
``jax.random``'s, so parity tests switch the draws off or feed them in.
"""
from __future__ import annotations

import torch

from ..configs.t1_dh_stand import T1EnvCfg
from ..physics import dynamics as dyn
from ..physics.model import RobotModel


def uniform(gen: torch.Generator, shape, lo, hi):
    """Uniform draw in [lo, hi) (lo/hi scalars or broadcastable tensors)."""
    return lo + torch.rand(shape, generator=gen, device=gen.device) * (hi - lo)


def randint(gen: torch.Generator, shape, lo: int, hi: int):
    return torch.randint(int(lo), int(hi), shape, generator=gen, device=gen.device,
                         dtype=torch.int64).to(torch.int32)


# ---------------------------------------------------------------------------
# Domain randomization
# ---------------------------------------------------------------------------


def sample_rigid_body_params(cfg: T1EnvCfg, model: RobotModel, gen, n: int):
    """Creation-time randomization: friction/restitution buckets, base payload
    and CoM, link mass scales.  Returns (dynamics params without armature,
    friction, body_mass, restitution)."""
    dr = cfg.domain_rand
    dev = gen.device
    nb = model.nb
    t = model.tensors(dev)
    mass = t["mass"].expand(n, nb).clone()
    com = t["com"].expand(n, nb, 3).clone()
    inertia = t["inertia"].expand(n, nb, 3, 3).clone()

    if dr.randomize_base_mass:
        mass[:, 0] += uniform(gen, (n,), *dr.added_mass_range)
    if dr.randomize_link_mass:
        scale = uniform(gen, (n, nb - 1), *dr.added_link_mass_range)
        mass[:, 1:] *= scale
        inertia[:, 1:] *= scale[..., None, None]
    if dr.randomize_com:
        r = torch.tensor(dr.com_displacement_range, dtype=torch.float32, device=dev)
        com[:, 0, :] += uniform(gen, (n, 3), r[:, 0], r[:, 1])

    if dr.randomize_friction:
        # 256 quantized (friction, restitution) pairs drawn through one bucket id
        num_buckets = 256
        buckets = uniform(gen, (num_buckets,), *dr.friction_range)
        rest_buckets = uniform(gen, (num_buckets,), *dr.restitution_range)
        ids = randint(gen, (n,), 0, num_buckets).long()
        friction, restitution = buckets[ids], rest_buckets[ids]
    else:
        friction = torch.full((n,), cfg.terrain.static_friction, device=dev)
        restitution = torch.full((n,), cfg.terrain.restitution, device=dev)

    params = dyn.DynamicsParams(mass=mass, com=com, inertia=inertia,
                                armature=torch.zeros((n, model.num_dof), device=dev))
    return params, friction, mass[:, 0].clone(), restitution


def sample_dof_params(cfg: T1EnvCfg, gen, n: int, p_gains_nom, d_gains_nom):
    """Per-reset randomization: gains, motor offsets, Coulomb/viscous
    friction, per-joint armature."""
    dr = cfg.domain_rand
    dev = gen.device
    na = p_gains_nom.shape[0]
    if dr.randomize_gains:
        p = uniform(gen, (n, na), *dr.stiffness_multiplier_range) * p_gains_nom
        d = uniform(gen, (n, na), *dr.damping_multiplier_range) * d_gains_nom
    else:
        p = p_gains_nom.expand(n, na).clone()
        d = d_gains_nom.expand(n, na).clone()
    offs = (uniform(gen, (n, na), *dr.motor_offset_range) if dr.randomize_motor_offset
            else torch.zeros((n, na), device=dev))
    if dr.randomize_coulomb_friction:
        coulomb = uniform(gen, (n, na), *dr.joint_coulomb_range)
        viscous = uniform(gen, (n, na), *dr.joint_viscous_range)
    else:
        coulomb = torch.zeros((n, na), device=dev)
        viscous = torch.zeros((n, na), device=dev)
    if dr.randomize_joint_armature:
        if dr.randomize_joint_armature_each_joint:
            r = torch.tensor(dr.joint_armature_ranges, dtype=torch.float32, device=dev)
            arm = uniform(gen, (n, na), r[:, 0], r[:, 1])
        else:
            arm = uniform(gen, (n, 1), *dr.joint_armature_range) * torch.ones((n, na), device=dev)
    else:
        arm = torch.zeros((n, na), device=dev)
    return p, d, offs, coulomb, viscous, arm


def sample_lag_steps(cfg: T1EnvCfg, gen, n: int):
    """(Re)sample every lag index.  Where per-step re-randomization is on, the
    reset value is the range maximum."""
    dr = cfg.domain_rand
    dev = gen.device

    def pick(enabled, randomized, rng_range, perstep=False):
        if not enabled:
            return torch.zeros((n,), dtype=torch.int32, device=dev)
        if perstep or not randomized:
            return torch.full((n,), rng_range[1], dtype=torch.int32, device=dev)
        return randint(gen, (n,), rng_range[0], rng_range[1] + 1)

    lag = pick(dr.add_lag, dr.randomize_lag_timesteps, dr.lag_timesteps_range,
               dr.randomize_lag_timesteps_perstep)
    dof_lag = pick(dr.add_dof_lag, dr.randomize_dof_lag_timesteps,
                   dr.dof_lag_timesteps_range, dr.randomize_dof_lag_timesteps_perstep)
    imu_lag = pick(dr.add_imu_lag, dr.randomize_imu_lag_timesteps,
                   dr.imu_lag_timesteps_range, dr.randomize_imu_lag_timesteps_perstep)
    dof_pos_lag = pick(dr.add_dof_pos_vel_lag, dr.randomize_dof_pos_lag_timesteps,
                       dr.dof_pos_lag_timesteps_range,
                       dr.randomize_dof_pos_lag_timesteps_perstep)
    dof_vel_lag = pick(dr.add_dof_pos_vel_lag, dr.randomize_dof_vel_lag_timesteps,
                       dr.dof_vel_lag_timesteps_range,
                       dr.randomize_dof_vel_lag_timesteps_perstep)
    return lag, dof_lag, imu_lag, dof_pos_lag, dof_vel_lag


def perstep_lag_update(gen, last, rng_range):
    """Per-step lag re-draw with the causality clamp: the index grows by at
    most +1 from the previous step."""
    new = randint(gen, tuple(last.shape), rng_range[0], rng_range[1] + 1)
    return torch.minimum(new, last + 1)


# ---------------------------------------------------------------------------
# Actuation
# ---------------------------------------------------------------------------


def push_ring(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Shift a lag ring buffer [..., C, L]: index 0 is the newest."""
    return torch.cat([new[..., None], buf[..., :-1]], dim=-1)


def read_ring(buf: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Per-env lagged read: buf [..., C, L], steps [...] -> [..., C]."""
    idx = steps.long()[..., None, None].expand(buf.shape[:-1] + (1,))
    return torch.gather(buf, -1, idx)[..., 0]


def resolve_action_lag(a_scaled, lag_buffer, lag_steps, dec: int):
    """The lagged action of every substep of one policy step, resolved ahead
    of the decimation kernel: the pushed action is constant within a policy
    step, so substep ``k`` reads ``a_scaled`` when ``lag <= k`` and else
    ``ring[lag - k - 1]`` (push-then-read at 1 kHz, as :func:`compute_torques`).
    Returns (rows [dec*nd, N] with row ``k*nd + j``, ring after the step)."""
    n, nd, L = lag_buffer.shape
    lag = lag_steps.long()
    ks = torch.arange(dec, device=lag.device)
    idx = torch.clamp(lag[:, None] - (ks[None] + 1), 0, L - 1)          # [N, dec]
    prev = torch.gather(lag_buffer, -1, idx[:, None, :].expand(n, nd, dec))
    rows = torch.cat([torch.where((lag <= k)[:, None], a_scaled, prev[..., k])
                      for k in range(dec)], dim=-1).T.contiguous()
    ring = torch.cat([a_scaled[..., None].expand(n, nd, min(dec, L)),
                      lag_buffer[..., :max(L - dec, 0)]], dim=-1)
    return rows, ring


def compute_torques(cfg: T1EnvCfg, params, torque_limits, default_dof_pos,
                    lag_buffer, actions, qpos, qvel, gen, noise=None):
    """PD torque law with action lag, Coulomb/viscous friction and the
    per-substep torque-multiplier noise.  ``noise`` overrides the draw (tests
    feed both packages the same numbers).  Returns (torques, lag_buffer,
    lag_steps)."""
    dr = cfg.domain_rand
    actions_scaled = actions * cfg.control.action_scale
    lag_steps = params.lag_steps
    if dr.add_lag:
        lag_buffer = push_ring(lag_buffer, actions_scaled)
        if dr.randomize_lag_timesteps and dr.randomize_lag_timesteps_perstep:
            lag_steps = perstep_lag_update(gen, lag_steps, dr.lag_timesteps_range)
        lagged = read_ring(lag_buffer, lag_steps)
    else:
        lagged = actions_scaled
    torques = (params.p_gains * (lagged + default_dof_pos - qpos + params.motor_offsets)
               - params.d_gains * qvel)
    if dr.randomize_coulomb_friction:
        torques = torques - params.joint_viscous * qvel - params.joint_coulomb * torch.sign(qvel)
    if dr.randomize_torque:
        mult = noise if noise is not None else uniform(gen, actions.shape, *dr.torque_multiplier_range)
        torques = torques * mult
    return torch.clamp(torques, -torque_limits, torque_limits), lag_buffer, lag_steps


# ---------------------------------------------------------------------------
# Curricula
# ---------------------------------------------------------------------------


def terrain_curriculum_update(cfg: T1EnvCfg, gen, done, base_xy, env_origin, commands,
                              terrain_level, terrain_type, terrain_origins):
    """Game-inspired terrain curriculum, applied to done envs."""
    max_level = cfg.terrain.num_rows
    distance = torch.linalg.norm(base_xy - env_origin[:, :2], dim=-1)
    move_up = distance > cfg.terrain.terrain_length / 2.0
    cmd_dist = torch.linalg.norm(commands[:, :2], dim=-1) * cfg.env.episode_length_s * 0.5
    move_down = (distance < cmd_dist) & (~move_up)
    new_level = terrain_level + move_up.to(torch.int32) - move_down.to(torch.int32)
    rand_level = randint(gen, tuple(terrain_level.shape), 0, max_level)
    new_level = torch.where(new_level >= max_level, rand_level, torch.clamp_min(new_level, 0))
    new_level = torch.where(done, new_level, terrain_level)
    new_origin = origin_at(terrain_origins, new_level, terrain_type)
    new_origin = torch.where(done[:, None], new_origin, env_origin)
    return new_level, new_origin


def origin_at(terrain_origins, level, ttype):
    """``terrain_origins[level, ttype]`` with the indices clamped into the
    grid, as a JAX gather clamps them."""
    rows, cols = terrain_origins.shape[:2]
    return terrain_origins[torch.clamp(level.long(), 0, rows - 1),
                           torch.clamp(ttype.long(), 0, cols - 1)]


def command_curriculum_update(cfg: T1EnvCfg, done, common_step, episode_sums_tracking,
                              cmd_vx_range, max_episode_length: float,
                              tracking_scale_dt: float, group=None):
    """Widen lin_vel_x when the tracking reward exceeds 80% of its maximum,
    evaluated only when ``common_step % max_episode_length == 0``.  With a
    ``group`` (:class:`~..parallel.trainer.ReduceGroup`) the done count and
    the tracking sum are summed over its ranks first, in one all-reduce (the
    JAX package's ``psum`` over ``axis_name``)."""
    if not cfg.commands.curriculum:
        return cmd_vx_range
    n_done = torch.sum(done)
    track_sum = torch.sum(torch.where(done, episode_sums_tracking, 0.0))
    if group is not None:
        # counts up to 2**24 are exact in float32
        both = group.sum_(torch.stack([n_done.to(torch.float32), track_sum]), "curriculum")
        n_done, track_sum = both[0], both[1]
    mean_track = track_sum / torch.clamp_min(n_done, 1)
    trigger = ((common_step % int(max_episode_length)) == 0) & (n_done > 0)
    improve = (mean_track / max_episode_length) > (0.8 * tracking_scale_dt)
    mc = cfg.commands.max_curriculum
    widened = torch.stack([
        torch.clamp(cmd_vx_range[0] - 0.25, -mc / 2.0, 0.0),
        torch.clamp(cmd_vx_range[1] + 0.5, 0.0, mc),
    ])
    return torch.where(trigger & improve, widened, cmd_vx_range)


# ---------------------------------------------------------------------------
# Reset sampling
# ---------------------------------------------------------------------------


def sample_reset_dofs(cfg: T1EnvCfg, gen, n: int, default_dof_pos):
    q = default_dof_pos + uniform(gen, (n, default_dof_pos.shape[-1]), -0.1, 0.1)
    return q, torch.zeros_like(q)


def sample_reset_root(cfg: T1EnvCfg, gen, n: int, env_origin, custom_origins: bool):
    pos = torch.tensor(cfg.init_state.pos, dtype=torch.float32, device=env_origin.device) + env_origin
    if custom_origins:
        half = (cfg.terrain.platform / 3.0 if cfg.terrain.curriculum
                else cfg.terrain.terrain_length / 2.0)
        jitter = uniform(gen, (n, 2), -half, half)
        pos = torch.cat([pos[:, :2] + jitter, pos[:, 2:]], dim=-1)
    return pos
