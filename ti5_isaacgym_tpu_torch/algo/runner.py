"""On-policy training runner (port of ``ti5_isaacgym_tpu/algo/runner.py``).

One learning iteration is a ``num_steps_per_env``-step rollout through the
env (on a card, one launch of the decimation kernel per step), GAE, and the
epochs x minibatches PPO update; :meth:`OnPolicyRunner.learn` runs
iterations and handles logging and checkpoints.  The iteration is a function
of a :class:`RunnerCarry` (env state, observations, train state, the run's
random generator and the running episode sums) that returns a new carry and
its metrics; nothing in it waits for the device.

Random streams: the carry's three generators are seeded from
``train_cfg.seed`` by one rule, :func:`split_seed` (the three 32-bit words of
``numpy.random.SeedSequence(seed).generate_state(3)``), in place of the JAX
package's ``jax.random.split(key, 3)``: the env's (its ``init_state`` seed,
a generator on the env's device), the network's (the flax-style init, drawn
on the CPU) and the run's (action noise and minibatch permutations, on the
env's device).

Data parallelism (:class:`~..parallel.trainer.ShardedRunner`): the runner's
``group`` makes the iteration average its metrics over the ranks; only the
lead rank (rank 0 of the default process group) writes the console rows,
the CSV, TensorBoard and checkpoints, and its checkpoints hold the learning
state only (params, Adam, lr, iteration), as the JAX package's multi-process
save does.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import time
from collections import deque
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs.t1_dh_stand import T1EnvCfg, T1TrainCfg
from ..utils.checkpoint import refuse_slim
from . import networks as nets
from .ppo import PPO, PPOConfig, TrainState, init_train_state
from .rollout import Transition, compute_gae

# checkpoints at multiples of this iteration count survive pruning
MILESTONE_EVERY = 25000


class RunnerCarry(NamedTuple):
    """The state one training iteration carries to the next."""

    env_state: Any
    obs: torch.Tensor
    priv_obs: torch.Tensor
    ts: TrainState
    rng: torch.Generator
    cur_reward_sum: torch.Tensor   # [N] running episode return
    cur_ep_len: torch.Tensor       # [N]


def split_seed(seed: int):
    """(env seed, network seed, run seed) from one training seed."""
    return tuple(int(s) for s in np.random.SeedSequence(int(seed)).generate_state(3))


def build_network(train_cfg: T1TrainCfg, env_cfg: T1EnvCfg):
    p = train_cfg.policy
    e = env_cfg.env
    name = train_cfg.runner.policy_class_name
    if name == "ActorCriticDH":
        return nets.ActorCriticDH(
            num_actions=e.num_actions, num_short_obs=e.num_short_obs,
            num_single_obs=e.num_single_obs, frame_stack=e.frame_stack,
            num_critic_obs=e.num_privileged_obs, actor_hidden=p.actor_hidden_dims,
            critic_hidden=p.critic_hidden_dims, estimator_hidden=p.state_estimator_hidden_dims,
            filters=p.filter_size, kernels=p.kernel_size, strides=p.stride_size,
            lh_output_dim=p.lh_output_dim, init_noise_std=p.init_noise_std)
    if name == "ActorCritic":
        return nets.ActorCritic(
            num_actions=e.num_actions, num_obs=e.num_observations,
            num_critic_obs=e.num_privileged_obs, actor_hidden=p.actor_hidden_dims,
            critic_hidden=p.critic_hidden_dims, init_noise_std=p.init_noise_std)
    raise ValueError(f"unknown policy class {name}")


def make_ppo(train_cfg: T1TrainCfg, network) -> PPO:
    """The learner of ``train_cfg``'s algorithm section, bound to ``network``."""
    a = train_cfg.algorithm
    cfg = PPOConfig(
        clip_param=a.clip_param, num_learning_epochs=a.num_learning_epochs,
        num_mini_batches=a.num_mini_batches, value_loss_coef=a.value_loss_coef,
        entropy_coef=a.entropy_coef, gamma=a.gamma, lam=a.lam,
        desired_kl=a.desired_kl, max_grad_norm=a.max_grad_norm,
        learning_rate=a.learning_rate, use_clipped_value_loss=a.use_clipped_value_loss,
        schedule=a.schedule,
        estimator_loss=(train_cfg.runner.algorithm_class_name == "DHPPO"),
        lin_vel_idx=a.lin_vel_idx)
    return PPO(cfg, network, dh=(train_cfg.runner.policy_class_name == "ActorCriticDH"))


def to_tensor_dict(x):
    """Dataclasses, dicts and generators -> nested dicts of tensors (a
    generator becomes its state), the form ``torch.save`` stores and
    ``torch.load(..., weights_only=True)`` reads."""
    if dataclasses.is_dataclass(x):
        return {f.name: to_tensor_dict(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: to_tensor_dict(v) for k, v in x.items()}
    if isinstance(x, torch.Generator):
        return x.get_state()
    return x


def from_tensor_dict(template, d, device):
    """The inverse of :func:`to_tensor_dict`, shaped by ``template``."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: from_tensor_dict(getattr(template, f.name), d[f.name], device)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: from_tensor_dict(template[k], d[k], device) for k in template}
    if isinstance(template, torch.Generator):
        gen = torch.Generator(device=template.device)
        gen.set_state(d)
        return gen
    return d.to(device)


def carry_to_dict(carry: RunnerCarry) -> Dict[str, Any]:
    """Everything a carry holds, as nested dicts of tensors.  The
    observations are not stored: they are the env state's histories."""
    return {"ts": to_tensor_dict(carry.ts), "env_state": to_tensor_dict(carry.env_state),
            "rng": carry.rng.get_state(), "cur_reward_sum": carry.cur_reward_sum,
            "cur_ep_len": carry.cur_ep_len}


def mean_metrics(group, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The metrics averaged over ``group``'s ranks in one all-reduce, all
    float32 (the JAX package's ``pmean``: a count such as ``done_count``
    becomes a per-rank mean)."""
    flat = group.mean_(torch.cat([v.reshape(-1).to(torch.float32) for v in metrics.values()]),
                       "metrics")
    sizes = [v.numel() for v in metrics.values()]
    return {k: c.view(v.shape) for (k, v), c in zip(metrics.items(), flat.split(sizes))}


class _HostMetrics:
    """The metrics of one iteration on their way to the host: one copy into
    pinned memory, enqueued after the iteration and waited for only when the
    metrics are read (``depth`` iterations later)."""

    def __init__(self, metrics: Dict[str, torch.Tensor]):
        self.shapes = {k: tuple(v.shape) for k, v in metrics.items()}
        flat = torch.cat([v.reshape(-1).to(torch.float32) for v in metrics.values()])
        self.event = None
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat

    def get(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        out, i, host = {}, 0, self.host.numpy()
        for k, shape in self.shapes.items():
            size = int(np.prod(shape))
            out[k] = host[i:i + size].reshape(shape)
            i += size
        return out


class OnPolicyRunner:
    """Drives collect -> GAE -> update; the DH and vanilla variants share
    this implementation (the network and the algorithm are configuration)."""

    def __init__(self, env, env_cfg: T1EnvCfg, train_cfg: T1TrainCfg,
                 log_dir: Optional[str] = None, seed: Optional[int] = None,
                 verbose: Optional[bool] = None):
        self.env = env
        # a resumed run repeats the original bit for bit only if every kernel
        # of the iteration is deterministic; some of cuDNN's conv backward
        # algorithms sum with atomics (process-wide, like networks.py's TF32)
        torch.backends.cudnn.deterministic = True
        # bring-up timing prints: on for the training CLI (which sets
        # TI5_VERBOSE=1), silent for programmatic construction (tests)
        self.verbose = (os.environ.get("TI5_VERBOSE", "0") == "1"
                        if verbose is None else verbose)
        self.env_cfg = env_cfg
        self.train_cfg = train_cfg
        self.log_dir = log_dir
        self.device = env.device
        self.network = build_network(train_cfg, env_cfg).to(self.device)
        self.network.requires_grad_(False)
        self.alg = make_ppo(train_cfg, self.network)
        self.ppo_cfg = self.alg.cfg
        self.num_steps_per_env = train_cfg.runner.num_steps_per_env
        self.seed = train_cfg.seed if seed is None else seed
        self.iteration_count = 0
        # the lead process logs and checkpoints: rank 0 of the default
        # process group, or the only process
        self.is_lead = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
        self.verbose = self.verbose and self.is_lead
        # the ranks the iteration's metrics are averaged over (None: this
        # process alone); set by parallel.trainer.ShardedRunner
        self.group = None
        self._iter_fn = self._make_iteration()
        self._tb = None
        if log_dir is not None and self.is_lead:
            # TensorBoard scalars for parity with the reference runner;
            # best-effort, the CSV is the canonical log
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"[runner] TensorBoard logging off ({e}); metrics.csv only", flush=True)
            else:
                self._tb = SummaryWriter(log_dir=log_dir, flush_secs=10)

    # ------------------------------------------------------------------

    def init_carry(self) -> RunnerCarry:
        env_seed, net_seed, run_seed = split_seed(self.seed)
        t0 = time.time()
        env_state, obs, priv = self.env.reset(self.env.init_state(env_seed))
        if self.verbose:
            print(f"[runner] env reset in {time.time() - t0:.1f}s", flush=True)
        net_gen = torch.Generator()
        net_gen.manual_seed(net_seed)
        nets.init_like_flax_(self.network, net_gen)
        params = {k: v.detach().clone() for k, v in self.network.named_parameters()}
        rng = torch.Generator(device=self.device)
        rng.manual_seed(run_seed)
        n = obs.shape[0]
        return RunnerCarry(
            env_state=env_state, obs=obs, priv_obs=priv,
            ts=init_train_state(self.ppo_cfg, params), rng=rng,
            cur_reward_sum=torch.zeros((n,), device=self.device),
            cur_ep_len=torch.zeros((n,), device=self.device))

    @torch.no_grad()
    def rollout(self, carry: RunnerCarry):
        """``num_steps_per_env`` steps with the carry's params: (trajectory
        [T, N, ...], the carry after the last step, per-step statistics
        summed over the steps).  Observations are stored as the env's bf16
        histories; rewards carry the timeout bootstrap ``rew + gamma *
        value * time_out``."""
        env, alg, cfg = self.env, self.alg, self.ppo_cfg
        T = self.num_steps_per_env
        params = carry.ts.params
        env_state, obs, priv, rng = carry.env_state, carry.obs, carry.priv_obs, carry.rng
        cur_rew, cur_len = carry.cur_reward_sum, carry.cur_ep_len
        n, dev, na = obs.shape[0], obs.device, self.env_cfg.env.num_actions

        def buf(*shape, dtype=torch.float32):
            return torch.empty((T, n) + shape, dtype=dtype, device=dev)

        traj = Transition(obs=buf(obs.shape[-1], dtype=obs.dtype),
                          critic_obs=buf(priv.shape[-1], dtype=priv.dtype),
                          actions=buf(na), rewards=buf(), dones=buf(dtype=torch.bool),
                          values=buf(), log_probs=buf(), mu=buf(na), sigma=buf(na))
        steps = []
        for t in range(T):
            action, logp, mu, sigma, value = alg.act(params, obs, priv, rng)
            env_state, obs2, priv2, rew, done, extras = env.step(env_state, action)
            for x, v in zip(traj, (obs, priv, action, rew + cfg.gamma * value
                                   * extras["time_outs"].to(torch.float32),
                                   done, value, logp, mu, sigma)):
                x[t] = v
            cur_rew = cur_rew + rew
            cur_len = cur_len + 1.0
            steps.append((torch.sum(torch.where(done, cur_rew, 0.0)),
                          torch.sum(torch.where(done, cur_len, 0.0)),
                          torch.sum(done), extras["episode_sums_done"],
                          extras["walked_distance_sum"]))
            cur_rew = torch.where(done, 0.0, cur_rew)
            cur_len = torch.where(done, 0.0, cur_len)
            obs, priv = obs2, priv2
        ep_rew, ep_len, done_count, sums_done, walked = (torch.stack(s) for s in zip(*steps))
        stats = {
            "ep_reward_sum": ep_rew.sum(), "ep_len_sum": ep_len.sum(),
            "done_count": done_count.sum(), "walked_distance_sum": walked.sum(),
            "episode_sums_done": sums_done.sum(dim=0),
            "max_command_x": extras["max_command_x"],
            "terrain_level_mean": extras.get("terrain_level_mean",
                                             torch.zeros((), device=dev)),
        }
        after = carry._replace(env_state=env_state, obs=obs, priv_obs=priv, rng=rng,
                               cur_reward_sum=cur_rew, cur_ep_len=cur_len)
        return traj, after, stats

    def _make_iteration(self):
        alg, cfg = self.alg, self.ppo_cfg

        def iteration(carry: RunnerCarry, mark=None):
            """One learning iteration: (new carry, metrics).  ``mark(name)``,
            when given, is called after the rollout, GAE and the update."""
            traj, after, stats = self.rollout(carry)
            if mark is not None:
                mark("rollout")
            # bootstrap values with the iteration's starting params
            last_values = alg.value(carry.ts.params, after.priv_obs)
            returns, advantages = compute_gae(traj, last_values, cfg.gamma, cfg.lam,
                                               group=self.group)
            if mark is not None:
                mark("gae")
            ts, metrics = alg.update(carry.ts, traj, returns, advantages, after.rng)
            # estimator-divergence diagnostics on the last rollout obs with
            # the updated params (prediction RMS against target RMS)
            with torch.no_grad():
                if alg.dh:
                    ref_vel = after.priv_obs[..., cfg.lin_vel_idx:cfg.lin_vel_idx + 3].to(
                        torch.float32)
                    est_vel = nets.apply(self.network, ts.params, "estimate_velocity",
                                         after.obs)
                    est_t = torch.sqrt(torch.mean(torch.sum(torch.square(ref_vel), -1)))
                    est_p = torch.sqrt(torch.mean(torch.sum(torch.square(est_vel), -1)))
                else:
                    est_t = est_p = torch.zeros((), device=self.device)
                metrics.update(stats)
                metrics.update({
                    "est_target_norm": est_t, "est_pred_norm": est_p,
                    "mean_step_reward": torch.mean(traj.rewards),
                    "mean_noise_std": torch.mean(torch.abs(ts.params["std"])),
                })
                if self.group is not None:
                    metrics = mean_metrics(self.group, metrics)
            if mark is not None:
                mark("update")
            return after._replace(ts=ts), metrics

        return iteration

    # ------------------------------------------------------------------

    def learn(self, num_iterations: int, carry: Optional[RunnerCarry] = None,
              log_every: int = 10) -> RunnerCarry:
        if carry is None:
            carry = self.init_carry()
        save_interval = self.train_cfg.runner.save_interval
        samples_per_iter = self.env.num_envs * self.num_steps_per_env
        # 100-episode sliding window (the reference's deque(maxlen=100)) over
        # per-iteration (count, reward sum, length sum) triples
        ep_window: deque = deque()
        win_count = win_rew = win_len = 0.0
        t_start = time.time()
        final_it = self.iteration_count + num_iterations
        # metrics are read `depth` iterations late, so the host never waits
        # for the iteration it has just enqueued
        depth = max(0, int(os.environ.get("TI5_LOG_PIPELINE", "4")))
        pending: deque = deque()          # (global iteration, _HostMetrics)
        # fps over a window of consumption timestamps much wider than the
        # pipeline depth, so a stall (a checkpoint) and the burst after it
        # cancel; the first row and the end-of-run drain rows are nan
        t_hist: deque = deque(maxlen=33)
        n_processed = [0]

        def process(git, fetched, steady=True):
            nonlocal win_count, win_rew, win_len
            metrics = fetched.get()
            now = time.time()
            if steady and n_processed[0] > 0:
                t_hist.append(now)
            else:
                t_hist.clear()
                t_hist.append(now)
            if len(t_hist) >= 2:
                dt_iter = max((t_hist[-1] - t_hist[0]) / (len(t_hist) - 1), 1e-9)
            else:
                dt_iter = float("nan")
            n_processed[0] += 1
            d = float(metrics["done_count"])
            ep_window.append((d, float(metrics["ep_reward_sum"]), float(metrics["ep_len_sum"])))
            win_count += d
            win_rew += float(metrics["ep_reward_sum"])
            win_len += float(metrics["ep_len_sum"])
            while len(ep_window) > 1 and win_count - ep_window[0][0] >= 100.0:
                c0, r0, l0 = ep_window.popleft()
                win_count -= c0
                win_rew -= r0
                win_len -= l0
            mean_ep_rew = win_rew / max(win_count, 1)
            mean_ep_len = win_len / max(win_count, 1)
            fps = samples_per_iter / dt_iter
            if self.log_dir and self.is_lead:
                self._log_csv(metrics, mean_ep_rew, mean_ep_len, fps, it=git)
                self._log_tb(metrics, mean_ep_rew, mean_ep_len, fps, it=git)
            if self.is_lead and (git % log_every == 0 or git == final_it):
                print(f"it {git:5d} | fps {fps:9.0f} | "
                      f"rew/step {float(metrics['mean_step_reward']):7.4f} | "
                      f"ep_rew {mean_ep_rew:8.2f} | ep_len {mean_ep_len:7.1f} | "
                      f"vloss {float(metrics['value_loss']):.4f} | "
                      f"sloss {float(metrics['surrogate_loss']):+.4f} | "
                      f"esloss {float(metrics['estimator_loss']):.4f} | "
                      f"kl {float(metrics['kl']):.4f} | lr {float(metrics['lr']):.2e}",
                      flush=True)

        for _ in range(num_iterations):
            carry, metrics = self._iter_fn(carry)
            self.iteration_count += 1
            pending.append((self.iteration_count, _HostMetrics(metrics)))
            while len(pending) > depth:
                process(*pending.popleft())
            if self.log_dir and save_interval and self.iteration_count % save_interval == 0:
                self.save(carry)
        while pending:
            process(*pending.popleft(), steady=False)
        if self.log_dir and save_interval and num_iterations > 0 \
                and self.iteration_count % save_interval != 0:
            # a final checkpoint, so that short runs leave a resumable one
            self.save(carry)
        wall = time.time() - t_start
        if self.is_lead:
            print(f"learn done: {num_iterations} iterations, "
                  f"{num_iterations * samples_per_iter / max(wall, 1e-9):,.0f} env-steps/s avg",
                  flush=True)
        return carry

    # ------------------------------------------------------------------

    def _log_csv(self, metrics, mean_ep_rew, mean_ep_len, fps, it=None):
        path = os.path.join(self.log_dir, "metrics.csv")
        first = not os.path.exists(path)
        os.makedirs(self.log_dir, exist_ok=True)
        row = {
            "iteration": self.iteration_count if it is None else it, "fps": fps,
            "mean_step_reward": float(metrics["mean_step_reward"]),
            "mean_episode_reward": mean_ep_rew,
            "mean_episode_length": mean_ep_len,
            "value_loss": float(metrics["value_loss"]),
            "surrogate_loss": float(metrics["surrogate_loss"]),
            "estimator_loss": float(metrics["estimator_loss"]),
            "kl": float(metrics["kl"]), "lr": float(metrics["lr"]),
            "max_command_x": float(metrics["max_command_x"]),
            "terrain_level": float(metrics["terrain_level_mean"]),
            "est_target_norm": float(metrics["est_target_norm"]),
            "est_pred_norm": float(metrics["est_pred_norm"]),
        }
        n_done = max(float(metrics["done_count"]), 1.0)
        row["walked_distance"] = float(metrics["walked_distance_sum"]) / n_done
        for i, name in enumerate(getattr(self.env, "reward_names", ())):
            row[f"rew_{name}"] = float(metrics["episode_sums_done"][i]) / n_done
        with open(path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if first:
                w.writeheader()
            w.writerow(row)

    def _log_tb(self, metrics, mean_ep_rew, mean_ep_len, fps, it=None):
        """TensorBoard scalars with the reference's writer tags."""
        if self._tb is None:
            return
        if it is None:
            it = self.iteration_count
        w = self._tb
        w.add_scalar("Loss/value_function", float(metrics["value_loss"]), it)
        w.add_scalar("Loss/surrogate", float(metrics["surrogate_loss"]), it)
        w.add_scalar("Loss/estimator", float(metrics["estimator_loss"]), it)
        w.add_scalar("Loss/learning_rate", float(metrics["lr"]), it)
        w.add_scalar("Policy/mean_noise_std", float(metrics["mean_noise_std"]), it)
        w.add_scalar("Policy/kl", float(metrics["kl"]), it)
        w.add_scalar("Loss/est_target_norm", float(metrics["est_target_norm"]), it)
        w.add_scalar("Loss/est_pred_norm", float(metrics["est_pred_norm"]), it)
        if np.isfinite(fps):
            w.add_scalar("Perf/total_fps", fps, it)
        w.add_scalar("Train/mean_reward", mean_ep_rew, it)
        w.add_scalar("Train/mean_episode_length", mean_ep_len, it)
        w.add_scalar("Episode/max_command_x", float(metrics["max_command_x"]), it)
        w.add_scalar("Episode/terrain_level", float(metrics["terrain_level_mean"]), it)
        n_done = max(float(metrics["done_count"]), 1.0)
        for i, name in enumerate(getattr(self.env, "reward_names", ())):
            w.add_scalar(f"Episode/rew_{name}", float(metrics["episode_sums_done"][i]) / n_done,
                         it)

    # --- checkpointing (torch.save of plain dicts of tensors) ---------

    def save(self, carry: RunnerCarry, path: Optional[str] = None,
             keep_last: int = 4) -> Optional[str]:
        """Params, the Adam state, lr, the iteration, the full env state
        (curriculum levels, command ranges, its generator) and the run's
        generator: a resume repeats the original run bit for bit.  Under
        data parallelism (a ``group``) the lead rank writes the learning state
        only (the env state is split over the ranks) and the other ranks
        write nothing and return None."""
        if not self.is_lead:
            return None
        path = os.path.abspath(path or os.path.join(self.log_dir,
                                                    f"model_{self.iteration_count}.pt"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = ({"ts": to_tensor_dict(carry.ts)} if self.group is not None
                   else carry_to_dict(carry))
        payload["iteration"] = self.iteration_count
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self._prune_checkpoints(keep_last)
        return path

    def _prune_checkpoints(self, keep_last: int):
        """Keep the newest ``keep_last`` checkpoints in the log dir and one
        every ``MILESTONE_EVERY`` iterations; delete the rest."""
        if not self.log_dir or keep_last <= 0 or not os.path.isdir(self.log_dir):
            return
        found = []
        for name in os.listdir(self.log_dir):
            stem, ext = os.path.splitext(name)
            if name.startswith("model_") and ext == ".pt":
                try:
                    found.append((int(stem.split("_", 1)[1]), name))
                except ValueError:
                    continue
        found.sort()
        for it, name in found[:-keep_last] if len(found) > keep_last else []:
            if it % MILESTONE_EVERY == 0:
                continue
            os.remove(os.path.join(self.log_dir, name))

    def load(self, path: str, carry: Optional[RunnerCarry] = None,
             params_only: bool = False) -> RunnerCarry:
        """Restore a :meth:`save` checkpoint into ``carry`` (a fresh
        :meth:`init_carry` when None).  ``params_only`` takes the params, lr
        and iteration and leaves the env alone (any env count).  A checkpoint
        of the learning state only (written under data parallelism), and any
        checkpoint loaded under data parallelism, restores the learning
        state (params, Adam, lr, iteration) onto ``carry``'s env state.  A
        full restore needs the checkpoint's env count and raises on
        another.  A slim checkpoint (``utils.checkpoint.slim``) raises unless
        ``params_only``: ``scripts/resume_migrate.py`` grafts it."""
        d = torch.load(path, map_location="cpu", weights_only=True)
        if not params_only:
            refuse_slim(d, path)
        learning_only = not params_only and ("env_state" not in d or self.group is not None)
        if not (params_only or learning_only):
            saved_n = int(d["cur_reward_sum"].shape[0])
            if saved_n != self.env.num_envs:
                raise ValueError(f"checkpoint {path} holds {saved_n} envs but the env has "
                                 f"{self.env.num_envs}: resume with --num_envs {saved_n}, or "
                                 "load the params only")
        if carry is None:
            carry = self.init_carry()
        dev = self.device
        saved_ts = d["ts"]
        self.iteration_count = int(d["iteration"])
        if params_only:
            return carry._replace(ts=carry.ts.replace(
                params={k: v.to(dev) for k, v in saved_ts["params"].items()},
                lr=saved_ts["lr"].to(dev)))
        ts = from_tensor_dict(carry.ts, saved_ts, dev)
        if learning_only:
            if self.is_lead:
                print(f"restored the learning state of {path} (iteration "
                      f"{self.iteration_count}); the env state starts fresh", flush=True)
            return carry._replace(ts=ts)
        env_state = from_tensor_dict(carry.env_state, d["env_state"], dev)
        rng = from_tensor_dict(carry.rng, d["rng"], dev)
        return carry._replace(ts=ts, env_state=env_state, obs=env_state.obs_hist,
                              priv_obs=env_state.critic_hist, rng=rng,
                              cur_reward_sum=d["cur_reward_sum"].to(dev),
                              cur_ep_len=d["cur_ep_len"].to(dev))

    # ------------------------------------------------------------------

    def get_inference_policy(self, params):
        """Deterministic policy (the action mean), like the reference's
        ``act_inference``."""
        net = self.network

        @torch.no_grad()
        def policy(obs):
            return nets.apply(net, params, "act_mean", obs)

        return policy


class DHOnPolicyRunner(OnPolicyRunner):
    """Named alias for registry parity with the reference."""
