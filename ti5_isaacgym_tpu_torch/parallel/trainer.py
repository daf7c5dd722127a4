"""Data-parallel training on ``torch.distributed`` (port of
``ti5_isaacgym_tpu/parallel/trainer.py``).

One OS process per rank, each on its own device (a card; the CPU for the
tests), in place of the JAX package's one process owning a device mesh:

* the envs are split over the ranks along the batch dimension: every rank
  builds the single-process initial carry at the global width from the same
  seed and keeps its slice (:func:`shard_carry`), chosen by field name, never
  by shape (``_REPLICATED_ENV_FIELDS``);
* the train state (params, Adam, lr) is replicated: every rank applies the
  same averaged gradient and lr, so it stays equal bit for bit across ranks
  (:meth:`ShardedRunner.check_replicated`);
* the iteration's collectives are all-reduces through a
  :class:`ReduceGroup`, which counts them by name: the command curriculum's
  sums (``curriculum``, one per env step), the GAE moments (``gae``), each
  minibatch's gradients and KL (``update``) and the metrics (``metrics``);
* random streams: rank 0 keeps the single-process generators of
  ``algo/runner.py`` (``split_seed``); rank r > 0 gets its own env and run
  generators, seeded by :func:`rank_seeds`.  (The JAX package folds the
  shard index into the runner's key only and replicates the env's key, so
  its shards draw the same env noise per local env index; the port does
  not copy that.)  Each rank draws its minibatch permutation over its own
  samples;
* rendezvous: a ``TCPStore`` at a coordinator address (several hosts), or a
  ``FileStore`` (ranks that :func:`spawn_local` starts on one host); the
  lead rank's run stamp and the barriers go through that store.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

# env-state fields that are shared scalars or globals, not per-env tensors
# (the JAX list without "rng": each rank has its own env generator)
_REPLICATED_ENV_FIELDS = ("common_step", "cmd_vx_range", "is_first_push",
                          "is_first_add_force", "terrain_height")
# carry fields replicated wholesale (network and optimizer state)
_REPLICATED_CARRY_FIELDS = ("ts",)
DEFAULT_TIMEOUT_S = 600.0

# the rendezvous store of this process's group (set by distributed_init)
_store = None
_key_uses = collections.Counter()


class ReduceGroup:
    """The ranks a data-parallel iteration reduces over: a process group
    (the default one when ``group`` is None), and the number of all-reduces
    made through it, by name (``counts``)."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.counts = collections.Counter()

    def sum_(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """``t`` summed over the ranks, in place; counted under ``name``."""
        self.counts[name] += 1
        return self.all_reduce_(t)

    def mean_(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """``t`` averaged over the ranks, in place (the sum over the world
        size: every rank divides the same bytes the same way)."""
        return self.sum_(t, name).div_(self.size)

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """An uncounted all-reduce of a contiguous ``t``, in place."""
        dist.all_reduce(t, op=op, group=self.group)
        return t


def rank_seeds(seed: int, rank: int) -> Tuple[int, int]:
    """(env seed, run seed) of rank ``rank`` > 0: the two 32-bit words of
    ``numpy.random.SeedSequence([seed, rank]).generate_state(2)``.  Rank 0
    keeps the single-process generators."""
    return tuple(int(s) for s in np.random.SeedSequence([int(seed), int(rank)]).generate_state(2))


def _generator(like: torch.Generator, seed: Optional[int] = None) -> torch.Generator:
    """A new generator on ``like``'s device: seeded with ``seed``, or a copy
    of ``like``'s state."""
    gen = torch.Generator(device=like.device)
    if seed is None:
        gen.set_state(like.get_state())
    else:
        gen.manual_seed(seed)
    return gen


def _slice_tree(x, lo: int, hi: int):
    """Rows ``[lo, hi)`` of every tensor of a (nested) state dataclass,
    except the fields named in ``_REPLICATED_ENV_FIELDS`` (kept as they
    are) and generators (left to the caller)."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: (getattr(x, f.name) if f.name in _REPLICATED_ENV_FIELDS
                     else _slice_tree(getattr(x, f.name), lo, hi))
            for f in dataclasses.fields(x)})
    if isinstance(x, torch.Generator):
        return x
    return x[lo:hi].clone()


def shard_carry(carry, rank: int, world_size: int, seed: int):
    """Rank ``rank``'s part of a single-process carry of ``world_size`` x n
    envs: rows ``[rank*n, (rank+1)*n)`` of the per-env fields, the train
    state and the replicated env fields as they are, and new generators
    (copies of the carry's for rank 0, :func:`rank_seeds` for the others)."""
    total = int(carry.obs.shape[0])
    if total % world_size:
        raise ValueError(f"{total} envs do not split evenly over {world_size} ranks")
    n = total // world_size
    lo, hi = rank * n, (rank + 1) * n
    env_rng, run_rng = carry.env_state.rng, carry.rng
    if rank == 0:
        env_rng, run_rng = _generator(env_rng), _generator(run_rng)
    else:
        env_seed, run_seed = rank_seeds(seed, rank)
        env_rng, run_rng = _generator(env_rng, env_seed), _generator(run_rng, run_seed)
    part = carry._replace(**{name: x if name in _REPLICATED_CARRY_FIELDS else _slice_tree(x, lo, hi)
                             for name, x in carry._asdict().items()})
    return part._replace(env_state=part.env_state.replace(rng=env_rng), rng=run_rng)


class ShardedRunner:
    """Wraps an :class:`~..algo.runner.OnPolicyRunner` whose env holds the
    global number of envs so that this rank trains its share of them, the
    collectives of the iteration on (over ``group``, default the whole
    world).  ``iteration`` is the runner's one-iteration function."""

    def __init__(self, runner, group=None):
        self.runner = runner
        self.reduce = ReduceGroup(group)
        self.rank, self.world_size = self.reduce.rank, self.reduce.size
        n = runner.env.num_envs
        if n % self.world_size:
            raise ValueError(f"{n} envs do not split evenly over {self.world_size} ranks")
        self.num_envs = n // self.world_size
        runner.group = runner.alg.group = runner.env.group = self.reduce
        self.iteration = runner._iter_fn

    def init_carry(self):
        """The single-process initial carry (global width, same seed on
        every rank, no collective: every rank computes the same reset), then
        this rank's part of it."""
        env = self.runner.env
        env.group = None
        try:
            carry = self.runner.init_carry()
        finally:
            env.group = self.reduce
        return self.shard_carry(carry)

    def shard_carry(self, carry):
        return shard_carry(carry, self.rank, self.world_size, self.runner.seed)

    def load(self, path: str, carry=None, **kw):
        """The learning state of a checkpoint on a fresh carry (or on
        ``carry``): the env state starts fresh."""
        return self.runner.load(path, carry=self.init_carry() if carry is None else carry, **kw)

    @property
    def log_dir(self):
        return self.runner.log_dir

    def save(self, carry, **kw):
        return self.runner.save(carry, **kw)

    def learn(self, num_iterations: int, carry=None, log_every: int = 10):
        if carry is None:
            carry = self.init_carry()
        return self.runner.learn(num_iterations, carry=carry, log_every=log_every)

    def check_replicated(self, carry) -> Tuple[int, float]:
        """(number of float32 words of params, Adam moments, count and lr in
        which some rank differs from another, the largest such gap): one
        MAX and one MIN all-reduce of their bits, outside the counts."""
        ts = carry.ts
        flat = torch.cat([v.reshape(-1).to(torch.float32) for tree in (ts.params, ts.mu, ts.nu)
                          for v in tree.values()]
                         + [ts.lr.reshape(1), ts.count.reshape(1).view(torch.float32)])
        bits = flat.view(torch.int32)
        hi = self.reduce.all_reduce_(bits.clone(), dist.ReduceOp.MAX)
        lo = self.reduce.all_reduce_(bits.clone(), dist.ReduceOp.MIN)
        differ = hi != lo
        gap = (hi.view(torch.float32) - lo.view(torch.float32)).abs()
        return int(differ.sum()), float(torch.where(differ, gap, 0.0).max())


# --- process group, store, ranks ------------------------------------------


def distributed_init(rank: int, world_size: int, backend: str, coordinator: Optional[str] = None,
                     store_file: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the process group as ``rank`` of ``world_size`` over ``backend``
    (``nccl`` for ranks on cards, ``gloo`` on the CPU or where two ranks
    share a card).  Rendezvous through a ``TCPStore`` at ``coordinator``
    (``host:port``, served by rank 0) or a ``FileStore`` at ``store_file``;
    ``timeout_s`` bounds the rendezvous and every collective."""
    global _store
    timeout = timedelta(seconds=timeout_s)
    if coordinator is not None:
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world_size, is_master=(rank == 0),
                              timeout=timeout)
    elif store_file is not None:
        store = dist.FileStore(store_file, world_size)
        store.set_timeout(timeout)
    else:
        raise ValueError("distributed_init needs a coordinator address or a store file")
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timeout)
    _store = store
    _key_uses.clear()


def distributed_shutdown():
    global _store
    if dist.is_initialized():
        dist.destroy_process_group()
    _store = None


def _key(name: str) -> str:
    """A store key for the next use of ``name`` (every rank uses its names
    in the same order, so the keys agree)."""
    _key_uses[name] += 1
    return f"ti5/{name}/{_key_uses[name]}"


def coordination_barrier(name: str, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Block until every rank has reached this point (through the store: no
    collective on any device).  A no-op in a single process."""
    if _store is None or not dist.is_initialized():
        return
    key = _key(f"barrier/{name}")
    if _store.add(key, 1) == dist.get_world_size():
        _store.set(key + "/done", "1")
    _store.wait([key + "/done"], timedelta(seconds=timeout_s))


def lead_value(name: str, value: str) -> str:
    """``value`` as rank 0 has it (published through the store, e.g. the run
    directory's time stamp); ``value`` itself in a single process."""
    if _store is None or not dist.is_initialized():
        return value
    key = _key(name)
    if dist.get_rank() == 0:
        _store.set(key, value)
    return _store.get(key).decode()


def run_rank(fn, rank: int, world_size: int, device: str, backend: str, args: Sequence = (),
             coordinator: Optional[str] = None, store_file: Optional[str] = None,
             timeout_s: float = DEFAULT_TIMEOUT_S):
    """``fn(rank, device, *args)`` in this process as ``rank`` of the group,
    which is left when ``fn`` returns or raises."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    distributed_init(rank, world_size, backend, coordinator, store_file, timeout_s)
    try:
        return fn(rank, device, *args)
    finally:
        distributed_shutdown()


def failing_ranks(name: str, ok: bool) -> list:
    """The ranks on which ``ok`` is false: every rank passes its own and
    gets the same list back (through the store, so that all ranks can fail
    together).  In a single process ``[]`` or ``[0]``."""
    if _store is None or not dist.is_initialized():
        return [] if ok else [0]
    key = _key(name)
    _store.set(f"{key}/{dist.get_rank()}", "1" if ok else "0")
    return [r for r in range(dist.get_world_size()) if _store.get(f"{key}/{r}") != b"1"]


def _rank_main(i, fn, devices, backend, args, world_size, rank_offset, coordinator, store_file,
               timeout_s, out_dir):
    rank = rank_offset + i
    value = run_rank(fn, rank, world_size, devices[i], backend, args, coordinator, store_file,
                     timeout_s)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(value, f)


def spawn_local(fn, devices: Sequence[str], backend: str, args: Sequence = (),
                world_size: Optional[int] = None, rank_offset: int = 0,
                coordinator: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                deadline_s: Optional[float] = None) -> list:
    """Start one process per entry of ``devices``
    (``torch.multiprocessing``, ``spawn``), ranks ``rank_offset + i`` of
    ``world_size`` (default ``len(devices)``), each running
    ``fn(rank, device, *args)`` through :func:`run_rank`; return their
    return values (picklable) in rank order.  Rendezvous: the ``TCPStore``
    at ``coordinator``, else a ``FileStore`` in a new temporary directory.
    ``timeout_s`` bounds the rendezvous and each collective, not the run:
    the call waits until every rank has returned, or until one has raised
    or died, which stops the others and raises with that rank's traceback,
    or until ``deadline_s`` seconds have passed where the caller gives one
    (a test), which stops them all and raises ``TimeoutError``.
    ``fn`` must be importable by name (a module-level function): the new
    processes import it afresh."""
    n = len(devices)
    world_size = n if world_size is None else world_size
    tmp = tempfile.mkdtemp(prefix="ti5_dp_")
    store_file = None if coordinator is not None else os.path.join(tmp, "store")
    try:
        ctx = torch_mp.start_processes(
            _rank_main, args=(fn, tuple(devices), backend, tuple(args), world_size, rank_offset,
                              coordinator, store_file, timeout_s, tmp),
            nprocs=n, join=False, daemon=True, start_method="spawn")
        end = None if deadline_s is None else time.monotonic() + deadline_s
        try:
            while not ctx.join(None if end is None else max(end - time.monotonic(), 0.0)):
                if end is not None and time.monotonic() >= end:
                    raise TimeoutError(f"the ranks did not finish within {deadline_s} s")
        finally:        # interrupted: leave no rank behind
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for rank in range(rank_offset, rank_offset + n):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
