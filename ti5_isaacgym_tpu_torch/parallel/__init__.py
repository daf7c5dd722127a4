from .trainer import (ReduceGroup, ShardedRunner, coordination_barrier,  # noqa: F401
                      distributed_init, failing_ranks, lead_value, rank_seeds, run_rank,
                      shard_carry, spawn_local)
