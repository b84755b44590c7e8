"""Distributed execution: landmark-sharded BA, in one process or across a
`torch.distributed` process group."""

from . import dist_ba
from .dist_ba import ShardedBAProblem, distributed_ba, make_distributed_ba_step, partition_problem

__all__ = [
    "dist_ba",
    "ShardedBAProblem",
    "distributed_ba",
    "make_distributed_ba_step",
    "partition_problem",
]
