"""Distributed BA across OS processes with `torch.distributed`.

Counterpart of `sqrtlm_slam_tpu/parallel/multiprocess.py`
(`jax.distributed` over N processes). Every process holds the same host
problem (the partitioner is deterministic, so all agree on the layout),
materializes only its own landmark shards, and runs the Nielsen LM loop of
`dist_ba.make_bucketed_lm_iterate`: the two sums of each iteration end in
one `all_reduce` each over the process group. The landmark shards are then
all-gathered, so every process returns identical arrays.

Backends: `gloo` for CPU tensors, `nccl` by default for CUDA tensors. NCCL
takes one GPU per rank; where two ranks would share one GPU, `initialize`
raises and names `backend="gloo"` (which takes CUDA tensors in `all_reduce`
and copies through the host). It never switches backend by itself.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..factors.reprojection import Camera
from ..optim import schur_bucketed
from ..utils import to_host
from . import dist_ba


def _rank_device(device, rank: int) -> torch.device:
    """The device of `rank`: its own card (round-robin) for "cuda"."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return device


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: Optional[str] = None, device="cuda") -> None:
    """Join the process group ("host:port" or "tcp://host:port" of rank 0).
    `backend` defaults to nccl for CUDA and gloo for the CPU."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA tensors; use backend=\"gloo\" "
                             "on the CPU")
        n_gpus = torch.cuda.device_count()
        if num_processes > n_gpus:
            raise ValueError(
                f"backend 'nccl' takes one GPU per rank: {num_processes} ranks on "
                f"{n_gpus} GPU(s) would share one; pass backend=\"gloo\" for several "
                "ranks on one GPU")
        torch.cuda.set_device(_rank_device(device, process_id))
    address = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id)


def global_mesh(shards_per_process: int, device="cuda") -> dist_ba.Mesh:
    """This process's `shards_per_process` shards (all on its device) in a
    mesh over every process of the group."""
    rank = dist.get_rank()
    dev = _rank_device(device, rank)
    return dist_ba.Mesh([dev] * shards_per_process, process_index=rank,
                        num_processes=dist.get_world_size())


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's `x` (same shape) along dim 0, in rank order.
    gloo gathers host tensors (it has no CUDA all_gather)."""
    if dist.get_backend() == "gloo":
        x = x.cpu()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x)
    return torch.cat(out)


def distributed_ba_lm(b: schur_bucketed.BucketedBAProblem, cam: Camera,
                      mesh: Optional[dist_ba.Mesh] = None, num_iters: int = 15,
                      robust_delta: Optional[float] = None
                      ) -> Tuple[schur_bucketed.BucketedBAProblem, torch.Tensor, torch.Tensor]:
    """Multi-process twin of `dist_ba.distributed_ba_lm`: every process
    calls it with the same problem and gets the same result. Returns
    (problem, chi2, accepted count)."""
    mesh = mesh if mesh is not None else global_mesh(1, b.points.device)
    sharded, lm_ids = dist_ba.partition_bucketed(b, mesh.num_shards)
    iterate = dist_ba.make_bucketed_lm_iterate(mesh, cam, num_iters=num_iters,
                                               robust_delta=robust_delta)
    sp, chi2, n_acc = iterate(dist_ba.to_shards(sharded, mesh))
    local = torch.stack([p.to(mesh.home) for p in sp.points])
    shard_pts = to_host(_all_gather(local))
    return dist_ba.unshard(b, sp, np.asarray(shard_pts), lm_ids), chi2, n_acc
