"""Device meshes of the multi-device solve: one process per shard.

The counterpart of povar_tpu/parallel/mesh.py's `make_mesh` for the
SPMD window layout (parallel/spmd.py). Where the JAX package runs one
program over a `jax.sharding.Mesh` with `shard_map` and `psum`, the port
runs one process per device (a rank of `torch.distributed`) and
all-reduces with `torch.distributed.all_reduce`: NCCL between distinct
GPUs, gloo between CPU processes. A mesh of one rank needs no process
group: its all-reduce is the identity, and the windowed plan, kernels
and layout overrides are those of any mesh, as with the JAX package's
`make_mesh(1)`.

NCCL refuses two ranks on one GPU, so a mesh of D ranks on the card
needs D cards; the CPU runs any D (`spawn(fn, D, "cpu")`). JAX's GSPMD
fallback (`pad_obs_to_multiple`, `shard_obs`, `make_sharded_solver`) is
not ported: the configurations it serves raise NotImplementedError on a
mesh (parallel/spmd.spmd_unsupported).
"""

from __future__ import annotations

import os
import pickle
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# how long a collective waits for a lost peer before its rank fails
# (gloo's and NCCL's default is 30 minutes)
PG_TIMEOUT_S = 300


@dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D mesh: its rank, the mesh size, the
    device its shard lives on, and the process group (None: the default
    group, or no group at all on a mesh of one)."""

    rank: int
    size: int
    device: torch.device
    group: Any = None

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the mesh, in place; returns x (the identity on a
        mesh of one). Every rank gets the same bits."""
        if self.size > 1:
            dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x [k, ...] concatenated in rank order along axis 0
        (the device-major order of the plan's landmark shards)."""
        if self.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)


def _device(kind: str, rank: int) -> torch.device:
    kind = torch.device(kind).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(device='cuda') but torch finds no CUDA device")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(kind)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh this process belongs to: a mesh of one rank when
    `torch.distributed` is not initialized (n_devices None or 1), else
    the initialized world (whose size n_devices must then match), this
    rank on cuda:<rank> (or the CPU with device="cpu")."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh({n_devices}) needs {n_devices} ranks of an "
                "initialized torch.distributed process group (start them "
                "with povar_tpu_torch.parallel.mesh.spawn)")
        return Mesh(rank=0, size=1, device=_device(device, 0))
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}) in a world of {size} ranks")
    return Mesh(rank=rank, size=size, device=_device(device, rank))


def _rank_main(rank, fn, n, device, args, out_dir):
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    # rendezvous through a file of the run's own directory: no port to
    # pick ahead and lose to another process before rank 0 binds it
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(out_dir, "store"),
        world_size=n, rank=rank, timeout=timedelta(seconds=PG_TIMEOUT_S))
    try:
        out = fn(make_mesh(n, device), *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, n: int, device="cuda", args: Sequence = ()) -> List:
    """Run fn(mesh, *args) on n ranks, one process each
    (`torch.multiprocessing.spawn`, a process group that meets in a file
    of a temporary directory: NCCL on cuda:0 .. cuda:n-1, gloo on the
    CPU), and return the ranks' results in rank order. fn, its arguments
    and its result must pickle (the results pass through that
    directory); a failing rank raises here and ends the others, and a
    collective whose peer is lost fails its rank after PG_TIMEOUT_S."""
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise RuntimeError(f"spawn({n}, 'cuda'): {have} CUDA devices")
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, n, device, tuple(args), out_dir),
            nprocs=n, join=True)
        out = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
