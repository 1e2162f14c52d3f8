"""The process group and the three collectives of the distributed solvers:
the torch.distributed counterpart of the JAX package's one-axis device mesh
(`parallel/dist_gba.make_mesh`, `jax.distributed.initialize`).

JAX runs `shard_map` bodies, one per device of a mesh, inside one program.
Here the same bodies run SPMD: one process per rank, each holding the whole
replicated state and its own block of the sharded arrays (`local_rows`),
and the collectives that the JAX bodies call become torch.distributed calls
on the mesh's group:

- `psum`   — `all_reduce` SUM (`jax.lax.psum`);
- `pmax`   — `all_reduce` MAX (`jax.lax.pmax`);
- `all_gather` — every rank's block concatenated along dim 0 in rank order
  (`jax.lax.all_gather(..., axis=0, tiled=True)`), by `dist.all_gather`
  into a list and `torch.cat`.

Gloo and NCCL take all three on CUDA tensors (all_reduce SUM and MAX of
float32 and int32, all_gather of float32, int32 and bool: what the solvers
send; chip_smoke.py's parallel phase runs them on an H100, torch 2.11),
and gloo on CPU tensors, so no collective is rebuilt from another.

Backends: "nccl" with one card per rank, or at world 1; "gloo" on the CPU,
and when several ranks share one card (NCCL refuses two ranks on one
device). The process group's timeout is short (COLLECTIVE_TIMEOUT_S), so
ranks that take different host branches, and so wait at different
collectives, fail instead of hanging. Ranks whose replicated state
differs would not hang: `check_replicated` compares a few counts and sums
across ranks before a solve and raises on every rank.

A mesh made with no process group initialized has one rank, and its
collectives return their input.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 120.0


def initialize_distributed(device=None, backend: str | None = None) -> bool:
    """`dist.init_process_group` from the env triplet the JAX package reads
    (COORDINATOR_ADDRESS "host:port", NUM_PROCESSES, PROCESS_ID). Returns
    False, and does nothing, when COORDINATOR_ADDRESS is unset. `device` is
    this rank's (default "cuda:{rank}", one card per rank); a CUDA device
    becomes the process's current one. The backend is NCCL for a CUDA
    device and gloo for the CPU, unless named; ranks that share one card
    name "gloo". Prints the choice."""
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if not addr:
        return False
    world, rank = int(os.environ["NUM_PROCESSES"]), int(os.environ["PROCESS_ID"])
    dev = torch.device(device if device is not None else f"cuda:{rank}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world,
                            rank=rank, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    print(f"[parallel] rank {rank} of {world}: backend {backend}, device {dev}", flush=True)
    return True


class Mesh:
    """One mesh axis over the ranks of the default process group."""

    def __init__(self, size: int, rank: int, device: torch.device, grouped: bool):
        self.size, self.rank, self.device = size, rank, device
        self.grouped = grouped  # collectives go through torch.distributed

    def axis_index(self) -> int:
        """This rank's block (`jax.lax.axis_index`)."""
        return self.rank

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if not self.grouped:
            return x
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, op=op)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x along dim 0, in rank order (tiled)."""
        if not self.grouped:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return torch.cat(parts, 0)


def world_size() -> int:
    """Ranks of the initialized process group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(device=None) -> Mesh:
    """The mesh over the process group's ranks (JAX `make_mesh`). `device`
    is this rank's: "cuda:{rank}" with one card per rank (the default),
    "cuda:0" when the ranks share one card, "cpu" on the CPU."""
    grouped = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if grouped else 0
    dev = torch.device(device if device is not None else f"cuda:{rank}")
    return Mesh(world_size(), rank, dev, grouped)


def check_replicated(mesh: Mesh, what: str, *values: torch.Tensor) -> None:
    """Raise ValueError on every rank unless every rank passed the same
    values: one pmax of the values and of their negatives. The solvers
    assume that each rank holds the same map (SPMD); ranks whose maps
    diverged would still meet at every collective and mix blocks of
    different maps. Pass counts and sums of the replicated arrays."""
    if not mesh.grouped:
        return
    v = torch.stack([torch.nan_to_num(torch.as_tensor(x, device=mesh.device).to(torch.float32))
                     for x in values])
    hi_lo = mesh.pmax(torch.cat([v, -v]))
    if not torch.equal(hi_lo[:len(v)], -hi_lo[len(v):]):
        raise ValueError(f"rank {mesh.rank} of {mesh.size}: {what} differs across ranks "
                         f"(max {hi_lo[:len(v)].tolist()}, min {(-hi_lo[len(v):]).tolist()})")


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of x's leading axis (the `P(axis)` placement):
    rows [r * n / size, (r + 1) * n / size). The leading axis must divide
    by the mesh size."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks")
    b = n // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]
