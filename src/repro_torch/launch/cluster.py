"""Multi-process bootstrap of the port (``repro.launch.cluster``).

Every process runs the SAME program (SPMD): ``init_cluster()`` joins the
process group, a mesh of :mod:`repro_torch.launch.mesh` spans its world,
and the training loop is :mod:`repro_torch.launch.train`'s, each rank
taking its part of the global batch.

The group's address, size and this process's rank come from, in order:
the arguments; ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` /
``REPRO_PROCESS_ID`` (the coordinator is ``host:port`` or a full
``init_method`` URL such as ``file:///shared/rendezvous``; a world of 1
joins too); torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT``; SLURM's ``SLURM_PROCID`` / ``SLURM_NTASKS`` with
``MASTER_ADDR`` / ``MASTER_PORT`` (those two launchers only for a world of
2 or more).

Unlike the reference, which prints and carries on single-host when its
initialization fails, :func:`init_cluster` raises: a run that silently
drops its mesh hides what it was asked to run on.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["init_cluster", "host_data_slice"]


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _rendezvous(coordinator, num_processes, process_id):
    """(init_method, world_size, rank), or None when no multi-process
    environment is set."""
    coordinator = coordinator or os.environ.get("REPRO_COORDINATOR")
    if coordinator:
        world = num_processes or _env_int("REPRO_NUM_PROCESSES")
        rank = process_id if process_id is not None else \
            _env_int("REPRO_PROCESS_ID")
        if world is None or rank is None:
            raise RuntimeError(
                f"coordinator {coordinator!r} given without the number of "
                f"processes and this process's id (REPRO_NUM_PROCESSES, "
                f"REPRO_PROCESS_ID)")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        return url, world, rank
    for rank_var, world_var in (("RANK", "WORLD_SIZE"),
                                ("SLURM_PROCID", "SLURM_NTASKS")):
        if rank_var in os.environ and world_var in os.environ:
            if int(os.environ[world_var]) < 2:
                return None  # a launcher's single process
            if not ("MASTER_ADDR" in os.environ
                    and "MASTER_PORT" in os.environ):
                raise RuntimeError(
                    f"{rank_var}/{world_var} are set but MASTER_ADDR and "
                    f"MASTER_PORT, the group's address, are not")
            return "env://", int(os.environ[world_var]), \
                int(os.environ[rank_var])
    return None


def init_cluster(coordinator: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None, *,
                 device="cuda") -> bool:
    """Join the process group of a multi-process run (NCCL on ``cuda``,
    gloo on ``cpu``); on CUDA each rank takes the card ``LOCAL_RANK`` (or
    its rank modulo the cards it sees).

    Returns True when distributed mode is active (also when the group was
    already initialized), False when no multi-process environment is set.
    Raises when one is set but the group cannot be joined."""
    if dist.is_initialized():
        return True
    found = _rendezvous(coordinator, num_processes, process_id)
    if found is None:
        return False
    url, world, rank = found
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else rank % torch.cuda.device_count())
    try:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=url, world_size=world, rank=rank)
    except Exception as e:
        raise RuntimeError(f"joining the process group at {url} as rank "
                           f"{rank} of {world} failed: {e}") from e
    return True


def host_data_slice() -> tuple:
    """(rank, world size) of this process; (0, 1) outside a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()
