"""The process group: one process per card, the port's counterpart of
``upsnet_tpu/parallel/mesh.py``.

The JAX package runs one controller over a ``Mesh(('data',))`` of all
chips, with parameters replicated and the batch split on 'data'. The port
runs one process per card under ``torchrun``, which sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``; each process drives ``cuda:LOCAL_RANK``.
Without ``torchrun`` the world is 1 and no group is made, exactly as a
single-device run. ``num_devices`` (the reference's ``gpus:``) caps the
world as ``make_mesh`` caps the mesh (``devs[:num_devices]``, 0 = all);
processes are started outside the program, so a world larger than a
nonzero ``num_devices`` is refused by name instead of cut.

The backend is NCCL on the card and gloo on the CPU; a caller may name it
(gloo serves two ranks on one card, which NCCL refuses). With a named
backend a world of 1 still makes a group.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import socket
import traceback

import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it raises
GROUP_TIMEOUT_S = 600


@dataclasses.dataclass
class Group:
    """This process's place in the world: ``rank`` of ``world`` on
    ``device``; ``distributed`` when a process group was made (collectives
    run over the default group), else every collective is the identity."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    distributed: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (in place; returns ``t``)."""
        if self.distributed:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        if self.distributed:
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def max_stats(self, stats: dict) -> dict:
        """Per-layer offset statistics (``utils/dcn_probe.py``) with each
        field's maximum over the ranks, so that every rank's saturation
        watch sees the same numbers and takes the same decision."""
        if not self.distributed or not stats:
            return stats
        names = sorted(stats)
        fields = sorted(stats[names[0]])
        t = torch.tensor([[stats[n][f] for f in fields] for n in names], dtype=torch.float64,
                         device=self.device)
        rows = self.all_reduce_max(t).tolist()
        return {n: dict(zip(fields, r)) for n, r in zip(names, rows)}

    def gather_to_main(self, obj):
        """Rank 0 gets the list of every rank's ``obj`` in rank order; the
        others get None."""
        if not self.distributed:
            return [obj]
        out = [None] * self.world if self.is_main else None
        dist.gather_object(obj, out, dst=0)
        return out

    def broadcast_from_main(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_group(num_devices: int = 0, device="cuda", backend: str | None = None,
               init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None) -> Group:
    """Join (or make) the process group of this run.

    ``rank`` and ``world_size`` default to ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE`` (0 and 1 without it). ``device`` 'cuda' means
    ``cuda:LOCAL_RANK``; a device with an index is taken as it is; 'cpu'
    keeps the CPU. ``backend`` defaults to 'nccl' on the card and 'gloo' on
    the CPU; naming it makes a group even for a world of 1. ``init_method``
    defaults to ``env://`` when ``MASTER_ADDR`` is set (``torchrun``), else
    to a free port on localhost, which serves a world of 1."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if num_devices and world > num_devices:
        raise ValueError(f"a world of {world} processes is larger than num_devices="
                         f"{num_devices} (the configuration's gpus:); start at most "
                         f"{num_devices} processes, or set num_devices to 0 (all)")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device; pass device='cpu' to run "
                               "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    distributed = world > 1 or backend is not None
    if distributed and not dist.is_initialized():
        if init_method is None:
            if "MASTER_ADDR" in env:
                init_method = "env://"
            elif world == 1:
                init_method = f"tcp://localhost:{_free_port()}"
            else:
                raise ValueError(f"a world of {world} needs an init_method or torchrun's "
                                 "MASTER_ADDR and MASTER_PORT")
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=init_method, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return Group(rank=rank, world=world, device=dev, distributed=distributed)


def close_group(group: Group) -> None:
    """Leave the process group that ``make_group`` joined."""
    if group.distributed and dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(fn, rank: int, world: int, args: tuple, results) -> None:
    try:
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, world: int, *args, timeout_s: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes and
    return their results in rank order. ``fn`` must be importable by name
    and its results picklable. A rank that raises, or a world that has not
    finished within ``timeout_s``, fails the call with every rank stopped:
    a hung rank cannot hang the caller."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
        while len(out) + len(errors) < world:
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, value = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                raise TimeoutError(f"{world - len(out) - len(errors)} of {world} ranks did "
                                   f"not finish within {timeout_s:g} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return [out[r] for r in range(world)]
