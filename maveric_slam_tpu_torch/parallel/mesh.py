"""The device mesh on torch.distributed (port of maveric_slam_tpu/parallel/mesh.py).

The JAX package runs a mesh from one controller, as `shard_map` over the
devices of a `jax.sharding.Mesh`. The port runs one process per rank
(SPMD): each of the JAX package's sharded arrays is each rank's own slice
on that rank's device, `psum` is `dist.all_reduce` and `all_gather` is
`dist.all_gather_into_tensor`. A mesh's axes name the grid of ranks, which
is flattened in rank order; the collectives here reduce over every axis, as
the JAX package's `psum` over its axis tuple does.

Joining. Processes join through torchrun's environment (MASTER_ADDR,
MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE) in
`maybe_init_distributed`, or are started by `spawn`, which sets that
environment itself. The backend is chosen once, from the layout: NCCL when
every rank has a card of its own, gloo on the CPU or when ranks share a
card (NCCL refuses two ranks on one GPU). It is never switched after a
failure. Every process group gets a timeout, so a rank that waits on a
peer that died raises instead of hanging, and `spawn` kills the other
ranks as soon as one fails.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import multiprocessing
import os
import queue as queue_lib
import socket
import threading
import time
import traceback
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.backend import resolve_device

LANDMARK_AXIS = "ldmk"
DEFAULT_TIMEOUT_S = 300.0  # a collective waits this long for its peers, then raises

_log = logging.getLogger(__name__)
# `all_gather_single` is the newer name of `all_gather_into_tensor`.
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: its flattened rank and the mesh's size,
    the axis names and shape of the rank grid, the rank's device, and the
    backend of the process group."""

    rank: int
    size: int
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device
    backend: str


def _local_layout() -> Tuple[int, int]:
    """(local rank, ranks on this host) from torchrun's environment."""
    rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    return rank, world


def rank_device(device=None) -> torch.device:
    """This rank's device. `None` or "cuda" means CUDA (raising without a
    card): the card LOCAL_RANK when every rank of the host has a card of its
    own, else the card the ranks share. Any other device is taken as given."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local_rank, _ = _local_layout()
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device) -> str:
    """NCCL when every rank of the host has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    _, local_world = _local_layout()
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def maybe_init_distributed(device=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group that torchrun's environment describes; True
    when this process is in one. A no-op without MASTER_ADDR and WORLD_SIZE
    (a single-process run) or when already joined. `device` is this rank's
    device as for `rank_device`; the backend follows from it."""
    if dist.is_initialized():
        return True
    if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dev = rank_device(device)
    backend = choose_backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _log.info("rank %d of %d joined over %s on %s", rank, world, backend, dev)
    return True


def make_mesh(n_devices: int | Sequence[int] | None = None,
              axis: str | Sequence[str] = LANDMARK_AXIS, device=None) -> Mesh:
    """The mesh over every rank of the process group: 1-D over `axis` when
    `n_devices` is an int (or None), or a grid of that shape over the axis
    names (e.g. (2, 2) over ("host", "chip")). Its size must be the world
    size. `device` as for `rank_device`."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: run under torchrun or mesh.spawn "
                           "(maybe_init_distributed joins torchrun's)")
    world = dist.get_world_size()
    if n_devices is None:
        shape = (world,)
    elif isinstance(n_devices, int):
        shape = (n_devices,)
    else:
        shape = tuple(int(s) for s in n_devices)
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ in length")
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    dev = rank_device(device)
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL process group cannot reduce tensors on {dev}")
    return Mesh(rank=dist.get_rank(), size=world, axis_names=axes, shape=shape, device=dev,
                backend=backend)


def global_mesh(axis: str = LANDMARK_AXIS, device=None) -> Mesh:
    """The 1-D mesh over every rank of the process group."""
    return make_mesh(None, axis, device)


def axis_index(mesh: Mesh, axis: Optional[str] = None) -> int:
    """This rank's index along `axis`, or in the flattened mesh (None)."""
    if axis is None:
        return mesh.rank
    return int(np.unravel_index(mesh.rank, mesh.shape)[mesh.axis_names.index(axis)])


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over every rank (a new tensor on every rank)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `x`, stacked in rank order: (mesh.size, *x.shape). Bool
    tensors travel as uint8."""
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = src.new_empty((mesh.size * src.numel(),))
    _all_gather_flat(out, src.contiguous().reshape(-1))
    out = out.reshape(mesh.size, *x.shape)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def barrier(mesh: Mesh) -> None:
    """Return once every rank of the mesh has reached this call."""
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


def local_rows(n: int, mesh: Mesh, what: str = "rows") -> slice:
    """This rank's block of `n` rows split evenly over the mesh (n must
    divide by the mesh size)."""
    if n % mesh.size:
        raise ValueError(f"{n} {what} do not divide over a mesh of {mesh.size}")
    rows, k = n // mesh.size, axis_index(mesh)
    return slice(k * rows, (k + 1) * rows)


def digest(a: np.ndarray) -> np.ndarray:
    """Two int64 sums of an array's bytes (plain and position-weighted), equal
    on two arrays of the same bytes; a cheap test that ranks agree."""
    b = np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8).astype(np.int64)
    return np.array([b.sum(), (b * np.arange(1, b.size + 1, dtype=np.int64)).sum()], np.int64)


def check_replicas(a: np.ndarray, mesh: Mesh, what: str) -> None:
    """Raise unless every rank holds the same bytes in `a` (one all_gather
    of two int64s). Ranks that drifted apart would otherwise go on to wait
    in different collectives."""
    mine = torch.from_numpy(digest(a)).to(mesh.device)
    every = all_gather(mine, mesh)
    if not bool(torch.all(every == every[0])):
        raise RuntimeError(f"mesh ranks diverged at {what}: digests {every.tolist()}")


# ---------------------------------------------------------------------- #
# Starting ranks
# ---------------------------------------------------------------------- #


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankFailure(RuntimeError):
    """A rank of `spawn` raised: `rank`, the exception's class name `kind`,
    its message `detail` and the rank's traceback `trace`."""

    def __init__(self, rank: int, world: int, kind: str, detail: str, trace: str):
        super().__init__(f"rank {rank} of {world} failed:\n{trace}")
        self.rank, self.kind, self.detail, self.trace = rank, kind, detail, trace


def _exit_with_parent(parent: int) -> None:
    """End this process once its parent is gone (a rank outlives no
    launcher that was killed)."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _rank_entry(fn, rank, world, port, device, threads, args, results, parent) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    threading.Thread(target=_exit_with_parent, args=(parent,), daemon=True).start()
    if threads:
        torch.set_num_threads(threads)
    try:
        maybe_init_distributed(device)
        value = fn(*args)
    except BaseException as e:  # noqa: BLE001 (reported to the parent)
        results.put((rank, False, (type(e).__name__, str(e), traceback.format_exc())))
        # Exit without waiting on the group: a peer may sit in a collective
        # (or a step thread of this rank may still hold one), and
        # destroy_process_group could block on it. `spawn` kills the rest.
        results.close()
        results.join_thread()
        os._exit(1)
    results.put((rank, True, value))
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: tuple = (), device=None,
          timeout_s: Optional[float] = 600.0, threads: Optional[int] = None) -> list:
    """Run `fn(*args)` in `world_size` new processes, one rank each, joined
    into one process group on `device` (as for `rank_device`; the card is
    shared when there are fewer cards than ranks), and return their results
    in rank order.

    The processes start with the `spawn` method (never `fork`: the caller
    may hold a CUDA context), so `fn` must be importable and `args` and the
    results picklable. `threads` sets each rank's torch thread count (None:
    the host's cores shared out among the ranks). When a
    rank raises, its traceback is raised here as RuntimeError and the other
    ranks are killed (`RankFailure`); so they are when `timeout_s` (None:
    no limit) passes. A rank ends itself when the caller's process is gone.
    """
    ctx = multiprocessing.get_context("spawn")
    threads = threads or max(1, (os.cpu_count() or 1) // world_size)
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world_size, port, device, threads, args, results,
                               os.getpid()))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} did not "
                                   f"finish within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    try:  # a failing rank's traceback may still be in the pipe
                        rank, ok, value = results.get(timeout=5.0)
                    except queue_lib.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} and no "
                            f"result") from None
                else:
                    continue
            if not ok:
                raise RankFailure(rank, world_size, *value)
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks returned results but exited with codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
    return [out[r] for r in range(world_size)]
