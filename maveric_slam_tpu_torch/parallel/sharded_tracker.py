"""Stream-sharded multi-stream tracking over a mesh (port of
maveric_slam_tpu/parallel/sharded_tracker.py).

`track_step_batched` runs S independent odometry streams in one batched
pass; here each rank runs it on its own S / n of them (`shard_streams`,
then `track_step_sharded`, which takes the injected noise's rows with
`local_streams`), with no communication (streams are independent). A
batched state gives stream s a generator seeded s, and a rank keeps its
streams' generators, so a stream draws the same noise sharded as
unsharded.
"""

from __future__ import annotations

import torch

from ..frontend import tracker as trk
from . import mesh as mesh_lib
from .mesh import Mesh

STREAM_AXIS = "stream"


def make_stream_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The 1-D mesh over STREAM_AXIS: every rank of the process group (its
    size must be `n_devices` when given). `device` as for
    `mesh.rank_device`."""
    return mesh_lib.make_mesh(n_devices, STREAM_AXIS, device=device)


def local_streams(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's streams of a tensor with a leading stream axis (such as
    a batch of images or injected noise), on the mesh's device."""
    return x[mesh_lib.local_rows(x.shape[0], mesh, "streams")].to(mesh.device)


def shard_streams(states: trk.TrackerState, images: torch.Tensor, mesh: Mesh):
    """This rank's streams of a batched state (made on the mesh's device:
    its generators stay where they were made) and of the images. S must
    divide by the mesh size."""
    rows = mesh_lib.local_rows(images.shape[0], mesh, "streams")
    local = trk.TrackerState(*(f[rows].to(mesh.device) for f in states[:-1]),
                             generator=states.generator[rows])
    return local, images[rows].to(mesh.device)


def replicate_params(params, mesh: Mesh):
    """The network's parameters on this rank's device."""
    return {k: v.to(mesh.device) if isinstance(v, torch.Tensor) else v for k, v in params.items()}


def track_step_sharded(params, states: trk.TrackerState, images: torch.Tensor, config,
                       gumbel_min: torch.Tensor | None = None,
                       gumbel_lo: torch.Tensor | None = None):
    """One tracking step of this rank's streams: `states` and `images` as
    `shard_streams` gave them, `params` from `replicate_params`. The noise,
    if injected, is the whole batch's (S, ...), cut to this rank's rows of
    the stream mesh over every rank. Returns this rank's (states, step), as
    `track_step_batched` does for them; `gather_steps` gives every
    stream's."""
    if gumbel_min is not None or gumbel_lo is not None:
        mesh = make_stream_mesh(device=images.device)
        gumbel_min, gumbel_lo = (None if g is None else local_streams(g, mesh)
                                 for g in (gumbel_min, gumbel_lo))
    return trk.track_step_batched(params, states, images, config, gumbel_min, gumbel_lo)


def gather_steps(step: trk.StepResult, mesh: Mesh) -> trk.StepResult:
    """Every rank's step results, streams in global order, on every rank."""
    return trk.StepResult(*(mesh_lib.all_gather(f, mesh).reshape(-1, *f.shape[1:]) for f in step))
