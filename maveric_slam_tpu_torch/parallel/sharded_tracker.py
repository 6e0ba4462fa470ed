"""Stream-sharded multi-stream tracking over a mesh (port of
maveric_slam_tpu/parallel/sharded_tracker.py).

`track_step_batched` runs S independent odometry streams in one batched
pass; here each rank runs it on its own S / n of them (`shard_streams`,
with the injected noise's rows from `local_streams`), with no
communication (streams are independent). A batched state gives stream s a
generator seeded s, and a rank keeps its streams' generators, so a stream
draws the same noise sharded as unsharded.
"""

from __future__ import annotations

import torch

from ..frontend import tracker as trk
from . import mesh as mesh_lib
from .mesh import Mesh

STREAM_AXIS = "stream"


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


def gather_steps(step: trk.StepResult, mesh: Mesh) -> trk.StepResult:
    """Every rank's step results, streams in global order, on every rank."""
    return trk.StepResult(*(mesh_lib.all_gather(f, mesh).reshape(-1, *f.shape[1:]) for f in step))
