"""The port's hand-written CUDA kernels, one module each.

Each module holds the kernel's wrapper, which launches the kernel for CUDA
tensors and takes the plain PyTorch version beside it only for CPU tensors,
and a plain integer `launches` that the wrapper raises by one per launch.
"""

from . import detector, match, nullspace, qconv, refine_pose, stem, svd3

MODULES = {
    "detector_postproc": detector,
    "windowed_match": match,
    "nullspace_inverse_iteration": nullspace,
    "svd3": svd3,
    "fused_stem": stem,
    "refine_pose": refine_pose,
    "qconv": qconv,
}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in MODULES.items()}


def reset_launch_counts() -> None:
    for mod in MODULES.values():
        mod.launches = 0
