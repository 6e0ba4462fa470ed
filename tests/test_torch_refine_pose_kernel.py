"""The pose refinement's kernel module on the CPU: the plain version against
the JAX package's `refine_pose`, the wrapper's dispatch and checks, and the
kernel's registration, C signature and device symbol. The kernel itself
runs on the card only (tests/test_torch_cuda.py, chip_smoke.py).
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax_spread import eagerly, relative, within_jax_spread
from pnp_problems import pnp_problem

from maveric_slam_tpu.geometry import pnp as jpnp
from maveric_slam_tpu_torch.config import DEFAULT_CONFIG
from maveric_slam_tpu_torch.geometry import pnp
from maveric_slam_tpu_torch.ops import kernels
from maveric_slam_tpu_torch.ops.kernels import _build
from maveric_slam_tpu_torch.ops.kernels import refine_pose as rp
from slam_bench import yardstick
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

HUBER, DAMPING = DEFAULT_CONFIG.ba.huber_delta, DEFAULT_CONFIG.ba.lm_damping
SOURCE = Path(_build.CSRC) / "refine_pose.cu"


def _jax_refine(args):
    """The JAX package's refine_pose vmapped over the poses, and its inputs."""
    K, *rest = (a.numpy() for a in args)
    return jax.vmap(lambda R0, t0, X, z, m: jpnp.refine_pose(
        K, R0, t0, X, z, m, huber_delta=HUBER, damping=DAMPING)), rest


def test_plain_matches_jax():
    """The port's refine_pose on the CPU (the plain version) against the JAX
    package's, vmapped over S = 4 poses of N = 100 factors: R, t and cost
    within twice JAX's own jitted-against-eager spread, or 1e-4 of the
    value's scale where that is larger (tests/test_torch_batched.py's rule);
    num_used exactly."""
    args = pnp_problem(4, 100, 0)
    fn, inputs = _jax_refine(args)
    jit = fn(*inputs)
    port = pnp.refine_pose(*args, huber_delta=HUBER, damping=DAMPING)
    within_jax_spread(port, jit, eagerly(fn, *inputs), relative(1e-4), ("R", "t", "cost"))
    assert port.num_used.dtype == torch.int32
    np.testing.assert_array_equal(port.num_used.numpy(), np.asarray(jit.num_used))
    # The refinement converges: the cost falls well below the initial pose's.
    start = pnp.refine_pose(*args, huber_delta=HUBER, damping=DAMPING, iterations=0)
    assert torch.all(port.cost < 0.5 * start.cost)


def test_cpu_takes_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's result bit for
    bit and launches nothing."""
    kernels.reset_launch_counts()
    args = pnp_problem(3, 37, 1)
    got = pnp.refine_pose(*args, huber_delta=HUBER, damping=DAMPING)
    ref = rp.refine_pose_plain(*args, huber_delta=HUBER, damping=DAMPING)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert rp.launches == 0 and not any(kernels.launch_counts().values())


def test_plain_edge_cases():
    """The contract the kernel is held to on the card: a row with every mask
    false comes back unchanged with cost 0; N = 0 too; a NaN in R0 gives a
    NaN pose; points at or behind z = 0 stay finite (the 1e-6 clamp)."""
    Kt, R0, t0, X, z, mask = pnp_problem(4, 50, 2)
    mask[1] = False
    R0[2, 0, 1] = float("nan")
    X[3, :10, 2] = -X[3, :10, 2]  # behind the camera
    X[3, 10:20, 2] = 0.0
    out = rp.refine_pose_plain(Kt, R0, t0, X, z, mask, HUBER, DAMPING)
    assert torch.equal(out.R[1], R0[1]) and torch.equal(out.t[1], t0[1])
    assert float(out.cost[1]) == 0.0 and int(out.num_used[1]) == 0
    assert torch.isnan(out.R[2]).all() and torch.isnan(out.t[2]).all()
    assert torch.isfinite(out.R[3]).all() and torch.isfinite(out.t[3]).all()
    empty = rp.refine_pose_plain(Kt, R0, t0, X[:, :0], z[:, :0], mask[:, :0], HUBER, DAMPING)
    assert torch.equal(empty.R[0], R0[0]) and torch.equal(empty.t[0], t0[0])
    assert not empty.cost.any() and not empty.num_used.any()


def _bad_inputs():
    Kt, R0, t0, X, z, mask = pnp_problem(2, 8, 3)
    return {
        "K float64": (Kt.double(), R0, t0, X, z, mask),
        "mask float": (Kt, R0, t0, X, z, mask.float()),
        "R0 batch": (Kt, R0[:1], t0, X, z, mask),
        "z width": (Kt, R0, t0, X, z[..., :1], mask),
        "X not (..., N, 3)": (Kt, R0, t0, X[..., :2], z, mask),
        "N differs": (Kt, R0, t0, X, z[:, :4], mask),
    }


@pytest.mark.parametrize("label", list(_bad_inputs()))
def test_wrapper_rejects(label):
    with pytest.raises((TypeError, ValueError)):
        rp.refine_pose(*_bad_inputs()[label])


def test_registered():
    """The module is one of ops.kernels.MODULES: launch_counts reports it and
    reset_launch_counts sets it to 0."""
    assert kernels.MODULES["refine_pose"] is rp
    assert "refine_pose.cu" in _build.SOURCES
    rp.launches = 5
    assert kernels.launch_counts()["refine_pose"] == 5
    kernels.reset_launch_counts()
    assert rp.launches == 0


def test_device_symbols_not_read_as_the_yardsticks_kernels():
    """slam_bench/yardstick.py finds its five kernels in a trace by
    substring; no `__global__` function of the new source may match one."""
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                       SOURCE.read_text())
    assert names == ["refine_pose_kernel"]
    symbols = [s for group in yardstick.KERNEL_SYMBOLS.values() for s in group]
    assert len(symbols) == 5
    assert not [(n, s) for n in names for s in symbols if s in n]


_CTYPES = {"const void*": _build._P, "void*": _build._P, "int": _build._I, "float": _build._F}


@pytest.mark.parametrize("entry", sorted(_build._SIGNATURES))
def test_c_signature_matches_source(entry):
    """Each entry point's ctypes argtypes agree with its extern "C"
    declaration (ctypes would cut a pointer passed as an int)."""
    text = "".join((Path(_build.CSRC) / name).read_text() for name in _build.SOURCES)
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
    assert m, entry
    params = [re.sub(r"\s+", " ", p.strip()) for p in m.group(1).split(",")]
    types = [_CTYPES[p.rsplit(" ", 1)[0].replace(" *", "*")] for p in params]
    assert tuple(types) == _build._SIGNATURES[entry]
