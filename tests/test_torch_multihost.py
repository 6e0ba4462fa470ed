"""The port's mesh across real processes joined the way torchrun joins
them, and the `track` CLI's --mesh, on the CPU (gloo).

- tests/torch_multihost_worker.py, started twice with MASTER_ADDR,
  MASTER_PORT, RANK and WORLD_SIZE set: sharded BA, the word-sharded pool
  and the frame-sharded LCD ring against the single-device port (the port's
  counterpart of tests/test_multihost.py);
- `cli.track --mesh 2 --device cpu` on rendered 192x640 PNGs, once
  starting its two ranks itself and once as two processes with torchrun's
  environment: rank 0 alone prints and writes the poses; it refuses to
  resume a checkpoint that does not divide over its ranks;
- ranks end themselves when the process that spawned them is killed;
- concurrent first builds of the CUDA kernel library: two processes build
  into one empty directory at once with a stub in place of nvcc; one of
  them compiles, and both get the same library.
Every process has a wall limit, and a test kills what it started.
"""

import os
import socket
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from maveric_slam_tpu_torch.config import DEFAULT_CONFIG
from maveric_slam_tpu_torch.data import kitti, synthetic
from maveric_slam_tpu_torch.parallel import mesh as tmesh
import torch_mesh_worker as worker
import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(cmd, world, timeout=WALL_S):
    """`cmd` once a rank, with torchrun's environment; [(returncode, output)]."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = torch_threads.subprocess_env(
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
            LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world), PYTHONPATH=REPO)
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
        return [(p.returncode, out) for p, out in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_multiprocess_sharded_components():
    outs = _run_ranks([sys.executable, os.path.join(REPO, "tests", "torch_multihost_worker.py")], 2)
    for rank, (code, out) in enumerate(outs):
        assert code == 0 and f"OK p{rank}" in out, out


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Five orbit frames at the CLI's 192x640 as PNGs (BA at frame 4)."""
    import cv2

    cfg = DEFAULT_CONFIG
    d = tmp_path_factory.mktemp("mesh_images")
    for k, p in enumerate(synthetic.orbit_poses(96, radius=8.0)[:5]):
        f = synthetic.render_box_room(cfg.working_camera.K, p, cfg.frontend.height, cfg.frontend.width)
        cv2.imwrite(str(d / f"{k:06d}.png"), (f * 255).round().astype(np.uint8))
    return d


def test_track_cli_mesh_spawns_its_ranks(images, tmp_path):
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR")}
    res = subprocess.run([sys.executable, "-m", "maveric_slam_tpu_torch.cli.track", str(images),
                          "--out-dir", str(out), "--device", "cpu", "--mesh", "2"],
                         cwd=REPO, env=dict(env, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=WALL_S)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.count("mesh of 2 ranks over gloo on cpu") == 1, res.stdout
    assert res.stdout.count(f"wrote {out}/poses.txt (5 poses)") == 1, res.stdout
    assert kitti.read_poses(str(out / "poses.txt")).shape == (5, 4, 4)


def test_track_cli_mesh_under_torchrun_environment(images, tmp_path):
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "maveric_slam_tpu_torch.cli.track", str(images), "--out-dir",
           str(out), "--device", "cpu", "--mesh", "2", "--max-frames", "3"]
    (code0, out0), (code1, out1) = _run_ranks(cmd, 2)
    assert code0 == 0 and code1 == 0, out0 + out1
    assert f"wrote {out}/poses.txt (3 poses)" in out0 and "wrote" not in out1, (out0, out1)
    assert kitti.read_poses(str(out / "poses.txt")).shape == (3, 4, 4)


def test_track_cli_mesh_refuses_checkpoints(images, tmp_path):
    """--mesh takes --checkpoint and --resume (tests/test_torch_mesh_checkpoint.py),
    but refuses to resume a checkpoint whose LCD ring does not divide over
    its ranks: every rank raises before it reads a frame, and the CLI fails
    with the reason."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    np.savez(ckpt / "state_00000003.npz", db_multihot=np.zeros((4095, 1), np.int8))
    (ckpt / "meta.json").write_text('{"state_file": "state_00000003.npz", "enable_loop_closure": true}')
    res = subprocess.run([sys.executable, "-m", "maveric_slam_tpu_torch.cli.track", str(images),
                          "--device", "cpu", "--mesh", "2", "--resume", str(ckpt),
                          "--out-dir", str(tmp_path / "out")],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                         text=True, timeout=WALL_S)
    assert res.returncode != 0, res.stdout
    assert "the checkpoint's 4095 LCD ring frames do not divide over a mesh of 2 ranks" in res.stderr
    assert not (tmp_path / "out").exists()


def _alive(pid: int) -> bool:
    """The process exists and is not a zombie awaiting its reaper."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_ranks_end_when_their_launcher_is_killed(tmp_path):
    """`spawn`'s ranks outlive no launcher killed with SIGKILL (a
    preempted `cli.track --mesh`): each ends itself within seconds."""
    import signal
    import time

    code = ("import torch_mesh_worker as w; from maveric_slam_tpu_torch.parallel import mesh; "
            f"mesh.spawn(w.sleep_forever, 2, args=({str(tmp_path)!r},), device='cpu', threads=1, "
            "timeout_s=None)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    launcher = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO)
    try:
        deadline = time.time() + WALL_S
        while len(list(tmp_path.glob("*.pid"))) < 2 and time.time() < deadline:
            assert launcher.poll() is None
            time.sleep(0.1)
        pids = [int(p.read_text()) for p in tmp_path.glob("*.pid")]
        assert len(pids) == 2 and all(_alive(p) for p in pids)
    finally:
        launcher.send_signal(signal.SIGKILL)
        launcher.wait(timeout=60)
    deadline = time.time() + 30
    while any(_alive(p) for p in pids) and time.time() < deadline:
        time.sleep(0.2)
    assert not any(_alive(p) for p in pids)


STUB_NVCC = """\
#!{python}
# Stands in for nvcc: logs each call, sleeps so that concurrent builds
# overlap, and writes the -o file.
import sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\\n")
time.sleep(0.5)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built\\n")
"""


def test_concurrent_first_builds_compile_once(tmp_path):
    """Two processes start `_build.build()` together in one empty build
    directory: one set of compiles and one link, both get the same path."""
    stub, log = tmp_path / "nvcc", tmp_path / "calls.log"
    stub.write_text(textwrap.dedent(STUB_NVCC.format(python=sys.executable, log=str(log))))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    build_dir = tmp_path / "build"
    paths = tmesh.spawn(worker.build_with_stub, 2, args=(str(build_dir), str(stub)), device="cpu",
                        threads=1, timeout_s=120)
    calls = log.read_text().split()
    from maveric_slam_tpu_torch.ops.kernels import _build

    assert calls.count("compile") == len(_build.SOURCES) and calls.count("link") == 1, calls
    assert paths[0] == paths[1] and os.path.exists(paths[0]), paths
    assert sorted(p.name for p in build_dir.iterdir() if p.suffix == ".so") == [
        os.path.basename(paths[0])]


def test_spawn_raises_a_failing_ranks_traceback():
    """A rank that raises while the others wait in a collective: its
    traceback reaches the caller and no rank is left running."""
    import multiprocessing

    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tmesh.spawn(worker.fail_on_rank, 3, args=(1,), device="cpu", threads=1, timeout_s=120)
    assert not multiprocessing.active_children()


def test_diverged_ranks_raise():
    with pytest.raises(RuntimeError, match="mesh ranks diverged at a test buffer"):
        tmesh.spawn(worker.diverge, 2, device="cpu", threads=1, timeout_s=120)


def test_mesh_engine_refuses_blocks_that_do_not_divide():
    """3 ranks cannot split the 4096-frame ring or the 10000-word pool."""
    msgs = tmesh.spawn(worker.engine_on_uneven_mesh, 3, args=(DEFAULT_CONFIG,), device="cpu",
                       threads=1, timeout_s=120)
    assert all("do not divide over a mesh of 3" in m for m in msgs), msgs
