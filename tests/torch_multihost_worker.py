"""One process of the port's multi-process harness (tests/test_torch_multihost.py).

Started N times with torchrun's environment (MASTER_ADDR, MASTER_PORT,
RANK, WORLD_SIZE), it joins the process group through
`maybe_init_distributed`, exactly as a process that torchrun starts does,
and checks on the CPU (gloo), each rank on its own, against the
single-device port on the same inputs:
- landmark-sharded BA: R within 2e-4, t and this rank's X within 2e-3
  (tests/multihost_worker.py's bars for the JAX package);
- the word-sharded pool: covisibility weights and this rank's sighting
  block exact;
- the frame-sharded LCD ring with the engine's order (query, then add),
  wrapping the ring: every query equal to lcd.query on the whole database,
  the replicated cursor equal to it, and a revisit found.
Prints "OK p<rank>" and exits 0 when every check held. Imports neither JAX
nor the JAX package.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from maveric_slam_tpu_torch.backend import ba  # noqa: E402
from maveric_slam_tpu_torch.loopclosure import lcd, sharded_lcd  # noqa: E402
from maveric_slam_tpu_torch.mapping import feature_pool, sharded_pool  # noqa: E402
from maveric_slam_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from maveric_slam_tpu_torch.parallel import sharded_ba  # noqa: E402


def build_problem(num_landmarks=64, num_poses=4):
    """tests/multihost_worker.py's problem: a forward-moving camera, points
    offset by 0.05 from the truth."""
    rng = np.random.default_rng(0)
    K = np.array([[370.0, 0.0, 320.0], [0.0, 370.0, 96.0], [0.0, 0.0, 1.0]], np.float32)
    X = np.stack([rng.uniform(-8, 8, num_landmarks), rng.uniform(-3, 3, num_landmarks),
                  rng.uniform(8, 30, num_landmarks)], axis=-1).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (num_poses, 3, 3)).copy()
    t = np.stack([np.array([0.0, 0.0, -0.8 * p], np.float32) for p in range(num_poses)])
    p_cam = np.einsum("pij,lj->lpi", R, X) + t[None]
    uv = np.stack([K[0, 0] * p_cam[..., 0] / p_cam[..., 2] + K[0, 2],
                   K[1, 1] * p_cam[..., 1] / p_cam[..., 2] + K[1, 2]], axis=-1).astype(np.float32)
    return ba.BAProblem(K=K, R=R, t=t, X=X + 0.05, uv=uv, mask=p_cam[..., 2] > 1.0)


def main() -> int:
    torch.set_num_threads(1)
    assert mesh_lib.maybe_init_distributed(device="cpu")
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    mesh = mesh_lib.global_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (world, rank, "gloo"), mesh

    problem = build_problem()
    ref, _ = ba.bundle_adjust(ba.BAProblem(*(torch.as_tensor(a) for a in problem)), iterations=3)
    solved, costs = sharded_ba.sharded_bundle_adjust(sharded_ba.shard_problem(problem, mesh), mesh,
                                                     iterations=3)
    assert torch.isfinite(costs).all(), costs
    rows = mesh_lib.local_rows(problem.X.shape[0], mesh)
    np.testing.assert_allclose(solved.R.numpy(), ref.R.numpy(), rtol=0, atol=2e-4)
    np.testing.assert_allclose(solved.t.numpy(), ref.t.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(solved.X.numpy(), ref.X.numpy()[rows], rtol=0, atol=2e-3)

    rng = np.random.default_rng(5)
    vocab = 2048
    p_ref = feature_pool.create(vocab, window=4)
    p_sh = sharded_pool.create(vocab, 4, mesh)
    for f in range(6):
        ids = torch.from_numpy(rng.integers(-1, vocab, (64,)).astype(np.int32))
        p_ref = feature_pool.remove_old(feature_pool.observe_batch(p_ref, ids, f), f)
        p_sh = feature_pool.remove_old(sharded_pool.observe_batch(p_sh, ids, f, mesh), f)
    q = torch.from_numpy(rng.integers(-1, vocab, (48,)).astype(np.int32))
    assert torch.equal(sharded_pool.covisibility_weights(p_sh, q, mesh),
                       feature_pool.covisibility_weights(p_ref, q))
    assert torch.equal(p_sh.num_sightings, p_ref.num_sightings[mesh_lib.local_rows(vocab, mesh)])

    cap, vocab_l = 8 * world, 512
    db_ref = lcd.create_database(cap, vocab_l)
    db_sh = sharded_lcd.create_database(cap, vocab_l, mesh)
    rng_l = np.random.default_rng(9)
    history = []
    n_kf = cap + 3  # wraps the ring across the ranks
    for f in range(n_kf):
        revisit = f == n_kf - 1
        ids = history[2] if revisit else rng_l.choice(vocab_l, 40, replace=False).astype(np.int32)
        history.append(ids)
        got = sharded_lcd.sharded_query(db_sh, torch.from_numpy(ids), mesh, f, min_frame_gap=3,
                                        min_score=0.3)
        want = lcd.query(db_ref, torch.from_numpy(ids), f, min_frame_gap=3, min_score=0.3)
        assert (int(got.best), int(got.best_frame), float(got.best_score)) == (
            int(want.best), int(want.best_frame), float(want.best_score)), f
        db_sh = sharded_lcd.sharded_add_frame(db_sh, torch.from_numpy(ids), f, mesh)
        db_ref = lcd.add_frame(db_ref, torch.from_numpy(ids), f)
    assert db_sh.next_slot == db_ref.next_slot
    assert int(got.best_frame) == 2, int(got.best_frame)
    print(f"OK p{rank}: {world} processes, BA cost {float(costs[0]):.4f} -> "
          f"{float(costs[-1]):.6f}, pool and LCD ring ({n_kf} keyframes) equal", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
