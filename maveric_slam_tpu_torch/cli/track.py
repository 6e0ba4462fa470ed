"""Run the SLAM engine over an image sequence (the port's counterpart of
maveric_slam_tpu/cli/track.py):

  python -m maveric_slam_tpu_torch.cli.track IMAGE_DIR [--out-dir out/]
      [--img-glob '*.png'] [--skip N] [--max-frames N] [--no-ba]
      [--no-loop-closure] [--gt poses.txt] [--gt-offset N] [--plot]
      [--checkpoint ckpt/ [--checkpoint-every N]] [--resume ckpt/]
      [--seed N] [--device cpu] [--mesh N]

Writes KITTI-format poses (poses.txt), a PLY polyline (trajectory.ply),
with --gt the ATE/RPE metrics (metrics.json), and with --plot a top-down
plot (trajectory.png). Its closing lines print the loop closures and the
engine's counters (`SlamSystem.counters`: keyframes, BA windows dispatched
and skipped, loops accepted, pose-graph solves) with its loop
verifications. --checkpoint saves the engine's state there at the
end (utils/checkpoint.py), and every N frames with --checkpoint-every N;
--resume restores a checkpoint first and goes on from the frame after it.
It runs on the CUDA device unless `--device cpu` is given; `--seed` seeds
the RANSAC noise. Decoding the images needs cv2 or PIL; the plot needs
matplotlib.

--mesh N runs the mesh-mode engine over N ranks (SlamSystem(mesh=...):
window BA sharded by landmark, the LCD database by frame, the pool by
word). Under torchrun with WORLD_SIZE = N this process is one rank
(`torchrun --nproc-per-node N -m maveric_slam_tpu_torch.cli.track ...
--mesh N`); otherwise it starts the N ranks itself. Each rank runs on its
own card when there are enough (NCCL), else on the card they share, or on
the CPU with --device cpu (gloo); ranks it starts itself share this
process's torch threads. Only rank 0 writes or prints results.
--checkpoint and --resume work with --mesh too: every rank takes part in
each save (rank 0 writes the whole state, in the single engine's format)
and every rank restores from the directory, which all ranks must be able
to read; a checkpoint resumes on a mesh of any size that divides the LCD
ring and the vocabulary, or on one device.
"""

import argparse
import json
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("image_dir")
    parser.add_argument("--img-glob", default="*.png")
    parser.add_argument("--out-dir", default="out")
    parser.add_argument("--skip", type=int, default=1)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--no-ba", action="store_true")
    parser.add_argument("--no-loop-closure", action="store_true")
    parser.add_argument("--gt", default=None, help="KITTI GT pose file")
    parser.add_argument("--gt-offset", type=int, default=0)
    parser.add_argument("--checkpoint", default=None, help="save state here")
    parser.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="also checkpoint every N frames during the run (crash-safe: a kill mid-save "
        "leaves the previous checkpoint intact)")
    parser.add_argument("--resume", default=None, help="restore state first")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument(
        "--mesh", type=int, default=0,
        help="run the engine over an N-rank mesh (window BA landmark-sharded, LCD frame-sharded, "
        "pool word-sharded); 0 = one device")
    args = parser.parse_args(argv)
    if not args.mesh:
        _run(args)
        return
    from ..parallel import mesh as mesh_lib

    world = os.environ.get("WORLD_SIZE")
    if world is None:
        import torch

        # The ranks share this process's torch threads (OMP_NUM_THREADS).
        mesh_lib.spawn(_run, args.mesh, args=(args,), device=args.device, timeout_s=None,
                       threads=max(1, torch.get_num_threads() // args.mesh))
        return
    if int(world) != args.mesh:
        parser.error(f"--mesh {args.mesh} under a launcher with WORLD_SIZE={world}")
    import torch.distributed as dist

    mesh_lib.maybe_init_distributed(args.device)
    try:
        _run(args)
    finally:
        dist.destroy_process_group()


def _run(args) -> None:
    """The engine over the sequence: one device, or (args.mesh) this rank of
    the mesh, in a process that has joined its process group."""
    from ..config import DEFAULT_CONFIG
    from ..data import kitti
    from ..models import superpoint as sp
    from ..ops.backend import resolve_device
    from ..slam import SlamSystem
    from ..utils import checkpoint, evaluation, trajectory

    cfg = DEFAULT_CONFIG
    mesh = None
    if args.mesh:
        from ..parallel import mesh as mesh_lib

        mesh = mesh_lib.make_mesh(args.mesh, device=args.device)
        dev = mesh.device
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0  # the process that writes and prints
    say = print if lead else (lambda *a, **k: None)
    seq = kitti.ImageSequence(args.image_dir, cfg.frontend.height, cfg.frontend.width,
                              img_glob=args.img_glob, skip=args.skip)
    slam = SlamSystem(sp.load_params(device=dev), cfg, seed=args.seed,
                      ba_every=0 if args.no_ba else 4,
                      enable_loop_closure=not args.no_loop_closure, device=dev, mesh=mesh)
    if mesh is not None:
        say(f"mesh of {mesh.size} ranks over {mesh.backend} on {dev}")
    start = 0
    if args.resume:
        checkpoint.restore(slam, args.resume)
        start = slam.frame_idx + 1
        say(f"resumed at frame {start}")
    n = len(seq) if args.max_frames is None else min(len(seq), args.max_frames)
    with slam:
        for i in range(start, n):
            slam.process(seq[i])
            if args.checkpoint and args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
                checkpoint.save(slam, args.checkpoint)
            if slam.stats and i % 10 == 0:
                s = slam.stats[-1]
                say(f"frame {i}/{n}: matches={s['matches']} inliers={s['inliers']}"
                    f" scale={s['scale']:.3f}")
        poses = slam.trajectory()
    if args.checkpoint:  # collective in mesh mode: every rank saves, rank 0 writes
        checkpoint.save(slam, args.checkpoint)
    if not lead:
        return
    os.makedirs(args.out_dir, exist_ok=True)
    trajectory.save_kitti_poses(os.path.join(args.out_dir, "poses.txt"), poses)
    trajectory.write_ply(os.path.join(args.out_dir, "trajectory.ply"), poses[:, :3, 3])
    print(f"wrote {args.out_dir}/poses.txt ({len(poses)} poses)")
    if slam.loop_events:
        print(f"loop closures: {[(e.frame, e.matched_frame) for e in slam.loop_events]}")
    counts = dict(slam.counters, verifications=slam.verifications)
    print("counters: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    if args.checkpoint:
        print(f"checkpointed to {args.checkpoint}")

    gt = None
    if args.gt:
        gt = kitti.read_poses(args.gt)[args.gt_offset: args.gt_offset + len(poses)]
        metrics = {**evaluation.ate(poses, gt), **evaluation.rpe(poses, gt)}
        with open(os.path.join(args.out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        print(json.dumps(metrics, indent=2))

    if args.plot:
        from ..utils import visualization

        tracks = [("estimate", poses)] + ([("ground truth", gt)] if gt is not None else [])
        visualization.plot_trajectories(tracks, os.path.join(args.out_dir, "trajectory.png"))
        print(f"wrote {args.out_dir}/trajectory.png")


if __name__ == "__main__":
    main()
