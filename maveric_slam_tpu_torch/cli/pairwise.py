"""Pairwise relative pose between two frames (the port's counterpart of
maveric_slam_tpu/cli/pairwise.py): estimates [R|t] for an image pair and
saves it as .npy, optionally with a match visualization.

Usage:
  python -m maveric_slam_tpu_torch.cli.pairwise IMG0 IMG1 [--outfile out.npy]
      [--viz matches.png] [--seed N] [--device cpu] [--matcher dot|lightglue]

It runs on the CUDA device unless `--device cpu` is given; `--seed` seeds
the torch.Generator that draws the RANSAC samples. Both matchers run
through the batched pairwise path (`pairwise.pairwise_pose_batched`, one
pair): `--matcher dot` is the one-way best-dot match, `--matcher lightglue`
LightGlue (`models/lightglue.py`) at full depth and width with weights
drawn from `LightGlueConfig.weights_seed` (its published weights are not in
the repository), which also prints its counters. A pair with fewer than
sample_size matches reads not valid, with the identity pose.
"""

import argparse

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("img0_path")
    parser.add_argument("img1_path")
    parser.add_argument("--outfile", default=None, help="save 3x4 [R|t] .npy")
    parser.add_argument("--viz", default=None, help="save match visualization")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("--matcher", choices=("dot", "lightglue"), default="dot")
    args = parser.parse_args(argv)

    import torch

    from ..config import DEFAULT_CONFIG, LightGlueConfig
    from ..data import kitti
    from ..frontend import pairwise
    from ..models import lightglue
    from ..models import superpoint as sp
    from ..ops.backend import resolve_device

    cfg = DEFAULT_CONFIG
    dev = resolve_device(args.device)
    params = sp.load_params(device=dev)
    img0 = kitti.load_frame(args.img0_path, cfg.frontend.height, cfg.frontend.width)
    img1 = kitti.load_frame(args.img1_path, cfg.frontend.height, cfg.frontend.width)
    t0, t1 = torch.from_numpy(img0).to(dev), torch.from_numpy(img1).to(dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    matcher = "dot" if args.matcher == "dot" else lightglue.LightGlue(LightGlueConfig(), dev)
    f0 = pairwise.extract_features(params, t0[None], cfg)
    f1 = pairwise.extract_features(params, t1[None], cfg)
    res = pairwise.pairwise_pose_batched(f0, f1, cfg, matcher, generator=gen)
    if args.matcher == "lightglue":
        print(f"lightglue counters: {matcher.counters}")
    R, t = res.R[0].cpu().numpy(), res.t[0].cpu().numpy()
    T = np.hstack([R, t[:, None]])
    print(f"matches: {int(res.num_matches[0])}  inliers: {int(res.num_inliers[0])}  "
          f"valid: {bool(res.valid[0])}")
    print("Rotation matrix R:")
    print(R)
    print("Translation vector t (unit):")
    print(t)
    print("Transformation matrix [R|t]:")
    print(T)
    if args.outfile:
        np.save(args.outfile, T)
        print(f"saved {args.outfile}")
    if args.viz:
        from ..utils import visualization

        matches = res.matches[0].long().cpu().numpy()
        visualization.draw_matches(img0, img1, f0.xy[0].cpu().numpy(),
                                   f1.xy[0].cpu().numpy()[np.maximum(matches, 0)],
                                   matches >= 0, out_path=args.viz)
        print(f"saved {args.viz}")


if __name__ == "__main__":
    main()
