"""Pairwise relative pose between two frames (the port's counterpart of
maveric_slam_tpu/cli/pairwise.py): estimates [R|t] for an image pair and
saves it as .npy, optionally with a match visualization.

Usage:
  python -m maveric_slam_tpu_torch.cli.pairwise IMG0 IMG1 [--outfile out.npy]
      [--viz matches.png] [--seed N] [--device cpu]

It runs on the CUDA device unless `--device cpu` is given; `--seed` seeds
the torch.Generator that draws the RANSAC samples.
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
    args = parser.parse_args(argv)

    import torch

    from ..config import DEFAULT_CONFIG
    from ..data import kitti
    from ..frontend import pairwise
    from ..models import superpoint as sp
    from ..ops.backend import resolve_device

    cfg = DEFAULT_CONFIG
    dev = resolve_device(args.device)
    params = sp.load_params(device=dev)
    img0 = kitti.load_frame(args.img0_path, cfg.frontend.height, cfg.frontend.width)
    img1 = kitti.load_frame(args.img1_path, cfg.frontend.height, cfg.frontend.width)
    t0, t1 = torch.from_numpy(img0).to(dev), torch.from_numpy(img1).to(dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    res = pairwise.pairwise_pose(params, t0, t1, cfg, generator=gen)
    R, t = res.R.cpu().numpy(), res.t.cpu().numpy()
    T = np.hstack([R, t[:, None]])
    print(f"matches: {int(res.num_matches)}  inliers: {int(res.num_inliers)}")
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
        from ..frontend import extractor
        from ..ops import matching
        from ..utils import visualization

        f0 = extractor.extract_golden(params, t0, cfg)
        f1 = extractor.extract_golden(params, t1, cfg)
        m = matching.nn_match_dot(f0.desc, f1.desc, f0.mask, f1.mask,
                                  dot_thresh=cfg.matcher.dot_thresh)
        visualization.draw_matches(img0, img1, f0.xy.cpu().numpy(),
                                   f1.xy.cpu().numpy()[m.index.cpu().numpy()],
                                   m.mask.cpu().numpy(), out_path=args.viz)
        print(f"saved {args.viz}")


if __name__ == "__main__":
    main()
