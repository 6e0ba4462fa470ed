"""Extract and serialize SuperPoint features for frames (the port's
counterpart of maveric_slam_tpu/cli/extract.py, with the same npz keys,
ground-truth grids and C header text):

  python -m maveric_slam_tpu_torch.cli.extract IMG [IMG ...] --out features.npz
      [--gt gt.npz] [--c-header features.h] [--device cpu]

--c-header also writes the reference's C layout (`imageN_semi[1920][65]`
etc., column-of-grid-major). It runs on the CUDA device unless
`--device cpu` is given.
"""

import argparse

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("images", nargs="+")
    parser.add_argument("--out", default="features.npz")
    parser.add_argument("--gt", default=None, help="also write float softmax grids")
    parser.add_argument("--c-header", default=None, help="emit reference-format C header")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    import torch

    from ..config import DEFAULT_CONFIG
    from ..data import kitti
    from ..models import superpoint as sp
    from ..ops.backend import resolve_device

    cfg = DEFAULT_CONFIG
    dev = resolve_device(args.device)
    params = sp.load_params(device=dev)
    arrays = {}
    gt_arrays = {}
    headers = []

    for i, path in enumerate(args.images):
        img = kitti.load_frame(path, cfg.frontend.height, cfg.frontend.width)
        semi_q, desc_q, scales = sp.superpoint_int8(params, torch.from_numpy(img).to(dev)[None])
        semi = semi_q[0].cpu().numpy()  # (Hc, Wc, 65)
        desc = desc_q[0].cpu().numpy()
        s_semi = float(scales["semi_scale"])
        s_desc = float(scales["desc_scale"])
        arrays[f"image{i}_semi"] = semi
        arrays[f"image{i}_desc"] = desc
        arrays[f"image{i}_semi_scale"] = np.float32(s_semi)
        arrays[f"image{i}_desc_scale"] = np.float32(s_desc)

        if args.gt:
            dense = np.exp(semi.astype(np.float64) * s_semi)
            dense /= dense.sum(-1, keepdims=True) + 1e-5
            nodust = dense[..., :64]
            gt_arrays[f"image{i}_probs_gt"] = nodust.max(-1).astype(np.float32)
            gt_arrays[f"image{i}_indices_gt"] = nodust.argmax(-1).astype(np.int32)

        if args.c_header:
            hc, wc = semi.shape[:2]
            lines = [
                f"const int image{i}_rows = {cfg.frontend.height};",
                f"const int image{i}_cols = {cfg.frontend.width};",
                f"const int image{i}_channels = 1;",
                f"const int image{i}_feature_rows = {hc};",
                f"const int image{i}_feature_cols = {wc};",
                f"const float image{i}_semi_scale = {s_semi};",
                f"const int8_t image{i}_semi[{hc * wc}][65] = {{",
            ]
            # Reference patch order: for c in cols, for r in rows.
            for c in range(wc):
                for r in range(hc):
                    lines.append(", ".join(str(v) for v in semi[r, c]) + ",")
            lines.append("};")
            lines.append(f"const float image{i}_desc_scale = {s_desc};")
            lines.append(f"const int8_t image{i}_desc[{hc * wc}][256] = {{")
            for c in range(wc):
                for r in range(hc):
                    lines.append(", ".join(str(v) for v in desc[r, c]) + ",")
            lines.append("};")
            headers.append("\n".join(lines))
        print(f"{path}: semi_scale={s_semi:.6f} desc_scale={s_desc:.6f}")

    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}")
    if args.gt:
        np.savez_compressed(args.gt, **gt_arrays)
        print(f"wrote {args.gt}")
    if args.c_header:
        with open(args.c_header, "w") as f:
            f.write("#pragma once\n\n#include <stdint.h>\n\n")
            f.write("const int cell_size = 8;\n\n")
            f.write("\n\n".join(headers) + "\n")
        print(f"wrote {args.c_header}")


if __name__ == "__main__":
    main()
