"""Where the card and the CPU part inside a tracking step's tail (ROADMAP
Faults (g)), stage by stage, on chip_smoke.py's [track] scene.

    python tools/torch_tail_split.py        # on a machine with an NVIDIA GPU

The card runs chip_smoke.py's [track] chain (orbit frames 0-10 at 192x640,
its RANSAC noise) and each stage of every step's tail (`_step_from_feats`:
windowed_match, ransac_essential, triangulate, refine_pose) is recorded
with its inputs and run again on the CPU from the card's own inputs, so
that each gap is that stage's alone. The depth-ratio scale (the lower
median of the pairs' ratios) is printed with its neighbours: how far the
scale moves when two ratios swap places. RANSAC also runs on the card with
the nullspace and svd3 kernels swapped for their plain versions (the same
arithmetic on CUDA tensors, so the kernels' share of the gap drops out),
and every RANSAC result is held against the same RANSAC in float64 on the
CPU. Prints one line per stage and step, and a summary.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from chip_smoke import _to_cpu  # noqa: E402


def _gap(a, b):
    """max |a - b| over the floating fields, and whether every other field
    is equal, of two results of one stage (CPU tensors)."""
    a, b = (x if isinstance(x, (tuple, list)) else (x,) for x in (a, b))
    d, same = 0.0, True
    for x, y in zip(a, b):
        if x.is_floating_point():
            d = max(d, float((x.double() - y.double()).abs().max()))
        else:
            same = same and torch.equal(x, y)
    return d, same


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_tail_split: no CUDA device")
    import maveric_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    from maveric_slam_tpu_torch.data import synthetic
    from maveric_slam_tpu_torch.frontend import extractor
    from maveric_slam_tpu_torch.frontend import tracker as trk
    from maveric_slam_tpu_torch.geometry import epipolar, ransac
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.ops.kernels import nullspace, svd3

    cfg = smoke._config()
    poses = synthetic.orbit_poses(smoke.ORBIT_N)[:smoke.N_FRAMES]
    frames = [synthetic.render_box_room(cfg.working_camera.K, p, smoke.H, smoke.W) for p in poses]
    gen = torch.Generator().manual_seed(0)
    m, k = cfg.frontend.top_n, cfg.ransac.num_hypotheses
    noises = [(ransac.gumbel((k, m), gen, "cpu"), ransac.gumbel((ransac.lo_hypotheses(k), m), gen, "cpu"))
              for _ in range(smoke.N_FRAMES - 1)]

    stages = {"windowed_match": trk.matching, "ransac_essential": trk.ransac,
              "triangulate": trk.epipolar, "refine_pose": trk.pnp}
    plain = {name: getattr(mod, name) for name, mod in stages.items()}
    rec = {}

    def recording(name):
        def run(*a, **kw):
            out = plain[name](*a, **kw)
            rec[name] = (a, kw, out)
            return out
        return run

    def ransac_with(fn_null, fn_svd, a, kw):
        """ransac_essential with epipolar's nullspace and svd3 swapped."""
        keep = epipolar.smallest_eigvec_inverse_iteration, epipolar.svd3
        epipolar.smallest_eigvec_inverse_iteration, epipolar.svd3 = fn_null, fn_svd
        try:
            return plain["ransac_essential"](*a, **kw)
        finally:
            epipolar.smallest_eigvec_inverse_iteration, epipolar.svd3 = keep

    cuda = torch.device("cuda")
    params = sp.load_params(device=cuda)
    state = trk._batched(trk.init_state(params, torch.from_numpy(frames[0]).to(cuda), cfg, 0))
    rows = []
    for name, mod in stages.items():
        setattr(mod, name, recording(name))
    try:
        for j, (f, (gmin, glo)) in enumerate(zip(frames[1:], noises)):
            feats = extractor.extract_quantized_batched(params, torch.from_numpy(f)[None].to(cuda), cfg)
            prev = state
            state, _ = trk._step_from_feats(state, feats, cfg, gmin[None].to(cuda), glo[None].to(cuda))
            snap = dict(rec)  # the step's own calls (the runs below record theirs)
            row = {}
            for name in stages:
                a, kw, out = snap[name]
                row[name] = _gap(_to_cpu(out), plain[name](*_to_cpu(a), **_to_cpu(kw)))
            a, kw, out = snap["ransac_essential"]
            on_card_plain = ransac_with(nullspace.nullspace_plain, svd3.svd3_plain, a, kw)
            exact = ransac_with(nullspace.nullspace_plain, svd3.svd3_plain, _to_cpu(a, torch.float64),
                                _to_cpu(kw, torch.float64))
            cpu32 = plain["ransac_essential"](*_to_cpu(a), **_to_cpu(kw))
            row["ransac, card with plain nullspace/svd3, vs CPU"] = _gap(_to_cpu(on_card_plain), cpu32)
            for label, r in (("card", out), ("CPU", cpu32)):
                row[f"ransac, {label} vs float64"] = _gap(_to_cpu(r, torch.float64)[:3], exact[:3])
            # The depth-ratio scale's neighbourhood on the card.
            X = snap["triangulate"][2][0]
            depth_ok = out.inliers[0] & (X[:, 2] > 1e-3) & (X[:, 2] < 1e3)
            cell0 = snap["windowed_match"][2].cell0[0].long()
            c0 = torch.clamp(cell0, min=0)
            ok = depth_ok & prev.depth_valid[0][c0] & (cell0 >= 0)
            ratio = torch.sort((prev.depth[0][c0] / torch.clamp(X[:, 2], min=1e-6))[ok]).values.cpu()
            i = (len(ratio) - 1) // 2
            near = ratio[max(i - 1, 0):i + 2].tolist()
            rows.append(row)
            print(f"[tail-split] step {j}: " + "; ".join(
                f"{n} max |d| {d:.3g}{'' if same else ' (integer fields differ)'}"
                for n, (d, same) in row.items())
                + f"; scale pairs {len(ratio)}, ratios around the lower median "
                + " ".join(f"{x:.6g}" for x in near), flush=True)
    finally:
        for name, mod in stages.items():
            setattr(mod, name, plain[name])
    print("[tail-split] largest over the steps: " + "; ".join(
        f"{n} {max(r[n][0] for r in rows):.3g}" for n in rows[0]), flush=True)


if __name__ == "__main__":
    main()
