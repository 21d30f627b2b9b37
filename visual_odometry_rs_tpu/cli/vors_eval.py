"""CLI: evaluate a TUM trajectory against ground truth (ATE / RPE).

    python -m visual_odometry_rs_tpu.cli.vors_eval groundtruth.txt trajectory.txt

The in-repo analog of the external evaluation repo the reference points to
(mpizenberg/rgbd-tracking-evaluation, reference README.md:18-19): absolute
trajectory error after Umeyama alignment, and relative pose error over
``--delta``-frame intervals.  Prints one JSON line to stdout.

Timestamps are matched greedily within ``--max-dt`` seconds (the standard
TUM association rule), so the estimate need not cover every ground-truth
frame.
"""

from __future__ import annotations

import argparse
import json
import sys

USAGE = "Usage: vors_eval groundtruth_file trajectory_file"


def associate(gt, est, max_dt: float):
    """Global best-first timestamp matching (the TUM benchmark's
    associate.py rule): collect every (|dt|, gt, est) candidate within
    ``max_dt``, sort by |dt|, accept greedily when both sides are unused.

    Candidate enumeration bisects the sorted ground-truth timestamps for the
    window around each estimate — O(C log G + C log C) with C the number of
    in-window candidate pairs, instead of the naive O(E*G) double loop
    (which costs tens of seconds on long fr2 sequences)."""
    import bisect

    gt_ts = [g.timestamp for g in gt]
    candidates = []
    for i, f in enumerate(est):
        lo = bisect.bisect_left(gt_ts, f.timestamp - max_dt)
        hi = bisect.bisect_right(gt_ts, f.timestamp + max_dt)
        for j in range(lo, hi):
            dt = abs(f.timestamp - gt_ts[j])
            if dt <= max_dt:
                candidates.append((dt, j, i))
    candidates.sort()
    used_gt, used_est = set(), set()
    pairs = []
    for _, j, i in candidates:
        if j not in used_gt and i not in used_est:
            used_gt.add(j)
            used_est.add(i)
            pairs.append((j, i))
    pairs.sort()
    return pairs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(usage=USAGE)
    parser.add_argument("groundtruth_file")
    parser.add_argument("trajectory_file")
    parser.add_argument("--delta", type=int, default=1, help="RPE frame interval")
    parser.add_argument("--max-dt", type=float, default=0.02,
                        help="max timestamp difference for matching (s)")
    parser.add_argument("--scale", action="store_true",
                        help="also estimate a similarity scale in the alignment")
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")  # trivial host-side math: no device needed

    from ..dataset import tum_rgbd
    from ..eval import ate as ate_mod

    try:
        with open(args.groundtruth_file) as f:
            gt = tum_rgbd.parse_trajectory(f.read())
        with open(args.trajectory_file) as f:
            est = tum_rgbd.parse_trajectory(f.read())
    except OSError as e:
        print(USAGE, file=sys.stderr)
        print(f"Cannot read inputs: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"Malformed trajectory line: {e}", file=sys.stderr)
        return 1

    pairs = associate(gt, est, args.max_dt)
    if len(pairs) < 2:
        print(f"only {len(pairs)} matched frames (max_dt={args.max_dt})", file=sys.stderr)
        return 1
    gt_m = [gt[j].pose for j, _ in pairs]
    est_m = [est[i].pose for _, i in pairs]

    ate = ate_mod.ate_rmse(est_m, gt_m, with_scale=args.scale)
    if args.delta < len(pairs):
        rpe_t, rpe_r = ate_mod.rpe_rmse(est_m, gt_m, delta=args.delta)
        rpe_t, rpe_r = round(rpe_t, 6), round(rpe_r, 6)
    else:
        # fewer matched frames than the RPE interval: no pairs to evaluate
        # (NaN would make the output line invalid JSON)
        rpe_t = rpe_r = None
    print(
        json.dumps(
            {
                "matched_frames": len(pairs),
                "ate_rmse_m": round(ate, 6),
                "rpe_trans_rmse_m": rpe_t,
                "rpe_rot_rmse_rad": rpe_r,
                "delta": args.delta,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
