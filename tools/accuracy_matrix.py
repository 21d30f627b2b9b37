"""Accuracy regression matrix: ATE across the product option space (CPU).

The reference validates accuracy externally (README.md:18-19 →
mpizenberg/rgbd-tracking-evaluation); this is the in-repo analog, run on
hermetic synthetic scenes so perf work cannot silently trade accuracy.
Covers {coarse_to_fine, dso, dso_fixed} x {L2, Huber} x {brightness on/off}
x {refine-window on/off} x {constant_position, constant_velocity,
cv+budget} — the full knob surface of the tracker product.

Run:  python tools/accuracy_matrix.py          # prints one JSON row per combo
Test: tests/test_accuracy_matrix.py pins bounds on the core combos in CI.

DSO default-threshold note: the DSO
regional threshold ``a (mean3x3(median) + b)^2`` at the reference default
``a=1.0`` admits too few points on weakly-textured synthetic renders
(ATE 0.0139 vs 0.0008 for coarse_to_fine); the matrix runs both DSO
selectors at the documented scene-tuned ``a=0.2``, and the ``dso_a1``
row records the default's behavior so the tuning story stays measured.
"""

from __future__ import annotations

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _scene(nb_frames=6, h=120, w=160, seed=0):
    from visual_odometry_rs_tpu.dataset import synthetic

    return synthetic.generate_sequence(
        nb_frames=nb_frames, height=h, width=w, seed=seed,
        twist_per_frame=[0.012, 0.004, 0.0, 0.002, 0.0, 0.001],
    )


# name -> TrackerConfig overrides (+ the special "refine" key)
COMBOS = {}
for sel, sel_kw in (
    ("c2f", {}),
    ("dso", {"candidate_selector": "dso", "dso_threshold_coef_a": 0.2}),
    ("dsofix", {"candidate_selector": "dso_fixed", "dso_threshold_coef_a": 0.2}),
):
    for rob, rob_kw in (("l2", {}), ("huber", {"robust_delta": 10.0})):
        for br, br_kw in (("nobr", {}), ("br", {"brightness_model": True})):
            for ref in ("noref", "refine"):
                name = f"{sel}_{rob}_{br}_{ref}"
                COMBOS[name] = ({**sel_kw, **rob_kw, **br_kw}, ref == "refine")
# warm-start rows (tracking-only)
COMBOS["c2f_l2_nobr_noref_cv"] = ({"warm_start": "constant_velocity"}, False)
COMBOS["c2f_l2_nobr_noref_cvbudget"] = (
    {"warm_start": "constant_velocity", "level_max_iterations": (20, 10, 5)},
    False,
)
# the DSO default-a story: reference default a=1.0 on weak synthetic texture
COMBOS["dso_a1_l2_nobr_noref"] = (
    {"candidate_selector": "dso", "dso_threshold_coef_a": 1.0}, False
)


def run_combo(seq, overrides, refine, nb_levels=3, cap=1024):
    import jax.numpy as jnp

    from visual_odometry_rs_tpu.eval import ate
    from visual_odometry_rs_tpu.math import pose as pose_mod
    from visual_odometry_rs_tpu.models import tracker as tracker_mod

    h, w = seq.grays[0].shape
    config = tracker_mod.TrackerConfig(
        height=h, width=w, nb_levels=nb_levels, candidate_cap=cap, **overrides
    )
    trk = tracker_mod.init_tracker(
        config, seq.intrinsics, 0.0, jnp.asarray(seq.depths[0]),
        0.0, jnp.asarray(seq.grays[0]),
    )
    est = [pose_mod.identity()]
    for f in range(1, len(seq.grays)):
        trk.track(float(f), jnp.asarray(seq.depths[f]), float(f),
                  jnp.asarray(seq.grays[f]))
        est.append(trk.current_pose)
    tracked_ate = ate.ate_rmse(est, seq.poses)
    if not refine:
        return tracked_ate, None

    from visual_odometry_rs_tpu.models import sliding_window

    sw = sliding_window.SlidingWindow(
        config, seq.intrinsics, window_size=3, max_iterations=8,
        interp_method="gather",
        robust_delta=overrides.get("robust_delta", 0.0),
        brightness=overrides.get("brightness_model", False),
    )
    refined = list(est)
    sw.start(seq.depths[0], seq.grays[0], est[0])
    for f in range(1, len(seq.grays)):
        ids, poses = sw.add_frame(seq.depths[f], seq.grays[f], est[f])
        for fid, p in zip(ids, poses):
            refined[fid] = p
    return tracked_ate, ate.ate_rmse(refined, seq.poses)


def main() -> int:
    seq = _scene()
    for name, (overrides, refine) in COMBOS.items():
        tracked, refined = run_combo(seq, overrides, refine)
        row = {"combo": name, "ate_tracked": round(tracked, 6)}
        if refined is not None:
            row["ate_refined"] = round(refined, 6)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
