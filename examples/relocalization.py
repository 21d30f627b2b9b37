"""Relocalization demo: the kidnapped-robot scenario.

The reference tracker has no recovery path — a frame whose solve fails
keeps its previous pose and tracking silently degrades from there
(reference src/core/track/inverse_compositional.rs:195-199).  This demo
drives the camera away from its start, teleports it back ("kidnap"), and
compares the reference-exact behavior against ``--relocalize``-style
recovery (``TrackerConfig.relocalize_window``): the tracker re-tracks the
lost frame against its recent-keyframe ring in one vmapped LM dispatch and
re-anchors to the best verified match.

Run: ``python examples/relocalization.py``
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu") if "--device" not in sys.argv else None

import jax.numpy as jnp

from visual_odometry_rs_tpu.dataset import synthetic, tum_rgbd
from visual_odometry_rs_tpu.math import pose as pose_mod
from visual_odometry_rs_tpu.models import tracker as tracker_mod


def main():
    step = [0.03, 0.004, 0.002, 0.0, 0.02, 0.0]
    total = -4.0 * np.asarray(step)
    small = [0.008, 0.002, 0.001, 0.0, 0.004, 0.0]
    twists = np.asarray([step] * 4 + [list(total)] + [small, small], np.float32)
    seq = synthetic.generate_sequence(
        nb_frames=len(twists) + 1, height=120, width=160, seed=23,
        twist_per_frame=twists,
    )
    kidnap_at = 5

    def run(window):
        config = tracker_mod.TrackerConfig(
            height=120, width=160, nb_levels=3, candidate_cap=1024,
            depth_scale=tum_rgbd.DEPTH_SCALE, interp_method="gather",
            relocalize_window=window,
        )
        trk = tracker_mod.init_tracker(
            config, seq.intrinsics, 0.0, jnp.asarray(seq.depths[0]),
            0.0, jnp.asarray(seq.grays[0]),
        )
        errs = []
        for i in range(1, len(seq.grays)):
            trk.track(float(i), jnp.asarray(seq.depths[i]),
                      float(i), jnp.asarray(seq.grays[i]))
            err = float(
                np.linalg.norm(
                    np.asarray(trk.current_pose.t) - np.asarray(seq.poses[i].t)
                )
            )
            errs.append(err)
        return trk, errs

    trk_off, errs_off = run(0)
    trk_on, errs_on = run(4)

    print(f"frames: {len(seq.grays)}, kidnap at frame {kidnap_at}")
    print(f"{'frame':>5} {'err (no recovery)':>18} {'err (relocalize=4)':>19}")
    for i, (a, b) in enumerate(zip(errs_off, errs_on), start=1):
        marker = "  <- kidnap" if i == kidnap_at else ""
        print(f"{i:>5} {a:>18.4f} {b:>19.4f}{marker}")
    print(f"relocalizations fired: {trk_on.relocalizations}")
    assert trk_on.relocalizations >= 1
    assert errs_on[-1] < 0.05 < errs_off[-1]
    print("recovered: post-kidnap error "
          f"{errs_off[-1] / max(errs_on[-1], 1e-9):.0f}x smaller with recovery")


if __name__ == "__main__":
    main()
