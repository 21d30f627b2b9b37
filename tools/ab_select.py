"""A/B: coarse-to-fine select formulations, in-graph, one process.

The half-res corner formulation deinterleaves each level into four (h/2,
w/2) corner maps and re-interleaves the masks, strided ops both ways; the
rolled form avoids them.

Variants (bit-identical outputs, pinned in tests/test_candidates.py):

- corner: comparator network on 4 corner maps (the default)
- rolled: full-resolution partner-swap ranks (``_keep_mask_full``) — every
  pixel compares itself against its three 2x2-block partners via adjacent
  pair swaps (row-major reshape + size-2-axis reverse: layout-preserving,
  fully fusible)

Measured with the full-output-carry harness of ab_precompute_stages,
vmapped over lanes exactly like the stage harness.  Read rows within one
run only.

Run:  python tools/ab_select.py [lanes...]
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from visual_odometry_rs_tpu.core.candidates import coarse_to_fine
from visual_odometry_rs_tpu.dataset import synthetic
from visual_odometry_rs_tpu.models import tracker as tracker_mod
from visual_odometry_rs_tpu.ops import gradient as gradient_ops
from visual_odometry_rs_tpu.ops import pyramid as pyramid_ops

from ab_precompute_stages import honest_ms  # noqa: E402


def main() -> int:
    H, W = 480, 640
    config = tracker_mod.TrackerConfig(
        height=H, width=W, nb_levels=6, candidate_cap=4096
    )
    nb = config.nb_levels
    seq = synthetic.generate_sequence(nb_frames=1, height=H, width=W, seed=0)
    intr = seq.intrinsics

    def stage_select(impl):
        def fn(depth, pyr):
            grads = tracker_mod._keyframe_gradients(pyr)
            sqn = [gradient_ops.squared_norm_f32(gx, gy) for gx, gy in grads]
            mask = coarse_to_fine.select(
                config.candidates_diff_threshold, sqn, impl=impl
            )[-1]
            return grads, mask

        return fn

    def stage_full(impl):
        def fn(depth, pyr):
            orig = coarse_to_fine.select
            coarse_to_fine.select = (
                lambda t, lv, _o=orig, _i=impl: _o(t, lv, impl=_i)
            )
            try:
                return tracker_mod.precompute_keyframe(config, intr, depth, pyr)
            finally:
                coarse_to_fine.select = orig

        return fn

    lanes = [int(a) for a in sys.argv[1:]] or [32]
    for B in lanes:
        depth = jnp.asarray(
            np.broadcast_to(np.asarray(seq.depths[0]), (B, H, W)).copy()
        )
        img = jnp.asarray(
            np.broadcast_to(np.asarray(seq.grays[0]), (B, H, W)).copy()
        )
        pyrs = list(jax.jit(
            jax.vmap(lambda i: pyramid_ops.mean_pyramid(nb, i))
        )(img))
        for name, mk in (("grad_select", stage_select), ("full", stage_full)):
            for impl in ("corner", "rolled"):
                fn = mk(impl)
                vfn = lambda d, p, _f=fn: jax.vmap(
                    lambda d1, *p1: _f(d1, list(p1))
                )(d, *p)
                ms = honest_ms(vfn, depth, pyrs)
                print(json.dumps({
                    "stage": name, "impl": impl, "lanes": B,
                    "ms": round(ms, 2),
                }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
