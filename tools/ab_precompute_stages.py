"""In-graph stage breakdown of the batched keyframe precompute.

The harness carries the COMPLETE stage output tree as the scan carry and
feeds a negligible function of it back into the inputs, so nothing is
eliminable and nothing can be hoisted out of the loop (a harness that
carries only a scalar lets XLA drop most of each stage and under-measures
it).  Stages are cumulative prefixes of ``precompute_keyframe``:

    grad_select   gradients + squared-norms + coarse-to-fine mask
    idepth_pyr    + masked inverse depth + DSO-mean pyramid
    extract       + _extract_level_onehot at every level
    full          + warp Jacobians (= production precompute_keyframe)

Run:  python tools/ab_precompute_stages.py [lanes...]
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from visual_odometry_rs_tpu.core import camera as camera_mod
from visual_odometry_rs_tpu.core import inverse_depth as idepth_mod
from visual_odometry_rs_tpu.core.candidates import coarse_to_fine
from visual_odometry_rs_tpu.dataset import synthetic
from visual_odometry_rs_tpu.models import tracker as tracker_mod
from visual_odometry_rs_tpu.ops import gradient as gradient_ops
from visual_odometry_rs_tpu.ops import pyramid as pyramid_ops

N_ITER = 6


def honest_ms(fn, depth, pyrs, n=N_ITER):
    """Wall/iteration of ``fn(depth, pyrs)`` with the FULL output carried.

    The carry is the output tree; a ~1e-38-scaled scalar of it perturbs the
    pyramid inputs each iteration, creating a true loop-carried dependency
    without changing any shapes or (meaningfully) any values.
    """

    def feedback(out):
        leaf = jax.tree_util.tree_leaves(out)[0]
        return leaf.astype(jnp.float32).ravel()[0] * 1e-38

    out0 = jax.jit(fn)(depth, pyrs)

    def body(carry, _):
        c = feedback(carry)
        # dtype-preserving data dependency: xor with (c != c) — always 0,
        # but XLA cannot prove c is non-NaN, so nothing folds or hoists
        flag = (c != c).astype(jnp.uint8)
        p2 = [
            jnp.bitwise_xor(p, flag.astype(p.dtype))
            if jnp.issubdtype(p.dtype, jnp.integer) else p + c
            for p in pyrs
        ]
        return fn(depth, p2), None

    run = jax.jit(
        lambda o: jax.lax.scan(body, o, None, length=n)[0]
    )
    jax.block_until_ready(run(out0))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(run(out0))
    return (time.perf_counter() - t0) * 1e3 / n


def main() -> int:
    H, W = 480, 640
    config = tracker_mod.TrackerConfig(
        height=H, width=W, nb_levels=6, candidate_cap=4096
    )
    seq = synthetic.generate_sequence(nb_frames=1, height=H, width=W, seed=0)
    intr = seq.intrinsics
    nb = config.nb_levels
    intr_levels = camera_mod.multi_res(intr, nb)
    caps = config.level_caps()

    def stage_grads_only(depth, pyr):
        return tracker_mod._keyframe_gradients(pyr)

    def stage_grad_sqn(depth, pyr):
        grads = tracker_mod._keyframe_gradients(pyr)
        sqn = [gradient_ops.squared_norm_f32(gx, gy) for gx, gy in grads]
        return grads, sqn

    def stage_grad_select(depth, pyr):
        grads = tracker_mod._keyframe_gradients(pyr)
        sqn = [gradient_ops.squared_norm_f32(gx, gy) for gx, gy in grads]
        mask = coarse_to_fine.select(config.candidates_diff_threshold, sqn)[-1]
        return grads, mask

    def stage_idepth(depth, pyr):
        grads, mask = stage_grad_select(depth, pyr)
        id0 = idepth_mod.masked(
            idepth_mod.from_depth(
                config.depth_scale, depth, config.idepth_variance
            ),
            mask,
        )
        id_levels = idepth_mod.pyramid(id0, nb, strategy="dso_mean")
        return grads, id_levels

    def stage_extract(depth, pyr):
        grads, id_levels = stage_idepth(depth, pyr)
        outs = []
        for lvl in range(nb):
            gx, gy = grads[lvl]
            outs.append(tracker_mod._extract_level_onehot(
                id_levels[lvl], gx, gy, pyr[lvl], caps[lvl],
                depth_u16=depth if lvl == 0 else None,
                depth_scale=config.depth_scale,
            ))
        return outs

    def stage_full(depth, pyr):
        return tracker_mod.precompute_keyframe(config, intr, depth, pyr)

    stages = [
        ("grads_only", stage_grads_only),
        ("grad_sqn", stage_grad_sqn),
        ("grad_select", stage_grad_select),
        ("idepth_pyr", stage_idepth),
        ("extract", stage_extract),
        ("full", stage_full),
    ]

    ks = [int(k) for k in sys.argv[1:]] or [8, 32]
    for K in ks:
        depth = jnp.asarray(
            np.broadcast_to(np.asarray(seq.depths[0]), (K, H, W)).copy()
        )
        img = jnp.asarray(
            np.broadcast_to(np.asarray(seq.grays[0]), (K, H, W)).copy()
        )
        pyrs = list(jax.jit(
            jax.vmap(lambda i: pyramid_ops.mean_pyramid(nb, i))
        )(img))
        prev = 0.0
        for name, fn in stages:
            vfn = lambda d, p, _f=fn: jax.vmap(
                lambda d1, *p1: _f(d1, list(p1))
            )(d, *p)
            ms = honest_ms(vfn, depth, pyrs)
            print(json.dumps({
                "stage": name, "lanes": K, "ms": round(ms, 2),
                "delta_ms": round(ms - prev, 2),
            }), flush=True)
            prev = ms
    return 0


if __name__ == "__main__":
    sys.exit(main())
