"""Decompose the diverse fused-scan step cost: tracking vs precompute.

Two terms to separate:

1. DIVERSE TRACKING is intrinsically dearer than broadcast: the vmapped LM
   ``while_loop`` runs until ALL lanes converge (max-iterations-over-lanes),
   so desynchronized lanes pay near-worst-case iteration counts.
2. The in-scan precompute (behind the ``lax.cond``) may cost more than an
   isolated measurement (branch overhead, select machinery).

Method: run the SAME diverse clip through ``batched_track_sequence`` with
(a) switches disabled (flow_threshold=inf -> pure tracking cost T_div),
(b) cadence-1 all-lanes (T_div + 0.8 P_all),
(c) cadence-1 subbatch-8 (T_div + 0.8 P_sub),
within one process.

Run:  python tools/ab_step_decompose.py
"""

import dataclasses
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from visual_odometry_rs_tpu.dataset import synthetic
    from visual_odometry_rs_tpu.models import tracker as tracker_mod
    from visual_odometry_rs_tpu.parallel import batch as batch_mod

    h, w, F, B = 480, 640, 10, 32
    config = tracker_mod.TrackerConfig(
        height=h, width=w, nb_levels=6, candidate_cap=4096
    )
    cache_file = (
        pathlib.Path(__file__).resolve().parents[1]
        / ".bench_cache" / f"diverse_v2_{B}x{F}_{h}x{w}.npz"
    )
    base = synthetic.generate_sequence(nb_frames=1, height=h, width=w, seed=0)
    intr = base.intrinsics
    data = np.load(cache_file)
    div_grays, div_depths = data["grays"], data["depths"]

    state = jax.jit(
        lambda d, g: batch_mod.batched_init_state(config, intr, d, g)
    )(jnp.asarray(div_depths[:B, 0]), jnp.asarray(div_grays[:B, 0]))
    clip_d = jnp.asarray(div_depths[:B, 1:].transpose(1, 0, 2, 3))
    clip_g = jnp.asarray(div_grays[:B, 1:].transpose(1, 0, 2, 3))

    def measure(label, cfg, subbatch):
        run = jax.jit(
            lambda s, dd, gg: batch_mod.batched_track_sequence(
                cfg, intr, s, dd, gg, switch_subbatch=subbatch
            )
        )
        final, (poses, diags) = run(state, clip_d, clip_g)
        jax.block_until_ready(final.current_pose.t)
        switch_frames = int(jnp.any(diags.switched, axis=1).sum())
        n = 4
        t0 = time.perf_counter()
        for _ in range(n):
            final, _ = run(state, clip_d, clip_g)
        jax.block_until_ready(final.current_pose.t)
        ms_per_step = (time.perf_counter() - t0) * 1e3 / (n * F)
        print(
            json.dumps(
                {"mode": label, "ms_per_step": round(ms_per_step, 2),
                 "fps_per_chip": round(1e3 * B / ms_per_step, 1),
                 "switch_frames": switch_frames}
            ),
            flush=True,
        )
        return ms_per_step, switch_frames

    # (a) pure diverse tracking: switches disabled
    cfg_nosw = dataclasses.replace(config, flow_threshold=float("inf"))
    t_div, _ = measure("diverse_noswitch", cfg_nosw, 0)
    # (b) all-lanes precompute
    t_all, sf_all = measure("diverse_all_lanes", config, 0)
    # (c) subbatch 8
    t_sub, sf_sub = measure("diverse_subbatch8", config, 8)
    # (d) broadcast floor for reference
    bcast_d = jnp.stack([jnp.asarray(div_depths[0, 1:])] * B, axis=1)
    bcast_g = jnp.stack([jnp.asarray(div_grays[0, 1:])] * B, axis=1)
    state_b = jax.jit(
        lambda d, g: batch_mod.batched_init_state(config, intr, d, g)
    )(
        jnp.asarray(np.broadcast_to(div_depths[0, 0], (B, h, w)).copy()),
        jnp.asarray(np.broadcast_to(div_grays[0, 0], (B, h, w)).copy()),
    )
    run_b = jax.jit(
        lambda s, dd, gg: batch_mod.batched_track_sequence(
            cfg_nosw, intr, s, dd, gg
        )
    )
    final, _ = run_b(state_b, bcast_d, bcast_g)
    jax.block_until_ready(final.current_pose.t)
    t0 = time.perf_counter()
    for _ in range(4):
        final, _ = run_b(state_b, bcast_d, bcast_g)
    jax.block_until_ready(final.current_pose.t)
    t_bcast = (time.perf_counter() - t0) * 1e3 / (4 * F)
    print(json.dumps({"mode": "broadcast_noswitch",
                      "ms_per_step": round(t_bcast, 2),
                      "fps_per_chip": round(1e3 * B / t_bcast, 1)}), flush=True)

    p_all = (t_all - t_div) * F / max(sf_all, 1)
    p_sub = (t_sub - t_div) * F / max(sf_sub, 1)
    print(json.dumps({
        "mode": "decomposition",
        "T_div_ms": round(t_div, 2),
        "T_broadcast_ms": round(t_bcast, 2),
        "P_all_in_scan_ms": round(p_all, 2),
        "P_sub8_in_scan_ms": round(p_sub, 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
