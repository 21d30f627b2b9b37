"""In-graph cost of the batched relocalization layer at production shapes.

Three variants of the diverse fused scan (B=32, 640x480, 6 levels, cap
4096, R=4 ring slots), switches disabled (flow_threshold=inf) so the
switch cond does not confound:

    none      no ring threaded (the plain diverse tracking floor)
    healthy   ring threaded, accept threshold high: no lane ever goes
              lost -> pays only the per-frame lost-detector energy eval
              and the `any(lost)` cond predicate
    taken     ring threaded, accept threshold 0: every lane reads as lost
              every frame (nothing verifies, nothing is adopted) -> the
              full recovery branch (B x R track_frame solves from
              identity) executes EVERY frame: worst-case cost-when-taken

steady-state overhead / frame = healthy - none
recovery cost / taken frame   = taken - healthy

Run:  python tools/ab_reloc_cost.py
"""

import dataclasses
import json
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

    h, w, F, B, R = 480, 640, 10, 32, 4
    cache_file = (
        pathlib.Path(__file__).resolve().parents[1]
        / ".bench_cache" / f"diverse_v2_{B}x{F}_{h}x{w}.npz"
    )
    base = synthetic.generate_sequence(nb_frames=1, height=h, width=w, seed=0)
    intr = base.intrinsics
    data = np.load(cache_file)
    div_grays, div_depths = data["grays"], data["depths"]
    clip_d = jnp.asarray(div_depths[:B, 1:].transpose(1, 0, 2, 3))
    clip_g = jnp.asarray(div_grays[:B, 1:].transpose(1, 0, 2, 3))

    def measure(label, accept, use_ring):
        config = tracker_mod.TrackerConfig(
            height=h, width=w, nb_levels=6, candidate_cap=4096,
            flow_threshold=float("inf"),
            relocalize_window=R if use_ring else 0,
            relocalize_energy_accept=accept,
        )
        state = jax.jit(
            lambda d, g: batch_mod.batched_init_state(config, intr, d, g)
        )(jnp.asarray(div_depths[:B, 0]), jnp.asarray(div_grays[:B, 0]))
        ring = (
            jax.jit(lambda s: batch_mod.batched_init_ring(config, s))(state)
            if use_ring else None
        )

        def go(s, r, dd, gg):
            return batch_mod.batched_track_sequence(
                config, intr, s, dd, gg,
                reloc_ring=r if use_ring else None,
            )

        run = jax.jit(go)
        outs = run(state, ring, clip_d, clip_g)
        jax.block_until_ready(outs[0].current_pose.t)
        n_lost = (
            int(jnp.sum(outs[1][1].relocalized)) if use_ring else -1
        )
        n = 4
        t0 = time.perf_counter()
        for _ in range(n):
            outs = run(state, ring, clip_d, clip_g)
        jax.block_until_ready(outs[0].current_pose.t)
        ms = (time.perf_counter() - t0) * 1e3 / (n * F)
        print(json.dumps({
            "mode": label, "ms_per_step": round(ms, 2),
            "fps_per_chip": round(1e3 * B / ms, 1),
            "relocalized_total": n_lost,
        }), flush=True)
        return ms

    t_none = measure("none", 150.0, False)
    t_healthy = measure("healthy", 1e12, True)
    t_taken = measure("taken", 0.0, True)
    print(json.dumps({
        "mode": "summary",
        "steady_overhead_ms_per_frame": round(t_healthy - t_none, 2),
        "recovery_ms_per_taken_frame": round(t_taken - t_healthy, 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
