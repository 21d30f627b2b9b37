"""Batched, fully-fused, shardable multi-sequence tracking.

The reference tracks one sequence on one core with host-side keyframe
switching (``vors_track.rs:49-64``).  This module is the scaling path:

- ``track_step``: one frame of one sequence as a *pure function* of tracker
  state — pyramid, 6-level LM, flow check and keyframe switch all inside jit.
  The keyframe switch is data-dependent, so under SPMD it is expressed as a
  select over double-buffered keyframe state (recompute-and-select), which is
  the branch-free form ``vmap``/``pjit`` require.
- ``batched_track_step``: ``vmap`` over a batch of sequences (data
  parallelism per chip).
- Sharding: batch-dim ``NamedSharding`` over the ``data`` mesh axis makes the
  same jitted function run SPMD across chips, with XLA inserting collectives
  only where needed (there is no cross-sequence coupling, so DP is
  communication-free; the sharded-reduction TP path lives in
  ``parallel.sharded``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math.pose import Pose
from ..models import tracker as tracker_mod
from ..models.tracker import KeyframeData, TrackerConfig
from ..ops import pyramid as pyramid_ops
from ..utils.types import Float


class TrackState(NamedTuple):
    """Per-sequence tracker state as a pytree (batched with a leading axis)."""

    kf: KeyframeData
    keyframe_pose: Pose
    current_pose: Pose


class StepDiagnostics(NamedTuple):
    flow: jnp.ndarray
    failed: jnp.ndarray
    switched: jnp.ndarray
    # lanes recovered by in-graph relocalization this frame (always present;
    # all-False unless a RelocRing is threaded through the scan)
    relocalized: jnp.ndarray
    # per-level LM iteration counts, (..., nb_levels) int32 (0 = finest) —
    # the warm-start/iteration-budget observability (tools/ab_warmstart.py)
    nb_iters: jnp.ndarray


class RelocRing(NamedTuple):
    """Per-lane ring of the last R keyframes for in-graph relocalization.

    The batched analog of the host ``Tracker``'s ``_reloc_history``
    (models/relocalize.py): leaves carry ``(B, R, ...)``; ``count`` is the
    number of filled slots and ``head`` the next write position.  Slots are
    written with one-hot selects (no dynamic indexing)."""

    kf: KeyframeData  # leaves (B, R, ...)
    pose_q: jnp.ndarray  # (B, R, 4) keyframe camera-to-world quaternions
    pose_t: jnp.ndarray  # (B, R, 3)
    count: jnp.ndarray  # (B,) int32 filled slots
    head: jnp.ndarray  # (B,) int32 next slot to write


def init_state(
    config: TrackerConfig, intrinsics: Intrinsics, depth: jnp.ndarray, img: jnp.ndarray
) -> TrackState:
    """Functional ``Config::init`` (inverse_compositional.rs:74-100)."""
    pyr = pyramid_ops.mean_pyramid(config.nb_levels, img)
    kf = tracker_mod.precompute_keyframe(config, intrinsics, depth, pyr)
    return TrackState(
        kf=kf, keyframe_pose=pose_mod.identity(), current_pose=pose_mod.identity()
    )


def track_step(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    state: TrackState,
    depth: jnp.ndarray,
    img: jnp.ndarray,
):
    """One fully-fused tracking step: returns (new_state, diagnostics).

    Mirrors ``Tracker::track`` (inverse_compositional.rs:170-240) but as a
    pure function with the keyframe switch as a masked select, so it vmaps
    and shards.  The keyframe precompute runs every frame under SPMD (both
    branches of a data-dependent switch are materialized); this trades FLOPs
    for branch-free batched execution — the standard SIMD divergence tradeoff.
    """
    init_model = pose_mod.compose(pose_mod.inverse(state.current_pose), state.keyframe_pose)
    pyr = pyramid_ops.mean_pyramid(config.nb_levels, img)
    result = tracker_mod.track_frame(config, state.kf, pyr, init_model)

    new_current = jax.tree_util.tree_map(
        lambda ok, old: jnp.where(result.failed, old, ok),
        pose_mod.compose(state.keyframe_pose, pose_mod.inverse(result.model)),
        state.current_pose,
    )

    switch = result.flow >= config.flow_threshold
    new_kf = tracker_mod.precompute_keyframe(config, intrinsics, depth, pyr)
    kf = jax.tree_util.tree_map(
        lambda new, old: jnp.where(switch, new, old), new_kf, state.kf
    )
    keyframe_pose = jax.tree_util.tree_map(
        lambda new, old: jnp.where(switch, new, old), new_current, state.keyframe_pose
    )
    new_state = TrackState(kf=kf, keyframe_pose=keyframe_pose, current_pose=new_current)
    return new_state, StepDiagnostics(
        flow=result.flow, failed=result.failed, switched=switch,
        relocalized=jnp.zeros_like(switch), nb_iters=result.nb_iters,
    )


def batched_init_state(
    config: TrackerConfig, intrinsics: Intrinsics, depths: jnp.ndarray, imgs: jnp.ndarray
) -> TrackState:
    """Initialize a batch of sequences: depths/imgs are (B, H, W)."""
    return jax.vmap(lambda d, i: init_state(config, intrinsics, d, i))(depths, imgs)


def batched_init_ring(config: TrackerConfig, state: TrackState) -> RelocRing:
    """Seed a ``RelocRing`` from a freshly initialized batched state.

    Slot 0 of every lane holds the initial keyframe (like the host
    tracker's ring); the other ``R-1`` slots are copies masked out by
    ``count`` until real switches fill them.
    """
    R = config.relocalize_window
    assert R > 0, "config.relocalize_window must be > 0 to build a ring"
    B = state.keyframe_pose.q.shape[0]
    kf_ring = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(
            x[:, None], (x.shape[0], R) + x.shape[1:]
        ),
        state.kf,
    )
    return RelocRing(
        kf=kf_ring,
        pose_q=jnp.broadcast_to(state.keyframe_pose.q[:, None], (B, R, 4)),
        pose_t=jnp.broadcast_to(state.keyframe_pose.t[:, None], (B, R, 3)),
        count=jnp.ones((B,), jnp.int32),
        head=jnp.ones((B,), jnp.int32) % R,
    )


def _ring_write(ring: RelocRing, switched, new_kf, new_pose: Pose) -> RelocRing:
    """Append ``new_kf``/``new_pose`` for the switched lanes at each lane's
    head slot (one-hot select over R; non-switched lanes untouched)."""
    R = ring.pose_q.shape[1]
    slot_oh = jax.lax.iota(jnp.int32, R)[None, :] == ring.head[:, None]  # (B, R)
    write = jnp.logical_and(switched[:, None], slot_oh)  # (B, R)

    def bcast2(flag, like):
        return flag.reshape(flag.shape + (1,) * (like.ndim - flag.ndim))

    kf = jax.tree_util.tree_map(
        lambda rr, nn: jnp.where(bcast2(write, rr), nn[:, None], rr),
        ring.kf, new_kf,
    )
    pose_q = jnp.where(write[..., None], new_pose.q[:, None], ring.pose_q)
    pose_t = jnp.where(write[..., None], new_pose.t[:, None], ring.pose_t)
    head = jnp.where(switched, (ring.head + 1) % R, ring.head)
    count = jnp.where(
        switched, jnp.minimum(ring.count + 1, R), ring.count
    ).astype(jnp.int32)
    return RelocRing(kf=kf, pose_q=pose_q, pose_t=pose_t, count=count, head=head)


def batched_track_step(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    state: TrackState,
    depths: jnp.ndarray,
    imgs: jnp.ndarray,
):
    """vmap of ``track_step`` over the leading batch (sequence) axis."""
    return jax.vmap(
        lambda s, d, i: track_step(config, intrinsics, s, d, i)
    )(state, depths, imgs)


def _lane_onehot(pending: jnp.ndarray, k_sub: int) -> jnp.ndarray:
    """(K, B) bool selector: slot k ↦ the k-th pending lane in lane order.

    Rows beyond the pending count are all-zero.  Built from a cumsum rank and
    an equality compare — no dynamic indexing."""
    ranks = jnp.cumsum(pending.astype(jnp.int32)) - 1  # (B,)
    slots = jax.lax.iota(jnp.int32, k_sub)  # (K,)
    return jnp.logical_and(pending[None, :], ranks[None, :] == slots[:, None])


def _onehot_rows(sel: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Exact lane gather/scatter ``out[i] = x[j]  where sel[i, j]``.

    ``sel`` is 0/1 with at most one nonzero per row; all-zero rows produce
    zeros.  Works for ANY dtype bit-exactly: the array is bit-cast to u8 byte
    planes (every byte value 0-255 is exact in bf16), moved with one bf16
    matmul, and reassembled.  Because the matmul only ever sees finite u8
    values, lanes containing NaN-encoding f32 bits move without triggering
    ``0 * NaN`` poisoning.  This is the batch-lane analog of the channel
    gathers in ``tracker._extract_level_onehot``."""
    orig_dtype = x.dtype
    out_rows = sel.shape[0]
    xb = x.astype(jnp.uint8) if orig_dtype == jnp.bool_ else x
    if xb.dtype != jnp.uint8:
        xb = jax.lax.bitcast_convert_type(xb, jnp.uint8)
    flat = xb.reshape(xb.shape[0], -1).astype(jnp.bfloat16)
    rows = jnp.dot(
        sel.astype(jnp.bfloat16), flat, preferred_element_type=Float
    ).astype(jnp.uint8)
    rows = rows.reshape((out_rows,) + xb.shape[1:])
    if orig_dtype == jnp.bool_:
        return rows.astype(jnp.bool_)
    if orig_dtype != jnp.uint8:
        rows = jax.lax.bitcast_convert_type(rows, orig_dtype)
    return rows


def _recover_lost(
    config: TrackerConfig,
    lost: jnp.ndarray,  # (B,)
    pyrs,  # list of (B, h, w) pyramid levels of the current frame
    ring: RelocRing,
    new_current: Pose,  # (B,) lanes
    kf,  # batched KeyframeData after the switch select
    keyframe_pose: Pose,
):
    """In-graph relocalization for the batched scan (models/relocalize.py's
    vmapped attempt, fused into the serving loop).

    Behind a scan-level ``lax.cond`` on "is ANY lane lost?", so healthy
    frames pay nothing beyond the predicate; when taken, every lane solves
    against all R ring keyframes from identity inits (one (B, R) vmap) and
    lost lanes that verify adopt the recovered pose and re-activate the
    matched ring keyframe.  Unfilled ring slots are masked via ``count``.
    """
    R = ring.pose_q.shape[1]

    def keep(cur, kf_in, kfp):
        return cur, kf_in, kfp, jnp.zeros_like(lost)

    def recover(cur, kf_in, kfp):
        def per_lane(ring_kf_b, ring_q_b, ring_t_b, count_b, cur_b, *pyr_b):
            pyr_list = list(pyr_b)

            def per_slot(kf_r):
                res = tracker_mod.track_frame(
                    config, kf_r, pyr_list, pose_mod.identity()
                )
                obs = kf_r.levels[0]
                energy, _, inside = tracker_mod._eval_energy(
                    obs, pyr_list[0], res.model, config.interp_method
                )
                frac = jnp.sum(inside).astype(Float) / jnp.maximum(
                    jnp.sum(obs.valid).astype(Float), 1.0
                )
                return res.model, res.failed, energy, frac

            models, failed, energies, fracs = jax.vmap(per_slot)(ring_kf_b)
            empty = jax.lax.iota(jnp.int32, R) >= count_b
            bad = (
                failed
                | ~jnp.isfinite(energies)
                | (fracs < config.relocalize_min_inside_frac)
                | empty
            )
            score = jnp.where(bad, jnp.asarray(jnp.inf, Float), energies)
            best = jnp.argmin(score)
            ok = score[best] <= config.relocalize_energy_accept
            oh = jax.lax.iota(jnp.int32, R) == best  # (R,)

            def pick(x):
                flag = oh.reshape((R,) + (1,) * (x.ndim - 1))
                return jnp.where(flag, x, 0).sum(axis=0).astype(x.dtype)

            model_b = Pose(pick(models.q), pick(models.t))
            ring_pose_b = Pose(pick(ring_q_b), pick(ring_t_b))
            kf_b = jax.tree_util.tree_map(pick, ring_kf_b)
            recovered = pose_mod.compose(ring_pose_b, pose_mod.inverse(model_b))
            return recovered, kf_b, ring_pose_b, ok

        recovered, kf_best, kfp_best, ok = jax.vmap(per_lane)(
            ring.kf, ring.pose_q, ring.pose_t, ring.count,
            cur, *pyrs,
        )
        adopt = jnp.logical_and(lost, ok)

        def bcast(flag, like):
            return flag.reshape(flag.shape + (1,) * (like.ndim - flag.ndim))

        cur2 = jax.tree_util.tree_map(
            lambda new, old: jnp.where(bcast(adopt, new), new, old),
            recovered, cur,
        )
        kf2 = jax.tree_util.tree_map(
            lambda new, old: jnp.where(bcast(adopt, new), new, old),
            kf_best, kf_in,
        )
        kfp2 = jax.tree_util.tree_map(
            lambda new, old: jnp.where(bcast(adopt, new), new, old),
            kfp_best, kfp,
        )
        return cur2, kf2, kfp2, adopt

    return jax.lax.cond(
        jnp.any(lost), recover, keep, new_current, kf, keyframe_pose
    )


def _lazy_switch_step(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    state: TrackState,
    depth: jnp.ndarray,
    img: jnp.ndarray,
    batched: bool,
    pending=None,
    do_check=None,
    switch_subbatch: int = 0,
    ring: RelocRing | None = None,
    prev_pose: Pose | None = None,
):
    """One scan-body step with the keyframe precompute behind a real branch.

    ``track_step`` pays the keyframe precompute every frame because under
    ``vmap`` a data-dependent switch must be a select.  Inside a ``lax.scan``
    the step is NOT under vmap (the batch lives in the array leading axes),
    so the switch can be a genuine ``lax.cond`` on "did ANY sequence
    switch?" — XLA executes the precompute branch only on frames where at
    least one sequence actually switches keyframe (rare: flow >= 1 px at the
    coarsest level), which is what the reference's host loop does too
    (inverse_compositional.rs:224-239).  Per-sequence selects inside the
    taken branch keep the numerics identical to ``track_step``.

    ``pending``/``do_check`` implement *switch-cadence batching* for diverse
    batches (see ``batched_track_sequence(switch_cadence=...)``): lanes whose
    flow crossed the threshold are marked pending, and the precompute branch
    is only considered on check frames, where ALL pending lanes switch at
    once (using that frame's image/depth as the new keyframe).  With
    ``pending=None`` every frame is a check frame and the semantics reduce
    exactly to the reference's per-frame switching.

    ``prev_pose`` carries the previous frame's pose for the
    constant-velocity warm start (``config.warm_start``); ``None`` keeps the
    reference's constant-position init.  When given, the step also returns
    the next carry value (this frame's pre-update pose, with velocity
    zeroed across failed/lost/relocalized lanes).
    """
    vm = (lambda f: jax.vmap(f)) if batched else (lambda f: f)

    init_model = vm(
        lambda cp, kp, pp: tracker_mod.warm_start_init(config, kp, cp, pp)
    )(
        state.current_pose,
        state.keyframe_pose,
        prev_pose if prev_pose is not None else state.current_pose,
    )
    pyrs = vm(lambda i: pyramid_ops.mean_pyramid(config.nb_levels, i))(img)
    result = vm(
        lambda kf, *args: tracker_mod.track_frame(
            config, kf, list(args[:-1]), args[-1]
        )
    )(state.kf, *pyrs, init_model)

    def bcast(flag, like):
        return flag.reshape(flag.shape + (1,) * (like.ndim - flag.ndim))

    proposed = vm(
        lambda kp, m: pose_mod.compose(kp, pose_mod.inverse(m))
    )(state.keyframe_pose, result.model)
    new_current = jax.tree_util.tree_map(
        lambda ok, old: jnp.where(bcast(result.failed, ok), old, ok),
        proposed,
        state.current_pose,
    )

    reloc_on = ring is not None and config.relocalize_window > 0
    if reloc_on:
        assert batched, "in-graph relocalization requires the batched driver"
        # lost-track detector: final finest-level photometric energy against
        # the CURRENT (pre-switch) keyframe — same criterion as the host
        # Tracker's recovery path (models/tracker.py Tracker.track)
        def lane_energy(kf, pyr0, model):
            obs = kf.levels[0]
            energy, _, _ = tracker_mod._eval_energy(
                obs, pyr0, model, config.interp_method
            )
            return energy

        energies = jax.vmap(lane_energy)(state.kf, pyrs[0], result.model)
        lost = jnp.logical_or(
            result.failed,
            jnp.logical_or(
                ~jnp.isfinite(energies),
                energies > config.relocalize_energy_accept,
            ),
        )
    else:
        lost = jnp.zeros_like(result.failed)

    switch_now = result.flow >= config.flow_threshold
    if reloc_on:
        # a lost frame never becomes the map anchor (and does not pend):
        # mirrors the host Tracker's early return before the flow switch
        switch_now = jnp.logical_and(switch_now, ~lost)
    if pending is None:
        pending_all = switch_now
    else:
        pending_all = jnp.logical_or(pending, switch_now)
    # Lanes that pended on an EARLIER frame but are lost on THIS check frame
    # must not switch either — otherwise the lost frame becomes the map
    # anchor (and, worse, gets written into the RelocRing the recovery then
    # trivially "verifies" against).  They stay pending and switch on the
    # next check where they are healthy (typically right after recovery).
    switch_mask = jnp.logical_and(pending_all, ~lost) if reloc_on else pending_all
    if pending is None:
        check = jnp.any(switch_mask)
    else:
        check = jnp.logical_and(do_check, jnp.any(switch_mask))

    def _maybe_ring_write(ring_in, switched_mask, kf_new):
        if not reloc_on:
            return ring_in
        return _ring_write(ring_in, switched_mask, kf_new, new_current)

    def recompute(kf_old, kf_pose_old, ring_in):
        # All lanes recompute, per-lane select.  The "per-lane cond via
        # scan-over-lanes" alternative (only switching lanes execute the
        # precompute, serially) was implemented and measured worse on the
        # diverse benchmark on the previous accelerator, at cadence 1 and
        # more so at cadence 4 — batch-1 precomputes underuse the device and
        # the scan serializes them, which loses badly exactly when cadence
        # batching concentrates many lane-switches onto one frame.
        new_kf = vm(
            lambda d1, *p: tracker_mod.precompute_keyframe(
                config, intrinsics, d1, list(p)
            )
        )(depth, *pyrs)
        kf = jax.tree_util.tree_map(
            lambda new, old: jnp.where(bcast(switch_mask, new), new, old),
            new_kf, kf_old,
        )
        kfp = jax.tree_util.tree_map(
            lambda new, old: jnp.where(bcast(switch_mask, new), new, old),
            new_current,
            kf_pose_old,
        )
        ring_out = _maybe_ring_write(ring_in, switch_mask, kf)
        deferred = jnp.logical_and(pending_all, ~switch_mask)
        return kf, kfp, deferred, switch_mask, ring_out

    def recompute_sub(kf_old, kf_pose_old, ring_in):
        # Sub-batch switch compaction: the precompute's cost scales with the
        # number of lanes it runs on (channel gathers dominate),
        # but on a typical diverse check frame only 1-4 of B lanes actually
        # pend.  Compact the pending lanes into a fixed K-lane sub-batch with
        # one-hot byte-plane matmuls (bit-exact, `_onehot_rows`), precompute
        # ONLY the sub-batch, and scatter keyframe state back.  This branch is
        # entered only when the pending count fits (count <= K, outer cond),
        # so semantics are IDENTICAL to the all-lanes recompute — lanes never
        # wait.  Overflow frames (count > K) take the all-lanes branch.
        k_sub = switch_subbatch
        sel = _lane_onehot(switch_mask, k_sub)  # (K, B)
        sub_depth = _onehot_rows(sel, depth)
        sub_pyrs = [_onehot_rows(sel, p) for p in pyrs]
        sub_kf = jax.vmap(
            lambda d1, *p: tracker_mod.precompute_keyframe(
                config, intrinsics, d1, list(p)
            )
        )(sub_depth, *sub_pyrs)
        sel_t = sel.T  # (B, K): one nonzero for switching lanes, zero rows else
        kf = jax.tree_util.tree_map(
            lambda new, old: jnp.where(
                bcast(switch_mask, old), _onehot_rows(sel_t, new), old
            ),
            sub_kf,
            kf_old,
        )
        kfp = jax.tree_util.tree_map(
            lambda new, old: jnp.where(bcast(switch_mask, new), new, old),
            new_current,
            kf_pose_old,
        )
        ring_out = _maybe_ring_write(ring_in, switch_mask, kf)
        deferred = jnp.logical_and(pending_all, ~switch_mask)
        return kf, kfp, deferred, switch_mask, ring_out

    def keep(kf_old, kf_pose_old, ring_in):
        return (
            kf_old, kf_pose_old, pending_all, jnp.zeros_like(pending_all),
            ring_in,
        )

    ring_arg = ring if reloc_on else 0
    if batched and 0 < switch_subbatch < pending_all.shape[0]:
        n_pending = jnp.sum(switch_mask.astype(jnp.int32))

        def recompute_dispatch(kf_old, kf_pose_old, ring_in):
            return jax.lax.cond(
                n_pending <= switch_subbatch,
                recompute_sub,
                recompute,
                kf_old,
                kf_pose_old,
                ring_in,
            )

    else:
        recompute_dispatch = recompute

    kf, keyframe_pose, pending_out, switched, ring_out = jax.lax.cond(
        check, recompute_dispatch, keep, state.kf, state.keyframe_pose, ring_arg
    )

    relocalized = jnp.zeros_like(result.failed)
    if reloc_on:
        new_current, kf, keyframe_pose, relocalized = _recover_lost(
            config, lost, pyrs, ring_out, new_current, kf, keyframe_pose
        )

    new_state = TrackState(kf=kf, keyframe_pose=keyframe_pose, current_pose=new_current)
    diag = StepDiagnostics(
        flow=result.flow, failed=result.failed, switched=switched,
        relocalized=relocalized, nb_iters=result.nb_iters,
    )
    outs = (new_state, diag)
    if pending is not None:
        outs = outs + (pending_out,)
    if prev_pose is not None:
        # next step's velocity = prev_out⁻¹ ∘ new_current.  Normally prev_out
        # is this frame's pre-update pose; across a failed, lost, or
        # relocalized lane the motion is unreliable, so prev_out := the
        # post-update pose there (zero velocity → constant-position next).
        reset = result.failed
        if reloc_on:
            reset = jnp.logical_or(jnp.logical_or(reset, lost), relocalized)
        prev_out = jax.tree_util.tree_map(
            lambda cur_new, cur_old: jnp.where(bcast(reset, cur_new), cur_new, cur_old),
            new_current,
            state.current_pose,
        )
        outs = outs + (prev_out,)
    if reloc_on:
        outs = outs + (ring_out,)
    return outs


def track_sequence(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    state: TrackState,
    depths: jnp.ndarray,
    imgs: jnp.ndarray,
    prev_pose0: Pose | None = None,
    return_prev: bool = False,
):
    """Track a whole clip of F frames with one ``lax.scan``.

    The reference's frame loop lives on the host (vors_track.rs:49-64); here
    it compiles into the XLA program, so an entire sequence is ONE device
    dispatch — per-frame launch/transfer latency (the dominant cost of the
    latency-bound single-stream path) is paid once per clip instead of once
    per frame, and the keyframe precompute runs only on frames that actually
    switch (``_lazy_switch_step``).  ``depths``/``imgs`` are (F, H, W);
    returns the final state plus per-frame poses and diagnostics stacked on
    the leading axis.  With ``config.warm_start == "constant_velocity"`` the
    scan additionally carries the previous frame's pose; chunked callers
    thread it across dispatches via ``prev_pose0=`` / ``return_prev=True``
    (default: zero velocity at the clip start).
    """
    vel = config.warm_start == "constant_velocity"

    def body(carry, frame):
        s, prev = carry
        d, i = frame
        outs = _lazy_switch_step(
            config, intrinsics, s, d, i, batched=False,
            prev_pose=prev if vel else None,
        )
        if vel:
            s2, diag, prev2 = outs
        else:
            s2, diag = outs
            prev2 = prev
        return (s2, prev2), (s2.current_pose, diag)

    prev0 = prev_pose0 if (vel and prev_pose0 is not None) else state.current_pose
    (final, prev_out), out = jax.lax.scan(body, (state, prev0), (depths, imgs))
    if return_prev:
        return final, out, prev_out
    return final, out


def batched_track_sequence(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    state: TrackState,
    depths: jnp.ndarray,
    imgs: jnp.ndarray,
    switch_cadence: int = 1,
    switch_subbatch: int = 0,
    pending0: jnp.ndarray | None = None,
    frame_offset=0,
    return_pending: bool = False,
    reloc_ring: RelocRing | None = None,
    prev_pose0: Pose | None = None,
    return_prev: bool = False,
):
    """``lax.scan`` over frames of the vmapped step: clips are (F, B, H, W).

    The scan carries the batched ``TrackState``; sharding the B axis over a
    ``data`` mesh turns this into the one-dispatch-per-clip SPMD serving
    loop.  The keyframe precompute runs under a scan-level ``lax.cond``
    (only on frames where some sequence switches), unlike
    ``batched_track_step`` which must pay it every frame.

    ``switch_cadence=K`` batches keyframe switches across lanes: the
    precompute branch is only considered every K-th frame, and lanes whose
    flow crossed the threshold since the last check all switch together
    (to THAT frame, not the trigger frame).  With diverse sequences the
    "any lane switched?" cond otherwise fires ~B times as often as any
    single lane switches, paying the full batched precompute each time;
    cadence K bounds precompute frames to F/K at the cost of lanes tracking
    up to K-1 extra frames against a stale keyframe (benign: flows of
    1-2 px at the coarsest level are still well inside LM's convergence
    basin, and the ATE impact is measured in ``tests/test_parallel.py``).
    ``K=1`` is the reference-exact per-frame semantics.

    ``switch_subbatch=K_sub > 0`` compacts the pending lanes into a fixed
    ``K_sub``-lane sub-batch on check frames (one-hot byte-plane matmuls,
    bit-exact) and precomputes only those lanes, falling back to the
    all-lanes recompute when more than ``K_sub`` lanes pend at once — lanes
    never wait, so the switch pattern is IDENTICAL to ``switch_subbatch=0``
    and poses agree to f32 lowering reassociation (~1e-7: the K-lane vmap
    compiles the same per-lane precompute at a different batch size; the
    lane movement itself is bit-exact).  Cheaper because precompute cost
    scales with the lane count it runs on — though sub-linearly: small
    sub-batches underuse the device.  ``switch_subbatch=-1`` selects the
    rule ``K_sub = max(1, B // 4)``, the optimum of a K sweep at B=32 on the
    previous accelerator; ``tools/ab_subbatch.py`` re-measures it.

    For chunked serving (``vors_batch --chunk``), thread the cadence state
    across dispatches: pass ``pending0=`` the previous chunk's pending mask,
    ``frame_offset=`` the global index of this chunk's first frame, and
    ``return_pending=True`` to get the carry back — otherwise pending switch
    flags are dropped and check-frame phase restarts at every chunk boundary.

    With ``config.warm_start == "constant_velocity"`` the scan carries each
    lane's previous pose; chunked callers thread it via ``prev_pose0=`` /
    ``return_prev=True`` (default: zero velocity at the scan start).
    """
    nb_frames = depths.shape[0]
    batch = depths.shape[1]
    if switch_subbatch == -1:
        switch_subbatch = max(1, batch // 4)
    reloc_on = reloc_ring is not None
    if reloc_on and config.relocalize_window <= 0:
        raise ValueError(
            "reloc_ring passed but config.relocalize_window is 0; build the "
            "config with relocalize_window=R and the ring with "
            "batched_init_ring"
        )

    vel = config.warm_start == "constant_velocity"

    def body(carry, frame):
        s, pending, prev, rng = carry
        t, d, i = frame
        do_check = (t + 1) % switch_cadence == 0
        outs = _lazy_switch_step(
            config, intrinsics, s, d, i, batched=True,
            pending=pending, do_check=do_check,
            switch_subbatch=switch_subbatch,
            ring=rng if reloc_on else None,
            prev_pose=prev if vel else None,
        )
        if vel and reloc_on:
            s2, diag, pending2, prev2, ring2 = outs
        elif vel:
            s2, diag, pending2, prev2 = outs
            ring2 = rng
        elif reloc_on:
            s2, diag, pending2, ring2 = outs
            prev2 = prev
        else:
            s2, diag, pending2 = outs
            prev2, ring2 = prev, rng
        return (s2, pending2, prev2, ring2), (s2.current_pose, diag)

    if pending0 is None:
        pending0 = jnp.zeros((batch,), bool)
    prev0 = prev_pose0 if (vel and prev_pose0 is not None) else state.current_pose
    frame_idx = frame_offset + jnp.arange(nb_frames)
    (final, pending_out, prev_out, ring_out), out = jax.lax.scan(
        body, (state, pending0, prev0 if vel else 0,
               reloc_ring if reloc_on else 0),
        (frame_idx, depths, imgs),
    )
    outs = (final, out)
    if return_pending:
        outs = outs + (pending_out,)
    if return_prev:
        outs = outs + (prev_out if vel else final.current_pose,)
    if reloc_on:
        outs = outs + (ring_out,)
    return outs


def make_sharded_step(config: TrackerConfig, intrinsics: Intrinsics, mesh, axis="data"):
    """jit the batched step with batch-dim shardings over ``mesh``.

    Inputs and state are sharded on their leading axis over ``axis``; XLA
    compiles one SPMD program per chip with no cross-chip communication
    (sequences are independent).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    def shard_like(tree):
        def spec(x):
            if hasattr(x, "ndim") and x.ndim > 0:
                return NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
            return NamedSharding(mesh, P())

        return jax.tree_util.tree_map(spec, tree)

    def step(state, depths, imgs):
        return batched_track_step(config, intrinsics, state, depths, imgs)

    return jax.jit(step)
