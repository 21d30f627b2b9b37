"""Loop-closure front-end: propose and photometrically verify loop edges.

The reference defers "loop closure" entirely (reference README.md:54-55) and
round 1 built only the back-end (``parallel.pose_graph``).  This module is
the missing front-end:

1. **Proposal** (``propose_candidates``): candidate pairs (i, j) whose
   *estimated* poses are close in position and orientation but far apart in
   time — the classic odometry-proximity gate.  Vectorized over all pairs.
2. **Verification** (``verify_candidate``): a candidate is accepted only if
   a full coarse-to-fine photometric alignment (the tracker's own
   ``track_frame`` machinery: keyframe i's candidates tracked against frame
   j's image, warm-started from the odometry estimate) converges with low
   mean photometric energy and enough candidates in view.  The refined
   relative pose becomes the loop edge measurement.
3. **Emission** (``detect_loops``): verified edges in the
   ``parallel.pose_graph`` convention (``Z_ij = T_i⁻¹ T_j``), ready for
   ``pose_graph.solve``.

Design notes: proposal is a tiny all-pairs computation; each verification is
one jitted multi-level LM solve (the same compiled program as regular
tracking, reused across candidates).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math.pose import Pose
from ..ops import pyramid as pyramid_ops
from ..utils.types import Float
from . import tracker as tracker_mod


@dataclass(frozen=True)
class LoopClosureConfig:
    """Gates for proposal and photometric verification."""

    # proposal: position / orientation proximity of ESTIMATED poses
    radius: float = 0.5  # meters
    max_angle: float = 0.6  # radians
    min_gap: int = 10  # frames of temporal separation
    max_candidates: int = 16  # closest-first cap on verification work
    # verification: photometric acceptance
    energy_accept: float = 300.0  # mean squared intensity over inside points
    min_inside_frac: float = 0.3  # fraction of keyframe candidates in view


def _stack(poses: Sequence[Pose]) -> Pose:
    return Pose(jnp.stack([p.q for p in poses]), jnp.stack([p.t for p in poses]))


def _pair_gates(t, q, ids, i, j, lc: LoopClosureConfig):
    """(passes, dist) for the ordered pair (i later, j earlier)."""
    if ids[i] - ids[j] <= lc.min_gap:
        return False, 0.0
    d = float(np.linalg.norm(t[i] - t[j]))
    if d >= lc.radius:
        return False, d
    # relative rotation angle from |<q_i, q_j>|: angle = 2 acos(|dot|)
    dot = abs(float(np.dot(q[i], q[j])))
    ang = 2.0 * np.arccos(min(max(dot, -1.0), 1.0))
    return ang < lc.max_angle, d


def propose_candidates(
    poses: Sequence[Pose], lc: LoopClosureConfig, node_ids=None
) -> List[Tuple[int, int]]:
    """Candidate loop pairs (i, j), ``ids[i] - ids[j] > min_gap``, by pose
    proximity.

    Returns pairs ordered by estimated distance (closest first), at most
    ``max_candidates``.  Proximity is evaluated on the given (drifty)
    estimates — verification decides truth.  ``node_ids`` (optional) maps
    each pose to its temporal identity (e.g. frame index when the poses are
    a keyframe subset); the gap gate uses these ids, defaulting to list
    positions.

    Scaling: candidates come from a spatial hash grid with cell size
    ``radius`` (each node checks its 27 neighboring cells), so proposal is
    O(N x local density) instead of the O(N²) all-pairs matrix the round-3
    version materialized — the difference between milliseconds and a dense
    (N, N, 3) numpy allocation at thousands of keyframes.  Results are
    identical to the all-pairs formulation (pinned by
    ``tests/test_loop_closure.py::test_propose_grid_matches_bruteforce``).
    """
    if lc.min_gap < 0:
        # with a negative gap BOTH temporal orderings of a pair can pass,
        # where the grid emits one ordered pair and the all-pairs
        # formulation emits two — and a "loop" between temporally adjacent
        # frames is meaningless anyway
        raise ValueError(f"min_gap must be >= 0, got {lc.min_gap}")
    P = _stack(poses)
    t = np.asarray(P.t, np.float64)  # (N, 3)
    q = np.asarray(P.q, np.float64)
    n = t.shape[0]
    ids = np.asarray(node_ids if node_ids is not None else np.arange(n))

    cell = max(float(lc.radius), 1e-9)
    grid: dict = {}
    pairs: List[Tuple[int, int]] = []
    dists: dict = {}
    cells_of = np.floor(t / cell).astype(np.int64)
    for i in range(n):
        ci = tuple(cells_of[i])
        # every unordered pair is examined exactly once: at the LATER list
        # index's insertion, against already-inserted nodes; both temporal
        # orderings are gated so non-monotonic node_ids still work
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for j in grid.get((ci[0] + dx, ci[1] + dy, ci[2] + dz), ()):
                        ok, d = _pair_gates(t, q, ids, i, j, lc)
                        if ok:
                            pairs.append((i, j))
                            dists[(i, j)] = d
                        else:
                            ok, d = _pair_gates(t, q, ids, j, i, lc)
                            if ok:
                                pairs.append((j, i))
                                dists[(j, i)] = d
        grid.setdefault(ci, []).append(i)

    pairs.sort(key=lambda p: (dists[p], p))
    if len(pairs) > lc.max_candidates:
        # no silent caps (repo standard): say what verification work the
        # closest-first truncation is dropping
        print(
            f"loop_closure: {len(pairs)} proposals, verifying closest "
            f"{lc.max_candidates}, dropping {len(pairs) - lc.max_candidates} "
            f"(raise max_candidates to verify more)",
            file=sys.stderr,
        )
    return pairs[: lc.max_candidates]


def _propose_bruteforce(
    poses: Sequence[Pose], lc: LoopClosureConfig, node_ids=None
) -> List[Tuple[int, int]]:
    """Round-3 all-pairs proposal, kept as the oracle for the grid version
    (O(N²) memory — do not use on long trajectories)."""
    P = _stack(poses)
    t = np.asarray(P.t, np.float64)
    q = np.asarray(P.q, np.float64)
    n = t.shape[0]
    ids = np.asarray(node_ids if node_ids is not None else np.arange(n))
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    gap_ok = ids[ii] - ids[jj] > lc.min_gap
    dist = np.linalg.norm(t[ii] - t[jj], axis=-1)
    dots = np.abs(np.sum(q[ii] * q[jj], axis=-1))
    ang = 2.0 * np.arccos(np.clip(dots, -1.0, 1.0))
    ok = gap_ok & (dist < lc.radius) & (ang < lc.max_angle)
    pairs = [(int(i), int(j)) for i, j in zip(ii[ok], jj[ok])]
    pairs.sort(key=lambda p: (dist[p[0], p[1]], p))
    return pairs[: lc.max_candidates]


def detect_loops(
    config: tracker_mod.TrackerConfig,
    intrinsics: Intrinsics,
    poses: Sequence[Pose],
    depths: Sequence,
    grays: Sequence,
    lc: LoopClosureConfig = LoopClosureConfig(),
    node_ids=None,
):
    """Propose + verify loop closures over a trajectory.

    ``poses`` are the (drifting) camera-to-world estimates; ``depths`` /
    ``grays`` the per-frame images.  Returns a list of
    ``(i, j, Z_ij: Pose, energy: float)`` verified edges in the
    ``parallel.pose_graph`` measurement convention ``Z_ij = T_i⁻¹ T_j``;
    ``pose_graph.odometry_graph(loop_edges=edges)`` accepts them directly
    (it ignores the trailing energy).

    All candidate verifications run as ONE vmapped multi-level LM dispatch
    (keyframe precompute is likewise one vmapped dispatch over the unique
    ``i`` frames) — on a long trajectory the round-2 serial host loop paid
    one device round trip per pair, which dominated wall time.
    """
    pairs = propose_candidates(poses, lc, node_ids=node_ids)
    if not pairs:
        return []

    uniq_i = sorted({i for i, _ in pairs})
    uniq_j = sorted({j for _, j in pairs})
    idx_i = jnp.asarray([uniq_i.index(i) for i, _ in pairs], jnp.int32)
    idx_j = jnp.asarray([uniq_j.index(j) for _, j in pairs], jnp.int32)

    pyr_batch = jax.jit(
        jax.vmap(lambda g: pyramid_ops.mean_pyramid(config.nb_levels, g))
    )
    precompute_batch = jax.jit(
        jax.vmap(
            lambda d, *p: tracker_mod.precompute_keyframe(
                config, intrinsics, d, list(p)
            )
        )
    )

    pyrs_i = pyr_batch(jnp.stack([jnp.asarray(grays[i]) for i in uniq_i]))
    kfs = precompute_batch(
        jnp.stack([jnp.asarray(depths[i]) for i in uniq_i]), *pyrs_i
    )
    pyrs_j = pyr_batch(jnp.stack([jnp.asarray(grays[j]) for j in uniq_j]))

    # tracker model convention: model maps keyframe i pixels into frame j:
    # model = T_j⁻¹ ∘ T_i  (cf. inverse_compositional.rs:177).  ONE jitted
    # batched compose — per-pair eager inverse/compose dispatches cost a
    # device round trip each.
    pose_i = Pose(
        jnp.stack([poses[i].q for i, _ in pairs]),
        jnp.stack([poses[i].t for i, _ in pairs]),
    )
    pose_j = Pose(
        jnp.stack([poses[j].q for _, j in pairs]),
        jnp.stack([poses[j].t for _, j in pairs]),
    )
    init_models = jax.jit(
        jax.vmap(lambda pj, pi: pose_mod.compose(pose_mod.inverse(pj), pi))
    )(pose_j, pose_i)

    def verify(kf, pyr_j_levels, init_model):
        result = tracker_mod.track_frame(config, kf, pyr_j_levels, init_model)
        # final photometric quality at the finest level
        obs = kf.levels[0]
        energy, _, inside = tracker_mod._eval_energy(
            obs, pyr_j_levels[0], result.model, config.interp_method
        )
        frac = jnp.sum(inside).astype(Float) / jnp.maximum(
            jnp.sum(obs.valid).astype(Float), 1.0
        )
        return result.model, result.failed, energy, frac

    @jax.jit
    def verify_all(kfs_sel, pyrs_sel, inits):
        return jax.vmap(
            lambda kf, init, *p: verify(kf, list(p), init)
        )(kfs_sel, inits, *pyrs_sel)

    kfs_sel = jax.tree_util.tree_map(lambda a: a[idx_i], kfs)
    pyrs_sel = [lvl[idx_j] for lvl in pyrs_j]
    models, failed, energies, fracs = verify_all(kfs_sel, pyrs_sel, init_models)

    failed = np.asarray(failed)
    energies = np.asarray(energies)
    fracs = np.asarray(fracs)
    edges = []
    for k, (i, j) in enumerate(pairs):
        e = float(energies[k])
        if (not bool(failed[k])) and np.isfinite(e) and e <= lc.energy_accept \
                and float(fracs[k]) >= lc.min_inside_frac:
            # Z_ij = T_i⁻¹ T_j = model⁻¹
            z = pose_mod.inverse(Pose(models.q[k], models.t[k]))
            edges.append((i, j, z, e))
    return edges
