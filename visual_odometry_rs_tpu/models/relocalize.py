"""Relocalization: recover a lost track against a ring of recent keyframes.

Green-field capability — the reference has no recovery path: a frame whose
level solve fails simply keeps its previous pose and tracking silently
degrades from there (inverse_compositional.rs:195-199).  Here, when the
host ``Tracker`` detects a lost frame (Cholesky failure or final
finest-level photometric energy above a threshold), it re-tracks the frame
against its last K keyframes and, if one of them verifies photometrically,
adopts the recovered pose and re-activates that keyframe as the anchor —
the "kidnapped robot returns to a known place" scenario.

Formulation: all K candidate keyframes are solved in ONE jitted
vmapped coarse-to-fine LM dispatch (the same batched-verification shape as
``models/loop_closure.py``); init models are identity ("the camera is near
one of these keyframes"), NOT the stale current pose — after a kidnap the
current pose is exactly what cannot be trusted.  Ranking and acceptance
reuse the loop-closure criteria: finite final energy, minimum in-image
fraction, Cholesky success.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..math import pose as pose_mod
from ..math.pose import Pose
from ..utils.types import Float
from . import tracker as tracker_mod


class RelocalizeResult(NamedTuple):
    pose: Pose  # recovered camera-to-world pose (valid iff ``ok``)
    best: jnp.ndarray  # int32: index of the chosen keyframe in the history
    energy: jnp.ndarray  # f32: its final finest-level mean squared residual
    ok: jnp.ndarray  # bool: some keyframe verified under the thresholds


def attempt(
    config,
    kfs,  # stacked KeyframeData pytree, leading axis K
    kf_q: jnp.ndarray,  # (K, 4) keyframe camera-to-world quaternions
    kf_t: jnp.ndarray,  # (K, 3) keyframe camera-to-world translations
    pyr: List[jnp.ndarray],  # current-frame pyramid (shared by all lanes)
    energy_accept: float,
    min_inside_frac: float,
) -> RelocalizeResult:
    """One vmapped LM solve of the current frame against K keyframes.

    Jittable; the caller jits per history length K (K is small and bounded
    by ``relocalize_window``, so at most K distinct compilations).
    """

    def one(kf):
        result = tracker_mod.track_frame(
            config, kf, pyr, pose_mod.identity()
        )
        obs = kf.levels[0]
        energy, _, inside = tracker_mod._eval_energy(
            obs, pyr[0], result.model, config.interp_method
        )
        frac = jnp.sum(inside).astype(Float) / jnp.maximum(
            jnp.sum(obs.valid).astype(Float), 1.0
        )
        return result.model, result.failed, energy, frac

    models, failed, energies, fracs = jax.vmap(one)(kfs)

    bad = failed | ~jnp.isfinite(energies) | (fracs < min_inside_frac)
    score = jnp.where(bad, jnp.asarray(jnp.inf, Float), energies)
    best = jnp.argmin(score)
    ok = score[best] <= energy_accept
    # model maps keyframe pixels into the current frame, so the recovered
    # camera-to-world pose is T_kf ∘ model⁻¹ (same algebra as
    # Tracker._step's ``proposed``)
    model_b = Pose(models.q[best], models.t[best])
    kf_pose_b = Pose(kf_q[best], kf_t[best])
    pose = pose_mod.compose(kf_pose_b, pose_mod.inverse(model_b))
    return RelocalizeResult(
        pose=pose, best=best.astype(jnp.int32), energy=energies[best], ok=ok
    )


def stack_history(history: List[Tuple]):
    """Stack a host list of (KeyframeData, Pose, …) into vmap-ready batches.

    All entries must be UNBUCKETED precompute outputs (identical static
    shapes); the host ``Tracker`` guarantees this by recording the raw
    ``precompute_keyframe`` result before bucketing.
    """
    kfs = jax.tree_util.tree_map(
        lambda *leaves: jnp.stack(leaves), *[entry[0] for entry in history]
    )
    kf_q = jnp.stack([entry[1].q for entry in history])
    kf_t = jnp.stack([entry[1].t for entry in history])
    return kfs, kf_q, kf_t
