"""Checkpoint / resume of tracker state (SURVEY §5).

The reference keeps tracker state in memory only; its de-facto checkpoint is
the stdout trajectory stream.  Here the tracker state is a small pytree
(keyframe data + poses + timestamps), so checkpointing is a generic
pytree↔npz round-trip — no external dependency, resumable mid-sequence, and
the same mechanism serializes the batched ``parallel.batch.TrackState``.

Checkpoints embed a format version and a tracker-config fingerprint;
``load_tracker`` refuses a checkpoint whose config doesn't match the live
tracker (a shape-compatible but semantically different config — e.g. changed
LM constants or interp method — would otherwise silently resume with stale
semantics).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Tuple

import jax
import numpy as np

FORMAT_VERSION = 2


class CheckpointMismatchError(RuntimeError):
    """Checkpoint is from a different format version or tracker config."""


# TrackerConfig fields added AFTER the v2 fingerprint scheme froze: excluded
# from the hash while at their defaults, so checkpoints written before the
# field existed keep resuming (a default-valued new knob cannot change the
# checkpointed state's semantics).  A NON-default value does change
# semantics and must change the fingerprint — then it stays in the payload.
_FINGERPRINT_DEFAULT_EXCLUDED = {
    # round 4: DSO candidate selector as a product option
    "candidate_selector": "coarse_to_fine",
    "dso_target": 2000,
    "dso_threshold_coef_a": 1.0,
    "dso_threshold_coef_b": 3,
    # round 5: warm start + per-level LM iteration budgets + fixed-block DSO
    "warm_start": "constant_position",
    "level_max_iterations": None,
    "dso_block_size": 4,
}


def _config_payload(config) -> dict:
    d = dataclasses.asdict(config)
    for k, default in _FINGERPRINT_DEFAULT_EXCLUDED.items():
        if d.get(k) == default:
            d.pop(k, None)
    return d


def _peek_meta(path: str) -> dict:
    """Read just the checkpoint metadata, closing the archive handle (the
    full pytree load happens later through ``load_pytree``)."""
    with np.load(path) as raw:
        return (
            json.loads(bytes(raw["__meta__"]).decode())
            if "__meta__" in raw else {}
        )


def config_fingerprint(config, intrinsics=None) -> str:
    """Stable hash of the tracker configuration (+ optional intrinsics)."""
    payload = {"config": _config_payload(config)}
    if intrinsics is not None:
        payload["intrinsics"] = [
            float(np.asarray(v)) for v in (intrinsics.cx, intrinsics.cy,
                                           intrinsics.fx, intrinsics.fy,
                                           intrinsics.skew)
        ]
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> None:
    """Serialize an arbitrary pytree of arrays to ``path`` (npz format).

    The write is ATOMIC (tmp file + ``os.replace``) so a crash mid-save
    cannot corrupt the previous checkpoint — periodic ``--save-state``
    overwrites the same file, and a truncated npz would make every later
    resume fail.  Writing through an open file handle also keeps the EXACT
    path (bare ``np.savez(path)`` silently appends ``.npz``, which would
    desynchronize save and load for extension-less paths)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    meta = dict(meta or {})
    meta.setdefault("format_version", FORMAT_VERSION)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    # treedef is reconstructed by the caller supplying a template tree


def load_pytree(path: str, template: Any) -> Tuple[Any, dict]:
    """Restore a pytree saved by ``save_pytree`` using ``template``'s
    structure (shapes/dtypes are taken from the file)."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
    leaves, treedef = jax.tree_util.tree_flatten(template)
    restored = [data[f"leaf_{i}"] for i in range(len(leaves))]
    import jax.numpy as jnp

    # keep 64-bit leaves as numpy: jnp.asarray would silently downcast them
    # to 32 bits (x64 is disabled), which destroys TUM epoch timestamps
    # (~1.3e9 s — f32 resolution there is ~128 s, gutting the
    # sequence-binding check) and large frame ids stored in checkpoint extras
    restored = [
        r if r.dtype in (np.float64, np.int64) else jnp.asarray(r)
        for r in restored
    ]
    return jax.tree_util.tree_unflatten(treedef, restored), meta


def save_tracker(path: str, tracker) -> None:
    """Checkpoint a ``models.tracker.Tracker``'s resumable state."""
    state = {
        "keyframe_data": tracker.keyframe_data,
        "keyframe_pose": tracker.keyframe_pose,
        "current_pose": tracker.current_pose,
    }
    # the constant-velocity warm-start carry; stored only when the mode is
    # on, so constant-position checkpoints keep the historical pytree
    # structure (the config fingerprint pins warm_start either way)
    if getattr(tracker.config, "warm_start", None) == "constant_velocity":
        state["prev_pose"] = tracker.prev_pose
    meta = {
        "format_version": FORMAT_VERSION,
        "config_fingerprint": config_fingerprint(tracker.config, tracker.intrinsics),
        "keyframe_depth_timestamp": tracker.keyframe_depth_timestamp,
        "keyframe_img_timestamp": tracker.keyframe_img_timestamp,
        "current_depth_timestamp": tracker.current_depth_timestamp,
        "current_img_timestamp": tracker.current_img_timestamp,
        "keyframe_switches": tracker.keyframe_switches,
    }
    save_pytree(path, state, meta)


def load_tracker(path: str, tracker) -> None:
    """Restore state saved by ``save_tracker`` into an initialized tracker
    with the same configuration.

    Raises ``CheckpointMismatchError`` if the checkpoint was written by a
    different format version or a tracker with a different config/intrinsics
    fingerprint.
    """
    vel_on = getattr(tracker.config, "warm_start", None) == "constant_velocity"
    template = {
        "keyframe_data": tracker.keyframe_data,
        "keyframe_pose": tracker.keyframe_pose,
        "current_pose": tracker.current_pose,
    }
    if vel_on:
        template["prev_pose"] = tracker.current_pose
    state, meta = load_pytree(path, template)
    version = meta.get("format_version")
    if version != FORMAT_VERSION:
        raise CheckpointMismatchError(
            f"checkpoint format version {version!r} != supported {FORMAT_VERSION} "
            f"({path})"
        )
    expected = config_fingerprint(tracker.config, tracker.intrinsics)
    found = meta.get("config_fingerprint")
    if found != expected:
        raise CheckpointMismatchError(
            f"checkpoint config fingerprint {found!r} does not match the live "
            f"tracker's {expected!r} — refusing to resume with mismatched "
            f"tracker semantics ({path})"
        )
    tracker.keyframe_data = state["keyframe_data"]
    tracker.keyframe_pose = state["keyframe_pose"]
    tracker.current_pose = state["current_pose"]
    # restore the warm-start carry (or zero the velocity, prev == current):
    # never extrapolate across a resume boundary from the construction-time
    # identity pose
    tracker.prev_pose = state.get("prev_pose", tracker.current_pose)
    tracker.keyframe_depth_timestamp = meta["keyframe_depth_timestamp"]
    tracker.keyframe_img_timestamp = meta["keyframe_img_timestamp"]
    tracker.current_depth_timestamp = meta["current_depth_timestamp"]
    tracker.current_img_timestamp = meta["current_img_timestamp"]
    tracker.keyframe_switches = meta["keyframe_switches"]
    _reset_reloc_ring(tracker)


def sequence_matches(saved_ts, associations) -> bool:
    """True iff ``saved_ts`` (consumed-frame depth timestamps stored in a
    checkpoint) is a prefix of ``associations``' timestamps.

    Binds a resume to its input sequence: the config fingerprint cannot
    tell two same-camera datasets apart.  Comparison is ABSOLUTE
    (``rtol=0``): TUM timestamps are ~1.3e9 s epoch seconds, where numpy's
    default ``rtol=1e-5`` would accept anything within ~13,000 s — i.e.
    every sequence from the same recording session."""
    saved = np.asarray(saved_ts, np.float64)
    if len(associations) < len(saved):
        return False
    live = np.array(
        [a.depth_timestamp for a in associations[: len(saved)]], np.float64
    )
    return bool(np.allclose(live, saved, rtol=0.0, atol=1e-6))


def _reset_reloc_ring(tracker) -> None:
    """Restart the relocalization keyframe ring after a checkpoint restore.

    The ring is a bounded cache, not trajectory state, so it is not
    serialized; re-seed it from the restored keyframe when its shapes are
    stackable (unbucketed), else let it refill on the next switches."""
    if getattr(tracker.config, "relocalize_window", 0) <= 0:
        return
    tracker._reloc_history = []
    if not tracker.config.bucket_candidates:
        tracker._reloc_history.append(
            (
                tracker.keyframe_data,
                tracker.keyframe_pose,
                tracker.keyframe_depth_timestamp,
                tracker.keyframe_img_timestamp,
            )
        )


# ---------------------------------------------------------------------------
# Sliding-window checkpoint/resume (SURVEY §5: "required once sliding-window
# BA exists" — the long-running refinement mode)
# ---------------------------------------------------------------------------


def sliding_window_fingerprint(sw) -> str:
    """Stable hash of everything that determines a SlidingWindow's
    semantics: tracker config, intrinsics, window geometry and solve
    options.  A resumed run with ANY of these changed would silently mix
    incompatible state."""
    payload = {
        "config": _config_payload(sw.config),
        "intrinsics": [
            float(np.asarray(v)) for v in (sw.intrinsics.cx, sw.intrinsics.cy,
                                           sw.intrinsics.fx, sw.intrinsics.fy,
                                           sw.intrinsics.skew)
        ],
        "window_size": sw.window_size,
        "marginalize": sw.marginalize,
        "switch_transfer": sw.switch_transfer,
        "coarse_level": sw.coarse_level,
        "solve_opts": {k: v for k, v in sorted(sw._solve_opts.items())},
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _window_kf_template(sw):
    """Keyframe-pytree TEMPLATE (structure only) via ``jax.eval_shape`` —
    no compute, no compile; leaf shapes/dtypes come from the file."""
    cfg = sw.config
    depth = jax.ShapeDtypeStruct((cfg.height, cfg.width), np.uint16)
    pyr = [jax.ShapeDtypeStruct(s, np.uint8) for s in cfg.level_shapes()]
    return jax.eval_shape(sw._precompute, depth, pyr).levels


def save_sliding_window(path: str, sw, extra: dict | None = None) -> None:
    """Checkpoint a ``models.sliding_window.SlidingWindow`` mid-sequence.

    ``extra``: optional caller-owned dict of name → array, stored alongside
    the window state and returned by ``load_sliding_window`` — e.g.
    ``vors_refine`` persists the refined-so-far trajectory here so a resume
    does not silently discard the refinement work of frames that had
    already left the window."""
    import jax.numpy as jnp

    extra = extra or {}
    state = {
        "kf_levels": sw.kf_levels,
        "kf_c2w": sw.kf_c2w,
        "idepth": sw.idepth,
        "images": jnp.stack(sw.images),
        "images_coarse": jnp.stack(sw.images_coarse),
        "models_q": jnp.stack([m.q for m in sw.models]),
        "models_t": jnp.stack([m.t for m in sw.models]),
        "prior_H": sw.prior_H,
        "prior_anchors": sw.prior_anchors,
    }
    for k, v in extra.items():
        state[f"extra_{k}"] = np.asarray(v)
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "sliding_window",
        "config_fingerprint": sliding_window_fingerprint(sw),
        "nb_frames": len(sw.models),
        "frame_ids": list(map(int, sw.frame_ids)),
        "keyframe_switches": sw.keyframe_switches,
        "next_id": sw._next_id,
        "extra_keys": sorted(extra.keys()),
    }
    save_pytree(path, state, meta)


def load_sliding_window(path: str, sw) -> dict:
    """Restore state saved by ``save_sliding_window`` into a freshly
    constructed (un-started) ``SlidingWindow`` with the same configuration;
    returns the caller's ``extra`` dict (empty if none was saved).

    Raises ``CheckpointMismatchError`` on format-version or fingerprint
    mismatch.  After loading, ``sw._next_id`` frames have been consumed —
    resume feeding from that frame index.
    """
    from ..math.pose import Pose

    meta = _peek_meta(path)
    version = meta.get("format_version")
    if version != FORMAT_VERSION or meta.get("kind") != "sliding_window":
        raise CheckpointMismatchError(
            f"not a v{FORMAT_VERSION} sliding-window checkpoint "
            f"(version {version!r}, kind {meta.get('kind')!r}): {path}"
        )
    expected = sliding_window_fingerprint(sw)
    found = meta.get("config_fingerprint")
    if found != expected:
        raise CheckpointMismatchError(
            f"checkpoint fingerprint {found!r} does not match the live "
            f"window's {expected!r} — refusing to resume with mismatched "
            f"window semantics ({path})"
        )
    template = {
        "kf_levels": _window_kf_template(sw),
        "kf_c2w": Pose(0.0, 0.0),
        "idepth": 0.0,
        "images": 0.0,
        "images_coarse": 0.0,
        "models_q": 0.0,
        "models_t": 0.0,
        "prior_H": 0.0,
        "prior_anchors": Pose(0.0, 0.0),
    }
    for k in meta.get("extra_keys", []):
        template[f"extra_{k}"] = 0.0
    state, _ = load_pytree(path, template)
    F = meta["nb_frames"]
    sw.kf_levels = state["kf_levels"]
    sw.kf_c2w = state["kf_c2w"]
    sw.idepth = state["idepth"]
    sw.images = [state["images"][i] for i in range(F)]
    sw.images_coarse = [state["images_coarse"][i] for i in range(F)]
    sw.models = [
        Pose(state["models_q"][i], state["models_t"][i]) for i in range(F)
    ]
    sw.prior_H = state["prior_H"]
    sw.prior_anchors = state["prior_anchors"]
    sw.frame_ids = list(meta["frame_ids"])
    sw.keyframe_switches = meta["keyframe_switches"]
    sw._next_id = meta["next_id"]
    return {k: np.asarray(state[f"extra_{k}"]) for k in meta.get("extra_keys", [])}


def _batched_window_kf_template(bsw):
    """Batched keyframe-levels TEMPLATE (structure only) via ``eval_shape``
    on the vmapped precompute — no compute, no compile."""
    cfg = bsw.config
    B = bsw.batch
    depth = jax.ShapeDtypeStruct((B, cfg.height, cfg.width), np.uint16)
    pyr = [jax.ShapeDtypeStruct((B,) + s, np.uint8) for s in cfg.level_shapes()]
    return jax.eval_shape(bsw._precompute_b, depth, pyr).levels


def save_batched_window(path: str, bsw, extra: dict | None = None) -> None:
    """Checkpoint a ``models.sliding_window.BatchedSlidingWindow`` mid-run
    (the ``vors_refine --batch`` serving state).

    Same contract as ``save_sliding_window``, with every leaf carrying the
    leading (B,) lane axis; ``extra`` is a caller-owned dict of name → array
    returned by ``load_batched_window``."""
    import jax.numpy as jnp

    extra = extra or {}
    state = {
        "kf_levels": bsw.kf_levels,
        "kf_c2w": bsw.kf_c2w,
        "idepth": bsw.idepth,
        "images": jnp.stack(bsw.images),  # (F, B, H, W)
        "images_coarse": jnp.stack(bsw.images_coarse),
        "models_q": jnp.stack([m.q for m in bsw.models]),  # (F, B, 4)
        "models_t": jnp.stack([m.t for m in bsw.models]),
        "prior_H": bsw.prior_H,
        "prior_anchors": bsw.prior_anchors,
        "frame_ids": np.asarray(bsw.frame_ids, np.int64),  # (F, B)
        "keyframe_switches": np.asarray(bsw.keyframe_switches, np.int64),
    }
    for k, v in extra.items():
        state[f"extra_{k}"] = np.asarray(v)
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "batched_window",
        "config_fingerprint": sliding_window_fingerprint(bsw),
        "batch": int(bsw.batch),
        "nb_frames": len(bsw.models),
        "next_id": bsw._next_id,
        "extra_keys": sorted(extra.keys()),
    }
    save_pytree(path, state, meta)


def load_batched_window(path: str, bsw) -> dict:
    """Restore ``save_batched_window`` state into a freshly constructed
    (un-started) ``BatchedSlidingWindow`` with the same configuration;
    returns the caller's ``extra`` dict.  Raises ``CheckpointMismatchError``
    on version / fingerprint / batch-size mismatch."""
    from ..math.pose import Pose

    meta = _peek_meta(path)
    version = meta.get("format_version")
    if version != FORMAT_VERSION or meta.get("kind") != "batched_window":
        raise CheckpointMismatchError(
            f"not a v{FORMAT_VERSION} batched-window checkpoint "
            f"(version {version!r}, kind {meta.get('kind')!r}): {path}"
        )
    expected = sliding_window_fingerprint(bsw)
    found = meta.get("config_fingerprint")
    if found != expected:
        raise CheckpointMismatchError(
            f"checkpoint fingerprint {found!r} does not match the live "
            f"batched window's {expected!r} — refusing to resume with "
            f"mismatched window semantics ({path})"
        )
    if bsw.batch is None:
        bsw.batch = int(meta["batch"])
    if int(meta["batch"]) != int(bsw.batch):
        raise CheckpointMismatchError(
            f"checkpoint batch size {meta['batch']} != live {bsw.batch} ({path})"
        )
    template = {
        "kf_levels": _batched_window_kf_template(bsw),
        "kf_c2w": Pose(0.0, 0.0),
        "idepth": 0.0,
        "images": 0.0,
        "images_coarse": 0.0,
        "models_q": 0.0,
        "models_t": 0.0,
        "prior_H": 0.0,
        "prior_anchors": Pose(0.0, 0.0),
        "frame_ids": 0,
        "keyframe_switches": 0,
    }
    for k in meta.get("extra_keys", []):
        template[f"extra_{k}"] = 0.0
    state, _ = load_pytree(path, template)
    F = meta["nb_frames"]
    bsw.kf_levels = bsw._shard(state["kf_levels"])
    bsw.kf_c2w = bsw._shard(state["kf_c2w"])
    bsw.idepth = bsw._shard(state["idepth"])
    bsw.images = [bsw._shard(state["images"][i]) for i in range(F)]
    bsw.images_coarse = [bsw._shard(state["images_coarse"][i]) for i in range(F)]
    bsw.models = [
        Pose(bsw._shard(state["models_q"][i]), bsw._shard(state["models_t"][i]))
        for i in range(F)
    ]
    bsw.prior_H = bsw._shard(state["prior_H"])
    bsw.prior_anchors = bsw._shard(state["prior_anchors"])
    bsw.frame_ids = np.asarray(state["frame_ids"], np.int64)
    bsw.keyframe_switches = np.asarray(state["keyframe_switches"], np.int64)
    bsw._next_id = meta["next_id"]
    return {k: np.asarray(state[f"extra_{k}"]) for k in meta.get("extra_keys", [])}


# ---------------------------------------------------------------------------
# Batched multi-sequence checkpoint/resume (vors_batch — the scaled serving
# CLI; SURVEY §5: restartability matters most for the long-running modes)
# ---------------------------------------------------------------------------


def batch_fingerprint(config, intrinsics, switch_cadence: int) -> str:
    """Stable hash of everything that determines the batched serving loop's
    state evolution: tracker config, intrinsics, and the switch cadence
    (cadence changes WHICH frames lanes switch keyframes on, so resuming
    under a different cadence silently changes semantics mid-sequence).
    ``switch_subbatch`` is deliberately NOT part of the fingerprint: it is a
    numerics-equivalent implementation choice."""
    payload = {
        "config": _config_payload(config),
        "intrinsics": [
            float(np.asarray(v)) for v in (intrinsics.cx, intrinsics.cy,
                                           intrinsics.fx, intrinsics.fy,
                                           intrinsics.skew)
        ],
        "switch_cadence": int(switch_cadence),
    }
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save_batch(
    path: str, state, pending, ring, frames_done: int,
    config, intrinsics, switch_cadence: int, lane_timestamps,
    prev_pose=None,
) -> None:
    """Checkpoint ``vors_batch``'s serving state mid-run.

    ``state``: the batched ``parallel.batch.TrackState``; ``pending``: the
    (B,) cadence carry mask; ``ring``: the ``RelocRing`` or ``None``;
    ``frames_done``: the global frame index the next chunk starts at (the
    cadence-phase carry, fed back as ``frame_offset``); ``lane_timestamps``:
    per lane, the depth timestamps of the associations CONSUMED so far
    (including frame 0) — the per-lane sequence binding ``sequence_matches``
    checks on resume; ``prev_pose``: the constant-velocity warm-start carry
    (``None`` unless ``config.warm_start == "constant_velocity"``)."""
    tree = {"state": state, "pending": pending}
    if ring is not None:
        tree["ring"] = ring
    if prev_pose is not None:
        tree["prev"] = prev_pose
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "batch",
        "config_fingerprint": batch_fingerprint(config, intrinsics, switch_cadence),
        "frames_done": int(frames_done),
        "has_ring": ring is not None,
        "has_prev": prev_pose is not None,
        "lane_timestamps": [
            [float(t) for t in ts] for ts in lane_timestamps
        ],
    }
    save_pytree(path, tree, meta)


def load_batch(
    path: str, state_template, ring_template,
    config, intrinsics, switch_cadence: int,
):
    """Restore a ``save_batch`` checkpoint.

    ``state_template``/``ring_template`` supply the pytree structure (build
    them with ``batched_init_state``/``batched_init_ring`` on the live
    inputs; ``ring_template=None`` when relocalization is off).  Returns
    ``(state, pending, ring_or_None, frames_done, lane_timestamps,
    prev_pose_or_None)``.  Raises ``CheckpointMismatchError`` on
    format/fingerprint mismatch or when the checkpoint's
    relocalization-ring / warm-start-carry presence disagrees with the live
    configuration (the config fingerprint already pins ``warm_start``, so a
    prev-presence mismatch can only come from a corrupted file)."""
    meta = _peek_meta(path)
    version = meta.get("format_version")
    if version != FORMAT_VERSION or meta.get("kind") != "batch":
        raise CheckpointMismatchError(
            f"not a v{FORMAT_VERSION} batch checkpoint "
            f"(version {version!r}, kind {meta.get('kind')!r}): {path}"
        )
    expected = batch_fingerprint(config, intrinsics, switch_cadence)
    found = meta.get("config_fingerprint")
    if found != expected:
        raise CheckpointMismatchError(
            f"checkpoint fingerprint {found!r} does not match the live batch "
            f"config's {expected!r} (config/intrinsics/--switch-cadence must "
            f"all match) — refusing to resume ({path})"
        )
    if meta.get("has_ring") != (ring_template is not None):
        raise CheckpointMismatchError(
            "checkpoint relocalization-ring presence "
            f"({meta.get('has_ring')}) does not match the live --relocalize "
            f"setting ({ring_template is not None}) ({path})"
        )
    expect_prev = getattr(config, "warm_start", "constant_position") == "constant_velocity"
    if bool(meta.get("has_prev", False)) != expect_prev:
        raise CheckpointMismatchError(
            f"checkpoint warm-start carry presence ({meta.get('has_prev')}) "
            f"does not match the live warm_start setting ({path})"
        )
    import jax.numpy as jnp

    template = {
        "state": state_template,
        "pending": jnp.zeros((0,), bool),
    }
    if expect_prev:
        template["prev"] = state_template.current_pose
    if ring_template is not None:
        template["ring"] = ring_template
    tree, _ = load_pytree(path, template)
    B_live = state_template.keyframe_pose.q.shape[0]
    B_saved = tree["state"].keyframe_pose.q.shape[0]
    if B_saved != B_live:
        raise CheckpointMismatchError(
            f"checkpoint batch size {B_saved} != live batch size {B_live} "
            f"({path})"
        )
    return (
        tree["state"],
        tree["pending"],
        tree.get("ring"),
        meta["frames_done"],
        [list(ts) for ts in meta["lane_timestamps"]],
        tree.get("prev"),
    )


# ---------------------------------------------------------------------------
# SLAM pipeline checkpoint/resume (vors_slam phase 1: tracking + keyframe
# store — the long-running part; loop closure + PGO run at the end)
# ---------------------------------------------------------------------------


def save_slam(
    path: str, tracker, trajectory, timestamps, keyframe_ids, kf_images,
    frames_done: int,
) -> None:
    """Checkpoint vors_slam's tracking phase: tracker state + trajectory so
    far + (optionally) the keyframe image store loop closure needs later.

    ``kf_images=None`` omits the keyframe images — the bounded-memory mode:
    keyframe images are re-decodable from the dataset on disk (the resume
    already binds to the exact association file via ``sequence_matches``),
    so storing them only inflates the checkpoint O(keyframes x image)."""
    import jax.numpy as jnp

    state = {
        "keyframe_data": tracker.keyframe_data,
        "keyframe_pose": tracker.keyframe_pose,
        "current_pose": tracker.current_pose,
        "traj_q": jnp.stack([p.q for p in trajectory]),
        "traj_t": jnp.stack([p.t for p in trajectory]),
    }
    if getattr(tracker.config, "warm_start", None) == "constant_velocity":
        state["prev_pose"] = tracker.prev_pose
    if kf_images is not None:
        state["kf_depths"] = np.stack(
            [np.asarray(kf_images[i][0]) for i in keyframe_ids]
        )
        state["kf_grays"] = np.stack(
            [np.asarray(kf_images[i][1]) for i in keyframe_ids]
        )
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "slam",
        "config_fingerprint": config_fingerprint(tracker.config, tracker.intrinsics),
        "keyframe_depth_timestamp": tracker.keyframe_depth_timestamp,
        "keyframe_img_timestamp": tracker.keyframe_img_timestamp,
        "current_depth_timestamp": tracker.current_depth_timestamp,
        "current_img_timestamp": tracker.current_img_timestamp,
        "keyframe_switches": tracker.keyframe_switches,
        "timestamps": [float(t) for t in timestamps],
        "keyframe_ids": list(map(int, keyframe_ids)),
        "frames_done": frames_done,
        "has_kf_images": kf_images is not None,
    }
    save_pytree(path, state, meta)


def load_slam(path: str, tracker):
    """Restore a ``save_slam`` checkpoint into an initialized tracker.

    Returns ``(trajectory, timestamps, keyframe_ids, kf_images,
    frames_done)``; raises ``CheckpointMismatchError`` on version or
    config-fingerprint mismatch.
    """
    from ..math.pose import Pose

    meta = _peek_meta(path)
    version = meta.get("format_version")
    if version != FORMAT_VERSION or meta.get("kind") != "slam":
        raise CheckpointMismatchError(
            f"not a v{FORMAT_VERSION} slam checkpoint "
            f"(version {version!r}, kind {meta.get('kind')!r}): {path}"
        )
    expected = config_fingerprint(tracker.config, tracker.intrinsics)
    found = meta.get("config_fingerprint")
    if found != expected:
        raise CheckpointMismatchError(
            f"checkpoint config fingerprint {found!r} does not match the "
            f"live tracker's {expected!r} ({path})"
        )
    has_kf = meta.get("has_kf_images", True)  # pre-round-4 checkpoints: yes
    template = {
        "keyframe_data": tracker.keyframe_data,
        "keyframe_pose": tracker.keyframe_pose,
        "current_pose": tracker.current_pose,
        "traj_q": 0.0,
        "traj_t": 0.0,
    }
    if getattr(tracker.config, "warm_start", None) == "constant_velocity":
        template["prev_pose"] = tracker.current_pose
    if has_kf:
        template["kf_depths"] = 0.0
        template["kf_grays"] = 0.0
    state, _ = load_pytree(path, template)
    tracker.keyframe_data = state["keyframe_data"]
    tracker.keyframe_pose = state["keyframe_pose"]
    tracker.current_pose = state["current_pose"]
    tracker.prev_pose = state.get("prev_pose", tracker.current_pose)
    tracker.keyframe_depth_timestamp = meta["keyframe_depth_timestamp"]
    tracker.keyframe_img_timestamp = meta["keyframe_img_timestamp"]
    tracker.current_depth_timestamp = meta["current_depth_timestamp"]
    tracker.current_img_timestamp = meta["current_img_timestamp"]
    tracker.keyframe_switches = meta["keyframe_switches"]
    _reset_reloc_ring(tracker)
    trajectory = [
        Pose(state["traj_q"][i], state["traj_t"][i])
        for i in range(state["traj_q"].shape[0])
    ]
    keyframe_ids = list(meta["keyframe_ids"])
    kf_images = (
        {
            fid: (np.asarray(state["kf_depths"][k]), np.asarray(state["kf_grays"][k]))
            for k, fid in enumerate(keyframe_ids)
        }
        if has_kf
        else None  # bounded mode: re-decode from the dataset on demand
    )
    return (
        trajectory, list(meta["timestamps"]), keyframe_ids, kf_images,
        meta["frames_done"],
    )
