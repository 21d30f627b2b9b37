"""Inverse-compositional se(3) RGB-D tracker — the flagship model.

Capability parity with reference ``src/core/track/inverse_compositional.rs`` +
``src/core/track/lm_optimizer.rs``: DSO-style sparse candidates over a
multi-scale mean pyramid, per-keyframe precomputed warp Jacobians and
Gauss-Newton Hessians (the inverse-compositional trick), per-frame
coarse-to-fine Levenberg-Marquardt alignment on se(3), and keyframe switching
on mean optical flow >= 1 px at the coarsest level.

Design (vs the reference's per-point Rust loops):

- **Fixed shapes everywhere.** The reference compacts candidates into
  variable-length Vecs (inverse_compositional.rs:260-279) and drops
  out-of-bounds points per iteration (lm_optimizer.rs:76-83).  Here candidate
  arrays are padded to a static per-level capacity with a validity mask;
  out-of-bounds warps contribute zero weight, and the energy normalizes by
  the masked count — numerically equivalent to the reference's
  mean-over-inside-points energy.
- **One fused reduction per LM iteration.** ``g = Jᵀ(r·m)`` and
  ``H = (J·m)ᵀJ`` are a single (6, N) x (N, 7) matmul.
- **lax.while_loop LM, static 6-level loop.** A whole frame's track — all
  pyramid levels, all LM iterations, the optical-flow check — jits into one
  XLA computation with no host round-trips.
- **Keyframe switching stays functional**: ``precompute_keyframe`` is itself
  jittable, and the batched/sharded driver (``parallel/``) swaps keyframe
  state with ``lax.cond`` double-buffering.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache, partial
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core import camera as camera_mod
from ..core import inverse_depth as idepth_mod
from ..core.camera import Intrinsics
from ..core.candidates import coarse_to_fine
from ..math import pose as pose_mod
from ..math import se3
from ..math.optimizer import LMState, damped_solve, iterative_solve, lm_update
from ..math.pose import Pose
from ..ops import gradient as gradient_ops
from ..ops import interp
from ..ops import pyramid as pyramid_ops
from ..utils.types import Float


@dataclass(frozen=True)
class TrackerConfig:
    """Static tracker configuration (the analog of ``track::Config``,
    inverse_compositional.rs:37-49, plus the magic numbers the reference
    hard-codes inside the optimizer, surfaced per SURVEY §5).
    """

    height: int
    width: int
    nb_levels: int = 6
    candidates_diff_threshold: int = 7
    depth_scale: float = 5000.0
    idepth_variance: float = 1e-4
    # LM schedule (lm_optimizer.rs:115,157,173,179,187)
    lm_coef_init: float = 0.1
    max_iterations: int = 20
    energy_tol: float = 1.0
    # Per-level LM iteration budgets (green-field; the reference uses one
    # cap of 20 for every level, lm_optimizer.rs:157).  Tuple indexed by
    # pyramid level (0 = finest), length nb_levels; None = ``max_iterations``
    # everywhere (reference-exact).  The coarse levels only seed the next
    # level's init, so their budget can often be cut without ATE cost
    # (tools/ab_warmstart.py measures it).
    level_max_iterations: Tuple[int, ...] | None = None
    # Per-frame LM warm start (inverse_compositional.rs:177 initializes each
    # frame's model from the PREVIOUS frame's pose — constant-position).
    # "constant_velocity" extrapolates the previous inter-frame motion
    # (``pred = cur ∘ (prev⁻¹ ∘ cur)``, the standard DSO-class motion
    # prior), cutting sequential LM iterations on smooth trajectories.
    # Applies to the host ``Tracker`` and the fused scan drivers
    # (``parallel.batch.track_sequence`` / ``batched_track_sequence``),
    # which carry the previous pose; the stateless per-step drivers
    # (``track_step``) keep the reference init.  After a failure or
    # relocalization the velocity resets to zero (constant-position) for
    # one frame.
    warm_start: str = "constant_position"
    # keyframe switch threshold in px of mean optical flow
    # (inverse_compositional.rs:224)
    flow_threshold: float = 1.0
    # static per-level candidate capacity; level capacity is
    # min(candidate_cap, pixels at that level)
    candidate_cap: int = 8192
    # bilinear sampling: "auto" (= "gather"), "gather", "onehot", "onehot_weighted"
    interp_method: str = "auto"
    # Huber robust weighting of photometric residuals (green-field extension;
    # the reference is plain L2, lm_optimizer.rs:79-81).  0.0 = off
    # (reference-exact).  When on, residuals beyond ``robust_delta``
    # intensity units get IRLS weight delta/|r| — occlusions and specular
    # outliers stop dragging the solve.
    robust_delta: float = 0.0
    # Affine brightness modeling (green-field; DSO-style): estimate a per-
    # frame gain/bias (a, b) jointly with the pose, residual
    # ``I_f - (a*T + b)``.  Off by default (reference-exact: the reference
    # assumes brightness constancy).  Use for auto-exposure cameras.
    brightness_model: bool = False
    # host-side Tracker only: slice each keyframe level down to the smallest
    # power-of-two bucket >= its actual candidate count (valid candidates are
    # contiguous at the front after the top_k compaction), so per-frame LM
    # cost scales with the real point count instead of the worst-case cap.
    # One jit specialization per bucket combination (cached).  Off by
    # default: bucketing changes reduction shapes, so results can differ by
    # f32 rounding from the unbucketed path.
    bucket_candidates: bool = False
    min_bucket: int = 256
    # host-side Tracker only (green-field; the reference has no recovery
    # path — a lost frame just keeps its previous pose,
    # inverse_compositional.rs:195-199): keep the last K keyframes and, when
    # a frame's track fails (Cholesky failure) or its final finest-level
    # energy exceeds ``relocalize_energy_accept``, re-track the frame
    # against ALL of them from identity inits in ONE vmapped dispatch
    # ("we are near one of these keyframes"), adopting the best verified
    # pose and re-activating that keyframe (models/relocalize.py).  While a
    # frame is in this recovery regime the ordinary flow-criterion keyframe
    # switch is suppressed, so an untrackable frame can never become the
    # map anchor.  0 = off (reference-exact).
    relocalize_window: int = 0
    relocalize_energy_accept: float = 150.0
    relocalize_min_inside_frac: float = 0.5
    # candidate selection algorithm for keyframe precompute:
    # "coarse_to_fine" (reference tracker's selector, coarse_to_fine.rs:15),
    # "dso" (the faithful DSO picker, dso.rs:98-147 — host-side Tracker
    # only: its block-size recursion is a data-dependent host decision, so
    # the fused in-graph drivers (parallel.batch, --chunk) reject it), or
    # "dso_fixed" (round 5: the recursion-free DSO variant at the STATIC
    # ``dso_block_size`` — jittable, so it IS available to the fused
    # in-graph drivers; identical to "dso" whenever the host recursion does
    # not fire, and it keeps the reference's random thinning in-graph).
    # ``dso_target`` is the DSO point-count target (examples/README.md
    # uses 2000; the "dso" recursion adapts block size toward it, while
    # "dso_fixed" uses it only for the thinning ratio).
    candidate_selector: str = "coarse_to_fine"
    dso_target: int = 2000
    dso_block_size: int = 4
    # DSO regional threshold ``a (mean3x3(median) + b)^2`` coefficients
    # (dso.rs:37-42; the reference notes "(2.0,3) in dso and (1.0,3) in
    # ldso").  On weakly-textured scenes the block maxima sit below the
    # median-based threshold at a=1; lower ``a`` to admit them.
    dso_threshold_coef_a: float = 1.0
    dso_threshold_coef_b: int = 3

    def level_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(pyramid_ops.level_shapes(self.height, self.width, self.nb_levels))

    def level_iterations(self, lvl: int) -> int:
        """LM iteration cap for pyramid level ``lvl`` (0 = finest)."""
        if self.level_max_iterations is None:
            return self.max_iterations
        if len(self.level_max_iterations) != self.nb_levels:
            raise ValueError(
                f"level_max_iterations must have nb_levels={self.nb_levels} "
                f"entries, got {len(self.level_max_iterations)}"
            )
        return self.level_max_iterations[lvl]

    def level_caps(self) -> Tuple[int, ...]:
        return tuple(
            min(self.candidate_cap, h * w) for h, w in self.level_shapes()
        )


class LevelObs(NamedTuple):
    """Per-level keyframe observation data (the analog of ``lm_optimizer::Obs``
    + the per-level slices of ``MultiresData``, inverse_compositional.rs:64-70).
    All arrays have static shapes; ``valid`` masks the padded candidates."""

    intrinsics: Intrinsics
    template: jnp.ndarray  # (H, W) u8 keyframe image at this level
    xs: jnp.ndarray  # (N,) f32 candidate column coords
    ys: jnp.ndarray  # (N,) f32 candidate row coords
    idepth: jnp.ndarray  # (N,) f32 inverse depths
    valid: jnp.ndarray  # (N,) bool: real candidate vs padding
    tmpl_vals: jnp.ndarray  # (N,) f32 template intensities at candidates
    jacobians: jnp.ndarray  # (N, 6) f32 precomputed warp jacobians


class KeyframeData(NamedTuple):
    levels: Tuple[LevelObs, ...]


def warp_jacobian(gu, gv, u, v, idepth, k: Intrinsics) -> jnp.ndarray:
    """Analytic 6-dof inverse-compositional warp Jacobian, (…, 6).

    Formula from inverse_compositional.rs:313-341 (image gradient (gu, gv)
    chained with the projection derivative at inverse depth ``idepth``).
    """
    cu, cv, fu, fv, s = k.cx, k.cy, k.fx, k.fy, k.skew
    a = u - cu
    b = v - cv
    c = a * fv - s * b
    inv_fv = 1.0 / fv
    inv_fuv = 1.0 / (fu * fv)
    z = idepth
    return jnp.stack(
        [
            gu * z * fu,
            z * (gu * s + gv * fv),
            -z * (gu * a + gv * b),
            gu * (-a * b * inv_fv - s) + gv * (-b * b * inv_fv - fv),
            gu * (a * c * inv_fuv + fu) + gv * (b * c * inv_fuv),
            gu * (-fu * fu * b + s * c) * inv_fuv + gv * (c / fu),
        ],
        axis=-1,
    )


def _keyframe_gradients(img_pyramid: List[jnp.ndarray]):
    """Per-level (gx, gy): centered at level 0, 2x2-block for levels >= 1
    (inverse_compositional.rs:111-117).

    f32 carriers with exact integer values: the same math in f32 is
    bit-exact for these < 2^24 integer ranges (see ``ops.gradient``)."""
    grads = [gradient_ops.centered_f32(img_pyramid[0])]
    grads.extend(gradient_ops.gradients_xy_f32(img_pyramid))
    return grads


@lru_cache(maxsize=64)
def _bit_reversal_order(hw: int):
    """Static scan order visiting flat indices by ascending bit-reversed
    value — a spatially-stratified enumeration (host-side, cached)."""
    import numpy as np

    nbits = max(1, (hw - 1).bit_length())
    r = np.arange(1 << nbits, dtype=np.int64)
    rev = np.zeros_like(r)
    x = r.copy()
    for _ in range(nbits):
        rev = (rev << 1) | (x & 1)
        x >>= 1
    perm = rev[rev < hw]
    return perm.astype(np.int32)


def _extract_candidates(
    idmap: idepth_mod.InverseDepthMap, cap: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Compact the known-idepth pixels of a level into fixed-size arrays.

    The fixed-shape replacement for the reference's Vec compaction ``extract_z``
    (inverse_compositional.rs:260-279): a rank-and-scatter compaction —
    gather the known-mask in a STATIC bit-reversed scan order, prefix-sum it
    to get each candidate's output slot, and scatter the flat indices into a
    (cap,)-sized buffer.  O(H·W) bandwidth instead of the O(H·W log) sort
    structure of ``lax.top_k`` over per-pixel keys (output is bit-identical
    to the top_k formulation).  It is the plain reference that
    ``_extract_level_onehot`` is checked against (``chip_smoke.py``).

    Valid candidates are compacted to the FRONT (bucketing relies on this).
    The bit-reversed visiting order means that when more candidates exist
    than ``cap`` the truncation drops a spatially-stratified subset —
    scanning in raw row-major order would silently keep only the TOP rows
    of the image.  (The reference never truncates; ordering is a fixed
    permutation and only reassociates the masked f32 reductions.)
    """
    h, w = idmap.state.shape
    hw = h * w
    perm = jnp.asarray(_bit_reversal_order(hw))
    known_p = idmap.known.reshape(-1)[perm]
    ranks = jnp.cumsum(known_p.astype(jnp.int32)) - 1
    take = jnp.logical_and(known_p, ranks < cap)
    dest = jnp.where(take, ranks, cap)  # cap = dump slot, sliced away below
    idxs = jnp.zeros((cap + 1,), jnp.int32).at[dest].set(perm, mode="drop")[:cap]
    total = jnp.minimum(jnp.sum(known_p.astype(jnp.int32)), cap)
    valid = jax.lax.iota(jnp.int32, cap) < total
    idxs = jnp.where(valid, idxs, 0)
    ys = jax.lax.div(idxs, jnp.int32(w))
    xs = jax.lax.rem(idxs, jnp.int32(w))
    z = idmap.idepth.reshape(-1)[idxs]
    return xs.astype(Float), ys.astype(Float), z, valid


_EXTRACT_CHUNK = 128


def _extract_level_onehot(
    idmap: idepth_mod.InverseDepthMap,
    gx: jnp.ndarray,
    gy: jnp.ndarray,
    tmpl_img: jnp.ndarray,
    cap: int,
    depth_u16: jnp.ndarray | None = None,
    depth_scale: float = 0.0,
):
    """Candidate compaction + per-candidate channel gathers with ZERO
    dynamic-index operations — everything is one-hot matmuls and
    elementwise compares.

    Motivation: on the accelerator this was written for, dynamic gathers,
    scatters and top_k at image scale were the slowest part of the fused
    precompute program, and the numerically identical one-hot matmul form
    was several times faster.  Whether that holds on the GPU is an open
    A/B against ``_extract_candidates`` (ROADMAP A.2).

    Construction: the flat mask is split into chunks of 128; per-chunk
    inclusive ranks come from one (C,128)x(128,128) triangular matmul;
    chunks are visited in a STATIC bit-reversed order (spatially-stratified
    truncation at chunk granularity — the analog of the per-pixel
    bit-reversal of ``_extract_candidates``, see there); each output slot
    locates its (chunk, within-chunk rank) with small exact matmuls against
    the chunk one-hot, and the candidate's flat index + channel values
    (inverse depth f32, gradients i16, template u8) are selected by
    one-nonzero-per-row products, which are exact in bf16/f32.

    Returns ``(xs, ys, z, valid, gu, gv, tmpl_vals)`` with valid candidates
    compacted to the front.
    """
    h, w = idmap.state.shape
    hw = h * w
    m = _EXTRACT_CHUNK
    n_chunks = -(-hw // m)
    pad = n_chunks * m - hw

    def flat_pad(a, fill):
        f = a.reshape(-1)
        if pad:
            f = jnp.concatenate([f, jnp.full((pad,), fill, f.dtype)])
        return f.reshape(n_chunks, m)

    known_cm = flat_pad(idmap.known, False)
    upper = jnp.triu(jnp.ones((m, m), jnp.bfloat16))
    # inclusive within-chunk ranks; integer values <= 128, exact in bf16
    lrank = jnp.dot(known_cm.astype(jnp.bfloat16), upper,
                    preferred_element_type=Float)  # (C, m) natural order
    counts = lrank[:, -1]  # (C,)

    chunk_perm = jnp.asarray(_bit_reversal_order(n_chunks))  # static visit order
    counts_v = counts[chunk_perm]
    offs_incl = jnp.cumsum(counts_v)  # (C,) f32 exact (< 2^24)
    offs_excl = offs_incl - counts_v
    total = jnp.minimum(offs_incl[-1], jnp.asarray(cap, Float))

    s = jax.lax.iota(jnp.int32, cap).astype(Float)  # output slots
    valid = s < total
    # visit-chunk of each slot: number of visited chunks fully before it
    past = (offs_incl[None, :] <= s[:, None]).astype(jnp.int32)  # (cap, C)
    jv = jnp.minimum(jnp.sum(past, axis=1), n_chunks - 1)
    iota_c = jax.lax.iota(jnp.int32, n_chunks)
    onehot_v = (iota_c[None, :] == jv[:, None])  # (cap, C) bool, visit space
    # per-chunk location scalars, byte-decomposed so a single small exact
    # bf16 matmul replaces the former two Precision.HIGHEST f32 matvecs
    # (and their f32 (cap, C) one-hot materialization): the natural chunk
    # id (chunk_perm < 2^16: 2 bytes) and the exclusive visit-order offset
    # (< hw <= 2^24: 3 bytes).  One nonzero per row -> every lane exact.
    # NOTE a visit-order row permute of the (C, m) channel data itself was
    # measured much worse (bit-reversed row gathers at image scale) — only
    # these (C,) vectors live in visit space.
    # byte-decomposition capacity limits: the chunk id rides as 2 bytes and
    # the exclusive offset as 3 — tighter than the generic <2^24 f32 rule,
    # so fail loudly instead of decoding wrong chunk ids on oversized images
    assert n_chunks < 65536 and hw < 2 ** 24, (
        f"_extract_level_onehot supports at most 2^16 chunks / 2^24 pixels "
        f"(got n_chunks={n_chunks}, hw={hw})"
    )
    perm_f = chunk_perm.astype(Float)
    loc_cols = jnp.stack(
        [
            jnp.floor(perm_f / 256.0),
            jnp.mod(perm_f, 256.0),
            jnp.mod(offs_excl, 256.0),
            jnp.mod(jnp.floor(offs_excl / 256.0), 256.0),
            jnp.floor(offs_excl / 65536.0),
        ],
        axis=1,
    ).astype(jnp.bfloat16)  # (C, 5)
    loc = jnp.dot(onehot_v.astype(jnp.bfloat16), loc_cols,
                  preferred_element_type=Float)  # (cap, 5)
    j_nat = loc[:, 0] * 256.0 + loc[:, 1]
    off_ex = loc[:, 2] + 256.0 * loc[:, 3] + 65536.0 * loc[:, 4]
    r = s - off_ex  # 0-based rank within the chunk
    j_nat_i = j_nat.astype(jnp.int32)
    onehot_nat = (iota_c[None, :] == j_nat_i[:, None])  # (cap, C) bool
    # ALL channel gathers ride ONE bf16 matmul: small-int channels are
    # exact in bf16 directly, and the inverse depth rides as u8 byte planes
    # (each exact in bf16) — cheaper than a separate Precision.HIGHEST
    # f32 matmul for z.  When the RAW u16 depth map is available (level 0,
    # where the fused idepth pyramid IS ``scale / depth`` at candidate
    # pixels), gather its TWO depth bytes instead of the f32 idepth's FOUR
    # and recompute ``scale / depth`` after the gather — the identical f32
    # division ``from_depth`` performs, so the result is bit-exact, and the
    # dominant channel matmul shrinks from 7 to 5 byte planes (level 0
    # holds most of the candidates of the pyramid).
    if depth_u16 is not None:
        d16 = flat_pad(depth_u16, 0).astype(jnp.uint16)
        z_bytes = [
            (d16 & 0xFF).astype(jnp.bfloat16),
            ((d16 >> 8) & 0xFF).astype(jnp.bfloat16),
        ]
    else:
        z_u32 = jax.lax.bitcast_convert_type(
            flat_pad(idmap.idepth, 0.0), jnp.uint32
        )
        z_bytes = [
            ((z_u32 >> (8 * k)) & 0xFF).astype(jnp.bfloat16) for k in range(4)
        ]
    nz = len(z_bytes)
    # the within-chunk rank row (lrank, integers <= m: exact in bf16) rides
    # as one more "channel" of the single one-hot matmul — folding the
    # former separate (cap, C) x (C, m) lrow pass into this one saves a
    # full read of the big one-hot per level
    chans = jnp.concatenate(
        [flat_pad(gx, 0).astype(jnp.bfloat16),
         flat_pad(gy, 0).astype(jnp.bfloat16),
         flat_pad(tmpl_img, 0).astype(jnp.bfloat16)] + z_bytes
        + [lrank.astype(jnp.bfloat16)],
        axis=1,
    )  # (C, (4+nz) m)
    rows = jnp.dot(onehot_nat.astype(jnp.bfloat16), chans,
                   preferred_element_type=Float)  # (cap, (4+nz) m)

    lrow = rows[:, (3 + nz) * m : (4 + nz) * m]  # (cap, m) exact
    lrow_shift = jnp.concatenate([jnp.zeros((cap, 1), Float), lrow[:, :-1]], axis=1)
    # first position where the inclusive rank reaches r+1
    sel = jnp.logical_and(lrow == r[:, None] + 1.0, lrow_shift == r[:, None])
    iota_m = jax.lax.iota(jnp.int32, m)
    p_local = jnp.sum(jnp.where(sel, iota_m[None, :], 0), axis=1)
    idx = jnp.where(valid, j_nat_i * m + p_local, 0)
    ys = jax.lax.div(idx, jnp.int32(w))
    xs = jax.lax.rem(idx, jnp.int32(w))

    self_f = sel.astype(Float)

    def pick(k):
        return jnp.sum(rows[:, k * m : (k + 1) * m] * self_f, axis=1)

    gu, gv, tmpl_vals = pick(0), pick(1), pick(2)
    if depth_u16 is not None:
        depth_f = pick(3) + 256.0 * pick(4)  # exact: u16 < 2^24 in f32
        # the exact division from_depth performs (depth > 0 at candidates)
        z = jnp.asarray(depth_scale, Float) / jnp.maximum(depth_f, 1.0)
        z = jnp.where(valid, z, 0.0)
    else:
        z_u32_out = sum(
            (pick(3 + k).astype(jnp.uint32) << (8 * k)) for k in range(nz)
        )
        z = jax.lax.bitcast_convert_type(z_u32_out, Float)
        z = jnp.where(valid, z, 0.0)  # padding slots decode garbage bits
    return xs.astype(Float), ys.astype(Float), z, valid, gu, gv, tmpl_vals


def precompute_keyframe(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    depth_map: jnp.ndarray,
    img_pyramid: List[jnp.ndarray],
    finest_mask: jnp.ndarray | None = None,
) -> KeyframeData:
    """Precompute all per-keyframe data (inverse_compositional.rs:105-161).

    Candidate masks from coarse-to-fine gradient selection, inverse-depth
    pyramid fused with the DSO-mean strategy, and per-candidate Jacobians and
    template intensities at every level.  Jittable; runs at init and on every
    keyframe switch.

    ``finest_mask`` overrides the in-graph coarse-to-fine selection with a
    precomputed level-0 candidate mask — the carrier for the DSO selector
    (``config.candidate_selector == "dso"``), whose block-size recursion is
    a host-side decision (``core.candidates.dso.select``) and therefore
    cannot run inside this jitted function.
    """
    nb_levels = len(img_pyramid)
    intr_levels = camera_mod.multi_res(intrinsics, nb_levels)
    grads = _keyframe_gradients(img_pyramid)

    if finest_mask is None:
        if config.candidate_selector == "dso":
            raise ValueError(
                "candidate_selector='dso' requires a host-side selection "
                "pass (core.candidates.dso.select is a data-dependent "
                "host recursion): use the host Tracker, pass finest_mask= "
                "explicitly, or use 'dso_fixed' (the recursion-free "
                "in-graph variant at a static block size).  The fused "
                "in-graph drivers (parallel.batch, --chunk) support "
                "coarse_to_fine and dso_fixed."
            )
        if config.candidate_selector == "dso_fixed":
            from ..core.candidates import dso as dso_mod

            finest_mask = dso_mod.select_fixed_block(
                gradient_ops.norm_direct(img_pyramid[0]),
                config.dso_target,
                block_size=config.dso_block_size,
                region_config=dso_mod.RegionConfig(
                    threshold_coef_a=config.dso_threshold_coef_a,
                    threshold_coef_b=config.dso_threshold_coef_b,
                ),
            )
        elif config.candidate_selector == "coarse_to_fine":
            sqn = [gradient_ops.squared_norm_f32(gx, gy) for gx, gy in grads]
            finest_mask = coarse_to_fine.select(
                config.candidates_diff_threshold, sqn
            )[-1]
        else:
            raise ValueError(
                f"unknown candidate_selector {config.candidate_selector!r}"
            )

    id0 = idepth_mod.masked(
        idepth_mod.from_depth(config.depth_scale, depth_map, config.idepth_variance),
        finest_mask,
    )
    id_levels = idepth_mod.pyramid(id0, nb_levels, strategy="dso_mean")

    caps = config.level_caps()
    levels = []
    for lvl in range(nb_levels):
        k = intr_levels[lvl]
        gx, gy = grads[lvl]
        xs, ys, z, valid, gu, gv, tmpl_vals = _extract_level_onehot(
            id_levels[lvl], gx, gy, img_pyramid[lvl], caps[lvl],
            depth_u16=depth_map
            if lvl == 0 and depth_map.dtype == jnp.uint16 else None,
            depth_scale=config.depth_scale,
        )
        jac = warp_jacobian(gu, gv, xs, ys, z, k)
        jac = jnp.where(valid[:, None], jac, 0.0)
        levels.append(
            LevelObs(
                intrinsics=k,
                template=img_pyramid[lvl],
                xs=xs,
                ys=ys,
                idepth=z,
                valid=valid,
                tmpl_vals=tmpl_vals,
                jacobians=jac,
            )
        )
    return KeyframeData(levels=tuple(levels))


# ---------------------------------------------------------------------------
# Per-level LM solve
# ---------------------------------------------------------------------------


def _eval_energy(obs: LevelObs, image: jnp.ndarray, model: Pose, method: str):
    """Warp + sample + residual pass (lm_optimizer.rs:68-87).

    energy = Σ_inside r² / #inside, where inside = valid candidate whose warp
    lands in the interpolation domain.
    """
    u, v = camera_mod.warp(model, obs.xs, obs.ys, obs.idepth, obs.intrinsics)
    vals, in_img = interp.bilinear(image, u, v, method)
    inside = jnp.logical_and(in_img, obs.valid)
    r = jnp.where(inside, vals - obs.tmpl_vals, 0.0)
    count = jnp.sum(inside).astype(Float)
    energy = jnp.sum(r * r) / count  # NaN when count == 0, like the reference
    return energy, r, inside


def _eval_full(
    obs: LevelObs, image: jnp.ndarray, model: Pose, method: str,
    robust_delta: float = 0.0,
):
    """Energy + Jᵀr + Σ JJᵀ in one fused masked matmul
    (lm_optimizer.rs:90-107).

    ``robust_delta > 0`` applies Huber IRLS weights (weighted energy,
    weighted normal equations).
    """
    energy, r, inside = _eval_energy(obs, image, model, method)
    maskf = inside.astype(Float)
    if robust_delta > 0.0:
        absr = jnp.abs(r)
        w = jnp.where(absr <= robust_delta, 1.0, robust_delta / jnp.maximum(absr, 1e-12))
        maskf = maskf * w
        count = jnp.sum(inside).astype(Float)
        energy = jnp.sum(w * r * r) / count  # weighted mean energy
    jm = obs.jacobians * maskf[:, None]  # (N, 6)
    rhs = jnp.concatenate([obs.jacobians, r[:, None]], axis=1)  # (N, 7)
    m = jnp.matmul(jm.T, rhs, precision=jax.lax.Precision.HIGHEST)
    return energy, m[:, 6], m[:, :6]


def solve_level(
    obs: LevelObs,
    image: jnp.ndarray,
    model0: Pose,
    *,
    lm_coef_init: float = 0.1,
    max_iterations: int = 20,
    energy_tol: float = 1.0,
    interp_method: str = "auto",
    robust_delta: float = 0.0,
):
    """LM solve of one pyramid level (the reference's
    ``LMOptimizerState::iterative_solve`` instantiation, lm_optimizer.rs:111-193).

    Step: damp diag ×(1+λ), 6x6 Cholesky, inverse-compositional update
    ``model ∘ exp(δ)⁻¹`` with first-order quaternion renormalization.
    """

    def init(_, model):
        energy, grad, hess = _eval_full(obs, image, model, interp_method, robust_delta)
        return LMState(model, energy, grad, hess, jnp.asarray(lm_coef_init, Float))

    def step(state):
        delta = damped_solve(state.hessian, state.gradient, state.lm_coef)
        new_model = pose_mod.compose(state.model, pose_mod.inverse(se3.exp(delta)))
        return pose_mod.renormalize_first_order(new_model)

    def eval_fn(_, state, new_model):
        energy, grad, hess = _eval_full(obs, image, new_model, interp_method, robust_delta)
        return (new_model, energy, grad, hess)

    def stop(state, nb_iter, eval_out):
        new_model, energy, grad, hess = eval_out
        return lm_update(
            state, nb_iter, new_model, energy, grad, hess,
            max_iterations=max_iterations, energy_tol=energy_tol,
        )

    return iterative_solve(
        None, model0,
        init=init, step=step, eval_fn=eval_fn, stop_criterion=stop,
        max_iterations=max_iterations + 3,
    )


# ---------------------------------------------------------------------------
# Affine-brightness variant (green-field; DSO-style gain/bias per frame)
# ---------------------------------------------------------------------------


class BrightnessState(NamedTuple):
    """Pose + per-frame affine brightness ``ab = (gain a, bias b)``:
    residual ``r = I_f(warp(p)) - (a * T(p) + b)``.  The reference has no
    appearance model (its residual is raw intensity difference,
    lm_optimizer.rs:79); auto-exposure cameras (TUM fr1) violate that
    brightness-constancy assumption — this variant estimates (a, b) jointly
    with the pose each frame."""

    pose: Pose
    ab: jnp.ndarray  # (2,) f32, init (1, 0)


def _eval_full_brightness(
    obs: LevelObs, image: jnp.ndarray, bst: BrightnessState, method: str,
    robust_delta: float = 0.0,
):
    """8-parameter normal equations: columns [J6_ic | T | 1].

    The residual is exactly linear in (a, b), so the appearance block is
    plain Gauss-Newton with additive updates; the pose block keeps the
    inverse-compositional convention (update ``pose ∘ exp(δ)⁻¹``), and the
    stacked signs work out so one (8, N) x (N, 9) matmul yields a system
    whose solution updates both (pose IC-inverse, ab additive).
    """
    a, b = bst.ab[0], bst.ab[1]
    u, v = camera_mod.warp(bst.pose, obs.xs, obs.ys, obs.idepth, obs.intrinsics)
    vals, in_img = interp.bilinear(image, u, v, method)
    inside = jnp.logical_and(in_img, obs.valid)
    r = jnp.where(inside, vals - (a * obs.tmpl_vals + b), 0.0)
    count = jnp.sum(inside).astype(Float)
    energy = jnp.sum(r * r) / count
    maskf = inside.astype(Float)
    if robust_delta > 0.0:
        absr = jnp.abs(r)
        w = jnp.where(absr <= robust_delta, 1.0, robust_delta / jnp.maximum(absr, 1e-12))
        maskf = maskf * w
        energy = jnp.sum(w * r * r) / count
    ones = jnp.ones_like(obs.tmpl_vals)
    j8 = jnp.concatenate(
        [obs.jacobians, obs.tmpl_vals[:, None], ones[:, None]], axis=1
    )  # (N, 8)
    jm = j8 * maskf[:, None]
    rhs = jnp.concatenate([j8, r[:, None]], axis=1)  # (N, 9)
    m = jnp.matmul(jm.T, rhs, precision=jax.lax.Precision.HIGHEST)
    return energy, m[:, 8], m[:, :8]


def solve_level_brightness(
    obs: LevelObs,
    image: jnp.ndarray,
    state0: BrightnessState,
    *,
    lm_coef_init: float = 0.1,
    max_iterations: int = 20,
    energy_tol: float = 1.0,
    interp_method: str = "auto",
    robust_delta: float = 0.0,
):
    """LM solve of one level over (pose, gain, bias)."""

    def init(_, bst):
        energy, grad, hess = _eval_full_brightness(
            obs, image, bst, interp_method, robust_delta
        )
        return LMState(bst, energy, grad, hess, jnp.asarray(lm_coef_init, Float))

    def step(state):
        delta = damped_solve(state.hessian, state.gradient, state.lm_coef)
        pose = pose_mod.compose(
            state.model.pose, pose_mod.inverse(se3.exp(delta[:6]))
        )
        pose = pose_mod.renormalize_first_order(pose)
        return BrightnessState(pose=pose, ab=state.model.ab + delta[6:8])

    def eval_fn(_, state, new_model):
        energy, grad, hess = _eval_full_brightness(
            obs, image, new_model, interp_method, robust_delta
        )
        return (new_model, energy, grad, hess)

    def stop(state, nb_iter, eval_out):
        new_model, energy, grad, hess = eval_out
        return lm_update(
            state, nb_iter, new_model, energy, grad, hess,
            max_iterations=max_iterations, energy_tol=energy_tol,
        )

    return iterative_solve(
        None, state0,
        init=init, step=step, eval_fn=eval_fn, stop_criterion=stop,
        max_iterations=max_iterations + 3,
    )


# ---------------------------------------------------------------------------
# Per-frame tracking
# ---------------------------------------------------------------------------


def warm_start_init(
    config: TrackerConfig, keyframe_pose: Pose, current_pose: Pose,
    prev_pose: Pose | None = None,
) -> Pose:
    """Initial keyframe→frame model for the next track.

    ``constant_position`` (reference-exact, inverse_compositional.rs:177):
    start from the previous frame's pose, ``model = cur⁻¹ ∘ kfp``.
    ``constant_velocity``: extrapolate the previous inter-frame motion —
    ``pred = cur ∘ (prev⁻¹ ∘ cur)`` (right-composition motion prior), then
    ``model = pred⁻¹ ∘ kfp``.  With ``prev == cur`` (start of sequence,
    post-failure, post-relocalization) the prediction degenerates exactly
    to constant-position.
    """
    if config.warm_start not in ("constant_position", "constant_velocity"):
        raise ValueError(f"unknown warm_start {config.warm_start!r}")
    if config.warm_start == "constant_position" or prev_pose is None:
        return pose_mod.compose(pose_mod.inverse(current_pose), keyframe_pose)
    vel = pose_mod.compose(pose_mod.inverse(prev_pose), current_pose)
    pred = pose_mod.renormalize_first_order(pose_mod.compose(current_pose, vel))
    return pose_mod.compose(pose_mod.inverse(pred), keyframe_pose)


class TrackResult(NamedTuple):
    model: Pose  # keyframe → current-frame motion estimate
    failed: jnp.ndarray  # bool: some level's Cholesky failed
    flow: jnp.ndarray  # mean abs optical flow at coarsest level (px)
    # per-level LM iteration counts, (nb_levels,) int32 indexed by level
    # (0 = finest) — observability for the warm-start/iteration-budget
    # tuning (tools/ab_warmstart.py); the counts come straight out of the
    # while_loop carries, so exposing them costs nothing
    nb_iters: jnp.ndarray


def track_frame(
    config: TrackerConfig,
    kf: KeyframeData,
    img_pyramid: List[jnp.ndarray],
    init_model: Pose,
) -> TrackResult:
    """Coarse-to-fine LM alignment of one frame against the keyframe
    (inverse_compositional.rs:170-240, minus the host-side state updates).

    On a level failure the remaining levels are skipped (the reference breaks
    the loop and the frame keeps its previous pose; the caller handles that).
    """
    if config.brightness_model:
        return _track_frame_brightness(config, kf, img_pyramid, init_model)
    model = init_model
    failed = jnp.asarray(False)
    nb_iters = [None] * config.nb_levels
    for lvl in reversed(range(config.nb_levels)):
        result = solve_level(
            kf.levels[lvl],
            img_pyramid[lvl],
            model,
            lm_coef_init=config.lm_coef_init,
            max_iterations=config.level_iterations(lvl),
            energy_tol=config.energy_tol,
            interp_method=config.interp_method,
            robust_delta=config.robust_delta,
        )
        # keep the previous model on failure; freeze after the first failure
        model = jax.tree_util.tree_map(
            lambda new, old: jnp.where(failed | result.failed, old, new),
            result.state.model,
            model,
        )
        failed = jnp.logical_or(failed, result.failed)
        nb_iters[lvl] = result.nb_iter

    # Optical-flow keyframe criterion at the coarsest level
    # (inverse_compositional.rs:211-222): mean |Δu| + |Δv| over candidates.
    coarse = kf.levels[-1]
    u, v = camera_mod.warp(model, coarse.xs, coarse.ys, coarse.idepth, coarse.intrinsics)
    dflow = jnp.abs(coarse.xs - u) + jnp.abs(coarse.ys - v)
    validf = coarse.valid.astype(Float)
    flow = jnp.sum(dflow * validf) / jnp.sum(validf)
    return TrackResult(
        model=model, failed=failed, flow=flow, nb_iters=jnp.stack(nb_iters)
    )


def _track_frame_brightness(
    config: TrackerConfig,
    kf: KeyframeData,
    img_pyramid: List[jnp.ndarray],
    init_model: Pose,
) -> TrackResult:
    """Coarse-to-fine track with joint affine-brightness estimation.

    (a, b) start at (1, 0) each frame and carry across pyramid levels, like
    the pose; the returned TrackResult is shape-compatible with the plain
    path (pose only — brightness is per-frame nuisance state)."""
    state = BrightnessState(pose=init_model, ab=jnp.array([1.0, 0.0], Float))
    failed = jnp.asarray(False)
    nb_iters = [None] * config.nb_levels
    for lvl in reversed(range(config.nb_levels)):
        result = solve_level_brightness(
            kf.levels[lvl],
            img_pyramid[lvl],
            state,
            lm_coef_init=config.lm_coef_init,
            max_iterations=config.level_iterations(lvl),
            energy_tol=config.energy_tol,
            interp_method=config.interp_method,
            robust_delta=config.robust_delta,
        )
        state = jax.tree_util.tree_map(
            lambda new, old: jnp.where(failed | result.failed, old, new),
            result.state.model,
            state,
        )
        failed = jnp.logical_or(failed, result.failed)
        nb_iters[lvl] = result.nb_iter

    coarse = kf.levels[-1]
    u, v = camera_mod.warp(
        state.pose, coarse.xs, coarse.ys, coarse.idepth, coarse.intrinsics
    )
    dflow = jnp.abs(coarse.xs - u) + jnp.abs(coarse.ys - v)
    validf = coarse.valid.astype(Float)
    flow = jnp.sum(dflow * validf) / jnp.sum(validf)
    return TrackResult(
        model=state.pose, failed=failed, flow=flow, nb_iters=jnp.stack(nb_iters)
    )


# ---------------------------------------------------------------------------
# Host-side Tracker: the reference's 4-call product API
# ---------------------------------------------------------------------------


class Tracker:
    """Stateful camera tracker over an RGB-D stream.

    Mirrors the reference's product API (``Config::init`` →
    ``Tracker::track`` → ``Tracker::current_frame``,
    src/bin/vors_track.rs:34-63).  The per-frame compute (pyramid, 6-level LM,
    flow) runs as jitted XLA computations; only the keyframe-switch decision
    and timestamps live on the host.  For the fully-fused batched/sharded
    tracker see ``parallel.batch``.
    """

    def __init__(
        self,
        config: TrackerConfig,
        intrinsics: Intrinsics,
        depth_timestamp: float,
        depth_map: jnp.ndarray,
        img_timestamp: float,
        img: jnp.ndarray,
    ):
        self.config = config
        self.intrinsics = intrinsics
        self._pyramid = jax.jit(
            lambda img: pyramid_ops.mean_pyramid(config.nb_levels, img)
        )
        if config.candidate_selector == "dso":
            # DSO selection (dso.rs:98-147): jitted gradient-norm stage,
            # host-side block-size recursion (core.candidates.dso.select —
            # each block size is a cached statically-shaped jit), then the
            # jitted precompute consuming the resulting level-0 mask
            self._grad_norm = jax.jit(gradient_ops.norm_direct)
            self._precompute_masked = jax.jit(
                lambda depth, pyr, mask: precompute_keyframe(
                    config, intrinsics, depth, pyr, finest_mask=mask
                )
            )

            def _precompute(depth, pyr):
                from ..core.candidates import dso as dso_mod

                mask = dso_mod.select(
                    self._grad_norm(pyr[0]), config.dso_target,
                    region_config=dso_mod.RegionConfig(
                        threshold_coef_a=config.dso_threshold_coef_a,
                        threshold_coef_b=config.dso_threshold_coef_b,
                    ),
                )
                return self._precompute_masked(depth, pyr, mask)

            self._precompute = _precompute
        else:
            self._precompute = jax.jit(
                lambda depth, pyr: precompute_keyframe(config, intrinsics, depth, pyr)
            )
        # One fused jit per frame: pyramid + 6-level LM + pose bookkeeping.
        # Everything stays on-device; the only host sync per frame is the
        # single (2,) diagnostics fetch in ``track``: every un-jitted op
        # would be a device dispatch of its own.
        def _step(kf, img, kf_pose, cur_pose, prev_pose):
            pyr = pyramid_ops.mean_pyramid(config.nb_levels, img)
            init_model = warm_start_init(config, kf_pose, cur_pose, prev_pose)
            result = track_frame(config, kf, pyr, init_model)
            proposed = pose_mod.compose(kf_pose, pose_mod.inverse(result.model))
            new_current = jax.tree_util.tree_map(
                lambda ok, old: jnp.where(result.failed, old, ok), proposed, cur_pose
            )
            # final finest-level photometric energy: lost-track detector for
            # the relocalization path.  Gated so the reference-exact
            # configuration (relocalize_window=0) pays nothing extra on the
            # latency-dominated per-frame path.
            if config.relocalize_window > 0:
                energy, _, _ = _eval_energy(
                    kf.levels[0], pyr[0], result.model, config.interp_method
                )
            else:
                energy = jnp.asarray(0.0, Float)
            diag = jnp.stack([result.flow, result.failed.astype(Float), energy])
            return new_current, diag, pyr

        self._step = jax.jit(_step)
        self._counts = jax.jit(
            lambda kf: jnp.stack([jnp.sum(L.valid) for L in kf.levels])
        )
        self._slice_cache = {}

        pyr = self._pyramid(img)
        raw_kf = self._precompute(depth_map, pyr)
        self.keyframe_data = self._maybe_bucket(raw_kf)
        self.keyframe_pose = pose_mod.identity()
        self.keyframe_depth_timestamp = depth_timestamp
        self.keyframe_img_timestamp = img_timestamp
        self.current_pose = pose_mod.identity()
        # previous frame's pose, for the constant-velocity warm start
        # (== current_pose → zero velocity → constant-position behavior)
        self.prev_pose = self.current_pose
        self.current_depth_timestamp = depth_timestamp
        self.current_img_timestamp = img_timestamp
        # per-frame diagnostics (metrics/observability; SURVEY §5)
        self.last_flow: float = 0.0
        self.last_failed: bool = False
        self.last_energy: float = 0.0
        self.keyframe_switches: int = 0
        # relocalization ring (models/relocalize.py): UNBUCKETED keyframe
        # data (uniform static shapes -> stackable for the vmapped attempt)
        self.relocalizations: int = 0
        self._reloc_history = []
        self._reloc_fn_cache = {}
        if config.relocalize_window > 0:
            self._reloc_history.append(
                (raw_kf, self.keyframe_pose, depth_timestamp, img_timestamp)
            )

    def track(
        self,
        depth_timestamp: float,
        depth_map: jnp.ndarray,
        img_timestamp: float,
        img: jnp.ndarray,
    ) -> None:
        """Track one frame (inverse_compositional.rs:170-240)."""
        import numpy as np

        new_current, diag, pyr = self._step(
            self.keyframe_data, img, self.keyframe_pose, self.current_pose,
            self.prev_pose,
        )
        diag_host = np.asarray(diag)  # the one device→host sync per frame

        self.current_depth_timestamp = depth_timestamp
        self.current_img_timestamp = img_timestamp
        self.prev_pose = self.current_pose
        self.current_pose = new_current
        self.last_failed = bool(diag_host[1])
        if self.last_failed:
            # pose kept; zero the velocity so the next init is the
            # reference's constant-position start from a known-good pose
            self.prev_pose = self.current_pose
        self.last_flow = float(diag_host[0])
        self.last_energy = float(diag_host[2])

        if self.config.relocalize_window > 0 and (
            self.last_failed
            or not np.isfinite(self.last_energy)
            or self.last_energy > self.config.relocalize_energy_accept
        ):
            # lost track: try to recover against the keyframe ring; whether
            # or not recovery succeeds, never let an untrackable frame
            # become the map anchor (suppress the flow-criterion switch).
            # Velocity is meaningless across a lost frame — zero it.
            self._try_relocalize(pyr)
            self.prev_pose = self.current_pose
            return

        if self.last_flow >= self.config.flow_threshold:
            raw_kf = self._precompute(depth_map, pyr)
            self.keyframe_data = self._maybe_bucket(raw_kf)
            self.keyframe_depth_timestamp = depth_timestamp
            self.keyframe_img_timestamp = img_timestamp
            self.keyframe_pose = self.current_pose
            self.keyframe_switches += 1
            if self.config.relocalize_window > 0:
                self._reloc_history.append(
                    (raw_kf, self.keyframe_pose, depth_timestamp, img_timestamp)
                )
                del self._reloc_history[: -self.config.relocalize_window]

    def _try_relocalize(self, pyr) -> None:
        """Recover the lost frame against the keyframe ring (ONE vmapped
        dispatch, models/relocalize.py).  On success, adopt the recovered
        pose and RE-ACTIVATE the matched keyframe as the tracking anchor;
        on failure, keep the reference behavior (previous pose retained)."""
        import numpy as np

        from . import relocalize as reloc_mod

        if not self._reloc_history:
            # the ring can legitimately be empty right after a checkpoint
            # restore with bucketing on (_reset_reloc_ring); recovery is
            # unavailable until the next keyframe switch refills it
            return
        kfs, kf_q, kf_t = reloc_mod.stack_history(self._reloc_history)
        K = len(self._reloc_history)
        if K not in self._reloc_fn_cache:
            cfg = self.config
            self._reloc_fn_cache[K] = jax.jit(
                lambda kfs, q, t, *pyr: reloc_mod.attempt(
                    cfg, kfs, q, t, list(pyr),
                    cfg.relocalize_energy_accept,
                    cfg.relocalize_min_inside_frac,
                )
            )
        res = self._reloc_fn_cache[K](kfs, kf_q, kf_t, *pyr)
        ok = bool(np.asarray(res.ok))
        if not ok:
            return
        best = int(np.asarray(res.best))
        self.current_pose = res.pose
        raw_kf, kf_pose, kf_dts, kf_its = self._reloc_history[best]
        self.keyframe_data = self._maybe_bucket(raw_kf)
        self.keyframe_pose = kf_pose
        self.keyframe_depth_timestamp = kf_dts
        self.keyframe_img_timestamp = kf_its
        self.last_failed = False
        self.last_energy = float(np.asarray(res.energy))
        self.relocalizations += 1

    def _maybe_bucket(self, kf: KeyframeData) -> KeyframeData:
        """Slice keyframe candidate arrays to power-of-two buckets.

        ``_extract_candidates`` compacts valid candidates to the front, so a
        front slice keeps every real point.  This is a host-side decision
        (one device→host count sync per keyframe switch); ``track_frame``
        re-specializes per bucket combination, and jit caching makes repeat
        buckets free.  Results match the unbucketed path up to f32 reduction
        order (padding lanes contribute exact zeros either way).
        """
        if not self.config.bucket_candidates:
            return kf
        import numpy as np

        counts = np.asarray(self._counts(kf))  # one sync for all levels
        buckets = []
        for obs, count in zip(kf.levels, counts):
            count = int(count)
            cap = obs.valid.shape[0]
            bucket = max(self.config.min_bucket, 1 << (max(count, 1) - 1).bit_length())
            buckets.append(min(bucket, cap))
        buckets = tuple(buckets)
        if buckets not in self._slice_cache:

            def slice_kf(kf):
                levels = []
                for obs, b in zip(kf.levels, buckets):
                    levels.append(
                        LevelObs(
                            intrinsics=obs.intrinsics,
                            template=obs.template,
                            xs=obs.xs[:b],
                            ys=obs.ys[:b],
                            idepth=obs.idepth[:b],
                            valid=obs.valid[:b],
                            tmpl_vals=obs.tmpl_vals[:b],
                            jacobians=obs.jacobians[:b],
                        )
                    )
                return KeyframeData(levels=tuple(levels))

            # one dispatch per switch instead of one per sliced array
            self._slice_cache[buckets] = jax.jit(slice_kf)
        return self._slice_cache[buckets](kf)

    def current_frame(self) -> Tuple[float, Pose]:
        """(depth timestamp, pose) of the last tracked frame
        (inverse_compositional.rs:243-248)."""
        return self.current_depth_timestamp, self.current_pose


def init_tracker(
    config: TrackerConfig,
    intrinsics: Intrinsics,
    depth_timestamp: float,
    depth_map: jnp.ndarray,
    img_timestamp: float,
    img: jnp.ndarray,
) -> Tracker:
    """The analog of ``Config::init`` (inverse_compositional.rs:74-100)."""
    return Tracker(config, intrinsics, depth_timestamp, depth_map, img_timestamp, img)
