"""DSO candidate-point selection, vectorized.

Capability parity with reference ``src/core/candidates/dso.rs`` (the faithful
picker from "Direct Sparse Odometry", Engel et al., PAMI 2018):

1. 32x32-region median gradients (dso.rs:307-325),
2. 3x3-smoothed quadratic thresholds ``a (mean3x3(median) + b)^2``
   (dso.rs:284-303),
3. per-block max-gradient picking over ``nb_levels`` block scales with a
   decaying threshold factor (dso.rs:154-276),
4. recursive block-size adaptation toward a target point count with bounds
   (0.8, 4.0) and random thinning above ratio 1.1 (dso.rs:98-147).

Design: block maxima are reshape+argmax reductions; region medians
are sorts over fixed 32x32 tiles (edge tiles padded with a +inf sentinel and
indexed at their true half-length); the ≤2-step recursion stays host-side with
a statically-shaped jitted core per block size.  The reference's
``thread_rng`` thinning (dso.rs:142 — nondeterministic) is replaced by an
explicit ``jax.random`` key.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ...utils.types import Float


@dataclass(frozen=True)
class RegionConfig:
    """(dso.rs:37-42, defaults :72-75 — "(2.0,3) in dso and (1.0,3) in ldso")."""

    size: int = 32
    threshold_coef_a: float = 1.0
    threshold_coef_b: int = 3


@dataclass(frozen=True)
class BlockConfig:
    """(dso.rs:45-53, defaults :78-82)."""

    base_size: int = 4
    nb_levels: int = 3
    threshold_factor: float = 0.5


@dataclass(frozen=True)
class RecursiveConfig:
    """(dso.rs:58-69, defaults :85-90)."""

    nb_iterations_left: int = 1
    low_thresh: float = 0.8
    high_thresh: float = 4.0
    random_thresh: float = 1.1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@partial(jax.jit, static_argnames=("size",))
def region_median_gradients(gradients: jnp.ndarray, size: int) -> jnp.ndarray:
    """Median gradient of each size x size region; right/bottom regions may be
    smaller (dso.rs:307-325).  Median = sorted[len/2] (upper median)."""
    h, w = gradients.shape
    nr, nc = _ceil_div(h, size), _ceil_div(w, size)
    pad_h, pad_w = nr * size - h, nc * size - w
    big = jnp.iinfo(jnp.int32).max
    g = jnp.pad(gradients.astype(jnp.int32), ((0, pad_h), (0, pad_w)), constant_values=big)
    tiles = g.reshape(nr, size, nc, size).transpose(0, 2, 1, 3).reshape(nr, nc, size * size)
    tiles = jnp.sort(tiles, axis=-1)
    # actual region sizes at the edges
    rh = jnp.minimum(size, h - jnp.arange(nr) * size)
    rw = jnp.minimum(size, w - jnp.arange(nc) * size)
    count = rh[:, None] * rw[None, :]
    med = jnp.take_along_axis(tiles, (count // 2)[..., None], axis=-1)[..., 0]
    return med.astype(gradients.dtype)


@partial(jax.jit, static_argnames=("coef_a", "coef_b"))
def region_thresholds(
    median_gradients: jnp.ndarray, coef_a: float, coef_b: int
) -> jnp.ndarray:
    """``a (mean3x3(median) + b)^2`` with edge-aware 3x3 means (dso.rs:284-303)."""
    med = median_gradients.astype(Float)
    ones = jnp.ones_like(med)
    kernel = jnp.ones((3, 3), Float)

    def box(x):
        return jax.lax.conv_general_dilated(
            x[None, None], kernel[None, None], (1, 1), "SAME",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
        )[0, 0]

    mean = box(med) / box(ones)
    tmp = mean + float(coef_b)
    # match the reference's left-associated f32 product a * t * t
    # (dso.rs:301) bit-for-bit — a * t**2 can differ by 1 ulp when a != 1
    thresh = (coef_a * tmp) * tmp
    # num_traits::cast to the integer gradient type truncates toward zero
    return jnp.trunc(thresh).astype(jnp.int32)


def _block_max(gradients: jnp.ndarray, block_size: int):
    """(max value, abs row, abs col) per block; edge blocks smaller
    (dso.rs:193-222).  Ties pick the first in row-major scan order."""
    h, w = gradients.shape
    nr, nc = _ceil_div(h, block_size), _ceil_div(w, block_size)
    pad_h, pad_w = nr * block_size - h, nc * block_size - w
    g = jnp.pad(gradients.astype(jnp.int32), ((0, pad_h), (0, pad_w)), constant_values=-1)
    tiles = (
        g.reshape(nr, block_size, nc, block_size)
        .transpose(0, 2, 1, 3)
        .reshape(nr, nc, block_size * block_size)
    )
    idx = jnp.argmax(tiles, axis=-1)
    val = jnp.take_along_axis(tiles, idx[..., None], axis=-1)[..., 0]
    di = idx // block_size
    dj = idx % block_size
    bi = jax.lax.broadcasted_iota(jnp.int32, (nr, nc), 0)
    bj = jax.lax.broadcasted_iota(jnp.int32, (nr, nc), 1)
    return val, bi * block_size + di, bj * block_size + dj


def _gmax(m1, m2):
    """``if m1.val < m2.val then m2 else m1`` (dso.rs:225-239)."""
    take2 = m1[0] < m2[0]
    return tuple(jnp.where(take2, b, a) for a, b in zip(m1, m2))


def _halve_max(m):
    """2x2 halving of (val, i, j) block-max maps with the reference's
    tie-preference chain ``g_max(a, g_max(b, g_max(c, d)))``."""
    val, pi, pj = m
    h2, w2 = val.shape[0] // 2, val.shape[1] // 2
    if h2 == 0 or w2 == 0:
        return None

    def corner(di, dj):
        return (
            val[di : 2 * h2 : 2, dj : 2 * w2 : 2],
            pi[di : 2 * h2 : 2, dj : 2 * w2 : 2],
            pj[di : 2 * h2 : 2, dj : 2 * w2 : 2],
        )

    a, b, c, d = corner(0, 0), corner(1, 0), corner(0, 1), corner(1, 1)
    return _gmax(a, _gmax(b, _gmax(c, d)))


def _pick_all(
    gradients: jnp.ndarray,
    thresholds: jnp.ndarray,
    block_size: int,
    nb_levels: int,
    threshold_factor: float,
    region_size: int,
):
    """Pick candidates at all block levels (dso.rs:156-276).

    Returns (total picked count, picked-level u8 map).
    """
    h, w = gradients.shape
    maxg = [_block_max(gradients, block_size)]
    for _ in range(1, nb_levels):
        nxt = _halve_max(maxg[-1])
        if nxt is None:
            break
        maxg.append(nxt)

    candidates = jnp.zeros((h, w), jnp.uint8)
    mask = jnp.ones(maxg[0][0].shape, bool)
    coef = 1.0
    total = jnp.asarray(0, jnp.int32)
    for level, (val, pi, pj) in enumerate(maxg):
        mh, mw = mask.shape
        eh, ew = mh // 2 * 2, mw // 2 * 2
        # blocks outside the even crop are ignored at this level (dso.rs:260-261)
        in_crop = jnp.zeros((mh, mw), bool).at[:eh, :ew].set(True)
        region_thresh = thresholds[pi // region_size, pj // region_size].astype(Float)
        meets = val.astype(Float) >= coef * region_thresh
        picked = mask & in_crop & meets
        total = total + jnp.sum(picked.astype(jnp.int32))
        # scatter level number at picked argmax pixels (unique per block)
        safe_i = jnp.where(picked, pi, h)  # out-of-bounds -> dropped
        safe_j = jnp.where(picked, pj, w)
        candidates = candidates.at[safe_i, safe_j].set(
            jnp.uint8(level + 1), mode="drop"
        )
        # next-level mask: all 4 children must be unpicked and masked-in
        if level + 1 < len(maxg):
            keep = (mask & ~picked)[:eh, :ew]
            mask = (
                keep[0::2, 0::2] & keep[1::2, 0::2] & keep[0::2, 1::2] & keep[1::2, 1::2]
            )
            coef *= threshold_factor
    return total, candidates


@partial(
    jax.jit,
    static_argnames=("block_size", "nb_levels", "threshold_factor", "region_size",
                     "coef_a", "coef_b"),
)
def _select_once(
    gradients: jnp.ndarray,
    block_size: int,
    nb_levels: int,
    threshold_factor: float,
    region_size: int,
    coef_a: float,
    coef_b: int,
):
    med = region_median_gradients(gradients, region_size)
    thresh = region_thresholds(med, coef_a, coef_b)
    return _pick_all(gradients, thresh, block_size, nb_levels, threshold_factor, region_size)


def select_fixed_block(
    gradients: jnp.ndarray,
    nb_target: int,
    *,
    block_size: int = 4,
    region_config: RegionConfig = RegionConfig(),
    block_config: BlockConfig = BlockConfig(),
    recursive_config: RecursiveConfig = RecursiveConfig(),
    key: jax.Array | None = None,
) -> jnp.ndarray:
    """Recursion-free DSO selection at a STATIC block size — fully jittable.

    The full ``select`` adapts ``block_size`` toward ``nb_target`` with a
    host-side recursion on the measured candidate count (dso.rs:117-139),
    which cannot run inside ``precompute_keyframe`` under jit.  This variant
    freezes the block size (the recursion is ≤``nb_iterations_left``=1 deep
    and usually a no-op once a scene-appropriate size is known) but KEEPS
    the reference's random thinning in-graph: the over-selection ratio and
    the keep-probability cutoff ``int(255 / ratio)`` (dso.rs:140-143) are
    traced values, so thinning needs no host decision.  Matches ``select``
    bit-for-bit whenever the host recursion does not fire (same block size,
    same key) — pinned by ``tests/test_dso.py``.

    This is the carrier that makes ``candidate_selector="dso_fixed"``
    available to the fused in-graph drivers (``--chunk``, ``vors_batch``),
    where the host ``select`` cannot run.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    thresholds = region_thresholds(
        region_median_gradients(gradients, region_config.size),
        region_config.threshold_coef_a,
        region_config.threshold_coef_b,
    )
    total, picked = _pick_all(
        gradients,
        thresholds,
        block_size,
        block_config.nb_levels,
        block_config.threshold_factor,
        region_config.size,
    )
    mask = picked > 0
    rec = recursive_config
    ratio = total.astype(Float) / float(nb_target)
    # reference thinning: keep where rnd <= int(255 / ratio) (dso.rs:140-143)
    # — applied only when random_thresh < ratio AND the count sits inside the
    # (low, high) bounds; out-of-bounds counts return UNthinned in the
    # reference (its recursion epilogue), and equality with the host
    # ``select`` at nb_iterations_left=0 preserves that branch shape
    rnd = jax.random.randint(key, mask.shape, 0, 256, jnp.int32)
    cutoff = jnp.floor(255.0 / jnp.maximum(ratio, 1e-9)).astype(jnp.int32)
    thin = jnp.logical_and(
        ratio > rec.random_thresh,
        jnp.logical_and(ratio >= rec.low_thresh, ratio <= rec.high_thresh),
    )
    return jnp.where(thin, mask & (rnd <= cutoff), mask)


def select(
    gradients: jnp.ndarray,
    nb_target: int,
    *,
    region_config: RegionConfig = RegionConfig(),
    block_config: BlockConfig = BlockConfig(),
    recursive_config: RecursiveConfig = RecursiveConfig(),
    key: jax.Array | None = None,
) -> jnp.ndarray:
    """DSO candidate selection toward ``nb_target`` points (dso.rs:98-147).

    The ≤ ``nb_iterations_left``-deep recursion adapts the block size
    host-side (each size is a fresh statically-shaped jit).  Returns a boolean
    mask.  ``key`` seeds the random thinning (deterministic; pass None for
    key 0).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    block = block_config
    rec = recursive_config
    while True:
        total, picked = _select_once(
            gradients,
            block.base_size,
            block.nb_levels,
            block.threshold_factor,
            region_config.size,
            region_config.threshold_coef_a,
            region_config.threshold_coef_b,
        )
        nb_candidates = int(total)
        ratio = nb_candidates / nb_target
        # nb_candidates ≈ K / (block_size + 1)^2 ⇒ rescale (dso.rs:117-126)
        target_size = max(1, round(math.sqrt(ratio) * (block.base_size + 1) - 1.0))
        if ratio < rec.low_thresh or ratio > rec.high_thresh:
            if target_size != block.base_size and rec.nb_iterations_left > 0:
                block = BlockConfig(
                    base_size=target_size,
                    nb_levels=block.nb_levels,
                    threshold_factor=block.threshold_factor,
                )
                rec = RecursiveConfig(
                    nb_iterations_left=rec.nb_iterations_left - 1,
                    low_thresh=rec.low_thresh,
                    high_thresh=rec.high_thresh,
                    random_thresh=rec.random_thresh,
                )
                continue
            return picked > 0
        if ratio > rec.random_thresh:
            # random thinning: keep with probability ~ 1/ratio (dso.rs:140-143)
            rnd = jax.random.randint(key, picked.shape, 0, 256, jnp.int32)
            return (picked > 0) & (rnd <= int(255.0 / ratio))
        return picked > 0
