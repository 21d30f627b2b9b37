"""Coarse-to-fine candidate-point selection, fully vectorized.

Capability parity with reference ``src/core/candidates/coarse_to_fine.rs``:
starting from an all-true mask at the coarsest gradient level, each finer
level keeps, inside every 2x2 block under a selected coarse pixel, the pixel
with the largest gradient plus the second-largest if
``second > third + diff_threshold`` (coarse_to_fine.rs:64-89).

Design: the per-block top-2 selection is a rank computation over the 4
stacked block corners — pure elementwise comparisons, no sort, no data-dependent shapes.  Output is a boolean mask per level (the
finest mask is the one the tracker consumes,
ref inverse_compositional.rs:120-125).
"""

from __future__ import annotations

from typing import List

import jax.numpy as jnp

from ...ops.pyramid import block_2x2


def _prune_block(thresh, a, b, c, d):
    """Vectorized ``prune_with_thresh`` (coarse_to_fine.rs:73-89).

    Returns 4 boolean maps (one per block corner).  Ties are broken by corner
    order a < b < c < d (the reference's unstable sort of equal keys is
    order-indeterminate; we fix a deterministic order).

    Round-4 formulation: a 6-comparator tournament + a 10-op min/max sorting
    network on the four (H/2, W/2) maps directly.  The previous version
    materialized (4, 4, H/2, W/2) pairwise ``beats`` tensors plus a lane
    sort — the keyframe precompute is dispatch/bandwidth-bound on exactly
    such image-sized intermediates, and this is numerically identical with ~4x fewer map-sized operations.
    """
    # integer inputs promote to i32 (u16 sqn from the public gradient API);
    # f32 carriers (exact integer values, the precompute's internal
    # pipeline) compare as-is — same results, native f32 arithmetic
    if jnp.issubdtype(a.dtype, jnp.integer):
        a, b, c, d = (x.astype(jnp.int32) for x in (a, b, c, d))
    cmp_dtype = a.dtype

    # pairwise "earlier corner beats on >=, later needs >" (the index
    # tie-break of the reference-fixed deterministic order)
    ab = a >= b
    ac = a >= c
    ad = a >= d
    bc = b >= c
    bd = b >= d
    cd = c >= d

    def i(x):
        return x.astype(jnp.int32)

    # rank = number of corners that beat this one (0 = largest)
    r_a = i(~ab) + i(~ac) + i(~ad)
    r_b = i(ab) + i(~bc) + i(~bd)
    r_c = i(ac) + i(bc) + i(~cd)
    r_d = i(ad) + i(bd) + i(cd)

    # second/third VALUES via a 4-element min/max sorting network
    s1 = jnp.maximum(a, b)
    t1 = jnp.minimum(a, b)
    s2 = jnp.maximum(c, d)
    t2 = jnp.minimum(c, d)
    mid1 = jnp.minimum(s1, s2)
    mid2 = jnp.maximum(t1, t2)
    second_val = jnp.maximum(mid1, mid2)
    third_val = jnp.minimum(mid1, mid2)
    keep_second = second_val > third_val + jnp.asarray(thresh, cmp_dtype)

    def keep(r):
        return jnp.logical_or(r == 0, jnp.logical_and(r == 1, keep_second))

    return keep(r_a), keep(r_b), keep(r_c), keep(r_d)


def _merge_block_masks(ka, kb, kc, kd):
    """Reassemble 4 corner masks (H/2, W/2) into a full-res mask (H, W).

    Formulation history (batched select, B=32, measured): a stack+reshape
    interleave forces layout transposes (11 ms); four static strided
    ``.at[::2].set`` updates were 2.4x faster (4.5 ms); the current
    broadcast-upsample + constant-phase-mask select fuses into one
    elementwise kernel — each corner upsamples by a layout-friendly
    (h2, 2, w2, 2) broadcast-reshape (row-major compatible: no transpose)
    and constant parity masks pick the right corner per pixel.
    """
    h2, w2 = ka.shape[-2:]
    lead = ka.shape[:-2]

    def up(x):
        # (.., h2, w2) -> (.., h2, 1, w2, 1) -> broadcast (.., h2, 2, w2, 2)
        # -> reshape (.., 2h2, 2w2): pure broadcast + row-major reshape
        xb = jnp.broadcast_to(
            x[..., :, None, :, None], (*lead, h2, 2, w2, 2)
        )
        return xb.reshape(*lead, 2 * h2, 2 * w2)

    row_odd = (jnp.arange(2 * h2) % 2 == 1)[:, None]
    col_odd = (jnp.arange(2 * w2) % 2 == 1)[None, :]
    # corner layout: [[a, c], [b, d]] (a=even/even, b=odd row, c=odd col)
    even_even = jnp.logical_and(~row_odd, ~col_odd)
    odd_even = jnp.logical_and(row_odd, ~col_odd)
    even_odd = jnp.logical_and(~row_odd, col_odd)
    odd_odd = jnp.logical_and(row_odd, col_odd)
    return (
        (up(ka) & even_even)
        | (up(kb) & odd_even)
        | (up(kc) & even_odd)
        | (up(kd) & odd_odd)
    )


def _swap_rows(x):
    """x[..., i, j] -> x[..., i ^ 1, j]: swap adjacent row pairs (block-local
    by construction — row i's partner is always inside the same aligned 2x2
    block).  Row-major reshape + tiny-axis reverse: layout-preserving, no
    strided deinterleave."""
    h, w = x.shape[-2:]
    xr = x.reshape(*x.shape[:-2], h // 2, 2, w)
    return xr[..., ::-1, :].reshape(*x.shape[:-2], h, w)


def _swap_cols(x):
    """x[..., i, j] -> x[..., i, j ^ 1] (column partner within the block)."""
    h, w = x.shape[-2:]
    xr = x.reshape(*x.shape[:-2], h, w // 2, 2)
    return xr[..., ::-1].reshape(*x.shape[:-2], h, w)


def _keep_mask_full(thresh, g):
    """Per-pixel top-2 keep mask at FULL resolution (round 5).

    Numerically identical to ``_prune_block`` + ``_merge_block_masks`` but
    with zero strided deinterleaves / re-interleaves: every pixel compares
    itself against its three 2x2-block partners obtained by adjacent-pair
    row/col swaps (pure layout-preserving elementwise ops, so XLA fuses the
    whole rank computation into O(1) kernels; the half-res corner
    formulation forced layout-hostile (h/2, w/2) slicing both ways).

    Tie-break: corner order a<b<c<d == order index ``2*col_parity +
    row_parity`` — x beats y iff ``g_x > g_y`` or equal values with the
    smaller order index (the reference-fixed deterministic order).

    ``g`` must have even trailing dims (callers slice to (2*h2, 2*w2)).
    """
    if jnp.issubdtype(g.dtype, jnp.integer):
        g = g.astype(jnp.int32)
    h, w = g.shape[-2:]
    rowp = (jnp.arange(h) % 2).astype(g.dtype)[:, None]  # 0 even, 1 odd
    colp = (jnp.arange(w) % 2).astype(g.dtype)[None, :]

    g_r = _swap_rows(g)          # row partner
    g_c = _swap_cols(g)          # col partner
    g_rc = _swap_cols(g_r)       # diagonal partner
    # partner order indices are pure functions of parity:
    # row partner flips rowp, col partner flips colp, diagonal flips both
    ord_p = 2 * colp + rowp
    ord_row = 2 * colp + (1 - rowp)
    ord_col = 2 * (1 - colp) + rowp
    ord_diag = 2 * (1 - colp) + (1 - rowp)

    def beats(gn, on):
        # neighbor beats this pixel
        return jnp.logical_or(
            gn > g, jnp.logical_and(gn == g, on < ord_p)
        )

    rank = (
        beats(g_r, ord_row).astype(jnp.int32)
        + beats(g_c, ord_col).astype(jnp.int32)
        + beats(g_rc, ord_diag).astype(jnp.int32)
    )

    # block second/third values, identical at all 4 pixels of a block
    s_row = jnp.maximum(g, g_r)   # max over the row pair of this column
    t_row = jnp.minimum(g, g_r)
    mid1 = jnp.minimum(s_row, _swap_cols(s_row))
    mid2 = jnp.maximum(t_row, _swap_cols(t_row))
    second_val = jnp.maximum(mid1, mid2)
    third_val = jnp.minimum(mid1, mid2)
    keep_second = second_val > third_val + jnp.asarray(thresh, g.dtype)

    return jnp.logical_or(
        rank == 0, jnp.logical_and(rank == 1, keep_second)
    )


def _upsample2_mask(pre, h2, w2):
    """(.., h2, w2) bool -> (.., 2h2, 2w2) by 2x2 replication (the
    broadcast-reshape interleave of ``_merge_block_masks.up``)."""
    lead = pre.shape[:-2]
    xb = jnp.broadcast_to(pre[..., :, None, :, None], (*lead, h2, 2, w2, 2))
    return xb.reshape(*lead, 2 * h2, 2 * w2)


def select(
    diff_threshold,
    gradient_sq_levels: List[jnp.ndarray],
    impl: str = "corner",
) -> List[jnp.ndarray]:
    """Multi-level candidate masks (coarse_to_fine.rs:15-32).

    ``gradient_sq_levels`` is ordered fine→coarse like the reference's
    pyramid; returns masks ordered coarse→fine with the *finest last*
    (callers use ``[-1]``).  The coarsest level is all-true.  At each finer
    level only blocks under a selected coarse pixel are evaluated.  Odd
    trailing rows/cols of a level are never selected (the reference's masks
    are sized from the half-resolution pre-mask).

    ``impl``: "corner" (default — the round-4 half-res corner comparator
    network) or "rolled" (the round-5 full-resolution partner-swap rank
    computation ``_keep_mask_full``; bit-identical output).  RETIRED as the
    default after an in-graph A/B (tools/ab_select.py) on the previous
    accelerator: faster as an isolated stage, slower inside the full
    precompute program, where XLA's downstream fusion and layout choices
    flipped the sign.  Kept as a tested variant until an A/B on the GPU
    decides it.
    """
    coarsest = gradient_sq_levels[-1]
    masks = [jnp.ones(coarsest.shape, dtype=bool)]
    for grad in reversed(gradient_sq_levels[:-1]):
        pre_mask = masks[-1]
        h, w = grad.shape[-2:]
        h2, w2 = h // 2, w // 2
        pre = pre_mask[..., :h2, :w2]
        if impl == "rolled":
            keep = _keep_mask_full(
                diff_threshold, grad[..., : 2 * h2, : 2 * w2]
            )
            full = keep & _upsample2_mask(pre, h2, w2)
        elif impl == "corner":
            a, b, c, d = block_2x2(grad)
            ka, kb, kc, kd = _prune_block(diff_threshold, a, b, c, d)
            full = _merge_block_masks(ka & pre, kb & pre, kc & pre, kd & pre)
        else:
            raise ValueError(f"unknown select impl {impl!r}")
        # pad back to the level's full (possibly odd) shape
        if full.shape[-2:] != (h, w):
            full = jnp.zeros(grad.shape, bool).at[..., : 2 * h2, : 2 * w2].set(full)
        masks.append(full)
    return masks
