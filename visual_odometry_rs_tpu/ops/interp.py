"""Masked bilinear interpolation — the gather at the heart of the hot loop.

Reference semantics (``src/core/track/lm_optimizer.rs:227-251`` and the
identical copy in ``examples/optim_affine-2d.rs:382-406``): with
``u = floor(x)``, ``v = floor(y)``, a point is *inside* iff
``0 <= u < width-2`` and ``0 <= v < height-2``; inside points are sampled
with bilinear weights ``(a, b) = (x-u, y-v)``; outside points contribute
nothing (the reference drops them from the residual vector, we return a mask).

Three interchangeable implementations:

- ``bilinear_gather``: XLA gather via advanced indexing (the default).
- ``bilinear_onehot``: reformulates sampling as matrix products
  ``out = rowsel(N,H) @ img(H,W) . colsel(N,W)`` where the one-hot selection
  matrices carry the bilinear weights, so the gather becomes dense matmul
  work when the table (image level) is small enough.
- ``bilinear_onehot_weighted``: one weighted-selector matmul.

All return ``(values, inside_mask)`` with fixed shapes.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils.types import Float


def inside_mask(x: jnp.ndarray, y: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """The reference's interpolation domain (lm_optimizer.rs:231)."""
    u = jnp.floor(x)
    v = jnp.floor(y)
    return (u >= 0.0) & (u < width - 2) & (v >= 0.0) & (v < height - 2)


def bilinear_gather(
    img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bilinear sample ``img`` (H, W) at float coords; XLA-gather path.

    ``x`` indexes columns (u) and ``y`` rows (v), like the reference.
    Out-of-domain points return value 0 with mask False.
    """
    height, width = img.shape[-2:]
    u = jnp.floor(x)
    v = jnp.floor(y)
    mask = (u >= 0.0) & (u < width - 2) & (v >= 0.0) & (v < height - 2)

    u0 = jnp.clip(u.astype(jnp.int32), 0, width - 2)
    v0 = jnp.clip(v.astype(jnp.int32), 0, height - 2)
    u1 = u0 + 1
    v1 = v0 + 1

    imf = img.astype(Float)
    vu00 = imf[..., v0, u0]
    vu10 = imf[..., v1, u0]
    vu01 = imf[..., v0, u1]
    vu11 = imf[..., v1, u1]

    a = x - u
    b = y - v
    val = (
        (1.0 - b) * (1.0 - a) * vu00
        + b * (1.0 - a) * vu10
        + (1.0 - b) * a * vu01
        + b * a * vu11
    )
    return jnp.where(mask, val, 0.0), mask


def bilinear_onehot(
    img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bilinear sample via one-hot matmuls.

    Row gather as an **exact bf16 matmul**: the selector matrix holds pure
    0/1 one-hots for rows v0 and v1 stacked into (2N, H), the image is u8
    (0..255 — exactly representable in bf16, as are 0/1), and each output
    element accumulates exactly one nonzero product into the f32 accumulator
    — so a default-precision bf16 matmul gathers rows *bit-exactly*,
    without the cost of ``Precision.HIGHEST``.  The fractional bilinear
    weights (a, b) are then applied elementwise in f32:
    ``val = Σ_w cols[n,w] · ((1-b) g0 + b g1)[n,w]`` with ``cols`` the
    (1-a)/a-weighted column one-hots.

    Cost: 2·N·H·W bf16 MACs + O(N·W) elementwise flops: it scales with the
    level's H·W, where the gather does not.
    """
    height, width = img.shape[-2:]
    n = x.shape[-1]
    u = jnp.floor(x)
    v = jnp.floor(y)
    mask = (u >= 0.0) & (u < width - 2) & (v >= 0.0) & (v < height - 2)

    u0 = jnp.clip(u.astype(jnp.int32), 0, width - 2)
    v0 = jnp.clip(v.astype(jnp.int32), 0, height - 2)
    a = (x - u).astype(Float)
    b = (y - v).astype(Float)

    rows_idx = jax.lax.broadcasted_iota(jnp.int32, (n, height), 1)
    cols_idx = jax.lax.broadcasted_iota(jnp.int32, (n, width), 1)
    v0c = v0[..., None]
    u0c = u0[..., None]
    # (2N, H) exact 0/1 selectors: first N rows pick v0, last N pick v0+1.
    sel01 = jnp.concatenate([(rows_idx == v0c), (rows_idx == v0c + 1)], axis=0)
    exact_in_bf16 = (
        jnp.issubdtype(img.dtype, jnp.integer) and img.dtype.itemsize == 1
    ) or img.dtype == jnp.bfloat16
    if exact_in_bf16:
        # u8/i8 pixels and 0/1 selectors are exact in bf16, and each output
        # element sums exactly one nonzero product -> a default-precision
        # bf16 matmul is bit-exact.  Wider integers (u16 depth maps etc.) do NOT
        # fit bf16's 8-bit significand and take the exact f32 branch below.
        gathered = jnp.dot(
            sel01.astype(jnp.bfloat16),
            img.astype(jnp.bfloat16),
            preferred_element_type=Float,
        )  # (2N, W)
    else:
        # float or wide-integer images: keep full f32 through the matmul
        gathered = jnp.dot(
            sel01.astype(Float),
            img.astype(Float),
            precision=jax.lax.Precision.HIGHEST,
        )
    g0 = gathered[:n]
    g1 = gathered[n:]
    interp_rows = (1.0 - b)[..., None] * g0 + b[..., None] * g1  # (N, W) f32
    cols = jnp.where(cols_idx == u0c, (1.0 - a)[..., None], 0.0) + jnp.where(
        cols_idx == u0c + 1, a[..., None], 0.0
    )
    val = jnp.sum(interp_rows * cols, axis=-1)
    return jnp.where(mask, val, 0.0), mask


def bilinear_onehot_weighted(
    img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single weighted one-hot matmul variant (f32, ``Precision.HIGHEST``).

    ``rows[n] = (1-b) e_{v0} + b e_{v1}`` carries the vertical weights inside
    the selector, so one (N,H)x(H,W) matmul interpolates rows.  XLA's
    algebraic simplifier can recognize the dot-of-one-hot pattern and lower
    it as a gather, which makes this variant the fastest in some fusion
    contexts — kept alongside ``bilinear_onehot`` so callers can pick per
    workload (both are within f32 rounding of ``bilinear_gather``).
    """
    height, width = img.shape[-2:]
    u = jnp.floor(x)
    v = jnp.floor(y)
    mask = (u >= 0.0) & (u < width - 2) & (v >= 0.0) & (v < height - 2)

    u0 = jnp.clip(u.astype(jnp.int32), 0, width - 2)
    v0 = jnp.clip(v.astype(jnp.int32), 0, height - 2)
    a = (x - u).astype(Float)
    b = (y - v).astype(Float)

    rows_idx = jax.lax.broadcasted_iota(jnp.int32, (x.shape[-1], height), 1)
    cols_idx = jax.lax.broadcasted_iota(jnp.int32, (x.shape[-1], width), 1)
    v0c = v0[..., None]
    u0c = u0[..., None]
    rows = jnp.where(rows_idx == v0c, (1.0 - b)[..., None], 0.0) + jnp.where(
        rows_idx == v0c + 1, b[..., None], 0.0
    )
    cols = jnp.where(cols_idx == u0c, (1.0 - a)[..., None], 0.0) + jnp.where(
        cols_idx == u0c + 1, a[..., None], 0.0
    )
    interp_rows = jnp.dot(
        rows, img.astype(Float), precision=jax.lax.Precision.HIGHEST
    )  # (N, W)
    val = jnp.sum(interp_rows * cols, axis=-1)
    return jnp.where(mask, val, 0.0), mask


def bilinear(
    img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray, method: str = "auto"
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dispatch bilinear sampling; ``auto`` is ``gather`` on every backend."""
    if method in ("auto", "gather"):
        return bilinear_gather(img, x, y)
    if method == "onehot":
        return bilinear_onehot(img, x, y)
    if method == "onehot_weighted":
        return bilinear_onehot_weighted(img, x, y)
    raise ValueError(f"unknown interpolation method: {method}")
