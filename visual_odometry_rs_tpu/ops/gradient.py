"""Image gradients with the reference's integer semantics.

Capability parity with reference ``src/core/gradient.rs``:

- ``centered``: ``(I(i,j+1)-I(i,j-1))/2, (I(i+1,j)-I(i-1,j))/2`` with zero
  borders, i16, division truncating toward zero (gradient.rs:15-33).
- ``squared_norm`` from (gx, gy) (gradient.rs:38-44).
- ``squared_norm_direct`` from the image (gradient.rs:49-65).
- 2x2-block gradients ``bloc_x/bloc_y/bloc_squared_norm`` (gradient.rs:74-111)
  used to build gradient pyramids one level coarser than the image
  (ref ``core/multires.rs:96-126``).

Integer-parity note: Rust's integer ``/`` truncates toward zero while
numpy/jnp ``//`` floors; we use ``lax.div`` (C-style truncation) so negative
gradients match the reference bit-for-bit.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

from .pyramid import block_2x2


def _trunc_div(x: jnp.ndarray, d: int) -> jnp.ndarray:
    """Integer division truncating toward zero (Rust semantics)."""
    return jax.lax.div(x, jnp.asarray(d, x.dtype))


def centered(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Centered gradients of a u8 image, zero at the 1-pixel border."""
    im = img.astype(jnp.int16)
    h, w = img.shape[-2:]
    gx = jnp.zeros(img.shape, jnp.int16)
    gy = jnp.zeros(img.shape, jnp.int16)
    gx_inner = _trunc_div(im[..., 1 : h - 1, 2:w] - im[..., 1 : h - 1, 0 : w - 2], 2)
    gy_inner = _trunc_div(im[..., 2:h, 1 : w - 1] - im[..., 0 : h - 2, 1 : w - 1], 2)
    gx = gx.at[..., 1 : h - 1, 1 : w - 1].set(gx_inner)
    gy = gy.at[..., 1 : h - 1, 1 : w - 1].set(gy_inner)
    return gx, gy


def squared_norm(gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    """``gx^2 + gy^2`` in i32, cast to u16 (gradient.rs:38-44)."""
    g = gx.astype(jnp.int32) ** 2 + gy.astype(jnp.int32) ** 2
    return g.astype(jnp.uint16)


def squared_norm_direct(img: jnp.ndarray) -> jnp.ndarray:
    """Squared gradient norm straight from the image (gradient.rs:49-65).

    Uses the *unhalved* differences: ``((2gx)^2 + (2gy)^2) / 4``.
    """
    im = img.astype(jnp.int32)
    h, w = img.shape[-2:]
    dx = im[..., 1 : h - 1, 2:w] - im[..., 1 : h - 1, 0 : w - 2]
    dy = im[..., 2:h, 1 : w - 1] - im[..., 0 : h - 2, 1 : w - 1]
    inner = ((dx * dx + dy * dy) // 4).astype(jnp.uint16)
    out = jnp.zeros(img.shape, jnp.uint16)
    return out.at[..., 1 : h - 1, 1 : w - 1].set(inner)


def bloc_x(a, b, c, d) -> jnp.ndarray:
    """Horizontal gradient of a 2x2 block [[a,c],[b,d]] (gradient.rs:74-80)."""
    s = (
        c.astype(jnp.int16) + d.astype(jnp.int16)
        - a.astype(jnp.int16) - b.astype(jnp.int16)
    )
    return _trunc_div(s, 2)


def bloc_y(a, b, c, d) -> jnp.ndarray:
    """Vertical gradient of a 2x2 block [[a,c],[b,d]] (gradient.rs:87-93)."""
    s = (
        b.astype(jnp.int16) - a.astype(jnp.int16)
        + d.astype(jnp.int16) - c.astype(jnp.int16)
    )
    return _trunc_div(s, 2)


def bloc_squared_norm(a, b, c, d) -> jnp.ndarray:
    """Gradient squared norm of a 2x2 block (gradient.rs:102-111)."""
    ai, bi, ci, di = (x.astype(jnp.int32) for x in (a, b, c, d))
    dx = ci + di - ai - bi
    dy = bi - ai + di - ci
    return ((dx * dx + dy * dy) // 4).astype(jnp.uint16)


def norm_direct(img: jnp.ndarray) -> jnp.ndarray:
    """Gradient norm straight from the image: ``sqrt(squared_norm_direct)``
    truncated to u16 — the input the DSO candidate selector expects
    (ref examples/candidates_dso.rs:42)."""
    sq = squared_norm_direct(img).astype(jnp.float32)
    return jnp.sqrt(sq).astype(jnp.uint16)


# Pyramid-of-gradients helpers (ref core/multires.rs:96-126) ----------------


def gradients_xy(img_pyramid: List[jnp.ndarray]) -> List[Tuple[jnp.ndarray, jnp.ndarray]]:
    """(gx, gy) at each level 1..n-1 from the image one level finer."""
    out = []
    for img in img_pyramid[:-1]:
        a, b, c, d = block_2x2(img)
        out.append((bloc_x(a, b, c, d), bloc_y(a, b, c, d)))
    return out


# f32 internal pipeline (round 4) --------------------------------------------
#
# Every value here is an integer < 2^24, so the i16/i32 gradient arithmetic
# above is EXACT in f32 as well (and f32 is what the accelerator's vector
# units are built for): differences of u8 pixels are exact, halving is exact
# (x*0.5 of an integer-valued f32), truncation toward zero (`jnp.trunc`)
# reproduces Rust integer division bit-for-bit, and squared norms are
# <= 2*127^2 < 2^24.  The keyframe precompute uses these internally; the
# public integer functions above keep the reference's exact dtypes.


def _trunc_half_f32(x: jnp.ndarray) -> jnp.ndarray:
    """Exact Rust ``/2`` of an integer-valued f32 array."""
    return jnp.trunc(x * jnp.float32(0.5))


def centered_f32(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``centered`` with f32 carriers (identical integer values)."""
    im = img.astype(jnp.float32)
    h, w = img.shape[-2:]
    gx = jnp.zeros(img.shape, jnp.float32)
    gy = jnp.zeros(img.shape, jnp.float32)
    gx_inner = _trunc_half_f32(im[..., 1 : h - 1, 2:w] - im[..., 1 : h - 1, 0 : w - 2])
    gy_inner = _trunc_half_f32(im[..., 2:h, 1 : w - 1] - im[..., 0 : h - 2, 1 : w - 1])
    gx = gx.at[..., 1 : h - 1, 1 : w - 1].set(gx_inner)
    gy = gy.at[..., 1 : h - 1, 1 : w - 1].set(gy_inner)
    return gx, gy


def gradients_xy_f32(img_pyramid: List[jnp.ndarray]) -> List[Tuple[jnp.ndarray, jnp.ndarray]]:
    """``gradients_xy`` with f32 carriers (identical integer values)."""
    out = []
    for img in img_pyramid[:-1]:
        a, b, c, d = (x.astype(jnp.float32) for x in block_2x2(img))
        out.append((_trunc_half_f32(c + d - a - b), _trunc_half_f32(b - a + d - c)))
    return out


def squared_norm_f32(gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    """``squared_norm`` on f32 carriers: exact, and the reference's
    ``as u16`` cast (gradient.rs:38-44) can never wrap here, so no mod is
    needed.  Proof: for any 2x2-block gradient pair, ``gx + gy = d - a``
    and ``gx - gy = c - b`` (pre-truncation; truncation only shrinks
    magnitudes), so ``gx² + gy² = ((gx+gy)² + (gx-gy)²) / 2
    <= (255² + 255²)/2 = 65025 < 2^16``; centered gradients are within
    ±127, bounding the sum by 32258.  (``squared_norm_direct`` — the DSO
    path — CAN wrap and keeps the integer formulation.)
    """
    return gx * gx + gy * gy


def gradients_squared_norm(img_pyramid: List[jnp.ndarray]) -> List[jnp.ndarray]:
    """Squared-norm gradients at each level 1..n-1 (multires.rs:96-106)."""
    out = []
    for img in img_pyramid[:-1]:
        a, b, c, d = block_2x2(img)
        out.append(bloc_squared_norm(a, b, c, d))
    return out
