"""Multi-resolution pyramids with the reference's integer semantics.

Capability parity with reference ``src/core/multires.rs``:

- ``mean_pyramid``: each level halves resolution via the integer mean of each
  2x2 block, ``(a+b+c+d)/4`` in u16 truncating back to u8 (multires.rs:21-31).
- ``halve``: generic 2x2-block reduction (multires.rs:67-88); odd rows/cols
  drop the last row/col; returns None below 2 pixels.
- ``limited_sequence`` / ``sequence`` combinators (multires.rs:38-60).

Design: a 2x2 block reduction is a reshape
``(H, W) → (H//2, 2, W//2, 2)`` followed by elementwise ops — XLA fuses this
into a single elementwise pass, no kernel needed.  Shapes are static per level; a
pyramid is a Python list of arrays (one fixed shape per level), which is the
XLA-friendly representation of a ragged multi-resolution stack.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import jax.numpy as jnp


def block_2x2(mat: jnp.ndarray):
    """Split a matrix into its 2x2 block corners ``(a, b, c, d)``.

    Matches the reference block layout (multires.rs:79-84):
    ``a=(2i,2j)  b=(2i+1,2j)  c=(2i,2j+1)  d=(2i+1,2j+1)``
    i.e. a=top-left, b=bottom-left, c=top-right, d=bottom-right.
    Odd trailing row/col are dropped.
    """
    h2 = mat.shape[-2] // 2
    w2 = mat.shape[-1] // 2
    m = mat[..., : 2 * h2, : 2 * w2]
    m = m.reshape(*m.shape[:-2], h2, 2, w2, 2)
    a = m[..., :, 0, :, 0]
    b = m[..., :, 1, :, 0]
    c = m[..., :, 0, :, 1]
    d = m[..., :, 1, :, 1]
    return a, b, c, d


def halve(mat: jnp.ndarray, f: Callable) -> Optional[jnp.ndarray]:
    """Apply ``f(a, b, c, d)`` to every 2x2 block. None if any dim < 2."""
    if mat.shape[-2] // 2 == 0 or mat.shape[-1] // 2 == 0:
        return None
    return f(*block_2x2(mat))


def sequence(data, f: Callable) -> List:
    """Repeatedly apply ``f`` until it returns None (multires.rs:53-60).

    Host-side combinator: the number of levels is static (derived from
    shapes), so the returned list has a deterministic trace-time length.
    """
    out = [data]
    while True:
        nxt = f(out[-1])
        if nxt is None:
            return out
        out.append(nxt)


def limited_sequence(max_length: int, data, f: Callable) -> List:
    """Like ``sequence`` but capped at ``max_length`` levels (multires.rs:38-49)."""
    out = [data]
    while len(out) < max_length:
        nxt = f(out[-1])
        if nxt is None:
            return out
        out.append(nxt)
    return out


def mean_2x2_u8(a, b, c, d) -> jnp.ndarray:
    """Integer mean of a 2x2 block of u8, truncating like the reference."""
    s = (
        a.astype(jnp.uint16)
        + b.astype(jnp.uint16)
        + c.astype(jnp.uint16)
        + d.astype(jnp.uint16)
    )
    return (s // 4).astype(jnp.uint8)


def mean_pyramid(max_levels: int, img: jnp.ndarray) -> List[jnp.ndarray]:
    """u8 mean pyramid with exact reference semantics (multires.rs:21-31)."""
    return limited_sequence(max_levels, img, lambda m: halve(m, mean_2x2_u8))


def num_levels(height: int, width: int, max_levels: int) -> int:
    """Number of levels ``mean_pyramid`` would produce for this shape."""
    n = 1
    h, w = height, width
    while n < max_levels and h // 2 > 0 and w // 2 > 0:
        h, w = h // 2, w // 2
        n += 1
    return n


def level_shapes(height: int, width: int, nb_levels: int):
    """Static shapes of each pyramid level."""
    shapes = [(height, width)]
    for _ in range(1, nb_levels):
        h, w = shapes[-1]
        shapes.append((h // 2, w // 2))
    return shapes
