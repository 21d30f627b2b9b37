"""Ring collectives built on ``ppermute`` (SURVEY §5 "long-context").

The reference has no communication layer at all (no networking deps,
Cargo.toml:16-24).  This module provides the ring primitives the scaled
framework uses for keyframe-sharded reductions — the VO analog of
ring-attention passes: partial sums travel around the device ring,
each hop overlapping the local accumulation, so no chip ever materializes
the full replicated reduction buffer.

``psum`` is the right tool for small reducers (it is XLA's all-reduce);
these ring forms matter when the reduced object itself is sharded — e.g.
assembling the 6K x 6K Schur camera system of a long keyframe window where
each chip should only own K/n block-rows (``parallel.ba`` uses
``ring_reduce_scatter`` for its ``assembly="ring"`` mode).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _ring_perm(n: int):
    return [(j, (j + 1) % n) for j in range(n)]


def ring_reduce_scatter(x: jnp.ndarray, axis_name: str, axis_size: int) -> jnp.ndarray:
    """Ring reduce-scatter: sum ``x`` across the mesh axis, scattering chunks.

    ``x`` (per chip) has leading dimension ``axis_size * chunk``; chip ``i``
    returns the fully-summed chunk ``i`` (shape ``x.shape`` with leading dim
    ``chunk``).  Classic n-1-hop ring: chunk ``c`` starts on chip ``c+1``,
    walks the ring accumulating every chip's local contribution, and lands
    on its owner ``c`` at the last hop.  Peak per-chip live buffer is one
    chunk instead of the full array (what ``psum`` would replicate).
    """
    n = axis_size
    lead = x.shape[0]
    if lead % n != 0:
        raise ValueError(f"leading dim {lead} not divisible by axis size {n}")
    chunks = x.reshape(n, lead // n, *x.shape[1:])
    if n == 1:
        return chunks[0]
    idx = jax.lax.axis_index(axis_name)
    perm = _ring_perm(n)

    acc = jnp.take(chunks, (idx - 1) % n, axis=0)

    def body(s, acc):
        acc = jax.lax.ppermute(acc, axis_name, perm)
        c = (idx - s - 2) % n
        return acc + jnp.take(chunks, c, axis=0)

    return jax.lax.fori_loop(0, n - 1, body, acc)


def ring_all_gather(x: jnp.ndarray, axis_name: str, axis_size: int) -> jnp.ndarray:
    """Ring all-gather: concatenate each chip's ``x`` along a new leading
    chunk dim, ordered by device index (n-1 ``ppermute`` hops).

    Returns shape ``(axis_size * x.shape[0], ...)`` — the inverse layout of
    ``ring_reduce_scatter``'s output.
    """
    n = axis_size
    if n == 1:
        return x
    idx = jax.lax.axis_index(axis_name)
    perm = _ring_perm(n)

    out = jnp.zeros((n, *x.shape), x.dtype)
    out = jax.lax.dynamic_update_index_in_dim(out, x, idx, 0)

    def body(s, carry):
        out, buf = carry
        buf = jax.lax.ppermute(buf, axis_name, perm)
        src = (idx - s - 1) % n  # whose chunk just arrived
        out = jax.lax.dynamic_update_index_in_dim(out, buf, src, 0)
        return out, buf

    out, _ = jax.lax.fori_loop(0, n - 1, body, (out, x))
    return out.reshape(n * x.shape[0], *x.shape[1:])


def ring_all_reduce(x: jnp.ndarray, axis_name: str, axis_size: int) -> jnp.ndarray:
    """All-reduce as reduce-scatter + all-gather (bandwidth-optimal ring).

    Numerically equivalent to ``psum`` up to f32 summation order.  Requires
    the leading dim divisible by ``axis_size``.
    """
    return ring_all_gather(
        ring_reduce_scatter(x, axis_name, axis_size), axis_name, axis_size
    )
