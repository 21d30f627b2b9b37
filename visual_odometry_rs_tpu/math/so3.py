"""Lie algebra/group functions for 3D rotations (so3 / SO3), pure JAX.

Capability parity with reference ``src/math/so3.rs``: ``hat``, ``hat_2``,
``vee``, ``exp`` (axis-angle → unit quaternion) and ``log`` (unit quaternion →
axis-angle), including the Taylor-series branches below the same threshold
``theta^2 < (1e-2)^2`` (ref so3.rs:19-20).

Design notes: there is no data-dependent branching — both the Taylor
and the exact expressions are evaluated and selected with ``jnp.where`` so the
functions are jit/vmap-safe with static shapes.  All functions broadcast over
arbitrary leading batch axes.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.types import Float
from . import pose as _pose

# Same Taylor thresholds as the reference (so3.rs:19-20).
EPSILON_TAYLOR_SERIES = 1e-2
EPSILON_TAYLOR_SERIES_2 = EPSILON_TAYLOR_SERIES * EPSILON_TAYLOR_SERIES


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so3 parameterization (…,3) → skew-symmetric matrix (…,3,3). Ref so3.rs:27-33."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    m = jnp.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], axis=-1)
    return m.reshape(*w.shape[:-1], 3, 3)


def hat_2(w: jnp.ndarray) -> jnp.ndarray:
    """Squared hat operator, ``hat_2(w) == hat(w) @ hat(w)`` (symmetric).

    Computed directly from products like the reference (so3.rs:38-50).
    """
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    w11, w22, w33 = wx * wx, wy * wy, wz * wz
    w12, w13, w23 = wx * wy, wx * wz, wy * wz
    m = jnp.stack(
        [-w22 - w33, w12, w13, w12, -w11 - w33, w23, w13, w23, -w11 - w22],
        axis=-1,
    )
    return m.reshape(*w.shape[:-1], 3, 3)


def vee(mat: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat (no skew-symmetry check, like the reference so3.rs:54-56)."""
    return jnp.stack([mat[..., 2, 1], mat[..., 0, 2], mat[..., 1, 0]], axis=-1)


def exp(w: jnp.ndarray) -> jnp.ndarray:
    """Exponential map so3 → SO3, returning a unit quaternion [w,x,y,z].

    Mirrors ref so3.rs:61-77, including the final normalization performed by
    nalgebra's ``UnitQuaternion::from_quaternion``.
    """
    w = jnp.asarray(w, dtype=Float)
    theta_2 = jnp.sum(w * w, axis=-1)
    use_taylor = theta_2 < EPSILON_TAYLOR_SERIES_2
    # Taylor branch (so3.rs:66-67).
    real_taylor = 1.0 - 0.125 * theta_2
    imag_taylor = 0.5 - (1.0 / 48.0) * theta_2
    # Exact branch (so3.rs:69-72); guard sqrt(0) for the gradient path.
    theta = jnp.sqrt(jnp.where(use_taylor, 1.0, theta_2))
    half_theta = 0.5 * theta
    real_exact = jnp.cos(half_theta)
    imag_exact = jnp.sin(half_theta) / theta
    real = jnp.where(use_taylor, real_taylor, real_exact)
    imag = jnp.where(use_taylor, imag_taylor, imag_exact)
    q = jnp.concatenate([real[..., None], imag[..., None] * w], axis=-1)
    return _pose.quat_normalize(q)


def log(q: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map SO3 → so3 for unit quaternions [w,x,y,z].

    Three branches like ref so3.rs:81-99: Taylor for small imaginary norm,
    a Taylor-in-alpha branch near theta = pi (|real| small), and the exact
    ``2 atan(|v|/w)`` branch otherwise.
    """
    q = jnp.asarray(q, dtype=Float)
    imag = q[..., 1:]
    real = q[..., 0]
    imag_norm_2 = jnp.sum(imag * imag, axis=-1)
    small_imag = imag_norm_2 < EPSILON_TAYLOR_SERIES_2
    imag_norm = jnp.sqrt(jnp.where(small_imag, 1.0, imag_norm_2))

    # Branch 1: small rotation (so3.rs:85-87).
    scale_small = 2.0 / real

    # Branch 2: rotation near pi (so3.rs:88-92).
    alpha = jnp.abs(real) / imag_norm
    theta_near_pi = jnp.sign(real) * (jnp.pi - 2.0 * alpha)

    # Branch 3: exact (so3.rs:93-98).
    theta_exact = 2.0 * jnp.arctan(imag_norm / real)

    near_pi = jnp.abs(real) < EPSILON_TAYLOR_SERIES
    theta = jnp.where(near_pi, theta_near_pi, theta_exact)
    scale = jnp.where(small_imag, scale_small, theta / imag_norm)
    return scale[..., None] * imag
