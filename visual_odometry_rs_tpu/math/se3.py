"""Lie algebra/group functions for 3D rigid-body motion (se3 / SE3), pure JAX.

Capability parity with reference ``src/math/se3.rs``: ``hat``, ``vee``,
``exp`` (twist → Pose) and ``log`` (Pose → twist) with the same Taylor-series
structure below ``theta^2 < (1e-2)^2`` (ref se3.rs:19-27).

Twist layout matches the reference (se3.rs:30-40): ``xi = [v, w]`` with the
linear velocity ``v = xi[0:3]`` first and the angular velocity ``w = xi[3:6]``
second.

Design notes: both Taylor and exact branches are always evaluated and
selected with ``jnp.where`` (they are a handful of FLOPs), keeping the
functions jit/vmap-safe with static shapes, and they broadcast over arbitrary
leading batch axes.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.types import Float
from . import so3
from .pose import Pose, quat_normalize

EPSILON_TAYLOR_SERIES = 1e-2
EPSILON_TAYLOR_SERIES_2 = EPSILON_TAYLOR_SERIES * EPSILON_TAYLOR_SERIES


def linear_velocity(xi: jnp.ndarray) -> jnp.ndarray:
    return xi[..., 0:3]


def angular_velocity(xi: jnp.ndarray) -> jnp.ndarray:
    return xi[..., 3:6]


def hat(xi: jnp.ndarray) -> jnp.ndarray:
    """Twist (…,6) → se3 element (…,4,4). Ref se3.rs:45-55."""
    v = linear_velocity(xi)
    w = angular_velocity(xi)
    top = jnp.concatenate([so3.hat(w), v[..., :, None]], axis=-1)
    bottom = jnp.zeros((*xi.shape[:-1], 1, 4), dtype=xi.dtype)
    return jnp.concatenate([top, bottom], axis=-2)


def vee(mat: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat (no skew-symmetry check). Ref se3.rs:59-61."""
    return jnp.stack(
        [
            mat[..., 0, 3], mat[..., 1, 3], mat[..., 2, 3],
            mat[..., 2, 1], mat[..., 0, 2], mat[..., 1, 0],
        ],
        axis=-1,
    )


def adjoint(p: Pose) -> jnp.ndarray:
    """Adjoint of a rigid motion: the (…, 6, 6) matrix with
    ``exp(adjoint(p) @ xi) = p ∘ exp(xi) ∘ p⁻¹``.

    For the ``xi = [v, w]`` twist layout (se3.rs:30-40):
    ``Adj = [[R, hat(t)·R], [0, R]]``.  Green-field (no reference
    counterpart): used to transport marginalization priors to a new keyframe
    frame in ``models.sliding_window``.
    """
    from .pose import rotation_matrix

    R = rotation_matrix(p.q)
    txR = jnp.matmul(so3.hat(p.t), R)
    top = jnp.concatenate([R, txR], axis=-1)
    bot = jnp.concatenate([jnp.zeros_like(R), R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _eye3(batch_shape, dtype):
    return jnp.broadcast_to(jnp.eye(3, dtype=dtype), (*batch_shape, 3, 3))


def exp(xi: jnp.ndarray) -> Pose:
    """Exponential map se3 → SE3. Ref se3.rs:65-95.

    Rotation: quaternion ``(real_factor, imag_factor * w)`` then normalized
    (nalgebra ``UnitQuaternion::from_quaternion`` renormalizes).
    Translation: ``V xi_v`` with ``V = I + c1 hat(w) + c2 hat(w)^2``.
    """
    xi = jnp.asarray(xi, dtype=Float)
    xi_v = linear_velocity(xi)
    xi_w = angular_velocity(xi)
    theta_2 = jnp.sum(xi_w * xi_w, axis=-1)
    use_taylor = theta_2 < EPSILON_TAYLOR_SERIES_2

    omega = so3.hat(xi_w)
    omega_2 = so3.hat_2(xi_w)

    # Taylor branch coefficients (se3.rs:71-74).
    real_t = 1.0 - 0.125 * theta_2
    imag_t = 0.5 - (1.0 / 48.0) * theta_2
    c_omega_t = 0.5 - (1.0 / 24.0) * theta_2
    c_omega2_t = (1.0 / 6.0) - (1.0 / 120.0) * theta_2

    # Exact branch (se3.rs:82-88), guarded for theta → 0 gradients.
    theta = jnp.sqrt(jnp.where(use_taylor, 1.0, theta_2))
    half_theta = 0.5 * theta
    real_e = jnp.cos(half_theta)
    imag_e = jnp.sin(half_theta) / theta
    c_omega_e = (1.0 - jnp.cos(theta)) / jnp.where(use_taylor, 1.0, theta_2)
    c_omega2_e = (theta - jnp.sin(theta)) / jnp.where(use_taylor, 1.0, theta * theta_2)

    real = jnp.where(use_taylor, real_t, real_e)
    imag = jnp.where(use_taylor, imag_t, imag_e)
    c_omega = jnp.where(use_taylor, c_omega_t, c_omega_e)
    c_omega2 = jnp.where(use_taylor, c_omega2_t, c_omega2_e)

    v_mat = (
        _eye3(theta_2.shape, xi.dtype)
        + c_omega[..., None, None] * omega
        + c_omega2[..., None, None] * omega_2
    )
    q = quat_normalize(jnp.concatenate([real[..., None], imag[..., None] * xi_w], axis=-1))
    t = jnp.einsum("...ij,...j->...i", v_mat, xi_v)
    return Pose(q, t)


def log(p: Pose) -> jnp.ndarray:
    """Logarithm map SE3 → se3. Ref se3.rs:99-129."""
    q = jnp.asarray(p.q, dtype=Float)
    t = jnp.asarray(p.t, dtype=Float)
    imag = q[..., 1:]
    real = q[..., 0]
    imag_norm_2 = jnp.sum(imag * imag, axis=-1)
    small_imag = imag_norm_2 < EPSILON_TAYLOR_SERIES_2
    imag_norm = jnp.sqrt(jnp.where(small_imag, 1.0, imag_norm_2))

    # --- angular part ---------------------------------------------------
    # Taylor branch (se3.rs:104-105).
    scale_small = 2.0 / real
    # Near-pi branch (se3.rs:114-116).
    alpha = jnp.abs(real) / imag_norm
    theta_near_pi = jnp.sign(real) * (jnp.pi - 2.0 * alpha)
    # Exact branch (se3.rs:119).
    theta_exact = 2.0 * jnp.arctan(imag_norm / real)
    near_pi = jnp.abs(real) < EPSILON_TAYLOR_SERIES
    theta = jnp.where(near_pi, theta_near_pi, theta_exact)
    w_scale = jnp.where(small_imag, scale_small, theta / imag_norm)
    w = w_scale[..., None] * imag

    omega = so3.hat(w)
    omega_2 = so3.hat_2(w)

    # --- V^{-1} coefficient ---------------------------------------------
    # Taylor branch (se3.rs:107-108): x_2 = |v|^2 / w^2.
    x_2 = imag_norm_2 / (real * real)
    c2_taylor = (1.0 / 12.0) * (1.0 + (1.0 / 15.0) * x_2)
    # Exact branch (se3.rs:121-124).
    theta_2 = theta * theta
    c2_exact = (1.0 - 0.5 * theta * real / imag_norm) / jnp.where(small_imag, 1.0, theta_2)
    c_omega2 = jnp.where(small_imag, c2_taylor, c2_exact)

    v_inv = (
        _eye3(real.shape, q.dtype)
        - 0.5 * omega
        + c_omega2[..., None, None] * omega_2
    )
    xi_v = jnp.einsum("...ij,...j->...i", v_inv, t)
    return jnp.concatenate([xi_v, w], axis=-1)
