"""Pyramidal inverse-compositional 2D affine image alignment.

Capability parity with reference ``examples/optim_affine-2d.rs``: estimate the
6-parameter affine warp between a template and an image by coarse-to-fine
Lucas-Kanade in the inverse-compositional formulation, minimized with
Levenberg-Marquardt.

Warp parameterization (affine-2d.rs:344-366)::

    W(p) = [ 1+p1  p3  p5 ]      (u, v) = W(p) @ (x, y, 1)
           [  p2  1+p4 p6 ]

Per-pixel Jacobians ``[x gx, x gy, y gx, y gy, gx, gy]`` (affine-2d.rs:408-429,
"CF Baker and Matthews"), precomputed once on the template.  Each LM step
composes ``W_old @ W(delta)^-1`` (affine-2d.rs:166-179).  Between pyramid
levels the translation components are doubled (affine-2d.rs:61-64).

Design: the template is dense (all pixels are candidates), so the
residual pass is one bilinear sample over a fixed (H*W) point grid, and the
gradient/Hessian reduction is a single fused (6+1)-column matmul.
The entire multi-level solve jits into one XLA computation.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..math.optimizer import LMState, damped_solve, iterative_solve, lm_update
from ..ops import gradient as gradient_ops
from ..ops import interp
from ..ops import pyramid as pyramid_ops
from ..utils.types import Float


class LevelData(NamedTuple):
    """Per-level precomputed observation data."""

    template_vals: jnp.ndarray  # (N,) f32 template intensities
    xs: jnp.ndarray  # (N,) f32 pixel x (column) coords
    ys: jnp.ndarray  # (N,) f32 pixel y (row) coords
    jacobians: jnp.ndarray  # (N, 6) f32
    image: jnp.ndarray  # (H, W) u8 target image


def warp_points(params: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Apply the affine warp to pixel coordinates (affine-2d.rs:337-342)."""
    u = (1.0 + params[0]) * x + params[2] * y + params[4]
    v = params[1] * x + (1.0 + params[3]) * y + params[5]
    return u, v


def warp_matrix(params: jnp.ndarray) -> jnp.ndarray:
    """Params → 3x3 affine matrix (affine-2d.rs:349-355)."""
    p = params
    return jnp.array(
        [
            [1.0 + p[0], p[2], p[4]],
            [p[1], 1.0 + p[3], p[5]],
            [0.0, 0.0, 1.0],
        ],
        dtype=Float,
    )


def warp_params(mat: jnp.ndarray) -> jnp.ndarray:
    """3x3 affine matrix → params (affine-2d.rs:357-366)."""
    return jnp.stack(
        [
            mat[0, 0] - 1.0,
            mat[1, 0],
            mat[0, 1],
            mat[1, 1] - 1.0,
            mat[0, 2],
            mat[1, 2],
        ]
    )


def affine_jacobians(gx: jnp.ndarray, gy: jnp.ndarray) -> jnp.ndarray:
    """Dense per-pixel Jacobians [x gx, x gy, y gx, y gy, gx, gy] (N, 6)."""
    h, w = gx.shape
    ys = jax.lax.broadcasted_iota(Float, (h, w), 0)
    xs = jax.lax.broadcasted_iota(Float, (h, w), 1)
    gxf = gx.astype(Float)
    gyf = gy.astype(Float)
    jac = jnp.stack(
        [xs * gxf, xs * gyf, ys * gxf, ys * gyf, gxf, gyf], axis=-1
    )
    return jac.reshape(h * w, 6)


def precompute_level(template: jnp.ndarray, image: jnp.ndarray) -> LevelData:
    gx, gy = gradient_ops.centered(template)
    h, w = template.shape
    ys = jax.lax.broadcasted_iota(Float, (h, w), 0).reshape(-1)
    xs = jax.lax.broadcasted_iota(Float, (h, w), 1).reshape(-1)
    return LevelData(
        template_vals=template.astype(Float).reshape(-1),
        xs=xs,
        ys=ys,
        jacobians=affine_jacobians(gx, gy),
        image=image,
    )


def _eval_energy(obs: LevelData, params: jnp.ndarray):
    """Masked residual pass: energy = Σ r² / #inside (affine-2d.rs:106-132)."""
    u, v = warp_points(params, obs.xs, obs.ys)
    vals, mask = interp.bilinear_gather(obs.image, u, v)
    r = jnp.where(mask, vals - obs.template_vals, 0.0)
    count = jnp.sum(mask)
    energy = jnp.sum(r * r) / count.astype(Float)
    return energy, r, mask


def _eval_full(obs: LevelData, params: jnp.ndarray):
    """Energy + gradient + Gauss-Newton Hessian in one fused reduction.

    ``g = Jᵀ (r ⊙ m)`` and ``H = (J ⊙ m)ᵀ J`` computed as a single
    (6, N) x (N, 7) matmul — the matmul form of the reference's per-point
    accumulation loop (affine-2d.rs:135-152).
    """
    energy, r, mask = _eval_energy(obs, params)
    maskf = mask.astype(Float)
    jm = obs.jacobians * maskf[:, None]
    rhs = jnp.concatenate([obs.jacobians, r[:, None]], axis=1)  # (N, 7)
    m = jnp.matmul(jm.T, rhs, precision=jax.lax.Precision.HIGHEST)  # (6, 7)
    hessian = m[:, :6]
    grad = m[:, 6]
    return energy, grad, hessian


def solve_level(
    obs: LevelData,
    params0: jnp.ndarray,
    *,
    max_iterations: int = 19,
    energy_tol: float = 0.01,
):
    """LM solve of one pyramid level (affine-2d.rs:155-227).

    The reference example stops at ``nb_iter >= 20`` (i.e. after iteration
    19's check lets iteration 20 run) and ``d_energy <= 0.01``.
    """

    def init(obs, params):
        energy, grad, hess = _eval_full(obs, params)
        return LMState(params, energy, grad, hess, jnp.asarray(0.1, Float))

    def step(state):
        delta = damped_solve(state.hessian, state.gradient, state.lm_coef)
        new_mat = warp_matrix(state.model) @ jnp.linalg.inv(warp_matrix(delta))
        return warp_params(new_mat)

    def eval_fn(obs, state, new_params):
        energy, grad, hess = _eval_full(obs, new_params)
        return (new_params, energy, grad, hess)

    def stop(state, nb_iter, eval_out):
        new_params, energy, grad, hess = eval_out
        return lm_update(
            state, nb_iter, new_params, energy, grad, hess,
            max_iterations=max_iterations, energy_tol=energy_tol,
        )

    return iterative_solve(
        obs, params0,
        init=init, step=step, eval_fn=eval_fn, stop_criterion=stop,
        max_iterations=max_iterations + 3,
    )


def default_nb_levels(height: int, width: int, target_coarse_pixels: int = 200) -> int:
    """``max(1, round(1 + log4(npixels / target)))`` (affine-2d.rs:49-52)."""
    import math

    return max(1, round(1.0 + math.log(height * width / target_coarse_pixels, 4.0)))


def random_template(img, seed: int = 0):
    """Extract a random affine-warped template from an image (host-side numpy).

    Re-creates the reference's template generation (affine-2d.rs:256-335):
    random scaling in [0.7, 0.8), a rotation bounded so the template stays
    inside the image, and a translation keeping all warped corners in-bounds.
    Unlike the reference (which uses ``thread_rng``, affine-2d.rs:259), this
    is seeded and deterministic.

    Returns ``(template u8 array, affine 2x3 ground-truth matrix)`` where
    ``template(i, j) = img(affine @ (j, i, 1))`` via bilinear sampling.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.asarray(img)
    rows, cols = img.shape
    s_r = rng.uniform(0.7, 0.8)
    s_c = rng.uniform(0.7, 0.8)
    tmp_rows = np.floor(s_r * rows)
    tmp_cols = np.floor(s_c * cols)

    # max rotation keeping the inner rectangle inside (affine-2d.rs:317-335)
    threshold = np.pi / 8
    inner_diag = np.hypot(tmp_rows, tmp_cols)
    ri, ci = rows - 2.0, cols - 2.0
    if inner_diag > ri:
        threshold = min(threshold, np.arcsin(ri / inner_diag) - np.arcsin(tmp_rows / inner_diag))
    if inner_diag > ci:
        threshold = min(threshold, np.arcsin(ci / inner_diag) - np.arcsin(tmp_cols / inner_diag))
    angle = rng.uniform(-threshold, threshold)

    m = np.array(
        [
            [s_c * np.cos(angle), -s_r * np.sin(angle)],
            [s_c * np.sin(angle), s_r * np.cos(angle)],
        ]
    )
    corners = np.array(
        [[0.0, cols - 1.0, cols - 1.0, 0.0], [0.0, 0.0, rows - 1.0, rows - 1.0]]
    )
    t_corners = m @ corners
    col_min, col_max = t_corners[0].min(), t_corners[0].max()
    row_min, row_max = t_corners[1].min(), t_corners[1].max()
    t_cols = rng.uniform(-col_min, max(-col_min + 1e-6, cols - 1.0 - col_max))
    t_rows = rng.uniform(-row_min, max(-row_min + 1e-6, rows - 1.0 - row_max))
    affine = np.array(
        [[m[0, 0], m[0, 1], t_cols], [m[1, 0], m[1, 1], t_rows]], dtype=np.float32
    )

    # bilinear-sample the template (all points in-bounds by construction)
    jj, ii = np.meshgrid(np.arange(cols), np.arange(rows))
    pts = affine @ np.stack([jj.ravel(), ii.ravel(), np.ones(ii.size)])
    x, y = pts[0], pts[1]
    u0 = np.floor(x).astype(int)
    v0 = np.floor(y).astype(int)
    u0c = np.clip(u0, 0, cols - 2)
    v0c = np.clip(v0, 0, rows - 2)
    a = x - u0
    b = y - v0
    imf = img.astype(np.float64)
    val = (
        (1 - b) * (1 - a) * imf[v0c, u0c]
        + b * (1 - a) * imf[v0c + 1, u0c]
        + (1 - b) * a * imf[v0c, u0c + 1]
        + b * a * imf[v0c + 1, u0c + 1]
    )
    template = val.reshape(rows, cols).astype(np.uint8)
    return template, affine


@partial(jax.jit, static_argnames=("nb_levels",))
def align(
    template: jnp.ndarray, image: jnp.ndarray, nb_levels: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full pyramidal alignment: returns (params, failed).

    Coarse-to-fine over ``nb_levels`` with translation doubling between
    levels (affine-2d.rs:59-73). Jits into a single XLA computation.
    """
    t_pyr = pyramid_ops.mean_pyramid(nb_levels, template)
    i_pyr = pyramid_ops.mean_pyramid(nb_levels, image)
    levels: List[LevelData] = [
        precompute_level(t, i) for t, i in zip(t_pyr, i_pyr)
    ]
    params = jnp.zeros(6, Float)
    failed = jnp.asarray(False)
    for lvl in reversed(range(len(levels))):
        params = params.at[4].multiply(2.0).at[5].multiply(2.0)
        result = solve_level(levels[lvl], params)
        params = result.state.model
        failed = jnp.logical_or(failed, result.failed)
    return params, failed
