"""Candidate-point-sharded LM solve (the tensor-parallel analog for VO).

The per-iteration work of the tracker's LM solve is a masked reduction over
candidate points: ``g = Jᵀ(r·m)``, ``H = (J·m)ᵀJ``, ``E = Σ r²/Σ m``
(SURVEY §2.3: "shard the candidate-point dimension of residual/Jacobian
reductions across chips; 6x6 solve replicated").  This module shards the
candidate axis over a mesh axis with ``shard_map``: each chip warps and
samples its own slice of points against a replicated image level, reduces
locally, and a single 45-float ``psum`` per LM iteration
(6x7 matrix + energy + count) crosses the devices.  The damped 6x6 Cholesky solve
is then computed redundantly on every chip — cheaper than communicating it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import camera as camera_mod
from ..math import pose as pose_mod
from ..math import se3
from ..math.optimizer import LMState, damped_solve, iterative_solve, lm_update
from ..math.pose import Pose
from ..models.tracker import LevelObs
from ..ops import interp
from ..utils.types import Float


def _local_partials(obs: LevelObs, image: jnp.ndarray, model: Pose, method: str):
    """Per-shard partial sums: (6x7 JᵀJ|Jᵀr block, Σr², Σ inside)."""
    u, v = camera_mod.warp(model, obs.xs, obs.ys, obs.idepth, obs.intrinsics)
    vals, in_img = interp.bilinear(image, u, v, method)
    inside = jnp.logical_and(in_img, obs.valid)
    r = jnp.where(inside, vals - obs.tmpl_vals, 0.0)
    maskf = inside.astype(Float)
    jm = obs.jacobians * maskf[:, None]
    rhs = jnp.concatenate([obs.jacobians, r[:, None]], axis=1)
    m = jnp.matmul(jm.T, rhs, precision=jax.lax.Precision.HIGHEST)  # (6, 7)
    return m, jnp.sum(r * r), jnp.sum(maskf)


def solve_level_point_sharded(
    obs: LevelObs,
    image: jnp.ndarray,
    model0: Pose,
    mesh: Mesh,
    axis: str = "points",
    *,
    lm_coef_init: float = 0.1,
    max_iterations: int = 20,
    energy_tol: float = 1.0,
    interp_method: str = "auto",
):
    """LM solve of one level with candidates sharded over ``mesh[axis]``.

    Numerically equivalent to ``models.tracker.solve_level`` up to f32
    summation order.  The while_loop runs in lockstep on every shard (model,
    λ and energy are replicated by the psum), so control flow is uniform.
    """

    def sharded_solve(obs_local: LevelObs, image_rep, model0_rep):
        def eval_full(model):
            m, rsq, cnt = _local_partials(obs_local, image_rep, model, interp_method)
            m = jax.lax.psum(m, axis)
            rsq = jax.lax.psum(rsq, axis)
            cnt = jax.lax.psum(cnt, axis)
            energy = rsq / cnt
            return energy, m[:, 6], m[:, :6]

        def init(_, model):
            energy, grad, hess = eval_full(model)
            return LMState(model, energy, grad, hess, jnp.asarray(lm_coef_init, Float))

        def step(state):
            delta = damped_solve(state.hessian, state.gradient, state.lm_coef)
            return pose_mod.renormalize_first_order(
                pose_mod.compose(state.model, pose_mod.inverse(se3.exp(delta)))
            )

        def eval_fn(_, state, new_model):
            energy, grad, hess = eval_full(new_model)
            return (new_model, energy, grad, hess)

        def stop(state, nb_iter, eval_out):
            new_model, energy, grad, hess = eval_out
            return lm_update(
                state, nb_iter, new_model, energy, grad, hess,
                max_iterations=max_iterations, energy_tol=energy_tol,
            )

        result = iterative_solve(
            None, model0_rep,
            init=init, step=step, eval_fn=eval_fn, stop_criterion=stop,
            max_iterations=max_iterations + 3,
        )
        return result.state.model, result.failed, result.nb_iter

    cand_spec = LevelObs(
        intrinsics=jax.tree_util.tree_map(lambda _: P(), obs.intrinsics),
        template=P(),
        xs=P(axis), ys=P(axis), idepth=P(axis), valid=P(axis),
        tmpl_vals=P(axis), jacobians=P(axis, None),
    )
    model_spec = Pose(q=P(), t=P())

    fn = jax.shard_map(
        sharded_solve,
        mesh=mesh,
        in_specs=(cand_spec, P(), model_spec),
        out_specs=(model_spec, P(), P()),
    )
    return fn(obs, image, model0)
