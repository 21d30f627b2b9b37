"""Generic jittable iterative-optimizer harness.

The reference defines an abstract iterative-solver protocol
(``src/math/optimizer.rs:32-71``): a ``State`` with four hooks —
``init / step / eval / stop_criterion`` — plus a provided driver loop
``iterative_solve``.  It is instantiated four times in the reference
(se3 tracking, 2D affine alignment, Rosenbrock, 1D regression).

This module is the JAX analog: the same four-hook decomposition, but
as pure functions driven by ``lax.while_loop`` so a whole solve jits into a
single XLA computation (no host round-trips per iteration).  The carry is an
arbitrary pytree chosen by the instantiation.

Protocol (all pure, all jittable):

- ``init(obs, model) -> state``           (pytree)
- ``step(state) -> new_model``            may signal failure via non-finite
                                          values; the driver stops and raises
                                          the ``failed`` flag in that case
                                          (graceful degradation — the analog
                                          of the reference's ``Result`` error)
- ``eval(obs, state, new_model) -> eval_out``   anything the stopper needs
- ``stop_criterion(state, nb_iter, eval_out) -> (state, continue?)``

``iterative_solve`` composes them. ``nb_iter`` starts at 1 on the first
iteration, matching the reference driver (optimizer.rs:57-70).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp


class SolveResult(NamedTuple):
    state: Any
    nb_iter: jnp.ndarray  # int32
    failed: jnp.ndarray  # bool: a step() produced non-finite model values


def _all_finite(tree) -> jnp.ndarray:
    leaves = jax.tree_util.tree_leaves(tree)
    ok = jnp.asarray(True)
    for leaf in leaves:
        if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating):
            ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(leaf)))
    return ok


def iterative_solve(
    obs: Any,
    initial_model: Any,
    *,
    init: Callable[[Any, Any], Any],
    step: Callable[[Any], Any],
    eval_fn: Callable[[Any, Any, Any], Any],
    stop_criterion: Callable[[Any, jnp.ndarray, Any], Tuple[Any, jnp.ndarray]],
    max_iterations: int = 100,
) -> SolveResult:
    """Run the iterative solver to convergence inside a ``lax.while_loop``.

    ``max_iterations`` is a hard static bound for the while loop on top of
    whatever ``stop_criterion`` decides (instantiations usually stop earlier).
    The driver mirrors ref optimizer.rs:57-70: each iteration computes a step,
    evaluates it, and lets ``stop_criterion`` both update the state and decide
    continuation.  A step producing non-finite values (e.g. a failed Cholesky
    factorization, which in JAX yields NaNs rather than an error) stops the
    loop with ``failed=True`` and leaves the state untouched, like the
    reference's error propagation (lm_optimizer.rs:131-133 caught at
    inverse_compositional.rs:195-199).
    """
    state0 = init(obs, initial_model)

    def cond(carry):
        _, nb_iter, stop, failed = carry
        return jnp.logical_and(~stop, jnp.logical_and(~failed, nb_iter < max_iterations))

    def body(carry):
        state, nb_iter, _, _ = carry
        nb_iter = nb_iter + 1
        new_model = step(state)
        step_ok = _all_finite(new_model)

        def on_ok(state):
            eval_out = eval_fn(obs, state, new_model)
            new_state, cont = stop_criterion(state, nb_iter, eval_out)
            return new_state, ~cont, jnp.asarray(False)

        def on_fail(state):
            return state, jnp.asarray(True), jnp.asarray(True)

        state, stop, failed = jax.lax.cond(step_ok, on_ok, on_fail, state)
        return state, nb_iter, stop, failed

    state, nb_iter, _, failed = jax.lax.while_loop(
        cond,
        body,
        (state0, jnp.asarray(0, jnp.int32), jnp.asarray(False), jnp.asarray(False)),
    )
    return SolveResult(state=state, nb_iter=nb_iter, failed=failed)


# ---------------------------------------------------------------------------
# Reusable Levenberg-Marquardt building blocks
# ---------------------------------------------------------------------------


class LMState(NamedTuple):
    """Accepted LM state: model + quadratic approximation at that model.

    The analog of the reference's ``LMOptimizerState`` + ``EvalData``
    (lm_optimizer.rs:16-40): ``lm_coef`` is the damping coefficient, and
    (energy, gradient, hessian) always describe the last *accepted* model.
    """

    model: Any
    energy: jnp.ndarray
    gradient: jnp.ndarray  # (n,)
    hessian: jnp.ndarray  # (n, n)
    lm_coef: jnp.ndarray


def damped_solve(hessian: jnp.ndarray, gradient: jnp.ndarray, lm_coef) -> jnp.ndarray:
    """Solve ``(H with diag * (1+lm)) delta = g`` by Cholesky.

    Mirrors the reference's step (lm_optimizer.rs:123-134): only the diagonal
    is scaled by ``1 + lm_coef`` (Marquardt scaling, not additive damping).
    A non-positive-definite system yields NaNs (JAX's Cholesky does not
    raise), which callers detect via non-finite outputs.
    """
    n = hessian.shape[-1]
    eye = jnp.eye(n, dtype=hessian.dtype)
    damped = hessian * (1.0 + lm_coef * eye)
    chol = jnp.linalg.cholesky(damped)
    delta = jax.scipy.linalg.cho_solve((chol, True), gradient)
    return delta


def lm_update(
    state: LMState,
    nb_iter: jnp.ndarray,
    new_model: Any,
    new_energy: jnp.ndarray,
    new_gradient: jnp.ndarray,
    new_hessian: jnp.ndarray,
    *,
    max_iterations: int,
    energy_tol: float,
) -> Tuple[LMState, jnp.ndarray]:
    """Shared accept/reject + λ-schedule logic of all reference LM instances.

    - energy increased (strictly): reject, ``λ *= 10``, continue
      (lm_optimizer.rs:170-174)
    - energy decreased or equal (or NaN, which Rust's ``>`` also sends to the
      accept path): accept, ``λ *= 0.1``, continue iff
      ``old_energy - new_energy > energy_tol`` (lm_optimizer.rs:176-189)
    - too many iterations (``nb_iter > max_iterations``): stop either way
      (lm_optimizer.rs:157-167)

    Returns ``(state, continue?)``.
    """
    rejected = new_energy > state.energy  # NaN compares False → accepted, like Rust
    d_energy = state.energy - new_energy

    accepted_state = LMState(
        model=new_model,
        energy=new_energy,
        gradient=new_gradient,
        hessian=new_hessian,
        lm_coef=state.lm_coef * 0.1,
    )
    rejected_state = state._replace(lm_coef=state.lm_coef * 10.0)

    new_state = jax.tree_util.tree_map(
        lambda a, r: jnp.where(rejected, r, a), accepted_state, rejected_state
    )
    too_many = nb_iter > max_iterations
    cont = jnp.where(
        rejected,
        ~too_many,
        jnp.logical_and(~too_many, d_energy > energy_tol),
    )
    return new_state, cont
