"""Pose-graph optimization (loop closure back-end).

The reference explicitly defers loop closure and pose-graph optimization to
future work (reference README.md:54-55); this is the green-field
implementation: given node poses ``T_i`` and relative measurements ``Z_ij``
(odometry chains + loop-closure edges), minimize

    E = Σ_edges || log( Z_ij^-1 · T_i^-1 · T_j ) ||²_Λ

over right-multiplied twist updates ``T_i <- T_i exp(xi_i)``.

Design: residuals and their (6, 2x6) Jacobians per edge come from
forward-mode autodiff of the exact se3 residual (vmapped over a fixed-shape
edge array — autodiff through the ``jnp.where``-guarded Taylor branches is
well-defined), the normal equations are assembled with segment-sums, and the
damped 6N x 6N system is solved with Cholesky inside a ``lax.while_loop`` LM
driver.  Node 0 is gauge-fixed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..math import pose as pose_mod
from ..math import se3
from ..math.pose import Pose
from ..utils.types import Float


class PoseGraph(NamedTuple):
    """Fixed-shape pose graph.

    nodes: Pose with leading (N,).
    edge_i / edge_j: (E,) int32 endpoints.
    edge_z: Pose with leading (E,) — measured T_i^-1 T_j.
    edge_weight: (E,) f32 — information weight per edge (0 = padding).
    """

    nodes: Pose
    edge_i: jnp.ndarray
    edge_j: jnp.ndarray
    edge_z: Pose
    edge_weight: jnp.ndarray


def edge_residual(ti: Pose, tj: Pose, z: Pose) -> jnp.ndarray:
    """6-dim se3 residual of one edge: log(Z^-1 T_i^-1 T_j)."""
    rel = pose_mod.compose(pose_mod.inverse(ti), tj)
    err = pose_mod.compose(pose_mod.inverse(z), rel)
    return se3.log(err)


def residuals(graph: PoseGraph, nodes: Pose) -> jnp.ndarray:
    ti = jax.tree_util.tree_map(lambda v: v[graph.edge_i], nodes)
    tj = jax.tree_util.tree_map(lambda v: v[graph.edge_j], nodes)
    r = jax.vmap(edge_residual)(ti, tj, graph.edge_z)
    return r * jnp.sqrt(graph.edge_weight)[:, None]


def _edge_jacobians(graph: PoseGraph, nodes: Pose):
    """Per-edge residual + Jacobians wrt both endpoint twists, (E,6,6) each."""

    def r_one(xi_i, xi_j, qi, ti_, qj, tj_, zq, zt, wgt):
        ti = pose_mod.compose(Pose(qi, ti_), se3.exp(xi_i))
        tj = pose_mod.compose(Pose(qj, tj_), se3.exp(xi_j))
        return edge_residual(ti, tj, Pose(zq, zt)) * jnp.sqrt(wgt)

    zeros6 = jnp.zeros(6, Float)

    def jac_one(qi, ti_, qj, tj_, zq, zt, wgt):
        ji = jax.jacfwd(lambda xi: r_one(xi, zeros6, qi, ti_, qj, tj_, zq, zt, wgt))(zeros6)
        jj = jax.jacfwd(lambda xj: r_one(zeros6, xj, qi, ti_, qj, tj_, zq, zt, wgt))(zeros6)
        r = r_one(zeros6, zeros6, qi, ti_, qj, tj_, zq, zt, wgt)
        return ji, jj, r

    qi = nodes.q[graph.edge_i]
    ti = nodes.t[graph.edge_i]
    qj = nodes.q[graph.edge_j]
    tj = nodes.t[graph.edge_j]
    return jax.vmap(jac_one)(qi, ti, qj, tj, graph.edge_z.q, graph.edge_z.t, graph.edge_weight)


class PGOResult(NamedTuple):
    nodes: Pose
    energy: jnp.ndarray
    nb_iter: jnp.ndarray


@partial(jax.jit, static_argnames=("max_iterations",))
def solve(graph: PoseGraph, *, max_iterations: int = 20) -> PGOResult:
    """LM pose-graph optimization; node 0 gauge-fixed."""
    N = graph.nodes.q.shape[0]

    def energy_of(nodes):
        r = residuals(graph, nodes)
        return jnp.sum(r * r)

    def normal_equations(nodes):
        ji, jj, r = _edge_jacobians(graph, nodes)
        # H is (N,6,N,6) assembled from the four per-edge blocks.
        H = jnp.zeros((N, 6, N, 6), Float)
        Hii = jnp.einsum("eab,eac->ebc", ji, ji)
        Hjj = jnp.einsum("eab,eac->ebc", jj, jj)
        Hij = jnp.einsum("eab,eac->ebc", ji, jj)
        H = H.at[graph.edge_i, :, graph.edge_i, :].add(Hii)
        H = H.at[graph.edge_j, :, graph.edge_j, :].add(Hjj)
        H = H.at[graph.edge_i, :, graph.edge_j, :].add(Hij)
        H = H.at[graph.edge_j, :, graph.edge_i, :].add(jnp.swapaxes(Hij, -1, -2))
        g = jnp.zeros((N, 6), Float)
        g = g.at[graph.edge_i].add(-jnp.einsum("eab,ea->eb", ji, r))
        g = g.at[graph.edge_j].add(-jnp.einsum("eab,ea->eb", jj, r))
        return H.reshape(6 * N, 6 * N), g.reshape(6 * N)

    def body(carry):
        nodes, energy, lm, it, done = carry
        H, g = normal_equations(nodes)
        n = 6 * N
        idx = jnp.arange(n)
        free = idx >= 6  # gauge-fix node 0
        eye = jnp.eye(n, dtype=Float)
        H_damped = H * (1.0 + lm * eye) + 1e-8 * eye
        H_fixed = jnp.where(free[:, None] & free[None, :], H_damped, eye)
        g_fixed = jnp.where(free, g, 0.0)
        chol = jnp.linalg.cholesky(H_fixed)
        delta = jax.scipy.linalg.cho_solve((chol, True), g_fixed).reshape(N, 6)
        new_nodes = jax.vmap(lambda q, t, xi: pose_mod.compose(Pose(q, t), se3.exp(xi)))(
            nodes.q, nodes.t, delta
        )
        new_nodes = pose_mod.renormalize_first_order(Pose(new_nodes.q, new_nodes.t))
        new_energy = energy_of(new_nodes)
        ok = (
            jnp.isfinite(new_energy)
            & (new_energy <= energy)
            & jnp.all(jnp.isfinite(new_nodes.q))
            & jnp.all(jnp.isfinite(new_nodes.t))
        )
        nodes = jax.tree_util.tree_map(
            lambda new, old: jnp.where(ok, new, old), new_nodes, nodes
        )
        lm = jnp.where(ok, lm * 0.3, lm * 10.0)
        d_energy = energy - new_energy
        done = jnp.logical_or(
            it + 1 >= max_iterations,
            jnp.logical_and(ok, d_energy < 1e-9 * (energy + 1.0)),
        )
        energy = jnp.where(ok, new_energy, energy)
        return nodes, energy, lm, it + 1, done

    energy0 = energy_of(graph.nodes)
    nodes, energy, _, it, _ = jax.lax.while_loop(
        lambda c: ~c[-1],
        body,
        (graph.nodes, energy0, jnp.asarray(1e-6, Float), jnp.asarray(0, jnp.int32), jnp.asarray(False)),
    )
    return PGOResult(nodes=nodes, energy=energy, nb_iter=it)


def _edge_hessian_blocks(ji, jj):
    """Per-edge 6x6 Gauss-Newton blocks (Hii, Hjj, Hij)."""
    Hii = jnp.einsum("eab,eac->ebc", ji, ji)
    Hjj = jnp.einsum("eab,eac->ebc", jj, jj)
    Hij = jnp.einsum("eab,eac->ebc", ji, jj)
    return Hii, Hjj, Hij


def _block_tridiag_solve(D, U, r):
    """Solve the symmetric block-tridiagonal system M x = r.

    ``D`` (N,6,6) diagonal blocks, ``U`` (N,6,6) with ``U[i]`` the (i, i+1)
    block (``U[N-1]`` ignored/zero), ``r`` (N,6).  Block Thomas algorithm as
    two ``lax.scan`` passes — O(N) with 6x6 solves, fully jittable.  This is
    the chain-sparsity solve the dense Cholesky wastes O(N^3) on.
    """
    N = D.shape[0]
    U = U.at[N - 1].set(jnp.zeros((6, 6), Float))
    Uprev = jnp.concatenate([jnp.zeros((1, 6, 6), Float), U[:-1]], axis=0)

    def fwd(carry, inp):
        c_prev, y_prev = carry
        D_i, U_i, Up_i, r_i = inp
        denom = D_i - Up_i.T @ c_prev
        c_i = jnp.linalg.solve(denom, U_i)
        y_i = jnp.linalg.solve(denom, (r_i - Up_i.T @ y_prev)[:, None])[:, 0]
        return (c_i, y_i), (c_i, y_i)

    (_, _), (C, Y) = jax.lax.scan(
        fwd, (jnp.zeros((6, 6), Float), jnp.zeros((6,), Float)), (D, U, Uprev, r)
    )

    def bwd(x_next, inp):
        c_i, y_i = inp
        x_i = y_i - c_i @ x_next
        return x_i, x_i

    _, X = jax.lax.scan(bwd, jnp.zeros((6,), Float), (C, Y), reverse=True)
    return X


def _solve_sparse_impl(
    graph: PoseGraph,
    *,
    max_iterations: int,
    cg_iters: int,
    cg_tol: float,
    reduce,
) -> PGOResult:
    """Shared body of ``solve_sparse`` / ``solve_sparse_sharded``.

    ``reduce`` is applied to every edge-accumulated quantity (energy,
    gradient, H-diagonal, matvec output, preconditioner blocks): identity
    when the graph's edges are all local, ``psum`` when they are sharded
    over a mesh axis — the two paths compute the same numbers by
    construction (up to f32 reduction order).
    """
    N = graph.nodes.q.shape[0]
    mask = jnp.ones((N, 6), Float).at[0].set(0.0)  # gauge-fix node 0
    chain = (graph.edge_j == graph.edge_i + 1).astype(Float)

    def energy_of(nodes):
        r = residuals(graph, nodes)
        return reduce(jnp.sum(r * r))

    def step_system(nodes, lm):
        ji, jj, r = _edge_jacobians(graph, nodes)
        g = jnp.zeros((N, 6), Float)
        g = g.at[graph.edge_i].add(-jnp.einsum("eab,ea->eb", ji, r))
        g = g.at[graph.edge_j].add(-jnp.einsum("eab,ea->eb", jj, r))
        g = reduce(g) * mask
        # diagonal entries of H (for Marquardt damping + floor)
        d = jnp.zeros((N, 6), Float)
        d = d.at[graph.edge_i].add(jnp.einsum("eab,eab->eb", ji, ji))
        d = d.at[graph.edge_j].add(jnp.einsum("eab,eab->eb", jj, jj))
        damp = lm * reduce(d) + 1e-8

        def matvec(v):
            vm = v * mask
            rv = jnp.einsum("eab,eb->ea", ji, vm[graph.edge_i]) + jnp.einsum(
                "eab,eb->ea", jj, vm[graph.edge_j]
            )
            out = jnp.zeros((N, 6), Float)
            out = out.at[graph.edge_i].add(jnp.einsum("eab,ea->eb", ji, rv))
            out = out.at[graph.edge_j].add(jnp.einsum("eab,ea->eb", jj, rv))
            return mask * (reduce(out) + damp * vm) + (1.0 - mask) * v

        # chain-part preconditioner blocks
        Hii, Hjj, Hij = _edge_hessian_blocks(ji, jj)
        D = jnp.zeros((N, 6, 6), Float)
        D = D.at[graph.edge_i].add(Hii)
        D = D.at[graph.edge_j].add(Hjj)
        D = reduce(D)
        i6 = jnp.arange(6)
        D = D.at[:, i6, i6].add(damp)
        U = jnp.zeros((N, 6, 6), Float)
        U = U.at[graph.edge_i].add(Hij * chain[:, None, None])
        U = reduce(U)
        # gauge: node 0 block = identity, decoupled from node 1
        D = D.at[0].set(jnp.eye(6, dtype=Float))
        U = U.at[0].set(jnp.zeros((6, 6), Float))

        def precond(v):
            return _block_tridiag_solve(D, U, v * mask) * mask + (1.0 - mask) * v

        return matvec, precond, g

    def pcg(matvec, precond, b):
        bnorm = jnp.sqrt(jnp.sum(b * b))
        x0 = jnp.zeros_like(b)
        z0 = precond(b)
        rz0 = jnp.sum(b * z0)

        def cond(carry):
            x, r, z, p, rz, k = carry
            rnorm = jnp.sqrt(jnp.sum(r * r))
            return (k < cg_iters) & (rnorm > cg_tol * bnorm)

        def body(carry):
            x, r, z, p, rz, k = carry
            Ap = matvec(p)
            pAp = jnp.sum(p * Ap)
            alpha = jnp.where(pAp > 0.0, rz / jnp.maximum(pAp, 1e-30), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = jnp.sum(r * z)
            beta = jnp.where(rz > 0.0, rz_new / jnp.maximum(rz, 1e-30), 0.0)
            p = z + beta * p
            return x, r, z, p, rz_new, k + 1

        x, _, _, _, _, _ = jax.lax.while_loop(
            cond, body, (x0, b, z0, z0, rz0, jnp.asarray(0, jnp.int32))
        )
        return x

    def body(carry):
        nodes, energy, lm, it, done = carry
        matvec, precond, g = step_system(nodes, lm)
        delta = pcg(matvec, precond, g)
        new_nodes = jax.vmap(
            lambda q, t, xi: pose_mod.compose(Pose(q, t), se3.exp(xi))
        )(nodes.q, nodes.t, delta)
        new_nodes = pose_mod.renormalize_first_order(Pose(new_nodes.q, new_nodes.t))
        new_energy = energy_of(new_nodes)
        ok = (
            jnp.isfinite(new_energy)
            & (new_energy <= energy)
            & jnp.all(jnp.isfinite(new_nodes.q))
            & jnp.all(jnp.isfinite(new_nodes.t))
        )
        nodes = jax.tree_util.tree_map(
            lambda new, old: jnp.where(ok, new, old), new_nodes, nodes
        )
        lm = jnp.where(ok, lm * 0.3, lm * 10.0)
        d_energy = energy - new_energy
        done = jnp.logical_or(
            it + 1 >= max_iterations,
            jnp.logical_and(ok, d_energy < 1e-9 * (energy + 1.0)),
        )
        energy = jnp.where(ok, new_energy, energy)
        return nodes, energy, lm, it + 1, done

    energy0 = energy_of(graph.nodes)
    nodes, energy, _, it, _ = jax.lax.while_loop(
        lambda c: ~c[-1],
        body,
        (graph.nodes, energy0, jnp.asarray(1e-6, Float),
         jnp.asarray(0, jnp.int32), jnp.asarray(False)),
    )
    return PGOResult(nodes=nodes, energy=energy, nb_iter=it)


@partial(jax.jit, static_argnames=("max_iterations", "cg_iters"))
def solve_sparse(
    graph: PoseGraph,
    *,
    max_iterations: int = 20,
    cg_iters: int = 100,
    cg_tol: float = 1e-7,
) -> PGOResult:
    """LM pose-graph optimization exploiting chain+loop sparsity.

    The dense ``solve`` assembles and Cholesky-factors the full 6N x 6N
    system — O(N³), a wall at hundreds of keyframes.  A SLAM graph is a
    chain plus a few loop edges, so here each LM step solves the damped
    normal equations with **preconditioned conjugate gradients**:

    - the matrix is never materialized — ``H v`` is an O(E) edge-wise pass
      (two 6x6 matvecs per edge + segment-sum scatter);
    - the preconditioner is the exact **block-tridiagonal chain part**
      (damped diagonal + consecutive-edge couplings), solved O(N) by block
      Thomas (``_block_tridiag_solve``);
    - loop edges are a low-rank perturbation of the chain, so PCG converges
      in ~O(#loops) iterations regardless of N.

    Same gauge (node 0 fixed), damping, and accept/reject semantics as
    ``solve``; results match the dense solve to CG tolerance.  O(N + E) per
    iteration, scaling to thousands of nodes.
    """
    return _solve_sparse_impl(
        graph, max_iterations=max_iterations, cg_iters=cg_iters,
        cg_tol=cg_tol, reduce=lambda x: x,
    )


def solve_sparse_sharded(
    graph: PoseGraph,
    mesh,
    axis: str = "graph",
    *,
    max_iterations: int = 20,
    cg_iters: int = 100,
    cg_tol: float = 1e-7,
) -> PGOResult:
    """``solve_sparse`` with the EDGE axis sharded over ``mesh[axis]``.

    The O(E) work per LM step (forward-mode edge Jacobians, the PCG
    edge-wise matvec, preconditioner block assembly) runs on local edge
    shards; node-space vectors stay replicated (6N floats per node — tiny)
    and every edge accumulation reduces with one ``psum``.  This is the
    distribution layout for pose-graph optimization at fleet scale (SURVEY
    §5): edges partition by trajectory segment, the psum rides the mesh.  Results match ``solve_sparse`` up to f32
    reduction order.

    Edges are padded to a multiple of the mesh axis with weight-0 self
    edges, which contribute exactly zero to every accumulated quantity.
    """
    from jax.sharding import PartitionSpec as P

    ndev = mesh.shape[axis]
    E = graph.edge_i.shape[0]
    pad = (-E) % ndev
    if pad:
        ident_q = jnp.tile(
            jnp.asarray([1.0, 0.0, 0.0, 0.0], Float)[None], (pad, 1)
        )
        graph = PoseGraph(
            nodes=graph.nodes,
            edge_i=jnp.concatenate([graph.edge_i, jnp.zeros(pad, jnp.int32)]),
            edge_j=jnp.concatenate([graph.edge_j, jnp.zeros(pad, jnp.int32)]),
            edge_z=Pose(
                jnp.concatenate([graph.edge_z.q, ident_q]),
                jnp.concatenate([graph.edge_z.t, jnp.zeros((pad, 3), Float)]),
            ),
            edge_weight=jnp.concatenate(
                [graph.edge_weight, jnp.zeros(pad, Float)]
            ),
        )

    graph_spec = PoseGraph(
        nodes=Pose(q=P(), t=P()),
        edge_i=P(axis),
        edge_j=P(axis),
        edge_z=Pose(q=P(axis), t=P(axis)),
        edge_weight=P(axis),
    )
    out_spec = PGOResult(nodes=Pose(q=P(), t=P()), energy=P(), nb_iter=P())
    fn = jax.shard_map(
        lambda g: _solve_sparse_impl(
            g, max_iterations=max_iterations, cg_iters=cg_iters,
            cg_tol=cg_tol, reduce=lambda x: jax.lax.psum(x, axis),
        ),
        mesh=mesh,
        in_specs=(graph_spec,),
        out_specs=out_spec,
    )
    return fn(graph)


def odometry_graph(nodes: Pose, loop_edges=(), noise_weight: float = 1.0) -> PoseGraph:
    """Build a chain pose graph from a trajectory plus optional loop edges.

    ``loop_edges`` is an iterable of ``(i, j, Pose)`` measured relative
    motions; trailing extras per edge are ignored, so
    ``models.loop_closure.detect_loops`` output (``(i, j, Z, energy)``)
    feeds in directly.

    CAVEAT: chain measurements are taken from the consecutive node
    *estimates*, so every chain edge has zero residual at initialization —
    all correction signal comes from the loop edges, which the optimizer
    distributes around the loop.  This is the right structure when the
    estimates ARE the odometry (the usual case); if you have independent
    odometry measurements with their own noise, build the ``PoseGraph``
    directly with those as ``edge_z`` instead.
    """
    N = nodes.q.shape[0]
    ii = [i for i in range(N - 1)]
    jj = [i + 1 for i in range(N - 1)]
    zq, zt, ww = [], [], []
    for i in range(N - 1):
        ti = Pose(nodes.q[i], nodes.t[i])
        tj = Pose(nodes.q[i + 1], nodes.t[i + 1])
        z = pose_mod.compose(pose_mod.inverse(ti), tj)
        zq.append(z.q)
        zt.append(z.t)
        ww.append(noise_weight)
    for edge in loop_edges:
        i, j, z = edge[0], edge[1], edge[2]
        ii.append(i)
        jj.append(j)
        zq.append(z.q)
        zt.append(z.t)
        ww.append(noise_weight)
    return PoseGraph(
        nodes=nodes,
        edge_i=jnp.asarray(ii, jnp.int32),
        edge_j=jnp.asarray(jj, jnp.int32),
        edge_z=Pose(jnp.stack(zq), jnp.stack(zt)),
        edge_weight=jnp.asarray(ww, Float),
    )
