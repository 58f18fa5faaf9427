"""Sim3 pose-graph optimization (essential graph).

JAX-native replacement for ``Optimizer::OptimizeEssentialGraph``
(reference src/Optimizer.cc:1501-1783): after a loop closure, keyframe
poses are optimized as Sim3 vertices over an edge set of loop connections,
spanning-tree edges, existing loop/merge edges, and strong covisibility
edges; map points are then corrected via their reference keyframe's
before/after transform.

Design: edges are a flat array; per-edge residuals
``r = log(S_ij * S_j * S_i^-1)`` and their 7x7 tangent jacobians come from
one batched forward-mode autodiff; the Gauss-Newton normal system is
assembled with segment-sums into dense [7K, 7K] and solved by Cholesky —
for SLAM-scale K (<= a few thousand) a dense solve beats any sparse
factorization, and it shards over the mesh with psum just like ba.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mam3slam_tpu.geometry import lie

# the dense normal equations feed a Cholesky: keep their products in full
# float32 (a TF32 product keeps about three decimal digits)
_HI = jax.lax.Precision.HIGHEST


class PGOEdges(NamedTuple):
    """Relative Sim3 measurements m on edge (i, j) with the convention
    S_j = m * S_i (m = S_jw * S_iw^-1 at consistency):
    residual is log(m * S_iw * S_jw^-1) = 0 when satisfied."""

    i: jnp.ndarray       # [E] i32
    j: jnp.ndarray       # [E] i32
    q: jnp.ndarray       # [E, 4] measured S_ij rotation
    t: jnp.ndarray       # [E, 3]
    s: jnp.ndarray       # [E]
    w: jnp.ndarray       # [E] information weight
    valid: jnp.ndarray   # [E] bool


def edge_residual(q_i, t_i, s_i, q_j, t_j, s_j, q_m, t_m, s_m):
    """log(S_m * S_i * S_j^{-1}) in R^7, batched (zero when S_j = m S_i)."""
    Si = lie.Sim3(q_i, t_i, s_i)
    Sj_inv = lie.sim3_inverse(lie.Sim3(q_j, t_j, s_j))
    Sm = lie.Sim3(q_m, t_m, s_m)
    err = lie.sim3_compose(Sm, lie.sim3_compose(Si, Sj_inv))
    return lie.sim3_log(err)


def optimize_essential_graph(q_kw, t_kw, s_kw, fixed, edges: PGOEdges,
                             iters: int = 20, lam0: float = 1e-4):
    """Damped GN (LM with accept/reject) over Sim3 vertices.
    q_kw/t_kw/s_kw: [K] world->kf Sim3 poses (s=1 on entry except
    loop-corrected KFs); fixed [K] bool.

    Returns corrected (q, t, s).
    """
    K = q_kw.shape[0]
    E = edges.i.shape[0]

    def cost_of(q, t, s):
        r = edge_residual(q[edges.i], t[edges.i], s[edges.i],
                          q[edges.j], t[edges.j], s[edges.j],
                          edges.q, edges.t, edges.s)
        w = jnp.where(edges.valid, edges.w, 0.0)
        return jnp.sum(w * jnp.sum(r * r, axis=-1))

    def gn_step(carry, _):
        q, t, s, lam, cost = carry

        qi, ti, si = q[edges.i], t[edges.i], s[edges.i]
        qj, tj, sj = q[edges.j], t[edges.j], s[edges.j]

        def r_of(xi_i, xi_j, qi, ti, si, qj, tj, sj, qm, tm, sm):
            def perturb(xi, qq, tt, ss):
                d = lie.sim3_exp(xi)
                S = lie.sim3_compose(d, lie.Sim3(qq, tt, ss))
                return S
            Si = perturb(xi_i, qi, ti, si)
            Sj = perturb(xi_j, qj, tj, sj)
            return edge_residual(Si.q, Si.t, Si.s, Sj.q, Sj.t, Sj.s,
                                 qm, tm, sm)

        zeros = jnp.zeros((E, 7))
        r = jax.vmap(r_of)(zeros, zeros, qi, ti, si, qj, tj, sj,
                           edges.q, edges.t, edges.s)
        Ji = jax.vmap(jax.jacfwd(r_of, argnums=0))(
            zeros, zeros, qi, ti, si, qj, tj, sj,
            edges.q, edges.t, edges.s)  # [E, 7, 7]
        Jj = jax.vmap(jax.jacfwd(r_of, argnums=1))(
            zeros, zeros, qi, ti, si, qj, tj, sj,
            edges.q, edges.t, edges.s)

        w = jnp.where(edges.valid, edges.w, 0.0)
        # mask fixed vertices
        free_i = ~fixed[edges.i]
        free_j = ~fixed[edges.j]
        Ji = Ji * free_i[:, None, None]
        Jj = Jj * free_j[:, None, None]

        # assemble dense H [7K, 7K], g [7K]
        Hii = jnp.einsum("eki,ekj,e->eij", Ji, Ji, w, precision=_HI)
        Hjj = jnp.einsum("eki,ekj,e->eij", Jj, Jj, w, precision=_HI)
        Hij = jnp.einsum("eki,ekj,e->eij", Ji, Jj, w, precision=_HI)
        gi = jnp.einsum("eki,ek,e->ei", Ji, r, w, precision=_HI)
        gj = jnp.einsum("eki,ek,e->ei", Jj, r, w, precision=_HI)

        H = jnp.zeros((K, K, 7, 7))
        H = H.at[edges.i, edges.i].add(Hii)
        H = H.at[edges.j, edges.j].add(Hjj)
        H = H.at[edges.i, edges.j].add(Hij)
        H = H.at[edges.j, edges.i].add(jnp.swapaxes(Hij, -1, -2))
        g = jnp.zeros((K, 7))
        g = g.at[edges.i].add(gi)
        g = g.at[edges.j].add(gj)

        # fixed vertices: identity rows; LM damping on the diagonal
        eye7 = jnp.eye(7)
        diag_fix = jnp.where(fixed[:, None, None], eye7[None], 0.0)
        diag = jnp.diagonal(H[jnp.arange(K), jnp.arange(K)],
                            axis1=-2, axis2=-1)
        damp = lam * jnp.maximum(diag, 1e-6) + 1e-8
        H = H.at[jnp.arange(K), jnp.arange(K)].add(
            diag_fix + damp[..., None] * eye7[None])
        Hd = H.transpose(0, 2, 1, 3).reshape(7 * K, 7 * K)
        gd = g.reshape(7 * K)
        # H is SPD after damping: Cholesky beats LU ~1.4x at this size
        chol = jax.scipy.linalg.cho_factor(Hd)
        dx = jax.scipy.linalg.cho_solve(chol, -gd).reshape(K, 7)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx,
                       jnp.zeros_like(dx))
        dx = jnp.where(fixed[:, None], 0.0, dx)

        dS = lie.sim3_exp(dx)
        S_new = lie.sim3_compose(dS, lie.Sim3(q, t, s))
        nq = lie.quat_normalize(S_new.q)
        nt, ns = S_new.t, S_new.s
        new_cost = cost_of(nq, nt, ns)
        accept = new_cost < cost
        lam2 = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                         jnp.minimum(lam * 5.0, 1e5))
        q = jnp.where(accept, nq, q)
        t = jnp.where(accept, nt, t)
        s = jnp.where(accept, ns, s)
        cost = jnp.where(accept, new_cost, cost)
        return (q, t, s, lam2, cost), None

    cost0 = cost_of(q_kw, t_kw, s_kw)
    carry, _ = jax.lax.scan(
        gn_step,
        (q_kw, t_kw, s_kw, jnp.asarray(lam0, jnp.float32), cost0),
        None, length=iters)
    return carry[0], carry[1], carry[2]


def optimize_essential_graph_4dof(q_kw, t_kw, fixed,
                                  edges: PGOEdges, iters: int = 20,
                                  lam0: float = 1e-4,
                                  gravity_axis=None):
    """4DoF essential-graph optimization (reference Optimizer.cc:5299
    ``OptimizeEssentialGraph4DoF`` / G2oTypes ``VertexPose4DoF`` +
    ``Edge4DoF``): for inertial maps whose roll/pitch are observable
    from gravity, only YAW (rotation about ``gravity_axis``, default
    world z) and translation are optimized; the full SE3 edge residual
    is evaluated (roll/pitch discrepancies contribute error but cannot
    be absorbed), and scale is held at 1 (inertial maps are metric).

    Same damped-GN/accept-reject machinery as
    ``optimize_essential_graph`` with a 4-dim left-retraction
    ``T' = [Rot(axis, dyaw) | dt] o T``.  Returns corrected (q, t)."""
    K = q_kw.shape[0]
    E = edges.i.shape[0]
    axis = (jnp.asarray([0.0, 0.0, 1.0]) if gravity_axis is None
            else jnp.asarray(gravity_axis))
    axis = axis / jnp.maximum(jnp.linalg.norm(axis), 1e-9)
    ones = jnp.ones_like(q_kw[..., 0])

    def cost_of(q, t):
        r = edge_residual(q[edges.i], t[edges.i], ones[edges.i],
                          q[edges.j], t[edges.j], ones[edges.j],
                          edges.q, edges.t, edges.s)
        w = jnp.where(edges.valid, edges.w, 0.0)
        return jnp.sum(w * jnp.sum(r * r, axis=-1))

    def perturb(xi, qq, tt):
        # right-composition with a WORLD-frame perturbation: T_cw' =
        # T_cw o d, d = [Rot(gravity_axis, dyaw) | dt] — yaw spins the
        # world about gravity (the only unobservable rotation DoF of an
        # inertial map), dt translates the world
        half = 0.5 * xi[0]
        dq = jnp.concatenate([jnp.cos(half)[None],
                              jnp.sin(half) * axis])
        q2 = lie.quat_mul(qq, dq)
        t2 = tt + lie.quat_rotate(qq, xi[1:4])
        return q2, t2

    def gn_step(carry, _):
        q, t, lam, cost = carry
        qi, ti = q[edges.i], t[edges.i]
        qj, tj = q[edges.j], t[edges.j]

        def r_of(xi_i, xi_j, qi, ti, qj, tj, qm, tm, sm):
            q1, t1 = perturb(xi_i, qi, ti)
            q2, t2 = perturb(xi_j, qj, tj)
            one = jnp.ones(())
            return edge_residual(q1, t1, one, q2, t2, one, qm, tm, sm)

        zeros = jnp.zeros((E, 4))
        r = jax.vmap(r_of)(zeros, zeros, qi, ti, qj, tj,
                           edges.q, edges.t, edges.s)
        Ji = jax.vmap(jax.jacfwd(r_of, argnums=0))(
            zeros, zeros, qi, ti, qj, tj, edges.q, edges.t, edges.s)
        Jj = jax.vmap(jax.jacfwd(r_of, argnums=1))(
            zeros, zeros, qi, ti, qj, tj, edges.q, edges.t, edges.s)

        w = jnp.where(edges.valid, edges.w, 0.0)
        Ji = Ji * (~fixed[edges.i])[:, None, None]
        Jj = Jj * (~fixed[edges.j])[:, None, None]

        Hii = jnp.einsum("eki,ekj,e->eij", Ji, Ji, w, precision=_HI)
        Hjj = jnp.einsum("eki,ekj,e->eij", Jj, Jj, w, precision=_HI)
        Hij = jnp.einsum("eki,ekj,e->eij", Ji, Jj, w, precision=_HI)
        gi = jnp.einsum("eki,ek,e->ei", Ji, r, w, precision=_HI)
        gj = jnp.einsum("eki,ek,e->ei", Jj, r, w, precision=_HI)

        H = jnp.zeros((K, K, 4, 4))
        H = H.at[edges.i, edges.i].add(Hii)
        H = H.at[edges.j, edges.j].add(Hjj)
        H = H.at[edges.i, edges.j].add(Hij)
        H = H.at[edges.j, edges.i].add(jnp.swapaxes(Hij, -1, -2))
        g = jnp.zeros((K, 4))
        g = g.at[edges.i].add(gi)
        g = g.at[edges.j].add(gj)

        eye4 = jnp.eye(4)
        diag_fix = jnp.where(fixed[:, None, None], eye4[None], 0.0)
        diag = jnp.diagonal(H[jnp.arange(K), jnp.arange(K)],
                            axis1=-2, axis2=-1)
        damp = lam * jnp.maximum(diag, 1e-6) + 1e-8
        H = H.at[jnp.arange(K), jnp.arange(K)].add(
            diag_fix + damp[..., None] * eye4[None])
        Hd = H.transpose(0, 2, 1, 3).reshape(4 * K, 4 * K)
        gd = g.reshape(4 * K)
        chol = jax.scipy.linalg.cho_factor(Hd)
        dx = jax.scipy.linalg.cho_solve(chol, -gd).reshape(K, 4)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx,
                       jnp.zeros_like(dx))
        dx = jnp.where(fixed[:, None], 0.0, dx)

        nq, nt = jax.vmap(perturb)(dx, q, t)
        nq = lie.quat_normalize(nq)
        new_cost = cost_of(nq, nt)
        accept = new_cost < cost
        lam2 = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                         jnp.minimum(lam * 5.0, 1e5))
        q = jnp.where(accept, nq, q)
        t = jnp.where(accept, nt, t)
        cost = jnp.where(accept, new_cost, cost)
        return (q, t, lam2, cost), None

    cost0 = cost_of(q_kw, t_kw)
    carry, _ = jax.lax.scan(
        gn_step, (q_kw, t_kw, jnp.asarray(lam0, jnp.float32), cost0),
        None, length=iters)
    return carry[0], carry[1]


def correct_points_by_ref(mp_pos, mp_ref_kf, mp_mask,
                          q_old, t_old, s_old, q_new, t_new, s_new):
    """Map-point correction through the reference KF's before/after Sim3
    (reference OptimizeEssentialGraph tail + RunGlobalBundleAdjustment
    :3773-3800):  X' = S_new^{-1}( S_old( X ) )."""
    ref = jnp.clip(mp_ref_kf, 0)
    S_old = lie.Sim3(q_old[ref], t_old[ref], s_old[ref])
    S_new_inv = lie.sim3_inverse(
        lie.Sim3(q_new[ref], t_new[ref], s_new[ref]))
    moved = lie.sim3_apply(S_new_inv, lie.sim3_apply(S_old, mp_pos))
    return jnp.where(mp_mask[:, None], moved, mp_pos)
