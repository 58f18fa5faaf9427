"""Fused motion-only pose optimization as one Pallas program (Triton route).

The XLA path of ``solvers.ba.pose_optimization`` (reference
``Optimizer::PoseOptimization``, src/Optimizer.cc:814-1114) runs 4 rounds x
6 LM iterations as ~24 sequential segments of tiny kernels (linearize ->
6x6 normal equations -> solve -> retract).  This kernel runs the whole
optimization -- every round, the inter-round chi2 re-classification, the
LM accept/reject logic and the 6x6 Cholesky solves -- inside ONE program,
so the edge arrays stay in registers and no launch separates the steps.

Layout: one program (``grid=()``) holds the N feature slots, padded to a
power of two, as 1-D blocks; the 6x6 normal equations are block reductions
and the solve is a statically unrolled Cholesky on scalars.  The pose is
carried as a rotation matrix flattened to 9 loop scalars.

Only PINHOLE (ideal projection vs undistorted keypoints -- exactly what
the tracking pipeline optimizes) is implemented; the generic XLA path
serves KB8.  Parity with the XLA solver is tested in interpret mode on
the CPU (tests/test_pallas_pose.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

CHI2_MONO = 5.991
N_SCALARS = 16  # R (9) | t (3) | fx fy cx cy


def _chol_solve6(H, g):
    """Solve H x = g for SPD 6x6 given as [6][6] scalars; returns [6] list.
    Statically unrolled Cholesky + fwd/back substitution."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = H[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _so3_exp(w0, w1, w2):
    """Rodrigues: 9 scalars of exp(hat(w)) and of the SE3 V matrix."""
    th2 = w0 * w0 + w1 * w1 + w2 * w2
    th = jnp.sqrt(th2)
    small = th < 1e-6
    # sin(th)/th and (1-cos th)/th^2 with series fallbacks
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / jnp.maximum(th, 1e-20))
    b = jnp.where(small, 0.5 - th2 / 24.0,
                  (1.0 - jnp.cos(th)) / jnp.maximum(th2, 1e-20))
    # R = I + a*hat + b*hat^2
    r00 = 1.0 + b * (-(w1 * w1 + w2 * w2))
    r01 = -a * w2 + b * (w0 * w1)
    r02 = a * w1 + b * (w0 * w2)
    r10 = a * w2 + b * (w0 * w1)
    r11 = 1.0 + b * (-(w0 * w0 + w2 * w2))
    r12 = -a * w0 + b * (w1 * w2)
    r20 = -a * w1 + b * (w0 * w2)
    r21 = a * w0 + b * (w1 * w2)
    r22 = 1.0 + b * (-(w0 * w0 + w1 * w1))
    # V = I + b*hat + c*hat^2, c = (th - sin th)/th^3
    c = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                  (th - jnp.sin(th)) / jnp.maximum(th2 * th, 1e-20))
    v00 = 1.0 + c * (-(w1 * w1 + w2 * w2))
    v01 = -b * w2 + c * (w0 * w1)
    v02 = b * w1 + c * (w0 * w2)
    v10 = b * w2 + c * (w0 * w1)
    v11 = 1.0 + c * (-(w0 * w0 + w2 * w2))
    v12 = -b * w0 + c * (w1 * w2)
    v20 = -b * w1 + c * (w0 * w2)
    v21 = b * w0 + c * (w1 * w2)
    v22 = 1.0 + c * (-(w0 * w0 + w1 * w1))
    R = (r00, r01, r02, r10, r11, r12, r20, r21, r22)
    V = (v00, v01, v02, v10, v11, v12, v20, v21, v22)
    return R, V


def _mat3_mul(A, B):
    return tuple(A[3 * i + 0] * B[0 + j] + A[3 * i + 1] * B[3 + j]
                 + A[3 * i + 2] * B[6 + j]
                 for i in range(3) for j in range(3))


def _mat3_vec(A, v):
    return tuple(A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2]
                 for i in range(3))


def _pose_kernel(rounds, iters, delta2, scal_ref, x_ref, y_ref, z_ref,
                 u_ref, v_ref, w_ref, valid_ref, rt_ref, inl_ref):
    x = x_ref[...]
    y = y_ref[...]
    z = z_ref[...]
    mu = u_ref[...]
    mv = v_ref[...]
    w = w_ref[...]
    valid = valid_ref[...]

    # scalars travel as one 16-vector; element i is read as a masked sum
    # (a block load + reduction is what every route lowers)
    lane = jnp.arange(N_SCALARS, dtype=jnp.int32)
    sv = scal_ref[...]

    def scal(i):
        return jnp.sum(jnp.where(lane == i, sv, 0.0))

    R0 = tuple(scal(i) for i in range(9))
    t0 = tuple(scal(9 + i) for i in range(3))
    fx, fy, cx, cy = (scal(12 + i) for i in range(4))

    def linearize(R, t, active):
        xc = R[0] * x + R[1] * y + R[2] * z + t[0]
        yc = R[3] * x + R[4] * y + R[5] * z + t[1]
        zc = R[6] * x + R[7] * y + R[8] * z + t[2]
        zs = jnp.where(jnp.abs(zc) < 1e-6, 1e-6, zc)
        iz = 1.0 / zs
        ru = fx * xc * iz + cx - mu
        rv = fy * yc * iz + cy - mv
        a = fx * iz
        b = fy * iz
        xn = xc * iz
        yn = yc * iz
        # Jc = [dpi | -dpi hat(Xc)] rows for u and v (see ba._edge_linearize);
        # None marks the structural zeros (Ju[1], Jv[0])
        Ju = (a, None, -a * xn,
              -a * xn * yc, a * zc + a * xn * xc, -a * yc)
        Jv = (None, b, -b * yn,
              -b * zc - b * yn * yc, b * yn * xc, b * xc)
        depth_ok = jnp.where(zc > 1e-3, 1.0, 0.0)
        chi2 = w * (ru * ru + rv * rv)
        act = active * depth_ok
        rho = jnp.where(chi2 <= delta2, chi2,
                        2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 1e-12))
                        - delta2)
        cost = jnp.sum(act * rho)
        return ru, rv, Ju, Jv, chi2, act, cost

    def solve_step(R, t, lam, robust, ru, rv, Ju, Jv, chi2, act):
        if robust:
            w_rob = jnp.where(chi2 <= delta2, 1.0,
                              jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)))
            we = act * w * w_rob
        else:
            we = act * w

        def dot(p, q):
            return None if p is None or q is None else p * q

        def rowsum(*terms):
            terms = [t_ for t_ in terms if t_ is not None]
            if not terms:
                return jnp.asarray(0.0, jnp.float32)
            acc = terms[0]
            for t_ in terms[1:]:
                acc = acc + t_
            return jnp.sum(we * acc)

        H = [[None] * 6 for _ in range(6)]
        g = [None] * 6
        for i in range(6):
            g[i] = rowsum(dot(Ju[i], ru), dot(Jv[i], rv))
            for j in range(i + 1):
                H[i][j] = rowsum(dot(Ju[i], Ju[j]), dot(Jv[i], Jv[j]))
                H[j][i] = H[i][j]
        for i in range(6):
            H[i][i] = H[i][i] + lam * jnp.maximum(H[i][i], 1e-6) + 1e-8
        dx = _chol_solve6(H, [-gi for gi in g])
        dR, V = _so3_exp(dx[3], dx[4], dx[5])
        dt = _mat3_vec(V, (dx[0], dx[1], dx[2]))
        nR = _mat3_mul(dR, R)
        nt = tuple(m + d for m, d in zip(_mat3_vec(dR, t), dt))
        return nR, nt

    def lm_rounds(R, t, active, robust):
        def body(_, carry):
            bR, bt, bcost, R, t, lam = carry
            ru, rv, Ju, Jv, chi2, act, cost = linearize(R, t, active)
            accept = cost < bcost
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                            jnp.minimum(lam * 4.0, 1e4))
            bR = tuple(jnp.where(accept, a_, b_) for a_, b_ in zip(R, bR))
            bt = tuple(jnp.where(accept, a_, b_) for a_, b_ in zip(t, bt))
            bcost = jnp.where(accept, cost, bcost)
            nR, nt = solve_step(bR, bt, lam, robust,
                                ru, rv, Ju, Jv, chi2, act)
            return bR, bt, bcost, nR, nt, lam

        big = jnp.asarray(jnp.inf, jnp.float32)
        lam0 = jnp.asarray(1e-3, jnp.float32)
        carry = (R, t, big, R, t, lam0)
        carry = jax.lax.fori_loop(0, iters + 1, body, carry)
        return carry[0], carry[1]

    R, t = R0, t0
    active = valid
    for rd in range(rounds):
        R, t = lm_rounds(R, t, active, robust=(rd < 2))
        # re-classification at the refined pose
        xc = R[0] * x + R[1] * y + R[2] * z + t[0]
        yc = R[3] * x + R[4] * y + R[5] * z + t[1]
        zc = R[6] * x + R[7] * y + R[8] * z + t[2]
        zs = jnp.where(jnp.abs(zc) < 1e-6, 1e-6, zc)
        iz = 1.0 / zs
        ru = fx * xc * iz + cx - mu
        rv = fy * yc * iz + cy - mv
        chi2 = w * (ru * ru + rv * rv)
        active = jnp.where((zc > 1e-3) & (chi2 <= delta2), valid, 0.0)

    out = jnp.zeros((N_SCALARS,), jnp.float32)
    for i, s in enumerate(R + t):
        out = jnp.where(lane == i, s, out)
    rt_ref[...] = out
    inl_ref[...] = active


def block_size(n: int) -> int:
    """Feature slots padded to a power of two (Triton block extents)."""
    return max(pl.next_power_of_2(int(n)), 32)


def num_warps(n_block: int) -> int:
    """Warps for one program over ``n_block`` slots.  Measured on an H100
    (700 W): 4 warps are fastest up to 1024 slots; past that a warp should
    hold <= 16 slots per vector or the LM step's ~40 live edge vectors
    spill out of registers (4096 slots: 1.8 ms at 4 warps, 0.54 ms at 8)."""
    return int(min(max(n_block // 512, 4), 16))


@functools.partial(jax.jit,
                   static_argnames=("rounds", "iters", "interpret"))
def pose_optimization_pinhole(R0, t0, fxycxy, pts, uv, w, valid,
                              rounds: int = 4, iters: int = 5,
                              interpret: bool = False):
    """Fused pose optimization.  Args:
    R0 [3,3], t0 [3], fxycxy [4], pts [N,3], uv [N,2], w [N], valid [N] bool.
    Returns (R [3,3], t [3], inlier [N] bool, n_inliers)."""
    N = pts.shape[0]
    Np = block_size(N)
    scal = jnp.concatenate([R0.reshape(9), t0.reshape(3),
                            fxycxy.reshape(4)]).astype(jnp.float32)

    def col(a):
        return jnp.pad(a.astype(jnp.float32), (0, Np - N))

    cols = [col(pts[:, 0]), col(pts[:, 1]), col(pts[:, 2]),
            col(uv[:, 0]), col(uv[:, 1]), col(w), col(valid)]
    kern = functools.partial(_pose_kernel, rounds, iters, CHI2_MONO)
    rt, inl = pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct((N_SCALARS,), jnp.float32),
                   jax.ShapeDtypeStruct((Np,), jnp.float32)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps(Np), num_stages=1),
        interpret=interpret,
        name="pose_optimization_pinhole",
    )(scal, *cols)
    R = rt[:9].reshape(3, 3)
    t = rt[9:12]
    inlier = inl[:N] > 0.5
    return R, t, inlier, jnp.sum(inlier.astype(jnp.int32))
