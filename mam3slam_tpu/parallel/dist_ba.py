"""Distributed bundle adjustment over a device mesh.

The multi-chip scaling story of the framework (SURVEY.md §2.6/§2.8 and
BASELINE.md "4-agent centralized BA across 2 hosts"): observation edges are
sharded across devices along a mesh axis; every per-edge computation runs
locally and the per-vertex reductions (gradients, Hessian blocks, Schur
products) become ``psum`` collectives over the interconnect.  Camera and point state is
replicated — it is tiny compared to edges — so the PCG loop is pure local
compute + one psum per matrix-vector product.

Also provides the batched multi-agent front end: N agents' motion-only pose
optimizations as one vmapped + sharded computation (agent-parallel axis,
SURVEY.md §2.8 item 1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mam3slam_tpu.solvers import ba as ba_mod


def pad_obs_to_multiple(obs: ba_mod.Obs, n: int) -> ba_mod.Obs:
    E = obs.cam.shape[0]
    pad = (-E) % n
    if pad == 0:
        return obs
    return ba_mod.Obs(
        cam=jnp.pad(obs.cam, (0, pad)),
        pt=jnp.pad(obs.pt, (0, pad)),
        uv=jnp.pad(obs.uv, ((0, pad), (0, 0))),
        w=jnp.pad(obs.w, (0, pad)),
        valid=jnp.pad(obs.valid, (0, pad)),
    )


def dist_run_ba(problem: ba_mod.BAProblem, mesh: Mesh, kind: int,
                axis: str = "edge", iters: int = 10, cg_iters: int = 30,
                **kw) -> ba_mod.BAResult:
    """run_ba with the edge list sharded over ``mesh[axis]``.

    Vertex state replicates; every segment-sum inside the solver psums over
    the axis, so all devices march through identical LM/CG control flow.
    """
    n = mesh.shape[axis]
    obs = pad_obs_to_multiple(problem.obs, n)
    problem = problem._replace(obs=obs)

    repl = P()
    shard_e = P(axis)
    in_specs = ba_mod.BAProblem(
        cam_q=repl, cam_t=repl, cam_params=repl, pts=repl,
        obs=ba_mod.Obs(cam=shard_e, pt=shard_e, uv=shard_e, w=shard_e,
                       valid=shard_e),
        cam_free=repl, pt_free=repl)
    out_specs = ba_mod.BAResult(cam_q=repl, cam_t=repl, pts=repl,
                                inlier=shard_e, cost=repl)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(in_specs,),
        out_specs=out_specs)
    def _run(prob):
        res = ba_mod.run_ba(prob, kind, iters=iters, cg_iters=cg_iters,
                            axis_name=axis, **kw)
        # cost/poses/points identical on every device (psum'd); emit one copy
        return res

    return _run(problem)


# ---------------------------------------------------------------------------
# agent-parallel batched front end
# ---------------------------------------------------------------------------

def batched_pose_optimization(mesh: Mesh, kind: int, axis: str = "agent"):
    """Returns a jitted fn optimizing N agents' frame poses in parallel,
    with the agent batch sharded over ``mesh[axis]`` (the batched form of the
    reference's per-agent Tracking threads, SURVEY.md §2.8 item 1).

    fn(q0 [N,4], t0 [N,3], cam_params [N,8], pts [N,M,3], uv [N,M,2],
       w [N,M], valid [N,M]) -> PoseOptResult batched over N.
    """
    shard = NamedSharding(mesh, P(axis))

    vmapped = jax.vmap(
        lambda q0, t0, cp, pts, uv, w, valid: ba_mod.pose_optimization(
            q0, t0, cp, kind, pts, uv, w, valid, use_kernel=False))

    @jax.jit
    def fn(q0, t0, cam_params, pts, uv, w, valid):
        args = [jax.lax.with_sharding_constraint(x, shard)
                for x in (q0, t0, cam_params, pts, uv, w, valid)]
        return vmapped(*args)

    return fn
