"""Fused pose-optimization kernel (Pallas, Triton route): parity with the
XLA solver path in interpret mode on the CPU, and its CUDA lowering.

The XLA path in solvers.ba.pose_optimization is itself validated against
reference Optimizer::PoseOptimization semantics in test_ba.py, so parity
here transitively validates the kernel.  The kernel's compiled form runs
only on a GPU (chip_smoke.py phase 5 times it there).
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from mam3slam_tpu.geometry import cameras, lie
from mam3slam_tpu.ops import pallas_pose
from mam3slam_tpu.solvers import ba

RNG = np.random.default_rng(7)


def _make_problem(n=512, n_out=60, noise=0.6):
    pts = np.stack([RNG.uniform(-4, 4, n), RNG.uniform(-3, 3, n),
                    RNG.uniform(3, 12, n)], axis=1).astype(np.float32)
    w_true = RNG.normal(0, 0.05, 3)
    q_true = lie.so3_exp_quat(jnp.asarray(w_true, jnp.float32))
    t_true = jnp.asarray(RNG.normal(0, 0.2, 3), jnp.float32)
    cam = cameras.make_pinhole(458.0, 457.0, 376.0, 240.0)
    Xc = lie.quat_rotate(q_true[None, :], jnp.asarray(pts)) + t_true[None, :]
    uv = np.array(cameras.project_ideal(cam, Xc))
    uv += RNG.normal(0, noise, uv.shape)
    out_idx = RNG.choice(n, n_out, replace=False)
    uv[out_idx] += RNG.uniform(20, 80, (n_out, 2)) * RNG.choice(
        [-1, 1], (n_out, 2))
    w = np.ones(n, np.float32)
    valid = np.ones(n, bool)
    valid[::29] = False
    return (cam, jnp.asarray(pts), jnp.asarray(uv, jnp.float32),
            jnp.asarray(w), jnp.asarray(valid), q_true, t_true, out_idx)


@pytest.mark.parametrize("n", [64, 768])
def test_pallas_pose_parity_and_accuracy(n):
    cam, pts, uv, w, valid, q_true, t_true, out_idx = _make_problem(
        n=n, n_out=max(n // 9, 4))

    # perturbed initial pose
    q0 = lie.quat_normalize(
        lie.quat_mul(lie.so3_exp_quat(jnp.asarray([0.02, -0.03, 0.01])), q_true))
    t0 = t_true + jnp.asarray([0.05, -0.04, 0.08])

    # XLA reference path
    ref = ba.pose_optimization(q0, t0, cam.params, cam.kind,
                               pts, uv, w, valid, use_kernel=False)

    R0 = lie.quat_to_matrix(q0)
    R, t, inlier, n_in = pallas_pose.pose_optimization_pinhole(
        R0, t0, cam.params[:4], pts, uv, w, valid, interpret=True)
    q = lie.quat_from_matrix(R)

    # both must land on the true pose
    def ang_err(qa, qb):
        d = abs(float(jnp.dot(qa, qb)))
        return 2 * np.arccos(min(d, 1.0))

    assert ang_err(q, q_true) < 2e-3
    assert float(jnp.linalg.norm(t - t_true)) < 5e-3
    # parity with the XLA path
    assert ang_err(q, ref.q) < 2e-3
    assert float(jnp.linalg.norm(t - ref.t)) < 5e-3

    # inlier classification: outliers rejected, inliers kept
    inl = np.asarray(inlier)
    assert not inl[out_idx].any()
    assert not inl[~np.asarray(valid)].any()
    clean = np.ones(len(inl), bool)
    clean[out_idx] = False
    clean &= np.asarray(valid)
    assert inl[clean].mean() > 0.97
    # classification agreement with the XLA path
    agree = (inl == np.asarray(ref.inlier)).mean()
    assert agree > 0.99


def test_pallas_pose_all_inliers_exact():
    """Noise-free case: both solvers drive the residual to ~0."""
    cam, pts, uv_noisy, w, valid, q_true, t_true, _ = _make_problem(
        n=256, n_out=0, noise=0.0)
    Xc = lie.quat_rotate(q_true[None, :], pts) + t_true[None, :]
    uv = cameras.project_ideal(cam, Xc)

    q0 = lie.quat_normalize(
        lie.quat_mul(lie.so3_exp_quat(jnp.asarray([0.03, 0.02, -0.02])), q_true))
    t0 = t_true + jnp.asarray([-0.06, 0.03, 0.05])
    R, t, inlier, n_in = pallas_pose.pose_optimization_pinhole(
        lie.quat_to_matrix(q0), t0, cam.params[:4], pts, uv,
        w, jnp.ones(pts.shape[0], bool), interpret=True)
    q = lie.quat_from_matrix(R)
    d = abs(float(jnp.dot(q, q_true)))
    assert 2 * np.arccos(min(d, 1.0)) < 1e-4
    assert float(jnp.linalg.norm(t - t_true)) < 1e-4
    assert int(n_in) == pts.shape[0]


def test_block_and_warps():
    """Slots pad to a power of two; warps follow the measured rule."""
    assert pallas_pose.block_size(700) == 1024
    assert pallas_pose.block_size(768) == 1024
    assert pallas_pose.block_size(5) == 32
    assert pallas_pose.num_warps(1024) == 4
    assert pallas_pose.num_warps(4096) == 8
    assert pallas_pose.num_warps(1 << 16) == 16


def test_padding_slots_are_inert():
    """Padded slots carry valid=0: the result equals the unpadded solve
    and every padded slot reports outlier."""
    cam, pts, uv, w, valid, q_true, t_true, _ = _make_problem(n=100,
                                                              n_out=8)
    q0 = lie.quat_normalize(lie.quat_mul(
        lie.so3_exp_quat(jnp.asarray([0.01, 0.02, -0.01])), q_true))
    args = (lie.quat_to_matrix(q0), t_true, cam.params[:4])
    R1, t1, inl1, n1 = pallas_pose.pose_optimization_pinhole(
        *args, pts, uv, w, valid, interpret=True)
    pad = 28  # 128 slots: same power-of-two block as 100
    R2, t2, inl2, n2 = pallas_pose.pose_optimization_pinhole(
        *args, jnp.pad(pts, ((0, pad), (0, 0)), constant_values=1.0),
        jnp.pad(uv, ((0, pad), (0, 0))), jnp.pad(w, (0, pad)),
        jnp.pad(valid, (0, pad)), interpret=True)
    np.testing.assert_allclose(np.asarray(R1), np.asarray(R2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), atol=1e-6)
    assert int(n1) == int(n2)
    assert not np.asarray(inl2)[100:].any()


def test_kernel_lowers_for_cuda():
    """The dispatch inside pose_optimization lowers the Triton kernel when
    the program is lowered for CUDA, and plain XLA when lowered for the
    CPU (no GPU needed: lowering stops before the GPU compiler)."""
    cam, pts, uv, w, valid, q_true, t_true, _ = _make_problem(n=64, n_out=4)

    def f(q0, t0, p, uv_, w_, v_):
        return ba.pose_optimization(q0, t0, cam.params, cam.kind, p, uv_,
                                    w_, v_)

    args = (q_true, t_true, pts, uv, w, valid)
    cuda = jax.jit(f).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    cpu = jax.jit(f).trace(*args).lower(
        lowering_platforms=("cpu",)).as_text()
    assert "triton" in cuda
    assert "triton" not in cpu


@pytest.mark.gpu
def test_kernel_on_gpu_matches_xla(gpu_device):
    """The compiled Triton kernel on the card against the XLA path."""
    cam, pts, uv, w, valid, q_true, t_true, _ = _make_problem(n=768,
                                                              n_out=80)
    q0 = lie.quat_normalize(lie.quat_mul(
        lie.so3_exp_quat(jnp.asarray([0.02, -0.03, 0.01])), q_true))
    args = jax.device_put((q0, t_true, cam.params, pts, uv, w, valid),
                          gpu_device)
    R, t, inlier, n_in = pallas_pose.pose_optimization_pinhole(
        lie.quat_to_matrix(args[0]), args[1], args[2][:4], *args[3:])
    ref = ba.pose_optimization(*args[:3], cam.kind, *args[3:],
                               use_kernel=False)
    d = abs(float(jnp.dot(lie.quat_from_matrix(R), ref.q)))
    assert 2 * np.arccos(min(d, 1.0)) < 2e-3
    assert float(jnp.linalg.norm(t - ref.t)) < 5e-3
    assert (np.asarray(inlier) == np.asarray(ref.inlier)).mean() > 0.99
