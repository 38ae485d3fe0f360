"""Dense Gauss-Newton / Levenberg-Marquardt smoother for the sliding window.

Replaces the reference's iSAM2 updates (/root/reference/run/pipeline.cpp:
738-759, run/pipeline_ligo_tc.cpp:578-587) with a full re-linearized solve
per keyframe: residual Jacobians come from ``jax.jacfwd`` through the factor
residuals (the window is tiny, so a dense (W*15)^2 normal-equation solve
beats incremental sparse updates), with Levenberg damping and
fixed-iteration ``lax`` loops. Marginal covariances — needed by the apps for
KeyFrameStats (pipeline.cpp:753) — are blocks of the inverse normal matrix.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .graph import Factors, WindowState, residuals

STATE_DIM = 15  # pose(6) + vel(3) + bias(6)


class SmootherConfig(NamedTuple):
    iterations: int = 8
    damping: float = 1e-6
    step_tol: float = 1e-10
    # "qr": QR on the augmented Jacobian (safest f32 conditioning);
    # "chol": Jacobi-equilibrated Cholesky on the normal equations — the
    # same system (H = J^T J + diag(pin) + damping I), solved at a fraction
    # of the cost: small-matrix QR is sequential per column (the pose-only
    # window makes the same trade
    # in optimize_pose_window; equilibration keeps diag(H~) == 1 across the
    # ~1e6+ info-magnitude spread between IMU and prior factors).
    solver: str = "qr"


class SmootherResult(NamedTuple):
    state: WindowState
    hessian: jax.Array  # (W*15, W*15) Gauss-Newton normal matrix at solution
    error: jax.Array  # () final 0.5*||r||^2
    iterations: jax.Array


def _linearize(state: WindowState, factors: Factors):
    """Residual vector and dense Jacobian w.r.t. the stacked window tangent."""
    W = state.window

    def r_of_delta(delta):
        return residuals(state.retract(delta.reshape(W, STATE_DIM)), factors)

    zero = jnp.zeros(W * STATE_DIM, dtype=state.trans.dtype)
    r = r_of_delta(zero)
    J = jax.jacfwd(r_of_delta)(zero)
    return r, J


def optimize(
    state: WindowState, factors: Factors, cfg: SmootherConfig = SmootherConfig()
) -> SmootherResult:
    W = state.window
    n = W * STATE_DIM
    dtype = state.trans.dtype
    # Inactive states must stay pinned: add a unit prior on their tangent.
    inactive = ~state.active
    pin = jnp.repeat(inactive.astype(dtype), STATE_DIM)

    # QR on the augmented Jacobian instead of normal equations: J^T J squares
    # the condition number, which overflows float32 (the tests run f64 on
    # CPU, but the deployed smoother runs f32 on device).
    sqrt_damp = jnp.sqrt(jnp.asarray(cfg.damping, dtype))

    def gn_step(st):
        r, J = _linearize(st, factors)
        if cfg.solver == "chol":
            # normal equations of the same augmented system: the diag(pin)
            # rows contribute pin (0/1 entries square to themselves), the
            # sqrt_damp rows contribute damping * I
            H = J.T @ J + jnp.diag(pin) + cfg.damping * jnp.eye(n, dtype=dtype)
            g = J.T @ r
            d = jax.lax.rsqrt(jnp.maximum(jnp.diag(H), 1e-30))
            Hs = H * d[:, None] * d[None, :]
            L = jnp.linalg.cholesky(Hs)
            z = jax.scipy.linalg.cho_solve((L, True), -(d * g))
            return d * z
        aug = jnp.concatenate(
            [J, jnp.diag(pin), sqrt_damp * jnp.eye(n, dtype=dtype)], axis=0
        )
        r_aug = jnp.concatenate([r, jnp.zeros(2 * n, dtype=dtype)])
        Q, R = jnp.linalg.qr(aug)
        delta = -jax.scipy.linalg.solve_triangular(R, Q.T @ r_aug, lower=False)
        return delta

    def body(carry, _):
        st, err, it = carry
        delta = gn_step(st)
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        step_ok = jnp.linalg.norm(delta) > cfg.step_tol
        new_st = st.retract(jnp.where(step_ok, delta, 0.0).reshape(W, STATE_DIM))
        new_err = 0.5 * jnp.sum(residuals(new_st, factors) ** 2)
        # Reject steps that increase the cost (simple LM-style guard).
        accept = new_err <= err
        st_out = jax.tree.map(
            lambda a, b: jnp.where(accept, a, b) if a.dtype != bool else b,
            new_st,
            st,
        )
        return (st_out, jnp.where(accept, new_err, err), it + 1), None

    err0 = 0.5 * jnp.sum(residuals(state, factors) ** 2)
    (final_state, err, iters), _ = jax.lax.scan(
        body, (state, err0, jnp.asarray(0, jnp.int32)), None, length=cfg.iterations
    )
    r, J = _linearize(final_state, factors)
    # Pin every UNOBSERVED dof explicitly (zero Jacobian column), not just
    # inactive states: a pose-only window (odom_ndt) leaves active states'
    # vel/bias blocks exactly singular, and marginal_covariance's tiny
    # jitter inversion only worked because the zero cross-blocks kept the
    # pose block clean — one future factor touching vel would break it
    # silently. A unit pin gives unobserved dofs a finite O(1) marginal
    # variance and leaves observed blocks untouched.
    unobserved = ~jnp.any(jnp.abs(J) > 0.0, axis=0)
    H = J.T @ J + jnp.diag(jnp.maximum(pin, unobserved.astype(dtype)))
    return SmootherResult(final_state, H, 0.5 * jnp.sum(r**2), iters)


class PoseWindowResult(NamedTuple):
    rot: jax.Array  # (W, 3, 3)
    trans: jax.Array  # (W, 3)
    hessian: jax.Array  # (W*6, W*6) normal matrix at solution (pins included)
    error: jax.Array  # () final 0.5*||r||^2


def optimize_pose_window(
    rot, trans, active,
    fp_rot, fp_trans, fp_sqrt_info,
    fb_rot, fb_trans, fb_sqrt_info, b_active,
    iterations: int = 5,
    damping: float = 1e-6,
):
    """Pose-only window Gauss-Newton (the odometry graph of pipeline.cpp:
    604-665: one INS pose prior per state + NDT between factors on the
    chain). The 15-dof smoother above pins vel/bias to zero for this graph,
    so the pose solution is identical — but the solve here is 6W dofs
    instead of 15W, and uses equilibrated normal-equations Cholesky instead
    of QR on the (r + 2n) x n augmented Jacobian. Small-matrix QR is
    sequential per column; the Jacobi-equilibrated Cholesky
    keeps f32 conditioning in check (diag(H~) == 1) at a fraction of the
    cost.

    fb arrays describe edges k -> k+1 for k in [0, W-2].
    """
    from ..core import se3
    from ..core.se3 import Pose3

    W = trans.shape[0]
    n = 6 * W
    dtype = trans.dtype
    inactive = ~active
    pin = jnp.repeat(inactive.astype(dtype), 6)
    idx_i = jnp.arange(W - 1)
    idx_j = jnp.arange(1, W)
    prior = Pose3(fp_rot, fp_trans)
    meas = Pose3(fb_rot, fb_trans)

    def resid(pose: Pose3):
        r_p = se3.local(prior, pose)
        r_p = jnp.einsum("fij,fj->fi", fp_sqrt_info, r_p)
        r_p = jnp.where(active[:, None], r_p, 0.0)
        xi = Pose3(pose.rot[idx_i], pose.trans[idx_i])
        xj = Pose3(pose.rot[idx_j], pose.trans[idx_j])
        r_b = se3.local(meas, se3.between(xi, xj))
        r_b = jnp.einsum("fij,fj->fi", fb_sqrt_info, r_b)
        r_b = jnp.where(b_active[:, None], r_b, 0.0)
        return jnp.concatenate([r_p.ravel(), r_b.ravel()])

    def linearize(pose: Pose3):
        def r_of(delta):
            return resid(se3.retract(pose, delta.reshape(W, 6)))

        zero = jnp.zeros(n, dtype)
        return r_of(zero), jax.jacfwd(r_of)(zero)

    def solve(H, g):
        # Jacobi equilibration: solve (DHD) z = -Dg, delta = Dz. Keeps the
        # f32 Cholesky stable across the ~1e6+ info-magnitude spread between
        # tight NDT betweens and trust-gain-scaled INS priors.
        d = jax.lax.rsqrt(jnp.maximum(jnp.diag(H), 1e-30))
        Hs = H * d[:, None] * d[None, :]
        L = jnp.linalg.cholesky(Hs + damping * jnp.eye(n, dtype=dtype))
        z = jax.scipy.linalg.cho_solve((L, True), -(d * g))
        return d * z

    def gn_hessian(pose: Pose3):
        r, J = linearize(pose)
        unobserved = ~jnp.any(jnp.abs(J) > 0.0, axis=0)
        H = J.T @ J + jnp.diag(jnp.maximum(pin, unobserved.astype(dtype)))
        return r, J, H

    def body(carry, _):
        pose, err = carry
        r, J, H = gn_hessian(pose)
        delta = solve(H, J.T @ r)
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        new_pose = se3.retract(pose, delta.reshape(W, 6))
        new_err = 0.5 * jnp.sum(resid(new_pose) ** 2)
        accept = new_err <= err
        pose_out = Pose3(
            jnp.where(accept, new_pose.rot, pose.rot),
            jnp.where(accept, new_pose.trans, pose.trans),
        )
        return (pose_out, jnp.where(accept, new_err, err)), None

    pose0 = Pose3(rot, trans)
    err0 = 0.5 * jnp.sum(resid(pose0) ** 2)
    (pose, err), _ = jax.lax.scan(body, (pose0, err0), None, length=iterations)
    r, J, H = gn_hessian(pose)
    return PoseWindowResult(pose.rot, pose.trans, H, 0.5 * jnp.sum(r**2))


def pose_marginal_covariance(hessian: jax.Array, idx, damping: float = 1e-12):
    """(6, 6) marginal covariance of pose ``idx`` from a pose-window normal
    matrix — the 6-dof analog of :func:`marginal_covariance`."""
    n = hessian.shape[0]
    Hinv = jnp.linalg.inv(hessian + damping * jnp.eye(n, dtype=hessian.dtype))
    s = idx * 6
    return jax.lax.dynamic_slice(Hinv, (s, s), (6, 6))


def marginal_covariance(hessian: jax.Array, idx, damping: float = 1e-12):
    """Marginal covariance of state ``idx``: the corresponding 15x15 block of
    H^-1 (what iSAM2's marginalCovariance returns for the pose sub-block,
    run/pipeline.cpp:753). Returns the (15, 15) block; pose part is [:6, :6]."""
    n = hessian.shape[0]
    Hinv = jnp.linalg.inv(hessian + damping * jnp.eye(n, dtype=hessian.dtype))
    s = idx * STATE_DIM
    return jax.lax.dynamic_slice(Hinv, (s, s), (STATE_DIM, STATE_DIM))
