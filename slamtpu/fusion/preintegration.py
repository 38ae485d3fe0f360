"""IMU preintegration (Forster et al. / GTSAM CombinedImuFactor semantics).

Array-program replacement for the reference's
``gtsam::PreintegratedCombinedMeasurements`` usage
(/root/reference/run/pipeline_ligo_tc.cpp:323-324, 404, 429-463): the per-scan
INS sample window is integrated with a single ``jax.lax.scan`` over padded,
fixed-length measurement buffers, producing the preintegrated deltas
(dR, dv, dp), their bias Jacobians, and the 15x15 noise covariance used by the
IMU factor.

Error-state ordering throughout: [dtheta(3), dv(3), dp(3), dba(3), dbg(3)].
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import so3
from ..core.se3 import Pose3


class ImuNoise(NamedTuple):
    """Continuous-time noise densities (from slamtpu.ins.ImuConfig /
    config/imu_config_berlin.json)."""

    accel_noise_sigma: jax.Array  # (3,) VRW, m/s^2/sqrt(Hz)
    gyro_noise_sigma: jax.Array  # (3,) ARW, rad/s/sqrt(Hz)
    accel_bias_rw_sigma: jax.Array  # (3,)
    gyro_bias_rw_sigma: jax.Array  # (3,)
    integration_sigma: float = 1e-8  # integration position noise

    @classmethod
    def from_imu_config(cls, cfg) -> "ImuNoise":
        return cls(
            accel_noise_sigma=jnp.asarray(cfg.velocity_random_walk),
            gyro_noise_sigma=jnp.asarray(cfg.angular_random_walk),
            accel_bias_rw_sigma=jnp.asarray(cfg.bias_random_walk_accel),
            gyro_bias_rw_sigma=jnp.asarray(cfg.bias_random_walk_gyro),
        )


class ImuBias(NamedTuple):
    accel: jax.Array  # (3,)
    gyro: jax.Array  # (3,)

    @staticmethod
    def zero(dtype=jnp.float64) -> "ImuBias":
        return ImuBias(jnp.zeros(3, dtype), jnp.zeros(3, dtype))

    def vec(self) -> jax.Array:
        return jnp.concatenate([self.accel, self.gyro])


class PreintegratedImu(NamedTuple):
    """Preintegrated measurements between two keyframes, at linearization
    bias ``bias_hat``."""

    dR: jax.Array  # (3, 3)
    dv: jax.Array  # (3,)
    dp: jax.Array  # (3,)
    dt: jax.Array  # () total integration time
    # bias Jacobians (first-order correction, Forster eq. 44)
    dR_dbg: jax.Array  # (3, 3)
    dv_dba: jax.Array  # (3, 3)
    dv_dbg: jax.Array  # (3, 3)
    dp_dba: jax.Array  # (3, 3)
    dp_dbg: jax.Array  # (3, 3)
    cov: jax.Array  # (15, 15) in [dtheta, dv, dp, dba, dbg]
    bias_hat: ImuBias


class NavState(NamedTuple):
    """Pose + velocity (gtsam::NavState)."""

    pose: Pose3
    vel: jax.Array  # (3,) world frame


def integrate(
    accel: jax.Array,  # (N, 3) measured specific force, body frame
    gyro: jax.Array,  # (N, 3) measured angular rate, body frame
    dts: jax.Array,  # (N,) per-sample dt; 0 entries are padding no-ops
    bias: ImuBias,
    noise: ImuNoise,
) -> PreintegratedImu:
    """Integrate a (padded) window of IMU samples with bias correction,
    propagating bias Jacobians and the full 15x15 covariance."""
    dtype = accel.dtype
    I3 = jnp.eye(3, dtype=dtype)

    def step(carry, inp):
        (dR, dv, dp, T, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, cov) = carry
        a_m, w_m, dt = inp
        a = a_m - bias.accel
        w = w_m - bias.gyro
        dt = dt.astype(dtype)
        dt2 = dt * dt

        dRk = so3.exp(w * dt)  # body rotation increment
        Jr = so3.left_jacobian(-w * dt)  # right Jacobian of Exp at (w dt)
        a_hat = so3.hat(a)
        dRa = dR @ a_hat  # dR * hat(a)

        # State propagation
        dp_n = dp + dv * dt + 0.5 * (dR @ a) * dt2
        dv_n = dv + (dR @ a) * dt
        dR_n = dR @ dRk

        # Bias Jacobian propagation (Forster supplementary eqs.)
        dp_dba_n = dp_dba + dv_dba * dt - 0.5 * dR * dt2
        dp_dbg_n = dp_dbg + dv_dbg * dt - 0.5 * dRa @ dR_dbg * dt2
        dv_dba_n = dv_dba - dR * dt
        dv_dbg_n = dv_dbg - dRa @ dR_dbg * dt
        dR_dbg_n = dRk.T @ dR_dbg - Jr * dt

        # Covariance propagation: x = [dtheta, dv, dp, dba, dbg]
        A = jnp.zeros((15, 15), dtype)
        A = A.at[0:3, 0:3].set(dRk.T)
        A = A.at[0:3, 12:15].set(-Jr * dt)
        A = A.at[3:6, 0:3].set(-dRa * dt)
        A = A.at[3:6, 3:6].set(I3)
        A = A.at[3:6, 9:12].set(-dR * dt)
        A = A.at[6:9, 0:3].set(-0.5 * dRa * dt2)
        A = A.at[6:9, 3:6].set(I3 * dt)
        A = A.at[6:9, 6:9].set(I3)
        A = A.at[6:9, 9:12].set(-0.5 * dR * dt2)
        A = A.at[9:12, 9:12].set(I3)
        A = A.at[12:15, 12:15].set(I3)

        safe_dt = jnp.maximum(dt, 1e-12)
        sg = (noise.gyro_noise_sigma.astype(dtype) ** 2) / safe_dt
        sa = (noise.accel_noise_sigma.astype(dtype) ** 2) / safe_dt
        sba = (noise.accel_bias_rw_sigma.astype(dtype) ** 2) * safe_dt
        sbg = (noise.gyro_bias_rw_sigma.astype(dtype) ** 2) * safe_dt
        si = jnp.full((3,), noise.integration_sigma**2, dtype) * safe_dt

        Q = jnp.zeros((15, 15), dtype)
        Q = Q.at[0:3, 0:3].set(Jr @ jnp.diag(sg) @ Jr.T * dt2)
        Q = Q.at[3:6, 3:6].set(dR @ jnp.diag(sa) @ dR.T * dt2)
        Q = Q.at[6:9, 6:9].set(
            0.25 * dR @ jnp.diag(sa) @ dR.T * dt2 * dt2 + jnp.diag(si)
        )
        Q = Q.at[9:12, 9:12].set(jnp.diag(sba))
        Q = Q.at[12:15, 12:15].set(jnp.diag(sbg))

        cov_n = A @ cov @ A.T + Q

        # Padding no-op: dt == 0 leaves the carry unchanged (A, Q both
        # degenerate to identity/zero because every dt factor vanishes, but
        # guard explicitly for clarity and to stop 1/dt noise terms).
        is_pad = dt <= 0.0
        out = (
            jnp.where(is_pad, dR, dR_n),
            jnp.where(is_pad, dv, dv_n),
            jnp.where(is_pad, dp, dp_n),
            jnp.where(is_pad, T, T + dt),
            jnp.where(is_pad, dR_dbg, dR_dbg_n),
            jnp.where(is_pad, dv_dba, dv_dba_n),
            jnp.where(is_pad, dv_dbg, dv_dbg_n),
            jnp.where(is_pad, dp_dba, dp_dba_n),
            jnp.where(is_pad, dp_dbg, dp_dbg_n),
            jnp.where(is_pad, cov, cov_n),
        )
        return out, None

    Z3 = jnp.zeros((3, 3), dtype)
    init = (
        I3,
        jnp.zeros(3, dtype),
        jnp.zeros(3, dtype),
        jnp.asarray(0.0, dtype),
        Z3,
        Z3,
        Z3,
        Z3,
        Z3,
        jnp.zeros((15, 15), dtype),
    )
    carry, _ = jax.lax.scan(step, init, (accel, gyro, dts))
    (dR, dv, dp, T, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, cov) = carry
    return PreintegratedImu(
        dR, dv, dp, T, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, cov, bias
    )


def bias_corrected_deltas(pim: PreintegratedImu, bias: ImuBias):
    """First-order bias correction of the preintegrated deltas."""
    dba = bias.accel - pim.bias_hat.accel
    dbg = bias.gyro - pim.bias_hat.gyro
    dR = pim.dR @ so3.exp(pim.dR_dbg @ dbg)
    dv = pim.dv + pim.dv_dba @ dba + pim.dv_dbg @ dbg
    dp = pim.dp + pim.dp_dba @ dba + pim.dp_dbg @ dbg
    return dR, dv, dp


def predict(
    state: NavState, bias: ImuBias, pim: PreintegratedImu, gravity: jax.Array
) -> NavState:
    """Propagate a NavState through the preintegrated window
    (gtsam PreintegratedCombinedMeasurements::predict,
    run/pipeline_ligo_tc.cpp:453)."""
    dR, dv, dp = bias_corrected_deltas(pim, bias)
    Ri = state.pose.rot
    t = pim.dt
    p_j = state.pose.trans + state.vel * t + 0.5 * gravity * t * t + Ri @ dp
    v_j = state.vel + gravity * t + Ri @ dv
    R_j = Ri @ dR
    return NavState(Pose3(R_j, p_j), v_j)


def residual(
    state_i: NavState,
    bias_i: ImuBias,
    state_j: NavState,
    pim: PreintegratedImu,
    gravity: jax.Array,
) -> jax.Array:
    """9-dof preintegration residual [r_R, r_v, r_p] (Forster eq. 45)."""
    dR, dv, dp = bias_corrected_deltas(pim, bias_i)
    Ri_T = state_i.pose.rot.T
    t = pim.dt
    r_R = so3.log(dR.T @ (Ri_T @ state_j.pose.rot))
    r_v = Ri_T @ (state_j.vel - state_i.vel - gravity * t) - dv
    r_p = (
        Ri_T
        @ (
            state_j.pose.trans
            - state_i.pose.trans
            - state_i.vel * t
            - 0.5 * gravity * t * t
        )
        - dp
    )
    return jnp.concatenate([r_R, r_v, r_p])
