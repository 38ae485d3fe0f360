"""Fixed-capacity factor graph over a sliding window of nav states.

Re-design of the reference's GTSAM usage: instead of an incremental iSAM2
Bayes tree (/root/reference/run/pipeline.cpp:486-489, 738-741 — a poor fit
for XLA), the window is re-solved every keyframe by dense Gauss-Newton
(slamtpu.fusion.smoother). Window sizes are <= ~32 states, so the normal
equations are a few-hundred-dof dense solve — cheap on the device and exactly
what iSAM2 approximates incrementally.

State per node: pose (SE(3)) + velocity (3) + IMU bias (6) = 15 tangent dofs,
ordered [dtheta, dv_pose?, ...] -> concretely [pose(6: omega,v), vel(3),
bias(6)]. Factors are stored in fixed-capacity padded arrays with active
masks; residuals of inactive slots are zeroed so jit shapes never change.

Factor types (parity with the reference graphs):
- prior_pose:  INS pose prior with trust-gain scheduling (pipeline.cpp:637-665)
- between:     LiDAR NDT between-factor (pipeline.cpp:594-604)
- prior_vel / prior_bias: init priors (pipeline_ligo_tc.cpp:365-404)
- imu:         CombinedImuFactor equivalent (15-dof residual incl. bias walk,
               pipeline_ligo_tc.cpp:459-463)
- position:    GPS/position factor scaffold (pipeline_ligo_tc.cpp:544-576)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se3
from ..core.se3 import Pose3
from .preintegration import ImuBias, NavState, PreintegratedImu, residual as imu_residual


class WindowState(NamedTuple):
    """W nav states (padded; ``active`` marks real ones)."""

    rot: jax.Array  # (W, 3, 3)
    trans: jax.Array  # (W, 3)
    vel: jax.Array  # (W, 3)
    bias: jax.Array  # (W, 6) [accel(3), gyro(3)]
    active: jax.Array  # (W,) bool

    @property
    def window(self) -> int:
        return self.trans.shape[0]

    def pose(self, idx=None) -> Pose3:
        if idx is None:
            return Pose3(self.rot, self.trans)
        return Pose3(self.rot[idx], self.trans[idx])

    def nav_state(self, idx) -> NavState:
        return NavState(self.pose(idx), self.vel[idx])

    def imu_bias(self, idx) -> ImuBias:
        return ImuBias(self.bias[idx, :3], self.bias[idx, 3:])

    def retract(self, delta: jax.Array) -> "WindowState":
        """delta: (W, 15) = [pose xi(6), dvel(3), dbias(6)]."""
        new_pose = se3.retract(Pose3(self.rot, self.trans), delta[:, :6])
        return WindowState(
            new_pose.rot,
            new_pose.trans,
            self.vel + delta[:, 6:9],
            self.bias + delta[:, 9:15],
            self.active,
        )

    @staticmethod
    def identity(window: int, dtype=jnp.float64) -> "WindowState":
        return WindowState(
            jnp.broadcast_to(jnp.eye(3, dtype=dtype), (window, 3, 3)),
            jnp.zeros((window, 3), dtype),
            jnp.zeros((window, 3), dtype),
            jnp.zeros((window, 6), dtype),
            jnp.zeros((window,), bool),
        )


class PriorPoseFactors(NamedTuple):
    idx: jax.Array  # (F,) int32
    rot: jax.Array  # (F, 3, 3)
    trans: jax.Array  # (F, 3)
    sqrt_info: jax.Array  # (F, 6, 6)
    active: jax.Array  # (F,) bool


class BetweenFactors(NamedTuple):
    i: jax.Array  # (F,)
    j: jax.Array  # (F,)
    rot: jax.Array  # (F, 3, 3) measured relative pose i->j
    trans: jax.Array  # (F, 3)
    sqrt_info: jax.Array  # (F, 6, 6)
    active: jax.Array


class VecPriorFactors(NamedTuple):
    """Prior on velocity (dim 3) or bias (dim 6)."""

    idx: jax.Array
    value: jax.Array  # (F, d)
    sqrt_info: jax.Array  # (F, d, d)
    active: jax.Array


class ImuFactors(NamedTuple):
    """Preintegrated IMU factors between consecutive window states.

    ``pim`` fields are stacked over F. 15-dof residual
    [rR, rv, rp, rba, rbg]; sqrt_info from the preintegration covariance."""

    i: jax.Array  # (F,) connects i -> i+1... stored explicitly as (i, j)
    j: jax.Array
    dR: jax.Array  # (F, 3, 3)
    dv: jax.Array  # (F, 3)
    dp: jax.Array  # (F, 3)
    dt: jax.Array  # (F,)
    dR_dbg: jax.Array  # (F, 3, 3)
    dv_dba: jax.Array
    dv_dbg: jax.Array
    dp_dba: jax.Array
    dp_dbg: jax.Array
    bias_hat: jax.Array  # (F, 6)
    sqrt_info: jax.Array  # (F, 15, 15)
    active: jax.Array


class PositionFactors(NamedTuple):
    idx: jax.Array
    value: jax.Array  # (F, 3) measured position
    sqrt_info: jax.Array  # (F, 3, 3)
    active: jax.Array


class Factors(NamedTuple):
    prior_pose: PriorPoseFactors
    between: BetweenFactors
    prior_vel: VecPriorFactors
    prior_bias: VecPriorFactors
    imu: ImuFactors
    position: PositionFactors
    gravity: jax.Array  # (3,) world gravity vector for IMU factors


def empty_factors(
    n_prior: int,
    n_between: int,
    n_vel: int,
    n_bias: int,
    n_imu: int,
    n_pos: int,
    dtype=jnp.float64,
) -> Factors:
    def zeros(*s):
        return jnp.zeros(s, dtype)

    def eye(n, d):
        return jnp.broadcast_to(jnp.eye(d, dtype=dtype), (n, d, d))

    def idx(n):
        return jnp.zeros((n,), jnp.int32)

    def off(n):
        return jnp.zeros((n,), bool)

    return Factors(
        prior_pose=PriorPoseFactors(idx(n_prior), eye(n_prior, 3), zeros(n_prior, 3),
                                    eye(n_prior, 6), off(n_prior)),
        between=BetweenFactors(idx(n_between), idx(n_between), eye(n_between, 3),
                               zeros(n_between, 3), eye(n_between, 6), off(n_between)),
        prior_vel=VecPriorFactors(idx(n_vel), zeros(n_vel, 3), eye(n_vel, 3), off(n_vel)),
        prior_bias=VecPriorFactors(idx(n_bias), zeros(n_bias, 6), eye(n_bias, 6), off(n_bias)),
        imu=ImuFactors(idx(n_imu), idx(n_imu), eye(n_imu, 3), zeros(n_imu, 3),
                       zeros(n_imu, 3), zeros(n_imu), eye(n_imu, 3), eye(n_imu, 3),
                       eye(n_imu, 3), eye(n_imu, 3), eye(n_imu, 3), zeros(n_imu, 6),
                       eye(n_imu, 15), off(n_imu)),
        position=PositionFactors(idx(n_pos), zeros(n_pos, 3), eye(n_pos, 3), off(n_pos)),
        gravity=jnp.asarray([0.0, 0.0, 9.81], dtype),
    )


def _apply_sqrt_info(sqrt_info, r, active):
    w = jnp.einsum("fij,fj->fi", sqrt_info, r)
    return jnp.where(active[:, None], w, 0.0)


def residuals(state: WindowState, factors: Factors) -> jax.Array:
    """Stacked weighted residual vector (fixed length)."""
    out = []

    fp = factors.prior_pose
    x = se3.Pose3(state.rot[fp.idx], state.trans[fp.idx])
    prior = se3.Pose3(fp.rot, fp.trans)
    r = se3.local(prior, x)  # gtsam PriorFactor error: Local(prior, x)
    out.append(_apply_sqrt_info(fp.sqrt_info, r, fp.active).ravel())

    fb = factors.between
    xi = se3.Pose3(state.rot[fb.i], state.trans[fb.i])
    xj = se3.Pose3(state.rot[fb.j], state.trans[fb.j])
    meas = se3.Pose3(fb.rot, fb.trans)
    r = se3.local(meas, se3.between(xi, xj))
    out.append(_apply_sqrt_info(fb.sqrt_info, r, fb.active).ravel())

    fv = factors.prior_vel
    r = state.vel[fv.idx] - fv.value
    out.append(_apply_sqrt_info(fv.sqrt_info, r, fv.active).ravel())

    fbias = factors.prior_bias
    r = state.bias[fbias.idx] - fbias.value
    out.append(_apply_sqrt_info(fbias.sqrt_info, r, fbias.active).ravel())

    fi = factors.imu
    if fi.i.shape[0] > 0:
        def one_imu(k):
            pim = PreintegratedImu(
                fi.dR[k], fi.dv[k], fi.dp[k], fi.dt[k], fi.dR_dbg[k], fi.dv_dba[k],
                fi.dv_dbg[k], fi.dp_dba[k], fi.dp_dbg[k], jnp.zeros((15, 15)),
                ImuBias(fi.bias_hat[k, :3], fi.bias_hat[k, 3:]),
            )
            si = state.nav_state(fi.i[k])
            sj = state.nav_state(fi.j[k])
            bi = state.imu_bias(fi.i[k])
            r9 = imu_residual(si, bi, sj, pim, factors.gravity)
            rb = state.bias[fi.j[k]] - state.bias[fi.i[k]]
            return jnp.concatenate([r9, rb])

        r = jax.vmap(one_imu)(jnp.arange(fi.i.shape[0]))
        out.append(_apply_sqrt_info(fi.sqrt_info, r, fi.active).ravel())

    fpos = factors.position
    r = state.trans[fpos.idx] - fpos.value
    out.append(_apply_sqrt_info(fpos.sqrt_info, r, fpos.active).ravel())

    return jnp.concatenate(out)


def sqrt_info_from_cov(cov: jax.Array, jitter: float = 1e-12) -> jax.Array:
    """Upper-triangular whitening matrix S with S^T S = cov^-1 (batched).

    Computed as inv(chol(cov).T)... concretely solve L S = I for lower L and
    use S = L^-1, giving S^T S = cov^-1."""
    d = cov.shape[-1]
    L = jnp.linalg.cholesky(cov + jitter * jnp.eye(d, dtype=cov.dtype))
    eye = jnp.broadcast_to(jnp.eye(d, dtype=cov.dtype), cov.shape)
    return jax.scipy.linalg.solve_triangular(L, eye, lower=True)


def sqrt_info_from_sigmas(sigmas: jax.Array) -> jax.Array:
    """Diagonal whitening from per-dof standard deviations (..., d)."""
    return jax.vmap(jnp.diag)(1.0 / sigmas) if sigmas.ndim == 2 else jnp.diag(1.0 / sigmas)


def reorder_covariance_trans_rot(cov: jax.Array) -> jax.Array:
    """Swap a 6x6 covariance between [trans, rot] and [rot, trans] block order.

    The reference's reorderCovarianceForGTSAM swaps only the diagonal 3x3
    blocks and leaves the off-diagonal cross-covariance blocks in place — a
    bug flagged in SURVEY.md (registercallback.cpp:170-186). This is the
    correct permutation P C P^T with P = [[0, I], [I, 0]]: diagonal blocks
    swap AND the off-diagonal blocks swap (each landing transposed relative
    to the original layout). Involutory: applying it twice returns the input.
    """
    tt = cov[..., :3, :3]
    tr = cov[..., :3, 3:]
    rt = cov[..., 3:, :3]
    rr = cov[..., 3:, 3:]
    top = jnp.concatenate([rr, rt], axis=-1)
    bot = jnp.concatenate([tr, tt], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)
