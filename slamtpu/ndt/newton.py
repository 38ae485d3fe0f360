"""Newton / Gauss-Newton P2D-NDT registration as a jittable while_loop.

Array-program replacement for the ndt_omp Newton optimizer the reference builds
its odometry on (/root/reference/run/pipeline.cpp:464-481,557-604): fixed
maximum iteration count, convergence masking instead of data-dependent exit,
and the final Hessian returned so callers can derive a pose covariance from
-(H + eps I)^-1 exactly like run/pipeline.cpp:594-603 does.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se3
from ..core.se3 import Pose3
from ..mapping import voxel
from ..mapping.gaussian_map import GaussianMap
from . import objective
from .constants import gauss_constants


class NewtonConfig(NamedTuple):
    resolution: float = 1.0
    outlier_ratio: float = 0.55
    max_iterations: int = 50
    trans_eps: float = 1e-4  # convergence threshold on |step| (register_config.json)
    step_size: float = 1.0
    max_step_norm: float = 1.0  # trust-region style clamp on the Newton step
    use_direct1: bool = False
    hess_lambda: float = 1e-6
    # Prior-pose regularization (the ndt_omp setRegularizationPose /
    # setRegularizationScaleFactor capability the tightly-coupled pipeline
    # relies on, /root/reference/run/pipeline_ligo_tc.cpp:293,531): a
    # quadratic tangent-space penalty 0.5*w*|Log(reg_pose^-1 pose)|^2 pulling
    # the optimum toward the (IMU-predicted) prior, with w = reg_weight *
    # n_contrib so the knob is scale-free in the number of contributing
    # point-voxel pairs. 0 disables the term. (ndt_omp's exact normalization
    # is unverifiable here — the submodule content is absent from the
    # reference snapshot — so the per-pair weighting is our definition.)
    reg_weight: float = 0.0
    # fused path: cumulative motion since the last mega-row gather at which
    # inner-step reuse freezes and the next outer iteration re-gathers, as a
    # fraction of the resolution. Small values are safest on maps with thin
    # high-certainty voxels (staleness flips their pull); larger values cut
    # gather counts on benign maps. One voxel is the default: DIRECT7's +-1
    # neighbor window absorbs a single-cell misassignment, and the bench
    # accuracy gates arbitrate (measured: 0.25 costs ~30%% of throughput for
    # ~1 mm on the headline; hard scenes are governed by the applied-step
    # iteration budget and the apps' inner_iters=2 default instead).
    gather_stale_frac: float = 1.0
    # GICP engine only: Euclidean correspondence-distance gate in meters
    # (the reference's gicp_corr_dist_threshold; voxel correspondences are
    # <= ~1.5x resolution away, so the 5 m default is inactive by design)
    gicp_max_corr_dist: float = 5.0
    # GICP engine only: plane-to-plane mode with per-point source covariances
    # from the source scan's own voxel stats (gicp_omp's defining feature);
    # False keeps the fast isotropic sigma^2 I fusion baked into the map
    gicp_aniso: bool = False
    # KDTREE search mode (voxel_grid_covariance_impl.hpp:443-554): > 0 gates
    # each candidate leaf on |point - centroid| <= kd_radius (the reference
    # radius-searches leaf centroids at radius = resolution). Pair with a
    # RegMap from build_regmap_kdtree, whose slots hold the 27-neighborhood's
    # nearest leaves instead of DIRECT7's face neighbors. 0 = DIRECT7/1.
    kd_radius: float = 0.0


class NewtonResult(NamedTuple):
    pose: Pose3
    hessian: jax.Array  # (6, 6) GN Hessian of the score at the final pose
    score: jax.Array  # ()
    iterations: jax.Array  # () int32
    converged: jax.Array  # () bool
    n_contrib: jax.Array  # () int32


def newton_align(
    points: jax.Array,
    mask: jax.Array,
    gmap: GaussianMap,
    init_pose: Pose3,
    cfg: NewtonConfig = NewtonConfig(),
    reg_pose: Pose3 = None,
) -> NewtonResult:
    """Align a source scan to the Gaussian map starting from ``init_pose``.

    The NDT score is *maximized*; near the optimum the GN Hessian of the score
    is negative definite, so the Newton step solve(H, -g) moves uphill — the
    same sign convention as the reference SVN stage-2 solve
    (svn_ndt_impl.hpp:833-839).

    ``reg_pose`` (with ``cfg.reg_weight > 0``) adds the prior-pose
    regularization term (see NewtonConfig).
    """
    d1, d2, _ = gauss_constants(cfg.resolution, cfg.outlier_ratio)
    offsets = voxel.DIRECT1_OFFSETS if cfg.use_direct1 else voxel.DIRECT7_OFFSETS

    def eval_obj(pose):
        return objective.score_grad_hess(
            points, mask, pose, gmap, d1, d2, offsets, cfg.hess_lambda
        )

    return _newton_loop(eval_obj, points.dtype, init_pose, cfg, reg_pose)


def newton_align_reg(
    points: jax.Array,
    mask: jax.Array,
    regmap,
    init_pose: Pose3,
    cfg: NewtonConfig = NewtonConfig(),
    grid_shape: tuple = (256, 256, 64),
    reg_pose: Pose3 = None,
) -> NewtonResult:
    """Newton alignment on the search-free RegMap layout (slamtpu.ndt.regmap)."""
    from . import regmap as regmap_mod

    d1, d2, _ = gauss_constants(cfg.resolution, cfg.outlier_ratio)

    def eval_obj(pose):
        return regmap_mod.score_grad_hess_reg(
            points, mask, pose, regmap, d1, d2, grid_shape, cfg.hess_lambda,
            kd_radius=cfg.kd_radius,
        )

    return _newton_loop(eval_obj, points.dtype, init_pose, cfg, reg_pose)


def regularize_step(pose: Pose3, grad, hess, n_contrib, cfg: NewtonConfig, reg_pose):
    """Add the prior-pose quadratic penalty to (grad, hess) — shared by the
    XLA and fused-Pallas Newton loops. No-op when reg_weight == 0 or no
    reg_pose is given (resolved at trace time).

    Sign convention: the NDT score is MAXIMIZED (H negative definite), so the
    augmented objective is score - 0.5*w*|xi|^2 and the penalty SUBTRACTS:
    grad - w*xi, hess - w*I. (The stationary point is then the correct MAP
    blend solve(H - wI, ...) and the system stays definite for any w; with
    the signs flipped the "pull" provably repels at moderate w — caught by a
    toy-quadratic check: data optimum 1.0, prior 0, h=4, w=1 must give 0.8.)"""
    if reg_pose is None or cfg.reg_weight <= 0.0:
        return grad, hess
    dtype = grad.dtype
    w = jnp.asarray(cfg.reg_weight, dtype) * jnp.maximum(n_contrib, 1).astype(dtype)
    xi = se3.local(se3.cast(reg_pose, dtype), se3.cast(pose, dtype))
    return grad - w * xi, hess - w * jnp.eye(6, dtype=dtype)


def _newton_loop(
    eval_obj, dtype, init_pose: Pose3, cfg: NewtonConfig, reg_pose: Pose3 = None
) -> NewtonResult:
    def cond(state):
        pose, it, converged, *_ = state
        return (it < cfg.max_iterations) & (~converged)

    def body(state):
        pose, it, _converged, _score, _hess, _nc = state
        obj = eval_obj(pose)
        grad, hess = regularize_step(
            pose, obj.grad, obj.hess, obj.n_contrib, cfg, reg_pose
        )
        step = jnp.linalg.solve(hess, -grad)
        step = jnp.where(jnp.all(jnp.isfinite(step)), step, jnp.zeros_like(step))
        norm = jnp.linalg.norm(step)
        scale = jnp.where(
            norm > cfg.max_step_norm, cfg.max_step_norm / jnp.maximum(norm, 1e-30), 1.0
        )
        step = (cfg.step_size * scale) * step
        new_pose = se3.retract(pose, step.astype(dtype))
        converged = jnp.linalg.norm(step) < cfg.trans_eps
        return (new_pose, it + 1, converged, obj.score, obj.hess, obj.n_contrib)

    zero6 = jnp.zeros((6, 6), dtype=dtype)
    init_state = (
        init_pose,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(0.0, dtype),
        zero6,
        jnp.asarray(0, jnp.int32),
    )
    pose, iters, converged, _, _, _ = jax.lax.while_loop(cond, body, init_state)
    # Final evaluation at the converged pose (score/Hessian for the caller).
    obj = eval_obj(pose)
    return NewtonResult(pose, obj.hess, obj.score, iters, converged, obj.n_contrib)
