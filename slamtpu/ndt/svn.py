"""Stein-Variational-Newton NDT registration: a pose posterior.

Re-design of ``svn_ndt::SvnNormalDistributionsTransform::align``
(/root/reference/extern/svn_ndt/include/svn_ndt_impl.hpp:674-964). The K
particles become a batch axis handled by ``jax.vmap`` — the reference's
OpenMP stage-1/stage-2 fan-outs collapse into batched einsums:

  stage 1: vmap of the fused NDT objective over K particle poses
  stage 2: K x K SE(3) RBF kernel matrix in tangent space
           (svn_ndt_impl.hpp:213-244), kernel-averaged force phi* and
           PSD-regularized H~, batched 6x6 solves
  stage 3: batched retract with step size epsilon

One difference by design: particle gradients/Hessians are computed directly
in the GTSAM tangent at each particle (right perturbation), so no
NDT<->GTSAM permutation matrix is needed (the reference permutes Euler-space
derivatives at svn_ndt_impl.hpp:731-736,800-805, which is only first-order
correct). Convergence and the posterior mean/covariance finalization follow
the reference exactly (:862-949): tangent-space mean at the prior, sample
covariance of Logmaps at the final mean, eigenvalue floor 1e-9.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import linalg, se3
from ..core.se3 import Pose3
from ..mapping import voxel
from ..mapping.gaussian_map import GaussianMap
from . import objective
from .constants import gauss_constants

# Particle initialization sigmas around the prior, GTSAM tangent order
# [omega_x, omega_y, omega_z, v_x, v_y, v_z] (svn_ndt_impl.hpp:710-716).
INIT_SIGMAS = (0.01, 0.01, 0.02, 0.05, 0.05, 0.05)


class SvnConfig(NamedTuple):
    resolution: float = 1.0
    outlier_ratio: float = 0.55
    num_particles: int = 20
    max_iterations: int = 100
    kernel_h: float = 5.0
    step_size: float = 0.05
    stop_thresh: float = 1e-4
    use_direct1: bool = False
    hess_lambda: float = 1e-6  # per-particle NDT Hessian Tikhonov (":650")
    svn_hess_lambda: float = 1e-6  # H~ regularization (":819")
    cov_eig_floor: float = 1e-9  # final covariance floor (":931")
    shared_gather: bool = True  # one voxel gather at the mean pose for all K
    #   particles (exact when the particle spread << resolution, which the
    #   init sigmas guarantee; set False for strict per-particle DIRECT7)
    kd_radius: float = 0.0  # KDTREE search mode: centroid-distance gate (see
    #   ndt.newton.NewtonConfig.kd_radius); pair with build_regmap_kdtree
    polish_iters: int = 0  # extra Newton steps on the particle MEAN after the
    #   SVN flow. The Stein kernel's repulsion term spreads particles over the
    #   posterior, so their mean is a posterior-mean estimate, not the MAP —
    #   its error is ~sigma/sqrt(K) (cm-class at K=20). A short Newton descent
    #   from the mean publishes the MODE at negligible cost (one extra gather)
    #   while the covariance still comes from the particle spread. 0 keeps the
    #   reference's exact publish semantics (svn_ndt_impl.hpp:862-899).
    polish_from: str = "prior"  # "prior" | "mean": polish start point. The
    #   Stein flow's mean wanders with the posterior's flat directions (445 mm
    #   measured at Berlin scale vs a 0.02 mm prior), so descending from the
    #   PRIOR publishes a strictly better mode whenever the prior is sane —
    #   the reference itself publishes the INS pose for the same reason
    #   (run/pipeline_lo_svn.cpp:388-390). "mean" polishes the particle mean
    #   (useful when the prior is degraded, e.g. GNSS denial).
    polish_pre_iters: int = 6  # "gicp_aniso" polish only: fused-NDT Newton
    #   contraction steps BEFORE the aniso stage. The SVN mean sits ~them
    #   far from the mode (measured 75 mm at kernel_h=5: kval ~= 1 for all
    #   pairs, so the flow is consensus dynamics that never contracts the
    #   init spread), and the aniso GN converges slowly from that far out;
    #   NDT Newton contracts fast and cheaply, the aniso stage then needs
    #   only polish_iters steps for its accuracy (20 -> ~9 mm in 2).
    polish_objective: str = "ndt"  # "ndt" | "gicp_aniso": objective the
    #   polish descends. "gicp_aniso" is plane-to-plane GICP against the
    #   RegMap's aux payload (plane-regularized target covariances) with the
    #   source scan's own per-point covariances — NDT's view-dependent
    #   surface bias is its dominant residual (measured 13.8 -> 5.1 mm on
    #   the sim world from an exact init), so the posterior comes from the
    #   NDT particle flow and the published mode from the GICP geometry.
    #   Requires svn_align_reg(..., src_cov=...) and a RegMap built with
    #   aux_payload=[mean, plane-regularized cov].


class SvnResult(NamedTuple):
    pose: Pose3  # posterior mean
    covariance: jax.Array  # (6, 6) posterior covariance in the tangent at pose
    iterations: jax.Array  # () int32
    converged: jax.Array  # () bool
    particles: Pose3  # (K,) final particle poses
    score: jax.Array = 0.0  # () objective at the published pose — (plain-float
    #   default: a jnp default would initialize a backend at import time,
    #   tests/test_import_hygiene.py; every code path sets it explicitly) —
    #   the reference's per-keyframe convergence-health signal
    #   (run/pipeline_lo_svn.cpp:418-447 logging). With polish enabled it is
    #   the last polish step's evaluation (pre-retract — the same contract as
    #   newton_align_fused); without polish, one extra evaluation at the mean.


def _pairwise_kernel(particles: Pose3, kernel_h: float):
    """K x K RBF kernel and its gradient in SE(3) tangent space.

    k[l, k] = exp(-||Log(T_l^-1 T_k)||^2 / h);
    grad[l, k] = k[l,k] * (-2/h) * Log(T_l^-1 T_k).
    """
    inv = se3.inverse(particles)
    rel = se3.compose(
        Pose3(inv.rot[:, None], inv.trans[:, None]),
        Pose3(particles.rot[None, :], particles.trans[None, :]),
    )
    diff = se3.logmap(rel)  # (K, K, 6)
    sq = jnp.sum(diff * diff, axis=-1)
    kval = jnp.exp(-sq / kernel_h)
    kgrad = kval[..., None] * (-2.0 / kernel_h) * diff
    return kval, kgrad


def svn_align(
    points: jax.Array,
    mask: jax.Array,
    gmap: GaussianMap,
    prior: Pose3,
    rng_key: jax.Array,
    cfg: SvnConfig = SvnConfig(),
) -> SvnResult:
    """SVN-NDT alignment returning a pose posterior (mean + 6x6 covariance)."""
    d1, d2, _ = gauss_constants(cfg.resolution, cfg.outlier_ratio)
    offsets = voxel.DIRECT1_OFFSETS if cfg.use_direct1 else voxel.DIRECT7_OFFSETS

    def obj_fn(pose):
        return objective.score_grad_hess(
            points, mask, pose, gmap, d1, d2, offsets, cfg.hess_lambda
        )

    return _svn_loop(lambda _mean: obj_fn, points.dtype, prior, rng_key, cfg)


def svn_align_reg(
    points: jax.Array,
    mask: jax.Array,
    regmap,
    prior: Pose3,
    rng_key: jax.Array,
    cfg: SvnConfig = SvnConfig(),
    grid_shape: tuple = (256, 256, 64),
    src_cov: jax.Array = None,  # (N, 3, 3), polish_objective == "gicp_aniso"
) -> SvnResult:
    """SVN-NDT on the search-free RegMap layout (slamtpu.ndt.regmap).

    With ``cfg.shared_gather`` (default), the per-point voxel gather runs
    once per iteration at the current particle MEAN; every particle reuses
    those Gaussians — a K-fold reduction of the gather-bound stage-1 cost.
    Exact whenever the particle spread stays within the DIRECT7 window
    (init sigmas 0.01-0.05 vs >= 0.5 m voxels)."""
    from . import regmap as regmap_mod

    d1, d2, _ = gauss_constants(cfg.resolution, cfg.outlier_ratio)

    from .pallas_math import fused_objective, gather_megaT, pair_math_impl

    # the kernel path gathers float32 mega rows; the plain path keeps the
    # points' dtype (float64 in the CPU tests)
    use_kernel = pair_math_impl() == "kernel"
    if use_kernel:
        ptsT = points.T

    if cfg.shared_gather and use_kernel:

        def make_obj(mean_pose):
            megaT = gather_megaT(
                points, mask, mean_pose, regmap, grid_shape,
                kd_radius=cfg.kd_radius,
            )

            def obj_fn(pose):
                return fused_objective(ptsT, megaT, pose, d1, d2, cfg.hess_lambda)

            return obj_fn

    elif cfg.shared_gather:

        def make_obj(mean_pose):
            _tp, mu, icov, active = regmap_mod.gather_pair_data(
                points, mask, mean_pose, regmap, grid_shape,
                kd_radius=cfg.kd_radius,
            )

            def obj_fn(pose):
                return regmap_mod.score_grad_hess_gathered(
                    points, pose, mu, icov, active, d1, d2, cfg.hess_lambda
                )

            return obj_fn

    else:

        def make_obj(_mean_pose):
            def obj_fn(pose):
                return regmap_mod.score_grad_hess_reg(
                    points, mask, pose, regmap, d1, d2, grid_shape,
                    cfg.hess_lambda, kd_radius=cfg.kd_radius,
                )

            return obj_fn

    polish_make_obj = None
    if cfg.polish_iters > 0 and cfg.polish_objective == "gicp_aniso":
        assert regmap.packed_aux is not None, (
            "polish_objective='gicp_aniso' needs a RegMap built with "
            "aux_payload (plane-regularized covariances)"
        )
        assert src_cov is not None, "pass src_cov (source_point_covariances)"
        from .gicp import score_grad_hess_gicp_aniso_gathered
        from .objective import sanitize_points

        pts_s, _ = sanitize_points(points, mask)

        if use_kernel:
            # fused plane-to-plane kernel: per-pair (C_t + R C_s R^T)^-1 in
            # registers instead of XLA's (N, 7, 3, 3) inversion chain
            N = points.shape[0]
            scovT = src_cov.reshape(N, 9).T.astype(jnp.float32)

            def polish_make_obj(mean_pose):
                megaT_aux = gather_megaT(
                    points, mask, mean_pose, regmap, grid_shape, table="aux"
                )

                def obj_fn(pose):
                    return fused_objective(
                        ptsT, megaT_aux, pose, 0.0, 25.0, cfg.hess_lambda,
                        src_covT=scovT,
                    )

                return obj_fn

        else:

            def polish_make_obj(mean_pose):
                _tp, mu_a, cov_a, act_a = regmap_mod.gather_pair_aux(
                    points, mask, mean_pose, regmap, grid_shape
                )

                def obj_fn(pose):
                    return score_grad_hess_gicp_aniso_gathered(
                        pts_s, src_cov, pose, mu_a, cov_a, act_a,
                        cfg.hess_lambda,
                    )

                return obj_fn

    return _svn_loop(
        make_obj, points.dtype, prior, rng_key, cfg, polish_make_obj
    )


def _svn_loop(
    make_obj,
    dtype,
    prior: Pose3,
    rng_key: jax.Array,
    cfg: SvnConfig,
    polish_make_obj=None,
) -> SvnResult:
    K = cfg.num_particles
    I6 = jnp.eye(6, dtype=dtype)

    sigmas = jnp.asarray(INIT_SIGMAS, dtype=dtype)
    xi0 = sigmas * jax.random.normal(rng_key, (K, 6), dtype=dtype)
    prior_b = Pose3(
        jnp.broadcast_to(prior.rot, (K, 3, 3)), jnp.broadcast_to(prior.trans, (K, 3))
    )
    particles0 = se3.retract(prior_b, xi0)

    def mean_pose_of(particles):
        xi = se3.local(prior_b, particles)  # (K, 6) tangent at prior
        return se3.retract(prior, jnp.mean(xi, axis=0))

    def cond(state):
        _particles, _mean, it, converged = state
        return (it < cfg.max_iterations) & (~converged)

    def body(state):
        particles, mean_last, it, _converged = state
        # Stage 1: NDT derivatives per particle (batched over K); the
        # objective may share work anchored at the current mean pose.
        # (named scopes land in the op metadata of the compiled program, so a
        # --profile trace decomposes the keyframe by stage — the analog of
        # the reference's per-iteration S1/S2/S3 prints,
        # svn_ndt_impl.hpp:880-891.)
        with jax.named_scope("svn_gather"):
            obj_fn = make_obj(mean_last)

        def eval_particle(pose):
            obj = obj_fn(pose)
            g = jnp.where(
                jnp.all(jnp.isfinite(obj.grad)), obj.grad, jnp.zeros_like(obj.grad)
            )
            H = jnp.where(jnp.all(jnp.isfinite(obj.hess)), obj.hess, I6)
            return g, H

        with jax.named_scope("svn_particle_eval"):
            grads, hessians = jax.vmap(eval_particle)(particles)  # (K,6), (K,6,6)
        # Stage 2: Stein-variational Newton update.
        with jax.named_scope("svn_stein_update"):
            kval, kgrad = _pairwise_kernel(particles, cfg.kernel_h)  # (K,K), (K,K,6)
            phi = (jnp.einsum("lk,la->ka", kval, grads) + jnp.sum(kgrad, axis=0)) / K
            Ht = (
                jnp.einsum("lk,lab->kab", kval * kval, hessians)
                + jnp.einsum("lka,lkb->kab", kgrad, kgrad)
            ) / K
            Ht = Ht + cfg.svn_hess_lambda * I6
            updates = jnp.linalg.solve(Ht, -phi[..., None])[..., 0]  # (K, 6)
            updates = jnp.where(
                jnp.all(jnp.isfinite(updates), axis=-1, keepdims=True), updates, 0.0
            )
        # Stage 3: retract particles.
        with jax.named_scope("svn_retract"):
            particles = se3.retract(particles, cfg.step_size * updates)
            mean_now = mean_pose_of(particles)
            delta = jnp.linalg.norm(se3.local(mean_last, mean_now))
        return particles, mean_now, it + 1, delta < cfg.stop_thresh

    state0 = (particles0, prior, jnp.asarray(0, jnp.int32), jnp.asarray(False))
    particles, mean_pose, iters, converged = jax.lax.while_loop(cond, body, state0)

    score = jnp.asarray(0.0, jnp.float32)
    if cfg.polish_iters > 0:
        # MAP polish: Newton ascent from the particle mean — on the NDT score
        # or on a dedicated polish objective (e.g. plane-to-plane GICP).
        # Each step re-anchors the gather at its own pose (measured:
        # fresh-gather aniso Newton reaches 5 mm in 2 steps from a 25 mm-off
        # start where stale-gather needed >8).
        def polish_step(mk_fn):
            def polish_body(_i, carry):
                pose, _score = carry
                obj = mk_fn(pose)(pose)
                step = jnp.linalg.solve(obj.hess, -obj.grad)
                step = jnp.where(
                    jnp.all(jnp.isfinite(step)), step, jnp.zeros_like(step)
                )
                nrm = jnp.linalg.norm(step)
                # the mean is already near the optimum: a large step means a
                # degenerate Hessian, so clamp hard rather than trust it
                step = step * jnp.minimum(1.0, 0.25 / jnp.maximum(nrm, 1e-30))
                return (
                    se3.retract(pose, step.astype(dtype)),
                    obj.score.astype(jnp.float32),
                )

            return polish_body

        start = prior if cfg.polish_from == "prior" else mean_pose
        if (
            polish_make_obj is not None
            and cfg.polish_pre_iters > 0
            and cfg.polish_from == "mean"
        ):
            # stage 1 (mean start only): contract on the primary (NDT)
            # objective first — the wandered mean needs basin-scale pulls the
            # narrow aniso discs converge slowly on. A "prior" start is
            # already near the mode, and the NDT pre-stage would first walk
            # it to NDT's density-biased optimum (ground-ring aliasing:
            # measured 101 mm at Berlin scale) before aniso pulls it back.
            with jax.named_scope("svn_polish_pre"):
                start, _ = jax.lax.fori_loop(
                    0, cfg.polish_pre_iters, polish_step(make_obj),
                    (start, score),
                )
        with jax.named_scope("svn_polish"):
            mean_pose, score = jax.lax.fori_loop(
                0, cfg.polish_iters, polish_step(polish_make_obj or make_obj),
                (start, score),
            )
    else:
        # no polish: one extra evaluation at the published mean supplies the
        # score (the SVN loop only evaluates particle poses)
        with jax.named_scope("svn_final_score"):
            score = make_obj(mean_pose)(mean_pose).score.astype(jnp.float32)

    # Posterior covariance: sample covariance of tangents at the final mean
    # (svn_ndt_impl.hpp:903-949), eigenvalue-floored.
    with jax.named_scope("svn_posterior"):
        mean_b = Pose3(
            jnp.broadcast_to(mean_pose.rot, (K, 3, 3)),
            jnp.broadcast_to(mean_pose.trans, (K, 3)),
        )
        tangents = se3.local(mean_b, particles)  # (K, 6)
        if K > 1:
            centered = tangents - jnp.mean(tangents, axis=0, keepdims=True)
            cov = centered.T @ centered / (K - 1)
        else:
            cov = jnp.diag(1e-6 * sigmas**2)
        cov = linalg.eig_floor_psd(cov, cfg.cov_eig_floor)
    return SvnResult(mean_pose, cov, iters, converged, particles, score)
