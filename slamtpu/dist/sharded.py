"""Multi-chip execution: point-axis sharding over a device mesh.

The reference is single-process (SURVEY.md section 2.4: no distributed
backend). This module is the new capability layer: the NDT math is a sum over
point-voxel pairs, so it shards cleanly along the point axis —

- **Map construction**: each chip computes voxel sufficient statistics for
  its point shard (sort + segment-sum, slamtpu.mapping); per-voxel stats are
  merged across chips by an ``all_gather`` of the fixed-capacity stat buffers
  followed by an associative merge (sums of (N, Sx, Sxx) commute).
- **Registration**: the Gaussian map is replicated; each chip evaluates the
  fused NDT objective on its point shard; (score, grad, Hessian) are combined
  with ``psum`` (a 43-float all-reduce per Newton iteration); the 6x6 solve
  and retract run replicated.

Everything is expressed with ``shard_map`` over a named 1-D mesh, so the same
code runs on one card, the cards of one host, or the CPU test mesh. The
pair-math implementation follows the platform of the mesh's devices
(``ndt.pallas_math.pair_math_impl``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map as _shard_map  # jax >= 0.8 (check_vma kwarg)

    def shard_map(f=None, *, mesh, in_specs, out_specs, check_rep=True):
        return _shard_map(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=check_rep
        )
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..core import se3
from ..core.se3 import Pose3
from ..mapping import gaussian_map, voxel
from ..mapping.gaussian_map import GaussianMap, VoxelStats
from ..ndt import gauss_constants
from ..ndt import objective as ndt_objective


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (axis_name,))


def build_map_sharded(
    mesh: Mesh,
    points: jax.Array,  # (N, 3), N divisible by mesh size
    mask: jax.Array,
    origin: jax.Array,
    resolution: float,
    capacity: int,
    min_points_per_voxel: int = 6,
    axis_name: str = "data",
) -> GaussianMap:
    """Build the Gaussian voxel map from points sharded across the mesh."""
    n_dev = mesh.shape[axis_name]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P()),
        out_specs=P(),
        check_rep=False,  # outputs are replicated via all_gather + merge
    )
    def _build(pts, msk, orig):
        local = gaussian_map.stats_from_points(
            pts, msk, orig, jnp.asarray(resolution, pts.dtype), capacity
        )
        # all-gather the fixed-capacity stat buffers, then associatively merge
        keys = jax.lax.all_gather(local.keys, axis_name)  # (D, V)
        n = jax.lax.all_gather(local.n, axis_name)
        sx = jax.lax.all_gather(local.sx, axis_name)
        sxx = jax.lax.all_gather(local.sxx, axis_name)
        ovf = jax.lax.all_gather(local.overflow, axis_name)

        def merge_step(i, acc):
            other = VoxelStats(
                keys[i], n[i], sx[i], sxx[i], acc.origin, acc.resolution, ovf[i]
            )
            return gaussian_map.merge_stats(acc, other, capacity)

        init = VoxelStats(
            keys[0], n[0], sx[0], sxx[0], orig,
            jnp.asarray(resolution, pts.dtype), ovf[0],
        )
        merged = jax.lax.fori_loop(1, n_dev, merge_step, init)
        return gaussian_map.finalize(merged, min_points_per_voxel)

    return _build(points, mask, origin)


def _psum_newton_loop(eval_obj, pose0, dtype, max_iterations, trans_eps):
    """Shared psum-reduced Newton loop for the sharded variants.

    ``eval_obj(pose) -> (score, grad, hess)`` must already be mesh-reduced.
    The final (score, hessian) are RE-EVALUATED at the returned pose — the
    in-loop values belong to the pre-step pose, and callers derive the pose
    covariance from this Hessian (same semantics as ndt.newton._newton_loop).
    """

    def cond(state):
        _pose, it, converged = state
        return (it < max_iterations) & (~converged)

    def body(state):
        pose, it, _conv = state
        _score, grad, hess = eval_obj(pose)
        step = jnp.linalg.solve(hess, -grad)
        step = jnp.where(jnp.all(jnp.isfinite(step)), step, jnp.zeros_like(step))
        norm = jnp.linalg.norm(step)
        scale = jnp.where(norm > 1.0, 1.0 / jnp.maximum(norm, 1e-30), 1.0)
        new_pose = se3.retract(pose, (scale * step).astype(dtype))
        return (new_pose, it + 1, norm * scale < trans_eps)

    state0 = (pose0, jnp.asarray(0, jnp.int32), jnp.asarray(False))
    pose, iters, _conv = jax.lax.while_loop(cond, body, state0)
    score, _grad, hess = eval_obj(pose)
    return pose, hess, score, iters


def newton_align_sharded(
    mesh: Mesh,
    points: jax.Array,  # (N, 3) sharded over the point axis
    mask: jax.Array,
    gmap: GaussianMap,  # replicated
    init_pose: Pose3,  # replicated
    resolution: float = 1.0,
    outlier_ratio: float = 0.55,
    max_iterations: int = 30,
    trans_eps: float = 1e-4,
    hess_lambda: float = 1e-6,
    axis_name: str = "data",
):
    """Scan-to-map Newton NDT with the objective reduced over the mesh.

    Per iteration each chip computes its shard's (score, grad, hess); one
    ``psum`` combines them; the replicated 6x6 solve and retract follow.
    Returns (pose, hessian, score, iterations)."""
    d1, d2, _ = gauss_constants(resolution, outlier_ratio)
    offsets = voxel.DIRECT7_OFFSETS
    dtype = points.dtype

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_rep=False,
    )
    def _align(pts, msk, gmap_rep, pose0):
        def eval_obj(pose):
            obj = ndt_objective.score_grad_hess(
                pts, msk, pose, gmap_rep, d1, d2, offsets, hess_lambda=0.0
            )
            score = jax.lax.psum(obj.score, axis_name)
            grad = jax.lax.psum(obj.grad, axis_name)
            hess = jax.lax.psum(obj.hess, axis_name) + hess_lambda * jnp.eye(6, dtype=dtype)
            return score, grad, hess

        return _psum_newton_loop(eval_obj, pose0, dtype, max_iterations, trans_eps)

    return _align(points, mask, gmap, init_pose)


def newton_align_sharded_reg(
    mesh: Mesh,
    points: jax.Array,  # (N, 3) sharded over the point axis
    mask: jax.Array,
    regmap,  # ndt.regmap.RegMap, replicated
    init_pose: Pose3,
    grid_shape: tuple,
    resolution: float = 1.0,
    outlier_ratio: float = 0.55,
    max_iterations: int = 30,
    trans_eps: float = 1e-4,
    hess_lambda: float = 1e-6,
    axis_name: str = "data",
):
    """Sharded Newton NDT on the search-free RegMap layout (the production
    multi-chip path: each chip runs the dense-grid gathers + pair math on its
    point shard; one psum of (score, grad, Hessian) per iteration).
    Returns (pose, hessian, score, iterations)."""
    from ..ndt import regmap as regmap_mod

    d1, d2, _ = gauss_constants(resolution, outlier_ratio)
    dtype = points.dtype

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_rep=False,
    )
    def _align(pts, msk, rmap, pose0):
        def eval_obj(pose):
            obj = regmap_mod.score_grad_hess_reg(
                pts, msk, pose, rmap, d1, d2, grid_shape, hess_lambda=0.0
            )
            score = jax.lax.psum(obj.score, axis_name)
            grad = jax.lax.psum(obj.grad, axis_name)
            hess = jax.lax.psum(obj.hess, axis_name) + hess_lambda * jnp.eye(
                6, dtype=dtype
            )
            return score, grad, hess

        return _psum_newton_loop(eval_obj, pose0, dtype, max_iterations, trans_eps)

    return _align(points, mask, regmap, init_pose)


def newton_align_sharded_fused(
    mesh: Mesh,
    points: jax.Array,  # (N, 3) float32, sharded over the point axis
    mask: jax.Array,
    regmap,  # ndt.regmap.RegMap, replicated
    init_pose: Pose3,
    grid_shape: tuple,
    resolution: float = 1.0,
    outlier_ratio: float = 0.55,
    max_iterations: int = 30,
    inner_iters: int = 6,
    trans_eps: float = 1e-4,
    hess_lambda: float = 1e-6,
    max_step_norm: float = 1.0,
    gather_stale_frac: float = 0.25,
    axis_name: str = "data",
    block: int = None,
    interpret: bool = False,
):
    """Sharded Newton NDT on the fused pair math: each device gathers mega
    rows and evaluates the pair math on its point shard; one psum of (score,
    grad, Hessian) per Newton step combines them, and each gather is reused
    for ``inner_iters`` steps (the single-device newton_align_fused recipe,
    distributed). Returns (pose, hessian, score, iterations). ``block``
    sizes the kernel's point blocks; ``interpret`` (tests only) runs the
    kernel in the Pallas interpreter."""
    from ..ndt.constants import gauss_constants
    from ..ndt.pallas_math import fused_objective, gather_megaT

    d1, d2, _ = gauss_constants(resolution, outlier_ratio)
    dtype = jnp.float32
    platform = mesh.devices.flat[0].platform

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_rep=False,
    )
    def _align(pts, msk, rmap, pose0):
        ptsT = pts.T.astype(dtype)

        def one_step(pose, megaT):
            obj = fused_objective(
                ptsT, megaT, pose, d1, d2, hess_lambda=0.0, block=block,
                interpret=interpret, platform=platform,
            )
            score = jax.lax.psum(obj.score, axis_name)
            grad = jax.lax.psum(obj.grad, axis_name)
            hess = jax.lax.psum(obj.hess, axis_name) + hess_lambda * jnp.eye(
                6, dtype=dtype
            )
            step = jnp.linalg.solve(hess, -grad)
            step = jnp.where(jnp.all(jnp.isfinite(step)), step, jnp.zeros_like(step))
            norm = jnp.linalg.norm(step)
            scale = jnp.where(
                norm > max_step_norm, max_step_norm / jnp.maximum(norm, 1e-30), 1.0
            )
            step = scale * step
            return se3.retract(pose, step.astype(dtype)), jnp.linalg.norm(step), score, hess

        def cond(state):
            _pose, it, converged, *_ = state
            return (it < max_iterations) & (~converged)

        stale_budget = jnp.asarray(gather_stale_frac * resolution, dtype)

        def body(state):
            pose, it, _conv, _score, _hess = state
            megaT = gather_megaT(pts, msk, pose, rmap, grid_shape)

            def inner(_, carry):
                pose_i, norm_i, s_i, h_i, moved, napp = carry
                new_pose, stepn, s2, h2 = one_step(pose_i, megaT)
                # staleness budget (see ndt.pallas_math.newton_align_fused);
                # frozen steps do not count toward the iteration budget
                ok = moved + stepn <= stale_budget
                pose_o = jax.tree.map(
                    lambda n, o: jnp.where(ok, n, o), new_pose, pose_i
                )
                return (
                    pose_o,
                    jnp.where(ok, stepn, norm_i),
                    jnp.where(ok, s2, s_i),
                    jnp.where(ok, h2, h_i),
                    jnp.where(ok, moved + stepn, moved + stale_budget),
                    napp + jnp.where(ok, 1, 0).astype(jnp.int32),
                )

            pose0, norm0, s0, h0 = one_step(pose, megaT)
            if inner_iters > 1:
                pose_f, norm_f, score, hess, _moved, n_applied = jax.lax.fori_loop(
                    0, inner_iters - 1, inner,
                    (pose0, norm0, s0, h0, norm0, jnp.asarray(1, jnp.int32)),
                )
            else:
                pose_f, norm_f, score, hess = pose0, norm0, s0, h0
                n_applied = jnp.asarray(1, jnp.int32)
            return (pose_f, it + n_applied, norm_f < trans_eps, score, hess)

        state0 = (
            se3.cast(pose0, dtype),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
            jnp.asarray(0.0, dtype),
            jnp.zeros((6, 6), dtype),
        )
        pose, iters, _conv, _score, _hess = jax.lax.while_loop(cond, body, state0)
        # re-evaluate at the RETURNED pose (the loop's values belong to the
        # pre-step pose; callers build the pose covariance from this Hessian)
        megaT = gather_megaT(pts, msk, pose, rmap, grid_shape)
        obj = fused_objective(
            ptsT, megaT, pose, d1, d2, hess_lambda=0.0, block=block,
            interpret=interpret, platform=platform,
        )
        score = jax.lax.psum(obj.score, axis_name)
        hess = jax.lax.psum(obj.hess, axis_name) + hess_lambda * jnp.eye(
            6, dtype=dtype
        )
        return pose, hess, score, iters

    return _align(points, mask, regmap, init_pose)


def lo_train_step(
    mesh: Mesh,
    points: jax.Array,
    mask: jax.Array,
    map_stats: VoxelStats,  # replicated running map sufficient statistics
    pose_guess: Pose3,
    resolution: float,
    capacity: int,
    grid_shape: tuple = (64, 64, 32),
    max_iterations: int = 20,
    inner_iters: int = 4,
    min_points_per_voxel: int = 6,
    block: int | None = None,
    axis_name: str = "data",
    interpret: bool = False,
):
    """One full LiDAR-odometry step over the mesh: register the (sharded)
    scan against the current map, then fold the registered scan's voxel
    statistics back into the map — the incremental-mapping equivalent of the
    reference's per-keyframe setInputTarget rebuild (run/pipeline_lo_svn.cpp:
    376-387), but associative and distributed.

    Registration runs on the production path — finalize the stats, build the
    search-free RegMap layout, and dispatch the fused Pallas pair-math kernel
    per shard with one psum per Newton step (``newton_align_sharded_fused``).
    The searchsorted baseline (``newton_align_sharded``) is kept only as a
    test oracle.

    Returns (pose, hessian, score, iterations, new_map_stats)."""
    from ..ndt.regmap import build_regmap

    gmap = gaussian_map.finalize(map_stats, min_points_per_voxel)
    rmap = build_regmap(gmap, grid_shape=grid_shape)
    pose, hess, score, iters = newton_align_sharded_fused(
        mesh,
        points,
        mask,
        rmap,
        pose_guess,
        grid_shape,
        resolution=resolution,
        max_iterations=max_iterations,
        inner_iters=inner_iters,
        block=block,
        axis_name=axis_name,
        interpret=interpret,
    )

    n_dev = mesh.shape[axis_name]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(), P()),
        out_specs=P(),
        check_rep=False,
    )
    def _update_map(pts, msk, pose_rep, stats_rep):
        world_pts = se3.transform_points(pose_rep, pts)
        local = gaussian_map.stats_from_points(
            world_pts, msk, stats_rep.origin, stats_rep.resolution, capacity
        )
        keys = jax.lax.all_gather(local.keys, axis_name)
        n = jax.lax.all_gather(local.n, axis_name)
        sx = jax.lax.all_gather(local.sx, axis_name)
        sxx = jax.lax.all_gather(local.sxx, axis_name)
        ovf = jax.lax.all_gather(local.overflow, axis_name)

        def merge_step(i, acc):
            other = VoxelStats(
                keys[i], n[i], sx[i], sxx[i], acc.origin, acc.resolution, ovf[i]
            )
            return gaussian_map.merge_stats(acc, other, capacity)

        merged = jax.lax.fori_loop(
            0,
            n_dev,
            merge_step,
            stats_rep,
        )
        return merged

    new_stats = _update_map(points, mask, pose, map_stats)
    return pose, hess, score, iters, new_stats


def svn_align_sharded(
    mesh: Mesh,
    points: jax.Array,  # (N, 3) float32, replicated (N multiple of block)
    mask: jax.Array,  # (N,), replicated
    regmap,  # ndt.RegMap, replicated
    prior: Pose3,  # replicated
    rng_key: jax.Array,
    cfg,  # ndt.SvnConfig (shared_gather semantics; polish_objective="ndt")
    grid_shape: tuple,
    axis_name: str = "data",
    block: int = None,
    interpret: bool = False,
):
    """SVN-NDT with the K-particle axis sharded over the mesh.

    The single-chip path (ndt.svn.svn_align_reg) vmaps stage 1 over K
    particles; here each chip evaluates the fused NDT objective for its
    K/D local particles — the elevation of the reference's OpenMP stage-1
    fan-out (svn_ndt_impl.hpp:719-813) to several devices. Stage 2's kernel
    moments are sums over the SOURCE particle axis l:

        phi[k]  = (1/K) sum_l  k[l,k] grad[l] + dk[l,k]
        Ht[k]   = (1/K) sum_l  k[l,k]^2 H[l]  + dk[l,k] dk[l,k]^T

    so each chip forms the partial moments for ALL K columns from its local
    rows and a ``psum_scatter`` both reduces over chips AND hands every chip
    exactly its K/D rows of (phi, Ht) — each 6-dof Stein-Newton solve runs
    once on one chip, not D times. Per iteration the wire carries one
    all_gather of particle poses (K x 12 floats) + the scattered moments
    (K x 42 floats) + one 6-float psum for the mean: all cheap next to
    stage 1's K/D pair-math evaluations.

    Particle init, convergence, polish ("ndt" objective only) and the
    posterior mean/covariance match the single-chip semantics; parity is
    pinned by tests/test_dist.py::TestSvnSharded.
    Returns the same SvnResult pytree (particles gathered to (K,)).
    """
    from ..core import linalg
    from ..ndt.pallas_math import fused_objective, gather_megaT
    from ..ndt.svn import INIT_SIGMAS, SvnResult, _pairwise_kernel  # noqa: F401

    assert cfg.polish_objective == "ndt", (
        "svn_align_sharded supports the NDT polish objective only "
        "(gicp_aniso needs the aux gather + src_cov plumbing)"
    )
    K = cfg.num_particles
    n_dev = mesh.shape[axis_name]
    assert K % n_dev == 0, (K, n_dev)
    assert K > 1, "particle covariance needs K >= 2"
    lk = K // n_dev
    d1, d2, _ = gauss_constants(cfg.resolution, cfg.outlier_ratio)
    dtype = jnp.float32
    platform = mesh.devices.flat[0].platform
    I6 = jnp.eye(6, dtype=dtype)

    # identical replicated init draw as the single-chip path; each chip
    # slices its lk rows via the sharded in_spec
    sigmas = jnp.asarray(INIT_SIGMAS, dtype=dtype)
    xi0 = sigmas * jax.random.normal(rng_key, (K, 6), dtype=dtype)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis_name)),
        out_specs=(P(), P(), P(), P(), P(axis_name), P()),
        check_rep=False,
    )
    def _run(pts, msk, rmap, prior_rep, xi_local):
        ptsT = pts.T.astype(dtype)
        prior_lb = Pose3(
            jnp.broadcast_to(prior_rep.rot, (lk, 3, 3)),
            jnp.broadcast_to(prior_rep.trans, (lk, 3)),
        )
        local0 = se3.retract(prior_lb, xi_local)

        def make_obj(mean_pose):
            with jax.named_scope("svn_gather"):
                megaT = gather_megaT(
                    pts, msk, mean_pose, rmap, grid_shape,
                    kd_radius=cfg.kd_radius,
                )

            def obj_fn(pose):
                return fused_objective(
                    ptsT, megaT, pose, d1, d2, cfg.hess_lambda,
                    block=block, interpret=interpret, platform=platform,
                )

            return obj_fn

        def mean_from(local):
            xi = se3.local(prior_lb, local)  # (lk, 6) tangent at prior
            s = jax.lax.psum(jnp.sum(xi, axis=0), axis_name)
            return se3.retract(prior_rep, s / K)

        def cond(state):
            _local, _mean, it, converged = state
            return (it < cfg.max_iterations) & (~converged)

        def body(state):
            local, mean_last, it, _conv = state
            obj_fn = make_obj(mean_last)

            def eval_particle(pose):
                obj = obj_fn(pose)
                g = jnp.where(
                    jnp.all(jnp.isfinite(obj.grad)), obj.grad,
                    jnp.zeros_like(obj.grad),
                )
                H = jnp.where(jnp.all(jnp.isfinite(obj.hess)), obj.hess, I6)
                return g, H

            with jax.named_scope("svn_particle_eval"):
                grads, hessians = jax.vmap(eval_particle)(local)  # (lk,...)

            with jax.named_scope("svn_stein_update"):
                # kernel rows: local particles l; columns: ALL K particles
                all_p = jax.tree.map(
                    lambda a: jax.lax.all_gather(a, axis_name, tiled=True),
                    local,
                )
                inv = se3.inverse(local)
                rel = se3.compose(
                    Pose3(inv.rot[:, None], inv.trans[:, None]),
                    Pose3(all_p.rot[None, :], all_p.trans[None, :]),
                )
                diff = se3.logmap(rel)  # (lk, K, 6)
                sq = jnp.sum(diff * diff, axis=-1)
                kval = jnp.exp(-sq / cfg.kernel_h)
                kgrad = kval[..., None] * (-2.0 / cfg.kernel_h) * diff
                phi_part = jnp.einsum("lk,la->ka", kval, grads) + jnp.sum(
                    kgrad, axis=0
                )  # (K, 6) partial over local l
                Ht_part = jnp.einsum(
                    "lk,lab->kab", kval * kval, hessians
                ) + jnp.einsum("lka,lkb->kab", kgrad, kgrad)  # (K, 6, 6)
                # reduce over chips AND scatter rows: each chip receives the
                # fully-summed moments for exactly its lk particles
                phi = jax.lax.psum_scatter(
                    phi_part, axis_name, scatter_dimension=0, tiled=True
                ) / K
                Ht = jax.lax.psum_scatter(
                    Ht_part, axis_name, scatter_dimension=0, tiled=True
                ) / K
                Ht = Ht + cfg.svn_hess_lambda * I6
                updates = jnp.linalg.solve(Ht, -phi[..., None])[..., 0]
                updates = jnp.where(
                    jnp.all(jnp.isfinite(updates), axis=-1, keepdims=True),
                    updates, 0.0,
                )
            with jax.named_scope("svn_retract"):
                local = se3.retract(local, cfg.step_size * updates)
                mean_now = mean_from(local)
                delta = jnp.linalg.norm(se3.local(mean_last, mean_now))
            return local, mean_now, it + 1, delta < cfg.stop_thresh

        state0 = (local0, prior_rep, jnp.asarray(0, jnp.int32), jnp.asarray(False))
        local, mean_pose, iters, converged = jax.lax.while_loop(
            cond, body, state0
        )

        score = jnp.asarray(0.0, jnp.float32)
        if cfg.polish_iters > 0:
            # replicated MAP polish on the NDT objective (ndt.svn semantics)
            def polish_body(_i, carry):
                pose, _score = carry
                obj = make_obj(pose)(pose)
                step = jnp.linalg.solve(obj.hess, -obj.grad)
                step = jnp.where(
                    jnp.all(jnp.isfinite(step)), step, jnp.zeros_like(step)
                )
                nrm = jnp.linalg.norm(step)
                step = step * jnp.minimum(1.0, 0.25 / jnp.maximum(nrm, 1e-30))
                return (
                    se3.retract(pose, step.astype(dtype)),
                    obj.score.astype(jnp.float32),
                )

            start = prior_rep if cfg.polish_from == "prior" else mean_pose
            with jax.named_scope("svn_polish"):
                mean_pose, score = jax.lax.fori_loop(
                    0, cfg.polish_iters, polish_body, (start, score)
                )
        else:
            with jax.named_scope("svn_final_score"):
                score = make_obj(mean_pose)(mean_pose).score.astype(jnp.float32)

        with jax.named_scope("svn_posterior"):
            mean_lb = Pose3(
                jnp.broadcast_to(mean_pose.rot, (lk, 3, 3)),
                jnp.broadcast_to(mean_pose.trans, (lk, 3)),
            )
            tang = se3.local(mean_lb, local)  # (lk, 6)
            mean_t = jax.lax.psum(jnp.sum(tang, axis=0), axis_name) / K
            centered = tang - mean_t[None, :]
            cov = jax.lax.psum(centered.T @ centered, axis_name) / (K - 1)
            cov = linalg.eig_floor_psd(cov, cfg.cov_eig_floor)
        return mean_pose, cov, iters, converged, local, score

    pose, cov, iters, converged, particles, score = _run(
        points, mask, regmap, prior, xi0
    )
    return SvnResult(pose, cov, iters, converged, particles, score)


def batch_align_sharded(
    mesh: Mesh,
    points: jax.Array,  # (B, N, 3), B divisible by mesh size
    mask: jax.Array,  # (B, N)
    regmap,  # ndt.RegMap, replicated
    init_poses: Pose3,  # (B,)-batched
    cfg,  # NewtonConfig
    grid_shape: tuple,
    inner_iters: int = 1,
    block: int = None,
    axis_name: str = "data",
    interpret: bool = False,
):
    """Data-parallel registration service: B independent scans against ONE
    shared map, the batch axis sharded over the mesh, the RegMap replicated.
    Each chip runs the vmapped fused Newton path on its local B/D scans —
    zero collectives in steady state (the complement of
    ``newton_align_sharded_fused``, which shards the POINTS of one scan).
    This is the multi-chip throughput/serving mode: localization requests
    against a common prebuilt map fan out across the devices."""
    from ..ndt.pallas_math import newton_align_fused_batch

    platform = mesh.devices.flat[0].platform

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(), P(axis_name)),
        out_specs=P(axis_name),
        check_rep=False,
    )
    def _run(pts, msk, rmap, init):
        return newton_align_fused_batch(
            pts, msk, rmap, init, cfg, grid_shape, inner_iters,
            interpret=interpret, block=block, platform=platform,
        )

    return _run(points, mask, regmap, init_poses)
