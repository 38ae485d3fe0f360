"""Batch pose-graph optimization: sparse Gauss-Newton/LM at 10k-pose scale.

The reference's loop-closure scaffold (voxel-bucketed candidate search +
iSAM2, /root/reference/run/pipeline.cpp:676-736) implies a batch pose-graph
backend. We never materialize the sparse normal matrix: per-factor
6x12 Jacobians come from a vmapped ``jacfwd`` (exact, batched), and the
normal-equation product H @ x is computed factor-wise with gathers +
segment-sums — so Gauss-Newton steps run as block-Jacobi-preconditioned
conjugate gradients with only (F, 6, 6) sized intermediates.

Anchor: node 0 (or any set) is pinned with a unit prior, the usual gauge fix.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se3
from ..core.se3 import Pose3


class PoseGraph(NamedTuple):
    poses: Pose3  # (N,) batched
    i: jax.Array  # (F,) int32 factor endpoints
    j: jax.Array  # (F,)
    rel_rot: jax.Array  # (F, 3, 3) measured i->j
    rel_trans: jax.Array  # (F, 3)
    sqrt_info: jax.Array  # (F, 6, 6)
    active: jax.Array  # (F,) bool
    anchored: jax.Array  # (N,) bool — nodes pinned at current value
    # optional per-node absolute pose priors (e.g. the INS priors the
    # reference's iSAM2 graph carries, run/pipeline.cpp:637-665 — without
    # them an offline re-solve discards the GNSS information and reverts to
    # raw odometry-chain quality)
    prior_rot: jax.Array  # (N, 3, 3)
    prior_trans: jax.Array  # (N, 3)
    prior_sqrt_info: jax.Array  # (N, 6, 6)
    prior_active: jax.Array  # (N,) bool

    @property
    def num_nodes(self) -> int:
        return self.poses.trans.shape[0]


class PoseGraphConfig(NamedTuple):
    gn_iterations: int = 10
    cg_iterations: int = 50
    damping: float = 1e-6
    anchor_weight: float = 1e6
    # Huber robust kernel on the whitened factor residual norm (IRLS):
    # factors beyond ``huber_delta`` sigmas are downweighted by delta/|r|,
    # so a single bad loop closure cannot blow the graph apart (GTSAM's
    # robust noise-model parity). <= 0 disables.
    huber_delta: float = 0.0


class PoseGraphResult(NamedTuple):
    poses: Pose3
    error: jax.Array
    iterations: jax.Array


def _factor_residual(pose_i: Pose3, pose_j: Pose3, rel: Pose3, sqrt_info):
    return sqrt_info @ se3.local(rel, se3.between(pose_i, pose_j))


def _linearize(graph: PoseGraph):
    """Per-factor residuals (F, 6) and Jacobians (F, 6, 6) wrt both endpoints."""
    pi = Pose3(graph.poses.rot[graph.i], graph.poses.trans[graph.i])
    pj = Pose3(graph.poses.rot[graph.j], graph.poses.trans[graph.j])
    rel = Pose3(graph.rel_rot, graph.rel_trans)

    def r_of(di, dj, k):
        pik = se3.retract(Pose3(pi.rot[k], pi.trans[k]), di)
        pjk = se3.retract(Pose3(pj.rot[k], pj.trans[k]), dj)
        return _factor_residual(
            pik, pjk, Pose3(rel.rot[k], rel.trans[k]), graph.sqrt_info[k]
        )

    zero = jnp.zeros(6, dtype=graph.poses.trans.dtype)
    ks = jnp.arange(graph.i.shape[0])
    r = jax.vmap(lambda k: r_of(zero, zero, k))(ks)
    Ji = jax.vmap(lambda k: jax.jacfwd(lambda d: r_of(d, zero, k))(zero))(ks)
    Jj = jax.vmap(lambda k: jax.jacfwd(lambda d: r_of(zero, d, k))(zero))(ks)
    m = graph.active[:, None]
    return jnp.where(m, r, 0.0), jnp.where(m[..., None], Ji, 0.0), jnp.where(
        m[..., None], Jj, 0.0
    )


def _linearize_priors(graph: PoseGraph):
    """Per-node prior residuals (N, 6) and Jacobians (N, 6, 6)."""

    def r_of(d, k):
        pk = se3.retract(
            Pose3(graph.poses.rot[k], graph.poses.trans[k]), d
        )
        prior = Pose3(graph.prior_rot[k], graph.prior_trans[k])
        return graph.prior_sqrt_info[k] @ se3.local(prior, pk)

    zero = jnp.zeros(6, dtype=graph.poses.trans.dtype)
    ks = jnp.arange(graph.num_nodes)
    r = jax.vmap(lambda k: r_of(zero, k))(ks)
    J = jax.vmap(lambda k: jax.jacfwd(lambda d: r_of(d, k))(zero))(ks)
    m = graph.prior_active[:, None]
    return jnp.where(m, r, 0.0), jnp.where(m[..., None], J, 0.0)


def optimize(graph: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig()) -> PoseGraphResult:
    N = graph.num_nodes
    dtype = graph.poses.trans.dtype
    anchor = graph.anchored.astype(dtype)[:, None] * cfg.anchor_weight

    def gn_step(poses, _):
        g = graph._replace(poses=poses)
        r, Ji, Jj = _linearize(g)

        if cfg.huber_delta > 0.0:
            # IRLS: scale residuals and Jacobians by sqrt(w), w = Huber weight
            rn = jnp.linalg.norm(r, axis=-1)
            w = jnp.where(
                rn > cfg.huber_delta, cfg.huber_delta / jnp.maximum(rn, 1e-30), 1.0
            )
            sw = jnp.sqrt(w)
            r = r * sw[:, None]
            Ji = Ji * sw[:, None, None]
            Jj = Jj * sw[:, None, None]

        rp, Jp = _linearize_priors(g)

        # gradient: b = J^T r scattered to nodes (+ per-node prior terms)
        bi = jnp.einsum("fab,fa->fb", Ji, r)
        bj = jnp.einsum("fab,fa->fb", Jj, r)
        b = jax.ops.segment_sum(bi, g.i, num_segments=N) + jax.ops.segment_sum(
            bj, g.j, num_segments=N
        )
        b = b + jnp.einsum("nab,na->nb", Jp, rp)

        # block-Jacobi preconditioner from diagonal 6x6 blocks
        Dii = jnp.einsum("fab,fac->fbc", Ji, Ji)
        Djj = jnp.einsum("fab,fac->fbc", Jj, Jj)
        D = jax.ops.segment_sum(Dii, g.i, num_segments=N) + jax.ops.segment_sum(
            Djj, g.j, num_segments=N
        )
        D = D + jnp.einsum("nab,nac->nbc", Jp, Jp)
        D = D + (cfg.damping + anchor[..., None]) * jnp.eye(6, dtype=dtype)
        # Invert each 6x6 block through Jacobi-equilibrated Cholesky (the
        # smoother's solve trick, smoother.py::optimize_pose_window): scale
        # to unit diagonal before factoring so the f32 factorization stays
        # accurate across the ~1e12 magnitude spread between anchored
        # (anchor_weight=1e6) and barely-constrained blocks. P is formed
        # explicitly so PCG's preconditioner apply stays one batched matmul.
        d = jax.lax.rsqrt(jnp.maximum(
            jnp.diagonal(D, axis1=-2, axis2=-1), 1e-30))
        Ds = D * d[:, :, None] * d[:, None, :]
        L = jnp.linalg.cholesky(Ds)
        eye6 = jnp.broadcast_to(jnp.eye(6, dtype=dtype), Ds.shape)
        Ps = jax.scipy.linalg.cho_solve((L, True), eye6)
        P = Ps * d[:, :, None] * d[:, None, :]

        def hx(x):  # x: (N, 6) -> H x (normal equations product)
            ui = jnp.einsum("fab,fb->fa", Ji, x[g.i]) + jnp.einsum(
                "fab,fb->fa", Jj, x[g.j]
            )
            yi = jnp.einsum("fab,fa->fb", Ji, ui)
            yj = jnp.einsum("fab,fa->fb", Jj, ui)
            y = jax.ops.segment_sum(yi, g.i, num_segments=N) + jax.ops.segment_sum(
                yj, g.j, num_segments=N
            )
            up = jnp.einsum("nab,nb->na", Jp, x)
            y = y + jnp.einsum("nab,na->nb", Jp, up)
            return y + (cfg.damping + anchor) * x

        def papply(v):
            return jnp.einsum("nab,nb->na", P, v)

        # PCG for H delta = -b
        def cg_body(carry, _):
            x, rr, z, p = carry
            Hp = hx(p)
            denom = jnp.sum(p * Hp)
            alpha = jnp.where(denom > 0, jnp.sum(rr * z) / jnp.maximum(denom, 1e-30), 0.0)
            x_n = x + alpha * p
            r_n = rr - alpha * Hp
            z_n = papply(r_n)
            beta_num = jnp.sum(r_n * z_n)
            beta = beta_num / jnp.maximum(jnp.sum(rr * z), 1e-30)
            p_n = z_n + beta * p
            return (x_n, r_n, z_n, p_n), None

        x0 = jnp.zeros((N, 6), dtype)
        r0 = -b
        z0 = papply(r0)
        (delta, *_), _ = jax.lax.scan(
            cg_body, (x0, r0, z0, z0), None, length=cfg.cg_iterations
        )
        delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
        delta = jnp.where(graph.anchored[:, None], 0.0, delta)
        new_poses = se3.retract(poses, delta)
        return new_poses, jnp.sum(r * r) + jnp.sum(rp * rp)

    poses, errs = jax.lax.scan(gn_step, graph.poses, None, length=cfg.gn_iterations)
    final_r, _, _ = _linearize(graph._replace(poses=poses))
    return PoseGraphResult(poses, 0.5 * jnp.sum(final_r**2), jnp.asarray(cfg.gn_iterations))


def make_graph(
    poses: Pose3,
    i: jax.Array,
    j: jax.Array,
    rel: Pose3,
    sqrt_info: jax.Array,
    active=None,
    anchored=None,
    prior: Pose3 = None,
    prior_sqrt_info: jax.Array = None,
    prior_active=None,
) -> PoseGraph:
    N = poses.trans.shape[0]
    F = i.shape[0]
    dtype = poses.trans.dtype
    if active is None:
        active = jnp.ones((F,), bool)
    if anchored is None:
        anchored = jnp.zeros((N,), bool).at[0].set(True)
    if prior is None:
        prior = Pose3(
            jnp.broadcast_to(jnp.eye(3, dtype=dtype), (N, 3, 3)),
            jnp.zeros((N, 3), dtype),
        )
        prior_sqrt_info = jnp.zeros((N, 6, 6), dtype)
        prior_active = jnp.zeros((N,), bool)
    else:
        if prior_active is None:
            prior_active = jnp.ones((N,), bool)
    return PoseGraph(poses, i.astype(jnp.int32), j.astype(jnp.int32), rel.rot,
                     rel.trans, sqrt_info, active, anchored,
                     prior.rot, prior.trans, prior_sqrt_info, prior_active)
