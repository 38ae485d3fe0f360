"""P2D-NDT score / gradient / Hessian against a Gaussian voxel map.

This is the array-program re-design of the reference hot loop (~99% of its runtime:
``computeParticleDerivatives`` + ``updateDerivatives``,
/root/reference/extern/svn_ndt/include/svn_ndt_impl.hpp:400-668). Differences
by design, not translation:

- **Parameterization**: derivatives are taken w.r.t. the local SE(3) tangent
  ``[omega, v]`` at the current pose (right perturbation ``T * Exp(delta)``),
  matching GTSAM ``retract``. The reference instead builds Euler-angle tables
  (Magnusson Eq 6.18/6.19) in an Rx*Ry*Rz convention while extracting the
  angles in GTSAM's Rz*Ry*Rx convention — an inconsistency we do not copy.
  The *score* is parameterization-independent, so score parity with the
  reference is preserved; our gradient/Hessian are verified against
  ``jax.grad``/``jax.hessian`` of the score instead (test_ndt.py).
- **Neighbor search**: DIRECT7/DIRECT1 integer voxel offsets + sorted-key
  binary search (no KdTree; KDTREE mode is intentionally dropped — DIRECT7 is
  the shipped configuration, /root/reference/config/register_config.json).
- **Shape discipline**: everything is fixed-shape (N points x K offsets) with
  validity masks; the per-point x per-neighbor contributions are reduced with
  einsums that factor the (k) axis out before the expensive 6x6 products.

Numeric guards mirror the reference (svn_ndt_impl.hpp:420-447): Mahalanobis
negativity clamp, exponent cap at 50, and the near-zero-factor cutoff.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se3, so3
from ..core.se3 import Pose3
from ..mapping import voxel
from ..mapping.gaussian_map import GaussianMap

MAX_EXPONENT_ARG = 50.0  # reference svn_ndt_impl.hpp:422
MIN_FACTOR = 1e-15  # reference svn_ndt_impl.hpp:444


class NdtObjective(NamedTuple):
    score: jax.Array  # () total score (maximized)
    grad: jax.Array  # (6,) d(score)/d(tangent [omega, v]) at the pose
    hess: jax.Array  # (6, 6) Gauss-Newton (or full) Hessian of the score
    n_contrib: jax.Array  # () int32: point-neighbor pairs that contributed


def sanitize_points(points, mask):
    """Drop non-finite points from the mask AND zero their coordinates.

    Masking alone is not enough: a NaN coordinate propagates through the
    einsum reductions as 0 * NaN = NaN even when its pair weight is zero,
    silently poisoning the gradient (and the zeroed Newton step then reads
    as "converged" at the initial pose)."""
    finite = jnp.all(jnp.isfinite(points), axis=-1)
    return jnp.where(finite[:, None], points, 0.0), mask & finite


def _pair_terms(points, mask, pose: Pose3, gmap: GaussianMap, d1, d2, offsets):
    """Shared gather + per-pair weights.

    Returns (tp, xrel, icov, icx, factor, score_pairs, active) where
    tp: (N,3) transformed points; xrel: (N,K,3); icov: (N,K,3,3);
    icx = icov @ xrel; factor/score_pairs: (N,K); active: (N,K) bool.
    """
    points, mask = sanitize_points(points, mask)
    dtype = points.dtype
    tp = se3.transform_points(pose, points)  # (N, 3)
    inv_res = (1.0 / gmap.resolution).astype(dtype)
    coords = voxel.coords_of(tp, gmap.origin.astype(dtype), inv_res)  # (N, 3)
    ncoords = coords[:, None, :] + offsets[None, :, :]  # (N, K, 3)
    keys = voxel.pack(ncoords)
    slot, found = voxel.lookup(gmap.keys, keys)  # (N, K)
    found = found & gmap.valid[slot] & mask[:, None]

    mu = gmap.mean[slot].astype(dtype)  # (N, K, 3)
    icov = gmap.icov[slot].astype(dtype)  # (N, K, 3, 3)
    xrel = tp[:, None, :] - mu
    icx = jnp.einsum("nkij,nkj->nki", icov, xrel)
    mahal = jnp.einsum("nki,nki->nk", xrel, icx)
    mahal = jnp.maximum(mahal, 0.0)  # clamp tiny negatives (reference :428)
    exponent = 0.5 * d2 * mahal
    ok = found & (exponent <= MAX_EXPONENT_ARG) & jnp.isfinite(mahal)
    e = jnp.exp(-jnp.where(ok, exponent, 0.0))
    score_pairs = jnp.where(ok, -d1 * e, 0.0)
    factor = d1 * d2 * e
    active = ok & (jnp.abs(factor) >= MIN_FACTOR)
    factor = jnp.where(active, factor, 0.0)
    return tp, xrel, icov, icx, factor, score_pairs, ok


def point_jacobian(points: jax.Array, pose: Pose3) -> jax.Array:
    """d(transformed point)/d(tangent [omega, v]) at delta = 0.

    x'(delta) = R * Exp(delta_w) * (x + V(delta_w) delta_v) + t
    => J = [ -R * hat(x) | R ]  with shape (N, 3, 6).
    """
    R = pose.rot
    mhat = -so3.hat(points)  # (N, 3, 3)
    Jw = jnp.einsum("ij,njk->nik", R, mhat)
    Jv = jnp.broadcast_to(R, points.shape[:-1] + (3, 3))
    return jnp.concatenate([Jw, Jv], axis=-1)  # (N, 3, 6)


def score_only(
    points: jax.Array,
    mask: jax.Array,
    pose: Pose3,
    gmap: GaussianMap,
    d1: float,
    d2: float,
    offsets: jax.Array = voxel.DIRECT7_OFFSETS,
) -> jax.Array:
    """Total NDT score at a pose (per-pair Magnusson Eq. 6.9, summed)."""
    *_, score_pairs, _ok = _pair_terms(points, mask, pose, gmap, d1, d2, offsets)
    return jnp.sum(score_pairs)


def score_grad_hess(
    points: jax.Array,
    mask: jax.Array,
    pose: Pose3,
    gmap: GaussianMap,
    d1: float,
    d2: float,
    offsets: jax.Array = voxel.DIRECT7_OFFSETS,
    hess_lambda: float = 1e-6,
) -> NdtObjective:
    """Score, gradient, and Gauss-Newton Hessian in one fused evaluation.

    grad = sum_{n,k} f_nk * J_n^T C^-1_nk (x'_n - mu_nk)
    hess = sum_{n,k} f_nk * J_n^T C^-1_nk J_n + lambda I
    with f = d1*d2*exp(-d2/2 * mahal^2) — the same accumulation as reference
    updateDerivatives (svn_ndt_impl.hpp:449-513, Gauss-Newton branch) plus the
    per-particle Tikhonov term (":650-653"), but with J in the SE(3) tangent.

    The neighbor axis (k) is reduced *before* touching the 6-dof axis:
      b_n = sum_k f_nk icx_nk          (N,3)
      M_n = sum_k f_nk C^-1_nk         (N,3,3)
      grad = sum_n J_n^T b_n ;  hess = sum_n J_n^T M_n J_n
    which turns the hot reduction into two big einsums on (N,3,*) tensors.
    """
    points, mask = sanitize_points(points, mask)
    tp, xrel, icov, icx, factor, score_pairs, ok = _pair_terms(
        points, mask, pose, gmap, d1, d2, offsets
    )
    J = point_jacobian(points, pose)  # (N, 3, 6)
    b = jnp.einsum("nk,nki->ni", factor, icx)  # (N, 3)
    M = jnp.einsum("nk,nkij->nij", factor, icov)  # (N, 3, 3)
    grad = jnp.einsum("nia,ni->a", J, b)
    hess = jnp.einsum("nia,nij,njb->ab", J, M, J)
    hess = hess + hess_lambda * jnp.eye(6, dtype=hess.dtype)
    score = jnp.sum(score_pairs)
    n_contrib = jnp.sum(ok, dtype=jnp.int32)
    return NdtObjective(score, grad, hess, n_contrib)


def full_hessian(
    points: jax.Array,
    mask: jax.Array,
    pose: Pose3,
    gmap: GaussianMap,
    d1: float,
    d2: float,
    offsets: jax.Array = voxel.DIRECT7_OFFSETS,
    hess_lambda: float = 1e-6,
):
    """Exact (non-Gauss-Newton) gradient and Hessian of the score w.r.t. the
    SE(3) tangent via autodiff, with the neighbor set frozen at delta = 0
    (the reference's full-Newton K=1 mode also freezes neighbors per
    evaluation). Used by the K=1 full-Newton variant and as the oracle for
    the hand-fused Gauss-Newton kernel."""

    def f(xi):
        return score_only(points, mask, se3.retract(pose, xi), gmap, d1, d2, offsets)

    zero = jnp.zeros((6,), dtype=points.dtype)
    grad = jax.grad(f)(zero)
    hess = jax.hessian(f)(zero)
    return grad, hess + hess_lambda * jnp.eye(6, dtype=hess.dtype)
