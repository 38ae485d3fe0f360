"""Voxelized GICP registration (the reference's GICP method option,
/root/reference/src/registercallback.cpp:24-91 via pclomp::gicp_omp).

The formulation follows VGICP (Koide et al.): correspondences come
from the voxel grid instead of per-point KD-tree nearest neighbors, and each
point-voxel pair contributes the plane-to-plane Mahalanobis cost

    e = r^T (C_voxel + R C_src R^T)^-1 r,   r = T p - mu

with an isotropic source covariance C_src = sigma^2 I (rotation-invariant, so
the combined inverse (C_voxel + sigma^2 I)^-1 is baked per voxel at map-build
time). Gradients/Hessian reuse the SE(3)-tangent machinery of the NDT
objective; the Newton loop minimizes the cost (sign-flipped into the common
maximize convention so slamtpu.ndt.newton is reused unchanged).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import linalg
from ..mapping.gaussian_map import GaussianMap
from . import regmap as regmap_mod
from .newton import NewtonConfig, NewtonResult, _newton_loop
from .objective import NdtObjective, point_jacobian


def gicp_map(gmap: GaussianMap, source_noise_sigma: float = 0.05) -> GaussianMap:
    """Clone the Gaussian map with icov = (cov + sigma^2 I)^-1 — after this,
    the GICP cost is evaluated by the same gather/math path as NDT."""
    fused = gmap.cov + (source_noise_sigma**2) * jnp.eye(3, dtype=gmap.cov.dtype)
    icov = linalg.inv3x3(fused)
    icov = jnp.where(gmap.valid[:, None, None], icov, 0.0)
    return gmap._replace(icov=icov)


def score_grad_hess_gicp(
    points: jax.Array,
    mask: jax.Array,
    pose,
    regmap: regmap_mod.RegMap,
    grid_shape: tuple,
    hess_lambda: float = 1e-6,
    max_mahal: float = 9.0,
    max_corr_dist: float = 5.0,
) -> NdtObjective:
    """GICP cost (negated, so it is maximized like the NDT score).

    ``max_mahal`` gates outlier pairs (pairs beyond 3 sigma contribute
    nothing — the robustness analog of NDT's bounded exp weight).
    ``max_corr_dist`` is the reference's Euclidean correspondence-distance
    gate (gicp_corr_dist_threshold, src/registercallback.cpp:56-61); voxel
    correspondences sit within ~1.5x resolution, so the 5 m default is
    inactive and the knob only bites when tightened below that.
    Expects a RegMap built from ``gicp_map(...)``.
    """
    from .objective import sanitize_points

    points, mask = sanitize_points(points, mask)
    _tp, mu, icov, active = regmap_mod.gather_pair_data(
        points, mask, pose, regmap, grid_shape
    )
    return score_grad_hess_gicp_gathered(
        points, pose, mu, icov, active, hess_lambda, max_mahal, max_corr_dist
    )


def score_grad_hess_gicp_gathered(
    points: jax.Array,  # (N, 3) body frame, already sanitized
    pose,
    mu: jax.Array,  # (N, 7, 3) pre-gathered voxel means
    icov: jax.Array,  # (N, 7, 3, 3) pre-gathered (cov + sigma^2 I)^-1
    active: jax.Array,  # (N, 7)
    hess_lambda: float = 1e-6,
    max_mahal: float = 9.0,
    max_corr_dist: float = 5.0,
) -> NdtObjective:
    """Isotropic VGICP cost on pre-gathered Gaussians (see
    score_grad_hess_gicp)."""
    from ..core import se3

    tp = se3.transform_points(pose, points)
    icx, _factor, _sp, _ok, mahal = regmap_mod._pair_math(
        tp, mu, icov, active, d1=-1.0, d2=2.0
    )
    dist2 = jnp.sum((tp[:, None, :] - mu) ** 2, axis=-1)
    inlier = (
        active
        & (mahal <= max_mahal)
        & (dist2 <= max_corr_dist**2)
        & jnp.isfinite(mahal)
    )
    w = inlier.astype(points.dtype)

    J = point_jacobian(points, pose)
    b = jnp.einsum("nk,nki->ni", w, icx)
    M = jnp.einsum("nk,nkij->nij", w, icov)
    # maximize score = -sum(mahal); grad = -2 J^T icov r; H_GN = -2 J^T icov J
    grad = -2.0 * jnp.einsum("nia,ni->a", J, b)
    hess = -2.0 * jnp.einsum("nia,nij,njb->ab", J, M, J)
    hess = hess + hess_lambda * jnp.eye(6, dtype=hess.dtype)
    score = -jnp.sum(jnp.where(inlier, mahal, 0.0))
    return NdtObjective(score, grad, hess, jnp.sum(inlier, dtype=jnp.int32))


def gicp_align(
    points: jax.Array,
    mask: jax.Array,
    regmap: regmap_mod.RegMap,
    init_pose,
    cfg: NewtonConfig = NewtonConfig(),
    grid_shape: tuple = (256, 256, 64),
) -> NewtonResult:
    """Newton VGICP alignment (regmap must come from gicp_map + build_regmap)."""

    def eval_obj(pose):
        return score_grad_hess_gicp(
            points, mask, pose, regmap, grid_shape, cfg.hess_lambda,
            max_corr_dist=cfg.gicp_max_corr_dist,
        )

    return _newton_loop(eval_obj, points.dtype, init_pose, cfg)


# --- anisotropic-source (plane-to-plane) GICP -------------------------------
#
# The isotropic mode above bakes C_src = sigma^2 I into the map, discarding
# the source scan's surface anisotropy — the defining feature of gicp_omp's
# plane-to-plane cost (the reference's GICP engine, registercallback.cpp:
# 56-61). This mode computes per-point source covariances from the source
# scan's OWN voxel statistics and fuses (C_tgt + R C_src R^T)^-1 per pair.


def regularize_plane_covariance(cov: jax.Array, eps: float = 1e-3) -> jax.Array:
    """GICP covariance regularization: eigenvalues replaced by (eps, 1, 1)
    keeping eigenvectors — every Gaussian becomes a disc with its normal
    direction squashed to eps (gicp_omp's surface model; Segal et al.).

    With target eigenvalues (eps, 1, 1) the result depends only on the
    surface NORMAL n (the smallest-eigenvalue direction):

        V diag(eps, 1, 1) V^T = I - (1 - eps) n n^T

    so no full eigendecomposition is needed: lambda_min comes from the
    closed-form symmetric-3x3 trigonometric (Cardano) formula and n from
    the largest cross product of two rows of (C - lambda_min I). This is
    scatter-free, unlike a batched Jacobi eigensolver whose column-sliced
    .at[].set updates serialize.
    """
    dtype = cov.dtype
    c00 = cov[..., 0, 0]
    c11 = cov[..., 1, 1]
    c22 = cov[..., 2, 2]
    c01 = 0.5 * (cov[..., 0, 1] + cov[..., 1, 0])
    c02 = 0.5 * (cov[..., 0, 2] + cov[..., 2, 0])
    c12 = 0.5 * (cov[..., 1, 2] + cov[..., 2, 1])
    q = (c00 + c11 + c22) / 3.0
    p1 = c01 * c01 + c02 * c02 + c12 * c12
    p2 = (c00 - q) ** 2 + (c11 - q) ** 2 + (c22 - q) ** 2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    p_safe = jnp.where(p > 1e-30, p, 1.0)
    # det((C - qI) / p) via cofactors of the shifted symmetric matrix
    b00, b11, b22 = (c00 - q) / p_safe, (c11 - q) / p_safe, (c22 - q) / p_safe
    b01, b02, b12 = c01 / p_safe, c02 / p_safe, c12 / p_safe
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = jnp.clip(0.5 * detB, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # ascending eigenvalues: lmin = q + 2p cos(phi + 2pi/3)
    lmin = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    # normal = null direction of (C - lmin I): the largest cross product of
    # its rows (branch-free: compute all three, take the longest)
    a00, a11, a22 = c00 - lmin, c11 - lmin, c22 - lmin
    rows = (
        (a00, c01, c02),
        (c01, a11, c12),
        (c02, c12, a22),
    )

    def cross(u, v):
        return (
            u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0],
        )

    cands = [cross(rows[0], rows[1]), cross(rows[0], rows[2]), cross(rows[1], rows[2])]
    norms = [u[0] * u[0] + u[1] * u[1] + u[2] * u[2] for u in cands]
    best01 = norms[0] >= norms[1]
    n0 = jnp.where(best01, cands[0][0], cands[1][0])
    n1 = jnp.where(best01, cands[0][1], cands[1][1])
    n2 = jnp.where(best01, cands[0][2], cands[1][2])
    nb = jnp.maximum(norms[0], norms[1])
    use2 = norms[2] > nb
    n0 = jnp.where(use2, cands[2][0], n0)
    n1 = jnp.where(use2, cands[2][1], n1)
    n2 = jnp.where(use2, cands[2][2], n2)
    nn = jnp.sqrt(n0 * n0 + n1 * n1 + n2 * n2)
    degenerate = nn < 1e-20  # isotropic / zero cov: normal is arbitrary
    inv_nn = jnp.where(degenerate, 0.0, 1.0 / jnp.where(degenerate, 1.0, nn))
    n0, n1, n2 = n0 * inv_nn, n1 * inv_nn, n2 * inv_nn
    n2v = jnp.where(degenerate, 1.0, n2)  # arbitrary unit normal = z
    n = jnp.stack([n0, n1, n2v], axis=-1)
    eye = jnp.eye(3, dtype=dtype)
    return eye - (1.0 - eps) * n[..., :, None] * n[..., None, :]


def gicp_map_aniso(gmap: GaussianMap, eps: float = 1e-3) -> GaussianMap:
    """Target map for anisotropic GICP: the payload's icov slot carries the
    plane-REGULARIZED COVARIANCE instead of an inverse — fusion with the
    rotated source covariance and the 3x3 inversion happen per pair at
    evaluation time (score_grad_hess_gicp_aniso)."""
    cov_r = regularize_plane_covariance(gmap.cov, eps)
    cov_r = jnp.where(gmap.valid[:, None, None], cov_r, 0.0)
    return gmap._replace(icov=cov_r)


def stencil_point_covariances(
    points: jax.Array,  # (cols*sub, 3) row-major over the range-image grid
    mask: jax.Array,  # (cols*sub,)
    grid_shape: tuple,  # (cols, sub) — static
    col_window: int = 2,  # +-2 azimuth columns
    chan_window: int = 1,  # +-1 subset channels
    dist_gate_rel: float = 0.08,  # neighbor gate: |q - p| <= rel*|p| + abs
    dist_gate_abs: float = 0.3,
    fallback_sigma: float = 0.05,
    min_neighbors: int = 5,
    eps: float = 1e-3,
) -> jax.Array:
    """(N, 3, 3) per-point plane-regularized source covariances from the
    RANGE-IMAGE neighborhood — the scatter-free alternative to the sort-based
    ``source_point_covariances`` (this is pure shifts + FMA, no sort).

    The projected sweep is a dense (cols, sub) grid (lidar.project), so each
    point's spatial neighbors are its GRID neighbors — the voxelized analog
    of gicp_omp's kNN covariances with a physically meaningful neighborhood
    (fixed angular footprint instead of fixed metric voxel). Azimuth wraps
    (columns cover 360 deg); channels clamp at the array edge. A
    range-proportional distance gate keeps foreground/background surfaces
    across depth edges from mixing into one covariance. Points with fewer
    than ``min_neighbors`` gated neighbors fall back to the isotropic
    sigma^2 I, like the sparse-voxel fallback of the sort-based path."""
    dtype = points.dtype
    cols, sub = grid_shape
    N = points.shape[0]
    assert N == cols * sub, (N, grid_shape)
    P = jnp.where(mask[:, None], points, 0.0).reshape(cols, sub, 3)
    V = mask.reshape(cols, sub)
    r = jnp.linalg.norm(P, axis=-1)
    gate2 = (dist_gate_rel * r + dist_gate_abs) ** 2

    n = jnp.zeros((cols, sub), dtype)
    sx = jnp.zeros((cols, sub, 3), dtype)
    sxx = jnp.zeros((cols, sub, 3, 3), dtype)
    for dc in range(-col_window, col_window + 1):
        for ds in range(-chan_window, chan_window + 1):
            Q = jnp.roll(P, (-dc, -ds), axis=(0, 1))
            VQ = jnp.roll(V, (-dc, -ds), axis=(0, 1))
            if ds > 0:
                VQ = VQ.at[:, -ds:].set(False)  # channel axis does not wrap
            elif ds < 0:
                VQ = VQ.at[:, :-ds].set(False)
            # accumulate CENTER-RELATIVE offsets: absolute body-frame coords
            # reach 150 m, where the f32 rounding of Q*Q (~1.5e-3 m^2)
            # swamps the ~1e-4 m^2 surface-normal variance the plane model
            # rides on; |Q - P| is bounded by the distance gate
            Qr = Q - P
            d2 = jnp.sum(Qr**2, axis=-1)
            w = (V & VQ & (d2 <= gate2)).astype(dtype)
            n = n + w
            sx = sx + w[..., None] * Qr
            sxx = sxx + w[..., None, None] * (Qr[..., :, None] * Qr[..., None, :])
    nf = jnp.maximum(n, 1.0)
    mu = sx / nf[..., None]
    cov = sxx / nf[..., None, None] - mu[..., :, None] * mu[..., None, :]
    cov = cov * (nf / jnp.maximum(nf - 1.0, 1.0))[..., None, None]
    cov = regularize_plane_covariance(cov, eps)
    good = (n >= min_neighbors) & V
    iso = (fallback_sigma**2) * jnp.eye(3, dtype=dtype)
    out = jnp.where(good[..., None, None], cov, iso)
    return out.reshape(N, 3, 3)


def source_point_covariances(
    points: jax.Array,
    mask: jax.Array,
    resolution,
    capacity: int = 8192,
    min_points_per_voxel: int = 4,
    fallback_sigma: float = 0.05,
    eps: float = 1e-3,
) -> jax.Array:
    """(N, 3, 3) per-point source covariances: each point inherits the
    plane-regularized covariance of ITS OWN voxel in the source scan (the
    voxelized analog of gicp_omp's per-point kNN covariances). Points in
    sparse voxels fall back to the isotropic sigma^2 I.

    Deliberately searchsorted-free: the point->voxel association falls
    out of the SAME sort used to build the stats — segment ids via cumsum
    over the sorted keys, covariances gathered per sorted point, un-sorted
    through the inverse permutation."""
    from ..mapping import voxel

    dtype = points.dtype
    N = points.shape[0]
    finite = jnp.all(jnp.isfinite(points), axis=-1)
    mask = mask & finite
    big = jnp.asarray(1e6, dtype)
    masked = jnp.where(mask[:, None], points, big)
    origin = (
        jnp.floor(jnp.min(masked, axis=0) / resolution) - 1.0
    ) * resolution
    # voxel-corner-relative offsets (|rel| < resolution): origin-relative
    # coords reach the scan diameter (~300 m), whose f32 outer-product
    # rounding (~6e-3 m^2) swamps the per-voxel surface covariance — the
    # same cancellation fixed in mapping.gaussian_map.stats_from_points
    rel = points - origin[None, :]
    coords = jnp.floor(rel * (1.0 / resolution)).astype(jnp.int32)
    keys = jnp.where(mask, voxel.pack(coords), voxel.INVALID_KEY)
    pts_rel = jnp.where(
        finite[:, None], rel - coords.astype(dtype) * resolution, 0.0
    )

    order = jnp.argsort(keys)
    skeys = keys[order]
    spts = pts_rel[order]
    is_valid = skeys != voxel.INVALID_KEY
    first = jnp.concatenate(
        [jnp.ones((1,), bool), skeys[1:] != skeys[:-1]]
    ) & is_valid
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    seg_ok = is_valid & (seg >= 0) & (seg < capacity)
    seg_c = jnp.where(seg_ok, seg, capacity)
    ones = seg_ok.astype(dtype)
    n = jax.ops.segment_sum(ones, seg_c, num_segments=capacity + 1)
    sx = jax.ops.segment_sum(
        spts * ones[:, None], seg_c, num_segments=capacity + 1
    )
    outer = spts[:, :, None] * spts[:, None, :]
    sxx = jax.ops.segment_sum(
        outer * ones[:, None, None], seg_c, num_segments=capacity + 1
    )
    nf = jnp.maximum(n, 1.0)
    mu = sx / nf[:, None]
    cov_v = sxx / nf[:, None, None] - mu[:, :, None] * mu[:, None, :]
    cov_v = cov_v * (nf / jnp.maximum(nf - 1.0, 1.0))[:, None, None]
    cov_v = regularize_plane_covariance(cov_v, eps)  # (capacity+1, 3, 3)
    good_v = n >= min_points_per_voxel

    # each sorted point gathers its segment's covariance; inverse-permute
    cov_sorted = cov_v[seg_c]
    good_sorted = seg_ok & good_v[seg_c]
    inv = jnp.zeros((N,), jnp.int32).at[order].set(
        jnp.arange(N, dtype=jnp.int32)
    )
    cov = cov_sorted[inv]
    good = good_sorted[inv]
    iso = (fallback_sigma**2) * jnp.eye(3, dtype=dtype)
    return jnp.where(good[:, None, None], cov, iso)


def score_grad_hess_gicp_aniso_gathered(
    points: jax.Array,  # (N, 3) body frame, already sanitized
    src_cov: jax.Array,  # (N, 3, 3) body-frame source covariances
    pose,
    mu: jax.Array,  # (N, 7, 3) pre-gathered target means
    cov_t: jax.Array,  # (N, 7, 3, 3) pre-gathered plane-regularized target covs
    active: jax.Array,  # (N, 7)
    hess_lambda: float = 1e-6,
    max_mahal: float = 9.0,
    max_corr_dist: float = 5.0,
) -> NdtObjective:
    """Plane-to-plane GICP cost on pre-gathered target Gaussians (the
    shared-gather / SVN-polish path: neighbor sets come from a nearby pose,
    contributions use this pose's exact transform)."""
    from ..core import se3

    tp = se3.transform_points(pose, points)
    R = pose.rot
    rc = jnp.einsum("ab,nbc,dc->nad", R, src_cov, R)  # R C_src R^T
    fused_inv = linalg.inv3x3(cov_t + rc[:, None, :, :])
    r = tp[:, None, :] - mu
    icx = jnp.einsum("nkij,nkj->nki", fused_inv, r)
    mahal = jnp.maximum(jnp.einsum("nki,nki->nk", r, icx), 0.0)
    dist2 = jnp.sum(r**2, axis=-1)
    inlier = (
        active & (mahal <= max_mahal) & (dist2 <= max_corr_dist**2)
        & jnp.isfinite(mahal)
    )
    w = inlier.astype(points.dtype)

    J = point_jacobian(points, pose)
    b = jnp.einsum("nk,nki->ni", w, icx)
    M = jnp.einsum("nk,nkij->nij", w, fused_inv)
    grad = -2.0 * jnp.einsum("nia,ni->a", J, b)
    hess = -2.0 * jnp.einsum("nia,nij,njb->ab", J, M, J)
    hess = hess + hess_lambda * jnp.eye(6, dtype=hess.dtype)
    score = -jnp.sum(jnp.where(inlier, mahal, 0.0))
    return NdtObjective(score, grad, hess, jnp.sum(inlier, dtype=jnp.int32))


def score_grad_hess_gicp_aniso(
    points: jax.Array,
    mask: jax.Array,
    src_cov: jax.Array,  # (N, 3, 3) body-frame source covariances
    pose,
    regmap: regmap_mod.RegMap,  # from gicp_map_aniso + build_regmap
    grid_shape: tuple,
    hess_lambda: float = 1e-6,
    max_mahal: float = 9.0,
    max_corr_dist: float = 5.0,
) -> NdtObjective:
    """Plane-to-plane GICP cost: e = r^T (C_tgt + R C_src R^T)^-1 r per
    point-voxel pair, negated into the maximize convention. Gauss-Newton
    treats the fused covariance as fixed at the evaluation pose (the same
    approximation gicp_omp's optimizer makes per iteration)."""
    from .objective import sanitize_points

    points, mask = sanitize_points(points, mask)
    _tp, mu, cov_t, active = regmap_mod.gather_pair_data(
        points, mask, pose, regmap, grid_shape
    )
    return score_grad_hess_gicp_aniso_gathered(
        points, src_cov, pose, mu, cov_t, active, hess_lambda,
        max_mahal, max_corr_dist,
    )


def gicp_align_aniso(
    points: jax.Array,
    mask: jax.Array,
    src_cov: jax.Array,
    regmap: regmap_mod.RegMap,
    init_pose,
    cfg: NewtonConfig = NewtonConfig(),
    grid_shape: tuple = (256, 256, 64),
) -> NewtonResult:
    """Newton plane-to-plane GICP (regmap from gicp_map_aniso + build_regmap,
    src_cov from source_point_covariances)."""

    def eval_obj(pose):
        return score_grad_hess_gicp_aniso(
            points, mask, src_cov, pose, regmap, grid_shape, cfg.hess_lambda,
            max_corr_dist=cfg.gicp_max_corr_dist,
        )

    return _newton_loop(eval_obj, points.dtype, init_pose, cfg)
