"""Registration-optimized map layout: dense-grid DIRECT7 without per-point search.

The baseline objective (slamtpu.ndt.objective) does 7 sorted-key binary
searches + 13-float gathers per point per iteration, and the searches and
small gathers dominate its evaluation. This module trades
per-map precomputation (amortized over all Newton/SVN iterations) for a
search-free per-point path:

1. **compacted payload**: valid voxels only, one (V+1, 16)-float row each
   [mean(3), icov(9), pad]; row V is an all-zero sentinel.
2. **dilated neighbor table**: every voxel within one face-step of an
   occupied voxel gets a row listing the payload rows of its 7 DIRECT7
   neighbors (sentinel V where missing). Points whose center cell is outside
   the dilated set have no neighbors by construction — exactly the DIRECT7
   semantics of the reference (voxel_grid_covariance_impl.hpp:559-600).
3. **dense slot grid**: a static-shape int32 grid over the dilated bounding
   box mapping cell -> dilated row (sentinel D outside/missing).

Per point per iteration this leaves: 1 grid gather + 1 mega-row gather +
fused math — no searchsorted in the hot loop. A random row gather pays per
row far more than per byte, so the payloads of all 7 DIRECT7 neighbors are
packed into ONE (D+1, 96)-float row per dilated cell:
[7 x (mean(3), icov(9))] + 7 validity flags + pad — one gathered row per
point and iteration (``pallas_math.gather_megaT``).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se3
from ..core.se3 import Pose3
from ..mapping import voxel
from ..mapping.gaussian_map import GaussianMap
from .objective import MAX_EXPONENT_ARG, MIN_FACTOR, NdtObjective, point_jacobian


class RegMap(NamedTuple):
    packed: jax.Array  # (D+1, 96): per dilated cell, 7 x [mean(3), icov(9)]
    #                    at offsets 12k, validity flags at 84..90, pad; row D=0
    grid: jax.Array  # (Gx*Gy*Gz + 1,) int32: cell -> dilated row (last = D)
    bbox_min: jax.Array  # (3,) int32 voxel coords of grid cell (0,0,0)
    origin: jax.Array  # (3,)
    resolution: jax.Array  # ()
    num_valid: jax.Array  # () int32
    overflow: jax.Array  # () int32: dilated cells dropped (capacity + bounds)
    # optional second mega-row table over the SAME dilated layout/grid,
    # carrying an alternative 12-float per-voxel payload (e.g. the
    # plane-regularized COVARIANCE for the anisotropic-GICP polish) — one
    # extra scatter at build time instead of a second full RegMap build.
    packed_aux: jax.Array | None = None

    @property
    def dilated_capacity(self) -> int:
        return self.packed.shape[0] - 1


def _unique_sorted(keys: jax.Array, capacity: int):
    """Sorted unique keys (INVALID-padded) from an array with duplicates.

    Also returns the number of distinct valid keys, so callers can detect
    capacity overflow (truncated voxels silently vanish otherwise)."""
    order = jnp.argsort(keys)
    sk = keys[order]
    first = jnp.concatenate([jnp.ones((1,), bool), sk[1:] != sk[:-1]]) & (
        sk != voxel.INVALID_KEY
    )
    uk = jnp.where(first, sk, voxel.INVALID_KEY)
    uk = jnp.sort(uk)
    return uk[:capacity], jnp.sum(first, dtype=jnp.int32)


@partial(jax.jit, static_argnames=("grid_shape", "dilated_capacity"))
def build_regmap(
    gmap: GaussianMap,
    grid_shape: tuple = (256, 256, 64),
    dilated_capacity: int | None = None,
    aux_payload: jax.Array | None = None,
) -> RegMap:
    """Precompute the registration layout from a finalized GaussianMap.

    Deliberately searchsorted-free: neighbor resolution goes through the
    dense grid (scatter once, gather per neighbor).

    ``aux_payload`` (V, 12): optional alternative per-voxel payload packed
    into ``RegMap.packed_aux`` over the same dilated layout (one extra
    full-row scatter instead of a second build).
    """
    V = gmap.capacity
    D = dilated_capacity or 4 * V
    gx, gy, gz = grid_shape
    n_cells = gx * gy * gz
    dtype = gmap.mean.dtype

    # 1) per-occupied-voxel payload rows (original map order; no sort needed)
    keys = jnp.where(gmap.valid, gmap.keys, voxel.INVALID_KEY)
    payload = jnp.concatenate([gmap.mean, gmap.icov.reshape(V, 9)], axis=1)
    payload = jnp.where(gmap.valid[:, None], payload, 0.0)

    # 2) dilated voxel set = occupied + 6 face neighbors (sort + unique)
    coords = voxel.unpack(keys)
    dil = voxel.pack(
        coords[None, :, :] + voxel.DIRECT7_OFFSETS[:, None, :]
    ).reshape(-1)
    dil = jnp.where(
        jnp.tile(keys != voxel.INVALID_KEY, 7), dil, voxel.INVALID_KEY
    )
    dkeys, n_distinct = _unique_sorted(dil, D)  # (D,) sorted unique, INVALID tail
    dvalid = dkeys != voxel.INVALID_KEY
    dcoords = voxel.unpack(dkeys)

    # 3) dense grid over the dilated bounding box: cell -> dilated row
    big = jnp.iinfo(jnp.int32).max
    bbox_min = jnp.min(jnp.where(dvalid[:, None], dcoords, big), axis=0)

    def cell_of(c3, valid):
        rel = c3 - bbox_min[None, :]
        ing = (
            valid
            & (rel[:, 0] >= 0) & (rel[:, 0] < gx)
            & (rel[:, 1] >= 0) & (rel[:, 1] < gy)
            & (rel[:, 2] >= 0) & (rel[:, 2] < gz)
        )
        return jnp.where(ing, (rel[:, 0] * gy + rel[:, 1]) * gz + rel[:, 2], n_cells)

    dflat = cell_of(dcoords, dvalid)
    # overflow accounting (truncated cells contribute nothing to registration;
    # apps warn when this is nonzero): distinct dilated cells beyond the D
    # capacity, plus surviving cells that fall outside the static grid extent
    out_of_grid = jnp.sum((dflat == n_cells) & dvalid, dtype=jnp.int32)
    overflow = jnp.maximum(n_distinct - D, 0) + out_of_grid
    grid = jnp.full((n_cells + 1,), D, jnp.int32)
    grid = grid.at[dflat].set(
        jnp.where(dvalid, jnp.arange(D, dtype=jnp.int32), D), mode="drop"
    )
    grid = grid.at[n_cells].set(D)

    # 4) mega-rows, scatter style: occupied voxel v is neighbor-slot j of the
    # dilated cell at (coords[v] - off_j) — that cell exists in the dilated
    # set by construction (off_j and -off_j are both DIRECT7 offsets), so one
    # full-row scatter-add of 7V rows writes every (cell, slot) payload. Rows
    # are disjoint per (v, j), values land on zeros, so add == set; dropped /
    # invalid targets go to row D+1 which is sliced off. It replaces a
    # (D, 7)-gather formulation (D = 4V is mostly padding).
    trow = jnp.concatenate(
        [
            grid[cell_of(coords - off[None, :], gmap.valid)]
            for off in voxel.DIRECT7_OFFSETS
        ]
    )  # (7V,) dilated row receiving each (voxel, slot) payload
    ok = jnp.tile(gmap.valid, 7) & (trow < D)
    # dropped updates spread over a V-row drop region (sliced off below) —
    # funneling them all into one row would serialize the scatter-add
    cid = jnp.arange(7 * V, dtype=jnp.int32)
    trow = jnp.where(ok, trow, D + 1 + cid % V)
    # (7V, 96) update rows: candidate block j carries the payload at columns
    # 12j..12j+12 and its validity flag at column 84+j — built with 7 static
    # one-hot blocks (no per-row dynamic slicing, which scatters horribly)
    j_of = jnp.repeat(jnp.arange(7), V)  # (7V,)
    flags = jnp.stack(
        [jnp.where(j_of == j, jnp.ones((7 * V,), dtype), 0.0) for j in range(7)],
        axis=1,
    )  # (7V, 7)

    def scatter_rows(pl):
        tiled = jnp.tile(pl, (7, 1))  # (7V, 12)
        blocks = [jnp.where((j_of == j)[:, None], tiled, 0.0) for j in range(7)]
        cols = jnp.concatenate(
            blocks + [flags, jnp.zeros((7 * V, 5), dtype)], axis=1
        )
        out = jnp.zeros((D + 1 + V, 96), dtype).at[trow].add(cols)
        return out[: D + 1]

    packed = scatter_rows(payload)
    packed_aux = None
    if aux_payload is not None:
        packed_aux = scatter_rows(
            jnp.where(gmap.valid[:, None], aux_payload.reshape(V, 12), 0.0)
        )

    return RegMap(
        packed=packed,
        grid=grid,
        bbox_min=bbox_min,
        origin=gmap.origin,
        resolution=gmap.resolution,
        num_valid=gmap.num_valid(),
        overflow=overflow,
        packed_aux=packed_aux,
    )


_KD_OFFSETS = np.stack(
    np.meshgrid(*([np.arange(-1, 2, dtype=np.int32)] * 3), indexing="ij"), -1
).reshape(27, 3)


@partial(jax.jit, static_argnames=("grid_shape", "dilated_capacity"))
def build_regmap_kdtree(
    gmap: GaussianMap,
    grid_shape: tuple = (256, 256, 64),
    dilated_capacity: int | None = None,
) -> RegMap:
    """KDTREE-search-mode analog of ``build_regmap``.

    The reference's KDTREE mode (voxel_grid_covariance_impl.hpp:443-554)
    builds a KdTree over valid-leaf CENTROIDS and radius-searches it per
    transformed point (radius = resolution), so a point contributes to every
    leaf whose centroid is within one resolution — including corner/edge
    neighbors DIRECT7 never sees, and leaves reachable from cells that are
    themselves empty.

    Array-program re-design — no tree, no per-point search: a leaf centroid lies
    inside its own voxel, so every leaf within ``resolution`` of a point in
    cell c sits in c's 3x3x3 cell neighborhood. At build time each cell of
    the 27-dilated set precomputes its <=7 nearest candidate leaves (by
    centroid-to-cell-center distance, a 27-way sort per cell); the result is
    a standard RegMap consumed by the unchanged mega-row query path. The
    exact radiusSearch gate |tp - mu| <= resolution is applied per point at
    gather time (``kd_radius``). Exact whenever <=7 leaves fall within the
    radius (the mega-row slot cap; beyond that the nearest-to-cell-center 7
    win). Build cost is a (D, 27) candidate gather — heavier than DIRECT7's
    scatter build; this mode buys fidelity, not speed.
    """
    V = gmap.capacity
    D = dilated_capacity or 6 * V
    gx, gy, gz = grid_shape
    n_cells = gx * gy * gz
    dtype = gmap.mean.dtype

    keys = jnp.where(gmap.valid, gmap.keys, voxel.INVALID_KEY)
    payload = jnp.concatenate([gmap.mean, gmap.icov.reshape(V, 9)], axis=1)
    payload = jnp.where(gmap.valid[:, None], payload, 0.0)

    # 27-dilated cell set (occupied + all edge/corner/face neighbors)
    coords = voxel.unpack(keys)
    offs = jnp.asarray(_KD_OFFSETS)
    dil = voxel.pack(coords[None, :, :] + offs[:, None, :]).reshape(-1)
    dil = jnp.where(
        jnp.tile(keys != voxel.INVALID_KEY, 27), dil, voxel.INVALID_KEY
    )
    dkeys, n_distinct = _unique_sorted(dil, D)
    dvalid = dkeys != voxel.INVALID_KEY
    dcoords = voxel.unpack(dkeys)

    big = jnp.iinfo(jnp.int32).max
    bbox_min = jnp.min(jnp.where(dvalid[:, None], dcoords, big), axis=0)

    def cell_of(c3, valid):
        rel = c3 - bbox_min[None, :]
        ing = (
            valid
            & (rel[:, 0] >= 0) & (rel[:, 0] < gx)
            & (rel[:, 1] >= 0) & (rel[:, 1] < gy)
            & (rel[:, 2] >= 0) & (rel[:, 2] < gz)
        )
        return jnp.where(ing, (rel[:, 0] * gy + rel[:, 1]) * gz + rel[:, 2], n_cells)

    dflat = cell_of(dcoords, dvalid)
    out_of_grid = jnp.sum((dflat == n_cells) & dvalid, dtype=jnp.int32)
    overflow = jnp.maximum(n_distinct - D, 0) + out_of_grid
    grid = jnp.full((n_cells + 1,), D, jnp.int32)
    grid = grid.at[dflat].set(
        jnp.where(dvalid, jnp.arange(D, dtype=jnp.int32), D), mode="drop"
    )
    grid = grid.at[n_cells].set(D)

    # occupied-cell grid: cell -> payload row (sentinel V)
    oflat = cell_of(coords, gmap.valid)
    occgrid = jnp.full((n_cells + 1,), V, jnp.int32)
    occgrid = occgrid.at[oflat].set(
        jnp.where(gmap.valid, jnp.arange(V, dtype=jnp.int32), V), mode="drop"
    )
    occgrid = occgrid.at[n_cells].set(V)

    # candidate leaves per dilated cell: its 27-neighborhood's occupants
    mu_table = jnp.concatenate([gmap.mean, jnp.zeros((1, 3), dtype)], axis=0)
    cand_rows = jnp.stack(
        [occgrid[cell_of(dcoords + o[None, :], dvalid)] for o in _KD_OFFSETS],
        axis=1,
    )  # (D, 27) payload rows, sentinel V
    cand_mu = mu_table[cand_rows]  # (D, 27, 3)
    center = (dcoords.astype(dtype) + 0.5) * gmap.resolution.astype(dtype) + (
        gmap.origin.astype(dtype)[None, :]
    )
    dist2 = jnp.sum((cand_mu - center[:, None, :]) ** 2, axis=-1)
    dist2 = jnp.where(cand_rows < V, dist2, jnp.inf)
    order = jnp.argsort(dist2, axis=1)[:, :7]  # (D, 7) nearest candidates
    sel_rows = jnp.take_along_axis(cand_rows, order, axis=1)  # (D, 7)
    sel_ok = jnp.take_along_axis(cand_rows < V, order, axis=1)

    pay_table = jnp.concatenate([payload, jnp.zeros((1, 12), dtype)], axis=0)
    fields = pay_table[jnp.where(sel_ok, sel_rows, V)]  # (D, 7, 12)
    packed = jnp.concatenate(
        [
            fields.reshape(D, 84),
            sel_ok.astype(dtype),
            jnp.zeros((D, 5), dtype),
        ],
        axis=1,
    )
    packed = jnp.where(dvalid[:, None], packed, 0.0)
    packed = jnp.concatenate([packed, jnp.zeros((1, 96), dtype)], axis=0)

    return RegMap(
        packed=packed,
        grid=grid,
        bbox_min=bbox_min,
        origin=gmap.origin,
        resolution=gmap.resolution,
        num_valid=gmap.num_valid(),
        overflow=overflow,
    )


def empty_regmap(
    capacity: int,
    grid_shape: tuple,
    dtype=jnp.float32,
    dilated_capacity: int | None = None,
    with_aux: bool = False,
) -> RegMap:
    """An all-empty RegMap with the same shapes build_regmap would produce —
    the initial cache value for apps that rebuild at reduced cadence."""
    D = dilated_capacity or 4 * capacity
    gx, gy, gz = grid_shape
    n_cells = gx * gy * gz
    return RegMap(
        packed=jnp.zeros((D + 1, 96), dtype),
        grid=jnp.full((n_cells + 1,), D, jnp.int32),
        bbox_min=jnp.zeros((3,), jnp.int32),
        origin=jnp.zeros((3,), dtype),
        resolution=jnp.asarray(1.0, dtype),
        num_valid=jnp.asarray(0, jnp.int32),
        overflow=jnp.asarray(0, jnp.int32),
        packed_aux=jnp.zeros((D + 1, 96), dtype) if with_aux else None,
    )


def point_rows(points, mask, pose: Pose3, regmap: RegMap, grid_shape):
    """Dense-grid lookup shared by every RegMap consumer: (tp (N,3),
    drow (N,) int32 dilated row per point, sentinel D for masked/out-of-grid).

    This is the SINGLE implementation of the RegMap indexing contract
    (bbox rebase, flat-index formula, sentinel conventions) — the fused
    kernel's gather (pallas_math.gather_megaT) and the XLA objective both
    route through it, so they cannot drift apart."""
    gx, gy, gz = grid_shape
    n_cells = gx * gy * gz
    # RegMap does not carry its (static) grid shape; a mismatched tuple maps
    # points to the wrong grid rows SILENTLY. This catches size mismatches at
    # trace time (a permutation with equal product remains the caller's duty).
    assert n_cells + 1 == regmap.grid.shape[0], (
        f"grid_shape {grid_shape} does not match the RegMap's grid "
        f"({regmap.grid.shape[0] - 1} cells) — pass the build-time tuple"
    )
    from .objective import sanitize_points

    dtype = points.dtype
    points, mask = sanitize_points(points, mask)
    tp = se3.transform_points(pose, points)  # (N, 3)
    inv_res = (1.0 / regmap.resolution).astype(dtype)
    coords = voxel.coords_of(tp, regmap.origin.astype(dtype), inv_res)
    rel = coords - regmap.bbox_min[None, :]
    inb = (
        mask
        & (rel[:, 0] >= 0) & (rel[:, 0] < gx)
        & (rel[:, 1] >= 0) & (rel[:, 1] < gy)
        & (rel[:, 2] >= 0) & (rel[:, 2] < gz)
    )
    flat = jnp.where(inb, (rel[:, 0] * gy + rel[:, 1]) * gz + rel[:, 2], n_cells)
    return tp, regmap.grid[flat]


def radius_gate(tp, mu, active_slot, kd_radius):
    """KDTREE-mode per-point gate: a slot contributes only when the leaf
    centroid lies within ``kd_radius`` of the transformed point — the exact
    radiusSearch predicate of the reference's KDTREE search mode
    (voxel_grid_covariance_impl.hpp:443-554). None/0 disables (DIRECT7)."""
    if kd_radius is None or kd_radius <= 0.0:
        return active_slot
    d2 = jnp.sum((tp[:, None, :] - mu) ** 2, axis=-1)
    return active_slot & (d2 <= kd_radius * kd_radius)


def gather_pair_data(
    points, mask, pose: Pose3, regmap: RegMap, grid_shape, kd_radius=None
):
    """The per-point voxel gather: (mu (N,7,3), icov (N,7,3,3), active (N,7)).

    Separated from the math so SVN can gather ONCE at the mean pose and reuse
    the Gaussians for all particles (their spread is << resolution).
    ``kd_radius`` applies the KDTREE-mode centroid-distance gate at the
    gather pose (see radius_gate; a RegMap from build_regmap_kdtree supplies
    the candidate slots)."""
    N = points.shape[0]
    tp, drow = point_rows(points, mask, pose, regmap, grid_shape)
    mega = regmap.packed[drow]  # (N, 96) — the ONE payload gather per point
    fields = mega[:, : 7 * 12].reshape(N, 7, 12)
    mu = fields[..., 0:3]
    icov = fields[..., 3:12].reshape(N, 7, 3, 3)
    active_slot = mega[:, 84:91] > 0.5  # (N, 7)
    active_slot = radius_gate(tp, mu, active_slot, kd_radius)
    return tp, mu, icov, active_slot


def gather_pair_aux(points, mask, pose: Pose3, regmap: RegMap, grid_shape):
    """Like gather_pair_data but against ``RegMap.packed_aux`` (the
    alternative 12-float payload — e.g. plane-regularized covariances for
    the anisotropic-GICP polish)."""
    N = points.shape[0]
    tp, drow = point_rows(points, mask, pose, regmap, grid_shape)
    mega = regmap.packed_aux[drow]
    fields = mega[:, : 7 * 12].reshape(N, 7, 12)
    return (
        tp,
        fields[..., 0:3],
        fields[..., 3:12].reshape(N, 7, 3, 3),
        mega[:, 84:91] > 0.5,
    )


def _pair_math(tp, mu, icov, active_slot, d1, d2):
    xrel = tp[:, None, :] - mu
    icx = jnp.einsum("nkij,nkj->nki", icov, xrel)
    mahal = jnp.maximum(jnp.einsum("nki,nki->nk", xrel, icx), 0.0)
    exponent = 0.5 * d2 * mahal
    ok = active_slot & (exponent <= MAX_EXPONENT_ARG) & jnp.isfinite(mahal)
    e = jnp.exp(-jnp.where(ok, exponent, 0.0))
    score_pairs = jnp.where(ok, -d1 * e, 0.0)
    factor = d1 * d2 * e
    active = ok & (jnp.abs(factor) >= MIN_FACTOR)
    factor = jnp.where(active, factor, 0.0)
    return icx, factor, score_pairs, ok, mahal


def _pair_terms_reg(
    points, mask, pose: Pose3, regmap: RegMap, d1, d2, grid_shape, kd_radius=None
):
    tp, mu, icov, active_slot = gather_pair_data(
        points, mask, pose, regmap, grid_shape, kd_radius=kd_radius
    )
    icx, factor, score_pairs, ok, mahal = _pair_math(tp, mu, icov, active_slot, d1, d2)
    return tp, icov, icx, factor, score_pairs, ok, mahal, active_slot


def score_grad_hess_gathered(
    points: jax.Array,
    pose: Pose3,
    mu: jax.Array,  # (N, 7, 3) from gather_pair_data at a nearby pose
    icov: jax.Array,  # (N, 7, 3, 3)
    active_slot: jax.Array,  # (N, 7)
    d1: float,
    d2: float,
    hess_lambda: float = 1e-6,
) -> NdtObjective:
    """NDT objective against pre-gathered Gaussians (SVN shared-gather path:
    neighbor sets come from the mean pose; contributions use this pose's
    exact transform)."""
    from .objective import sanitize_points

    points, _ = sanitize_points(points, jnp.ones(points.shape[0], bool))
    tp = se3.transform_points(pose, points)
    icx, factor, score_pairs, ok, _mahal = _pair_math(tp, mu, icov, active_slot, d1, d2)
    J = point_jacobian(points, pose)
    b = jnp.einsum("nk,nki->ni", factor, icx)
    M = jnp.einsum("nk,nkij->nij", factor, icov)
    grad = jnp.einsum("nia,ni->a", J, b)
    hess = jnp.einsum("nia,nij,njb->ab", J, M, J)
    hess = hess + hess_lambda * jnp.eye(6, dtype=hess.dtype)
    return NdtObjective(
        jnp.sum(score_pairs), grad, hess, jnp.sum(ok, dtype=jnp.int32)
    )


def score_grad_hess_reg(
    points: jax.Array,
    mask: jax.Array,
    pose: Pose3,
    regmap: RegMap,
    d1: float,
    d2: float,
    grid_shape: tuple,
    hess_lambda: float = 1e-6,
    kd_radius: float = None,
) -> NdtObjective:
    """Fused NDT objective on the RegMap layout (DIRECT7 semantics; parity
    with objective.score_grad_hess is tested in tests/test_regmap.py).
    ``kd_radius`` > 0 switches to the KDTREE-mode centroid gate."""
    from .objective import sanitize_points

    points, mask = sanitize_points(points, mask)
    tp, icov, icx, factor, score_pairs, ok, _mahal, _act = _pair_terms_reg(
        points, mask, pose, regmap, d1, d2, grid_shape, kd_radius=kd_radius
    )
    J = point_jacobian(points, pose)
    b = jnp.einsum("nk,nki->ni", factor, icx)
    M = jnp.einsum("nk,nkij->nij", factor, icov)
    grad = jnp.einsum("nia,ni->a", J, b)
    hess = jnp.einsum("nia,nij,njb->ab", J, M, J)
    hess = hess + hess_lambda * jnp.eye(6, dtype=hess.dtype)
    return NdtObjective(
        jnp.sum(score_pairs), grad, hess, jnp.sum(ok, dtype=jnp.int32)
    )
