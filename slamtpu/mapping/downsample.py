"""Point-cloud downsampling / cropping utilities (device-side, fixed shape).

Fixed-shape array equivalents of the PCL filters the reference applies around its
mapping pipeline:

- ``voxel_downsample``: one point per occupied voxel — the centroid — like
  ``pcl::VoxelGrid`` (used at map distribution time with mapvoxelsize 0.5,
  /root/reference/run/pipeline_ins_map_distribution.cpp:324-341 and
  /root/reference/run/pipeline.cpp:858-859). Implemented with the same
  sort + segment-sum machinery as the Gaussian map: fixed capacity, padded
  output, compiled shapes static.
- ``axis_crop``: boolean band-pass on one coordinate axis, like
  ``pcl::PassThrough`` (/root/reference/run/pipeline.cpp:912-916). Masks
  only — fixed shapes mean no reallocation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import voxel


def voxel_downsample(
    points: jax.Array,
    mask: jax.Array,
    origin: jax.Array,
    resolution,
    capacity: int,
):
    """Centroid-per-voxel downsample over a padded point buffer.

    Returns (centroids (capacity, 3), out_mask (capacity,), overflow ())
    where ``overflow`` counts distinct occupied voxels dropped for capacity
    (the same observability contract as the map-build paths — silent
    thinning is not acceptable at map-distribution time). Slots beyond the
    number of occupied voxels are masked out and hold zeros. Voxels outside
    the [0, GRID_DIM)^3 key range around ``origin`` are dropped (match the
    fixed-capacity map convention, not PCL's unbounded grid).
    """
    finite = jnp.all(jnp.isfinite(points), axis=-1)
    keys = voxel.key_of_points(points, origin, 1.0 / jnp.asarray(resolution), mask & finite)
    order = jnp.argsort(keys)
    skeys = keys[order]
    spts = points[order]
    is_valid = skeys != voxel.INVALID_KEY
    first = (
        jnp.concatenate([jnp.ones((1,), bool), skeys[1:] != skeys[:-1]]) & is_valid
    )
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    seg = jnp.where(is_valid & (seg >= 0) & (seg < capacity), seg, capacity)
    n = jax.ops.segment_sum(
        jnp.ones_like(seg), seg, num_segments=capacity + 1
    )[:capacity]
    sx = jax.ops.segment_sum(spts, seg, num_segments=capacity + 1)[:capacity]
    out_mask = n > 0
    centroids = sx / jnp.maximum(n, 1).astype(spts.dtype)[:, None]
    centroids = jnp.where(out_mask[:, None], centroids, 0.0)
    n_distinct = jnp.sum(first, dtype=jnp.int32)
    overflow = jnp.maximum(n_distinct - capacity, 0)
    return centroids, out_mask, overflow


def axis_crop(points: jax.Array, mask: jax.Array, axis: int, lo, hi) -> jax.Array:
    """PassThrough band filter: keep masked points with lo <= p[axis] <= hi."""
    v = points[:, axis]
    return mask & (v >= lo) & (v <= hi)
