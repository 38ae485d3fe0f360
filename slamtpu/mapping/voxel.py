"""Voxel key math for fixed-capacity device-side voxel maps.

The reference stores NDT leaves in a ``tsl::robin_map<size_t, Leaf>`` keyed by a
dense 1-D leaf index computed from floored voxel coordinates
(/root/reference/extern/svn_ndt/include/voxel_grid_covariance_impl.hpp:189-192)
and keeps a separate truncation-keyed archive voxel hash
(reference include/map.hpp:29-57). We replace both with a single
**packed int32 key**: voxel integer coordinates relative to a map origin, each
bounded to ``[0, GRID_DIM)`` with ``GRID_DIM = 1024``, packed as
``(x * 1024 + y) * 1024 + z`` which fits exactly in 30 bits. Keys sort
lexicographically by (x, y, z), enabling sort + segment-sum map construction
and ``searchsorted`` lookup — no device hash table needed.

We follow the *floor* convention everywhere (the reference's archive hash
truncates instead of flooring, a quirk SURVEY.md flags as a bug not to copy).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

GRID_DIM = 1024  # voxels per axis; 1024^3 = 2^30 fits int32
INVALID_KEY = np.iinfo(np.int32).max  # sorts to the end


def coords_of(points: jax.Array, origin: jax.Array, inv_resolution: jax.Array) -> jax.Array:
    """Floored integer voxel coordinates relative to ``origin``.

    points: (..., 3) float; origin: (3,) float (map lower corner);
    returns (..., 3) int32.
    """
    return jnp.floor((points - origin) * inv_resolution).astype(jnp.int32)


def pack(coords: jax.Array) -> jax.Array:
    """Pack int voxel coords (..., 3) into a single int32 key.

    Out-of-range coordinates map to INVALID_KEY.
    """
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    in_range = (
        (x >= 0) & (x < GRID_DIM) & (y >= 0) & (y < GRID_DIM) & (z >= 0) & (z < GRID_DIM)
    )
    key = (x * GRID_DIM + y) * GRID_DIM + z
    return jnp.where(in_range, key, INVALID_KEY)


def unpack(key: jax.Array) -> jax.Array:
    """Inverse of pack for valid keys: (...,) int32 -> (..., 3) int32."""
    z = key % GRID_DIM
    rem = key // GRID_DIM
    y = rem % GRID_DIM
    x = rem // GRID_DIM
    return jnp.stack([x, y, z], axis=-1)


def key_of_points(points: jax.Array, origin: jax.Array, inv_resolution: jax.Array,
                  valid: jax.Array | None = None) -> jax.Array:
    """Packed keys for points, with an optional validity mask."""
    key = pack(coords_of(points, origin, inv_resolution))
    if valid is not None:
        key = jnp.where(valid, key, INVALID_KEY)
    return key


def lookup(sorted_keys: jax.Array, query_keys: jax.Array):
    """Find slots of query keys in a sorted key array.

    Returns (slot, found): slot (...,) int32 indices into the map arrays
    (clamped in range), found (...,) bool.
    """
    cap = sorted_keys.shape[0]
    idx = jnp.searchsorted(sorted_keys, query_keys, side="left").astype(jnp.int32)
    idx = jnp.minimum(idx, cap - 1)
    found = (sorted_keys[idx] == query_keys) & (query_keys != INVALID_KEY)
    return idx, found


# DIRECT7 neighbor offsets: center + 6 face neighbors
# (/root/reference/extern/svn_ndt/include/voxel_grid_covariance_impl.hpp:559-600).
# Kept as numpy so importing this module never touches a JAX backend; they are
# converted to device arrays lazily at trace time wherever they are consumed.
DIRECT7_OFFSETS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [-1, 0, 0],
        [0, 1, 0],
        [0, -1, 0],
        [0, 0, 1],
        [0, 0, -1],
    ],
    dtype=np.int32,
)

DIRECT1_OFFSETS = np.zeros((1, 3), dtype=np.int32)
