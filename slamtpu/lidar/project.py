"""Device-side range-image -> point-cloud projection and filtering.

The reference fuses projection and filtering into its per-packet decode loop
(reference src/lidarcallback.cpp:703-884, AVX2 8-wide FMA). Here the
whole sweep is one fixed-shape elementwise program over the
(columns x subset_channels) grid — XLA spreads it over the device, the
natural widening of the 8-wide SIMD design:

    point = range * direction_lut[m_id, ch] + offset_lut[m_id]      (FMA)
    keep  = range in [rmin, rmax] & range > 0 & column valid
            & not inside vehicle box
            & (z in [zmin, zmax]  OR  reflectivity >= threshold)

Also computes the per-point normalized intra-scan time ``alpha`` used for
motion deskew (reference toPCLPointCloud,
/root/reference/include/dataframe.hpp:406-433).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ProjectionFilters(NamedTuple):
    """Filter constants (static per run; baked into the jitted kernel)."""

    range_min: float = 0.0
    range_max: float = 1e9
    z_min: float = -1e9
    z_max: float = 1e9
    reflectivity_threshold: float = 255.0
    box_min: tuple = (0.0, 0.0, 0.0)
    box_max: tuple = (0.0, 0.0, 0.0)


class ScanBuffer(NamedTuple):
    """Padded fixed-shape scan: flattened (cols*subset) points + validity.

    Carries the full per-point radiometry of the reference's SoA cloud
    (reflectivity + signal + NIR, /root/reference/include/dataframe.hpp:299-434)
    so intensity-aided consumers see everything the decoder produced; signal
    and NIR are None on paths that do not supply them (they are pytree leaves,
    so jitted consumers specialize per presence)."""

    points: jax.Array  # (N, 3) float32, body frame
    mask: jax.Array  # (N,) bool
    alpha: jax.Array  # (N,) float32 in [0, 1]: intra-scan time fraction
    reflectivity: jax.Array  # (N,) uint8
    num_points: jax.Array  # () int32
    signal: jax.Array | None = None  # (N,) uint16 signal photons
    nir: jax.Array | None = None  # (N,) uint16 ambient NIR


def project_frame(
    ranges_m: jax.Array,  # (cols, sub) float32
    reflectivity: jax.Array,  # (cols, sub) uint8
    col_timestamp_s: jax.Array,  # (cols,) float64/float32
    col_valid: jax.Array,  # (cols,) bool
    direction: jax.Array,  # (cols, sub, 3) float32
    offset: jax.Array,  # (cols, 3) float32
    filters: ProjectionFilters,
    signal: jax.Array | None = None,  # (cols, sub) uint16
    nir: jax.Array | None = None,  # (cols, sub) uint16
) -> ScanBuffer:
    pts = ranges_m[..., None] * direction + offset[:, None, :]  # (cols, sub, 3)

    in_range = (
        (ranges_m >= filters.range_min)
        & (ranges_m <= filters.range_max)
        & (ranges_m > 0.0)
        & col_valid[:, None]
    )
    bmin = jnp.asarray(filters.box_min, pts.dtype)
    bmax = jnp.asarray(filters.box_max, pts.dtype)
    in_box = jnp.all((pts >= bmin) & (pts <= bmax), axis=-1)
    z = pts[..., 2]
    z_or_refl = ((z >= filters.z_min) & (z <= filters.z_max)) | (
        reflectivity.astype(jnp.float32) >= filters.reflectivity_threshold
    )
    keep = in_range & ~in_box & z_or_refl

    # Normalized intra-scan time per column (0 where invalid).
    ts = col_timestamp_s.astype(jnp.float64)
    big = jnp.asarray(jnp.inf, ts.dtype)
    t0 = jnp.min(jnp.where(col_valid, ts, big))
    t1 = jnp.max(jnp.where(col_valid, ts, -big))
    span = jnp.maximum(t1 - t0, 1e-12)
    alpha_col = jnp.clip((ts - t0) / span, 0.0, 1.0).astype(jnp.float32)
    alpha = jnp.broadcast_to(alpha_col[:, None], ranges_m.shape)

    n = ranges_m.shape[0] * ranges_m.shape[1]
    return ScanBuffer(
        points=pts.reshape(n, 3),
        mask=keep.reshape(n),
        alpha=alpha.reshape(n),
        reflectivity=reflectivity.reshape(n),
        num_points=jnp.sum(keep, dtype=jnp.int32),
        signal=None if signal is None else signal.reshape(n),
        nir=None if nir is None else nir.reshape(n),
    )


def pack_frame(ranges_m, reflectivity, col_timestamp_s, col_valid,
               signal=None, nir=None):
    """Host side: one (cols, 2*sub + 2) float32 array carrying the whole
    decoded frame — each host->device transfer is a round trip, so the
    four per-frame inputs ship as ONE buffer.
    Column timestamps are re-based to the first column in float64 before the
    float32 cast (absolute day-seconds would quantize at ~10 us).

    With ``signal``/``nir`` ((cols, sub) uint16 each) the buffer widens to
    (cols, 4*sub + 2) and the packed projection carries them to the
    ScanBuffer — still ONE transfer (the width is a static shape, so the
    projection jit specializes per layout). uint16 is exact in float32."""
    import numpy as np

    cols, sub = ranges_m.shape
    extras = 2 * sub if signal is not None else 0
    out = np.empty((cols, 2 * sub + extras + 2), np.float32)
    out[:, :sub] = ranges_m
    out[:, sub : 2 * sub] = reflectivity
    if signal is not None:
        out[:, 2 * sub : 3 * sub] = signal
        out[:, 3 * sub : 4 * sub] = nir
    ts = np.asarray(col_timestamp_s, np.float64)
    valid = np.asarray(col_valid, bool)
    # rebase to the first VALID column — missing columns carry ts = 0.0, and
    # rebasing to one of those would leave ~86400-s absolutes whose float32
    # quantization (~10 ms) collapses the deskew alpha to a few levels
    base = ts[valid][0] if valid.any() else 0.0
    out[:, 2 * sub + extras] = ts - base
    out[:, 2 * sub + extras + 1] = valid
    return out


def project_frame_packed(
    packed: jax.Array,  # (cols, 2*sub + 2) or (cols, 4*sub + 2) from pack_frame
    direction: jax.Array,  # (cols, sub, 3) float32
    offset: jax.Array,  # (cols, 3) float32
    filters: ProjectionFilters,
) -> ScanBuffer:
    """project_frame on a pack_frame buffer (numerically identical)."""
    sub = direction.shape[1]
    ranges_m = packed[:, :sub]
    reflectivity = packed[:, sub : 2 * sub].astype(jnp.uint8)
    with_radiometry = packed.shape[1] == 4 * sub + 2
    extras = 2 * sub if with_radiometry else 0
    signal = nir = None
    if with_radiometry:
        signal = packed[:, 2 * sub : 3 * sub].astype(jnp.uint16)
        nir = packed[:, 3 * sub : 4 * sub].astype(jnp.uint16)
    col_timestamp_s = packed[:, 2 * sub + extras]
    col_valid = packed[:, 2 * sub + extras + 1] > 0.5
    return project_frame(
        ranges_m, reflectivity, col_timestamp_s, col_valid,
        direction, offset, filters, signal=signal, nir=nir,
    )


def filters_from_params(params) -> ProjectionFilters:
    """Build ProjectionFilters from a lidar.ouster.LidarParams."""
    import numpy as np

    half = np.asarray(params.vehicle_box_dimensions, np.float32) / 2.0
    center = np.asarray(params.vehicle_box_center, np.float32)
    return ProjectionFilters(
        range_min=float(params.range_filter[0]),
        range_max=float(params.range_filter[1]),
        z_min=float(params.z_filter[0]),
        z_max=float(params.z_filter[1]),
        reflectivity_threshold=float(params.reflectivity_threshold),
        box_min=tuple((center - half).tolist()),
        box_max=tuple((center + half).tolist()),
    )
