"""Motion deskew of a sweep using per-point intra-scan time fractions.

The reference computes a per-point alpha = normalized intra-scan time
"for future deskew" (/root/reference/include/dataframe.hpp:406-433) but never
applies it. Here it is applied: given the body poses at sweep start and end,
each point is re-expressed in the end-of-sweep body frame by interpolating
the relative motion on the SE(3) geodesic:

    T_alpha = T_end^-1 * T(alpha),  T(alpha) = T_start * Exp(alpha * Log(T_start^-1 T_end))
    p_deskewed = T_end^-1 T(alpha) p

Fully batched: one Expmap per point (cheap closed forms on the VPU).
"""
from __future__ import annotations



import jax
import jax.numpy as jnp

from ..core import se3
from ..core.se3 import Pose3


@jax.jit
def deskew_points(
    points: jax.Array,  # (N, 3) body frame as decoded (sensor at sample time)
    alpha: jax.Array,  # (N,) in [0, 1]
    pose_start: Pose3,
    pose_end: Pose3,
) -> jax.Array:
    """Return points re-expressed in the end-of-sweep body frame."""
    xi = se3.local(pose_start, pose_end)  # (6,)
    # relative motion remaining after time alpha, expressed at the end frame:
    # T_end^-1 T(alpha) = Exp(xi)^-1 Exp(alpha xi) = Exp(-(1-alpha) xi) ... on
    # the one-parameter subgroup these commute exactly.
    rem = -(1.0 - alpha)[:, None] * xi[None, :]
    T = se3.expmap(rem)  # (N,) batched poses
    return jnp.einsum("nij,nj->ni", T.rot, points) + T.trans


def deskew_scan(scan, pose_start: Pose3, pose_end: Pose3):
    """Deskew a ScanBuffer in place (returns a new ScanBuffer).

    ``deskew_points`` is jitted: an EAGER elementwise chain would dispatch
    one device op per step of the expmap chain, every keyframe."""
    new_pts = deskew_points(scan.points, scan.alpha, pose_start, pose_end)
    return scan._replace(points=new_pts)
