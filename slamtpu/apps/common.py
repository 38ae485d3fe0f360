"""Shared app plumbing: replay-driven ingest and INS pose seeding.

Each app mirrors one reference executable (SURVEY.md section 2.5) but runs
from a replay file (or live UDP via slamtpu.runtime.udp): packets are decoded
host-side, synchronized, projected on device, and handed to the app's
per-keyframe step.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se3
from ..core.se3 import Pose3
from ..ins import geodesy
from ..ins.anpp import AnppDecoder, NavFrame
from ..lidar.ouster import FrameAssembler, build_luts
from ..lidar.project import (ScanBuffer, filters_from_params, pack_frame,
    project_frame_packed)
from ..runtime.config import PipelineConfig
from ..runtime.replay import STREAM_COMPASS, STREAM_LIDAR, read_replay
from ..runtime.sync import SyncedFrame, Synchronizer

log = logging.getLogger("slamtpu.apps")


def np_quat_to_rot(q) -> np.ndarray:
    """Host numpy port of core.so3.quat_to_rot ([w,x,y,z]; keeps eager
    device ops and their dispatches off this per-keyframe path)."""
    qw, qx, qy, qz = np.asarray(q, np.float64)
    n = qw * qw + qx * qx + qy * qy + qz * qz
    s = 2.0 / n if n > 0 else 2.0
    wx, wy, wz = s * qw * qx, s * qw * qy, s * qw * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def np_pose7(rot, trans) -> np.ndarray:
    """(7,) [qw qx qy qz tx ty tz] from a numpy rotation matrix + translation
    (the KeyFrameStats pose encoding; cf. map.hpp:91-108)."""
    R = np.asarray(rot, np.float64)
    t = np.asarray(trans, np.float64)
    # Shepperd's method (branch on the largest diagonal term)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    if q[0] < 0:
        q = -q
    return np.concatenate([q, t])


def np_between(a, b):
    """Relative pose a^-1 b for host (rot, trans) numpy tuples —
    (Ra^T Rb, Ra^T (tb - ta)), GTSAM Pose3::between semantics."""
    Ra, ta = np.asarray(a[0], np.float64), np.asarray(a[1], np.float64)
    Rb, tb = np.asarray(b[0], np.float64), np.asarray(b[1], np.float64)
    return Ra.T @ Rb, Ra.T @ (tb - ta)


def ins_pose_ned(nav: NavFrame, ref_lla: np.ndarray) -> Pose3:
    """NED pose of the body from a NavFrame: position via lla2ned around the
    reference origin, attitude from the fused quaternion (the INS seed used
    throughout the reference apps, e.g. run/pipeline_lo_svn.cpp:359-376).

    Runs fully host-side in numpy float64 — float32 latitude quantizes
    positions by ~0.6 m (see slamtpu.ins.geodesy), and the Pose3 leaves stay
    numpy so downstream host math costs no device round trips."""
    ned = geodesy.lla2ned(np.asarray(nav.lla, np.float64), np.asarray(ref_lla, np.float64))
    return Pose3(np_quat_to_rot(nav.quat), ned)


@dataclasses.dataclass
class IngestPipeline:
    """Replay/UDP packets -> SyncedFrames -> padded device ScanBuffers."""

    cfg: PipelineConfig

    def __post_init__(self):
        self.luts = build_luts(self.cfg.meta, self.cfg.lidar)
        self.assembler = FrameAssembler(self.cfg.meta, self.luts)
        self.anpp = AnppDecoder()
        self.sync = Synchronizer(self.cfg.nav_window)
        self.filters = filters_from_params(self.cfg.lidar)
        self._project = jax.jit(project_frame_packed, static_argnames=("filters",))
        self._dir = jnp.asarray(self.luts.direction)
        self._off = jnp.asarray(self.luts.offset)

    def synced_frames(self, replay_path: str) -> Iterator[SyncedFrame]:
        # Consecutive LiDAR payloads batch into one native decode call
        # (FrameAssembler.push_packets): per-packet Python parsing costs
        # ~35 ms per Berlin sweep, the batched path ~2 ms. The Synchronizer
        # buffers pending scans until nav coverage arrives, so decoding a
        # LiDAR run ahead of its interleaved compass packets is order-safe.
        batch: list = []

        def drain_lidar():
            for frame in self.assembler.push_packets(batch):
                yield from self.sync.push_scan(frame)
            batch.clear()

        for stream, _ts, payload in read_replay(replay_path):
            if stream == STREAM_LIDAR:
                batch.append(payload)
                if len(batch) >= 256:
                    yield from drain_lidar()
            elif stream == STREAM_COMPASS:
                yield from drain_lidar()
                nav = self.anpp.push_packet(payload)
                if nav is not None:
                    yield from self.sync.push_nav(nav)
        yield from drain_lidar()
        tail = self.assembler.flush()
        if tail is not None:
            yield from self.sync.push_scan(tail)

    def project(self, synced: SyncedFrame) -> ScanBuffer:
        fr = synced.scan
        packed = pack_frame(
            fr.ranges_m, fr.reflectivity, fr.col_timestamp_s, fr.col_valid,
            signal=fr.signal, nir=fr.nir,
        )
        return self._project(jnp.asarray(packed), self._dir, self._off, self.filters)


def maybe_deskew(scan: ScanBuffer, synced: SyncedFrame, ref_lla, enabled: bool) -> ScanBuffer:
    """INS-based motion compensation of a projected scan (lidar.deskew):
    re-expresses every point in the end-of-sweep body frame using the INS
    poses interpolated at the sweep interval ends."""
    if not enabled:
        return scan
    from ..lidar.deskew import deskew_scan
    from ..runtime.sync import interpolate_at

    # alpha is normalized over the SCAN's column span (lidar.project), not
    # over the sync interval — which starts at the PREVIOUS sweep's end, ~5 ms
    # (= 1.5 cm at 3 m/s) before the first column. Interpolate the nav window
    # at the scan's own start/end timestamps so alpha=0/1 match the poses.
    dt = scan.points.dtype  # ins_pose_ned returns host f64; scan path in f32
    nav_s = interpolate_at(synced.ins, synced.scan.timestamp)
    nav_e = interpolate_at(synced.ins, synced.scan.timestamp_end)
    pose_s = se3.cast(ins_pose_ned(nav_s, ref_lla), dt)
    pose_e = se3.cast(ins_pose_ned(nav_e, ref_lla), dt)
    return deskew_scan(scan, pose_s, pose_e)


class MapRebuildCadence:
    """Shared rebuild-cadence state for apps carrying a cached RegMap
    (RegisterConfig.map_rebuild_every): the map+RegMap build runs under
    lax.cond inside the fused step and only executes on rebuild keyframes.
    One implementation so lo_svn and ligo_tc keep identical invalidation
    semantics (periodic + forced on origin recentering)."""

    def __init__(self, register_cfg, grid_shape, with_aux: bool = False):
        self._every = max(int(register_cfg.map_rebuild_every), 1)
        self._idx = 0
        self.force_next = False  # set on resume: the cache starts empty
        if grid_shape is not None:
            from ..ndt.regmap import empty_regmap

            # the KDTREE builder dilates 27 ways (default 6V rows) vs
            # DIRECT7's 7 (4V); the cached empty map must match its shapes
            kdtree = "KDTREE" in (
                register_cfg.search_method, register_cfg.svn_search_method
            )
            self.regmap = empty_regmap(
                register_cfg.map_capacity, grid_shape,
                dilated_capacity=6 * register_cfg.map_capacity if kdtree else None,
                with_aux=with_aux and not kdtree,
            )
        else:
            self.regmap = None

    def tick(self, force: bool = False) -> bool:
        """Advance one keyframe; True when this keyframe must rebuild."""
        rebuild = force or self.force_next or (self._idx % self._every == 0)
        self.force_next = False
        self._idx += 1
        return rebuild


class VizHook:
    """Optional live-viewer attachment (``--viz``).

    The reference feeds visualizer threads through a viz queue with windowed
    cloud eviction (run/pipeline.cpp:826-985); here each keyframe's scan is
    stride-subsampled host-side, posed into the world frame with the
    published pose, and pushed to a :class:`slamtpu.runtime.viewer.LiveViewer`
    (which owns the sliding window). One ~100 KB device->host transfer per
    keyframe at the default stride — viz is opt-in, never on the bench path.
    """

    def __init__(self, viewer, stride: int = 8):
        self.viewer = viewer
        self.stride = max(int(stride), 1)

    def subsample(self, scan) -> np.ndarray:
        """Host (M, 3) body-frame points of a projected ScanBuffer.

        When the buffer carries reflectivity, the result is an (M, 4) array
        whose last column is the intensity channel — the viewer colors by it
        (reference parity: pipeline.cpp:919 colors clouds by intensity)."""
        pts = np.asarray(scan.points[:: self.stride])
        msk = np.asarray(scan.mask[:: self.stride])
        refl = getattr(scan, "reflectivity", None)
        if refl is not None:
            inten = np.asarray(refl[:: self.stride], np.float32)[msk]
            return np.concatenate([pts[msk], inten[:, None]], axis=1)
        return pts[msk]

    def push(
        self, body_pts: Optional[np.ndarray], pose, frame_id: int,
        ins_pose=None,
    ) -> None:
        """Pose a subsampled cloud into the world and feed the viewer; when
        the caller supplies the raw INS pose too, both trajectories render
        (optimized red vs INS green — the reference's live drift diagnostic,
        pipeline.cpp:862-864)."""
        if body_pts is None:
            return
        body_pts = np.asarray(body_pts)
        inten = None
        if body_pts.ndim == 2 and body_pts.shape[1] == 4:
            body_pts, inten = body_pts[:, :3], body_pts[:, 3]
        R = np.asarray(pose.rot, np.float64)
        t = np.asarray(pose.trans, np.float64)
        self.viewer.push_cloud(body_pts @ R.T + t, frame_id, intensity=inten)
        self.viewer.push_pose(
            t,
            ins_xyz=np.asarray(ins_pose.trans, np.float64)
            if ins_pose is not None
            else None,
        )


@dataclasses.dataclass
class TrajectoryEntry:
    timestamp: float
    frame_id: int
    pose: Pose3  # published pose (NED)
    ins_pose: Pose3
    covariance: Optional[np.ndarray] = None


def ate_rmse(traj_a: List[Pose3], traj_b: List[Pose3]) -> float:
    """Absolute trajectory error (translation RMSE), no alignment."""
    assert len(traj_a) == len(traj_b) and traj_a
    d = [
        np.linalg.norm(np.asarray(a.trans) - np.asarray(b.trans))
        for a, b in zip(traj_a, traj_b)
    ]
    return float(np.sqrt(np.mean(np.square(d))))


def np_sqrt_info_from_sigmas(sigmas) -> np.ndarray:
    """Host (numpy) diagonal whitening — avoids per-factor eager device
    ops."""
    return np.diag(1.0 / np.asarray(sigmas, np.float64))


def np_sqrt_info_from_cov(cov, jitter: float = 1e-12) -> np.ndarray:
    """Host (numpy) whitening S with S^T S = cov^-1 (lower-inverse)."""
    cov = np.asarray(cov, np.float64)
    d = cov.shape[-1]
    L = np.linalg.cholesky(cov + jitter * np.eye(d))
    return np.linalg.solve(L, np.eye(d))
