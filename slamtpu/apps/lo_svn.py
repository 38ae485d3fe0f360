"""SVN-NDT LiDAR odometry (the reference's primary pipeline,
/root/reference/run/pipeline_lo_svn.cpp).

Per keyframe: seed with the INS pose (lla2ned + fused quaternion), build the
NDT target map from a sliding window of keyframe clouds (the reference ships
with the window reduced to the last keyframe, :376-387; window size is a
config knob here), run SVN-NDT to get a pose posterior. The reference
currently *publishes* the INS pose while evaluating SVN (:388-390) — that
behavior is the ``publish="ins"`` option; default publishes the SVN mean.

The whole device path (map build + K-particle SVN flow) is one jitted call
over fixed-shape ring buffers of keyframe clouds.
"""
from __future__ import annotations

import dataclasses
import logging
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se3
from ..core.se3 import Pose3
from ..mapping import gaussian_map
from ..ndt import SvnConfig, svn_align
from ..runtime.config import PipelineConfig
from ..runtime.stats import KeyFrameStats, StageTimer, StatsArchive
from .common import (IngestPipeline, MapRebuildCadence, TrajectoryEntry,
    ins_pose_ned)
from .common import maybe_deskew as common_deskew

log = logging.getLogger("slamtpu.lo_svn")


def _lo_svn_core(
    kf_points,  # (K, N, 3) world-frame keyframe clouds (ring buffer, donated)
    kf_mask,  # (K, N) (donated)
    new_points,  # (N, 3) body frame
    new_mask,  # (N,)
    flat,  # (>=17,): [prior pose(12), origin(3), rebuild flag(1), ins-anchor flag(1)]
    head,  # () int32 ring-buffer slot to overwrite
    key,  # PRNG key (device-resident)
    regmap_in,  # RegMap from the previous rebuild (regmap path only)
    svn_cfg: SvnConfig,
    capacity: int,
    min_points: int,
    grid_shape: tuple = None,
    publish_svn: bool = True,
    scan_grid: tuple = None,  # (cols, sub) of the projected sweep: enables
    #   the range-image stencil source covariances (ndt.gicp.
    #   stencil_point_covariances, no sort unlike the voxel path)
    exclude_recent=None,  # () int32: rebuilds skip the newest
    #   ``exclude_recent`` ring clouds (RegisterConfig.map_exclude_recent).
    #   Registration against content rendered from viewpoints close to the
    #   current one carries a measured viewpoint-proximity bias (~10 mm at
    #   0.3 m separation, decaying below 1 mm past ~1.5 m at Berlin scale,
    #   measured); the nearest clouds add no coverage the scan
    #   lacks, so dropping them removes the bias at zero cost. None keeps
    #   the full-window reference semantics.
):
    """One fused SVN keyframe: map build over the keyframe window, K-particle
    SVN flow, ring-buffer insert of the new cloud at the anchor pose, and
    PRNG split — all in one dispatch. The scalar results return as ONE (52,)
    vector [pose(12), cov(36), iterations, converged, n_voxels, score]:
    one transfer instead of one per array.

    The map+RegMap rebuild (a sort-heavy build over the whole keyframe
    window) only runs when the rebuild flag is set; in between, registration
    targets the cached RegMap — up to ``map_rebuild_every - 1`` keyframes
    stale, which steady-state odometry tolerates (the window content changes
    by one scan per keyframe). rebuild_every=1 reproduces the reference's
    per-keyframe setInputTarget semantics (run/pipeline_lo_svn.cpp:376-387)."""
    f32 = jnp.float32
    prior = Pose3(flat[0:9].reshape(3, 3).astype(f32), flat[9:12].astype(f32))
    origin = flat[12:15].astype(f32)
    rebuild = flat[15] > 0.5
    key, sub = jax.random.split(key)
    K, N, _ = kf_points.shape
    bmask = kf_mask
    if exclude_recent is not None:
        # ring age of slot s: 0 = newest (slot head - 1), K-1 = oldest
        ages = jnp.mod(head - 1 - jnp.arange(K), K)
        bmask = kf_mask & (ages >= exclude_recent)[:, None]
    if grid_shape is None:
        gmap = gaussian_map.build_map(
            kf_points.reshape(K * N, 3),
            bmask.reshape(K * N),
            origin,
            svn_cfg.resolution,
            capacity=capacity,
            min_points_per_voxel=min_points,
        )
        res = svn_align(new_points, new_mask, gmap, prior, sub, svn_cfg)
        regmap = regmap_in
        n_voxels = gmap.num_valid()
    else:
        from ..ndt import build_regmap, build_regmap_kdtree, svn_align_reg

        aniso = svn_cfg.polish_iters > 0 and svn_cfg.polish_objective == "gicp_aniso"

        def _builder(gmap, grid_shape):
            if svn_cfg.kd_radius > 0:
                return build_regmap_kdtree(gmap, grid_shape=grid_shape)
            aux = None
            if aniso:
                # polish payload: plane-regularized target covariances for
                # the anisotropic-GICP mode (one extra scatter at build time)
                from ..ndt import regularize_plane_covariance

                cov_r = regularize_plane_covariance(gmap.cov)
                aux = jnp.concatenate(
                    [gmap.mean, cov_r.reshape(-1, 9)], axis=1
                )
            return build_regmap(gmap, grid_shape=grid_shape, aux_payload=aux)

        def do_build(_):
            with jax.named_scope("map_rebuild"):
                gmap = gaussian_map.build_map(
                    kf_points.reshape(K * N, 3),
                    bmask.reshape(K * N),
                    origin,
                    svn_cfg.resolution,
                    capacity=capacity,
                    min_points_per_voxel=min_points,
                )
                rm = _builder(gmap, grid_shape=grid_shape)
            # match the cache's dtypes exactly (x64 test mode widens some
            # scalars) — cond branches must agree
            return jax.tree.map(lambda a, e: a.astype(e.dtype), rm, regmap_in)

        regmap = jax.lax.cond(rebuild, do_build, lambda _: regmap_in, None)
        src_cov = None
        if aniso:
            with jax.named_scope("src_covariances"):
                if scan_grid is not None:
                    from ..ndt.gicp import stencil_point_covariances

                    src_cov = stencil_point_covariances(
                        new_points, new_mask, scan_grid
                    )
                else:
                    from ..ndt import source_point_covariances

                    src_cov = source_point_covariances(
                        new_points, new_mask, svn_cfg.resolution,
                        capacity=min(capacity, 1 << 14),
                        min_points_per_voxel=min_points,
                    )
        res = svn_align_reg(
            new_points, new_mask, regmap, prior, sub, svn_cfg, grid_shape,
            src_cov=src_cov,
        )
        n_voxels = regmap.num_valid
    published = res.pose if publish_svn else prior
    # ring insert at the ANCHOR pose: flat[16] selects the INS prior (the
    # reference's target clouds sit at INS-derived poses,
    # run/pipeline_lo_svn.cpp:376-390 — keeps SVN per-keyframe errors from
    # compounding through the map) or the published odometry pose
    with jax.named_scope("ring_insert"):
        anchor = jax.tree.map(
            lambda a, b: jnp.where(flat[16] > 0.5, a, b), prior, published
        )
        world_pts = se3.transform_points(anchor, new_points)
        kf_points = kf_points.at[head].set(world_pts)
        kf_mask = kf_mask.at[head].set(new_mask)
    scalars = jnp.concatenate(
        [
            published.rot.ravel().astype(f32),
            published.trans.astype(f32),
            res.covariance.ravel().astype(f32),
            jnp.stack(
                [
                    res.iterations.astype(f32),
                    res.converged.astype(f32),
                    n_voxels.astype(f32),
                    res.score.astype(f32),
                ]
            ),
        ]
    )
    return kf_points, kf_mask, key, scalars, regmap


@partial(
    jax.jit,
    static_argnames=(
        "svn_cfg", "capacity", "min_points", "grid_shape", "publish_svn",
        "scan_grid",
    ),
    donate_argnums=(0, 1),
)
def _lo_svn_step(
    kf_points, kf_mask, new_points, new_mask, flat, head, key, regmap_in,
    svn_cfg: SvnConfig, capacity: int, min_points: int,
    grid_shape: tuple = None, publish_svn: bool = True,
    scan_grid: tuple = None, exclude_recent=None,
):
    """Fused keyframe on an already-projected scan (see _lo_svn_core)."""
    return _lo_svn_core(
        kf_points, kf_mask, new_points, new_mask, flat, head, key, regmap_in,
        svn_cfg, capacity, min_points, grid_shape, publish_svn, scan_grid,
        exclude_recent,
    )


@partial(
    jax.jit,
    static_argnames=(
        "svn_cfg", "capacity", "min_points", "grid_shape", "publish_svn",
        "scan_grid", "filters", "deskew",
    ),
    donate_argnums=(0, 1),
)
def _lo_svn_step_packed(
    kf_points,  # (K, N, 3) (donated)
    kf_mask,  # (K, N) (donated)
    packed,  # (cols, W) pack_frame buffer: the ONE host->device transfer
    dir_lut,  # (cols, sub, 3) device-resident projection LUT
    off_lut,  # (cols, 3)
    flat,  # (41,): [prior(12), origin(3), rebuild(1), ins-anchor(1),
    #   deskew pose_start(12), deskew pose_end(12)]
    head,
    key,
    regmap_in,
    svn_cfg: SvnConfig,
    capacity: int,
    min_points: int,
    grid_shape: tuple = None,
    publish_svn: bool = True,
    scan_grid: tuple = None,
    filters=None,  # ProjectionFilters (static NamedTuple)
    deskew: bool = True,
    exclude_recent=None,  # see _lo_svn_core
):
    """The WHOLE per-keyframe device path in one dispatch: range-image
    projection + filtering, INS motion deskew, map build (rebuild keyframes),
    K-particle SVN flow, and the ring insert. Fusing projection/deskew into
    the registration step removes two dispatches and their host round
    trips per keyframe. The scalar vector gains num_points at slot 52
    ((53,) total)."""
    from ..lidar.deskew import deskew_points
    from ..lidar.project import project_frame_packed

    with jax.named_scope("project"):
        scan = project_frame_packed(packed, dir_lut, off_lut, filters)
    new_points, new_mask = scan.points, scan.mask
    if deskew:
        with jax.named_scope("deskew"):
            f32 = jnp.float32
            pose_s = Pose3(
                flat[17:26].reshape(3, 3).astype(f32), flat[26:29].astype(f32)
            )
            pose_e = Pose3(
                flat[29:38].reshape(3, 3).astype(f32), flat[38:41].astype(f32)
            )
            new_points = deskew_points(new_points, scan.alpha, pose_s, pose_e)
    kf_points, kf_mask, key, scalars, regmap = _lo_svn_core(
        kf_points, kf_mask, new_points, new_mask, flat, head, key, regmap_in,
        svn_cfg, capacity, min_points, grid_shape, publish_svn, scan_grid,
        exclude_recent,
    )
    scalars = jnp.concatenate(
        [scalars, scan.num_points.astype(jnp.float32)[None]]
    )
    return kf_points, kf_mask, key, scalars, regmap


@dataclasses.dataclass
class LoSvnApp:
    cfg: PipelineConfig
    publish: str = "svn"  # "svn" | "ins" (reference parity: "ins")
    anchor: str = "ins"  # "ins" | "odom": pose at which keyframe clouds enter
    #   the target ring. "ins" matches the reference (clouds at INS-derived
    #   poses, pipeline_lo_svn.cpp:376-390) and keeps per-keyframe SVN errors
    #   from compounding through the map; "odom" is pure LO (drifts)
    seed: int = 1337

    def __post_init__(self):
        self.ingest = IngestPipeline(self.cfg)
        reg = self.cfg.register
        self.svn_cfg = SvnConfig(
            resolution=reg.svn_resolution,
            outlier_ratio=reg.svn_outlier_ratio,
            num_particles=reg.svn_particles,
            max_iterations=reg.svn_max_iterations,
            kernel_h=reg.svn_kernel_h,
            step_size=reg.svn_step_size,
            stop_thresh=reg.svn_stop_thresh,
            use_direct1=reg.svn_search_method == "DIRECT1",
            kd_radius=reg.svn_resolution
            if reg.svn_search_method == "KDTREE"
            else 0.0,
            polish_iters=reg.svn_polish_iters,
            # KDTREE mode shares the regmap slots with the radius gate; its
            # layout has no aux payload, so the polish stays on the NDT score
            polish_objective=reg.svn_polish_objective
            if reg.svn_search_method != "KDTREE"
            else "ndt",
            polish_from=reg.svn_polish_from,
        )
        self._trajectory: List[TrajectoryEntry] = []
        self._stats_archive = StatsArchive()
        self.viz = None  # Optional[common.VizHook] — set by the CLI's --viz
        self._pending: List[tuple] = []  # keyframes whose device results are
        #   still in flight: the per-keyframe host sync is deferred so the
        #   next frame's decode overlaps the device step (the prior is the
        #   INS pose — host data — so there is no true dependency)
        self._n_keyframes = 0
        self.timer = StageTimer()
        self._ref_lla: Optional[np.ndarray] = None
        self._kf_points = None  # (K, N, 3) ring buffer
        self._kf_mask = None
        self._kf_head = 0
        self._origin = None
        self._key = jax.random.PRNGKey(self.seed)
        # range-image layout of projected sweeps (for the stencil source
        # covariances); None falls back to the sort-based voxel path
        self._scan_grid = (
            (self.cfg.meta.columns_per_frame, self.ingest.luts.subset_channels)
            if reg.svn_src_cov == "stencil"
            else None
        )
        self._cadence = MapRebuildCadence(
            reg,
            tuple(reg.reg_grid_shape) if reg.use_regmap else None,
            with_aux=self.svn_cfg.polish_iters > 0
            and self.svn_cfg.polish_objective == "gicp_aniso",
        )

    @property
    def trajectory(self) -> List[TrajectoryEntry]:
        self.flush()
        return self._trajectory

    @property
    def stats(self) -> StatsArchive:
        self.flush()
        return self._stats_archive

    def save_checkpoint(self, path: str):
        """Persist the odometry state (keyframe ring, origin, PRNG key) so a
        later run continues exactly — runtime.checkpoint.save_lo_svn."""
        from ..runtime import checkpoint

        checkpoint.save_lo_svn(path, self)

    def resume_from(self, path: str):
        """Restore a checkpoint; subsequent scans continue the trajectory."""
        from ..runtime import checkpoint

        checkpoint.load_lo_svn(path, self)
        return self

    def run_replay(self, replay_path: str, max_keyframes: int = 10**9):
        for synced in self.ingest.synced_frames(replay_path):
            self.process(synced)
            if self._n_keyframes >= max_keyframes:
                break
        return self.trajectory

    def flush(self):
        """Materialize in-flight keyframe results (one host sync for all)."""
        pending, self._pending = self._pending, []
        if pending and self._cadence.regmap is not None:
            ovf = int(self._cadence.regmap.overflow)
            if ovf and not getattr(self, "_ovf_warned", False):
                self._ovf_warned = True
                log.warning(
                    "RegMap truncated %d dilated cells (capacity/grid too "
                    "small) — raise map_capacity or reg_grid_shape", ovf,
                )
        for synced, num_points, ins_pose, dt_ms, scalars, viz_pts in pending:
            scalars = np.asarray(scalars, np.float64)
            published = Pose3(scalars[0:9].reshape(3, 3), scalars[9:12])
            cov = scalars[12:48].reshape(6, 6)
            iters, converged, _n_voxels, score = scalars[48:52]
            if num_points is None:  # packed step: num_points rides slot 52
                num_points = scalars[52]
            if self.viz is not None:
                self.viz.push(
                    viz_pts, published, synced.scan.frame_id, ins_pose=ins_pose
                )
            self._record(
                synced, int(num_points), published, ins_pose, cov,
                int(iters), bool(converged > 0.5), float(score), dt_ms,
            )

    def _exclude_recent(self):
        """Per-keyframe exclusion count for map rebuilds (None disables —
        identical trace to the full-window semantics). Clamped so the build
        always keeps at least one ring cloud during the fill-up phase."""
        e = int(self.cfg.register.map_exclude_recent)
        if e <= 0:
            return None
        filled = min(self._n_keyframes, int(self.cfg.register.keyframe_window))
        return jnp.int32(min(e, max(filled - 1, 0)))

    def _deskew_interval_poses(self, synced):
        """Host-side INS poses at the sweep's own start/end timestamps (the
        deskew endpoints, see common.maybe_deskew for why not the sync
        interval); numpy f64 throughout."""
        from ..runtime.sync import interpolate_at

        nav_s = interpolate_at(synced.ins, synced.scan.timestamp)
        nav_e = interpolate_at(synced.ins, synced.scan.timestamp_end)
        return (
            ins_pose_ned(nav_s, self._ref_lla),
            ins_pose_ned(nav_e, self._ref_lla),
        )

    def process(self, synced):
        nav_end = synced.ins[-1]
        if self._ref_lla is None:
            # first keyframe: fix the geodetic reference + map origin
            self._ref_lla = np.asarray(nav_end.lla)
        ins_pose = ins_pose_ned(nav_end, self._ref_lla)
        if self._kf_points is None:
            with self.timer.span("project"):
                scan = self.ingest.project(synced)
            scan = common_deskew(scan, synced, self._ref_lla, self.cfg.deskew)
            K = self.cfg.register.keyframe_window
            N = scan.points.shape[0]
            self._kf_points = jnp.zeros((K, N, 3), jnp.float32)
            self._kf_mask = jnp.zeros((K, N), bool)
            grid_half = 512.0 * self.svn_cfg.resolution
            self._origin = jnp.asarray(
                np.asarray(ins_pose.trans) - grid_half, jnp.float32
            )
            world = se3.transform_points(se3.cast(Pose3(
                jnp.asarray(ins_pose.rot), jnp.asarray(ins_pose.trans)), jnp.float32),
                scan.points)
            self._kf_points = self._kf_points.at[self._kf_head].set(world)
            self._kf_mask = self._kf_mask.at[self._kf_head].set(scan.mask)
            self._kf_head = (self._kf_head + 1) % self._kf_points.shape[0]
            self._n_keyframes += 1
            if self.viz is not None:
                self.viz.push(
                    self.viz.subsample(scan), ins_pose, synced.scan.frame_id,
                    ins_pose=ins_pose,
                )
            self._record(
                synced, int(scan.num_points), ins_pose, ins_pose, None, 0,
                True, 0.0, 0.0,
            )
            return
        self._origin, shifted = gaussian_map.recenter_origin(
            self._origin, np.asarray(ins_pose.trans), self.svn_cfg.resolution
        )
        if shifted:
            log.info("map origin recentered at keyframe %d", synced.scan.frame_id)
        reg = self.cfg.register
        grid_shape = tuple(reg.reg_grid_shape) if reg.use_regmap else None
        # rebuild the registration target every map_rebuild_every keyframes
        # (a recentered origin invalidates the cache unconditionally)
        rebuild = self._cadence.tick(force=shifted)
        if self.cfg.deskew:
            pose_s, pose_e = self._deskew_interval_poses(synced)
        else:
            pose_s = pose_e = ins_pose
        flat = np.concatenate(
            [
                np.asarray(ins_pose.rot, np.float64).ravel(),
                np.asarray(ins_pose.trans, np.float64),
                np.asarray(self._origin, np.float64),
                [1.0 if rebuild else 0.0],
                [1.0 if self.anchor == "ins" else 0.0],
                np.asarray(pose_s.rot, np.float64).ravel(),
                np.asarray(pose_s.trans, np.float64),
                np.asarray(pose_e.rot, np.float64).ravel(),
                np.asarray(pose_e.trans, np.float64),
            ]
        ).astype(np.float32)
        viz_pts = None
        if self.viz is not None:
            # the hot path never materializes a ScanBuffer; project one on
            # the side for the viewer (viz runs are not perf runs)
            scan_v = common_deskew(
                self.ingest.project(synced), synced, self._ref_lla,
                self.cfg.deskew,
            )
            viz_pts = self.viz.subsample(scan_v)
        fr = synced.scan
        with self.timer.span("svn_step"):
            from ..lidar.project import pack_frame

            packed = pack_frame(
                fr.ranges_m, fr.reflectivity, fr.col_timestamp_s,
                fr.col_valid, signal=fr.signal, nir=fr.nir,
            )
            self._kf_points, self._kf_mask, self._key, scalars, self._cadence.regmap = (
                _lo_svn_step_packed(
                    self._kf_points,
                    self._kf_mask,
                    jnp.asarray(packed),
                    self.ingest._dir,
                    self.ingest._off,
                    flat,
                    jnp.int32(self._kf_head),
                    self._key,
                    self._cadence.regmap,
                    self.svn_cfg,
                    reg.map_capacity,
                    reg.min_points_per_voxel,
                    grid_shape,
                    self.publish == "svn",
                    self._scan_grid,
                    self.ingest.filters,
                    self.cfg.deskew,
                    self._exclude_recent(),
                )
            )
        self._kf_head = (self._kf_head + 1) % int(self.cfg.register.keyframe_window)
        self._n_keyframes += 1
        self._pending.append(
            (synced, None, ins_pose,
             self.timer.last_ms("svn_step"), scalars, viz_pts)
        )
        if len(self._pending) >= 64:  # bound the in-flight queue
            self.flush()

    def _record(
        self, synced, num_points, pose, ins_pose, cov, iters, converged,
        score, dispatch_ms,
    ):
        from .common import np_pose7

        self._trajectory.append(
            TrajectoryEntry(
                timestamp=synced.t_end,
                frame_id=synced.scan.frame_id,
                pose=pose,
                ins_pose=ins_pose,
                covariance=cov,
            )
        )
        ins7 = np_pose7(np.asarray(ins_pose.rot), np.asarray(ins_pose.trans))
        opt7 = np_pose7(np.asarray(pose.rot), np.asarray(pose.trans))
        self._stats_archive.add(
            KeyFrameStats(
                frame_id=synced.scan.frame_id,
                timestamp=synced.t_end,
                num_points=num_points,
                # dispatch wall time: the device step itself runs async and
                # overlaps the next frame's decode (see flush())
                align_time_ms=max(dispatch_ms, 1e-3),
                ndt_iterations=iters,
                converged=converged,
                score=score,
                ins_sigma=np.concatenate(
                    [np.asarray(synced.ins[-1].sigma_rpy), np.asarray(synced.ins[-1].sigma_pos)]
                ),
                lidar_sigma=np.sqrt(np.maximum(np.diag(cov), 0.0))
                if cov is not None
                else np.zeros(6),
                ins_pose=ins7,
                optimized_pose=opt7,
                # per-keyframe INS-vs-optimized translation gap
                # (pipeline.cpp:745-752)
                pose_rmse=float(np.linalg.norm(ins7[4:] - opt7[4:])),
            )
        )
