"""Tightly-coupled LiDAR-IMU-GNSS odometry (the reference ``pipeline_ligo_tc``,
/root/reference/run/pipeline_ligo_tc.cpp — its glue is rotted against current
decoder APIs; the logic here follows its factor-graph structure, which is
authoritative per SURVEY.md).

Per keyframe (:339-622):
1. preintegrate the per-scan INS raw-IMU window (packet-28 accel/gyro) from
   the previous keyframe bias (:429-449)
2. predicted = preintegration forward propagation (:453)
3. CombinedImuFactor chain on (x, v, b) (:459-463)
4. INS pose prior with trust-gain scaling (:465-506)
5. Newton-NDT between-factor against the keyframe-window target cloud,
   initialized from the IMU prediction (:517-542)
6. window re-solve (replaces iSAM2 :578-587); predict next
Initialization places priors on x/v/b incl. WGS84 gravity (:365-404).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se3
from ..core.se3 import Pose3
from functools import partial

from ..fusion import (
    ImuBias,
    ImuNoise,
    NavState,
    SmootherConfig,
    WindowState,
    empty_factors,
    integrate,
    marginal_covariance,
    predict,
)
from ..fusion import robust, smoother
from ..ins.gravity import gravity_wgs84
from ..mapping import gaussian_map
from ..ndt import NewtonConfig
from ..runtime.config import PipelineConfig
from ..runtime.stats import KeyFrameStats, StageTimer, StatsArchive
from .common import (IngestPipeline, MapRebuildCadence, TrajectoryEntry,
    ins_pose_ned, maybe_deskew, np_between, np_pose7, np_sqrt_info_from_cov,
    np_sqrt_info_from_sigmas)
from .odom_ndt import _register_step
from .packed import PackedStep

log = logging.getLogger("slamtpu.ligo_tc")

IMU_WINDOW_CAPACITY = 64  # padded samples per scan interval (50 Hz x ~0.2 s)


@partial(
    jax.jit,
    static_argnames=("cfg", "capacity", "min_points", "grid_shape", "inner_iters"),
)
def _ligo_step(
    kf_points,  # (K, N, 3) keyframe-window clouds, BODY frame
    kf_mask,  # (K, N) False rows disable empty slots
    kf_poses,  # (K, 12) optimized world poses of the window keyframes
    new_points,  # (N, 3) body frame
    new_mask,
    imu,  # (IMU_WINDOW_CAPACITY, 7): [accel(3), gyro(3), dt]
    flat,  # (28,): [prev_opt_pose(12), vel(3), bias(6), gravity(3), origin(3),
    #               rebuild flag(1)]
    regmap_in,  # RegMap cache (None when use_regmap is off)
    noise: ImuNoise,
    cfg: NewtonConfig,
    capacity: int,
    min_points: int,
    grid_shape: tuple,
    inner_iters: int = 2,
):
    """One fully-fused tightly-coupled keyframe (pipeline_ligo_tc.cpp:
    429-542): preintegrate the IMU window, forward-predict, transform the
    target keyframe WINDOW to its optimized poses (the reference accumulates
    the targetID window into one fused target cloud, :519-527), build the
    NDT map, register from the IMU prediction with the prior-pose
    regularization pulling toward it (setRegularizationPose, :531). Small
    inputs ride in packed arrays; the result is ONE flat vector [pim(292),
    predicted_vel(3), pose(12), hessian(36), score, iterations, converged] —
    one transfer instead of one per array."""
    f32 = jnp.float32
    prev_pose = Pose3(flat[0:9].reshape(3, 3), flat[9:12])
    vel = flat[12:15]
    bias = ImuBias(flat[15:18], flat[18:21])
    gravity = flat[21:24]
    origin = flat[24:27].astype(f32)
    rebuild = flat[27] > 0.5
    pim = integrate(imu[:, 0:3], imu[:, 3:6], imu[:, 6], bias, noise)
    predicted = predict(NavState(prev_pose, vel), bias, pim, gravity)
    K, N, _ = kf_points.shape
    wposes = Pose3(
        kf_poses[:, 0:9].reshape(K, 3, 3).astype(f32), kf_poses[:, 9:12].astype(f32)
    )
    world = jax.vmap(se3.transform_points)(wposes, kf_points)
    pred32 = se3.cast(predicted.pose, f32)
    out = _register_step(
        world.reshape(K * N, 3),
        kf_mask.reshape(K * N), new_points, new_mask,
        pred32, origin,
        cfg, capacity, min_points, grid_shape,
        reg_pose=pred32,
        regmap_cache=regmap_in if grid_shape is not None else None,
        rebuild=rebuild,
        inner_iters=inner_iters,
    )
    res, regmap = out if grid_shape is not None else (out, regmap_in)
    dt = flat.dtype
    return regmap, jnp.concatenate(
        [
            pim.dR.ravel(), pim.dv, pim.dp, jnp.reshape(pim.dt, (1,)),
            pim.dR_dbg.ravel(), pim.dv_dba.ravel(), pim.dv_dbg.ravel(),
            pim.dp_dba.ravel(), pim.dp_dbg.ravel(),
            pim.bias_hat.vec(), pim.cov.ravel(),
            predicted.vel,
            res.pose.rot.ravel().astype(dt), res.pose.trans.astype(dt),
            res.hessian.ravel().astype(dt),
            jnp.stack(
                [res.score.astype(dt), res.iterations.astype(dt),
                 res.converged.astype(dt)]
            ),
        ]
    )


@dataclasses.dataclass
class LigoTcApp:
    cfg: PipelineConfig
    window: int = 6

    def __post_init__(self):
        self.ingest = IngestPipeline(self.cfg)
        reg = self.cfg.register
        self.newton_cfg = NewtonConfig(
            resolution=reg.ndt_resolution,
            outlier_ratio=reg.svn_outlier_ratio,
            max_iterations=reg.ndt_max_iterations,
            trans_eps=reg.ndt_transform_epsilon,
            # prior-pose pull toward the IMU prediction
            # (setRegularizationScaleFactor, pipeline_ligo_tc.cpp:293)
            reg_weight=reg.regularization_scale_factor,
        )
        self.noise = ImuNoise.from_imu_config(self.cfg.imu)
        self.trajectory: List[TrajectoryEntry] = []
        self.stats = StatsArchive()
        self.viz = None  # Optional[common.VizHook] — set by the CLI's --viz
        self.timer = StageTimer()
        self._ref_lla: Optional[np.ndarray] = None
        self._origin = None
        self._gravity = None
        # registration target = the keyframe window fused at its optimized
        # poses (pipeline_ligo_tc.cpp:519-527): body-frame cloud ring plus,
        # per slot, the live window dict whose "pose" the re-solve updates
        self._kf_clouds = None  # (K, N, 3) body frame
        self._kf_masks = None  # (K, N)
        self._kf_slots: List[Optional[dict]] = []
        self._kf_head = 0
        self._cadence = MapRebuildCadence(
            reg, tuple(reg.reg_grid_shape) if reg.use_regmap else None
        )
        self._trust = robust.trust_gain_init_np()
        self._win: List[dict] = []  # per-state dicts (numpy): pose, vel, bias, ins, pim
        self._fuse_step = PackedStep(self._fuse_device)
        # static factor skeleton (indices + fixed whitenings); gravity is set
        # at the first keyframe from the WGS84 model
        W = self.window
        tpl = empty_factors(W, W - 1, W, 1, W - 1, 0)
        tpl = tpl._replace(
            prior_pose=tpl.prior_pose._replace(idx=jnp.arange(W, dtype=jnp.int32)),
            between=tpl.between._replace(
                i=jnp.arange(W - 1, dtype=jnp.int32), j=jnp.arange(1, W, dtype=jnp.int32)
            ),
            prior_vel=tpl.prior_vel._replace(
                idx=jnp.arange(W, dtype=jnp.int32),
                sqrt_info=jnp.broadcast_to(jnp.eye(3) / 0.5, (W, 3, 3)),
            ),
            prior_bias=tpl.prior_bias._replace(
                idx=jnp.asarray([0], jnp.int32),
                sqrt_info=(jnp.eye(6) / 0.05)[None],
                active=jnp.asarray([True]),
            ),
            imu=tpl.imu._replace(
                i=jnp.arange(W - 1, dtype=jnp.int32), j=jnp.arange(1, W, dtype=jnp.int32)
            ),
        )
        self._factor_template = tpl

    def save_checkpoint(self, path: str):
        """Persist the tightly-coupled state (nav window + keyframe ring +
        trust/origin/gravity) — runtime.checkpoint.save_ligo_tc."""
        from ..runtime import checkpoint

        checkpoint.save_ligo_tc(path, self)

    def resume_from(self, path: str):
        """Restore a checkpoint; subsequent scans continue the trajectory."""
        from ..runtime import checkpoint

        checkpoint.load_ligo_tc(path, self)
        return self

    def run_replay(self, replay_path: str, max_keyframes: int = 10**9):
        for synced in self.ingest.synced_frames(replay_path):
            self.process(synced)
            if len(self.trajectory) >= max_keyframes:
                break
        return self.trajectory

    def _imu_window(self, synced):
        """Padded (64, 7) [accel(3), gyro(3), dt] window from the scan's INS
        samples, static biases removed (imu config, compcallback.cpp:28-157).
        One array so it ships to the device in a single transfer."""
        samples = synced.ins
        imu = np.zeros((IMU_WINDOW_CAPACITY, 7))
        k = 0
        for a, b in zip(samples, samples[1:]):
            if k >= IMU_WINDOW_CAPACITY:
                log.warning("IMU window overflow (%d samples)", len(samples))
                break
            imu[k, 0:3] = np.asarray(a.imu_accel) - self.cfg.imu.static_bias_accel
            imu[k, 3:6] = np.asarray(a.imu_gyro) - self.cfg.imu.static_bias_gyro
            imu[k, 6] = max(b.t - a.t, 0.0)
            k += 1
        return imu

    def _insert_keyframe(self, scan, win_entry: dict):
        """Insert the scan (body frame) into the registration ring; the slot
        keeps a reference to the live window dict so later window re-solves
        update its world pose for free (the reference re-fetches optimized
        poses when fusing the target window, pipeline_ligo_tc.cpp:519-526)."""
        self._kf_clouds = self._kf_clouds.at[self._kf_head].set(scan.points)
        self._kf_masks = self._kf_masks.at[self._kf_head].set(scan.mask)
        self._kf_slots[self._kf_head] = win_entry
        self._kf_head = (self._kf_head + 1) % self._kf_clouds.shape[0]

    def _window_poses(self) -> np.ndarray:
        """(K, 12) optimized world poses of the ring slots (identity rows for
        empty slots — their masks are all-False anyway)."""
        K = self._kf_clouds.shape[0]
        out = np.zeros((K, 12), np.float32)
        for k, entry in enumerate(self._kf_slots):
            if entry is None:
                out[k, 0:9] = np.eye(3).ravel()
            else:
                out[k, 0:9] = np.asarray(entry["pose"][0], np.float64).ravel()
                out[k, 9:12] = np.asarray(entry["pose"][1], np.float64)
        return out

    def process(self, synced):
        with self.timer.span("project"):
            scan = self.ingest.project(synced)
        nav = synced.ins[-1]
        if self._ref_lla is None:
            self._ref_lla = np.asarray(nav.lla)
            g_mag = float(gravity_wgs84(*[jnp.asarray(v) for v in nav.lla]))
            self._gravity = np.array([0.0, 0.0, g_mag])  # NED: g is +down
            self._factor_template = self._factor_template._replace(
                gravity=jnp.asarray(self._gravity)
            )
        scan = maybe_deskew(scan, synced, self._ref_lla, self.cfg.deskew)
        ins_pose = ins_pose_ned(nav, self._ref_lla)
        ins_np = (np.asarray(ins_pose.rot, np.float64), np.asarray(ins_pose.trans, np.float64))
        ins_sigma = np.concatenate([np.asarray(nav.sigma_rpy), np.asarray(nav.sigma_pos)])
        vel_ned = np.asarray(nav.vel_ned, np.float64)

        if self._kf_clouds is None:
            grid_half = 512.0 * self.newton_cfg.resolution
            self._origin = ins_np[1] - grid_half
            K = max(int(self.cfg.register.keyframe_window), 1)
            N = scan.points.shape[0]
            self._kf_clouds = jnp.zeros((K, N, 3), jnp.float32)
            self._kf_masks = jnp.zeros((K, N), bool)
            self._kf_slots = [None] * K
            first = dict(
                pose=ins_np, vel=vel_ned, bias=np.zeros(6),
                ins=(ins_np, np.maximum(ins_sigma, 1e-6)),
                ins_vel=vel_ned,
                pim=None, rel=None, rel_cov=None,
            )
            self._insert_keyframe(scan, first)
            self._win = [first]
            if self.viz is not None:
                self.viz.push(self.viz.subsample(scan), ins_pose,
                              synced.scan.frame_id, ins_pose=ins_pose)
            self.trajectory.append(
                TrajectoryEntry(synced.t_end, synced.scan.frame_id, ins_pose, ins_pose)
            )
            return

        prev = self._win[-1]
        self._origin, shifted = gaussian_map.recenter_origin(
            self._origin, ins_np[1], self.newton_cfg.resolution
        )
        imu = self._imu_window(synced)
        reg = self.cfg.register
        grid_shape = tuple(reg.reg_grid_shape) if reg.use_regmap else None
        rebuild = self._cadence.tick(force=shifted)
        flat = np.concatenate(
            [
                np.asarray(prev["pose"][0], np.float64).ravel(),
                np.asarray(prev["pose"][1], np.float64),
                np.asarray(prev["vel"], np.float64),
                np.asarray(prev["bias"], np.float64),
                self._gravity,
                np.asarray(self._origin, np.float64),
                [1.0 if rebuild else 0.0],
            ]
        )
        with self.timer.span("ndt"):
            self._cadence.regmap, out = _ligo_step(
                self._kf_clouds, self._kf_masks, self._window_poses(),
                scan.points, scan.mask,
                imu, flat, self._cadence.regmap, self.noise,
                self.newton_cfg,
                reg.map_capacity,
                reg.min_points_per_voxel,
                grid_shape,
                reg.fused_inner_iters,
            )
            out = np.asarray(out, np.float64)
        if self._cadence.regmap is not None and (self._cadence._idx & 31) == 1:
            ovf = int(self._cadence.regmap.overflow)
            if ovf and not getattr(self, "_ovf_warned", False):
                self._ovf_warned = True
                log.warning(
                    "RegMap truncated %d dilated cells (capacity/grid too "
                    "small) — raise map_capacity or reg_grid_shape", ovf,
                )
        pim_np = dict(
            dR=out[0:9].reshape(3, 3), dv=out[9:12], dp=out[12:15],
            dt=float(out[15]), dR_dbg=out[16:25].reshape(3, 3),
            dv_dba=out[25:34].reshape(3, 3), dv_dbg=out[34:43].reshape(3, 3),
            dp_dba=out[43:52].reshape(3, 3), dp_dbg=out[52:61].reshape(3, 3),
            bias_hat=out[61:67], cov=out[67:292].reshape(15, 15),
        )
        predicted_vel = out[292:295]
        res_pose = (out[295:304].reshape(3, 3), out[304:307])
        H = out[307:343].reshape(6, 6)
        ndt_score, ndt_iters, ndt_converged = out[343:346]
        lidar_cov = -np.linalg.inv(H + 1e-6 * np.eye(6))
        lidar_cov = 0.5 * (lidar_cov + lidar_cov.T)
        ev, evec = np.linalg.eigh(lidar_cov)
        lidar_cov = evec @ np.diag(np.maximum(ev, 1e-12)) @ evec.T
        # registration-bias variance floor (RegisterConfig.lidar_*_sigma_floor)
        # — see apps/odom_ndt.py: the point-count-scaled Hessian prices the
        # between factor far below the estimator's real mm-class bias
        floor = np.concatenate(
            [
                np.full(3, self.cfg.register.lidar_rot_sigma_floor),
                np.full(3, self.cfg.register.lidar_trans_sigma_floor),
            ]
        )
        lidar_cov = lidar_cov + np.diag(floor * floor)
        rel = np_between(prev["pose"], res_pose)

        self._trust, scale = robust.trust_gain_update_np(
            self._trust, float(np.linalg.norm(np.asarray(nav.sigma_pos)))
        )
        scaled_sigma = np.maximum(ins_sigma * float(scale), 1e-6)

        entry = dict(
            pose=res_pose, vel=predicted_vel, bias=np.asarray(prev["bias"]),
            ins=(ins_np, scaled_sigma), ins_vel=vel_ned,
            pim=pim_np, rel=rel, rel_cov=lidar_cov,
        )
        self._win.append(entry)
        if len(self._win) > self.window:
            self._win.pop(0)

        with self.timer.span("smoother"):
            # _fuse writes the optimized states back into self._win
            pose_opt, vel_opt, bias_opt, cov_opt = self._fuse()
        self._insert_keyframe(scan, entry)  # body; _ligo_step transforms
        if self.viz is not None:
            self.viz.push(self.viz.subsample(scan),
                          Pose3(pose_opt[0], pose_opt[1]),
                          synced.scan.frame_id, ins_pose=ins_pose)
        self.trajectory.append(
            TrajectoryEntry(
                synced.t_end, synced.scan.frame_id,
                Pose3(pose_opt[0], pose_opt[1]), ins_pose, cov_opt,
            )
        )
        self.stats.add(
            KeyFrameStats(
                frame_id=synced.scan.frame_id,
                timestamp=synced.t_end,
                num_points=int(scan.num_points),
                align_time_ms=self.timer.last_ms("ndt"),
                ndt_iterations=int(ndt_iters),
                converged=bool(ndt_converged > 0.5),
                score=float(ndt_score),
                ins_sigma=ins_sigma,
                scaled_sigma=scaled_sigma,
                lidar_sigma=np.sqrt(np.maximum(np.diag(lidar_cov), 0.0)),
                optimized_sigma=np.sqrt(np.maximum(np.diag(cov_opt)[:6], 0.0))
                if cov_opt is not None
                else np.zeros(6),
                ins_pose=np_pose7(ins_np[0], ins_np[1]),
                optimized_pose=np_pose7(pose_opt[0], pose_opt[1]),
                # INS-vs-optimized translation gap (pipeline.cpp:745-752)
                pose_rmse=float(np.linalg.norm(ins_np[1] - pose_opt[1])),
            )
        )

    def _fuse_device(self, a):
        """Device half of the window re-solve (traced once by PackedStep)."""
        tpl = self._factor_template
        st = WindowState(
            rot=a["rot"], trans=a["trans"], vel=a["vel"], bias=a["bias"],
            active=a["active"],
        )
        factors = tpl._replace(
            prior_pose=tpl.prior_pose._replace(
                rot=a["fp_rot"], trans=a["fp_trans"],
                sqrt_info=a["fp_si"], active=a["active"],
            ),
            prior_vel=tpl.prior_vel._replace(value=a["fv_val"], active=a["active"]),
            prior_bias=tpl.prior_bias._replace(value=a["fbias_val"]),
            between=tpl.between._replace(
                rot=a["fb_rot"], trans=a["fb_trans"],
                sqrt_info=a["fb_si"], active=a["b_active"],
            ),
            imu=tpl.imu._replace(
                dR=a["dR"], dv=a["dv"], dp=a["dp"], dt=a["dt"],
                dR_dbg=a["dR_dbg"], dv_dba=a["dv_dba"], dv_dbg=a["dv_dbg"],
                dp_dba=a["dp_dba"], dp_dbg=a["dp_dbg"], bias_hat=a["bias_hat"],
                sqrt_info=a["fi_si"], active=a["b_active"],
            ),
        )
        result = smoother.optimize(
            st, factors,
            SmootherConfig(
                iterations=6, solver=self.cfg.register.smoother_solver
            ),
        )
        cov = marginal_covariance(result.hessian, a["cur"])
        return dict(
            rot=result.state.rot, trans=result.state.trans,
            vel=result.state.vel, bias=result.state.bias, cov=cov,
        )

    def _fuse(self):
        """Window re-solve. Factor arrays are assembled in numpy and shipped
        as ONE packed vector (PackedStep): one transfer instead of one per
        factor array."""
        W = self.window
        n = len(self._win)
        pad = W - n
        eye3, eye6, eye15 = np.eye(3), np.eye(6), np.eye(15)

        def stack(items, pad_item, count=pad):
            return np.stack([np.asarray(x, np.float64) for x in items] + [pad_item] * count)

        n_b = n - 1
        pad_b = W - 1 - n_b
        pims = [w["pim"] for w in self._win[1:]]  # numpy dicts

        def stack_pim(key, pad_val):
            return stack((p[key] for p in pims), pad_val, pad_b)

        args = dict(
            rot=stack((w["pose"][0] for w in self._win), eye3),
            trans=stack((w["pose"][1] for w in self._win), np.zeros(3)),
            vel=stack((w["vel"] for w in self._win), np.zeros(3)),
            bias=stack((w["bias"] for w in self._win), np.zeros(6)),
            active=np.asarray([True] * n + [False] * pad),
            fp_rot=stack((w["ins"][0][0] for w in self._win), eye3),
            fp_trans=stack((w["ins"][0][1] for w in self._win), np.zeros(3)),
            fp_si=stack((np_sqrt_info_from_sigmas(w["ins"][1]) for w in self._win), eye6),
            fv_val=stack((w["ins_vel"] for w in self._win), np.zeros(3)),
            fbias_val=np.asarray(self._win[0]["bias"], np.float64)[None],
            fb_rot=stack((w["rel"][0] for w in self._win[1:]), eye3, pad_b),
            fb_trans=stack((w["rel"][1] for w in self._win[1:]), np.zeros(3), pad_b),
            fb_si=stack((np_sqrt_info_from_cov(w["rel_cov"]) for w in self._win[1:]), eye6, pad_b),
            b_active=np.asarray([True] * n_b + [False] * pad_b),
            dR=stack_pim("dR", eye3),
            dv=stack_pim("dv", np.zeros(3)),
            dp=stack_pim("dp", np.zeros(3)),
            dt=np.asarray([p["dt"] for p in pims] + [0.0] * pad_b),
            dR_dbg=stack_pim("dR_dbg", np.zeros((3, 3))),
            dv_dba=stack_pim("dv_dba", np.zeros((3, 3))),
            dv_dbg=stack_pim("dv_dbg", np.zeros((3, 3))),
            dp_dba=stack_pim("dp_dba", np.zeros((3, 3))),
            dp_dbg=stack_pim("dp_dbg", np.zeros((3, 3))),
            bias_hat=stack_pim("bias_hat", np.zeros(6)),
            fi_si=stack((np_sqrt_info_from_cov(p["cov"]) for p in pims), eye15, pad_b),
            cur=np.int32(n - 1),
        )
        out = self._fuse_step(args)
        state_rot = np.asarray(out["rot"], np.float64)
        state_trans = np.asarray(out["trans"], np.float64)
        state_vel = np.asarray(out["vel"], np.float64)
        state_bias = np.asarray(out["bias"], np.float64)
        cov = np.asarray(out["cov"], np.float64)
        cur = n - 1
        for k in range(n):
            self._win[k]["pose"] = (state_rot[k], state_trans[k])
            self._win[k]["vel"] = state_vel[k]
            self._win[k]["bias"] = state_bias[k]
        return (state_rot[cur], state_trans[cur]), state_vel[cur], state_bias[cur], cov
