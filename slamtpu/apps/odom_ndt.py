"""Newton-NDT odometry + window-smoother fusion (the reference ``pipeline``
executable, /root/reference/run/pipeline.cpp).

Per keyframe (pipeline.cpp:432-824):
1. target map = previous keyframe cloud at its optimized pose (:552-557)
2. Newton NDT from the constant-velocity initial guess (:558-563)
3. deviation gate vs the constant-velocity prediction -> SE(3) blend
   (:570-592)
4. LiDAR between-factor with covariance -(H + 1e-6 I)^-1 (:594-604)
5. INS pose prior with GPS-denial trust-gain sigma scaling (:637-665)
6. window smoother re-solve (replaces iSAM2 :738-759), marginal covariance
7. constant-velocity prediction of the next initial guess (:763-770)
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
from ..fusion import robust, smoother
from ..fusion.graph import sqrt_info_from_cov
from ..mapping import gaussian_map
from ..ndt import NewtonConfig, newton_align
from ..runtime.config import PipelineConfig
from ..runtime.stats import KeyFrameStats, StageTimer, StatsArchive
from .common import (IngestPipeline, TrajectoryEntry, ins_pose_ned, maybe_deskew,
    np_pose7 as _p7)

log = logging.getLogger("slamtpu.odom_ndt")


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "capacity", "min_points", "grid_shape", "method", "svn_cfg",
        "inner_iters", "scan_grid",
    ),
)
def _register_step(
    target_points,  # (N, 3) previous keyframe cloud, world frame
    target_mask,
    new_points,  # (N, 3) body frame
    new_mask,
    init_guess: Pose3,
    origin,
    cfg: NewtonConfig,
    capacity: int,
    min_points: int,
    grid_shape: tuple = None,
    reg_pose: Pose3 = None,
    method: str = "NDT_OMP",
    svn_cfg=None,  # ndt.SvnConfig, required for method == "SVNNDT"
    key=None,  # PRNG key, required for method == "SVNNDT"
    regmap_cache=None,  # RegMap: enables reduced-cadence rebuild (NDT_OMP only)
    rebuild=None,  # () bool: rebuild the map this call (with regmap_cache)
    inner_iters: int = 2,  # fused-kernel Newton steps per gather
    scan_grid: tuple = None,  # (cols, sub) range-image layout of new_points:
    #   enables the stencil source covariances for the GICP-aniso engine
    #   (ndt.gicp.stencil_point_covariances — shifts + FMA, no sort)
):
    """Build the target map and register by the configured engine — the
    analog of the reference's registration_method switch
    (/root/reference/run/pipeline.cpp:464-481, src/registercallback.cpp:41-61):
    NDT_OMP -> Newton P2D-NDT, SVNNDT -> SVN particle flow (posterior mean),
    GICP -> voxelized GICP, NDT_OMP_MULTIRES -> coarse-to-fine pyramid.

    With ``regmap_cache``/``rebuild`` (NDT_OMP + grid_shape only) the
    map+RegMap build — the dominant keyframe cost — runs under ``lax.cond``
    and the call returns ``(result, regmap)`` so the caller can carry the
    cache forward (cf. RegisterConfig.map_rebuild_every)."""
    if method == "NDT_OMP_MULTIRES":
        from ..ndt.multires import build_pyramid, multires_align

        levels = build_pyramid(
            target_points, target_mask, origin,
            resolutions=[2.0 * cfg.resolution, cfg.resolution],
            capacity=capacity,
            grid_shape=grid_shape or (256, 256, 64),
            min_points_per_voxel=min_points,
            max_iterations=[max(cfg.max_iterations // 3, 3), cfg.max_iterations],
        )
        return multires_align(new_points, new_mask, levels, init_guess)

    def build_gmap():
        return gaussian_map.build_map(
            target_points, target_mask, origin, cfg.resolution,
            capacity=capacity, min_points_per_voxel=min_points,
        )

    if method == "GICP":
        gmap = build_gmap()
        from ..ndt import build_regmap, gicp_align, gicp_align_fused, gicp_map
        from ..ndt.pallas_math import pair_math_impl

        if cfg.gicp_aniso:
            # plane-to-plane mode: per-point source covariances from the
            # source scan's own voxel stats, (C_tgt + R C_src R^T)^-1 fused
            # per pair (gicp_omp capability, registercallback.cpp:56-61)
            from ..ndt import gicp_align_aniso, gicp_map_aniso, source_point_covariances

            regmap = build_regmap(
                gicp_map_aniso(gmap), grid_shape=grid_shape or (256, 256, 64)
            )
            if scan_grid is not None:
                from ..ndt.gicp import stencil_point_covariances

                src_cov = stencil_point_covariances(
                    new_points, new_mask, scan_grid
                )
            else:
                src_cov = source_point_covariances(
                    new_points, new_mask, cfg.resolution,
                    capacity=min(capacity, 1 << 14),
                    min_points_per_voxel=min_points,
                )
            return gicp_align_aniso(
                new_points, new_mask, src_cov, regmap, init_guess, cfg,
                grid_shape or (256, 256, 64),
            )
        regmap = build_regmap(gicp_map(gmap), grid_shape=grid_shape or (256, 256, 64))
        if pair_math_impl() == "kernel" and grid_shape is not None:
            return gicp_align_fused(
                new_points, new_mask, regmap, init_guess, cfg,
                grid_shape, inner_iters=inner_iters,
            )
        return gicp_align(
            new_points, new_mask, regmap, init_guess, cfg, grid_shape or (256, 256, 64)
        )
    if method == "SVNNDT":
        from ..ndt import (NewtonResult, build_regmap, build_regmap_kdtree,
            svn_align, svn_align_reg)

        gmap = build_gmap()
        if grid_shape is None:
            res = svn_align(new_points, new_mask, gmap, init_guess, key, svn_cfg)
        else:
            _builder = (
                build_regmap_kdtree if svn_cfg.kd_radius > 0 else build_regmap
            )
            regmap = _builder(gmap, grid_shape=grid_shape)
            res = svn_align_reg(
                new_points, new_mask, regmap, init_guess, key, svn_cfg, grid_shape
            )
        # adapt the posterior to the Newton interface: H = -cov^-1 so that
        # the apps' lidar_cov = -(H)^-1 recovers the SVN posterior covariance
        hess = -jnp.linalg.inv(
            res.covariance + 1e-9 * jnp.eye(6, dtype=res.covariance.dtype)
        )
        return NewtonResult(
            pose=res.pose,
            hessian=hess,
            score=res.score.astype(new_points.dtype),
            iterations=res.iterations,
            converged=res.converged,
            n_contrib=jnp.zeros((), jnp.int32),
        )

    if grid_shape is None:
        return newton_align(
            new_points, new_mask, build_gmap(), init_guess, cfg, reg_pose=reg_pose
        )
    from ..ndt import build_regmap, build_regmap_kdtree, newton_align_reg
    from ..ndt.pallas_math import newton_align_fused, pair_math_impl

    # KDTREE search mode pairs the centroid-gated objective (cfg.kd_radius)
    # with the 27-neighborhood nearest-leaf RegMap layout
    _builder = build_regmap_kdtree if cfg.kd_radius > 0 else build_regmap

    if regmap_cache is None:
        regmap = _builder(build_gmap(), grid_shape=grid_shape)
    else:
        # the whole map+RegMap build traces inside the cond branch: it only
        # EXECUTES on rebuild keyframes
        def do_build(_):
            rm = _builder(build_gmap(), grid_shape=grid_shape)
            return jax.tree.map(lambda a, e: a.astype(e.dtype), rm, regmap_cache)

        regmap = jax.lax.cond(rebuild, do_build, lambda _: regmap_cache, None)
    if pair_math_impl() == "kernel":
        res = newton_align_fused(
            new_points, new_mask, regmap, init_guess, cfg, grid_shape,
            inner_iters=inner_iters, reg_pose=reg_pose,
        )
    else:
        res = newton_align_reg(
            new_points, new_mask, regmap, init_guess, cfg, grid_shape, reg_pose=reg_pose
        )
    return res if regmap_cache is None else (res, regmap)


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "capacity", "min_points", "grid_shape", "max_td", "max_rd",
        "method", "svn_cfg", "inner_iters", "window", "smoother_iters",
        "scan_grid", "tgt_window", "tgt_exclude",
    ),
    donate_argnums=(0,),
)
def _odom_fused_step(
    carry,  # device-resident odometry state (window ring + prev cloud), donated
    new_points,  # (N, 3) body frame
    new_mask,
    flat,  # (36,) [ins_rot(9), ins_trans(3), scaled_sigma(6), origin(3),
    #   lidar sigma floor (rot, trans), use_ins_rel flag(1),
    #   ins_rel rot(9) + trans(3) — INS relative motion since the previous
    #   keyframe, the registration seed]
    cfg: NewtonConfig,
    capacity: int,
    min_points: int,
    grid_shape: tuple,
    max_td: float,
    max_rd: float,
    method: str = "NDT_OMP",
    svn_cfg=None,
    key=None,
    inner_iters: int = 2,
    window: int = 6,
    smoother_iters: int = 4,
    scan_grid: tuple = None,  # see _register_step
    tgt_window: int = 1,  # RegisterConfig.odom_target_window: clouds in the
    #   registration target (1 = reference scan-to-previous semantics)
    tgt_exclude: int = 0,  # RegisterConfig.odom_target_exclude: drop the
    #   newest E target clouds (requires tgt_window > 1; see the ring-lock
    #   note in the target assembly below)
):
    """One COMPLETE odometry keyframe in a single device dispatch
    (pipeline.cpp:432-824): transform the previous keyframe cloud to its
    optimized pose, build the NDT map, register from the constant-velocity
    guess, deviation-gate + blend, derive the LiDAR covariance from the
    Hessian, slide the factor window, re-solve the pose window
    (iSAM2-equivalent), and extract the marginal covariance.

    Round 2 split this across two dispatches with a host round trip between
    them (Hessian -> covariance -> sqrt-info assembly in numpy) — that trip
    plus the 15-dof QR smoother were the last fat keeping odom_berlin below
    sensor rate. All inter-stage data now stays on device; the host ships
    one (21,) vector in and one (100,) vector out per keyframe, and the
    carried window state never leaves the device.
    """
    W = window
    cd = carry["win_trans"].dtype  # f64 under x64 (CPU tests), f32 on device
    f32 = jnp.float32
    ins_pose = Pose3(flat[0:9].reshape(3, 3).astype(cd), flat[9:12].astype(cd))
    scaled_sigma = jnp.maximum(flat[12:18].astype(cd), 1e-6)
    origin = flat[18:21].astype(f32)

    n = carry["n"]  # states currently in the window (>= 1)
    idx_prev = n - 1
    prev = Pose3(carry["win_rot"][idx_prev], carry["win_trans"][idx_prev])
    pp = Pose3(
        carry["win_rot"][jnp.maximum(idx_prev - 1, 0)],
        carry["win_trans"][jnp.maximum(idx_prev - 1, 0)],
    )
    have_pp = n >= 2
    prev32 = Pose3(prev.rot.astype(f32), prev.trans.astype(f32))
    pp32 = Pose3(pp.rot.astype(f32), pp.trans.astype(f32))
    M = tgt_window
    if M == 1:
        # reference semantics: target = previous keyframe cloud at its
        # optimized pose (pipeline.cpp:552-557)
        target = se3.transform_points(prev32, carry["prev_points"][0])
        target_mask = carry["prev_mask"][0]
    else:
        # multi-viewpoint target: the last M keyframe clouds, each at its
        # OPTIMIZED pose from the smoother window (decorrelates the
        # single-scan ground-ring sampling bias — RegisterConfig.
        # odom_target_window). Ring slot M-1 is the newest (state idx_prev);
        # slot j holds state idx_prev - (M-1-j), invalid during fill-up.
        offs = jnp.arange(M) - (M - 1)
        state_of_slot = idx_prev + offs  # (M,)
        sidx = jnp.clip(state_of_slot, 0, W - 1)
        Rm = carry["win_rot"][sidx].astype(f32)  # (M, 3, 3)
        tm = carry["win_trans"][sidx].astype(f32)  # (M, 3)
        world = (
            jnp.einsum("mij,mnj->mni", Rm, carry["prev_points"])
            + tm[:, None, :]
        )
        valid = state_of_slot >= 0
        if tgt_exclude > 0:  # see RegisterConfig.odom_target_exclude
            # RegisterConfig.odom_target_exclude: drop the newest E clouds
            # from the target — the ring-pattern lock is a NEAREST-viewpoint
            # effect (correlation decays below mm past ~1.5 m separation,
            # measured); clouds >= 2 keyframes back
            # still cover the scan while their ring phases have diverged.
            # Clamped during fill-up so at least one cloud always remains.
            keep_from_newest = jnp.arange(M)[::-1]  # M-1 -> 0, ..., 0 -> M-1
            n_valid = jnp.sum(valid.astype(jnp.int32))
            e_eff = jnp.minimum(tgt_exclude, jnp.maximum(n_valid - 1, 0))
            valid = valid & (keep_from_newest >= e_eff)
        target = world.reshape(-1, 3)
        target_mask = (carry["prev_mask"] & valid[:, None]).reshape(-1)
    guess_cv = robust.constant_velocity_predict(pp32, prev32)
    guess = jax.tree.map(lambda a, b: jnp.where(have_pp, a, b), guess_cv, prev32)
    # INS-relative seed (flat[23] set): guess = prev_optimized o INS relative
    # motion. Pure const-velocity under-predicts during cold start (no
    # velocity estimate yet) and under acceleration; with the round-5
    # accurate map covariances the wall Gaussians are genuine ~3 cm-sigma
    # pancakes, so a 0.3 m guess error sits ~10 sigma out where the NDT
    # gradient vanishes — registration then recovers only part of the motion
    # and the 3 mm-sigma between factors freeze the shortfall against the
    # cm-sigma INS priors (measured: 0.145 m/keyframe until the window
    # fills). The INS relative motion is cm-class over one sweep and is the
    # same FrameData the reference feeds its prior factor (pipeline.cpp:
    # 637-665); the reference's own const-vel seed (:763-770) faces the same
    # cold start against its f64-exact maps.
    use_ins_rel = flat[23] > 0.5
    rel_ins = Pose3(flat[24:33].reshape(3, 3).astype(f32), flat[33:36].astype(f32))
    guess_ins = se3.compose(prev32, rel_ins)
    guess = jax.tree.map(
        lambda a, b: jnp.where(use_ins_rel, a, b), guess_ins, guess
    )
    res = _register_step(
        target, target_mask, new_points, new_mask, guess, origin,
        cfg, capacity, min_points, grid_shape,
        method=method, svn_cfg=svn_cfg, key=key, inner_iters=inner_iters,
        scan_grid=scan_grid,
    )
    blended32, w = robust.deviation_gated_blend(guess, res.pose, max_td, max_rd)
    blended = Pose3(blended32.rot.astype(cd), blended32.trans.astype(cd))

    # LiDAR covariance from the Hessian (pipeline.cpp:594-603), on device
    H = res.hessian.astype(cd)
    lidar_cov = -jnp.linalg.inv(H + 1e-6 * jnp.eye(6, dtype=cd))
    lidar_cov = 0.5 * (lidar_cov + lidar_cov.T)
    ev, evec = jnp.linalg.eigh(lidar_cov)
    lidar_cov = (evec * jnp.maximum(ev, 1e-12)[None, :]) @ evec.T
    # registration-bias variance floor (RegisterConfig.lidar_*_sigma_floor):
    # keeps the between factor honest about mm-class NDT bias that the
    # point-count-scaled Hessian cannot see
    floor = jnp.concatenate(
        [jnp.full((3,), flat[21], cd), jnp.full((3,), flat[22], cd)]
    )
    lidar_cov = lidar_cov + jnp.diag(floor * floor)
    fb_si_new = sqrt_info_from_cov(lidar_cov)
    rel = se3.between(prev, blended)

    # slide the window ring: roll left when full, write at idx
    full = n >= W
    idx = jnp.minimum(n, W - 1)

    def roll_in(a, new_val):
        rolled = jnp.where(full, jnp.roll(a, -1, axis=0), a)
        return rolled.at[idx].set(new_val.astype(a.dtype))

    win_rot = roll_in(carry["win_rot"], blended.rot)
    win_trans = roll_in(carry["win_trans"], blended.trans)
    fp_rot = roll_in(carry["fp_rot"], ins_pose.rot)
    fp_trans = roll_in(carry["fp_trans"], ins_pose.trans)
    fp_sig = roll_in(carry["fp_sig"], scaled_sigma)
    # edge slot e holds the between factor (e-1) -> e; idx >= 1 here
    fb_rot = roll_in(carry["fb_rot"], rel.rot)
    fb_trans = roll_in(carry["fb_trans"], rel.trans)
    fb_si = roll_in(carry["fb_si"], fb_si_new)

    ks = jnp.arange(W)
    active = ks <= idx
    b_active = (ks >= 1) & (ks <= idx)

    fp_si = jax.vmap(jnp.diag)(1.0 / fp_sig)
    sm = smoother.optimize_pose_window(
        win_rot, win_trans, active, fp_rot, fp_trans, fp_si,
        fb_rot[1:], fb_trans[1:], fb_si[1:], b_active[1:],
        iterations=smoother_iters,
    )
    cov_opt = smoother.pose_marginal_covariance(sm.hessian, idx)

    new_carry = dict(
        win_rot=sm.rot, win_trans=sm.trans,
        fp_rot=fp_rot, fp_trans=fp_trans, fp_sig=fp_sig,
        fb_rot=fb_rot, fb_trans=fb_trans, fb_si=fb_si,
        n=jnp.minimum(n + 1, W),
        # roll the target-cloud ring: newest at slot M-1 (M == 1 reduces to
        # the plain previous-cloud carry)
        prev_points=(
            new_points[None]
            if M == 1
            else jnp.roll(carry["prev_points"], -1, axis=0)
            .at[M - 1]
            .set(new_points)
        ),
        prev_mask=(
            new_mask[None]
            if M == 1
            else jnp.roll(carry["prev_mask"], -1, axis=0).at[M - 1].set(new_mask)
        ),
    )
    out = jnp.concatenate(
        [
            sm.rot[idx].ravel(), sm.trans[idx],
            cov_opt.ravel(),
            lidar_cov.ravel(),
            rel.rot.ravel(), rel.trans,
            jnp.stack(
                [
                    res.score.astype(cd), res.iterations.astype(cd),
                    res.converged.astype(cd), w.astype(cd),
                ]
            ),
        ]
    )
    return new_carry, out


@dataclasses.dataclass
class OdomNdtApp:
    cfg: PipelineConfig
    window: int = 8  # smoother window size (states kept live)
    max_trans_deviation: float = 1.0  # pipeline.cpp:454
    max_rot_deviation: float = 0.1  # pipeline.cpp:455
    loop_closure: bool = False  # voxel-bucket candidate search + NDT verify
    loop_cfg: object = None  # fusion.loop_closure.LoopClosureConfig
    method: Optional[str] = None  # None -> cfg.register.method
    smoother_iters: int = 4  # pose-window Gauss-Newton iterations

    def __post_init__(self):
        self.ingest = IngestPipeline(self.cfg)
        reg = self.cfg.register
        # engine choice from the config, as the reference's
        # registration_method switch (run/pipeline.cpp:464-481;
        # src/registercallback.cpp:41-43)
        known = ("NDT_OMP", "SVNNDT", "GICP", "NDT_OMP_MULTIRES")
        if self.method is None:
            self.method = reg.method
        if self.method not in known:
            raise ValueError(f"unknown registration method {self.method!r}; known: {known}")
        self.newton_cfg = NewtonConfig(
            resolution=reg.ndt_resolution,
            outlier_ratio=reg.svn_outlier_ratio,
            max_iterations=reg.ndt_max_iterations,
            trans_eps=reg.gicp_transform_epsilon
            if self.method == "GICP"
            else reg.ndt_transform_epsilon,
            use_direct1=reg.search_method == "DIRECT1",
            # KDTREE mode: radiusSearch over leaf centroids at radius =
            # resolution (registercallback.cpp search-method switch)
            kd_radius=reg.ndt_resolution
            if reg.search_method == "KDTREE"
            else 0.0,
            gicp_max_corr_dist=reg.gicp_corr_dist_threshold,
            gicp_aniso=reg.gicp_source_cov == "anisotropic",
        )
        # range-image layout of the projected sweep: the GICP-aniso engine's
        # source covariances come from the grid stencil instead of the
        # sort-based voxel pass (same knob as lo_svn's polish,
        # RegisterConfig.svn_src_cov)
        self._scan_grid = (
            (self.cfg.meta.columns_per_frame, self.ingest.luts.subset_channels)
            if self.newton_cfg.gicp_aniso and reg.svn_src_cov == "stencil"
            else None
        )
        # multi-viewpoint registration target (RegisterConfig.
        # odom_target_window); clamped to the smoother window — older
        # clouds' optimized poses are not retained
        self.tgt_window = max(1, min(int(reg.odom_target_window), self.window))
        # target-cloud exclusion needs a ring to exclude from; cap so at
        # least one cloud survives at steady state
        self.tgt_exclude = max(
            0, min(int(reg.odom_target_exclude), self.tgt_window - 1)
        )
        self.svn_cfg = None
        self._key = None
        if self.method == "SVNNDT":
            from ..ndt import SvnConfig

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
                # _register_step's regmap carries no aux payload (scan-to-
                # previous-keyframe targets rebuild fully each keyframe)
                polish_objective="ndt",
            )
            self._key = jax.random.PRNGKey(1234)
        self._trajectory: List[TrajectoryEntry] = []
        self._stats = StatsArchive()
        self.viz = None  # Optional[common.VizHook] — set by the CLI's --viz
        self.timer = StageTimer()
        self._ref_lla: Optional[np.ndarray] = None
        self._origin = None  # numpy (3,)
        self._trust = robust.trust_gain_init_np()
        # device-resident odometry state (window ring + previous cloud);
        # see _odom_fused_step. None until the first keyframe.
        self._carry = None
        # (rot, trans) numpy f64 INS pose of the previous keyframe — source
        # of the INS-relative registration seed (use_ins_rel in the step)
        self._prev_ins = None
        self._n_keyframes = 0
        # keyframes whose device results are still in flight — the host
        # fetches lag one keyframe behind dispatch so the next frame's
        # decode/pack overlaps the device step (lo_svn's pattern; here the
        # carried window state lives on device, so there is no host-side
        # data dependency between keyframes at all)
        self._pending: List[tuple] = []
        # loop closure (the reference's candidate-search scaffold,
        # pipeline.cpp:676-736, completed): detector + full odometry-chain
        # history for the offline pose-graph refinement pass
        self._detector = None
        self._closures = []
        self._odo_rels = []  # (rel (rot, trans) numpy, cov 6x6) per step
        if self.loop_closure:
            from ..fusion.loop_closure import LoopClosureConfig, LoopDetector

            self._detector = LoopDetector(self.loop_cfg or LoopClosureConfig())

    @property
    def trajectory(self) -> List[TrajectoryEntry]:
        self.flush()
        return self._trajectory

    @property
    def stats(self) -> StatsArchive:
        self.flush()
        return self._stats

    def save_checkpoint(self, path: str):
        """Persist the odometry state (device carry + trust + origin) so a
        later run continues exactly — runtime.checkpoint.save_odom_ndt."""
        from ..runtime import checkpoint

        checkpoint.save_odom_ndt(path, self)

    def resume_from(self, path: str):
        """Restore a checkpoint; subsequent scans continue the trajectory."""
        from ..runtime import checkpoint

        checkpoint.load_odom_ndt(path, self)
        return self

    def run_replay(self, replay_path: str, max_keyframes: int = 10**9):
        for synced in self.ingest.synced_frames(replay_path):
            self.process(synced)
            if self._n_keyframes >= max_keyframes:
                break
        return self.trajectory

    def _next_key(self):
        """Fresh PRNG key per keyframe (SVNNDT engine only)."""
        if self._key is None:
            return None
        self._key, sub = jax.random.split(self._key)
        return sub

    def process(self, synced):
        with self.timer.span("project"):
            scan = self.ingest.project(synced)
        nav = synced.ins[-1]
        if self._ref_lla is None:
            self._ref_lla = np.asarray(nav.lla)
        scan = maybe_deskew(scan, synced, self._ref_lla, self.cfg.deskew)
        ins_pose = ins_pose_ned(nav, self._ref_lla)
        ins_sigma = np.concatenate([np.asarray(nav.sigma_rpy), np.asarray(nav.sigma_pos)])

        if self._carry is None:
            # first keyframe: INS prior only (pipeline.cpp:532-543)
            grid_half = 512.0 * self.newton_cfg.resolution
            self._origin = np.asarray(ins_pose.trans, np.float64) - grid_half
            self._start(ins_pose, ins_sigma, synced, scan)
            return

        self._origin, _shifted = gaussian_map.recenter_origin(
            self._origin, np.asarray(ins_pose.trans), self.newton_cfg.resolution
        )
        # trust-gain INS prior (pipeline.cpp:637-665); insChecker = sigma
        # norm — host data only, so it is computed BEFORE dispatch and the
        # device step has no host-side dependency on the previous keyframe
        self._trust, scale = robust.trust_gain_update_np(
            self._trust, float(np.linalg.norm(np.asarray(nav.sigma_pos)))
        )
        scaled_sigma = np.maximum(ins_sigma * float(scale), 1e-6)
        reg = self.cfg.register
        # INS relative motion since the previous keyframe — the registration
        # seed (see the use_ins_rel note in _odom_fused_step). None after a
        # legacy-checkpoint resume: that first keyframe falls back to the
        # const-velocity seed.
        if self._prev_ins is not None:
            pr, pt = self._prev_ins
            cr = np.asarray(ins_pose.rot, np.float64)
            ct = np.asarray(ins_pose.trans, np.float64)
            rel_rot = pr.T @ cr
            rel_trans = pr.T @ (ct - pt)
            ins_rel = np.concatenate([[1.0], rel_rot.ravel(), rel_trans])
        else:
            ins_rel = np.zeros(13)
        self._prev_ins = (
            np.asarray(ins_pose.rot, np.float64).copy(),
            np.asarray(ins_pose.trans, np.float64).copy(),
        )
        flat = np.concatenate(
            [
                np.asarray(ins_pose.rot, np.float64).ravel(),
                np.asarray(ins_pose.trans, np.float64),
                scaled_sigma,
                np.asarray(self._origin, np.float64),
                [reg.lidar_rot_sigma_floor, reg.lidar_trans_sigma_floor],
                ins_rel,
            ]
        ).astype(self._flat_dtype)
        with self.timer.span("step"):
            self._carry, out = _odom_fused_step(
                self._carry,
                scan.points,
                scan.mask,
                flat,
                self.newton_cfg,
                self.cfg.register.map_capacity,
                self.cfg.register.min_points_per_voxel,
                tuple(self.cfg.register.reg_grid_shape)
                if self.cfg.register.use_regmap
                else None,
                self.max_trans_deviation,
                self.max_rot_deviation,
                method=self.method,
                svn_cfg=self.svn_cfg,
                key=self._next_key(),
                inner_iters=self.cfg.register.fused_inner_iters,
                window=self.window,
                smoother_iters=self.smoother_iters,
                scan_grid=self._scan_grid,
                tgt_window=self.tgt_window,
                tgt_exclude=self.tgt_exclude,
            )
        self._n_keyframes += 1
        # the scan buffers enter the donated carry as prev_points/prev_mask
        # and are consumed by the NEXT dispatch — the loop-closure detector
        # needs its own copies
        det_cloud = (
            (jnp.array(scan.points, copy=True), jnp.array(scan.mask, copy=True))
            if self._detector is not None
            else None
        )
        self._pending.append(
            (synced, int(scan.num_points), ins_pose, ins_sigma, scaled_sigma,
             self.timer.last_ms("step"), det_cloud, out,
             self.viz.subsample(scan) if self.viz is not None else None)
        )
        if len(self._pending) > 2:
            self._drain_one()

    def flush(self):
        """Materialize all in-flight keyframe results."""
        while self._pending:
            self._drain_one()

    def _drain_one(self):
        (synced, num_points, ins_pose, ins_sigma, scaled_sigma, dt_ms, det_cloud,
         out_dev, viz_pts) = self._pending.pop(0)
        out = np.asarray(out_dev, np.float64)
        pose_opt = (out[0:9].reshape(3, 3), out[9:12])
        cov_opt = out[12:48].reshape(6, 6)
        lidar_cov = out[48:84].reshape(6, 6)
        rel = (out[84:93].reshape(3, 3), out[93:96])
        ndt_score, ndt_iters, ndt_converged, w = out[96:100]
        if self.viz is not None:
            self.viz.push(viz_pts, Pose3(pose_opt[0], pose_opt[1]),
                          synced.scan.frame_id, ins_pose=ins_pose)
        if self._detector is not None:
            self._odo_rels.append((rel, lidar_cov))
            self._closures += self._detector.add_keyframe(
                Pose3(pose_opt[0], pose_opt[1]), det_cloud[0], det_cloud[1]
            )
        self._trajectory.append(
            TrajectoryEntry(
                timestamp=synced.t_end,
                frame_id=synced.scan.frame_id,
                pose=Pose3(pose_opt[0], pose_opt[1]),
                ins_pose=ins_pose,
                covariance=cov_opt,
            )
        )
        self._stats.add(
            KeyFrameStats(
                frame_id=synced.scan.frame_id,
                timestamp=synced.t_end,
                num_points=num_points,
                ndt_iterations=int(ndt_iters),
                converged=bool(ndt_converged > 0.5),
                score=float(ndt_score),
                ins_sigma=ins_sigma,
                scaled_sigma=scaled_sigma,
                lidar_sigma=np.sqrt(np.maximum(np.diag(lidar_cov), 0.0)),
                optimized_sigma=np.sqrt(np.maximum(np.diag(cov_opt), 0.0)),
                align_time_ms=dt_ms,
                ins_pose=_p7(np.asarray(ins_pose.rot), np.asarray(ins_pose.trans)),
                optimized_pose=_p7(pose_opt[0], pose_opt[1]),
                # INS-vs-optimized translation gap (pipeline.cpp:745-752)
                pose_rmse=float(
                    np.linalg.norm(np.asarray(ins_pose.trans) - np.asarray(pose_opt[1]))
                ),
                trust_weight=float(w),
            )
        )

    @property
    def _flat_dtype(self):
        return np.float64 if jax.config.jax_enable_x64 else np.float32

    def _start(self, ins_pose, ins_sigma, synced, scan):
        W = self.window
        cd = self._flat_dtype
        self._prev_ins = (
            np.asarray(ins_pose.rot, np.float64).copy(),
            np.asarray(ins_pose.trans, np.float64).copy(),
        )
        eye3 = np.tile(np.eye(3), (W, 1, 1))
        win_rot = eye3.copy()
        win_rot[0] = np.asarray(ins_pose.rot, np.float64)
        win_trans = np.zeros((W, 3))
        win_trans[0] = np.asarray(ins_pose.trans, np.float64)
        fp_sig = np.ones((W, 6))
        fp_sig[0] = np.maximum(ins_sigma, 1e-6)
        self._carry = dict(
            win_rot=jnp.asarray(win_rot, cd),
            win_trans=jnp.asarray(win_trans, cd),
            fp_rot=jnp.asarray(win_rot, cd),
            fp_trans=jnp.asarray(win_trans, cd),
            fp_sig=jnp.asarray(fp_sig, cd),
            fb_rot=jnp.asarray(eye3, cd),
            fb_trans=jnp.zeros((W, 3), cd),
            fb_si=jnp.asarray(np.tile(np.eye(6), (W, 1, 1)), cd),
            n=jnp.asarray(1, jnp.int32),
            # target-cloud ring, newest at slot M-1 (odom_target_window)
            prev_points=jnp.zeros(
                (self.tgt_window,) + scan.points.shape, scan.points.dtype
            )
            .at[self.tgt_window - 1]
            .set(scan.points),
            prev_mask=jnp.zeros((self.tgt_window,) + scan.mask.shape, bool)
            .at[self.tgt_window - 1]
            .set(scan.mask),
        )
        self._n_keyframes += 1
        if self.viz is not None:
            self.viz.push(self.viz.subsample(scan), ins_pose,
                          synced.scan.frame_id, ins_pose=ins_pose)
        if self._detector is not None:
            # copies: the originals enter the donated carry as prev_points
            self._closures += self._detector.add_keyframe(
                Pose3(np.asarray(ins_pose.rot, np.float64),
                      np.asarray(ins_pose.trans, np.float64)),
                jnp.array(scan.points, copy=True), jnp.array(scan.mask, copy=True),
            )
        self._trajectory.append(
            TrajectoryEntry(
                timestamp=synced.t_end,
                frame_id=synced.scan.frame_id,
                pose=ins_pose,
                ins_pose=ins_pose,
            )
        )

    def refine_loop_closures(self):
        """Offline pose-graph pass over the full trajectory: odometry-chain
        between factors (the per-keyframe NDT relatives and covariances) plus
        every verified loop closure (pipeline.cpp:676-736 completed with
        fusion.pose_graph). Rewrites self.trajectory poses in place and
        returns (refined_poses, closures)."""
        if self._detector is None:
            raise RuntimeError("construct the app with loop_closure=True")
        from ..fusion.loop_closure import refine_trajectory

        poses = [
            Pose3(jnp.asarray(e.pose.rot), jnp.asarray(e.pose.trans))
            for e in self.trajectory
        ]
        rels = [Pose3(jnp.asarray(r[0]), jnp.asarray(r[1])) for r, _ in self._odo_rels]
        covs = [c for _, c in self._odo_rels]
        if not self._closures:
            log.info("no loop closures found; trajectory unchanged")
            return poses, []
        # INS priors (trust-gain-scaled, like the live graph's) keep the
        # offline re-solve anchored to the GNSS information
        prior_poses = [
            Pose3(jnp.asarray(e.ins_pose.rot), jnp.asarray(e.ins_pose.trans))
            for e in self.trajectory
        ]
        prior_sigmas = []
        for k, rec in enumerate(self.stats.records[: len(self.trajectory)]):
            sig = np.asarray(rec.scaled_sigma)
            if not (sig > 0).all():
                sig = np.maximum(np.asarray(rec.ins_sigma), 1e-6)
            prior_sigmas.append(np.maximum(sig, 1e-6))
        while len(prior_sigmas) < len(self.trajectory):
            prior_sigmas.append(np.full(6, 1e-2))
        refined, _result = refine_trajectory(
            poses, rels, covs, self._closures,
            prior_poses=prior_poses, prior_sigmas=prior_sigmas,
        )
        for e, p in zip(self.trajectory, refined):
            e.pose = Pose3(np.asarray(p.rot, np.float64), np.asarray(p.trans, np.float64))
        return refined, self._closures
