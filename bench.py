"""Headline benchmark: scan-to-map NDT registrations/sec at 128k pts/scan.

Prints ONE JSON line {"metric", "value", "unit", "device", ...}; the device
is the one JAX measured on, and a run that finds no GPU fails.
Each registration = a full Newton P2D-NDT alignment (DIRECT7, 1.0 m voxels,
30 max iterations) of a 128k-point scan against a prebuilt Gaussian voxel
map — the reference hot path (ndt_omp align, run/pipeline.cpp:558-563).

Extra modes:
  python bench.py --mode svn        # SVN-NDT K=20 at the reference config
  python bench.py --mode posegraph  # batch 10k-pose graph smoothing
  python bench.py --mode pair_math_ab  # pair-math kernel vs plain XLA
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

import numpy as np

from slamtpu.runtime.jaxcache import enable_persistent_cache

enable_persistent_cache()

N_POINTS = 128 * 1024
RESOLUTION = 1.0
MAP_CAPACITY = 1 << 16
MAX_ITERS = 30


def _device() -> dict:
    """The device this run measures, as JAX reports it; no GPU is an error."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"bench.py measures on a GPU; JAX found {devices[0].platform}"
        )
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def _record(rec: dict) -> str:
    """One result line, naming its device."""
    return json.dumps({**rec, "device": _device()})


def _berlin_meta_lidar():
    """The OS-2-128-shaped sensor of the Berlin cells: 2048 x 128, channel
    stride 4 (~65k points per sweep, padded to 2^17)."""
    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    import simulator

    from slamtpu.lidar.ouster import LidarParams

    meta = simulator.small_meta(cols=2048, pix=128, cpp=16)
    return meta, LidarParams(channel_stride=4, range_filter=(0.5, 150.0))


def lo_berlin_config(rebuild_every: int = 4, exclude_recent: int = 3):
    """lo_svn at the Berlin operating point (K=20 SVN particles, 2^17 map
    capacity, deskew on, plane-to-plane polish)."""
    from slamtpu.ins.imu_config import ImuConfig
    from slamtpu.runtime.config import PipelineConfig, RegisterConfig

    meta, lidar = _berlin_meta_lidar()
    return PipelineConfig(
        meta=meta,
        lidar=lidar,
        imu=ImuConfig(),
        register=RegisterConfig(
            # the published pose comes from the prior-start polish; the SVN
            # flow supplies the posterior covariance, which is fully
            # stabilized long before the budget: at this operating point the
            # posterior sigmas at 4/8/16 iterations agree within 0.25% and
            # ATE is bit-identical (measured) — 8 keeps a 2x safety margin at
            # half the stage-1 cost
            svn_resolution=1.0, svn_particles=20, svn_max_iterations=8,
            svn_kernel_h=5.0, svn_step_size=1.0,
            map_capacity=1 << 17,
            min_points_per_voxel=4, keyframe_window=5,
            reg_grid_shape=(256, 256, 32),
            map_rebuild_every=rebuild_every,
            map_exclude_recent=exclude_recent,
        ),
        deskew=True,
    )


def odom_berlin_config():
    """odom_ndt at the Berlin operating point (scan-to-previous Newton NDT,
    deskew on)."""
    from slamtpu.ins.imu_config import ImuConfig
    from slamtpu.runtime.config import PipelineConfig, RegisterConfig

    meta, lidar = _berlin_meta_lidar()
    return PipelineConfig(
        meta=meta,
        lidar=lidar,
        imu=ImuConfig(),
        register=RegisterConfig(
            ndt_resolution=1.0, ndt_max_iterations=20,
            # one 65k-pt scan per target: ~15k occupied voxels, 2x headroom
            # (RegMap.overflow guards the sizing)
            map_capacity=1 << 15,
            min_points_per_voxel=4,
            reg_grid_shape=(160, 160, 32),
        ),
        deskew=True,
    )


def bench_posegraph(n_poses: int = 10_000):
    """Config 5: sparse LM over a 10k-pose graph with loop closures."""
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3
    from slamtpu.core.se3 import Pose3
    from slamtpu.fusion import PoseGraphConfig, make_graph
    from slamtpu.fusion import pose_graph as pg

    rng = np.random.default_rng(7)
    # Closed-form circular ground truth in float64 (chaining between/compose
    # in float32 at 500 m translation scale loses ~2e-4 relative per step
    # SYSTEMATICALLY — measured 1.7 km of drift over a noise-free 10k chain).
    radius = 500.0
    yaw = 2 * np.pi * np.arange(n_poses) / n_poses
    gt_t64 = np.stack(
        [radius * np.sin(yaw), radius * (1 - np.cos(yaw)), np.zeros(n_poses)], -1
    )
    cy, sy = np.cos(yaw), np.sin(yaw)
    z = np.zeros(n_poses)
    o = np.ones(n_poses)
    gt_R64 = np.stack(
        [np.stack([cy, -sy, z], -1), np.stack([sy, cy, z], -1),
         np.stack([z, z, o], -1)], 1
    )
    gt = Pose3(jnp.asarray(gt_R64, jnp.float32), jnp.asarray(gt_t64, jnp.float32))
    # exact relative motions in f64, perturbed, chained in f64 for the init
    rel_R64 = np.einsum("nji,njk->nik", gt_R64[:-1], gt_R64[1:])
    rel_t64 = np.einsum("nji,nj->ni", gt_R64[:-1], gt_t64[1:] - gt_t64[:-1])
    noise = rng.normal(size=(n_poses - 1, 6)) * np.array([1e-4] * 3 + [3e-3] * 3)
    rel64 = se3.retract(
        Pose3(jnp.asarray(rel_R64), jnp.asarray(rel_t64)), jnp.asarray(noise)
    )  # f64 on CPU-capable backends; magnitudes are small so f32 also safe
    rel_odo = Pose3(rel64.rot.astype(jnp.float32), rel64.trans.astype(jnp.float32))
    rrot = np.asarray(rel64.rot, np.float64)
    rt = np.asarray(rel64.trans, np.float64)
    init_R = np.empty_like(gt_R64)
    init_t = np.empty_like(gt_t64)
    init_R[0] = gt_R64[0]
    init_t[0] = gt_t64[0]
    for k in range(n_poses - 1):
        init_t[k + 1] = init_t[k] + init_R[k] @ rt[k]
        init_R[k + 1] = init_R[k] @ rrot[k]
    init = Pose3(jnp.asarray(init_R, jnp.float32), jnp.asarray(init_t, jnp.float32))
    # 150 mid-range closures + 50 circle-closing pairs (end revisits start)
    n_mid = 150
    li_mid = rng.integers(0, n_poses - 1000, n_mid)
    lj_mid = li_mid + rng.integers(500, 999, n_mid)
    li_end = rng.integers(0, 50, 50)
    lj_end = n_poses - 50 + rng.integers(0, 50, 50)
    li = np.concatenate([li_mid, li_end])
    lj = np.concatenate([lj_mid, lj_end])
    lr_R = np.einsum("nji,njk->nik", gt_R64[li], gt_R64[lj])
    lr_t = np.einsum("nji,nj->ni", gt_R64[li], gt_t64[lj] - gt_t64[li])
    i = jnp.concatenate([jnp.arange(n_poses - 1), jnp.asarray(li)]).astype(jnp.int32)
    j = jnp.concatenate([jnp.arange(1, n_poses), jnp.asarray(lj)]).astype(jnp.int32)
    rel = Pose3(
        jnp.concatenate([rel_odo.rot, jnp.asarray(lr_R, jnp.float32)]),
        jnp.concatenate([rel_odo.trans, jnp.asarray(lr_t, jnp.float32)]),
    )
    si = jnp.broadcast_to(jnp.eye(6, dtype=jnp.float32) * 100.0, (i.shape[0], 6, 6))
    graph = make_graph(init, i, j, rel, si)
    cfg = PoseGraphConfig(gn_iterations=8, cg_iterations=60)
    opt = jax.jit(pg.optimize, static_argnames=("cfg",))
    res = opt(graph, cfg)
    jax.block_until_ready(res.poses.trans)
    # chained timing (each solve re-linearized at the previous solution)
    t0 = time.perf_counter()
    g = graph
    for _ in range(3):
        res = opt(g, cfg)
        g = g._replace(poses=res.poses)
    jax.block_until_ready(res.poses.trans)
    dt = (time.perf_counter() - t0) / 3
    drift_before = float(jnp.linalg.norm(init.trans[-1] - gt.trans[-1]))
    drift_after = float(jnp.linalg.norm(res.poses.trans[-1] - gt.trans[-1]))
    print(
        _record(
            {
                "metric": f"batch pose-graph LM ({n_poses} poses, {i.shape[0]} factors, 8 GN x 60 PCG)",
                "value": round(dt * 1e3, 1),
                "unit": "ms/solve",
                "detail": {
                    "end_drift_before_m": round(drift_before, 3),
                    "end_drift_after_m": round(drift_after, 3),
                },
            }
        )
    )


def bench_svn():
    """Config 2 operating point: SVN-NDT K=20 at the reference config."""
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3
    from slamtpu.mapping import gaussian_map
    from slamtpu.ndt import SvnConfig, build_regmap, svn_align_reg

    world, pts, mask, origin = _world()
    gmap = jax.jit(
        gaussian_map.build_map, static_argnames=("capacity", "min_points_per_voxel")
    )(pts, mask, origin, RESOLUTION, capacity=MAP_CAPACITY)
    regmap = build_regmap(gmap, grid_shape=(192, 192, 48))
    rng = np.random.default_rng(42)
    src = jnp.asarray(world + rng.normal(0, 0.01, world.shape).astype(np.float32))
    gt = se3.expmap(jnp.asarray([0.004, -0.006, 0.02, 0.1, -0.08, 0.02], jnp.float32))
    src_body = se3.transform_points(se3.inverse(gt), src)
    cfg = SvnConfig(
        resolution=RESOLUTION, num_particles=20, max_iterations=30,
        kernel_h=5.0, step_size=1.0, stop_thresh=1e-4,
    )
    align = jax.jit(svn_align_reg, static_argnames=("cfg", "grid_shape"))
    res = align(src_body, mask, regmap, se3.identity(dtype=jnp.float32),
                jax.random.PRNGKey(0), cfg, (192, 192, 48))
    jax.block_until_ready(res.pose.trans)
    t0 = time.perf_counter()
    for _ in range(5):
        res = align(src_body, mask, regmap, se3.identity(dtype=jnp.float32),
                    jax.random.PRNGKey(0), cfg, (192, 192, 48))
    jax.block_until_ready(res.pose.trans)
    dt = (time.perf_counter() - t0) / 5
    err = np.asarray(se3.local(gt, res.pose))
    it = max(int(res.iterations), 1)
    print(
        _record(
            {
                "metric": "SVN-NDT alignment (K=20 particles, 128k pts, 1.0 m voxels)",
                "value": round(dt * 1e3 / it, 2),
                "unit": "ms/iteration",
                "detail": {
                    "iterations": it,
                    "ms_per_alignment": round(dt * 1e3, 1),
                    "trans_err_m": round(float(np.linalg.norm(err[3:])), 4),
                    "note": "reference: 70-90 ms/iter on ~11k-pt scans (output/output.txt)",
                },
            }
        )
    )



def _timed_replay(app, path, warmup: int = 8):
    """Run the app over a replay; returns (trajectory, total_wall_s,
    warm_kf_per_s) where the warm rate excludes the first ``warmup``
    keyframes (jit compilation dominates them)."""
    frames = list(app.ingest.synced_frames(path))
    t0 = time.perf_counter()
    t_warm_start = None
    for i, s in enumerate(frames):
        if i == warmup:
            # drain queued warmup work (compiles) so it cannot bleed into
            # the steady-state window of async-dispatch apps
            getattr(app, "flush", lambda: None)()
            t_warm_start = time.perf_counter()
        app.process(s)
    # apps with deferred recording dispatch async; drain before stopping the
    # clock or the rate reads as dispatch throughput, not work throughput
    getattr(app, "flush", lambda: None)()
    t_end = time.perf_counter()
    warm = (
        (len(frames) - warmup) / (t_end - t_warm_start)
        if t_warm_start is not None and len(frames) > warmup
        else None
    )
    return app.trajectory, t_end - t0, warm


def bench_lo100(n_sweeps: int = 100):
    """Config 2: SVN-NDT LiDAR odometry over a 100-scan replayed sequence
    with an incremental keyframe-window map (the full lo_svn app: packet
    decode -> sync -> project -> SVN registration per keyframe)."""
    import tempfile, os
    import jax

    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    import importlib

    simulator = importlib.import_module("simulator")
    from slamtpu.apps import LoSvnApp
    from slamtpu.apps.common import ate_rmse
    from slamtpu.core.se3 import Pose3
    from slamtpu.core import se3
    import jax.numpy as jnp
    from slamtpu.lidar.ouster import LidarParams
    from slamtpu.runtime.config import PipelineConfig, RegisterConfig

    meta = simulator.small_meta(cols=256, pix=64, cpp=16)
    cfg = PipelineConfig(
        meta=meta,
        lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
        imu=__import__("slamtpu.ins.imu_config", fromlist=["ImuConfig"]).ImuConfig(),
        register=RegisterConfig(
            svn_resolution=1.0, svn_particles=20, svn_max_iterations=30,
            svn_kernel_h=5.0, svn_step_size=1.0,
            # capacity sized to the scene (~400 occupied voxels/scan, 3-scan
            # window): regmap build cost scales with capacity (29.8 ms at
            # 1<<15 vs 10.3 ms at 1<<13 for the same 16k-pt scan)
            map_capacity=1 << 14,
            min_points_per_voxel=4, keyframe_window=3,
            reg_grid_shape=(256, 256, 32),
            # measured on the 100-scan sim: identical ATE to per-keyframe
            # rebuild (0.0325 vs 0.0323 m) at 4x the keyframe rate
            map_rebuild_every=4,
        ),
    )
    path = os.path.join(tempfile.mkdtemp(), "lo100.rpl")
    gt = simulator.simulate_replay(path, meta, cfg.lidar, n_sweeps=n_sweeps)
    app = LoSvnApp(cfg)
    traj, dt, warm_kf_s = _timed_replay(app, path)
    # relative-to-first-keyframe ATE vs ground truth
    gt_poses = [Pose3(jnp.asarray(R), jnp.asarray(p)) for R, p in gt[1:]]
    a0, g0 = traj[0].pose, gt_poses[0]
    rel_app = [se3.between(a0, e.pose) for e in traj]
    rel_gt = [se3.between(g0, g) for g in gt_poses[: len(traj)]]
    ate = ate_rmse(rel_app, rel_gt)
    print(
        _record(
            {
                "metric": f"SVN-NDT LiDAR odometry over {n_sweeps}-scan replay (full app incl. decode)",
                "value": round(warm_kf_s or len(traj) / dt, 2),
                "unit": "keyframes/s (steady-state)",
                "detail": {
                    "keyframes": len(traj),
                    "wall_s": round(dt, 1),
                    "total_kf_s": round(len(traj) / dt, 2),
                    "ate_rmse_m": round(ate, 4),
                    "stage_ms": app.timer.summary(),
                },
            }
        )
    )


def bench_lo_berlin(
    n_sweeps: int = 30, rebuild_every: int = 4, exclude_recent: int = 3
):
    """Config 2 at the REAL Berlin operating point: OS-2-128-shaped sensor
    (2048 x 128, stride 4 -> ~65k pts/scan after decode, 10 Hz), full lo_svn
    replay at 2^17 map capacity. Reports steady-state keyframes/s (>=10 is
    real-time) and ATE; runs the per-keyframe-rebuild parity config and the
    reduced-cadence config side by side.

    Operating point (from the lo_svn ATE error budget): rebuild every 4
    keyframes with the newest 3 ring clouds excluded from builds — the
    exclusion removes the measured viewpoint-proximity bias (ATE 0.0107 ->
    0.0031 m at 48 sweeps) and the tighter cadence keeps the target fresh
    under exclusion."""
    import tempfile, os
    import importlib

    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    simulator = importlib.import_module("simulator")
    import dataclasses as _dc

    import jax.numpy as jnp

    from slamtpu.apps import LoSvnApp
    from slamtpu.apps.common import ate_rmse
    from slamtpu.core import se3
    from slamtpu.core.se3 import Pose3

    cfg = lo_berlin_config(rebuild_every, exclude_recent)
    meta = cfg.meta
    path = os.path.join(tempfile.mkdtemp(), "berlin.rpl")
    # skewed=True: each column rendered from the sensor pose at its own
    # timestamp — what a real spinning lidar measures (and what makes the
    # deskew path honest work instead of a no-op)
    gt = simulator.simulate_replay(
        path, meta, cfg.lidar, n_sweeps=n_sweeps, skewed=True
    )
    app = LoSvnApp(cfg)
    traj, dt, warm_kf_s = _timed_replay(app, path)
    gt_poses = [Pose3(jnp.asarray(R), jnp.asarray(p)) for R, p in gt[1:]]
    a0, g0 = traj[0].pose, gt_poses[0]
    ate = ate_rmse(
        [se3.between(a0, e.pose) for e in traj],
        [se3.between(g0, g) for g in gt_poses[: len(traj)]],
    )
    # parity config (rebuild every keyframe, full window) for the honest
    # comparison with the reference semantics
    cfg1 = _dc.replace(
        cfg,
        register=_dc.replace(
            cfg.register, map_rebuild_every=1, map_exclude_recent=0
        ),
    )
    app1 = LoSvnApp(cfg1)
    traj1, dt1, warm1 = _timed_replay(app1, path)
    ate1 = ate_rmse(
        [se3.between(traj1[0].pose, e.pose) for e in traj1],
        [se3.between(g0, g) for g in gt_poses[: len(traj1)]],
    )
    # deskew-off comparison on the same skewed replay (the reference's
    # behavior: alpha computed, never applied — dataframe.hpp:406-433)
    cfg_nd = _dc.replace(cfg, deskew=False)
    app_nd = LoSvnApp(cfg_nd)
    traj_nd, dt_nd, _warm_nd = _timed_replay(app_nd, path)
    ate_nd = ate_rmse(
        [se3.between(traj_nd[0].pose, e.pose) for e in traj_nd],
        [se3.between(g0, g) for g in gt_poses[: len(traj_nd)]],
    )
    # proof the ablation is wired (round-4 advisor: identical rounded ATEs
    # made it look like a no-op): max per-keyframe translation delta between
    # the deskew-on and deskew-off trajectories — nonzero iff the toggle
    # changes the trace
    import numpy as _np

    nd_delta = float(
        max(
            _np.linalg.norm(
                _np.asarray(a.pose.trans, _np.float64)
                - _np.asarray(b.pose.trans, _np.float64)
            )
            for a, b in zip(traj, traj_nd)
        )
    )
    print(
        _record(
            {
                "metric": f"SVN-NDT LO at Berlin scale (2048x128 stride 4, {n_sweeps} skewed sweeps, deskew on, 2^17 capacity)",
                "value": round(warm_kf_s or len(traj) / dt, 2),
                "unit": "keyframes/s (steady-state)",
                "detail": {
                    "rebuild_every": rebuild_every,
                    "exclude_recent": exclude_recent,
                    "ate_rmse_m": round(ate, 4),
                    "stage_ms": app.timer.summary(),
                    "parity_rebuild1_kf_s": round(warm1 or len(traj1) / dt1, 2),
                    "parity_rebuild1_ate_m": round(ate1, 4),
                    "deskew_off_ate_m": round(ate_nd, 4),
                    "deskew_off_traj_delta_m": round(nd_delta, 5),
                },
            }
        )
    )


def bench_ate_budget(n_sweeps: int = 48):
    """Error-budget decomposition of lo_svn's Berlin-scale ATE. Each run
    reports the
    published-pose error per keyframe in the GT BODY frame
    (longitudinal / lateral / vertical), separating systematic bias from
    noise:

      ins    — publish the INS prior: measures prior quality (the sim's nav
               stream is noiseless, so this pins "anchor-pose error ~= 0"
               and attributes everything else to registration);
      parity — reference semantics (rebuild every keyframe, full window):
               the constant fresh-map viewpoint-proximity bias;
      op     — the bench operating point (rebuild cadence + exclude-recent):
               what lo_berlin actually ships.
    """
    import tempfile, os
    import importlib
    import dataclasses as _dc

    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    simulator = importlib.import_module("simulator")
    import jax.numpy as jnp

    from slamtpu.apps import LoSvnApp
    from slamtpu.core import se3
    from slamtpu.core.se3 import Pose3
    from slamtpu.lidar.ouster import LidarParams
    from slamtpu.runtime.config import PipelineConfig, RegisterConfig

    meta = simulator.small_meta(cols=2048, pix=128, cpp=16)

    def cfg_with(**reg_over):
        base = dict(
            svn_resolution=1.0, svn_particles=20, svn_max_iterations=8,
            svn_kernel_h=5.0, svn_step_size=1.0, map_capacity=1 << 17,
            min_points_per_voxel=4, keyframe_window=5,
            reg_grid_shape=(256, 256, 32),
        )
        base.update(reg_over)
        return PipelineConfig(
            meta=meta,
            lidar=LidarParams(channel_stride=4, range_filter=(0.5, 150.0)),
            imu=__import__(
                "slamtpu.ins.imu_config", fromlist=["ImuConfig"]
            ).ImuConfig(),
            register=RegisterConfig(**base),
            deskew=True,
        )

    path = os.path.join(tempfile.mkdtemp(), "berlin_budget.rpl")
    gt = simulator.simulate_replay(
        path, meta, LidarParams(channel_stride=4, range_filter=(0.5, 150.0)),
        n_sweeps=n_sweeps, skewed=True,
    )
    gt_poses = [Pose3(jnp.asarray(R), jnp.asarray(p)) for R, p in gt[1:]]

    def decompose(traj):
        import numpy as np

        n = min(len(traj), len(gt_poses))
        a0, g0 = traj[0].pose, gt_poses[0]
        errs = []
        for e, g in zip(traj[:n], gt_poses[:n]):
            rel_e = se3.between(a0, e.pose)
            rel_g = se3.between(g0, g)
            dtw = np.asarray(rel_e.trans, np.float64) - np.asarray(
                rel_g.trans, np.float64
            )
            errs.append(np.asarray(rel_g.rot, np.float64).T @ dtw)
        errs = np.stack(errs)
        return {
            "ate_m": round(float(np.sqrt((errs**2).sum(1).mean())), 5),
            "bias_body_mm": [round(v, 2) for v in (errs.mean(0) * 1e3)],
            "std_body_mm": [round(v, 2) for v in (errs.std(0) * 1e3)],
        }

    out = {}
    runs = {
        "ins": (dict(map_rebuild_every=6), "ins"),
        "parity": (dict(map_rebuild_every=1), "svn"),
        "op": (
            dict(map_rebuild_every=4, map_exclude_recent=3), "svn"
        ),
    }
    for name, (reg_over, publish) in runs.items():
        app = LoSvnApp(cfg_with(**reg_over), publish=publish)
        traj = app.run_replay(path)
        out[name] = decompose(traj)
    print(
        _record(
            {
                "metric": "lo_svn Berlin-scale ATE error budget "
                f"({n_sweeps} skewed sweeps; body-frame [fwd, left, down])",
                "value": out["op"]["ate_m"],
                "unit": "m ATE at the operating point",
                "detail": out,
            }
        )
    )


def bench_ligo_berlin(n_sweeps: int = 30):
    """Config 3 (the reference's most complete pipeline,
    /root/reference/run/pipeline_ligo_tc.cpp:339-622) at the Berlin operating
    point: tightly-coupled LiDAR-IMU odometry — IMU preintegration chain at
    50 Hz + scan-to-window NDT + sliding-window smoother — on the
    OS-2-128-shaped sensor (2048 x 128 stride 4, skewed sweeps, 10 Hz).
    Round-5 ask #3: the preintegration + window-smoother chain has different
    host-device economics than lo_svn (per-keyframe host-side smoother sync),
    so real-time at sensor scale needed its own measurement."""
    import tempfile, os
    import importlib

    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    simulator = importlib.import_module("simulator")
    import jax.numpy as jnp

    from slamtpu.apps import LigoTcApp
    from slamtpu.apps.common import ate_rmse
    from slamtpu.core import se3
    from slamtpu.core.se3 import Pose3
    from slamtpu.lidar.ouster import LidarParams
    from slamtpu.runtime.config import PipelineConfig, RegisterConfig

    meta = simulator.small_meta(cols=2048, pix=128, cpp=16)
    cfg = PipelineConfig(
        meta=meta,
        lidar=LidarParams(channel_stride=4, range_filter=(0.5, 150.0)),
        imu=__import__("slamtpu.ins.imu_config", fromlist=["ImuConfig"]).ImuConfig(),
        register=RegisterConfig(
            ndt_resolution=1.0, ndt_max_iterations=20,
            # scan-to-window target: W-1 65k-pt scans -> ~20k occupied voxels
            map_capacity=1 << 16,
            min_points_per_voxel=4,
            reg_grid_shape=(192, 192, 32),
            # operating point (round 5): amortize the map+RegMap build like
            # lo_berlin — per-keyframe rebuild measured 4.65 kf/s
            map_rebuild_every=4,
        ),
        deskew=True,
    )
    path = os.path.join(tempfile.mkdtemp(), "berlin_ligo.rpl")
    gt = simulator.simulate_replay(
        path, meta, cfg.lidar, n_sweeps=n_sweeps, skewed=True
    )
    app = LigoTcApp(cfg, window=6)
    traj, dt, warm_kf_s = _timed_replay(app, path)
    gt_poses = [Pose3(jnp.asarray(R), jnp.asarray(p)) for R, p in gt[1:]]
    a0, g0 = traj[0].pose, gt_poses[0]
    ate = ate_rmse(
        [se3.between(a0, e.pose) for e in traj],
        [se3.between(g0, g) for g in gt_poses[: len(traj)]],
    )
    # parity variant: per-keyframe rebuild (reference setInputTarget
    # semantics) + the conservative QR smoother solve
    import dataclasses as _dc

    cfg1 = _dc.replace(
        cfg,
        register=_dc.replace(
            cfg.register, map_rebuild_every=1, smoother_solver="qr"
        ),
    )
    app1 = LigoTcApp(cfg1, window=6)
    traj1, dt1, warm1 = _timed_replay(app1, path)
    ate1 = ate_rmse(
        [se3.between(traj1[0].pose, e.pose) for e in traj1],
        [se3.between(g0, g) for g in gt_poses[: len(traj1)]],
    )
    print(
        _record(
            {
                "metric": f"tightly-coupled LiDAR-IMU odometry at Berlin scale (2048x128 stride 4, {n_sweeps} skewed sweeps, 50 Hz IMU preintegration)",
                "value": round(warm_kf_s or len(traj) / dt, 2),
                "unit": "keyframes/s (steady-state)",
                "detail": {
                    "keyframes": len(traj),
                    "ate_rmse_m": round(ate, 4),
                    "stage_ms": app.timer.summary(),
                    "rebuild_every": 4,
                    "parity_rebuild1_qr_kf_s": round(warm1 or len(traj1) / dt1, 2),
                    "parity_rebuild1_qr_ate_m": round(ate1, 4),
                },
            }
        )
    )


def bench_odom_berlin(n_sweeps: int = 30):
    """odom_ndt (the reference `pipeline`) at the Berlin operating point:
    scan-to-previous-keyframe Newton NDT + window smoother on the
    OS-2-128-shaped sensor."""
    import tempfile, os
    import importlib

    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    simulator = importlib.import_module("simulator")
    import jax.numpy as jnp

    from slamtpu.apps import OdomNdtApp
    from slamtpu.apps.common import ate_rmse
    from slamtpu.core import se3
    from slamtpu.core.se3 import Pose3

    cfg = odom_berlin_config()
    meta = cfg.meta
    path = os.path.join(tempfile.mkdtemp(), "berlin_odom.rpl")
    gt = simulator.simulate_replay(
        path, meta, cfg.lidar, n_sweeps=n_sweeps, skewed=True
    )
    app = OdomNdtApp(cfg, window=6)
    traj, dt, warm_kf_s = _timed_replay(app, path)
    gt_poses = [Pose3(jnp.asarray(R), jnp.asarray(p)) for R, p in gt[1:]]
    a0, g0 = traj[0].pose, gt_poses[0]
    ate = ate_rmse(
        [se3.between(a0, e.pose) for e in traj],
        [se3.between(g0, g) for g in gt_poses[: len(traj)]],
    )
    # engine comparison: plane-to-plane GICP (our extension) vs the
    # reference's NDT engine on the same replay — NDT's density-sensitive
    # Gaussians alias on the ground-ring pattern
    import dataclasses as _dc

    cfg_g = _dc.replace(cfg, register=_dc.replace(
        cfg.register, method="GICP", gicp_source_cov="anisotropic",
        gicp_transform_epsilon=1e-4))
    app_g = OdomNdtApp(cfg_g, window=6)
    traj_g, dt_g, warm_g = _timed_replay(app_g, path)
    ate_g = ate_rmse(
        [se3.between(traj_g[0].pose, e.pose) for e in traj_g],
        [se3.between(g0, g) for g in gt_poses[: len(traj_g)]],
    )
    # multi-viewpoint target on the DEFAULT engine (odom_target_window=3):
    # the single-scan NDT target carries its ground-ring sampling pattern
    # into the voxel Gaussians, and scan-to-previous cannot exclude-recent
    # (the target IS the nearest viewpoint) — blending 3 viewpoints
    # decorrelates the pattern
    cfg_w = _dc.replace(cfg, register=_dc.replace(
        cfg.register, odom_target_window=3, map_capacity=1 << 16,
        reg_grid_shape=(192, 192, 32)))
    app_w = OdomNdtApp(cfg_w, window=6)
    traj_w, dt_w, warm_w = _timed_replay(app_w, path)
    ate_w = ate_rmse(
        [se3.between(traj_w[0].pose, e.pose) for e in traj_w],
        [se3.between(g0, g) for g in gt_poses[: len(traj_w)]],
    )
    print(
        _record(
            {
                "metric": f"Newton-NDT odometry at Berlin scale (2048x128 stride 4, {n_sweeps} skewed sweeps, deskew on)",
                "value": round(warm_kf_s or len(traj) / dt, 2),
                "unit": "keyframes/s (steady-state)",
                "detail": {
                    "ate_rmse_m": round(ate, 4),
                    "stage_ms": app.timer.summary(),
                    "gicp_aniso_engine_kf_s": round(warm_g or len(traj_g) / dt_g, 2),
                    "gicp_aniso_engine_ate_m": round(ate_g, 4),
                    "target_window3_kf_s": round(warm_w or len(traj_w) / dt_w, 2),
                    "target_window3_ate_m": round(ate_w, 4),
                },
            }
        )
    )


def _app_bench(app_name: str, n_sweeps: int = 50):
    """Configs 3/4: full tightly-coupled (ligo_tc) or INS-mapping (ins_map)
    app over a replayed sequence."""
    import tempfile, os
    import importlib

    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    simulator = importlib.import_module("simulator")
    from slamtpu.lidar.ouster import LidarParams
    from slamtpu.runtime.config import PipelineConfig, RegisterConfig

    meta = simulator.small_meta(cols=256, pix=64, cpp=16)
    cfg = PipelineConfig(
        meta=meta,
        lidar=LidarParams(channel_stride=1, range_filter=(0.5, 150.0)),
        imu=__import__("slamtpu.ins.imu_config", fromlist=["ImuConfig"]).ImuConfig(),
        register=RegisterConfig(
            ndt_resolution=1.0, ndt_max_iterations=20,
            map_capacity=1 << 13,  # ~400 occupied voxels/scan: 22x headroom
            min_points_per_voxel=4, reg_grid_shape=(256, 256, 32),
        ),
    )
    path = os.path.join(tempfile.mkdtemp(), "app.rpl")
    gt = simulator.simulate_replay(path, meta, cfg.lidar, n_sweeps=n_sweeps)
    if app_name == "ligo":
        from slamtpu.apps import LigoTcApp

        app = LigoTcApp(cfg, window=6)
    else:
        from slamtpu.apps import InsMapApp

        app = InsMapApp(cfg, resolution=1.0)
    traj, dt, warm_kf_s = _timed_replay(app, path)
    detail = {"keyframes": len(traj), "wall_s": round(dt, 1),
              "total_kf_s": round(len(traj) / dt, 2),
              "stage_ms": getattr(app, "timer", None) and app.timer.summary()}
    if app_name == "ligo":
        from slamtpu.core import se3
        from slamtpu.core.se3 import Pose3
        import jax.numpy as jnp
        from slamtpu.apps.common import ate_rmse

        gt_poses = [Pose3(jnp.asarray(R), jnp.asarray(p)) for R, p in gt[1:]]
        a0, g0 = traj[0].pose, gt_poses[0]
        detail["ate_rmse_m"] = round(
            ate_rmse([se3.between(a0, e.pose) for e in traj],
                     [se3.between(g0, g) for g in gt_poses[: len(traj)]]), 4)
        name = f"tightly-coupled LiDAR-IMU odometry over {n_sweeps}-scan replay"
    else:
        import numpy as _np

        gmap = app.finalize_and_export(os.path.join(tempfile.mkdtemp(), "map"))
        detail["valid_voxels"] = int(gmap.num_valid())
        name = f"GNSS/INS mapping + NDT map distribution over {n_sweeps}-scan replay"
    print(_record({"metric": name, "value": round(warm_kf_s or len(traj) / dt, 2),
                      "unit": "keyframes/s (steady-state)",
                      "detail": detail}))



def _batch_scenario(world, B: int):
    """B noisy copies of the world at staggered offsets + their true xis."""
    import jax.numpy as jnp

    from slamtpu.core import se3

    rng = np.random.default_rng(42)
    xis, srcs = [], []
    for b in range(B):
        src = world + rng.normal(0, 0.01, world.shape).astype(np.float32)
        xi = np.array(
            [0.004, -0.006, 0.02, 0.6, -0.4, 0.08], np.float32
        ) * (0.5 + b / B)
        gt_b = se3.expmap(jnp.asarray(xi))
        srcs.append(
            np.asarray(se3.transform_points(se3.inverse(gt_b), jnp.asarray(src)))
        )
        xis.append(xi)
    return jnp.asarray(np.stack(srcs)), jnp.ones((B, world.shape[0]), bool), xis


def _hard_scenario(world):
    """~60%-overlap source: keep a jittered half-plane of the world, replace
    the rest with clutter partly outside the mapped extent. Returns
    (source_points float32 ndarray, overlap_fraction)."""
    rng = np.random.default_rng(7)
    keep = world[:, 0] + rng.normal(0, 8.0, world.shape[0]) < 48.0
    n_keep = int(keep.sum())
    src = np.empty_like(world)
    src[:n_keep] = world[keep] + rng.normal(0, 0.01, (n_keep, 3)).astype(np.float32)
    n_new = world.shape[0] - n_keep
    src[n_keep:] = np.stack(
        [rng.uniform(60, 110, n_new), rng.uniform(0, 80, n_new),
         rng.uniform(0, 6, n_new)], -1
    ).astype(np.float32)
    return src, n_keep / world.shape[0]


def bench_batch(B: int = 32):
    """Config 1 throughput variant: B concurrent registrations against one
    shared map in a single dispatch (newton_align_fused_batch). Aggregate
    registrations/s; per-scan accuracy asserted."""
    import jax

    world, _mask, regmap, *_ = headline_case()
    align, xis = batch32_case(world, regmap, B)
    res = align()
    check_batch32(res, xis)
    n_rep = 10
    t0 = time.perf_counter()
    for _ in range(n_rep):
        res = align()
    jax.block_until_ready(res.pose.trans)
    dt = (time.perf_counter() - t0) / n_rep
    agg = B / dt
    print(
        _record(
            {
                "metric": f"batched scan-to-map NDT ({B} scans x 128k pts/dispatch)",
                "value": round(agg, 2),
                "unit": "registrations/s (aggregate)",
                "detail": {
                    "ms_per_dispatch": round(dt * 1e3, 2),
                    "ms_per_registration": round(dt * 1e3 / B, 3),
                    "max_iters": int(np.max(np.asarray(res.iterations))),
                },
            }
        )
    )


def bench_ingest(duration_s: float = 11.0):
    """Sustained live-ingest soak at the Berlin operating regime: loopback
    UDP at the real sensor rate (1280 x 24832 B lidar datagrams/s + 50 Hz
    ANPP, src/lidarcallback.cpp:208-209) through
    LivePipeline(io_backend=\"native\") — the C++ receiver built exactly for
    this rate. Reports delivered SyncedFrames, ring/queue drops, and
    end-to-end packet->SyncedFrame latency. Send pacing follows the recorded
    sensor timestamps (realtime factor 1.0)."""
    import importlib
    import os
    import socket
    import tempfile
    import threading

    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    simulator = importlib.import_module("simulator")
    import asyncio

    from slamtpu.lidar.ouster import LidarParams
    from slamtpu.runtime.live import LivePipeline
    from slamtpu.runtime.replay import STREAM_LIDAR, read_replay
    from slamtpu.runtime.udp import UdpConfig
    from slamtpu.runtime.config import PipelineConfig, RegisterConfig

    n_sweeps = int(duration_s * 10) + 2
    meta = simulator.small_meta(cols=2048, pix=128, cpp=16)
    cfg = PipelineConfig(
        meta=meta,
        lidar=LidarParams(channel_stride=4, range_filter=(0.5, 150.0)),
        imu=__import__("slamtpu.ins.imu_config", fromlist=["ImuConfig"]).ImuConfig(),
        register=RegisterConfig(),
    )
    # the Berlin-scale raycast is expensive (~6 min for 112 sweeps); the
    # replay is deterministic (seeded), so cache it across bench runs
    cache_dir = os.path.expanduser("~/.cache/slamtpu-bench")
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"ingest_berlin_{n_sweeps}.rpl")
    t_gen = 0.0
    if not os.path.exists(path):
        t_gen = time.perf_counter()
        simulator.simulate_replay(path + ".tmp", meta, cfg.lidar, n_sweeps=n_sweeps)
        os.replace(path + ".tmp", path)
        t_gen = time.perf_counter() - t_gen
    packets = list(read_replay(path))
    lidar_per_sweep = meta.columns_per_frame // meta.columns_per_packet

    send_done = {}  # sweep index -> monotonic time its last lidar pkt was sent
    arrivals = []  # (frame_id, monotonic arrival time)

    class Collector:
        def process(self, synced):
            arrivals.append((synced.scan.frame_id, time.monotonic()))

    def free_port():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    lp, cp = free_port(), free_port()
    pipe = LivePipeline(
        cfg, Collector(),
        lidar_udp=UdpConfig(host="127.0.0.1", port=lp, buffer_size=1 << 24,
                            receive_timeout_s=2.0),
        compass_udp=UdpConfig(host="127.0.0.1", port=cp, receive_timeout_s=2.0),
        io_backend="native",
        queue_capacity=32,
    )
    sent = {"lidar": 0, "compass": 0}

    def sender():
        pipe.ready.wait(timeout=30.0)
        out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        t_start = time.monotonic()
        ts0 = packets[0][1]
        n_lidar = 0
        for stream, ts, payload in packets:
            lag = (ts - ts0) - (time.monotonic() - t_start)
            if lag > 0.0005:
                time.sleep(lag)
            out.sendto(payload, ("127.0.0.1", lp if stream == STREAM_LIDAR else cp))
            if stream == STREAM_LIDAR:
                sent["lidar"] += 1
                n_lidar += 1
                if n_lidar % lidar_per_sweep == 0:
                    send_done[n_lidar // lidar_per_sweep - 1] = time.monotonic()
            else:
                sent["compass"] += 1
        out.close()

    t = threading.Thread(target=sender, daemon=True)
    t.start()
    asyncio.run(pipe.run(duration_s=duration_s + 4.0))
    t.join(timeout=5.0)

    lat_ms = [
        1e3 * (ta - send_done[fid]) for fid, ta in arrivals if fid in send_done
    ]
    n_frames = len(arrivals)
    # the final sweep never completes (no next frame_id) and the first only
    # arms the sync window
    expected = n_sweeps - 2
    rx_drops = sum(pipe.rx_dropped.values())
    total_sent = sent["lidar"] + sent["compass"]
    drop_pct = 100.0 * rx_drops / max(total_sent, 1)
    byte_rate = sent["lidar"] * 24832 / duration_s
    print(
        _record(
            {
                "metric": f"native ingest soak at Berlin rate ({duration_s:.0f}s, "
                          "1280 x 24832B/s lidar + 50 Hz ANPP)",
                "value": round(n_frames / duration_s, 2),
                "unit": "SyncedFrames/s delivered",
                "detail": {
                    "frames_delivered": n_frames,
                    "frames_expected": expected,
                    "packets_sent": total_sent,
                    "ring_drops": rx_drops,
                    "ring_drop_pct": round(drop_pct, 3),
                    "queue_dropped_frames": pipe.dropped_frames,
                    "latency_ms_mean": round(float(np.mean(lat_ms)), 2) if lat_ms else None,
                    "latency_ms_p95": round(float(np.percentile(lat_ms, 95)), 2) if lat_ms else None,
                    "lidar_byte_rate_MBps": round(byte_rate / 1e6, 1),
                    "replay_gen_s": round(t_gen, 1),
                },
            }
        )
    )
    assert n_frames >= int(0.99 * expected), (n_frames, expected)
    assert drop_pct < 1.0, drop_pct


def bench_hard_overlap():
    """Config 1 honesty variant: ~60% overlap + out-of-map clutter + 0.72 m
    initial offset — real scan-to-map conditions instead of registering a
    copy of the map's own points."""
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3
    from slamtpu.mapping import gaussian_map
    from slamtpu.ndt import NewtonConfig, build_regmap, newton_align_fused

    world, pts, mask, origin = _world()
    gmap = jax.jit(
        gaussian_map.build_map, static_argnames=("capacity", "min_points_per_voxel")
    )(pts, mask, origin, RESOLUTION, capacity=MAP_CAPACITY)
    regmap = build_regmap(gmap, grid_shape=(192, 192, 48))
    src, overlap_frac = _hard_scenario(world)
    true_xi = jnp.asarray([0.004, -0.006, 0.02, 0.6, -0.4, 0.08], jnp.float32)
    gt = se3.expmap(true_xi)
    src_body = se3.transform_points(se3.inverse(gt), jnp.asarray(src))
    cfg = NewtonConfig(resolution=RESOLUTION, max_iterations=MAX_ITERS, trans_eps=1e-4)
    align = jax.jit(
        newton_align_fused, static_argnames=("cfg", "grid_shape", "inner_iters")
    )
    res = align(src_body, mask, regmap, se3.identity(dtype=jnp.float32), cfg,
                (192, 192, 48), 10)
    jax.block_until_ready(res.pose.trans)
    err = np.asarray(se3.local(gt, res.pose))
    te, re_ = float(np.linalg.norm(err[3:])), float(np.linalg.norm(err[:3]))
    assert te < 0.05 and re_ < 0.035, f"hard-overlap registration inaccurate: {err}"
    n_rep = 20
    t0 = time.perf_counter()
    for _ in range(n_rep):
        res = align(src_body, mask, regmap, se3.identity(dtype=jnp.float32), cfg,
                    (192, 192, 48), 10)
    jax.block_until_ready(res.pose.trans)
    dt = (time.perf_counter() - t0) / n_rep
    print(
        _record(
            {
                "metric": "scan-to-map NDT, ~60% overlap + out-of-map clutter (128k pts)",
                "value": round(1.0 / dt, 2),
                "unit": "registrations/s",
                "detail": {
                    "overlap_frac": round(overlap_frac, 3),
                    "trans_err_m": round(te, 5),
                    "rot_err_rad": round(re_, 5),
                    "iters": int(res.iterations),
                },
            }
        )
    )


def bench_map(capacity: int = 1 << 17, grid_shape=(256, 256, 64)):
    """Map-construction phase breakdown at the Berlin operating point
    (128k pts/scan, 2^17 voxel capacity): stats accumulate, finalize
    (eig3x3 + inflation + icov), RegMap build (dilate + dense grid +
    mega-row pack). These dominate the per-keyframe cost of the odometry
    apps; the registration itself is benchmarked by the default mode."""
    import jax
    import jax.numpy as jnp

    from slamtpu.mapping import gaussian_map
    from slamtpu.ndt import build_regmap

    world, pts, mask, origin = _world()
    res = jnp.asarray(RESOLUTION)

    # Phase timings run inside one jitted fori_loop with a data dependence
    # threaded through the carry, so each phase is timed on the device and
    # not at dispatch.
    N_REPS = 10

    def chain(body):
        def fn(*args):
            def step(i, carry):
                return body(carry, i, *args)

            return jax.lax.fori_loop(0, N_REPS, step, jnp.zeros((), jnp.float32))

        f = jax.jit(fn)
        out = f(*args_holder)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args_holder))
        return (time.perf_counter() - t0) / N_REPS * 1e3

    args_holder = ()

    def stats_body(carry, i, pts, mask, origin):
        p = pts + carry * 1e-20 + i.astype(jnp.float32) * 0.0
        st = gaussian_map.stats_from_points(p, mask, origin, res, capacity)
        return st.sx[0, 0].astype(jnp.float32)

    args_holder = (pts, mask, origin)
    ms_stats = chain(stats_body)

    stats = jax.jit(gaussian_map.stats_from_points, static_argnames=("capacity",))(
        pts, mask, origin, res, capacity
    )

    def fin_body(carry, i, st_sx):
        st = stats._replace(sx=st_sx + carry * 1e-20)
        g = gaussian_map.finalize(st, 6)
        return g.mean[0, 0].astype(jnp.float32)

    args_holder = (stats.sx,)
    ms_fin = chain(fin_body)

    gmap = jax.jit(gaussian_map.finalize, static_argnames=("min_points_per_voxel",))(
        stats, 6
    )

    def reg_body(carry, i, mean):
        g = gmap._replace(mean=mean + carry * 1e-20)
        r = build_regmap(g, grid_shape=grid_shape)
        return r.packed[0, 0].astype(jnp.float32)

    args_holder = (gmap.mean,)
    ms_reg = chain(reg_body)
    rmap = build_regmap(gmap, grid_shape=grid_shape)
    total = ms_stats + ms_fin + ms_reg
    print(
        _record(
            {
                "metric": f"map+RegMap build (128k pts, capacity {capacity}, grid {grid_shape})",
                "value": round(total, 2),
                "unit": "ms/build",
                "detail": {
                    "stats_ms": round(ms_stats, 2),
                    "finalize_ms": round(ms_fin, 2),
                    "regmap_ms": round(ms_reg, 2),
                    "valid_voxels": int(gmap.num_valid()),
                    "regmap_overflow": int(rmap.overflow),
                },
            }
        )
    )


def bench_roofline():
    """Bandwidth accounting for one 128k-pt fused registration: measure the
    two hot streams — the (N, 96) mega-row gather and the fused pair-math
    eval — as achieved bytes/s, beside the whole registration's time.

    Method: chained fori_loop timing (each iteration's input depends on the
    previous output, so the device, not the dispatch, is timed).
    """
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3
    from slamtpu.mapping import gaussian_map
    from slamtpu.ndt import NewtonConfig, build_regmap, newton_align_fused
    from slamtpu.ndt.constants import gauss_constants
    from slamtpu.ndt.pallas_math import fused_objective, gather_megaT

    _, pts, mask, origin = _world()
    N = pts.shape[0]
    grid_shape = (192, 192, 48)
    gmap = jax.jit(
        gaussian_map.build_map,
        static_argnames=("capacity", "min_points_per_voxel"),
    )(pts, mask, origin, RESOLUTION,
      capacity=1 << 17, min_points_per_voxel=6)
    regmap = build_regmap(gmap, grid_shape=grid_shape)
    jax.block_until_ready(regmap.packed)

    n_iter = 50

    def chain_ms(body, *args):
        def fn(*a):
            def step(i, carry):
                return body(carry, i, *a)

            return jax.lax.fori_loop(0, n_iter, step, jnp.float32(0.0))

        f = jax.jit(fn)
        jax.block_until_ready(f(*args))
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        return (time.perf_counter() - t0) / n_iter * 1e3

    ident = se3.identity(dtype=jnp.float32)
    d1, d2, _ = gauss_constants(RESOLUTION, 0.55)

    # 1) the mega-row gather stream: voxel assignment (grid int32 lookup) +
    #    one (N, 96) f32 row gather. carry perturbs the points so
    #    iterations chain without changing the access-pattern statistics.
    def gather_body(carry, i, p):
        megaT = gather_megaT(p + carry * 1e-20, mask, ident, regmap, grid_shape)
        return megaT[0, 0]

    ms_gather = chain_ms(gather_body, pts)

    # 2) the fused kernel eval on pre-gathered rows: reads (96 + 3) * 4 B
    #    per point per eval, writes one 64-float partials row per block.
    megaT0 = gather_megaT(pts, mask, ident, regmap, grid_shape)
    megaT0 = jax.block_until_ready(jnp.asarray(megaT0))

    def kernel_body(carry, i, ptsT, megaT):
        pose = se3.retract(
            ident, jnp.zeros(6, jnp.float32).at[3].set(carry * 1e-20)
        )
        obj = fused_objective(ptsT, megaT, pose, d1, d2)
        return obj.score

    try:
        ms_kernel = chain_ms(kernel_body, pts.T.copy(), megaT0)
        kernel_err = None
    except Exception as e:
        ms_kernel = None
        kernel_err = str(e)

    # 3) whole registration at the headline operating point
    cfg = NewtonConfig(resolution=RESOLUTION, max_iterations=30, trans_eps=1e-4)
    _align = jax.jit(
        newton_align_fused, static_argnames=("cfg", "grid_shape", "inner_iters")
    )
    true_xi = jnp.asarray([0.004, -0.006, 0.02, 0.6, -0.4, 0.08], jnp.float32)
    src = se3.transform_points(se3.inverse(se3.expmap(true_xi)), pts)
    res = _align(src, mask, regmap, se3.identity(dtype=jnp.float32), cfg,
                 grid_shape, 10)
    jax.block_until_ready(res.pose.trans)
    t0 = time.perf_counter()
    for _ in range(20):
        res = _align(src, mask, regmap, se3.identity(dtype=jnp.float32), cfg,
                     grid_shape, 10)
    jax.block_until_ready(res.pose.trans)
    ms_reg = (time.perf_counter() - t0) / 20 * 1e3

    gather_bytes = N * (96 * 4 + 4 + 4)  # mega row + drow idx + grid cell
    kernel_bytes = N * (96 + 3) * 4
    detail = {
        "n_points": int(N),
        "gather_ms": round(ms_gather, 3),
        "gather_stream_mb": round(gather_bytes / 1e6, 1),
        "gather_gbs": round(gather_bytes / (ms_gather * 1e-3) / 1e9, 1),
        "kernel_ms": round(ms_kernel, 3) if ms_kernel else kernel_err,
        "kernel_stream_mb": round(kernel_bytes / 1e6, 1),
        "kernel_gbs": round(kernel_bytes / (ms_kernel * 1e-3) / 1e9, 1)
        if ms_kernel
        else None,
        "registration_ms": round(ms_reg, 3),
    }
    print(
        _record(
            {
                "metric": "roofline decomposition of one fused 128k-pt registration",
                "value": detail["gather_gbs"],
                "unit": "GB/s achieved on the mega-row gather stream",
                "detail": detail,
            }
        )
    )


def _world():
    import jax.numpy as jnp

    rng = np.random.default_rng(42)
    n_g = N_POINTS // 2
    ground = np.stack(
        [rng.uniform(0, 80, n_g), rng.uniform(0, 80, n_g), rng.normal(0, 0.04, n_g)], -1
    )
    n_w = N_POINTS // 4
    walls = np.stack(
        [rng.uniform(0, 80, n_w), rng.normal(40, 0.06, n_w), rng.uniform(0, 8, n_w)], -1
    )
    flip = rng.random(n_w) < 0.5
    walls[flip] = walls[flip][:, [1, 0, 2]]
    n_c = N_POINTS - n_g - n_w
    centers = rng.uniform(0, 80, size=(64, 3)) * np.array([1, 1, 0.1])
    clutter = centers[rng.integers(0, 64, n_c)] + rng.normal(0, 0.5, (n_c, 3))
    world = np.concatenate([ground, walls, clutter]).astype(np.float32)
    return world, jnp.asarray(world), jnp.ones(N_POINTS, bool), jnp.asarray(
        [-32.0, -32.0, -32.0], jnp.float32
    )


HEADLINE_GRID = (192, 192, 48)
HEADLINE_XI = (0.004, -0.006, 0.02, 0.6, -0.4, 0.08)  # 0.72 m offset


def headline_case():
    """The headline registration: a 128k-point structured world (ground +
    walls + clutter, ~80 m extent, the Berlin point count at 1 m voxels)
    mapped once; the source is the world resampled with sensor noise and
    offset by a realistic inter-scan motion. Returns (world, mask, regmap,
    src_body, gt, cfg, align) with ``align(src, mask, regmap, init, cfg)``."""
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3
    from slamtpu.mapping import gaussian_map
    from slamtpu.ndt import NewtonConfig, build_regmap, newton_align_fused

    world, pts, mask, origin = _world()
    rng = np.random.default_rng(43)
    gmap = jax.jit(
        gaussian_map.build_map, static_argnames=("capacity", "min_points_per_voxel")
    )(pts, mask, origin, RESOLUTION, capacity=MAP_CAPACITY)
    regmap = build_regmap(gmap, grid_shape=HEADLINE_GRID)
    jax.block_until_ready(regmap.packed)
    src = jnp.asarray(world + rng.normal(0, 0.01, world.shape).astype(np.float32))
    gt = se3.expmap(jnp.asarray(HEADLINE_XI, jnp.float32))
    src_body = se3.transform_points(se3.inverse(gt), src)
    cfg = NewtonConfig(
        resolution=RESOLUTION, max_iterations=MAX_ITERS, trans_eps=1e-4
    )
    # fused pair math; each gather reused for 10 Newton steps. Measured
    # accuracy ladder at this config (0.72 m initial offset): inner=6
    # 0.9 mm; inner=10 2.5 mm; inner=15 9.7 mm; inner=30 (single gather)
    # 55 mm -- at the accuracy gate. inner=10 keeps a 20x margin.
    _align = jax.jit(
        newton_align_fused, static_argnames=("cfg", "grid_shape", "inner_iters")
    )

    def align(src, msk, rmap, init, cfg):
        return _align(src, msk, rmap, init, cfg, HEADLINE_GRID, 10)

    return world, mask, regmap, src_body, gt, cfg, align


def registration_error(gt, pose):
    """(translation m, rotation rad) of ``pose`` against ``gt``."""
    from slamtpu.core import se3

    err = np.asarray(se3.local(gt, pose))
    return float(np.linalg.norm(err[3:])), float(np.linalg.norm(err[:3]))


def batch32_case(world, regmap, B: int = 32):
    """B noisy scans against the headline map in one dispatch
    (newton_align_fused_batch). Returns (align(), true xis)."""
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3
    from slamtpu.ndt import NewtonConfig, newton_align_fused_batch

    bpts, bmask, xis = _batch_scenario(world, B)
    init_b = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape),
        se3.identity(dtype=jnp.float32),
    )
    # 2 outer gathers (20 iters x inner 10): worst-case error ~40 mm, inside
    # the 50 mm gate (accuracy asserted per scan by check_batch32)
    bcfg = NewtonConfig(resolution=RESOLUTION, max_iterations=20, trans_eps=3e-4)
    balign = jax.jit(
        newton_align_fused_batch,
        static_argnames=("cfg", "grid_shape", "inner_iters"),
    )
    return (
        lambda: balign(bpts, bmask, regmap, init_b, bcfg, HEADLINE_GRID, 10),
        xis,
    )


def check_batch32(bres, xis):
    """Every scan of the batch within the headline's accuracy gate; returns
    the worst (translation m, rotation rad) error."""
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3

    worst = (0.0, 0.0)
    for b, xi in enumerate(xis):
        pose = jax.tree.map(lambda a: a[b], bres.pose)
        t, r = registration_error(se3.expmap(jnp.asarray(xi)), pose)
        assert t < 0.05 and r < 0.035, f"scan {b} inaccurate: {t} m, {r} rad"
        worst = (max(worst[0], t), max(worst[1], r))
    return worst


def bench_pair_math_ab(n_sweeps: int = 16):
    """The pair-math kernel against the plain XLA path, alternating in one
    process (kernel, xla, xla, kernel): one objective evaluation at
    N = 131072 (chained on the device), one headline registration, and one
    lo_svn keyframe at the Berlin operating point (a warm replay through
    ``run_replay``). The implementation is forced by replacing
    ``pallas_math.pair_math_impl``, with the jit caches cleared at each
    switch."""
    import contextlib
    import tempfile

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    import simulator

    from slamtpu.apps import LoSvnApp
    from slamtpu.apps.common import ate_rmse
    from slamtpu.core import se3
    from slamtpu.core.se3 import Pose3
    from slamtpu.ndt import pallas_math
    from slamtpu.ndt.constants import gauss_constants

    real_impl = pallas_math.pair_math_impl

    @contextlib.contextmanager
    def forced(impl):
        pallas_math.pair_math_impl = lambda platform=None: impl
        jax.clear_caches()
        try:
            yield
        finally:
            pallas_math.pair_math_impl = real_impl
            jax.clear_caches()

    world, mask, regmap, src_body, gt, cfg, align = headline_case()
    ident = se3.identity(dtype=jnp.float32)
    ptsT = src_body.T
    megaT = pallas_math.gather_megaT(src_body, mask, ident, regmap, HEADLINE_GRID)
    d1, d2, _ = gauss_constants(RESOLUTION, 0.55)
    n_chain = 50

    @jax.jit
    def objective_chain(ptsT, megaT):
        def step(_i, c):
            pose = se3.retract(ident, jnp.zeros(6, jnp.float32).at[3].set(c * 1e-20))
            return c + 1e-30 * pallas_math.fused_objective(
                ptsT, megaT, pose, d1, d2).score
        return jax.lax.fori_loop(0, n_chain, step, jnp.float32(0.0))

    lo_cfg = lo_berlin_config()
    tmp = tempfile.TemporaryDirectory()
    path = str(Path(tmp.name) / "berlin.rpl")
    gt_sweeps = simulator.simulate_replay(
        path, lo_cfg.meta, lo_cfg.lidar, n_sweeps=n_sweeps, skewed=True
    )
    gt_poses = [Pose3(jnp.asarray(R), jnp.asarray(p)) for R, p in gt_sweeps[1:]]

    out = {"kernel": [], "xla": []}
    for impl in ("kernel", "xla", "xla", "kernel"):
        with forced(impl):
            jax.block_until_ready(objective_chain(ptsT, megaT))
            t0 = time.perf_counter()
            jax.block_until_ready(objective_chain(ptsT, megaT))
            obj_ms = (time.perf_counter() - t0) / n_chain * 1e3

            res = align(src_body, mask, regmap, ident, cfg)
            trans_err, _rot = registration_error(gt, res.pose)
            t0 = time.perf_counter()
            for _ in range(20):
                res = align(src_body, mask, regmap, ident, cfg)
            jax.block_until_ready(res.pose.trans)
            reg_ms = (time.perf_counter() - t0) / 20 * 1e3

            LoSvnApp(lo_cfg).run_replay(path)  # compile
            app = LoSvnApp(lo_cfg)
            t0 = time.perf_counter()
            traj = app.run_replay(path)
            kf_ms = (time.perf_counter() - t0) / len(traj) * 1e3
            ate = ate_rmse(
                [se3.between(traj[0].pose, e.pose) for e in traj],
                [se3.between(gt_poses[0], g) for g in gt_poses[: len(traj)]],
            )
        out[impl].append({
            "objective_ms": obj_ms, "registration_ms": reg_ms,
            "registration_err_m": trans_err, "lo_svn_keyframe_ms": kf_ms,
            "lo_svn_ate_m": ate,
        })
        print(impl, out[impl][-1], flush=True)
    tmp.cleanup()
    print(
        _record(
            {
                "metric": "pair math: kernel vs plain XLA (objective at 128k "
                          "points, headline registration, lo_svn keyframe)",
                "value": min(r["lo_svn_keyframe_ms"] for r in out["kernel"]),
                "unit": "ms per lo_svn keyframe with the kernel",
                "detail": out,
            }
        )
    )


def main():
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3

    world, mask, regmap, src_body, gt, cfg, align = headline_case()
    res = align(src_body, mask, regmap, se3.identity(dtype=jnp.float32), cfg)
    jax.block_until_ready(res.pose.trans)
    trans_err, rot_err = registration_error(gt, res.pose)
    assert trans_err < 0.05 and rot_err < 0.035, (
        f"benchmark registration inaccurate: trans {trans_err}, rot {rot_err}"
    )

    # N>=5 independent repeats (each a 20-registration timed block): the
    # headline is the MEDIAN block rate, with the full sorted list recorded
    # so that a change can be judged against the measured spread.
    n_blocks, block_rep = 7, 20
    block_rates = []
    for _ in range(n_blocks):
        t0 = time.perf_counter()
        for _ in range(block_rep):
            res = align(src_body, mask, regmap, se3.identity(dtype=jnp.float32), cfg)
        jax.block_until_ready(res.pose.trans)
        block_rates.append(block_rep / (time.perf_counter() - t0))
    block_rates.sort()
    reg_per_s = block_rates[len(block_rates) // 2]
    dt = 1.0 / reg_per_s
    n_rep = block_rep  # companion variants below reuse the block size

    detail = {
        "iters": int(res.iterations),
        "trans_err_m": round(trans_err, 5),
        "rot_err_rad": round(rot_err, 5),
        "ms_per_registration": round(dt * 1e3, 3),
        "repeat_blocks": n_blocks,
        "regs_per_block": block_rep,
        "block_rates_reg_per_s": [round(r, 2) for r in block_rates],
        "spread_pct": round(
            100.0 * (block_rates[-1] - block_rates[0]) / block_rates[0], 1
        ),
    }

    # companion variants on the same map, folded into the one JSON line the
    # driver records: aggregate throughput with 32 scans/dispatch, and the
    # harder ~60%-overlap + out-of-map-clutter scan (accuracy asserted)
    try:
        B = 32
        balign, xis = batch32_case(world, regmap, B)
        bres = balign()
        check_batch32(bres, xis)
        t0 = time.perf_counter()
        for _ in range(8):
            bres = balign()
        jax.block_until_ready(bres.pose.trans)
        bdt = (time.perf_counter() - t0) / 8
        detail["batch32_reg_per_s"] = round(B / bdt, 2)
    except Exception as e:  # pragma: no cover - keep the headline alive
        detail["batch32_reg_per_s"] = f"failed: {e}"

    try:
        hsrc, _hfrac = _hard_scenario(world)
        hsrc_body = se3.transform_points(se3.inverse(gt), jnp.asarray(hsrc))
        hres = align(hsrc_body, mask, regmap, se3.identity(dtype=jnp.float32), cfg)
        jax.block_until_ready(hres.pose.trans)
        herr = np.asarray(se3.local(gt, hres.pose))
        assert np.linalg.norm(herr[3:]) < 0.05 and np.linalg.norm(herr[:3]) < 0.035
        t0 = time.perf_counter()
        for _ in range(n_rep):
            hres = align(hsrc_body, mask, regmap, se3.identity(dtype=jnp.float32), cfg)
        jax.block_until_ready(hres.pose.trans)
        hdt = (time.perf_counter() - t0) / n_rep
        detail["hard_overlap60_reg_per_s"] = round(1.0 / hdt, 2)
        detail["hard_overlap60_trans_err_m"] = round(
            float(np.linalg.norm(herr[3:])), 5
        )
    except Exception as e:  # pragma: no cover
        detail["hard_overlap60_reg_per_s"] = f"failed: {e}"

    print(
        _record(
            {
                "metric": "scan-to-map NDT registrations/sec (128k pts, 1.0 m voxels, DIRECT7, Newton<=30 iters)",
                "value": round(reg_per_s, 3),
                "unit": "registrations/s",
                "detail": detail,
            }
        )
    )


if __name__ == "__main__":
    _device()
    mode = sys.argv[sys.argv.index("--mode") + 1] if "--mode" in sys.argv else "ndt"
    if mode == "posegraph":
        bench_posegraph()
    elif mode == "lo100":
        bench_lo100()
    elif mode == "ligo":
        _app_bench("ligo")
    elif mode == "insmap":
        _app_bench("insmap")
    elif mode == "svn":
        bench_svn()
    elif mode == "map":
        bench_map()
    elif mode == "batch":
        bench_batch()
    elif mode == "lo_berlin":
        bench_lo_berlin()
    elif mode == "ligo_berlin":
        bench_ligo_berlin()
    elif mode == "pair_math_ab":
        bench_pair_math_ab()
    elif mode == "roofline":
        bench_roofline()
    elif mode == "ate_budget":
        bench_ate_budget()
    elif mode == "odom_berlin":
        bench_odom_berlin()
    elif mode == "hard":
        bench_hard_overlap()
    elif mode == "ingest":
        bench_ingest()
    else:
        main()
