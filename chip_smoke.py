"""Smoke test of slamtpu's main path on NVIDIA GPUs.

    python chip_smoke.py          # one card: kernels, registration, apps
    python chip_smoke.py --four   # four cards: the sharded paths vs one card

Runs in one process that owns the card(s); only ``nvidia-smi`` runs as a
child. Prints the card's name and power limit, each phase's result, and as
its last line one JSON object ``{"ok": true, "device": {...}}``. A failed
phase raises and exits non-zero: nothing is caught and carried on. With no
GPU it exits non-zero before any phase.
"""
import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
KERNEL_NS = (131072, 65536)  # points per kernel parity check
# kernel vs plain XLA: float32 sums of ~10^6 pair terms, taken per block and
# then over blocks by the kernel but in XLA's own tree order by the
# reference, so each output may differ by its rounding (~1e-7 of its largest
# entry); 1e-4 leaves room for the few pairs whose gates flip on that noise.
REL_TOL = 1e-4
N_CONTRIB_TOL = 1e-4  # of N: pairs whose threshold test flips
ATE_BOUND_M = 0.01  # ten times lo_svn's last recorded ATE
N_SWEEPS = 16  # per app replay
FOUR_POINTS = 65536  # per scan on the four-card paths
FOUR_BATCH = 32


def _devices(n_cards):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found {devices[0].platform}"
        )
    if len(devices) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found {len(devices)}")
    return devices


def phase_device(device):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[device] {device.device_kind}; nvidia-smi: {smi}", flush=True)


def _close(name, got, ref, n):
    """Assert ``got`` matches the plain reference ``ref``; print the gap."""
    import numpy as np

    gaps = {}
    for field in ("score", "grad", "hess"):
        g = np.asarray(getattr(got, field), np.float64)
        r = np.asarray(getattr(ref, field), np.float64)
        gaps[field] = float(np.max(np.abs(g - r)) / np.max(np.abs(r)))
    dn = abs(int(got.n_contrib) - int(ref.n_contrib))
    print(
        f"[kernels] {name} N={n}: max|kernel-ref|/max|ref| "
        + " ".join(f"{k}={v:.2e}" for k, v in gaps.items())
        + f" (tol {REL_TOL:.0e}); n_contrib {int(got.n_contrib)} vs "
        f"{int(ref.n_contrib)} (tol {int(N_CONTRIB_TOL * n)}); float32, "
        "matmul precision highest",
        flush=True,
    )
    assert max(gaps.values()) <= REL_TOL, (name, n, gaps)
    assert dn <= N_CONTRIB_TOL * n, (name, n, dn)


def phase_kernels(bench):
    """Each kernel variant, compiled for the card at N = 131072 and 65536,
    against the plain XLA reference; then the registration step's HLO must
    hold the kernel as a Triton custom call."""
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3
    from slamtpu.mapping import gaussian_map
    from slamtpu.ndt import (build_regmap, gauss_constants, gicp_map,
        regularize_plane_covariance, score_grad_hess_gicp, score_grad_hess_reg)
    from slamtpu.ndt import pallas_math as pm
    from slamtpu.ndt.gicp import (score_grad_hess_gicp_aniso_gathered,
        source_point_covariances)
    from slamtpu.ndt.regmap import gather_pair_aux

    _world, pts, mask, origin = bench._world()
    grid = bench.HEADLINE_GRID
    gmap = gaussian_map.build_map(pts, mask, origin, bench.RESOLUTION,
                                  capacity=bench.MAP_CAPACITY)
    aux = jnp.concatenate(
        [gmap.mean, regularize_plane_covariance(gmap.cov).reshape(-1, 9)], 1
    )
    rmap = build_regmap(gmap, grid_shape=grid, aux_payload=aux)
    grmap = build_regmap(gicp_map(gmap), grid_shape=grid)
    src_cov = source_point_covariances(pts, mask, bench.RESOLUTION,
                                       capacity=1 << 14)
    d1, d2, _ = gauss_constants(bench.RESOLUTION, 0.55)
    corr2 = 25.0
    pose = se3.expmap(jnp.asarray([0.004, -0.006, 0.02, 0.3, -0.2, 0.04],
                                  jnp.float32))

    @jax.jit
    def kernels(p, m, scov):
        megaT = pm.gather_megaT(p, m, pose, rmap, grid)
        gmegaT = pm.gather_megaT(p, m, pose, grmap, grid)
        amegaT = pm.gather_megaT(p, m, pose, rmap, grid, table="aux")
        kw = dict(platform="gpu")
        return (
            pm.fused_objective(p.T, megaT, pose, d1, d2, **kw),
            pm.fused_objective(p.T, gmegaT, pose, 0.0, corr2, gicp=True, **kw),
            pm.fused_objective(p.T, amegaT, pose, 0.0, corr2,
                               src_covT=scov.reshape(-1, 9).T, **kw),
        )

    @jax.jit
    def references(p, m, scov):
        _tp, mu, cov_t, act = gather_pair_aux(p, m, pose, rmap, grid)
        return (
            score_grad_hess_reg(p, m, pose, rmap, d1, d2, grid),
            score_grad_hess_gicp(p, m, pose, grmap, grid),
            score_grad_hess_gicp_aniso_gathered(p, scov, pose, mu, cov_t, act),
        )

    for n in KERNEL_NS:
        stride = pts.shape[0] // n
        args = (pts[::stride][:n], mask[::stride][:n], src_cov[::stride][:n])
        for name, got, ref in zip(("ndt", "gicp", "aniso"), kernels(*args),
                                  references(*args)):
            _close(name, got, ref, n)

    # the registration step as the headline compiles it
    _w, mask_h, regmap_h, src_body, _gt, cfg, _align = bench.headline_case()
    compiled = jax.jit(
        pm.newton_align_fused, static_argnames=("cfg", "grid_shape", "inner_iters")
    ).lower(src_body, mask_h, regmap_h, se3.identity(dtype=jnp.float32), cfg,
            grid, 10).compile()
    print(f"[kernels] registration step memory_analysis: "
          f"{compiled.memory_analysis()}", flush=True)
    hlo = compiled.as_text()
    calls = [l for l in hlo.splitlines()
             if 'custom_call_target="__gpu$xla.gpu.triton"' in l]
    assert calls, "the pair math is not a Triton custom call in the compiled step"
    print(f"[kernels] registration step holds {len(calls)} Triton custom "
          f"call(s), e.g. {calls[0].strip()[:120]}", flush=True)


def phase_registration(bench):
    """The headline registration (128k points, 0.72 m offset) and the
    32-scan batch, with the benchmark's accuracy asserts."""
    import jax
    import jax.numpy as jnp

    from slamtpu.core import se3

    world, mask, regmap, src_body, gt, cfg, align = bench.headline_case()
    init = se3.identity(dtype=jnp.float32)
    res = align(src_body, mask, regmap, init, cfg)
    trans, rot = bench.registration_error(gt, res.pose)
    assert trans < 0.05 and rot < 0.035, (trans, rot)
    t0 = time.perf_counter()
    for _ in range(20):
        res = align(src_body, mask, regmap, init, cfg)
    jax.block_until_ready(res.pose.trans)
    ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"[registration] headline: error {trans:.5f} m / {rot:.6f} rad, "
          f"{int(res.iterations)} iterations, {ms:.3f} ms per registration",
          flush=True)

    balign, xis = bench.batch32_case(world, regmap)
    bres = balign()
    worst = bench.check_batch32(bres, xis)
    t0 = time.perf_counter()
    for _ in range(5):
        bres = balign()
    jax.block_until_ready(bres.pose.trans)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"[registration] batch of {len(xis)}: worst error {worst[0]:.5f} m "
          f"/ {worst[1]:.6f} rad, {ms:.2f} ms per dispatch", flush=True)


def phase_apps(bench, simulator):
    """lo_svn and odom_ndt replay a seeded Berlin-scale drive through
    ``run_replay``: a first instance compiles, a second one is timed."""
    import jax.numpy as jnp

    from slamtpu.apps import LoSvnApp, OdomNdtApp
    from slamtpu.apps.common import ate_rmse
    from slamtpu.core import se3
    from slamtpu.core.se3 import Pose3

    lo_cfg = bench.lo_berlin_config()
    odom_cfg = bench.odom_berlin_config()
    apps = (
        ("lo_svn", lambda: LoSvnApp(lo_cfg)),
        ("odom_ndt", lambda: OdomNdtApp(odom_cfg, window=6)),
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "berlin.rpl")
        gt = simulator.simulate_replay(
            path, lo_cfg.meta, lo_cfg.lidar, n_sweeps=N_SWEEPS, skewed=True
        )
        gt_poses = [Pose3(jnp.asarray(R), jnp.asarray(p)) for R, p in gt[1:]]
        for name, make in apps:
            make().run_replay(path)
            app = make()
            t0 = time.perf_counter()
            traj = app.run_replay(path)
            dt = time.perf_counter() - t0
            assert len(traj) >= 12, (name, len(traj))
            ate = ate_rmse(
                [se3.between(traj[0].pose, e.pose) for e in traj],
                [se3.between(gt_poses[0], g) for g in gt_poses[: len(traj)]],
            )
            print(f"[apps] {name}: {len(traj)} keyframes, "
                  f"{len(traj) / dt:.2f} keyframes/s, ATE {ate:.5f} m "
                  f"(bound {ATE_BOUND_M} m)", flush=True)
            assert ate <= ATE_BOUND_M, (name, ate)


def phase_four(bench, devices):
    """The sharded paths of ``slamtpu.dist`` on four cards, each against the
    same path on a one-card mesh: map build, psum-reduced Newton, batch
    serving over replicas, and particle-sharded SVN. Only the order of the
    cross-card sums differs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jax.sharding import NamedSharding, PartitionSpec as P

    from slamtpu.core import se3
    from slamtpu.dist import (batch_align_sharded, build_map_sharded,
        make_mesh, newton_align_sharded_fused, svn_align_sharded)
    from slamtpu.ndt import NewtonConfig, SvnConfig, build_regmap

    meshes = {1: make_mesh(devices[:1]), 4: make_mesh(devices)}
    world, pts, mask, origin = bench._world()
    stride = pts.shape[0] // FOUR_POINTS
    pts, mask, world = pts[::stride], mask[::stride], world[::stride]
    grid = bench.HEADLINE_GRID
    ident = se3.identity(dtype=jnp.float32)

    def on_both(fn, *args):
        """fn(mesh, *args) on the one-card and the four-card mesh, with the
        arguments replicated over that mesh's cards."""
        return {
            n: jax.block_until_ready(
                fn(mesh, *jax.device_put(args, NamedSharding(mesh, P())))
            )
            for n, mesh in meshes.items()
        }

    def report(name, poses, tol=1e-3):
        poses = jax.device_get(poses)
        d = np.asarray(se3.local(poses[1], poses[4])).reshape(-1, 6)
        gap_t = float(np.max(np.linalg.norm(d[:, 3:], axis=1)))
        gap_r = float(np.max(np.linalg.norm(d[:, :3], axis=1)))
        print(f"[four] {name}: 4-card vs 1-card pose gap {gap_t:.2e} m / "
              f"{gap_r:.2e} rad (tol {tol:.0e})", flush=True)
        assert gap_t <= tol and gap_r <= tol, (name, gap_t, gap_r)

    gmaps = on_both(lambda mesh, p, m, o: build_map_sharded(
        mesh, p, m, o, bench.RESOLUTION, bench.MAP_CAPACITY
    ), pts, mask, origin)
    assert np.array_equal(np.asarray(gmaps[4].keys), np.asarray(gmaps[1].keys))
    assert np.array_equal(np.asarray(gmaps[4].valid), np.asarray(gmaps[1].valid))
    mean_gap = float(np.max(np.abs(np.asarray(gmaps[4].mean)
                                   - np.asarray(gmaps[1].mean))))
    print(f"[four] map build: {int(gmaps[1].num_valid())} voxels, same keys, "
          f"max mean gap {mean_gap:.2e} m (tol 1e-4)", flush=True)
    assert mean_gap <= 1e-4

    rmap = build_regmap(gmaps[1], grid_shape=grid)
    gt = se3.expmap(jnp.asarray(bench.HEADLINE_XI, jnp.float32))
    src = se3.transform_points(se3.inverse(gt), pts)
    newton = on_both(lambda mesh, *a: newton_align_sharded_fused(
        mesh, *a, grid, max_iterations=30, inner_iters=10
    ), src, mask, rmap, ident)
    err = bench.registration_error(gt, jax.device_get(newton[4][0]))
    assert err[0] < 0.05 and err[1] < 0.035, err
    report("psum-reduced Newton", {n: r[0] for n, r in newton.items()})

    bpts, bmask, _xis = bench._batch_scenario(np.asarray(world), FOUR_BATCH)
    init_b = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (FOUR_BATCH,) + a.shape), ident
    )
    bcfg = NewtonConfig(resolution=bench.RESOLUTION, max_iterations=20,
                        trans_eps=3e-4)
    batch = on_both(lambda mesh, *a: batch_align_sharded(
        mesh, *a, bcfg, grid, inner_iters=10
    ), bpts, bmask, rmap, init_b)
    report(f"batch of {FOUR_BATCH} over replicas",
           {n: r.pose for n, r in batch.items()})

    svn_cfg = SvnConfig(resolution=bench.RESOLUTION, num_particles=20,
                        max_iterations=8, polish_iters=4, polish_from="prior")
    prior = se3.retract(gt, jnp.asarray([0.004, -0.003, 0.002, 0.02, -0.01,
                                         0.015], jnp.float32))
    key = jax.random.PRNGKey(3)
    svn = on_both(lambda mesh, *a: svn_align_sharded(
        mesh, *a, svn_cfg, grid
    ), src, mask, rmap, prior, key)
    report("particle-sharded SVN", {n: r.pose for n, r in svn.items()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import bench  # the benchmark's worlds, Berlin configurations and checks
    import simulator  # seeded sensor simulator (tests/simulator.py)

    devices = _devices(4 if args.four else 1)
    phase_device(devices[0])
    if args.four:
        phase_four(bench, devices[:4])
    else:
        phase_kernels(bench)
        phase_registration(bench)
        phase_apps(bench, simulator)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))


if __name__ == "__main__":
    main()
