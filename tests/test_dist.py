"""Multi-device sharding tests on the virtual 8-CPU mesh: the sharded map
build and psum-reduced Newton must match single-device results exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from slamtpu.core import se3
from slamtpu.dist import build_map_sharded, lo_train_step, make_mesh, newton_align_sharded
from slamtpu.mapping import gaussian_map
from slamtpu.ndt import NewtonConfig, newton_align

# heavy lane: whole-app replays / multi-device suites / subprocess spawns;
# excluded from the default fast lane (pytest.ini: -m "not slow")
pytestmark = pytest.mark.slow

RNG = np.random.default_rng(21)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices())


def make_world(n=4096):
    centers = RNG.uniform(0, 30, size=(32, 3))
    pts = centers[RNG.integers(0, 32, n)] + RNG.normal(0, 0.3, (n, 3))
    return jnp.asarray(pts), jnp.ones(n, bool)


class TestShardedMap:
    def test_matches_single_device(self, mesh):
        pts, mask = make_world()
        origin = jnp.asarray([-8.0, -8.0, -8.0])
        spts = jax.device_put(pts, NamedSharding(mesh, P("data")))
        smask = jax.device_put(mask, NamedSharding(mesh, P("data")))
        gmap_d = build_map_sharded(mesh, spts, smask, origin, 1.0, 4096)
        gmap_1 = gaussian_map.build_map(pts, mask, origin, 1.0, capacity=4096)
        np.testing.assert_array_equal(np.asarray(gmap_d.keys), np.asarray(gmap_1.keys))
        np.testing.assert_array_equal(np.asarray(gmap_d.count), np.asarray(gmap_1.count))
        np.testing.assert_array_equal(np.asarray(gmap_d.valid), np.asarray(gmap_1.valid))
        np.testing.assert_allclose(np.asarray(gmap_d.mean), np.asarray(gmap_1.mean), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(gmap_d.icov), np.asarray(gmap_1.icov), rtol=1e-9, atol=1e-9
        )


class TestShardedNewton:
    def test_matches_single_device(self, mesh):
        pts, mask = make_world()
        origin = jnp.asarray([-8.0, -8.0, -8.0])
        gmap = gaussian_map.build_map(pts, mask, origin, 1.0, capacity=4096)
        gt = se3.expmap(jnp.asarray([0.01, -0.02, 0.03, 0.2, -0.1, 0.05]))
        src = se3.transform_points(se3.inverse(gt), pts)
        ssrc = jax.device_put(src, NamedSharding(mesh, P("data")))
        smask = jax.device_put(mask, NamedSharding(mesh, P("data")))
        pose_d, hess_d, score_d, iters_d = newton_align_sharded(
            mesh, ssrc, smask, gmap, se3.identity(dtype=pts.dtype), max_iterations=20
        )
        res_1 = newton_align(
            src, mask, gmap, se3.identity(dtype=pts.dtype),
            NewtonConfig(resolution=1.0, max_iterations=20, max_step_norm=1.0),
        )
        err = np.asarray(se3.local(gt, se3.Pose3(pose_d.rot, pose_d.trans)))
        assert np.linalg.norm(err[3:]) < 0.05
        assert np.linalg.norm(err[:3]) < 0.035
        # distributed and single-device iterates agree (same math, psum'd)
        np.testing.assert_allclose(
            np.asarray(pose_d.trans), np.asarray(res_1.pose.trans), atol=1e-6
        )
        # psum reduction order differs from the single-device sum; after 20
        # Newton iterations the scores agree only to ~1e-5 relative
        np.testing.assert_allclose(float(score_d), float(res_1.score), rtol=1e-4)

    def test_lo_train_step_runs_and_grows_map(self, mesh):
        pts, mask = make_world(2048)
        origin = jnp.asarray([-8.0, -8.0, -8.0])
        stats = gaussian_map.stats_from_points(pts, mask, origin, jnp.asarray(1.0), 4096)
        new_pts, new_mask = make_world(2048)
        spts = jax.device_put(new_pts, NamedSharding(mesh, P("data")))
        smask = jax.device_put(new_mask, NamedSharding(mesh, P("data")))
        pose, hess, score, iters, new_stats = jax.jit(
            lambda p, m, st, g: lo_train_step(
                mesh, p, m, st, g, resolution=1.0, capacity=4096,
                grid_shape=(64, 64, 64), max_iterations=4, inner_iters=2,
                block=128,
            )
        )(spts, smask, stats, se3.identity(dtype=pts.dtype))
        assert np.isfinite(np.asarray(pose.trans)).all()
        assert int(jnp.sum(new_stats.n)) == int(jnp.sum(stats.n)) + int(jnp.sum(new_mask))


class TestGraftEntry:
    def test_entry_and_dryrun(self):
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        assert np.isfinite(np.asarray(out[0])).all()
        ge.dryrun_multichip(8)


class TestShardedNewtonReg:
    def test_matches_single_device_regmap(self, mesh):
        from slamtpu.ndt import build_regmap, newton_align_reg

        pts, mask = make_world()
        origin = jnp.asarray([-8.0, -8.0, -8.0])
        gmap = gaussian_map.build_map(pts, mask, origin, 1.0, capacity=4096)
        grid = (64, 64, 64)
        regmap = build_regmap(gmap, grid_shape=grid)
        gt = se3.expmap(jnp.asarray([0.01, -0.02, 0.03, 0.2, -0.1, 0.05]))
        src = se3.transform_points(se3.inverse(gt), pts)
        from slamtpu.dist import newton_align_sharded_reg

        ssrc = jax.device_put(src, NamedSharding(mesh, P("data")))
        smask = jax.device_put(mask, NamedSharding(mesh, P("data")))
        pose_d, hess_d, score_d, iters_d = newton_align_sharded_reg(
            mesh, ssrc, smask, regmap, se3.identity(dtype=pts.dtype), grid,
            max_iterations=20,
        )
        res_1 = newton_align_reg(
            src, mask, regmap, se3.identity(dtype=pts.dtype),
            NewtonConfig(resolution=1.0, max_iterations=20, max_step_norm=1.0), grid,
        )
        err = np.asarray(se3.local(gt, se3.Pose3(pose_d.rot, pose_d.trans)))
        assert np.linalg.norm(err[3:]) < 0.05
        np.testing.assert_allclose(
            np.asarray(pose_d.trans), np.asarray(res_1.pose.trans), atol=1e-6
        )


class TestShardedFused:
    def test_fused_sharded_matches_reg_path(self):
        """The fused-kernel sharded registration recovers the pose and
        matches the XLA reg path on the same inner_iters schedule."""
        import jax
        import jax.numpy as jnp

        from slamtpu.core import se3
        from slamtpu.dist import make_mesh, newton_align_sharded_fused
        from slamtpu.mapping import gaussian_map
        from slamtpu.ndt import build_regmap
        from slamtpu.ndt.pallas_math import newton_align_fused
        from slamtpu.ndt.newton import NewtonConfig

        rng = np.random.default_rng(11)
        N = 8 * 256  # 8 shards x 256 points; block=128
        centers = rng.uniform(2, 30, (24, 3)) * np.array([1, 1, 0.25])
        world = (centers[rng.integers(0, 24, N)] + rng.normal(0, 0.3, (N, 3))).astype(
            np.float32
        )
        pts = jnp.asarray(world)
        mask = jnp.ones(N, bool)
        origin = jnp.asarray([-8.0, -8.0, -8.0], jnp.float32)
        gmap = gaussian_map.build_map(pts, mask, origin, 1.0, capacity=4096,
                                      min_points_per_voxel=4)
        rm = build_regmap(gmap, grid_shape=(48, 48, 16))
        gt = se3.expmap(jnp.asarray([0.01, -0.008, 0.02, 0.25, -0.2, 0.05], jnp.float32))
        src = se3.transform_points(se3.inverse(gt), pts)

        mesh = make_mesh()
        pose, hess, score, iters = newton_align_sharded_fused(
            mesh, src, mask, rm, se3.identity(dtype=jnp.float32), (48, 48, 16),
            max_iterations=12, inner_iters=4, block=128, interpret=True,
        )
        err = np.asarray(se3.local(gt, pose))
        assert np.linalg.norm(err[3:]) < 0.03, err
        assert np.linalg.norm(err[:3]) < 0.02, err

        # single-device fused path, same schedule -> same result (up to
        # reduction-order float noise)
        cfg = NewtonConfig(resolution=1.0, max_iterations=12, trans_eps=1e-4)
        ref = newton_align_fused(
            src, mask, rm, se3.identity(dtype=jnp.float32), cfg, (48, 48, 16),
            inner_iters=4, block=128, interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(pose.trans), np.asarray(ref.pose.trans), atol=5e-3
        )
        # the sharded path re-evaluates (score, hess) at the RETURNED pose;
        # the single-chip fused path reports the pre-retract values — at the
        # slightly different final poses the scores agree only to ~0.5%
        np.testing.assert_allclose(float(score), float(ref.score), rtol=7e-3)


class TestSvnSharded:
    def _setup(self):
        rng = np.random.default_rng(5)
        N = 2048  # one fused block; points are REPLICATED (particles shard)
        centers = rng.uniform(2, 30, (24, 3)) * np.array([1, 1, 0.25])
        world = (
            centers[rng.integers(0, 24, N)] + rng.normal(0, 0.3, (N, 3))
        ).astype(np.float32)
        pts = jnp.asarray(world)
        mask = jnp.ones(N, bool)
        origin = jnp.asarray([-8.0, -8.0, -8.0], jnp.float32)
        gmap = gaussian_map.build_map(
            pts, mask, origin, 1.0, capacity=4096, min_points_per_voxel=4
        )
        from slamtpu.ndt import build_regmap

        rm = build_regmap(gmap, grid_shape=(48, 48, 16))
        gt = se3.expmap(
            jnp.asarray([0.01, -0.008, 0.02, 0.15, -0.1, 0.05], jnp.float32)
        )
        src = se3.transform_points(se3.inverse(gt), pts)
        return src, mask, rm, gt

    def test_matches_single_device(self):
        """Particle-axis sharding must reproduce the single-chip SVN flow:
        same init draw, same per-iteration updates (up to psum reduction
        order), same posterior mean/covariance and score."""
        from slamtpu.dist import make_mesh, svn_align_sharded
        from slamtpu.ndt import SvnConfig, svn_align_reg

        src, mask, rm, gt = self._setup()
        cfg = SvnConfig(
            resolution=1.0, num_particles=16, max_iterations=6,
            polish_iters=2, polish_from="prior", shared_gather=True,
        )
        key = jax.random.PRNGKey(3)
        prior = se3.retract(
            gt, jnp.asarray([0.004, -0.003, 0.002, 0.02, -0.01, 0.015], jnp.float32)
        )
        mesh = make_mesh()
        d = svn_align_sharded(mesh, src, mask, rm, prior, key, cfg, (48, 48, 16))
        s = svn_align_reg(src, mask, rm, prior, key, cfg, (48, 48, 16))
        np.testing.assert_allclose(
            np.asarray(d.pose.trans), np.asarray(s.pose.trans), atol=2e-4
        )
        np.testing.assert_allclose(
            np.asarray(d.pose.rot), np.asarray(s.pose.rot), atol=2e-4
        )
        assert int(d.iterations) == int(s.iterations)
        np.testing.assert_allclose(
            np.asarray(d.covariance), np.asarray(s.covariance),
            rtol=2e-2, atol=1e-7,
        )
        np.testing.assert_allclose(float(d.score), float(s.score), rtol=1e-3)
        # particle clouds agree particle-for-particle (same init slice order)
        np.testing.assert_allclose(
            np.asarray(d.particles.trans), np.asarray(s.particles.trans),
            atol=5e-4,
        )

    def test_collectives(self):
        """Per SVN iteration: one all_gather of particle poses (rot+trans),
        the stage-2 moments reduced+scattered, one 6-float psum for the
        mean; the posterior adds two psums. Stage 1 (the FLOPs) is
        communication-free."""
        from slamtpu.dist import make_mesh, svn_align_sharded
        from slamtpu.ndt import SvnConfig, build_regmap

        src, mask, rm, _gt = self._setup()
        cfg = SvnConfig(
            resolution=1.0, num_particles=16, max_iterations=4, polish_iters=2
        )
        mesh = make_mesh()
        jx = jax.make_jaxpr(
            lambda p, m, r, pr, k: svn_align_sharded(
                mesh, p, m, r, pr, k, cfg, (48, 48, 16)
            )
        )(src, mask, rm, se3.identity(dtype=jnp.float32), jax.random.PRNGKey(0))
        counts = TestCollectiveCounts._count(jx)
        assert counts.get("all_gather", 0) == 2, counts
        # psum_scatter lowers to reduce_scatter (phi + Ht)
        rs = counts.get("reduce_scatter", 0) + counts.get("psum_scatter", 0)
        assert rs == 2, counts
        # loop-body mean + posterior (tangent mean, covariance)
        assert counts.get("psum", 0) == 3, counts
        assert counts.get("ppermute", 0) == 0, counts
        assert counts.get("all_to_all", 0) == 0, counts


class TestBatchAlignSharded:
    def test_matches_unsharded_batch(self):
        """Data-parallel serving mode: B scans sharded over the mesh must
        reproduce the single-device vmapped batch exactly (no collectives —
        each scan is independent)."""
        from slamtpu.dist import batch_align_sharded, make_mesh
        from slamtpu.mapping import gaussian_map
        from slamtpu.ndt import NewtonConfig, build_regmap
        from slamtpu.ndt.pallas_math import newton_align_fused_batch

        rng = np.random.default_rng(5)
        N = 256
        centers = rng.uniform(2, 30, (24, 3)) * np.array([1, 1, 0.25])
        world = (centers[rng.integers(0, 24, N)] + rng.normal(0, 0.3, (N, 3))).astype(
            np.float32
        )
        pts = jnp.asarray(world)
        mask = jnp.ones(N, bool)
        origin = jnp.asarray([-8.0, -8.0, -8.0], jnp.float32)
        gmap = gaussian_map.build_map(
            pts, mask, origin, 1.0, capacity=4096, min_points_per_voxel=4
        )
        rm = build_regmap(gmap, grid_shape=(48, 48, 16))
        B = 8
        bpts = np.empty((B, N, 3), np.float32)
        gts = []
        for b in range(B):
            xi = jnp.asarray(
                np.array([0.01, -0.008, 0.02, 0.25, -0.2, 0.05], np.float32)
                * (0.5 + b / B)
            )
            gt = se3.expmap(xi)
            gts.append(gt)
            bpts[b] = np.asarray(se3.transform_points(se3.inverse(gt), pts))
        bpts = jnp.asarray(bpts)
        bmask = jnp.ones((B, N), bool)
        init_b = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (B,) + a.shape),
            se3.identity(dtype=jnp.float32),
        )
        cfg = NewtonConfig(resolution=1.0, max_iterations=24, trans_eps=1e-4)
        mesh = make_mesh()
        sh = batch_align_sharded(
            mesh, bpts, bmask, rm, init_b, cfg, (48, 48, 16), inner_iters=2,
            block=128, interpret=True,
        )
        ref = newton_align_fused_batch(
            bpts, bmask, rm, init_b, cfg, (48, 48, 16), inner_iters=2, block=128,
            interpret=True,
        )
        np.testing.assert_allclose(
            np.asarray(sh.pose.trans), np.asarray(ref.pose.trans), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(sh.pose.rot), np.asarray(ref.pose.rot), atol=1e-6
        )
        for b in range(B):
            err = np.asarray(
                se3.local(gts[b], jax.tree.map(lambda a: a[b], sh.pose))
            )
            assert np.linalg.norm(err[3:]) < 0.05, (b, err)


class TestCollectiveCounts:
    """Pin the per-step collective budget from the traced jaxpr — the
    driver-visible proof that the sharded paths communicate exactly as
    documented (SURVEY.md section 2.4: 'psum voxel stats', 'one 43-float
    psum per Newton step'). A regression that silently adds
    collectives (e.g. an accidental replication constraint) fails here."""

    NAMES = {
        "psum", "all_gather", "ppermute", "reduce_scatter", "psum_scatter",
        "all_to_all",
    }

    @staticmethod
    def _count(jx):
        from collections import Counter

        c = Counter()

        def walk(j):
            for eqn in j.eqns:
                if eqn.primitive.name in TestCollectiveCounts.NAMES:
                    c[eqn.primitive.name] += 1
                for v in eqn.params.values():
                    for sub in (v if isinstance(v, (list, tuple)) else [v]):
                        if hasattr(sub, "jaxpr"):
                            walk(sub.jaxpr)
                        elif hasattr(sub, "eqns"):
                            walk(sub)

        walk(jx.jaxpr)
        return dict(c)

    def _world(self, n=4096):
        rng = np.random.default_rng(0)
        pts = jnp.asarray(rng.uniform(0, 30, (n, 3)), jnp.float32)
        return pts, jnp.ones(n, bool), jnp.asarray([-8.0, -8.0, -8.0], jnp.float32)

    def test_lo_train_step_collectives(self):
        mesh = make_mesh()
        pts, mask, origin = self._world()
        stats = gaussian_map.stats_from_points(
            pts, mask, origin, jnp.asarray(2.0, jnp.float32), 1024
        )
        pose0 = se3.identity(dtype=jnp.float32)
        jx = jax.make_jaxpr(
            lambda p, m, st, g: lo_train_step(
                mesh, p, m, st, g, resolution=2.0, capacity=1024,
                grid_shape=(32, 32, 16), max_iterations=4, inner_iters=2,
                min_points_per_voxel=3, block=128,
            )
        )(pts, mask, stats, pose0)
        counts = self._count(jx)
        # 4 psums per objective evaluation (score, grad, hess, n_contrib) x
        # 2 evaluation sites (while-loop body + final eval at the solution);
        # the while-loop body counts ONCE regardless of iteration count
        assert counts.get("psum", 0) == 8, counts
        # folding the scan's stats into the map: one all_gather per stat
        # buffer (keys, n, sx, sxx, overflow)
        assert counts.get("all_gather", 0) == 5, counts
        assert counts.get("ppermute", 0) == 0, counts
        assert counts.get("all_to_all", 0) == 0, counts

    def test_batch_align_sharded_zero_collectives(self):
        """The data-parallel serving mode must be communication-free in
        steady state: batch axis sharded, map replicated, no cross-chip
        reductions at all."""
        from slamtpu.dist import batch_align_sharded
        from slamtpu.ndt import build_regmap

        mesh = make_mesh()
        pts, mask, origin = self._world()
        stats = gaussian_map.stats_from_points(
            pts, mask, origin, jnp.asarray(2.0, jnp.float32), 1024
        )
        gmap = gaussian_map.finalize(stats, 3)
        rmap = build_regmap(gmap, grid_shape=(32, 32, 16))
        B = len(jax.devices())
        bpts = jnp.broadcast_to(pts[None, :128], (B, 128, 3))
        bmask = jnp.ones((B, 128), bool)
        init_b = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (B,) + a.shape),
            se3.identity(dtype=jnp.float32),
        )
        jx = jax.make_jaxpr(
            lambda p, m, r, i: batch_align_sharded(
                mesh, p, m, r, i, NewtonConfig(resolution=2.0, max_iterations=2),
                (32, 32, 16), inner_iters=2, block=128,
            )
        )(bpts, bmask, rmap, init_b)
        counts = self._count(jx)
        assert counts == {}, counts

    def test_build_map_sharded_collectives(self):
        mesh = make_mesh()
        pts, mask, origin = self._world()
        jx = jax.make_jaxpr(
            lambda p, m: build_map_sharded(
                mesh, p, m, origin, 2.0, 1024, min_points_per_voxel=3
            )
        )(pts, mask)
        counts = self._count(jx)
        assert counts.get("all_gather", 0) == 5, counts
        assert counts.get("psum", 0) == 0, counts
