"""NDT objective / Newton / SVN tests.

- Score + gradient + GN-Hessian parity against the float64 numpy oracle
  (same semantics as the reference hot loop, svn_ndt_impl.hpp:400-668).
- Gradient consistency against jax.grad of the score (the internal-consistency
  property the reference lacks).
- Convergence gates from the reference test
  (/root/reference/extern/svn_ndt/test/test_svn_ndt.cpp:94-96): translation
  error < 0.05 m, rotation error < 0.035 rad on the synthetic two-plane cloud
  with 2 cm noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slamtpu.core import se3, so3
from slamtpu.mapping import gaussian_map
from slamtpu.ndt import (
    NewtonConfig,
    SvnConfig,
    full_hessian,
    gauss_constants,
    newton_align,
    score_grad_hess,
    score_only,
    svn_align,
)
from tests.oracles import oracle_build_map, oracle_gauss_constants, oracle_ndt, two_plane_cloud

RNG = np.random.default_rng(1337)
RES = 1.0
OUTLIER = 0.55


@pytest.fixture(scope="module")
def fixture():
    """Target = gt-transformed two-plane cloud + 2 cm noise; aligning the
    untransformed source against it must recover gt (as the reference test
    does, test_svn_ndt.cpp:44-131)."""
    base = two_plane_cloud(extent=8.0, pitch=0.15)
    R, t = gt_pose()
    target = base @ R.T + t
    target += RNG.normal(scale=0.02, size=target.shape)
    mask_t = np.ones(len(target), bool)
    origin = np.floor(target.min(0)) - 8.0
    gmap = jax.jit(
        gaussian_map.build_map, static_argnames=("capacity", "min_points_per_voxel")
    )(jnp.asarray(target), jnp.asarray(mask_t), jnp.asarray(origin), RES, capacity=2048)
    omap = oracle_build_map(target, mask_t, origin, RES)
    source = two_plane_cloud(extent=8.0, pitch=0.3)
    mask_s = np.ones(len(source), bool)
    return target, origin, gmap, omap, source, mask_s


def gt_pose():
    """yaw 15 deg, pitch 5 deg, t = [0.5, 0, 0.3] like the reference test."""
    rpy = np.array([0.0, np.deg2rad(5.0), np.deg2rad(15.0)])
    return np.asarray(so3.rpy_to_rot(jnp.asarray(rpy))), np.array([0.5, 0.0, 0.3])


class TestConstants:
    def test_match_oracle(self):
        d1, d2, d3 = gauss_constants(RES, OUTLIER)
        o1, o2, o3 = oracle_gauss_constants(RES, OUTLIER)
        assert abs(d1 - o1) < 1e-12 and abs(d2 - o2) < 1e-12 and abs(d3 - o3) < 1e-12
        assert d1 < 0 and d2 > 0


class TestObjective:
    def test_score_grad_hess_parity(self, fixture):
        _, origin, gmap, omap, source, mask_s = fixture
        d1, d2, _ = gauss_constants(RES, OUTLIER)
        R, t = gt_pose()
        # Perturbed pose so neighbors straddle voxel boundaries
        pose = se3.retract(
            se3.Pose3(jnp.asarray(R), jnp.asarray(t)),
            jnp.asarray([0.02, -0.01, 0.03, 0.1, -0.05, 0.08]),
        )
        obj = jax.jit(score_grad_hess)(
            jnp.asarray(source), jnp.asarray(mask_s), pose, gmap, d1, d2
        )
        Rn, tn = np.asarray(pose.rot), np.asarray(pose.trans)
        s_o, g_o, H_o = oracle_ndt(source, mask_s, Rn, tn, omap, origin, RES, d1, d2)
        assert s_o != 0.0
        np.testing.assert_allclose(float(obj.score), s_o, rtol=1e-9)
        np.testing.assert_allclose(np.asarray(obj.grad), g_o, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(np.asarray(obj.hess), H_o, rtol=1e-8, atol=1e-12)

    def test_grad_matches_autodiff(self, fixture):
        _, _, gmap, _, source, mask_s = fixture
        d1, d2, _ = gauss_constants(RES, OUTLIER)
        R, t = gt_pose()
        pose = se3.Pose3(jnp.asarray(R), jnp.asarray(t))
        pts = jnp.asarray(source)
        msk = jnp.asarray(mask_s)
        obj = score_grad_hess(pts, msk, pose, gmap, d1, d2)
        ad_grad, ad_hess = jax.jit(full_hessian)(pts, msk, pose, gmap, d1, d2)
        np.testing.assert_allclose(np.asarray(obj.grad), np.asarray(ad_grad), rtol=1e-7, atol=1e-10)
        # GN Hessian approximates the exact Hessian near the optimum only;
        # here just check shapes/symmetry and that AD hessian is finite.
        assert np.isfinite(np.asarray(ad_hess)).all()
        np.testing.assert_allclose(np.asarray(obj.hess), np.asarray(obj.hess).T, atol=1e-10)

    def test_score_invariance_to_padding(self, fixture):
        _, _, gmap, _, source, mask_s = fixture
        d1, d2, _ = gauss_constants(RES, OUTLIER)
        R, t = gt_pose()
        pose = se3.Pose3(jnp.asarray(R), jnp.asarray(t))
        s1 = score_only(jnp.asarray(source), jnp.asarray(mask_s), pose, gmap, d1, d2)
        padded = np.concatenate([source, np.full((37, 3), 1e9)])
        pmask = np.concatenate([mask_s, np.zeros(37, bool)])
        s2 = score_only(jnp.asarray(padded), jnp.asarray(pmask), pose, gmap, d1, d2)
        np.testing.assert_allclose(float(s1), float(s2), rtol=1e-12)


class TestNewton:
    def test_converges_on_two_planes(self, fixture):
        _, _, gmap, _, source, mask_s = fixture
        R, t = gt_pose()
        gt = se3.Pose3(jnp.asarray(R), jnp.asarray(t))
        # init = gt perturbed (the registration must recover the perturbation)
        init = se3.retract(gt, jnp.asarray([0.02, -0.03, 0.05, 0.2, -0.15, 0.1]))
        # trans_eps 5e-3: the two-plane fixture leaves translation along the
        # plane-intersection line unconstrained, so steps along that gauge
        # direction shrink slowly (the reference's pclomp gate behaves the
        # same way; its hasConverged() is true on any loop exit).
        cfg = NewtonConfig(
            resolution=RES, outlier_ratio=OUTLIER, max_iterations=50, trans_eps=5e-3
        )
        res = jax.jit(newton_align, static_argnames=("cfg",))(
            jnp.asarray(source), jnp.asarray(mask_s), gmap, init, cfg
        )
        err = np.asarray(se3.local(gt, res.pose))
        rot_err = np.linalg.norm(err[:3])
        trans_err = np.linalg.norm(err[3:])
        assert bool(res.converged), f"not converged in {int(res.iterations)} iters"
        assert int(res.iterations) < 50
        assert trans_err < 0.05, trans_err
        assert rot_err < 0.035, rot_err
        # Hessian usable for covariance: -(H)^-1 PSD-ish
        cov = -np.linalg.inv(np.asarray(res.hessian))
        assert np.isfinite(cov).all()


class TestNonFinitePoints:
    def test_nan_point_does_not_poison_gradient(self, fixture):
        """A single NaN coordinate must neither poison the gradient
        (0 * NaN = NaN survives masking in einsum reductions) nor change the
        result vs dropping the point from the mask."""
        from slamtpu.ndt import build_regmap, score_grad_hess_reg
        from slamtpu.ndt.objective import score_grad_hess as sgh

        _, _, gmap, _, source, mask_s = fixture
        d1, d2, _ = gauss_constants(RES, OUTLIER)
        pose = se3.identity(dtype=jnp.float64)
        bad = np.array(source, np.float64)
        bad[7] = np.nan
        bad[23, 1] = np.inf
        clean_mask = np.array(mask_s)
        clean_mask[[7, 23]] = False

        ref = sgh(jnp.asarray(source), jnp.asarray(clean_mask), pose, gmap, d1, d2)
        got = sgh(jnp.asarray(bad), jnp.asarray(mask_s), pose, gmap, d1, d2)
        assert np.isfinite(np.asarray(got.grad)).all()
        assert np.isfinite(np.asarray(got.hess)).all()
        np.testing.assert_allclose(np.asarray(got.grad), np.asarray(ref.grad), atol=1e-9)
        np.testing.assert_allclose(float(got.score), float(ref.score), atol=1e-9)

        regmap = build_regmap(gmap, grid_shape=(64, 64, 32))
        got_r = score_grad_hess_reg(
            jnp.asarray(bad), jnp.asarray(mask_s), pose, regmap, d1, d2, (64, 64, 32)
        )
        assert np.isfinite(np.asarray(got_r.grad)).all()
        np.testing.assert_allclose(
            np.asarray(got_r.grad), np.asarray(ref.grad), atol=1e-6
        )

    def test_fused_kernel_nan_point(self, fixture):
        from slamtpu.ndt import build_regmap
        from slamtpu.ndt.pallas_math import BLOCK, score_grad_hess_fused

        _, _, gmap, _, source, mask_s = fixture
        d1, d2, _ = gauss_constants(RES, OUTLIER)
        n = len(source)
        n_pad = -(-n // BLOCK) * BLOCK
        pts = np.zeros((n_pad, 3), np.float32)
        pts[:n] = source
        pts[5] = np.nan
        mask = np.zeros(n_pad, bool)
        mask[:n] = True
        regmap = build_regmap(gmap, grid_shape=(64, 64, 32))
        regmap32 = jax.tree.map(
            lambda x: x.astype(jnp.float32) if x.dtype == jnp.float64 else x, regmap
        )
        obj = score_grad_hess_fused(
            jnp.asarray(pts), jnp.asarray(mask), se3.identity(dtype=jnp.float32),
            regmap32, d1, d2, (64, 64, 32), block=128, interpret=True,
        )
        assert np.isfinite(float(obj.score))
        assert np.isfinite(np.asarray(obj.grad)).all()
        assert np.isfinite(np.asarray(obj.hess)).all()


class TestPoseRegularization:
    """Prior-pose penalty (the ndt_omp setRegularizationPose analog). The
    score is MAXIMIZED (H negative definite), so the penalty must SUBTRACT
    from grad/hess — the flipped sign provably repels (caught in review)."""

    def test_toy_quadratic_map_blend(self):
        """Data optimum t*=1 (curvature 4), prior 0, w=1 -> MAP = 4/5."""
        from slamtpu.ndt.newton import regularize_step

        cfg = NewtonConfig(reg_weight=1.0)
        reg_pose = se3.identity(dtype=jnp.float64)
        t = 0.3  # arbitrary linearization point along x
        pose = se3.retract(reg_pose, jnp.asarray([0, 0, 0, t, 0, 0.0]))
        # maximized data objective -2 (tx - 1)^2: grad = -4 (t-1), hess = -4 I
        g = jnp.zeros(6, jnp.float64).at[3].set(-4.0 * (t - 1.0))
        H = -4.0 * jnp.eye(6, dtype=jnp.float64)
        g2, H2 = regularize_step(pose, g, H, jnp.asarray(1), cfg, reg_pose)
        step = jnp.linalg.solve(H2, -g2)
        t_new = t + float(step[3])
        assert t_new == pytest.approx(4.0 / 5.0, abs=1e-9)
        # the augmented system must stay definite (negative) for any w
        assert float(jnp.linalg.eigvalsh(H2).max()) < 0.0

    def test_registration_pulls_toward_prior(self, fixture):
        """With a deliberately wrong prior, the regularized optimum lies
        between the data optimum and the prior, monotonically approaching
        the prior as the weight grows."""
        _, _, gmap, _, source, mask_s = fixture
        R, t = gt_pose()
        gt = se3.Pose3(jnp.asarray(R), jnp.asarray(t))
        init = se3.retract(gt, jnp.asarray([0.0, 0.0, 0.0, 0.05, 0.0, 0.0]))
        wrong_prior = se3.retract(gt, jnp.asarray([0.0, 0.0, 0.0, 0.6, 0.0, 0.0]))
        dists = []
        for w in (0.0, 2.0, 1e6):
            cfg = NewtonConfig(
                resolution=RES, outlier_ratio=OUTLIER, max_iterations=50,
                trans_eps=1e-4, reg_weight=w,
            )
            res = jax.jit(newton_align, static_argnames=("cfg",))(
                jnp.asarray(source), jnp.asarray(mask_s), gmap, init, cfg,
                reg_pose=wrong_prior,
            )
            dists.append(float(jnp.linalg.norm(
                se3.local(wrong_prior, res.pose)
            )))
        # unregularized sits at the data optimum (farthest from the wrong
        # prior); moderate weight moves strictly toward it; huge weight pins
        assert dists[1] < dists[0], dists
        assert dists[2] < 1e-2, dists
        assert np.isfinite(dists).all()


class TestSVN:
    def test_svn_k10_converges(self, fixture):
        _, _, gmap, _, source, mask_s = fixture
        R, t = gt_pose()
        gt = se3.Pose3(jnp.asarray(R), jnp.asarray(t))
        init = se3.retract(gt, jnp.asarray([0.01, -0.02, 0.03, 0.15, -0.1, 0.08]))
        cfg = SvnConfig(
            resolution=RES,
            outlier_ratio=OUTLIER,
            num_particles=10,
            max_iterations=60,
            kernel_h=1.0,
            step_size=1.0,
            stop_thresh=1e-4,
        )
        res = jax.jit(svn_align, static_argnames=("cfg",))(
            jnp.asarray(source),
            jnp.asarray(mask_s),
            gmap,
            init,
            jax.random.PRNGKey(1337),
            cfg,
        )
        err = np.asarray(se3.local(gt, res.pose))
        assert np.linalg.norm(err[3:]) < 0.05, err
        assert np.linalg.norm(err[:3]) < 0.035, err
        cov = np.asarray(res.covariance)
        ev = np.linalg.eigvalsh(cov)
        assert ev.min() >= 1e-9 * (1 - 1e-6)
        np.testing.assert_allclose(cov, cov.T, atol=1e-12)

    def test_svn_polish_lands_on_newton_mode(self, fixture):
        """polish_iters publishes the MAP: the polished mean must land on the
        Newton optimum of the same objective (the mode), far closer to it
        than the raw particle mean, whose Stein-repulsion spread keeps it a
        posterior-mean estimate. (On this 2 cm-noise fixture the mode is not
        necessarily closer to ground truth — the property under test is
        mode-seeking, not accuracy.)"""
        _, _, gmap, _, source, mask_s = fixture
        R, t = gt_pose()
        gt = se3.Pose3(jnp.asarray(R), jnp.asarray(t))
        init = se3.retract(gt, jnp.asarray([0.01, -0.02, 0.03, 0.15, -0.1, 0.08]))
        base = dict(
            resolution=RES, outlier_ratio=OUTLIER, num_particles=10,
            max_iterations=60, kernel_h=1.0, step_size=1.0, stop_thresh=1e-4,
        )
        key = jax.random.PRNGKey(1337)
        res_raw = jax.jit(svn_align, static_argnames=("cfg",))(
            jnp.asarray(source), jnp.asarray(mask_s), gmap, init, key,
            SvnConfig(**base),
        )
        res_pol = jax.jit(svn_align, static_argnames=("cfg",))(
            jnp.asarray(source), jnp.asarray(mask_s), gmap, init, key,
            SvnConfig(**base, polish_iters=3, polish_from="mean"),
        )
        newton_res = jax.jit(newton_align, static_argnames=("cfg",))(
            jnp.asarray(source), jnp.asarray(mask_s), gmap, init,
            NewtonConfig(
                resolution=RES, outlier_ratio=OUTLIER, max_iterations=50,
                trans_eps=1e-6,
            ),
        )
        d_raw = float(jnp.linalg.norm(se3.local(newton_res.pose, res_raw.pose)))
        d_pol = float(jnp.linalg.norm(se3.local(newton_res.pose, res_pol.pose)))
        # the two-plane valley is shallow (Newton itself needs ~50 iters
        # here), so assert strict mode-seeking progress, not full arrival
        assert d_pol < 0.5 * d_raw, (d_pol, d_raw)
        assert d_pol < 0.03, (d_pol, d_raw)
        # covariance still comes from the particle spread, not the polish —
        # same scale per dof (the base point of the tangent moved ~0.1, so
        # entries shift at second order; the SPREAD must not collapse)
        d_pol_var = np.diag(np.asarray(res_pol.covariance))
        d_raw_var = np.diag(np.asarray(res_raw.covariance))
        ratio = d_pol_var / np.maximum(d_raw_var, 1e-12)
        assert np.all((ratio > 0.3) & (ratio < 3.0)), ratio
