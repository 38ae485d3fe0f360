"""The pair-math kernel (Triton route, run here in the Pallas interpreter)
against the plain XLA references, its padding and sentinel rules, its
batching, and the one function that chooses the implementation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slamtpu.core import se3
from slamtpu.mapping import gaussian_map
from slamtpu.ndt import (build_regmap, gauss_constants, gicp_map,
    regularize_plane_covariance, score_grad_hess_gicp, score_grad_hess_reg)
from slamtpu.ndt import pallas_math as pm
from slamtpu.ndt.gicp import (score_grad_hess_gicp_aniso_gathered,
    source_point_covariances)
from slamtpu.ndt.regmap import gather_pair_aux

RES = 1.0
GRID = (32, 32, 8)
N = 300  # not a multiple of any block: the wrapper pads
D1, D2, _ = gauss_constants(RES, 0.55)
CORR2 = 25.0  # max_corr_dist^2 of the GICP modes (5 m, the default gate)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(8)
    tgt = np.concatenate([
        rng.normal(0, 0.3, (600, 3)) + [1.5, 1.5, 0.5],
        rng.normal(0, 0.3, (600, 3)) + [3.5, 2.5, 1.0],
        np.stack([rng.uniform(0, 5, 600), rng.uniform(0, 4, 600),
                  rng.normal(0, 0.03, 600)], -1),
    ])
    gmap = gaussian_map.build_map(
        jnp.asarray(tgt, jnp.float32), jnp.ones(len(tgt), bool),
        jnp.asarray([-8.0, -8.0, -8.0], jnp.float32), RES,
        capacity=512, min_points_per_voxel=4,
    )
    cov_r = regularize_plane_covariance(gmap.cov)
    aux = jnp.concatenate([gmap.mean, cov_r.reshape(-1, 9)], axis=1)
    rmap = build_regmap(gmap, grid_shape=GRID, aux_payload=aux)
    grmap = build_regmap(gicp_map(gmap, 0.05), grid_shape=GRID)
    pts = jnp.asarray(
        tgt[rng.choice(len(tgt), N, replace=False)] + rng.normal(0, 0.02, (N, 3)),
        jnp.float32,
    )
    mask = jnp.asarray(rng.random(N) < 0.9)
    scov = source_point_covariances(
        pts, mask, RES, capacity=256, min_points_per_voxel=4
    ).astype(jnp.float32)
    pose = se3.retract(
        se3.identity(dtype=jnp.float32),
        jnp.asarray([0.02, -0.01, 0.05, 0.1, -0.08, 0.04], jnp.float32),
    )
    return dict(rmap=rmap, grmap=grmap, pts=pts, mask=mask, scov=scov, pose=pose)


def _kernel(w, variant, block, pts=None, mask=None, pose=None, interpret=True):
    """The kernel's objective for one variant; rows masked out by ``mask``
    gather the sentinel row."""
    pts = w["pts"] if pts is None else pts
    mask = w["mask"] if mask is None else mask
    pose = w["pose"] if pose is None else pose
    if variant == "ndt":
        megaT = pm.gather_megaT(pts, mask, pose, w["rmap"], GRID)
        return pm.fused_objective(pts.T, megaT, pose, D1, D2, block=block,
                                  interpret=interpret)
    if variant == "gicp":
        megaT = pm.gather_megaT(pts, mask, pose, w["grmap"], GRID)
        return pm.fused_objective(pts.T, megaT, pose, 0.0, CORR2, gicp=True,
                                  block=block, interpret=interpret)
    megaT = pm.gather_megaT(pts, mask, pose, w["rmap"], GRID, table="aux")
    scovT = w["scov"][: pts.shape[0]].reshape(-1, 9).T
    return pm.fused_objective(pts.T, megaT, pose, 0.0, CORR2, src_covT=scovT,
                              block=block, interpret=interpret)


def _reference(w, variant):
    """The plain XLA objective, independent of the mega-row transpose."""
    pts, mask, pose = w["pts"], w["mask"], w["pose"]
    if variant == "ndt":
        return score_grad_hess_reg(pts, mask, pose, w["rmap"], D1, D2, GRID)
    if variant == "gicp":
        return score_grad_hess_gicp(pts, mask, pose, w["grmap"], GRID)
    _tp, mu, cov_t, act = gather_pair_aux(pts, mask, pose, w["rmap"], GRID)
    return score_grad_hess_gicp_aniso_gathered(
        pts, w["scov"], pose, mu, cov_t, act
    )


def _assert_close(got, ref, rtol=1e-4):
    """float32 sums of a few thousand pair terms taken in another order:
    agreement to 1e-4 of each output's largest entry."""
    assert int(got.n_contrib) == int(ref.n_contrib)
    for field in ("score", "grad", "hess"):
        g = np.asarray(getattr(got, field), np.float64)
        r = np.asarray(getattr(ref, field), np.float64)
        np.testing.assert_allclose(g, r, rtol=0, atol=rtol * np.max(np.abs(r)))


VARIANTS = ("ndt", "gicp", "aniso")


@pytest.mark.parametrize("block", (64, 128))
@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_matches_plain_reference(world, variant, block):
    ref = _reference(world, variant)
    assert int(ref.n_contrib) > 100  # the case exercises real pairs
    _assert_close(_kernel(world, variant, block), ref)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cpu_default_is_the_plain_path(world, variant):
    """Without ``interpret`` the CPU takes the XLA path, and it agrees."""
    got = _kernel(world, variant, None, interpret=False)
    _assert_close(got, _reference(world, variant))
    megaT = pm.gather_megaT(world["pts"], world["mask"], world["pose"],
                            world["rmap"], GRID)
    jaxpr = jax.make_jaxpr(
        lambda p, m: pm.fused_objective(p, m, world["pose"], D1, D2)
    )(world["pts"].T, megaT)
    assert "pallas_call" not in str(jaxpr)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sentinel_and_padding_rows_contribute_nothing(world, variant):
    """Masked points gather the all-zero sentinel row; the wrapper's block
    padding uses the same zeros. Neither may change any output."""
    pts, mask = world["pts"], world["mask"]
    n_keep = 200
    keep = _kernel(world, variant, 64, pts=pts[:n_keep], mask=mask[:n_keep])
    # the same points followed by masked-out ones (sentinel rows) whose
    # coordinates are far from the map
    junk = jnp.full((N - n_keep, 3), 3.0e3, jnp.float32)
    mixed_pts = jnp.concatenate([pts[:n_keep], junk])
    mixed_mask = jnp.concatenate([mask[:n_keep], jnp.zeros(N - n_keep, bool)])
    w = dict(world, scov=jnp.concatenate(
        [world["scov"][:n_keep], jnp.zeros((N - n_keep, 3, 3), jnp.float32)]))
    mixed = _kernel(w, variant, 64, pts=mixed_pts, mask=mixed_mask)
    # sentinel rows touch only the padded sums' zero terms, so the match is
    # exact up to the reordering of the per-block partial sums
    _assert_close(mixed, keep, rtol=1e-5)
    # a block size that divides n_keep (no padding) gives the same answer
    whole = _kernel(world, variant, 8, pts=pts[:n_keep], mask=mask[:n_keep])
    _assert_close(whole, keep, rtol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_vmap_over_poses_equals_unbatched(world, variant):
    """SVN vmaps the kernel over K particle poses with shared mega rows;
    each batched result must equal the unbatched call."""
    xis = jnp.asarray(np.random.default_rng(2).normal(0, 0.02, (3, 6)),
                      jnp.float32)
    poses = jax.vmap(lambda xi: se3.retract(world["pose"], xi))(xis)
    pts, mask = world["pts"], world["mask"]
    table = "aux" if variant == "aniso" else "packed"
    rmap = world["grmap"] if variant == "gicp" else world["rmap"]
    megaT = pm.gather_megaT(pts, mask, world["pose"], rmap, GRID, table=table)
    kw = dict(block=64, interpret=True)
    if variant == "ndt":
        args = (D1, D2)
    else:
        args = (0.0, CORR2)
        kw.update(gicp=variant == "gicp")
        if variant == "aniso":
            kw.update(src_covT=world["scov"].reshape(-1, 9).T)
    batched = jax.vmap(
        lambda p: pm.fused_objective(pts.T, megaT, p, *args, **kw)
    )(poses)
    for k in range(3):
        single = pm.fused_objective(
            pts.T, megaT, jax.tree.map(lambda a: a[k], poses), *args, **kw
        )
        for field in single._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(batched, field)[k]),
                np.asarray(getattr(single, field)),
            )


def test_kernel_names_the_triton_route(world):
    """The pallas_call carries Triton compiler params (num_warps), so on a
    GPU it lowers to a Triton custom call, never to Mosaic GPU."""
    megaT = pm.gather_megaT(world["pts"], world["mask"], world["pose"],
                            world["rmap"], GRID)
    jaxpr = jax.make_jaxpr(
        lambda p, m: pm.fused_objective(p, m, world["pose"], D1, D2,
                                        interpret=True)
    )(world["pts"].T, megaT)
    eqns = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert len(eqns) == 1
    params = eqns[0].params["compiler_params"]
    assert "triton" in params
    assert params["triton"].num_warps == pm.NUM_WARPS


@pytest.mark.parametrize(
    "platform, impl", [("gpu", "kernel"), ("cpu", "xla")]
)
def test_pair_math_impl_by_platform(platform, impl):
    assert pm.pair_math_impl(platform) == impl


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_pair_math_impl_rejects_other_platforms(platform):
    with pytest.raises(ValueError, match="no pair-math implementation"):
        pm.pair_math_impl(platform)


def test_pair_math_impl_defaults_to_the_default_backend():
    assert jax.default_backend() == "cpu"
    assert pm.pair_math_impl() == "xla"


@pytest.mark.gpu
@pytest.mark.parametrize("variant", VARIANTS)
def test_compiled_kernel_matches_plain_reference(gpu, world, variant):
    """On the card: the kernel compiled by Triton (no interpreter) against
    the plain XLA reference, and the step's HLO holds the Triton call."""
    got = _kernel(world, variant, None, interpret=False)
    _assert_close(got, _reference(world, variant))
    megaT = pm.gather_megaT(world["pts"], world["mask"], world["pose"],
                            world["rmap"], GRID)
    hlo = jax.jit(
        lambda p, m: pm.fused_objective(p, m, world["pose"], D1, D2)
    ).lower(world["pts"].T, megaT).compile().as_text()
    assert 'custom_call_target="__gpu$xla.gpu.triton"' in hlo
