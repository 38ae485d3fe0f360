"""The NDT pair math as one Pallas kernel for NVIDIA GPUs (Triton route).

Division of labour with XLA:
- XLA keeps the dense-grid lookup and the (N, 96) mega-row gather
  (``gather_megaT``): one gather is reused across inner Newton steps and
  across all K SVN particles, so it stays outside the kernel.
- The per-pair math (Mahalanobis -> pair weight -> gradient/Hessian moments)
  reads only contiguous per-point data: the transposed (96, N) mega rows and
  the (3, N) points. The plain XLA version (``regmap.score_grad_hess_gathered``
  and its GICP siblings) materialises (N, 7, 3) and (N, 7, 3, 3) intermediates
  and contracts them over N in separate passes. The kernel reads 99 floats per
  point once and writes 64 per block.

Layout for Hopper: every program handles one block of points and writes its
own row of a (num_blocks, 64) partials array ([0] score, [1:7] gradient,
[7:43] Hessian row-major, [43] count); a ``jnp.sum`` over blocks is the
second pass. No atomics, so results repeat bit for bit from run to run.
Each point keeps about 40 live values, so registers, not shared memory, set
the block size; loads are one (BLOCK,) row slice per field, which keeps every
loaded shape a power of two.

Padding and out-of-map points carry the all-zero sentinel mega row (validity
lanes 0) and contribute nothing, so no separate mask plane is needed; the
wrapper pads N up to a block multiple the same way.

``pair_math_impl`` is the one place that chooses between this kernel and the
plain XLA path. Tests run the kernel on the CPU with ``interpret=True``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core import se3
from ..core.se3 import Pose3
from .objective import MAX_EXPONENT_ARG, MIN_FACTOR, NdtObjective
from .regmap import RegMap

BLOCK = 512  # points per program (chosen on the H100, see PERF.md)
NUM_WARPS = 4
_OUT_LANES = 64  # one partials row per program; lanes 44..63 stay zero


def pair_math_impl(platform: str | None = None) -> str:
    """Which implementation evaluates the pair math on ``platform`` (the
    platform of the devices the computation runs on; default: JAX's default
    backend). ``"kernel"`` on a GPU, ``"xla"`` (the plain jnp path) on the
    CPU; any other platform is an error."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no pair-math implementation for platform {platform!r}")


def _load_pose(params_ref, ptsT_ref):
    """Scalar params and the block's body-frame and transformed points."""
    p = [params_ref[c] for c in range(16)]
    R = p[:9]
    x = [ptsT_ref[c, :] for c in range(3)]
    tp = [
        R[3 * i] * x[0] + R[3 * i + 1] * x[1] + R[3 * i + 2] * x[2] + p[9 + i]
        for i in range(3)
    ]
    return p, R, x, tp


def _kernel(params_ref, ptsT_ref, megaT_ref, out_ref, *, gicp: bool):
    """NDT (or, with ``gicp``, isotropic VGICP) pair math for one block.

    params ((16,)): R row-major(9), t(3), d1, d2, unused, max_mahal. In GICP
    mode the d2 slot carries max_corr_dist^2 and the pair weight is the
    trimmed quadratic cost instead of the NDT exponential.
    ptsT ((3, B)): body-frame points; megaT ((96, B)): transposed mega rows;
    out ((64,)): this block's partial sums.
    """
    p, R, x, tp = _load_pose(params_ref, ptsT_ref)
    d1, d2, max_mahal = p[12], p[13], p[15]
    zero = jnp.zeros_like(x[0])
    score = count = zero
    b = [zero] * 3
    M = [zero] * 9
    for k in range(7):
        base = 12 * k
        mu = [megaT_ref[base + c, :] for c in range(3)]
        ic = [megaT_ref[base + 3 + c, :] for c in range(9)]
        valid = megaT_ref[84 + k, :] > 0.5
        xr = [tp[c] - mu[c] for c in range(3)]
        icx = [ic[3 * r] * xr[0] + ic[3 * r + 1] * xr[1] + ic[3 * r + 2] * xr[2]
               for r in range(3)]
        mahal = jnp.maximum(xr[0] * icx[0] + xr[1] * icx[1] + xr[2] * icx[2], 0.0)
        if gicp:
            dist2 = xr[0] * xr[0] + xr[1] * xr[1] + xr[2] * xr[2]
            ok = valid & (mahal <= max_mahal) & (dist2 <= d2)
            pair_score = -mahal
            f = jnp.where(ok, -2.0, zero)
        else:
            exponent = 0.5 * d2 * mahal
            ok = valid & (exponent <= MAX_EXPONENT_ARG)
            e = jnp.exp(-jnp.where(ok, exponent, zero))
            pair_score = -d1 * e
            f = d1 * d2 * e
            f = jnp.where(ok & (jnp.abs(f) >= MIN_FACTOR), f, zero)
        score = score + jnp.where(ok, pair_score, zero)
        count = count + jnp.where(ok, 1.0, zero)
        b = [b[c] + f * icx[c] for c in range(3)]
        M = [M[c] + f * ic[c] for c in range(9)]
    out_ref[...] = _finish_block(R, x, b, M, score, count)


def _kernel_aniso(params_ref, ptsT_ref, megaT_ref, scovT_ref, out_ref):
    """Plane-to-plane GICP pair math for one block: per pair fuse
    S = C_t + R C_src R^T, invert it in registers (closed-form adjugate) and
    apply the trimmed quadratic cost.

    megaT carries the aux payload (mean(3), plane-regularized target
    covariance(9) per slot); scovT ((9, B)) is the per-point body-frame
    source covariance. params: R(9), t(3), unused, max_corr_dist^2, unused,
    max_mahal.
    """
    p, R, x, tp = _load_pose(params_ref, ptsT_ref)
    corr2, max_mahal = p[13], p[15]
    # rc = R C_src R^T per point (C_src symmetric, row-major in scovT)
    s = [scovT_ref[c, :] for c in range(9)]
    RC = [[R[3 * i] * s[j] + R[3 * i + 1] * s[3 + j] + R[3 * i + 2] * s[6 + j]
           for j in range(3)] for i in range(3)]
    rc = [[RC[i][0] * R[3 * j] + RC[i][1] * R[3 * j + 1] + RC[i][2] * R[3 * j + 2]
           for j in range(3)] for i in range(3)]

    zero = jnp.zeros_like(x[0])
    score = count = zero
    b = [zero] * 3
    M = [zero] * 9
    for k in range(7):
        base = 12 * k
        mu = [megaT_ref[base + c, :] for c in range(3)]
        ct = [megaT_ref[base + 3 + c, :] for c in range(9)]
        valid = megaT_ref[84 + k, :] > 0.5
        # fused symmetric S = C_t + rc (6 unique planes)
        s00 = ct[0] + rc[0][0]
        s01 = ct[1] + rc[0][1]
        s02 = ct[2] + rc[0][2]
        s11 = ct[4] + rc[1][1]
        s12 = ct[5] + rc[1][2]
        s22 = ct[8] + rc[2][2]
        # closed-form symmetric 3x3 inverse (adjugate / det)
        c00 = s11 * s22 - s12 * s12
        c01 = s02 * s12 - s01 * s22
        c02 = s01 * s12 - s02 * s11
        c11 = s00 * s22 - s02 * s02
        c12 = s01 * s02 - s00 * s12
        c22 = s00 * s11 - s01 * s01
        det = s00 * c00 + s01 * c01 + s02 * c02
        inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
        i00, i01, i02 = c00 * inv_det, c01 * inv_det, c02 * inv_det
        i11, i12, i22 = c11 * inv_det, c12 * inv_det, c22 * inv_det
        xr = [tp[c] - mu[c] for c in range(3)]
        icx = [
            i00 * xr[0] + i01 * xr[1] + i02 * xr[2],
            i01 * xr[0] + i11 * xr[1] + i12 * xr[2],
            i02 * xr[0] + i12 * xr[1] + i22 * xr[2],
        ]
        mahal = jnp.maximum(xr[0] * icx[0] + xr[1] * icx[1] + xr[2] * icx[2], 0.0)
        dist2 = xr[0] * xr[0] + xr[1] * xr[1] + xr[2] * xr[2]
        ok = valid & (mahal <= max_mahal) & (dist2 <= corr2)
        f = jnp.where(ok, -2.0, zero)
        score = score + jnp.where(ok, -mahal, zero)
        count = count + jnp.where(ok, 1.0, zero)
        b = [b[c] + f * icx[c] for c in range(3)]
        fi = (i00, i01, i02, i01, i11, i12, i02, i12, i22)
        M = [M[c] + f * fi[c] for c in range(9)]
    out_ref[...] = _finish_block(R, x, b, M, score, count)


def _finish_block(R, x, b, M, score, count):
    """Shared tail of the three pair loops: assemble gradient and Hessian
    from the per-point moments (b = sum f*icx, M = sum f*icov) and reduce the
    block to its (64,) partials row. Tangent order is [omega, v]."""
    # gradient: q = R^T b ; g_v = sum q ; g_w = sum x cross q
    q = [R[a] * b[0] + R[3 + a] * b[1] + R[6 + a] * b[2] for a in range(3)]
    gv = [jnp.sum(q[a]) for a in range(3)]
    gw = [
        jnp.sum(x[1] * q[2] - x[2] * q[1]),
        jnp.sum(x[2] * q[0] - x[0] * q[2]),
        jnp.sum(x[0] * q[1] - x[1] * q[0]),
    ]

    # P = R^T M R per point (symmetric: 6 unique planes)
    P = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for c in range(a, 3):
            acc = None
            for i in range(3):
                for j in range(3):
                    term = (R[3 * i + a] * R[3 * j + c]) * M[3 * i + j]
                    acc = term if acc is None else acc + term
            P[a][c] = P[c][a] = acc

    def cross(u):  # x cross u, per point
        return (
            x[1] * u[2] - x[2] * u[1],
            x[2] * u[0] - x[0] * u[2],
            x[0] * u[1] - x[1] * u[0],
        )

    # H_vv = sum P ; Q[:, c] = x cross P[:, c] ; H_wv = sum Q ;
    # H_ww[a, :] = sum x cross Q[a, :] (symmetric)
    Qcols = [cross((P[0][c], P[1][c], P[2][c])) for c in range(3)]
    H = [[None] * 6 for _ in range(6)]
    for a in range(3):
        for c in range(3):
            if c >= a:
                H[3 + a][3 + c] = H[3 + c][3 + a] = jnp.sum(P[a][c])
            H[a][3 + c] = H[3 + c][a] = jnp.sum(Qcols[c][a])
    for a in range(3):
        wrow = cross((Qcols[0][a], Qcols[1][a], Qcols[2][a]))
        for c in range(a, 3):
            H[a][c] = H[c][a] = jnp.sum(wrow[c])

    vals = [jnp.sum(score), *gw, *gv, *(H[a][c] for a in range(6) for c in range(6)),
            jnp.sum(count)]
    lane = jax.lax.broadcasted_iota(jnp.int32, (_OUT_LANES,), 0)
    row = jnp.zeros((_OUT_LANES,), jnp.float32)
    for c, v in enumerate(vals):
        row = jnp.where(lane == c, v, row)
    return row


def gather_megaT(
    points, mask, pose: Pose3, regmap: RegMap, grid_shape, kd_radius=None,
    table: str = "packed",
):
    """XLA side: voxel assignment + mega-row gather -> (96, N) float32.

    Index resolution is shared with the XLA objective (regmap.point_rows) so
    the fused and gathered paths cannot drift. ``kd_radius`` applies the
    KDTREE-mode centroid-distance gate by zeroing the slot-validity flags of
    out-of-radius candidates (regmap.radius_gate) — the kernel needs no
    change. ``table="aux"`` gathers from ``RegMap.packed_aux`` (the
    alternative payload, e.g. plane-regularized covariances)."""
    from .regmap import point_rows, radius_gate

    tp, drow = point_rows(points, mask, pose, regmap, grid_shape)
    src = regmap.packed if table == "packed" else regmap.packed_aux
    mega = src[drow]  # (N, 96)
    if kd_radius is not None and kd_radius > 0.0:
        mu = mega[:, :84].reshape(-1, 7, 12)[..., 0:3]
        act = radius_gate(tp, mu, mega[:, 84:91] > 0.5, kd_radius)
        mega = jnp.concatenate(
            [mega[:, :84], act.astype(mega.dtype), mega[:, 91:]], axis=1
        )
    return mega.T.astype(jnp.float32)  # (96, N)


def _kernel_sums(params, ptsT, megaT, src_covT, gicp, block, interpret):
    """Run the kernel over all point blocks and reduce the partials rows."""
    N = ptsT.shape[1]
    pad = -N % block
    ops = [ptsT, megaT] + ([] if src_covT is None else [src_covT])
    if pad:  # zero rows are sentinels: they contribute nothing
        ops = [jnp.pad(a, ((0, 0), (0, pad))) for a in ops]
    nb = (N + pad) // block
    kernel = (
        _kernel_aniso if src_covT is not None
        else functools.partial(_kernel, gicp=gicp)
    )
    partials = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nb, _OUT_LANES), jnp.float32),
        grid=(nb,),
        in_specs=[pl.BlockSpec((16,), lambda i: (0,))]
        + [pl.BlockSpec((a.shape[0], block), lambda i: (0, i)) for a in ops],
        out_specs=pl.BlockSpec((None, _OUT_LANES), lambda i: (i, 0)),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="ndt_pair_math",
    )(params, *ops)
    return jnp.sum(partials, axis=0)


def _xla_objective(ptsT, megaT, pose, d1, d2, hess_lambda, gicp, max_mahal, src_covT):
    """The plain XLA path on the same pre-gathered rows (the transposes cancel
    against the ones ``gather_megaT`` and the callers apply)."""
    from . import gicp as gicp_mod
    from .regmap import score_grad_hess_gathered

    pts = ptsT.T
    mega = megaT.T
    N = pts.shape[0]
    fields = mega[:, :84].reshape(N, 7, 12)
    mu = fields[..., 0:3]
    cov = fields[..., 3:12].reshape(N, 7, 3, 3)
    active = mega[:, 84:91] > 0.5
    if src_covT is not None:
        return gicp_mod.score_grad_hess_gicp_aniso_gathered(
            pts, src_covT.T.reshape(N, 3, 3), pose, mu, cov, active,
            hess_lambda, max_mahal, d2**0.5,
        )
    if gicp:
        return gicp_mod.score_grad_hess_gicp_gathered(
            pts, pose, mu, cov, active, hess_lambda, max_mahal, d2**0.5
        )
    return score_grad_hess_gathered(pts, pose, mu, cov, active, d1, d2, hess_lambda)


def fused_objective(
    ptsT, megaT, pose: Pose3, d1, d2, hess_lambda=1e-6,
    gicp: bool = False, gicp_max_mahal: float = 9.0, block: int = None,
    interpret: bool = False, src_covT=None, platform: str = None,
) -> NdtObjective:
    """The pair math on pre-gathered mega rows.

    With ``gicp=True`` the pair weight switches to the trimmed quadratic
    GICP cost (use a RegMap built from gicp_map; d1 is ignored and d2
    carries max_corr_dist^2). With ``src_covT`` ((9, N) per-point body-frame
    source covariances) it runs the PLANE-TO-PLANE mode: megaT must carry the
    aux payload (plane-regularized target COVARIANCES), the per-pair fusion
    (C_t + R C_s R^T)^-1 happens in registers, and d2 carries
    max_corr_dist^2.

    ``pair_math_impl(platform)`` picks the kernel or the plain XLA path;
    ``interpret=True`` (tests only) runs the kernel in the Pallas interpreter
    on any platform. ``block`` overrides the points per program."""
    if not interpret and pair_math_impl(platform) == "xla":
        return _xla_objective(
            ptsT, megaT, pose, d1, d2, hess_lambda, gicp, gicp_max_mahal, src_covT
        )
    params = jnp.concatenate(
        [
            pose.rot.astype(jnp.float32).reshape(9),
            pose.trans.astype(jnp.float32),
            jnp.asarray([d1, d2, 0.0, gicp_max_mahal], jnp.float32),
        ]
    )
    if src_covT is not None:
        src_covT = src_covT.astype(jnp.float32)
    out = _kernel_sums(
        params, ptsT.astype(jnp.float32), megaT, src_covT, gicp,
        block or BLOCK, interpret,
    )
    hess = out[7:43].reshape(6, 6) + hess_lambda * jnp.eye(6, dtype=jnp.float32)
    return NdtObjective(out[0], out[1:7], hess, out[43].astype(jnp.int32))


@functools.partial(
    jax.jit,
    static_argnames=("grid_shape", "hess_lambda", "d1", "d2", "block", "interpret"),
)
def score_grad_hess_fused(
    points: jax.Array,  # (N, 3) float32
    mask: jax.Array,  # (N,)
    pose: Pose3,
    regmap: RegMap,
    d1: float,
    d2: float,
    grid_shape: tuple,
    hess_lambda: float = 1e-6,
    block: int = None,
    interpret: bool = False,
) -> NdtObjective:
    """XLA gathers + the pair math of ``fused_objective``. float32 only."""
    from .objective import sanitize_points

    points, mask = sanitize_points(points, mask)
    megaT = gather_megaT(points, mask, pose, regmap, grid_shape)
    return fused_objective(
        points.T.astype(jnp.float32), megaT, pose, d1, d2, hess_lambda,
        block=block, interpret=interpret,
    )


def gicp_align_fused(
    points: jax.Array,
    mask: jax.Array,
    regmap: RegMap,  # built from gicp_map(...)
    init_pose: Pose3,
    cfg,  # NewtonConfig
    grid_shape: tuple,
    inner_iters: int = 1,
    max_mahal: float = 9.0,
    interpret: bool = False,
    block: int = None,
):
    """VGICP registration on the fused pair math (cf. ndt.gicp)."""
    return newton_align_fused(
        points, mask, regmap, init_pose, cfg, grid_shape, inner_iters,
        _gicp=True, _gicp_max_mahal=max_mahal, interpret=interpret, block=block,
    )


def newton_align_fused(
    points: jax.Array,
    mask: jax.Array,
    regmap: RegMap,
    init_pose: Pose3,
    cfg,  # NewtonConfig
    grid_shape: tuple,
    inner_iters: int = 1,
    reg_pose: Pose3 = None,
    interpret: bool = False,
    block: int = None,
    final_eval: bool = False,
    platform: str = None,
    _gicp: bool = False,
    _gicp_max_mahal: float = 9.0,
) -> "NewtonResult":
    """Newton registration on the fused pair math (``fused_objective``:
    the kernel on a GPU, plain XLA on the CPU; ``platform`` names the
    platform when the caller knows it, as the sharded paths do).

    ``inner_iters > 1`` re-uses each gather for several Newton steps (voxel
    assignments change negligibly between steps once the pose is within a
    fraction of the resolution — the same approximation as SVN shared-gather),
    cutting the gather-bound cost accordingly. ``inner_iters=1`` is exact
    DIRECT7 per step. A STALENESS BUDGET guards the reuse: once the
    cumulative step length since the gather exceeds a quarter of the voxel
    size, further inner steps freeze and the next outer iteration re-gathers
    — unbudgeted reuse walked registrations into wrong-neighbor basins on
    maps with thin far-range voxels (measured 0.005 -> 0.144 m at a 0.3 m
    initial offset with inner_iters=4).

    ``reg_pose`` (with ``cfg.reg_weight > 0``) adds the prior-pose
    regularization penalty to each step (NewtonConfig.reg_weight).

    Contract: by default the returned (score, hessian) are evaluated at the
    pose BEFORE the final retract — within ``trans_eps`` of the returned pose
    once converged (this saves one gather and evaluation per registration,
    and the apps consume the Hessian only as a converged-pose
    covariance). Pass ``final_eval=True`` to re-evaluate the objective at the
    RETURNED pose instead, matching the non-fused ``newton_align`` /
    ``newton_align_reg`` contract exactly (the reference prices factors off
    the converged-pose Hessian, run/pipeline.cpp:594-604). Pinned by
    tests/test_regmap.py::TestFusedContract.
    """
    from .constants import gauss_constants
    from .newton import NewtonResult, regularize_step

    d1, d2, _ = gauss_constants(cfg.resolution, cfg.outlier_ratio)
    if _gicp:
        # the kernel's d2 slot carries the squared correspondence-distance
        # gate in GICP mode (gicp_corr_dist_threshold analog)
        d2 = float(cfg.gicp_max_corr_dist) ** 2
    dtype = jnp.float32
    from .objective import sanitize_points

    # a NaN coordinate would poison the kernel's b/grad accumulators via
    # 0 * NaN even with a zero pair weight — zero it and drop it from the mask
    points, mask = sanitize_points(points, mask)
    ptsT = points.T.astype(dtype)

    def one_step(pose, megaT):
        obj = fused_objective(
            ptsT, megaT, pose, d1, d2, cfg.hess_lambda,
            gicp=_gicp, gicp_max_mahal=_gicp_max_mahal, interpret=interpret,
            block=block, platform=platform,
        )
        grad, hess = regularize_step(
            pose, obj.grad, obj.hess, obj.n_contrib, cfg, reg_pose
        )
        step = jnp.linalg.solve(hess, -grad)
        step = jnp.where(jnp.all(jnp.isfinite(step)), step, jnp.zeros_like(step))
        norm = jnp.linalg.norm(step)
        scale = jnp.where(
            norm > cfg.max_step_norm, cfg.max_step_norm / jnp.maximum(norm, 1e-30), 1.0
        )
        step = (cfg.step_size * scale) * step
        return se3.retract(pose, step.astype(dtype)), jnp.linalg.norm(step), obj

    def cond(state):
        _pose, it, converged, *_ = state
        return (it < cfg.max_iterations) & (~converged)

    stale_budget = jnp.asarray(cfg.gather_stale_frac * cfg.resolution, dtype)

    def body(state):
        pose, it, conv, score, hess, nc = state
        megaT = gather_megaT(
            points, mask, pose, regmap, grid_shape,
            kd_radius=getattr(cfg, "kd_radius", 0.0),
        )

        def inner(_, carry):
            pose_i, norm_i, obj_i, moved, napp = carry
            new_pose, stepn, obj2 = one_step(pose_i, megaT)
            # staleness budget: freeze once the pose has moved a quarter
            # eighth of a voxel... (the next outer iteration re-gathers);
            # frozen steps do NOT count toward the iteration budget
            ok = moved + stepn <= stale_budget
            pose_o = jax.tree.map(
                lambda n, o: jnp.where(ok, n, o), new_pose, pose_i
            )
            obj_o = jax.tree.map(lambda n, o: jnp.where(ok, n, o), obj2, obj_i)
            return (
                pose_o,
                jnp.where(ok, stepn, norm_i),
                obj_o,
                jnp.where(ok, moved + stepn, moved + stale_budget),
                napp + jnp.where(ok, 1, 0).astype(jnp.int32),
            )

        pose0, norm0, obj0 = one_step(pose, megaT)
        if inner_iters > 1:
            pose_f, norm_f, obj_f, _moved, n_applied = jax.lax.fori_loop(
                0, inner_iters - 1, inner,
                (pose0, norm0, obj0, norm0, jnp.asarray(1, jnp.int32)),
            )
        else:
            pose_f, norm_f, obj_f = pose0, norm0, obj0
            n_applied = jnp.asarray(1, jnp.int32)
        converged = norm_f < cfg.trans_eps
        # freeze once converged: under vmap (newton_align_fused_batch) the
        # lockstep while keeps executing body for finished lanes — their
        # state must not move, or batched results diverge from unbatched
        out = (pose_f, it + n_applied, conv | converged, obj_f.score,
               obj_f.hess, obj_f.n_contrib)
        old = (pose, it, conv, score, hess, nc)
        return jax.tree.map(lambda n, o: jnp.where(conv, o, n), out, old)

    init_state = (
        se3.cast(init_pose, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(0.0, dtype),
        jnp.zeros((6, 6), dtype),
        jnp.asarray(0, jnp.int32),
    )
    pose, iters, converged, score, hess, nc = jax.lax.while_loop(cond, body, init_state)
    if final_eval:
        megaT = gather_megaT(
            points, mask, pose, regmap, grid_shape,
            kd_radius=getattr(cfg, "kd_radius", 0.0),
        )
        obj = fused_objective(
            ptsT, megaT, pose, d1, d2, cfg.hess_lambda,
            gicp=_gicp, gicp_max_mahal=_gicp_max_mahal, interpret=interpret,
            block=block, platform=platform,
        )
        score, hess, nc = obj.score, obj.hess, obj.n_contrib
    return NewtonResult(pose, hess, score, iters, converged, nc)


def newton_align_fused_batch(
    points: jax.Array,  # (B, N, 3) scans sharing one map
    mask: jax.Array,  # (B, N)
    regmap: RegMap,
    init_pose: Pose3,  # (B,)-batched Pose3
    cfg,  # NewtonConfig
    grid_shape: tuple,
    inner_iters: int = 1,
    interpret: bool = False,
    block: int = None,
    final_eval: bool = False,
    platform: str = None,
) -> "NewtonResult":
    """Register B scans against ONE shared map in a single dispatch.

    Fills the card when one scan's registration leaves it idle: the vmap
    batches the kernel over a leading grid axis and the per-scan 6-dof
    Newton solves stay independent (the lockstep while_loop runs until every
    scan converges — iterations report the max). Per-scan accuracy equals
    the unbatched path.
    """
    return jax.vmap(
        lambda p, m, ip: newton_align_fused(
            p, m, regmap, ip, cfg, grid_shape, inner_iters,
            interpret=interpret, block=block, final_eval=final_eval,
            platform=platform,
        )
    )(points, mask, init_pose)
