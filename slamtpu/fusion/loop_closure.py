"""Loop-closure detection and pose-graph refinement.

Completes the reference's commented-out scaffold
(/root/reference/run/pipeline.cpp:676-736): keyframes are bucketed by the
voxel of their position (the reference's spatialArchive / VoxelHashMap,
map.hpp:110); revisited buckets within a search radius — excluding the recent
temporal window — yield candidate pairs, which are verified by NDT
registration (scan-to-scan) and turned into between-factors for the batch
pose-graph optimizer (slamtpu.fusion.pose_graph).
"""
from __future__ import annotations

import dataclasses
import logging
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se3
from ..core.se3 import Pose3
from ..mapping import gaussian_map
from ..ndt import NewtonConfig, build_regmap, newton_align_reg
from . import pose_graph as pg
from .graph import sqrt_info_from_cov

log = logging.getLogger("slamtpu.loop")


@dataclasses.dataclass
class LoopClosure:
    i: int
    j: int
    relative: Pose3  # measured i -> j
    covariance: np.ndarray  # (6, 6)
    score: float


@dataclasses.dataclass
class LoopClosureConfig:
    bucket_size: float = 10.0  # m, spatial bucket edge (reference used voxel buckets)
    search_radius: float = 15.0  # m, candidate distance threshold
    min_keyframe_gap: int = 20  # temporal exclusion window
    max_candidates_per_keyframe: int = 2
    resolution: float = 2.0  # NDT voxel size for verification
    reg_grid_shape: tuple = (128, 128, 32)  # dense lookup grid (searchsorted-free)
    max_iterations: int = 30
    min_contrib_ratio: float = 0.3  # accepted pairs / source points
    max_fitness_error: float = 0.5  # m, translation sanity vs odometry guess


class LoopDetector:
    """Host-side spatial index + NDT verification of loop candidates."""

    def __init__(self, cfg: LoopClosureConfig = LoopClosureConfig()):
        self.cfg = cfg
        self.buckets: Dict[Tuple[int, int, int], List[int]] = defaultdict(list)
        self.positions: List[np.ndarray] = []
        self.clouds: List[Tuple[jax.Array, jax.Array]] = []  # body-frame points, mask
        self.poses: List[Pose3] = []

    def add_keyframe(self, pose: Pose3, points, mask) -> List[LoopClosure]:
        """Register a keyframe and return verified loop closures against it."""
        idx = len(self.poses)
        pos = np.asarray(pose.trans, np.float64)
        closures = []
        for cand in self._candidates(pos, idx):
            lc = self.verify_pair(cand, pose, points, mask)
            if lc is not None:
                closures.append(lc)
                if len(closures) >= self.cfg.max_candidates_per_keyframe:
                    break
        key = tuple(np.floor(pos / self.cfg.bucket_size).astype(int))
        self.buckets[key].append(idx)
        self.positions.append(pos)
        self.clouds.append((points, mask))
        self.poses.append(pose)
        return closures

    def _candidates(self, pos: np.ndarray, idx: int) -> List[int]:
        base = np.floor(pos / self.cfg.bucket_size).astype(int)
        found = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for k in self.buckets.get(tuple(base + [dx, dy, dz]), ()):
                        if idx - k < self.cfg.min_keyframe_gap:
                            continue
                        if np.linalg.norm(self.positions[k] - pos) <= self.cfg.search_radius:
                            found.append(k)
        found.sort(key=lambda k: np.linalg.norm(self.positions[k] - pos))
        return found

    def verify_pair(self, k: int, pose_j: Pose3, pts_j, mask_j) -> Optional[LoopClosure]:
        """NDT-register the new keyframe's cloud against candidate k's map."""
        cfg = self.cfg
        pts_k, mask_k = self.clouds[k]
        pose_k = self.poses[k]
        world_k = se3.transform_points(se3.cast(pose_k, pts_k.dtype), pts_k)
        origin = gaussian_map.origin_for(world_k, mask_k, cfg.resolution)
        gmap = gaussian_map.build_map(
            world_k, mask_k, origin, cfg.resolution, capacity=1 << 14,
            min_points_per_voxel=4,
        )
        # RegMap path: the production registration layout (the sorted-key
        # gmap path is a test oracle)
        regmap = build_regmap(gmap, grid_shape=cfg.reg_grid_shape)
        res = newton_align_reg(
            pts_j, mask_j, regmap, se3.cast(pose_j, pts_j.dtype),
            NewtonConfig(resolution=cfg.resolution, max_iterations=cfg.max_iterations),
            cfg.reg_grid_shape,
        )
        n_src = int(jnp.sum(mask_j))
        ratio = float(res.n_contrib) / max(n_src * 7, 1)
        guess_delta = np.linalg.norm(
            np.asarray(res.pose.trans) - np.asarray(pose_j.trans, np.float32)
        )
        # Note: the eps-convergence flag is deliberately NOT required — Newton
        # can creep along weakly-constrained directions without crossing the
        # step threshold while the registration itself is good; the contrib
        # ratio and odometry-consistency gates below are the real filters.
        if ratio < cfg.min_contrib_ratio or guess_delta > cfg.max_fitness_error:
            log.info(
                "loop %d rejected: ratio=%.2f delta=%.2f", k, ratio, guess_delta
            )
            return None
        H = np.asarray(res.hessian, np.float64)
        cov = -np.linalg.inv(H + 1e-6 * np.eye(6))
        cov = 0.5 * (cov + cov.T)
        ev, evec = np.linalg.eigh(cov)
        cov = evec @ np.diag(np.maximum(ev, 1e-9)) @ evec.T
        rel = se3.between(se3.cast(self.poses[k], jnp.float32), res.pose)
        return LoopClosure(k, len(self.poses), rel, cov, float(res.score))


def refine_trajectory(
    poses: List[Pose3],
    odometry_rels: List[Pose3],
    odometry_covs: List[np.ndarray],
    closures: List[LoopClosure],
    cfg: pg.PoseGraphConfig = pg.PoseGraphConfig(huber_delta=2.0),
    prior_poses: List[Pose3] = None,
    prior_sigmas: List[np.ndarray] = None,
):
    """Batch pose-graph optimization over odometry + loop-closure factors.

    ``prior_poses``/``prior_sigmas`` (optional, per node) add absolute pose
    priors — the INS priors the reference's live iSAM2 graph carries
    (run/pipeline.cpp:637-665). Without them the offline re-solve discards
    the GNSS/INS information and its optimum reverts to raw odometry-chain
    quality. The default config enables a Huber kernel at 2 sigma: an
    imperfect closure is downweighted instead of distorting the whole
    trajectory."""
    N = len(poses)
    stack = Pose3(
        jnp.stack([p.rot for p in poses]), jnp.stack([p.trans for p in poses])
    )
    i = list(range(N - 1)) + [c.i for c in closures]
    j = list(range(1, N)) + [c.j for c in closures]
    rels = odometry_rels + [c.relative for c in closures]
    covs = odometry_covs + [c.covariance for c in closures]
    rel = Pose3(
        jnp.stack([r.rot for r in rels]), jnp.stack([r.trans for r in rels])
    )
    si = jnp.stack([sqrt_info_from_cov(jnp.asarray(c)) for c in covs])
    prior = None
    psi = None
    if prior_poses is not None:
        prior = Pose3(
            jnp.stack([p.rot for p in prior_poses]),
            jnp.stack([p.trans for p in prior_poses]),
        )
        psi = jnp.stack(
            [jnp.diag(1.0 / jnp.asarray(s, stack.trans.dtype)) for s in prior_sigmas]
        )
    graph = pg.make_graph(
        stack, jnp.asarray(i, jnp.int32), jnp.asarray(j, jnp.int32), rel, si,
        prior=prior, prior_sqrt_info=psi,
    )
    result = pg.optimize(graph, cfg)
    return [Pose3(result.poses.rot[k], result.poses.trans[k]) for k in range(N)], result
