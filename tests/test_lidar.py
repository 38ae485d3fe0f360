"""Golden-packet tests for the Ouster decoder + device projection.

Packets are synthesized byte-for-byte per the wire layouts in
/root/reference/src/lidarcallback.cpp:632-891 (RNG19) and :382-630 (LEGACY);
decoded output is checked against an independent scalar oracle.
"""
import struct

import jax
import jax.numpy as jnp
import numpy as np

from slamtpu.lidar import (
    FrameAssembler,
    LidarParams,
    ProjectionFilters,
    build_luts,
    filters_from_params,
    packet_size,
    parse_packet,
    project_frame,
    synthetic_os2_metadata,
)

RNG = np.random.default_rng(99)


def make_meta(profile="RNG19_RFL8_SIG16_NIR16", cols=64, pix=16, cpp=4):
    return synthetic_os2_metadata(
        columns_per_frame=cols,
        pixels_per_column=pix,
        columns_per_packet=cpp,
        udp_profile=profile,
    )


def build_rng19_packet(meta, frame_id, m_ids, ts_ns, ranges_mm, refl, signal, nir,
                       col_status=None):
    """Hand-built RNG19 packet (32B header | cols x (12B hdr + pix x 12B) | 32B footer)."""
    pix = meta.pixels_per_column
    col_status = [1] * len(m_ids) if col_status is None else col_status
    out = bytearray()
    out += struct.pack("<HH", 0x0001, frame_id) + bytes(28)
    for c, m_id in enumerate(m_ids):
        out += struct.pack("<QHBx", ts_ns[c], m_id, col_status[c])
        for ch in range(pix):
            r = int(ranges_mm[c][ch]) & 0x7FFFF
            out += struct.pack("<BBBxBxHHH", r & 0xFF, (r >> 8) & 0xFF, (r >> 16) & 0xFF,
                               int(refl[c][ch]), int(signal[c][ch]), int(nir[c][ch]), 0)
    out += bytes(32)
    assert len(out) == packet_size(meta)
    return bytes(out)


def build_legacy_packet(meta, frame_ids, m_ids, ts_ns, ranges_mm, refl, signal, nir,
                        block_status=None):
    """LEGACY packet: cols x (16B hdr + pix x 12B + 4B status)."""
    pix = meta.pixels_per_column
    block_status = [0xFFFFFFFF] * len(m_ids) if block_status is None else block_status
    out = bytearray()
    for c, m_id in enumerate(m_ids):
        out += struct.pack("<QHH", ts_ns[c], m_id, frame_ids[c]) + bytes(4)
        for ch in range(pix):
            r = int(ranges_mm[c][ch]) & 0xFFFFF
            out += struct.pack("<IBxHHH", r, int(refl[c][ch]), int(signal[c][ch]),
                               int(nir[c][ch]), 0)
        out += struct.pack("<I", block_status[c])
    assert len(out) == packet_size(meta)
    return bytes(out)


def random_fields(meta, n_cols):
    pix = meta.pixels_per_column
    return (
        RNG.integers(500, 200000, size=(n_cols, pix)),
        RNG.integers(0, 255, size=(n_cols, pix)),
        RNG.integers(0, 65535, size=(n_cols, pix)),
        RNG.integers(0, 65535, size=(n_cols, pix)),
    )


class TestParse:
    def test_rng19_roundtrip(self):
        meta = make_meta()
        params = LidarParams(channel_stride=2)
        luts = build_luts(meta, params)
        ranges, refl, sig, nir = random_fields(meta, 4)
        ts = [10_000_000_000 + i * 100_000 for i in range(4)]
        pkt = build_rng19_packet(meta, 7, [0, 1, 2, 3], ts, ranges, refl, sig, nir)
        pc = parse_packet(pkt, meta, luts)
        assert pc is not None
        np.testing.assert_array_equal(pc.m_ids, [0, 1, 2, 3])
        assert pc.col_valid.all()
        sub = luts.subset_c_ids
        np.testing.assert_allclose(
            pc.ranges_m, ranges[:, sub].astype(np.float32) * 1e-3, rtol=1e-7
        )
        np.testing.assert_array_equal(pc.reflectivity, refl[:, sub].astype(np.uint8))
        np.testing.assert_array_equal(pc.signal, sig[:, sub].astype(np.uint16))
        np.testing.assert_array_equal(pc.nir, nir[:, sub].astype(np.uint16))
        np.testing.assert_allclose(pc.timestamps_s, np.asarray(ts) * 1e-9, rtol=0, atol=1e-12)

    def test_rng19_range_is_19bit(self):
        meta = make_meta(pix=4, cpp=1)
        luts = build_luts(meta, LidarParams())
        ranges = np.full((1, 4), 0x7FFFF + 1000)  # overflows 19 bits
        pkt = build_rng19_packet(meta, 1, [0], [0], ranges, *(np.zeros((1, 4)),) * 3)
        pc = parse_packet(pkt, meta, luts)
        np.testing.assert_allclose(
            pc.ranges_m[0], ((0x7FFFF + 1000) & 0x7FFFF) * 1e-3 * np.ones(4), rtol=1e-7
        )

    def test_bad_type_and_size_rejected(self):
        meta = make_meta()
        luts = build_luts(meta, LidarParams())
        assert parse_packet(b"\x00" * 10, meta, luts) is None
        ranges, refl, sig, nir = random_fields(meta, 4)
        pkt = bytearray(build_rng19_packet(meta, 1, [0, 1, 2, 3], [0] * 4, ranges, refl, sig, nir))
        pkt[0] = 0x55  # wrong packet type
        assert parse_packet(bytes(pkt), meta, luts) is None

    def test_invalid_column_status_masked(self):
        meta = make_meta()
        luts = build_luts(meta, LidarParams())
        ranges, refl, sig, nir = random_fields(meta, 4)
        pkt = build_rng19_packet(
            meta, 1, [0, 1, 2, 3], [0] * 4, ranges, refl, sig, nir, col_status=[1, 0, 1, 0]
        )
        pc = parse_packet(pkt, meta, luts)
        np.testing.assert_array_equal(pc.col_valid, [True, False, True, False])

    def test_legacy_roundtrip(self):
        meta = make_meta(profile="LEGACY")
        luts = build_luts(meta, LidarParams(channel_stride=4))
        ranges, refl, sig, nir = random_fields(meta, 4)
        ts = [5_000_000_000 + i for i in range(4)]
        pkt = build_legacy_packet(meta, [3] * 4, [4, 5, 6, 7], ts, ranges, refl, sig, nir,
                                  block_status=[0xFFFFFFFF, 0, 0xFFFFFFFF, 0xFFFFFFFF])
        pc = parse_packet(pkt, meta, luts)
        sub = luts.subset_c_ids
        np.testing.assert_array_equal(pc.col_valid, [True, False, True, True])
        np.testing.assert_allclose(
            pc.ranges_m, ranges[:, sub].astype(np.float32) * 1e-3, rtol=1e-7
        )

    def test_timestamp_fold_mod_86400(self):
        meta = make_meta(pix=4, cpp=1)
        luts = build_luts(meta, LidarParams())
        two_days_ns = int(2.5 * 86400 * 1e9)
        pkt = build_rng19_packet(meta, 1, [0], [two_days_ns], np.ones((1, 4)) * 1000,
                                 *(np.zeros((1, 4)),) * 3)
        pc = parse_packet(pkt, meta, luts)
        np.testing.assert_allclose(pc.timestamps_s[0], 0.5 * 86400, atol=1e-6)


class TestAssembler:
    def test_frame_boundary_on_id_change(self):
        meta = make_meta(cols=8, pix=4, cpp=4)
        luts = build_luts(meta, LidarParams())
        asm = FrameAssembler(meta, luts)
        ranges, refl, sig, nir = random_fields(meta, 4)
        base = 1_000_000_000
        p1 = build_rng19_packet(meta, 1, [0, 1, 2, 3], [base + i * 100 for i in range(4)],
                                ranges, refl, sig, nir)
        p2 = build_rng19_packet(meta, 1, [4, 5, 6, 7], [base + 400 + i * 100 for i in range(4)],
                                ranges, refl, sig, nir)
        p3 = build_rng19_packet(meta, 2, [0, 1, 2, 3], [base + 800 + i * 100 for i in range(4)],
                                ranges, refl, sig, nir)
        assert asm.push_packet(p1) is None
        assert asm.push_packet(p2) is None
        frame = asm.push_packet(p3)
        assert frame is not None and frame.frame_id == 1
        assert frame.col_valid.all()
        assert frame.num_columns == 8
        np.testing.assert_allclose(frame.timestamp, base * 1e-9, atol=1e-12)
        np.testing.assert_allclose(frame.timestamp_end, (base + 700) * 1e-9, atol=1e-12)
        # second frame completes via flush
        f2 = asm.flush()
        assert f2 is not None and f2.frame_id == 2 and f2.num_columns == 4

    def test_legacy_mid_packet_boundary(self):
        meta = make_meta(profile="LEGACY", cols=8, pix=4, cpp=4)
        luts = build_luts(meta, LidarParams())
        asm = FrameAssembler(meta, luts)
        ranges, refl, sig, nir = random_fields(meta, 4)
        pkt = build_legacy_packet(meta, [1, 1, 2, 2], [6, 7, 0, 1], [100] * 4,
                                  ranges, refl, sig, nir)
        frame = asm.push_packet(pkt)
        assert frame is not None and frame.frame_id == 1 and frame.num_columns == 2


class TestProjection:
    def test_points_match_scalar_oracle(self):
        meta = make_meta(cols=16, pix=8, cpp=4)
        params = LidarParams(
            channel_stride=2,
            range_filter=(0.3, 150.0),
            z_filter=(-5.0, 5.0),
            reflectivity_threshold=200,
            vehicle_box_center=np.zeros(3),
            vehicle_box_dimensions=np.array([1.0, 1.0, 1.0]),
        )
        luts = build_luts(meta, params)
        asm = FrameAssembler(meta, luts)
        n_pk = 4
        frames = []
        for k in range(2):  # two frames so the first completes
            for p in range(n_pk):
                ranges, refl, sig, nir = random_fields(meta, 4)
                ranges = np.where(RNG.random(ranges.shape) < 0.2, 0, ranges)  # no-returns
                pkt = build_rng19_packet(
                    meta, k, [p * 4 + i for i in range(4)],
                    [int(1e9 + (k * 16 + p * 4 + i) * 1e5) for i in range(4)],
                    ranges, refl, sig, nir,
                )
                out = asm.push_packet(pkt)
                if out is not None:
                    frames.append(out)
        assert len(frames) == 1
        fr = frames[0]
        filters = filters_from_params(params)
        sb = project_frame(
            jnp.asarray(fr.ranges_m),
            jnp.asarray(fr.reflectivity),
            jnp.asarray(fr.col_timestamp_s),
            jnp.asarray(fr.col_valid),
            jnp.asarray(luts.direction),
            jnp.asarray(luts.offset),
            filters,
        )
        pts = np.asarray(sb.points).reshape(16, luts.subset_channels, 3)
        mask = np.asarray(sb.mask).reshape(16, luts.subset_channels)
        # scalar oracle per reference decode semantics
        n_checked = 0
        for m_id in range(16):
            for s, c_id in enumerate(luts.subset_c_ids):
                r = float(fr.ranges_m[m_id, s])
                expect = r * luts.direction[m_id, s] + luts.offset[m_id]
                np.testing.assert_allclose(pts[m_id, s], expect, rtol=1e-6, atol=1e-6)
                keep = (
                    fr.col_valid[m_id]
                    and params.range_filter[0] <= r <= params.range_filter[1]
                    and r > 0
                )
                if keep:
                    in_box = np.all(np.abs(expect) <= 0.5)
                    z_ok = params.z_filter[0] <= expect[2] <= params.z_filter[1]
                    refl_ok = fr.reflectivity[m_id, s] >= params.reflectivity_threshold
                    keep = (not in_box) and (z_ok or refl_ok)
                assert bool(mask[m_id, s]) == bool(keep), (m_id, s)
                n_checked += 1
        assert int(sb.num_points) == mask.sum()
        assert n_checked == 16 * luts.subset_channels

    def test_packed_projection_matches_unpacked(self):
        """pack_frame + project_frame_packed == project_frame (the packed
        path is the production ingest: one host->device transfer)."""
        from slamtpu.lidar.project import pack_frame, project_frame_packed

        meta = make_meta(cols=8, pix=4, cpp=4)
        params = LidarParams()
        luts = build_luts(meta, params)
        ranges = (RNG.random((8, 4)) * 50).astype(np.float32)
        refl = RNG.integers(0, 255, (8, 4)).astype(np.uint8)
        ts = 86_000.0 + np.linspace(0.0, 0.1, 8)  # large absolute day-seconds
        valid = np.ones(8, bool)
        valid[3] = False
        filters = filters_from_params(params)
        a = project_frame(
            jnp.asarray(ranges), jnp.asarray(refl),
            jnp.asarray(ts - ts[0]),  # unpacked path gets the same re-base
            jnp.asarray(valid),
            jnp.asarray(luts.direction), jnp.asarray(luts.offset), filters,
        )
        packed = pack_frame(ranges, refl, ts, valid)
        b = project_frame_packed(
            jnp.asarray(packed), jnp.asarray(luts.direction),
            jnp.asarray(luts.offset), filters,
        )
        np.testing.assert_allclose(np.asarray(b.points), np.asarray(a.points), atol=1e-6)
        np.testing.assert_array_equal(np.asarray(b.mask), np.asarray(a.mask))
        np.testing.assert_allclose(np.asarray(b.alpha), np.asarray(a.alpha), atol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(b.reflectivity), np.asarray(a.reflectivity)
        )
        assert int(b.num_points) == int(a.num_points)

    def test_signal_nir_carried_to_scan_buffer(self):
        """Golden packets -> FrameAssembler -> packed projection: the wire
        signal/NIR words survive to the ScanBuffer unchanged (the reference's
        SoA cloud keeps all three radiometry fields per point,
        /root/reference/include/dataframe.hpp:299-434)."""
        from slamtpu.lidar.project import pack_frame, project_frame_packed

        meta = make_meta(cols=8, pix=4, cpp=4)
        params = LidarParams()
        luts = build_luts(meta, params)
        asm = FrameAssembler(meta, luts)
        fields = {}
        frames = []
        for k in range(2):
            for p in range(2):
                ranges, refl, sig, nir = random_fields(meta, 4)
                if k == 0:
                    fields[p] = (sig, nir)
                pkt = build_rng19_packet(
                    meta, k, [p * 4 + i for i in range(4)],
                    [int(1e9 + (k * 8 + p * 4 + i) * 1e5) for i in range(4)],
                    ranges, refl, sig, nir,
                )
                out = asm.push_packet(pkt)
                if out is not None:
                    frames.append(out)
        fr = frames[0]
        # decoder grid carries the wire words (subset = all channels here)
        for p, (sig, nir) in fields.items():
            np.testing.assert_array_equal(fr.signal[p * 4 : p * 4 + 4], sig)
            np.testing.assert_array_equal(fr.nir[p * 4 : p * 4 + 4], nir)
        packed = pack_frame(
            fr.ranges_m, fr.reflectivity, fr.col_timestamp_s, fr.col_valid,
            signal=fr.signal, nir=fr.nir,
        )
        sb = project_frame_packed(
            jnp.asarray(packed), jnp.asarray(luts.direction),
            jnp.asarray(luts.offset), filters_from_params(params),
        )
        assert sb.signal is not None and sb.nir is not None
        np.testing.assert_array_equal(
            np.asarray(sb.signal).reshape(8, 4), fr.signal
        )
        np.testing.assert_array_equal(np.asarray(sb.nir).reshape(8, 4), fr.nir)
        # the radiometry-free packed layout still projects identically
        sb0 = project_frame_packed(
            jnp.asarray(pack_frame(
                fr.ranges_m, fr.reflectivity, fr.col_timestamp_s, fr.col_valid
            )),
            jnp.asarray(luts.direction), jnp.asarray(luts.offset),
            filters_from_params(params),
        )
        assert sb0.signal is None and sb0.nir is None
        np.testing.assert_allclose(
            np.asarray(sb0.points), np.asarray(sb.points), atol=1e-6
        )
        np.testing.assert_array_equal(np.asarray(sb0.mask), np.asarray(sb.mask))

    def test_alpha_normalized(self):
        meta = make_meta(cols=8, pix=4, cpp=4)
        params = LidarParams()
        luts = build_luts(meta, params)
        ranges = np.ones((8, 4), np.float32)
        refl = np.zeros((8, 4), np.uint8)
        ts = np.linspace(100.0, 100.1, 8)
        sb = project_frame(
            jnp.asarray(ranges),
            jnp.asarray(refl),
            jnp.asarray(ts),
            jnp.ones(8, bool),
            jnp.asarray(luts.direction),
            jnp.asarray(luts.offset),
            ProjectionFilters(),
        )
        alpha = np.asarray(sb.alpha).reshape(8, 4)
        np.testing.assert_allclose(alpha[0], 0.0, atol=1e-6)
        np.testing.assert_allclose(alpha[-1], 1.0, atol=1e-6)
        assert (np.diff(alpha[:, 0]) > 0).all()


class TestDeskew:
    def test_identity_motion_noop(self):
        from slamtpu.core import se3
        from slamtpu.lidar.deskew import deskew_points

        pts = jnp.asarray(RNG.normal(size=(100, 3)))
        alpha = jnp.asarray(RNG.uniform(0, 1, 100))
        p = se3.expmap(jnp.asarray(RNG.normal(size=6) * 0.3))
        out = deskew_points(pts, alpha, p, p)
        np.testing.assert_allclose(np.asarray(out), np.asarray(pts), atol=1e-12)

    def test_recovers_static_world(self):
        """Points of a static world sampled from a moving sensor, deskewed to
        the end pose, must match a rigid scan taken at the end pose."""
        from slamtpu.core import se3
        from slamtpu.lidar.deskew import deskew_points

        world = jnp.asarray(RNG.uniform(-10, 10, size=(500, 3)))
        xi = jnp.asarray([0.0, 0.0, 0.2, 1.0, 0.5, 0.0])  # motion over the sweep
        pose_start = se3.expmap(jnp.asarray(RNG.normal(size=6) * 0.2))
        pose_end = se3.retract(pose_start, xi)
        alpha = jnp.asarray(RNG.uniform(0, 1, 500))
        # body-frame sample of each point at its sample time T(alpha)
        t_alpha = se3.retract(
            se3.Pose3(
                jnp.broadcast_to(pose_start.rot, (500, 3, 3)),
                jnp.broadcast_to(pose_start.trans, (500, 3)),
            ),
            alpha[:, None] * xi[None, :],
        )
        inv = se3.inverse(t_alpha)
        body = jnp.einsum("nij,nj->ni", inv.rot, world) + inv.trans
        desk = deskew_points(body, alpha, pose_start, pose_end)
        expect = se3.transform_points(se3.inverse(pose_end), world)
        np.testing.assert_allclose(np.asarray(desk), np.asarray(expect), atol=1e-10)

    def test_alpha_one_points_unchanged(self):
        from slamtpu.core import se3
        from slamtpu.lidar.deskew import deskew_points

        pts = jnp.asarray(RNG.normal(size=(50, 3)))
        start = se3.expmap(jnp.asarray(RNG.normal(size=6) * 0.3))
        end = se3.retract(start, jnp.asarray(RNG.normal(size=6) * 0.1))
        out = deskew_points(pts, jnp.ones(50), start, end)
        np.testing.assert_allclose(np.asarray(out), np.asarray(pts), atol=1e-12)


class TestPackedKeyframeStep:
    """The lo_svn single-dispatch keyframe (_lo_svn_step_packed) must equal
    the composition of its standalone pieces: project_frame_packed ->
    deskew_points -> anchor transform -> ring insert. Pins that the fused
    path actually APPLIES the deskew poses carried in flat[17:41] (a wiring
    bug there is invisible to trajectory-level e2e gates when the polish
    absorbs the residual)."""

    def _setup(self):
        from slamtpu.lidar.project import (ProjectionFilters, pack_frame,
            project_frame_packed)

        cols, sub = 16, 8
        rng = np.random.default_rng(3)
        ranges = rng.uniform(1.0, 20.0, (cols, sub)).astype(np.float32)
        refl = rng.integers(0, 255, (cols, sub)).astype(np.uint8)
        ts = np.linspace(0.0, 0.1, cols)
        valid = np.ones(cols, bool)
        direction = rng.normal(size=(cols, sub, 3)).astype(np.float32)
        direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
        offset = np.zeros((cols, 3), np.float32)
        packed = jnp.asarray(pack_frame(ranges, refl, ts, valid))
        dirs, offs = jnp.asarray(direction), jnp.asarray(offset)
        filters = ProjectionFilters(range_min=0.5, range_max=100.0)
        scan = project_frame_packed(packed, dirs, offs, filters)
        return packed, dirs, offs, filters, scan

    def _run_step(self, packed, dirs, offs, filters, N, flat, deskew):
        from slamtpu.apps.lo_svn import _lo_svn_step_packed
        from slamtpu.ndt import SvnConfig
        from slamtpu.ndt.regmap import empty_regmap

        GRID = (8, 8, 4)
        cfg = SvnConfig(num_particles=2, max_iterations=1, polish_iters=0)
        kf_points = jnp.zeros((2, N, 3), jnp.float32)
        kf_mask = jnp.zeros((2, N), bool)
        return _lo_svn_step_packed(
            kf_points, kf_mask, packed, dirs, offs,
            jnp.asarray(flat, jnp.float32), jnp.int32(1),
            jax.random.PRNGKey(0), empty_regmap(64, GRID),
            cfg, 64, 3, GRID, True, None, filters, deskew,
        )

    def test_equals_standalone_composition(self):
        from slamtpu.core import se3
        from slamtpu.lidar.deskew import deskew_points

        packed, dirs, offs, filters, scan = self._setup()
        N = scan.points.shape[0]
        pose_s = se3.expmap(jnp.asarray([0.02, -0.01, 0.05, 0.4, 0.2, -0.1]))
        pose_e = se3.retract(pose_s, jnp.asarray([0.0, 0.0, 0.1, 0.5, 0.0, 0.0]))
        eye = np.eye(3).ravel()
        flat = np.concatenate([
            eye, np.zeros(3),              # prior = identity (and INS anchor)
            np.full(3, -50.0), [0.0, 1.0],  # origin, rebuild=0, anchor=ins
            np.asarray(pose_s.rot).ravel(), np.asarray(pose_s.trans),
            np.asarray(pose_e.rot).ravel(), np.asarray(pose_e.trans),
        ])
        kf_points, kf_mask, _key, scalars, _rm = self._run_step(
            packed, dirs, offs, filters, N, flat, deskew=True
        )
        expect = deskew_points(
            scan.points.astype(jnp.float32),
            scan.alpha.astype(jnp.float32),
            se3.cast(pose_s, jnp.float32), se3.cast(pose_e, jnp.float32),
        )
        # anchor pose is identity, so the ring slot holds the deskewed body pts
        np.testing.assert_allclose(
            np.asarray(kf_points[1]), np.asarray(expect), atol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(kf_mask[1]), np.asarray(scan.mask)
        )
        assert scalars.shape == (53,)
        assert int(scalars[52]) == int(jnp.sum(scan.mask))
        # deskew=False must insert the raw projected points instead
        kf_points0, _m, _k, _s, _r = self._run_step(
            packed, dirs, offs, filters, N, flat, deskew=False
        )
        np.testing.assert_allclose(
            np.asarray(kf_points0[1]),
            np.asarray(scan.points, np.float32), atol=1e-6,
        )
        diff = np.abs(np.asarray(kf_points[1]) - np.asarray(kf_points0[1]))
        assert diff.max() > 0.01, "deskew poses had no effect"


class TestSimulatorEncoder:
    """The simulator's vectorized RNG19 encoder must stay byte-identical to
    the per-point struct.pack reference loop (the original golden encoder,
    layout per /root/reference/src/lidarcallback.cpp:632-891). The loop cost
    ~35 s of pure Python packing per Berlin-scale sweep; the numpy path is
    ~21x faster per packet."""

    def test_byte_identical_to_reference_loop(self):
        import struct
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).parent))
        import simulator
        from simulator import packet_size

        def encode_loop(meta, frame_id, m_ids, ts_ns, ranges_mm, refl):
            pix = meta.pixels_per_column
            out = bytearray()
            out += struct.pack("<HH", 0x0001, frame_id & 0xFFFF) + bytes(28)
            for c, m_id in enumerate(m_ids):
                out += struct.pack("<QHBx", int(ts_ns[c]), int(m_id), 1)
                r = ranges_mm[c].astype(np.uint32) & 0x7FFFF
                for ch in range(pix):
                    v = int(r[ch])
                    out += struct.pack(
                        "<BBBxBxHHH", v & 0xFF, (v >> 8) & 0xFF,
                        (v >> 16) & 0xFF, int(refl[c][ch]), 0, 0, 0,
                    )
            out += bytes(32)
            assert len(out) == packet_size(meta)
            return bytes(out)

        meta = simulator.small_meta(cols=64, pix=32, cpp=16)
        rng = np.random.default_rng(3)
        m_ids = list(range(16, 32))
        ts = rng.integers(0, 2**62, 16).astype(np.uint64)
        ranges = rng.integers(0, 2**20, (16, 32)).astype(np.uint32)
        refl = rng.integers(0, 255, (16, 32)).astype(np.uint8)
        assert simulator.encode_rng19_packet(
            meta, 7, m_ids, ts, ranges, refl
        ) == encode_loop(meta, 7, m_ids, ts, ranges, refl)


class TestMapExcludeRecent:
    """RegisterConfig.map_exclude_recent: rebuilds skip the newest ring
    clouds (the measured viewpoint-proximity bias).
    Pins the ring-age arithmetic: age 0 = slot (head - 1) mod K."""

    def _n_voxels(self, head, exclude):
        from slamtpu.apps.lo_svn import _lo_svn_step
        from slamtpu.ndt import SvnConfig

        K, N = 3, 8
        # each ring slot holds one spread cluster in its own 1 m voxel
        rng = np.random.default_rng(7)
        jitter = rng.uniform(-0.3, 0.3, (K, N, 3)).astype(np.float32)
        centers = (10.0 * np.arange(K) + 0.5)[:, None, None].astype(np.float32)
        kf_points = jnp.asarray(centers + jitter)
        kf_mask = jnp.ones((K, N), bool)
        new_points = jnp.full((N, 3), 40.5, jnp.float32)
        new_mask = jnp.ones((N,), bool)
        flat = np.zeros(17, np.float32)
        flat[0] = flat[4] = flat[8] = 1.0  # identity prior
        flat[15] = 1.0  # rebuild
        cfg = SvnConfig(num_particles=2, max_iterations=1, polish_iters=0)
        _p, _m, _k, scalars, _r = _lo_svn_step(
            kf_points, kf_mask, new_points, new_mask,
            jnp.asarray(flat), jnp.int32(head), jax.random.PRNGKey(0), None,
            cfg, 64, 2, None, True, None,
            None if exclude is None else jnp.int32(exclude),
        )
        return int(scalars[50])

    def test_excludes_newest_ring_clouds(self):
        assert self._n_voxels(head=0, exclude=None) == 3
        assert self._n_voxels(head=0, exclude=0) == 3
        # head=0 -> newest is slot 2, then slot 1
        assert self._n_voxels(head=0, exclude=1) == 2
        assert self._n_voxels(head=0, exclude=2) == 1
        # head=1 -> newest is slot 0
        assert self._n_voxels(head=1, exclude=1) == 2

    def test_app_clamps_during_fill_up(self):
        from slamtpu.apps import LoSvnApp
        from slamtpu.ins.imu_config import ImuConfig
        from slamtpu.lidar.ouster import LidarParams, synthetic_os2_metadata
        from slamtpu.runtime.config import PipelineConfig, RegisterConfig

        cfg = PipelineConfig(
            meta=synthetic_os2_metadata(
                columns_per_frame=32, pixels_per_column=8,
                columns_per_packet=16,
            ),
            lidar=LidarParams(),
            imu=ImuConfig(),
            register=RegisterConfig(map_exclude_recent=2, keyframe_window=4),
        )
        app = LoSvnApp(cfg)
        app._n_keyframes = 1  # only the bootstrap cloud in the ring
        assert int(app._exclude_recent()) == 0
        app._n_keyframes = 2
        assert int(app._exclude_recent()) == 1
        app._n_keyframes = 9  # ring full (window 4)
        assert int(app._exclude_recent()) == 2
