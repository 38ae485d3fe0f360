// Native Ouster packet decoder: the host-side byte-twiddling hot path.
//
// C++ counterpart of slamtpu/lidar/ouster.py::parse_packet (wire layouts per
// /root/reference/src/lidarcallback.cpp:632-891 RNG19 and :382-630 LEGACY),
// decoding BATCHES of packets into pre-allocated column-major arrays that
// feed fixed-shape device buffers. Exposed through a plain C ABI consumed via
// ctypes (slamtpu/lidar/native.py). Unlike the reference's per-point
// push_back decode, output is dense (packet x column x subset-channel) grids
// — the device-shaped layout — so the inner loop is branch-light and
// auto-vectorizable (the AVX2 path of the reference collapses into plain
// contiguous loops the compiler vectorizes).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libouster_decode.so ouster_decode.cpp

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

constexpr double kSecondsPerDay = 86400.0;

inline uint16_t le16(const uint8_t* p) {
    return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}
inline uint32_t le32(const uint8_t* p) {
    return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}
inline uint64_t le64(const uint8_t* p) {
    uint64_t v = 0;
    for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
    return v;
}

}  // namespace

extern "C" {

// Decode n_packets RNG19_RFL8_SIG16_NIR16 packets (each packet_bytes long,
// concatenated in `data`). Outputs are (n_packets * columns_per_packet) rows
// by n_subset channels. pkt_ok[p] = 0 marks a rejected packet (size/type).
int ouster_decode_rng19(
    const uint8_t* data, int64_t packet_bytes, int64_t n_packets,
    int32_t pixels_per_column, int32_t columns_per_packet,
    int32_t columns_per_frame,
    const int32_t* subset_ids, int32_t n_subset,
    uint16_t* frame_ids, double* ts_s, int32_t* m_ids, uint8_t* col_valid,
    float* ranges_m, uint8_t* refl, uint16_t* signal, uint16_t* nir,
    uint8_t* pkt_ok) {
    const int64_t block = 12 + static_cast<int64_t>(pixels_per_column) * 12;
    const int64_t expected = 32 + columns_per_packet * block + 32;
    if (packet_bytes != expected) return -1;
    for (int64_t p = 0; p < n_packets; ++p) {
        const uint8_t* pkt = data + p * packet_bytes;
        const uint16_t ptype = le16(pkt);
        const uint16_t fid = le16(pkt + 2);
        const bool ok = (ptype == 0x0001);
        pkt_ok[p] = ok ? 1 : 0;
        for (int64_t c = 0; c < columns_per_packet; ++c) {
            const int64_t row = p * columns_per_packet + c;
            const uint8_t* col = pkt + 32 + c * block;
            const uint64_t ts_ns = le64(col);
            const double ts = std::fmod(static_cast<double>(ts_ns) * 1e-9, kSecondsPerDay);
            const uint16_t m_id = le16(col + 8);
            const bool cv = ok && (col[10] & 0x01) && (m_id < columns_per_frame) && ts >= 0.0;
            frame_ids[row] = fid;
            ts_s[row] = ts;
            m_ids[row] = m_id;
            col_valid[row] = cv ? 1 : 0;
            const uint8_t* chans = col + 12;
            float* r_out = ranges_m + row * n_subset;
            uint8_t* f_out = refl + row * n_subset;
            uint16_t* s_out = signal + row * n_subset;
            uint16_t* n_out = nir + row * n_subset;
            for (int32_t s = 0; s < n_subset; ++s) {
                const uint8_t* ch = chans + static_cast<int64_t>(subset_ids[s]) * 12;
                const uint32_t range_mm =
                    (static_cast<uint32_t>(ch[0]) | (static_cast<uint32_t>(ch[1]) << 8) |
                     (static_cast<uint32_t>(ch[2]) << 16)) & 0x0007FFFFu;
                r_out[s] = static_cast<float>(range_mm) * 1e-3f;
                f_out[s] = ch[4];
                s_out[s] = le16(ch + 6);
                n_out[s] = le16(ch + 8);
            }
        }
    }
    return 0;
}

// LEGACY profile: 16 B column header (ts, m_id, frame_id), 4 B block status
// (0xFFFFFFFF = valid), 20-bit range.
int ouster_decode_legacy(
    const uint8_t* data, int64_t packet_bytes, int64_t n_packets,
    int32_t pixels_per_column, int32_t columns_per_packet,
    int32_t columns_per_frame,
    const int32_t* subset_ids, int32_t n_subset,
    uint16_t* frame_ids, double* ts_s, int32_t* m_ids, uint8_t* col_valid,
    float* ranges_m, uint8_t* refl, uint16_t* signal, uint16_t* nir,
    uint8_t* pkt_ok) {
    const int64_t block = 16 + static_cast<int64_t>(pixels_per_column) * 12 + 4;
    const int64_t expected = columns_per_packet * block;
    if (packet_bytes != expected) return -1;
    for (int64_t p = 0; p < n_packets; ++p) {
        const uint8_t* pkt = data + p * packet_bytes;
        pkt_ok[p] = 1;
        for (int64_t c = 0; c < columns_per_packet; ++c) {
            const int64_t row = p * columns_per_packet + c;
            const uint8_t* col = pkt + c * block;
            const uint64_t ts_ns = le64(col);
            const double ts = std::fmod(static_cast<double>(ts_ns) * 1e-9, kSecondsPerDay);
            const uint16_t m_id = le16(col + 8);
            const uint16_t fid = le16(col + 10);
            const uint32_t status = le32(col + 16 + static_cast<int64_t>(pixels_per_column) * 12);
            const bool cv = (status == 0xFFFFFFFFu) && (m_id < columns_per_frame) && ts >= 0.0;
            frame_ids[row] = fid;
            ts_s[row] = ts;
            m_ids[row] = m_id;
            col_valid[row] = cv ? 1 : 0;
            const uint8_t* chans = col + 16;
            float* r_out = ranges_m + row * n_subset;
            uint8_t* f_out = refl + row * n_subset;
            uint16_t* s_out = signal + row * n_subset;
            uint16_t* n_out = nir + row * n_subset;
            for (int32_t s = 0; s < n_subset; ++s) {
                const uint8_t* ch = chans + static_cast<int64_t>(subset_ids[s]) * 12;
                const uint32_t range_mm = le32(ch) & 0x000FFFFFu;
                r_out[s] = static_cast<float>(range_mm) * 1e-3f;
                f_out[s] = ch[4];
                s_out[s] = le16(ch + 6);
                n_out[s] = le16(ch + 8);
            }
        }
    }
    return 0;
}

}  // extern "C"
