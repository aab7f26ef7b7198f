// WAL record codec: framing + CRC32 validation in native code.
//
// Port copy of native/walcodec.cc (the PyTorch port builds its own library).
//
// Behavioral reference: the upstream NornicDB pkg/storage/wal_atomic_record.go:8-39
// — the reference validates [magic][version][len][payload][crc][trailer]
// records in Go on its hot durability path; this framework keeps the same
// record layout (see nornicdb_tpu_torch/storage/wal.py) and moves the
// bytes-touching half (framing, CRC sweep, torn-tail detection) to C++,
// called from Python via ctypes. JSON payload parsing stays in Python.
//
// Record layout (must match wal.py):
//   [magic:4 = "NWAL"][version:1][oplen:4 LE][payload]
//   [crc32:4 LE over payload][seq:8 LE][pad to 8-byte boundary]
//
// Build: by nornicdb_tpu_torch/storage/native.py at first use, with g++,
// into nornicdb_tpu_torch/storage/_build/libwalcodec-<digest>.so

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t kMagic[4] = {'N', 'W', 'A', 'L'};
constexpr uint8_t kVersion = 1;
constexpr uint64_t kHeader = 9;   // magic + version + oplen
constexpr uint64_t kFooter = 12;  // crc + seq

uint32_t crc_table[256];
bool crc_ready = false;

void init_crc() {
  if (crc_ready) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_ready = true;
}

uint32_t crc32(const uint8_t* data, uint64_t n) {
  init_crc();
  uint32_t c = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < n; i++) c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

inline uint64_t rd_u64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
  return v;
}

inline void wr_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF;
  p[2] = (v >> 16) & 0xFF; p[3] = (v >> 24) & 0xFF;
}

inline void wr_u64(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; i++) { p[i] = v & 0xFF; v >>= 8; }
}

}  // namespace

extern "C" {

// Encode one record into out (capacity out_cap). Returns bytes written, or
// -1 if out_cap is too small.
int64_t wal_encode(const uint8_t* payload, uint32_t len, uint64_t seq,
                   uint8_t* out, uint64_t out_cap) {
  uint64_t body = kHeader + (uint64_t)len + kFooter;
  uint64_t total = (body + 7) & ~7ull;  // pad to 8-byte boundary
  if (total > out_cap) return -1;
  std::memcpy(out, kMagic, 4);
  out[4] = kVersion;
  wr_u32(out + 5, len);
  std::memcpy(out + kHeader, payload, len);
  wr_u32(out + kHeader + len, crc32(payload, len));
  wr_u64(out + kHeader + len + 4, seq);
  for (uint64_t i = body; i < total; i++) out[i] = 0;
  return (int64_t)total;
}

// Scan a buffer of records. For each valid record writes (payload_offset,
// payload_length, seq) into the parallel output arrays (capacity
// max_records). Stops at the first torn/corrupt record (torn-tail
// semantics — ref: wal.py read_all). Returns the number of valid records;
// sets *valid_bytes to the offset just past the last valid record.
int64_t wal_scan(const uint8_t* buf, uint64_t n, uint64_t* offsets,
                 uint64_t* lengths, uint64_t* seqs, uint64_t max_records,
                 uint64_t* valid_bytes) {
  uint64_t off = 0;
  int64_t count = 0;
  *valid_bytes = 0;
  while (off + kHeader <= n && (uint64_t)count < max_records) {
    if (std::memcmp(buf + off, kMagic, 4) != 0 || buf[off + 4] != kVersion)
      break;
    uint32_t len = rd_u32(buf + off + 5);
    uint64_t body_end = off + kHeader + (uint64_t)len + kFooter;
    if (body_end > n) break;  // torn tail
    const uint8_t* payload = buf + off + kHeader;
    uint32_t want = rd_u32(buf + off + kHeader + len);
    if (crc32(payload, len) != want) break;  // corrupt
    offsets[count] = off + kHeader;
    lengths[count] = len;
    seqs[count] = rd_u64(buf + off + kHeader + len + 4);
    count++;
    uint64_t total = (kHeader + (uint64_t)len + kFooter + 7) & ~7ull;
    off += total;
    *valid_bytes = off;
  }
  return count;
}

// Batch CRC32 (exposed for tests / future use).
uint32_t wal_crc32(const uint8_t* data, uint64_t n) { return crc32(data, n); }

}  // extern "C"
