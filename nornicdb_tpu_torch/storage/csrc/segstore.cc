// Append-only segment KV store: the native durable storage engine.
//
// Port copy of native/segstore.cc (the PyTorch port builds its own library).
//
// Behavioral reference: the reference persists its graph in BadgerDB (an
// LSM KV, pkg/storage/badger.go) with single-byte key prefixes per record
// kind. This is the native equivalent here: a C++ append-only
// segment file with an in-memory key index, CRC-validated records,
// tombstone deletes and offline compaction. Payload bytes never cross the
// FFI during scans/compaction — the lesson from walcodec (see
// storage/native.py) is that native only pays when the data stays native.
//
// Record: [u32 klen][u32 vlen][key bytes][value bytes][u32 crc32(key+value)]
//         vlen == 0xFFFFFFFF marks a tombstone (no value bytes).
// A torn/corrupt tail terminates recovery at the last good record.
//
// Reads go through a read-only mmap of the file (remapped as appends grow
// it; FILE* fallback when mmap is unavailable) — the role of Badger's
// value-log mmap. Compaction is TWO-PHASE so it runs online (the role of
// Badger's background GC, pkg/storage/badger.go:67): phase 1 copies a
// snapshot of the live index to a temp file WITHOUT the store lock (the
// file is append-only, so snapshot offsets are immutable); phase 2 takes
// the lock only to replay the delta (keys added/changed/deleted during
// phase 1), fsync, and atomically swap. Readers and writers are blocked
// only for the delta, not the full rewrite.
//
// Build: by nornicdb_tpu_torch/storage/native.py at first use, with g++,
// into nornicdb_tpu_torch/storage/_build/libsegstore-<digest>.so

#include <cstdint>
#ifndef _WIN32
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#endif
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kTombstone = 0xFFFFFFFFu;

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

uint32_t crc32_update(uint32_t c, const uint8_t* data, uint64_t n) {
  for (uint64_t i = 0; i < n; i++) c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c;
}

uint32_t crc32_of(const uint8_t* a, uint64_t an, const uint8_t* b, uint64_t bn) {
  init_crc();
  uint32_t c = 0xFFFFFFFFu;
  c = crc32_update(c, a, an);
  c = crc32_update(c, b, bn);
  return c ^ 0xFFFFFFFFu;
}

struct Entry {
  uint64_t offset;  // offset of the VALUE bytes in the file
  uint32_t len;
};

struct Store {
  std::mutex mu;
  std::string path;
  FILE* f = nullptr;   // append handle
  FILE* rf = nullptr;  // persistent read handle (mmap fallback)
  std::unordered_map<std::string, Entry> index;
  uint64_t valid_bytes = 0;
  uint64_t tombstones = 0;  // dead records: deletes AND overwritten versions
  bool sync = false;
  bool compacting = false;  // one online compaction at a time
  uint8_t* map = nullptr;   // read-only view of the segment file
  uint64_t map_len = 0;
};

#ifndef _WIN32
void unmap_locked(Store* s) {
  if (s->map) {
    munmap(s->map, s->map_len);
    s->map = nullptr;
    s->map_len = 0;
  }
}

// (Re)map the file read-only at its current size; returns true when the
// mapping covers `need` bytes. Appends via FILE* land in the same page
// cache, so an existing mapping stays coherent for already-covered bytes.
bool remap_locked(Store* s, uint64_t need) {
  unmap_locked(s);
  int fd = open(s->path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return false;
  }
  void* m = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                 MAP_SHARED, fd, 0);
  close(fd);
  if (m == MAP_FAILED) return false;
  s->map = static_cast<uint8_t*>(m);
  s->map_len = static_cast<uint64_t>(st.st_size);
  return need <= s->map_len;
}
#else
void unmap_locked(Store*) {}
bool remap_locked(Store*, uint64_t) { return false; }
#endif

bool read_exact(FILE* f, void* buf, uint64_t n) {
  return std::fread(buf, 1, n, f) == n;
}

// Scan the file, rebuilding the index; truncates state at the first bad
// record. Returns false only on open failure.
bool load(Store* s) {
  FILE* f = std::fopen(s->path.c_str(), "rb");
  if (!f) {
    s->valid_bytes = 0;
    return true;  // fresh store
  }
  std::vector<uint8_t> key, val;
  uint64_t off = 0;
  while (true) {
    uint32_t klen, vlen;
    if (!read_exact(f, &klen, 4) || !read_exact(f, &vlen, 4)) break;
    bool tomb = vlen == kTombstone;
    uint32_t real_vlen = tomb ? 0 : vlen;
    if (klen > (1u << 24) || real_vlen > (1u << 30)) break;  // sanity
    key.resize(klen);
    val.resize(real_vlen);
    if (klen && !read_exact(f, key.data(), klen)) break;
    if (real_vlen && !read_exact(f, val.data(), real_vlen)) break;
    uint32_t want;
    if (!read_exact(f, &want, 4)) break;
    if (crc32_of(key.data(), klen, val.data(), real_vlen) != want) break;
    std::string k(reinterpret_cast<char*>(key.data()), klen);
    if (tomb) {
      s->index.erase(k);
      s->tombstones++;
    } else {
      if (s->index.count(k)) s->tombstones++;  // stale version is garbage
      s->index[k] = Entry{off + 8 + klen, real_vlen};
    }
    off += 8 + klen + real_vlen + 4;
  }
  std::fclose(f);
  s->valid_bytes = off;
  return true;
}

bool append_record(Store* s, const uint8_t* key, uint32_t klen,
                   const uint8_t* val, uint32_t vlen, bool tomb) {
  if (!s->f) return false;
  uint32_t wire_vlen = tomb ? kTombstone : vlen;
  uint32_t real_vlen = tomb ? 0 : vlen;
  uint32_t crc = crc32_of(key, klen, val, real_vlen);
  if (std::fwrite(&klen, 1, 4, s->f) != 4) return false;
  if (std::fwrite(&wire_vlen, 1, 4, s->f) != 4) return false;
  if (klen && std::fwrite(key, 1, klen, s->f) != klen) return false;
  if (real_vlen && std::fwrite(val, 1, real_vlen, s->f) != real_vlen) return false;
  if (std::fwrite(&crc, 1, 4, s->f) != 4) return false;
  if (std::fflush(s->f) != 0) return false;
#ifndef _WIN32
  if (s->sync && fsync(fileno(s->f)) != 0) return false;
#endif
  return true;
}

}  // namespace

extern "C" {

void* seg_open(const char* path) {
  auto* s = new Store();
  s->path = path;
  // a crash mid-compaction leaves a stale temp file; the live store is the
  // source of truth, so drop it
  std::remove((s->path + ".compact").c_str());
  if (!load(s)) {
    delete s;
    return nullptr;
  }
  // truncate any torn tail so appends extend from the last good record
  FILE* f = std::fopen(path, "rb+");
  if (f) {
#ifdef _WIN32
    std::fclose(f);
#else
    if (std::fseek(f, 0, SEEK_END) == 0) {
      long end = std::ftell(f);
      if (end >= 0 && static_cast<uint64_t>(end) > s->valid_bytes) {
        (void)!ftruncate(fileno(f), static_cast<off_t>(s->valid_bytes));
      }
    }
    std::fclose(f);
#endif
  }
  s->f = std::fopen(path, "ab");
  if (!s->f) {
    delete s;
    return nullptr;
  }
  s->rf = std::fopen(path, "rb");  // may be null for a fresh empty store
  return s;
}

void seg_set_sync(void* handle, int32_t enabled) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  s->sync = enabled != 0;
}

void seg_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  unmap_locked(s);
  if (s->f) std::fclose(s->f);
  if (s->rf) std::fclose(s->rf);
  delete s;
}

int32_t seg_put(void* handle, const uint8_t* key, uint32_t klen,
                const uint8_t* val, uint32_t vlen) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  uint64_t value_off = s->valid_bytes + 8 + klen;
  if (!append_record(s, key, klen, val, vlen, false)) return -1;
  std::string k(reinterpret_cast<const char*>(key), klen);
  if (s->index.count(k)) s->tombstones++;  // stale version is garbage
  s->index[k] = Entry{value_off, vlen};
  s->valid_bytes += 8ull + klen + vlen + 4;
  if (!s->rf) s->rf = std::fopen(s->path.c_str(), "rb");
  return 0;
}

// Single-call read: copies the value into out when it fits and returns its
// length; returns -1 when the key is absent, -(length)-2 when out_cap is too
// small (caller grows the buffer and retries — the mutex makes each attempt
// consistent), -2 on IO failure.
int64_t seg_get(void* handle, const uint8_t* key, uint32_t klen,
                uint8_t* out, uint64_t out_cap) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->index.find(std::string(reinterpret_cast<const char*>(key), klen));
  if (it == s->index.end()) return -1;
  const Entry& e = it->second;
  if (e.len == 0) return 0;
  if (out_cap < e.len) return -static_cast<int64_t>(e.len) - 2;
  // mmap fast path (remap when appends have grown the file past the view)
  if (e.offset + e.len > s->map_len) remap_locked(s, e.offset + e.len);
  if (s->map && e.offset + e.len <= s->map_len) {
    std::memcpy(out, s->map + e.offset, e.len);
    return e.len;
  }
  if (!s->rf) s->rf = std::fopen(s->path.c_str(), "rb");
  if (!s->rf) return -2;
  if (std::fseek(s->rf, static_cast<long>(e.offset), SEEK_SET) != 0) return -2;
  if (std::fread(out, 1, e.len, s->rf) != e.len) return -2;
  return e.len;
}

int32_t seg_delete(void* handle, const uint8_t* key, uint32_t klen) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  std::string k(reinterpret_cast<const char*>(key), klen);
  auto it = s->index.find(k);
  if (it == s->index.end()) return -1;
  if (!append_record(s, key, klen, nullptr, 0, true)) return -2;
  s->index.erase(it);
  s->tombstones++;
  s->valid_bytes += 8ull + klen + 4;
  return 0;
}

uint64_t seg_count(void* handle) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->index.size();
}

uint64_t seg_tombstones(void* handle) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->tombstones;
}

// Iterate keys (optionally by prefix). Output is length-prefixed
// ([u32 klen][key bytes])* so keys may contain any byte. Returns bytes
// written, or the negative of the required capacity when out_cap is small.
int64_t seg_keys(void* handle, const uint8_t* prefix, uint32_t plen,
                 uint8_t* out, uint64_t out_cap) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  uint64_t need = 0;
  for (const auto& kv : s->index) {
    if (plen && (kv.first.size() < plen ||
                 std::memcmp(kv.first.data(), prefix, plen) != 0))
      continue;
    need += 4 + kv.first.size();
  }
  if (need > out_cap) return -static_cast<int64_t>(need);
  uint64_t off = 0;
  for (const auto& kv : s->index) {
    if (plen && (kv.first.size() < plen ||
                 std::memcmp(kv.first.data(), prefix, plen) != 0))
      continue;
    uint32_t klen = static_cast<uint32_t>(kv.first.size());
    std::memcpy(out + off, &klen, 4);
    off += 4;
    std::memcpy(out + off, kv.first.data(), klen);
    off += klen;
  }
  return static_cast<int64_t>(off);
}

namespace {

// Copy one live record from `in` to `out`; updates idx/off. Payload bytes
// never leave C++.
bool copy_record(FILE* in, FILE* out, const std::string& k, const Entry& e,
                 std::unordered_map<std::string, Entry>& idx,
                 uint64_t& new_off, std::vector<uint8_t>& val) {
  val.resize(e.len);
  if (std::fseek(in, static_cast<long>(e.offset), SEEK_SET) != 0) return false;
  if (e.len && std::fread(val.data(), 1, e.len, in) != e.len) return false;
  uint32_t klen = static_cast<uint32_t>(k.size());
  uint32_t vlen = e.len;
  uint32_t crc = crc32_of(reinterpret_cast<const uint8_t*>(k.data()), klen,
                          val.data(), vlen);
  if (std::fwrite(&klen, 1, 4, out) != 4 ||
      std::fwrite(&vlen, 1, 4, out) != 4 ||
      std::fwrite(k.data(), 1, klen, out) != klen ||
      (vlen && std::fwrite(val.data(), 1, vlen, out) != vlen) ||
      std::fwrite(&crc, 1, 4, out) != 4)
    return false;
  idx[k] = Entry{new_off + 8 + klen, vlen};
  new_off += 8ull + klen + vlen + 4;
  return true;
}

}  // namespace

// Online compaction: rewrite only live records (drops tombstones + stale
// versions). Two-phase — the store lock is held only while replaying the
// delta of writes that landed during the snapshot copy, so concurrent
// readers/writers are not blocked by the bulk rewrite (the role of
// Badger's background value-log GC, pkg/storage/badger.go:67).
int32_t seg_compact(void* handle) {
  auto* s = static_cast<Store*>(handle);
  std::string path;
  std::unordered_map<std::string, Entry> snap;
  {
    std::lock_guard<std::mutex> lock(s->mu);
    if (s->compacting) return -3;
    s->compacting = true;
    snap = s->index;
    path = s->path;
  }
  std::string tmp = path + ".compact";
  FILE* out = std::fopen(tmp.c_str(), "wb");
  FILE* in = std::fopen(path.c_str(), "rb");
  std::unordered_map<std::string, Entry> written;
  uint64_t new_off = 0;
  std::vector<uint8_t> val;
  bool ok = out && in;
  // phase 1 (unlocked): snapshot offsets are immutable in an append-only
  // file, so the copy races nothing
  if (ok) {
    for (const auto& kv : snap) {
      if (!copy_record(in, out, kv.first, kv.second, written, new_off, val)) {
        ok = false;
        break;
      }
    }
  }
  {
    std::lock_guard<std::mutex> lock(s->mu);
    s->compacting = false;
    if (ok) {
      // phase 2 (locked): keep only entries still current, append the
      // records that changed/arrived during phase 1, swap atomically
      std::unordered_map<std::string, Entry> new_index;
      uint64_t dead = 0;
      for (const auto& kv : written) {
        auto it = s->index.find(kv.first);
        const auto sit = snap.find(kv.first);
        if (it != s->index.end() && sit != snap.end() &&
            it->second.offset == sit->second.offset &&
            it->second.len == sit->second.len) {
          new_index[kv.first] = kv.second;
        } else {
          dead++;  // deleted or overwritten while phase 1 ran
        }
      }
      for (const auto& kv : s->index) {
        if (new_index.count(kv.first)) continue;
        if (!copy_record(in, out, kv.first, kv.second, new_index, new_off,
                         val)) {
          ok = false;
          break;
        }
      }
      ok = ok && std::fflush(out) == 0;
#ifndef _WIN32
      ok = ok && fsync(fileno(out)) == 0;
#endif
      if (ok) {
        std::fclose(in);
        in = nullptr;
        std::fclose(out);
        out = nullptr;
        unmap_locked(s);
        std::fclose(s->f);
        if (s->rf) {
          std::fclose(s->rf);
          s->rf = nullptr;
        }
        if (std::rename(tmp.c_str(), path.c_str()) != 0) {
          s->f = std::fopen(path.c_str(), "ab");
          return s->f ? -1 : -2;
        }
        s->f = std::fopen(path.c_str(), "ab");
        s->rf = std::fopen(path.c_str(), "rb");
        s->index = std::move(new_index);
        s->valid_bytes = new_off;
        s->tombstones = dead;
        return s->f ? 0 : -2;
      }
    }
  }
  if (in) std::fclose(in);
  if (out) std::fclose(out);
  std::remove(tmp.c_str());  // abort: the live store is untouched
  return -1;
}

}  // extern "C"
