// Minimal native LMDB (data.mdb) core: mmap'd read-only parser + bulk
// writer. The MMF dataset zoo ships region features as LMDB environments
// (reference tools/scripts/features/lmdb_conversion.py; readers
// feature_readers.py:218-265); the port does not depend on the lmdb
// package, so it reads and writes the on-disk format directly.
//
// Format (LMDB 0.9, 64-bit, 4096-byte pages):
//   page 0/1: meta pages — magic 0xBEEFC0DE, version 1, MDB_db[2]
//             (FREE, MAIN), last_pg, txnid; readers use the meta with the
//             larger txnid.
//   B+tree:   branch pages (P_BRANCH) hold [first-key -> child pgno]
//             nodes (48-bit pgno in lo/hi/flags), leaf pages (P_LEAF)
//             hold [key -> data] nodes; F_BIGDATA nodes store an 8-byte
//             overflow pgno whose P_OVERFLOW pages carry the value
//             contiguously after one 16-byte header.
//
// Build: cc -O2 -shared -fPIC -o liblmdbcore.so lmdb_core.cc

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t MDB_MAGIC = 0xBEEFC0DE;
constexpr uint32_t MDB_DATA_VERSION = 1;
constexpr size_t PAGEHDRSZ = 16;
constexpr uint16_t P_BRANCH = 0x01;
constexpr uint16_t P_LEAF = 0x02;
constexpr uint16_t P_OVERFLOW = 0x04;
constexpr uint16_t P_META = 0x08;
constexpr uint16_t F_BIGDATA = 0x01;
constexpr uint64_t P_INVALID = ~uint64_t(0);

#pragma pack(push, 1)
struct MdbPageHdr {
  uint64_t pgno;
  uint16_t pad;
  uint16_t flags;
  union {
    struct {
      uint16_t lower;  // offset past last ptr slot (from page start)
      uint16_t upper;  // offset of lowest node (from page start)
    } pb;
    uint32_t pages;  // overflow page count
  };
};

struct MdbDb {
  uint32_t pad;
  uint16_t flags;
  uint16_t depth;
  uint64_t branch_pages;
  uint64_t leaf_pages;
  uint64_t overflow_pages;
  uint64_t entries;
  uint64_t root;
};

struct MdbMeta {
  uint32_t magic;
  uint32_t version;
  uint64_t address;
  uint64_t mapsize;
  MdbDb dbs[2];  // FREE, MAIN
  uint64_t last_pg;
  uint64_t txnid;
};
#pragma pack(pop)

static_assert(sizeof(MdbDb) == 48, "MDB_db layout");
static_assert(sizeof(MdbMeta) == 24 + 96 + 16, "MDB_meta layout");

struct Env {
  uint8_t* map = nullptr;
  size_t map_size = 0;
  size_t psize = 4096;
  MdbDb main{};
};

inline const MdbPageHdr* page(const Env* e, uint64_t pgno) {
  if ((pgno + 1) * e->psize > e->map_size) return nullptr;
  return reinterpret_cast<const MdbPageHdr*>(e->map + pgno * e->psize);
}

inline uint16_t numkeys(const MdbPageHdr* p) {
  return (p->pb.lower - PAGEHDRSZ) >> 1;
}

inline const uint16_t* ptrs(const MdbPageHdr* p) {
  return reinterpret_cast<const uint16_t*>(
      reinterpret_cast<const uint8_t*>(p) + PAGEHDRSZ);
}

struct Node {
  uint64_t child_or_size;  // branch: child pgno; leaf: data size
  uint16_t flags;
  const uint8_t* key;
  uint16_t ksize;
  const uint8_t* data;  // leaf only (inline data or 8-byte overflow pgno)
};

inline Node node_at(const MdbPageHdr* p, unsigned i) {
  const uint8_t* base = reinterpret_cast<const uint8_t*>(p);
  const uint8_t* n = base + ptrs(p)[i];
  Node out{};
  uint16_t lo, hi, flags, ksize;
  memcpy(&lo, n, 2);
  memcpy(&hi, n + 2, 2);
  memcpy(&flags, n + 4, 2);
  memcpy(&ksize, n + 6, 2);
  out.flags = flags;
  out.ksize = ksize;
  out.key = n + 8;
  if (p->flags & P_BRANCH) {
    // 48-bit child pgno: lo | hi<<16 | flags<<32
    out.child_or_size =
        uint64_t(lo) | (uint64_t(hi) << 16) | (uint64_t(flags) << 32);
  } else {
    out.child_or_size = uint64_t(lo) | (uint64_t(hi) << 16);
    out.data = n + 8 + ksize;
  }
  return out;
}

inline int keycmp(const uint8_t* a, size_t alen, const uint8_t* b,
                  size_t blen) {
  size_t m = alen < blen ? alen : blen;
  int c = memcmp(a, b, m);
  if (c) return c;
  return alen < blen ? -1 : (alen > blen ? 1 : 0);
}

}  // namespace

extern "C" {

void* lmdb_open(const char* path) {
  std::string file = path;
  struct stat st;
  if (stat(file.c_str(), &st) == 0 && S_ISDIR(st.st_mode)) {
    file += "/data.mdb";
  }
  int fd = open(file.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  if (fstat(fd, &st) != 0 || st.st_size < 8192) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return nullptr;

  Env* e = new Env();
  e->map = static_cast<uint8_t*>(map);
  e->map_size = st.st_size;

  // meta pages: offsets PAGEHDRSZ into pages 0 and 1; page size is not
  // stored, but meta always fits the minimum 4096 bytes
  const MdbMeta* m0 =
      reinterpret_cast<const MdbMeta*>(e->map + PAGEHDRSZ);
  const MdbMeta* m1 =
      reinterpret_cast<const MdbMeta*>(e->map + 4096 + PAGEHDRSZ);
  const MdbMeta* meta = nullptr;
  if (m0->magic == MDB_MAGIC) meta = m0;
  if (m1->magic == MDB_MAGIC && (!meta || m1->txnid > m0->txnid)) meta = m1;
  if (!meta || meta->version != MDB_DATA_VERSION) {
    munmap(map, st.st_size);
    delete e;
    return nullptr;
  }
  e->main = meta->dbs[1];
  return e;
}

void lmdb_close(void* handle) {
  Env* e = static_cast<Env*>(handle);
  if (!e) return;
  if (e->map) munmap(e->map, e->map_size);
  delete e;
}

long long lmdb_entries(void* handle) {
  Env* e = static_cast<Env*>(handle);
  return e ? (long long)e->main.entries : -1;
}

// Returns data length and sets *out to a pointer INTO the map (valid
// until lmdb_close); -1 if the key is absent.
long long lmdb_get(void* handle, const uint8_t* key, size_t klen,
                   const uint8_t** out) {
  Env* e = static_cast<Env*>(handle);
  if (!e || e->main.root == P_INVALID) return -1;
  const MdbPageHdr* p = page(e, e->main.root);
  while (p && (p->flags & P_BRANCH)) {
    unsigned n = numkeys(p);
    // find last child whose first-key <= key (node 0 has empty key)
    unsigned lo = 1, hi = n, pick = 0;
    while (lo < hi) {
      unsigned mid = (lo + hi) / 2;
      Node nd = node_at(p, mid);
      if (keycmp(nd.key, nd.ksize, key, klen) <= 0) {
        pick = mid;
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    p = page(e, node_at(p, pick).child_or_size);
  }
  if (!p || !(p->flags & P_LEAF)) return -1;
  unsigned n = numkeys(p);
  unsigned lo = 0, hi = n;
  while (lo < hi) {
    unsigned mid = (lo + hi) / 2;
    Node nd = node_at(p, mid);
    int c = keycmp(nd.key, nd.ksize, key, klen);
    if (c == 0) {
      if (nd.flags & F_BIGDATA) {
        uint64_t opgno;
        memcpy(&opgno, nd.data, 8);
        const MdbPageHdr* op = page(e, opgno);
        if (!op || !(op->flags & P_OVERFLOW)) return -1;
        *out = reinterpret_cast<const uint8_t*>(op) + PAGEHDRSZ;
      } else {
        *out = nd.data;
      }
      return (long long)nd.child_or_size;
    }
    if (c < 0)
      lo = mid + 1;
    else
      hi = mid;
  }
  return -1;
}

// ---- cursor: depth-first in-order iteration over all leaf entries ----
struct Cursor {
  Env* env;
  struct Frame {
    uint64_t pgno;
    unsigned idx;
  };
  std::vector<Frame> stack;
  bool done = false;
};

void* lmdb_cursor_open(void* handle) {
  Env* e = static_cast<Env*>(handle);
  Cursor* c = new Cursor();
  c->env = e;
  if (!e || e->main.root == P_INVALID) {
    c->done = true;
    return c;
  }
  // descend to the leftmost leaf
  uint64_t pgno = e->main.root;
  while (true) {
    const MdbPageHdr* p = page(e, pgno);
    if (!p) {
      c->done = true;
      return c;
    }
    c->stack.push_back({pgno, 0});
    if (p->flags & P_LEAF) break;
    pgno = node_at(p, 0).child_or_size;
  }
  return c;
}

int lmdb_cursor_next(void* cursor, const uint8_t** key, size_t* klen,
                     const uint8_t** val, size_t* vlen) {
  Cursor* c = static_cast<Cursor*>(cursor);
  if (!c || c->done || c->stack.empty()) return 0;
  Env* e = c->env;

  while (!c->stack.empty()) {
    auto& top = c->stack.back();
    const MdbPageHdr* p = page(e, top.pgno);
    if (!p) break;
    if (p->flags & P_LEAF) {
      if (top.idx < numkeys(p)) {
        Node nd = node_at(p, top.idx++);
        *key = nd.key;
        *klen = nd.ksize;
        if (nd.flags & F_BIGDATA) {
          uint64_t opgno;
          memcpy(&opgno, nd.data, 8);
          const MdbPageHdr* op = page(e, opgno);
          if (!op) break;
          *val = reinterpret_cast<const uint8_t*>(op) + PAGEHDRSZ;
        } else {
          *val = nd.data;
        }
        *vlen = nd.child_or_size;
        return 1;
      }
      c->stack.pop_back();
      // advance the parent branch
      while (!c->stack.empty()) {
        auto& parent = c->stack.back();
        const MdbPageHdr* bp = page(e, parent.pgno);
        parent.idx += 1;
        if (bp && parent.idx < numkeys(bp)) {
          // descend leftmost under the next child
          uint64_t pgno = node_at(bp, parent.idx).child_or_size;
          while (true) {
            const MdbPageHdr* np = page(e, pgno);
            if (!np) {
              c->done = true;
              return 0;
            }
            c->stack.push_back({pgno, 0});
            if (np->flags & P_LEAF) break;
            pgno = node_at(np, 0).child_or_size;
          }
          break;
        }
        c->stack.pop_back();
      }
      if (c->stack.empty()) {
        c->done = true;
        return 0;
      }
      continue;
    }
    break;  // corrupt structure
  }
  c->done = true;
  return 0;
}

void lmdb_cursor_close(void* cursor) {
  delete static_cast<Cursor*>(cursor);
}

// ---------------------------------------------------------------------
// Bulk writer: one transaction's worth of sorted (key, value) pairs laid
// out bottom-up (leaf pages -> branch levels -> metas). Produces a file
// any stock LMDB can open read-only.
// ---------------------------------------------------------------------
namespace {

struct Writer {
  std::string path;
  size_t psize = 4096;
  std::vector<std::pair<std::string, std::string>> items;
};

inline size_t even(size_t n) { return (n + 1) & ~size_t(1); }

void put_page_hdr(uint8_t* page_buf, uint64_t pgno, uint16_t flags,
                  uint16_t lower, uint16_t upper) {
  MdbPageHdr h{};
  h.pgno = pgno;
  h.flags = flags;
  h.pb.lower = lower;
  h.pb.upper = upper;
  memcpy(page_buf, &h, sizeof(h));
}

}  // namespace

void* lmdb_writer_open(const char* path) {
  Writer* w = new Writer();
  w->path = path;
  return w;
}

int lmdb_writer_put(void* handle, const uint8_t* key, size_t klen,
                    const uint8_t* val, size_t vlen) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w || klen == 0 || klen > 511) return -1;
  w->items.emplace_back(
      std::string(reinterpret_cast<const char*>(key), klen),
      std::string(reinterpret_cast<const char*>(val), vlen));
  return 0;
}

// Writes data.mdb (creating the directory file path directly). Returns 0
// on success.
int lmdb_writer_commit(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  const size_t psize = w->psize;
  const size_t nodemax = (psize - PAGEHDRSZ) / 2 & ~size_t(1);  // 2040

  std::sort(w->items.begin(), w->items.end(),
            [](const auto& a, const auto& b) {
              int c = memcmp(a.first.data(), b.first.data(),
                             std::min(a.first.size(), b.first.size()));
              if (c) return c < 0;
              return a.first.size() < b.first.size();
            });

  std::string file = w->path;
  struct stat st;
  if (stat(file.c_str(), &st) == 0 && S_ISDIR(st.st_mode)) {
    file += "/data.mdb";
  }
  FILE* f = fopen(file.c_str(), "wb");
  if (!f) return -1;

  std::vector<uint8_t> buf(psize, 0);
  uint64_t next_pgno = 2;  // 0/1 reserved for metas
  uint64_t n_leaf = 0, n_branch = 0, n_overflow = 0;

  // pass 1: assign overflow pages and pack leaves
  struct LeafEntry {
    const std::string* key;
    const std::string* val;
    bool big;
    uint64_t opgno;
  };
  std::vector<LeafEntry> entries;
  entries.reserve(w->items.size());
  std::vector<std::pair<std::string, uint64_t>> level;  // first key -> pgno

  // reserve overflow pages first so leaf nodes know their pgno targets
  fseek(f, 2 * psize, SEEK_SET);
  for (auto& kv : w->items) {
    LeafEntry le{&kv.first, &kv.second, false, 0};
    size_t nsize = 8 + kv.first.size() + kv.second.size();
    if (nsize > nodemax) {
      le.big = true;
      le.opgno = next_pgno;
      size_t opages = (kv.second.size() + psize - PAGEHDRSZ - 1) /
                      (psize - PAGEHDRSZ);
      // overflow data is CONTIGUOUS after ONE header page-start
      opages = (PAGEHDRSZ + kv.second.size() + psize - 1) / psize;
      // write overflow chain
      std::vector<uint8_t> obuf(opages * psize, 0);
      MdbPageHdr oh{};
      oh.pgno = next_pgno;
      oh.flags = P_OVERFLOW;
      oh.pages = (uint32_t)opages;
      memcpy(obuf.data(), &oh, sizeof(oh));
      memcpy(obuf.data() + PAGEHDRSZ, kv.second.data(), kv.second.size());
      fseek(f, next_pgno * psize, SEEK_SET);
      fwrite(obuf.data(), 1, obuf.size(), f);
      next_pgno += opages;
      n_overflow += opages;
    }
    entries.push_back(le);
  }

  // pack leaf pages
  {
    size_t i = 0;
    while (i < entries.size()) {
      uint64_t pgno = next_pgno++;
      n_leaf++;
      std::fill(buf.begin(), buf.end(), 0);
      uint16_t lower = PAGEHDRSZ;
      uint16_t upper = (uint16_t)psize;
      std::vector<uint16_t> offs;
      std::string first_key = *entries[i].key;
      while (i < entries.size()) {
        const LeafEntry& le = entries[i];
        size_t dlen = le.big ? 8 : le.val->size();
        size_t nsize = even(8 + le.key->size() + dlen);
        if (lower + 2 + nsize > upper) break;
        upper -= (uint16_t)nsize;
        offs.push_back(upper);
        uint8_t* n = buf.data() + upper;
        uint64_t dsize = le.val->size();
        uint16_t lo = dsize & 0xFFFF, hi = (dsize >> 16) & 0xFFFF;
        uint16_t flags = le.big ? F_BIGDATA : 0;
        uint16_t ksize = (uint16_t)le.key->size();
        memcpy(n, &lo, 2);
        memcpy(n + 2, &hi, 2);
        memcpy(n + 4, &flags, 2);
        memcpy(n + 6, &ksize, 2);
        memcpy(n + 8, le.key->data(), ksize);
        if (le.big) {
          memcpy(n + 8 + ksize, &le.opgno, 8);
        } else {
          memcpy(n + 8 + ksize, le.val->data(), le.val->size());
        }
        lower += 2;
        i++;
      }
      // ptr slots
      uint8_t* pb = buf.data() + PAGEHDRSZ;
      for (size_t k = 0; k < offs.size(); ++k) {
        memcpy(pb + 2 * k, &offs[k], 2);
      }
      put_page_hdr(buf.data(), pgno, P_LEAF, lower, upper);
      fseek(f, pgno * psize, SEEK_SET);
      fwrite(buf.data(), 1, psize, f);
      level.emplace_back(first_key, pgno);
    }
  }

  uint16_t depth = 1;
  // build branch levels until a single root
  while (level.size() > 1) {
    depth++;
    std::vector<std::pair<std::string, uint64_t>> parent;
    size_t i = 0;
    while (i < level.size()) {
      uint64_t pgno = next_pgno++;
      n_branch++;
      std::fill(buf.begin(), buf.end(), 0);
      uint16_t lower = PAGEHDRSZ;
      uint16_t upper = (uint16_t)psize;
      std::vector<uint16_t> offs;
      std::string first_key = level[i].first;
      bool first_in_page = true;
      while (i < level.size()) {
        size_t ksize = first_in_page ? 0 : level[i].first.size();
        size_t nsize = even(8 + ksize);
        if (lower + 2 + nsize > upper) break;
        upper -= (uint16_t)nsize;
        offs.push_back(upper);
        uint8_t* n = buf.data() + upper;
        uint64_t child = level[i].second;
        uint16_t lo = child & 0xFFFF;
        uint16_t hi = (child >> 16) & 0xFFFF;
        uint16_t fl = (child >> 32) & 0xFFFF;
        uint16_t ks = (uint16_t)ksize;
        memcpy(n, &lo, 2);
        memcpy(n + 2, &hi, 2);
        memcpy(n + 4, &fl, 2);
        memcpy(n + 6, &ks, 2);
        if (ksize) memcpy(n + 8, level[i].first.data(), ksize);
        lower += 2;
        first_in_page = false;
        i++;
      }
      uint8_t* pb = buf.data() + PAGEHDRSZ;
      for (size_t k = 0; k < offs.size(); ++k) {
        memcpy(pb + 2 * k, &offs[k], 2);
      }
      put_page_hdr(buf.data(), pgno, P_BRANCH, lower, upper);
      fseek(f, pgno * psize, SEEK_SET);
      fwrite(buf.data(), 1, psize, f);
      parent.emplace_back(first_key, pgno);
    }
    level.swap(parent);
  }

  uint64_t root = w->items.empty() ? P_INVALID : level[0].second;
  if (w->items.empty()) depth = 0;

  // metas
  for (int mp = 0; mp < 2; ++mp) {
    std::fill(buf.begin(), buf.end(), 0);
    put_page_hdr(buf.data(), mp, P_META, 0, 0);
    MdbMeta meta{};
    meta.magic = MDB_MAGIC;
    meta.version = MDB_DATA_VERSION;
    meta.mapsize = next_pgno * psize;
    meta.dbs[0].root = P_INVALID;  // FREE db empty
    meta.dbs[1].flags = 0;
    meta.dbs[1].depth = depth;
    meta.dbs[1].branch_pages = n_branch;
    meta.dbs[1].leaf_pages = n_leaf;
    meta.dbs[1].overflow_pages = n_overflow;
    meta.dbs[1].entries = w->items.size();
    meta.dbs[1].root = root;
    meta.last_pg = next_pgno - 1;
    meta.txnid = mp;  // meta1 (txnid 1) is current
    memcpy(buf.data() + PAGEHDRSZ, &meta, sizeof(meta));
    fseek(f, mp * psize, SEEK_SET);
    fwrite(buf.data(), 1, psize, f);
  }
  fclose(f);
  delete w;
  return 0;
}

void lmdb_writer_abort(void* handle) {
  delete static_cast<Writer*>(handle);
}

}  // extern "C"
