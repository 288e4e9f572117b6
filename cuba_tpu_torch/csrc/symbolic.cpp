// cuba_tpu native symbolic compiler.
//
// C++ counterpart of cuba_tpu/solver/structure.py::_finish_structure — the
// host-side "problem compiler" that turns edge lists into the static index
// structure consumed by the jitted TPU numeric path.  Plays the role of the
// reference's host/GPU structural pass (reference:
// src/cuda_block_solver.cu:1158-1173 buildHplStructure,
// src/sparse_block_matrix.cpp:55-133 HschurSparseBlockMatrix, cu:979-1000
// findHschureMulBlockIndices), but runs once on the host CPU: on TPU all
// symbolic work happens at initialize() so the compiled step function sees
// only static shapes.
//
// API style: one `ba_symbolic_compile` call returns an opaque handle owning
// all result vectors; `ba_*` getters copy into caller buffers; free with
// `ba_symbolic_free`.  Bound from Python via ctypes (no pybind11).
//
// Build: see cuba_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <limits>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct SymbolicResult {
  // Hpl block-CSC over deduplicated free (pose, landmark) pairs,
  // sorted by (landmark col, pose row).
  std::vector<int32_t> hpl_row;
  std::vector<int32_t> hpl_col;
  std::vector<int32_t> edge2hpl;  // slot per edge; n_hpl == "no slot"
  // Hsc block pattern: unique upper-tri (r <= c) pose pairs, row-major.
  std::vector<int32_t> hsc_row;
  std::vector<int32_t> hsc_col;
  // Schur multiplication triplets in landmark-major (generation) order:
  // mul_i non-decreasing, mul_i <= mul_j, same landmark column per pair.
  std::vector<int32_t> mul_i;
  std::vector<int32_t> mul_j;
  std::vector<int32_t> mul_k;
  // Fused Schur chunk plan (ops/segmm.py::SchurPlan semantics) computed in
  // the same pass — the triplets are generated landmark-major so the plan
  // needs no re-sort.  chunk=1024 / slot_block=512 / max_kwin=1024 (the
  // values plan_mxu always uses).
  int32_t sp_kwin = 0;
  int32_t sp_ok = 1;
  int64_t sp_chunks = 0;
  int64_t sp_slot_pad = 0;
  int64_t sp_hsc_pad = 0;
  std::vector<int32_t> sp_sb;   // [C]
  std::vector<int32_t> sp_li;   // [C*chunk]
  std::vector<int32_t> sp_lj;   // [C*chunk]
  std::vector<int32_t> sp_lk;   // [C*chunk]
  std::vector<int32_t> sp_gid;  // [C*kwin]
};

// Open-addressing hash set assigning first-seen provisional ids to int64
// keys (power-of-two capacity, linear probing).  Sized for the ~n_hsc
// unique Hsc block keys — stays cache-resident, so the 1.3M lookups at
// kitti00 scale beat the former radix sort of the whole triplet list.
struct KeyIdMap {
  std::vector<int64_t> keys;  // 0 = empty (stored key+1)
  std::vector<int32_t> ids;
  size_t mask = 0, count = 0;

  explicit KeyIdMap(size_t cap_hint) {
    size_t cap = 1024;
    while (cap < cap_hint * 2) cap <<= 1;
    keys.assign(cap, 0);
    ids.assign(cap, -1);
    mask = cap - 1;
  }
  void grow() {
    KeyIdMap bigger(keys.size());  // doubles (cap*2 via hint)
    for (size_t s = 0; s < keys.size(); ++s)
      if (keys[s]) bigger.insert_raw(keys[s], ids[s]);
    keys.swap(bigger.keys);
    ids.swap(bigger.ids);
    mask = bigger.mask;
  }
  void insert_raw(int64_t k1, int32_t id) {
    size_t s = (static_cast<uint64_t>(k1) * 0x9E3779B97F4A7C15ull) >> 1;
    for (s &= mask;; s = (s + 1) & mask) {
      if (!keys[s]) {
        keys[s] = k1;
        ids[s] = id;
        return;
      }
    }
  }
  // returns the id of key, inserting a fresh one (next_id) if absent
  int32_t get_or_insert(int64_t key, int32_t next_id, bool* inserted) {
    if (count * 2 >= keys.size()) grow();
    const int64_t k1 = key + 1;
    size_t s = (static_cast<uint64_t>(k1) * 0x9E3779B97F4A7C15ull) >> 1;
    for (s &= mask;; s = (s + 1) & mask) {
      if (keys[s] == k1) {
        *inserted = false;
        return ids[s];
      }
      if (!keys[s]) {
        keys[s] = k1;
        ids[s] = next_id;
        ++count;
        *inserted = true;
        return next_id;
      }
    }
  }
};

// Stable LSD radix sort of (key, payload) by key, 16-bit digits, skipping
// passes above the highest set bit.  ~6x faster than std::stable_sort on
// the multi-million-element triplet/edge sorts here (single-core host).
int64_t round_up_i64(int64_t x, int64_t m) { return (x + m - 1) / m * m; }

void radix_sort_pairs(std::vector<int64_t>& keys, std::vector<int64_t>& payload,
                      int64_t max_key) {
  const size_t n = keys.size();
  if (n <= 1) return;
  int passes = 0;
  while (max_key > 0 && passes < 4) {
    ++passes;
    max_key >>= 16;
  }
  std::vector<int64_t> kbuf(n), pbuf(n);
  std::vector<int64_t> cnt(size_t(1) << 16);
  for (int p = 0; p < passes; ++p) {
    const int shift = p * 16;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (size_t t = 0; t < n; ++t) cnt[(keys[t] >> shift) & 0xFFFF]++;
    int64_t run = 0;
    for (size_t d = 0; d < cnt.size(); ++d) {
      int64_t c = cnt[d];
      cnt[d] = run;
      run += c;
    }
    for (size_t t = 0; t < n; ++t) {
      const int64_t slot = cnt[(keys[t] >> shift) & 0xFFFF]++;
      kbuf[slot] = keys[t];
      pbuf[slot] = payload[t];
    }
    keys.swap(kbuf);
    payload.swap(pbuf);
  }
}

}  // namespace

extern "C" {

// Compile the symbolic structure.
//   e_pi / e_li : [n_edges] internal pose / landmark indices (active first;
//                 fixed vertices have index >= num_p / num_l).  Edges with
//                 both endpoints fixed must already be dropped.
//   num_p / num_l : counts of ACTIVE poses / landmarks.
// Returns an opaque handle (never null) — query sizes, copy, then free.
}  // extern "C" — internal helpers below, reopened after

// ---------------------------------------------------------------------------
// Shared fused-Schur chunk planning core (ops/segmm.py::plan_schur twin).
// Inputs are the landmark-major (canonically sorted) triplet streams.  When
// the dense chunk packing violates the 2-block slot window and ``col``
// (slot -> landmark) is given, the triplets are RE-CHUNKED at landmark
// granularity — each chunk's tail padded — so tighter slot_block values
// stay feasible under loop-closure covisibility (twin:
// ops/segmm.py::_chunk_by_landmark).
// ---------------------------------------------------------------------------

namespace {

struct SchurPlanCore {
  int32_t kwin = 0;
  int32_t ok = 1;
  int64_t chunks = 0;
  int64_t slot_pad = 0;
  int64_t hsc_pad = 0;
  std::vector<int32_t> sb;   // [C]
  std::vector<int32_t> li;   // [C*chunk]
  std::vector<int32_t> lj;   // [C*chunk]
  std::vector<int32_t> lk;   // [C*chunk]
  std::vector<int32_t> gid;  // [C*kwin]
};

// Greedy landmark-granular chunk ranges: close a chunk early when adding
// the next landmark's triplets would overflow the chunk capacity or push
// the merged slot window past 2*slot_block.  Returns false when a single
// landmark alone cannot fit (dense packing is the only option); else
// fills per-chunk source ranges [cb[c], cb[c]+cc[c]).
bool chunk_ranges_by_landmark(const int32_t* mi, const int32_t* mj,
                              int64_t n_mul, const int32_t* col,
                              int64_t chunk, int64_t slot_block,
                              std::vector<int64_t>& cb,
                              std::vector<int64_t>& cc) {
  cb.clear();
  cc.clear();
  if (n_mul == 0) return false;
  const int64_t win = 2 * slot_block;
  int64_t run_b = 0, cur_n = 0, cur_lo = 0, cur_hi = -1, chunk_b = 0;
  while (run_b < n_mul) {
    const int32_t lm = col[mi[run_b]];
    int64_t run_e = run_b;
    int64_t lo = std::numeric_limits<int64_t>::max(), hi = -1;
    while (run_e < n_mul && col[mi[run_e]] == lm) {
      lo = std::min<int64_t>(lo, std::min(mi[run_e], mj[run_e]));
      hi = std::max<int64_t>(hi, std::max(mi[run_e], mj[run_e]));
      ++run_e;
    }
    const int64_t c_ = run_e - run_b;
    if (c_ > chunk || hi - lo >= win) return false;
    if (cur_n) {
      const int64_t nlo = std::min(cur_lo, lo), nhi = std::max(cur_hi, hi);
      if (cur_n + c_ > chunk ||
          nhi >= (nlo / slot_block) * slot_block + win) {
        cb.push_back(chunk_b);
        cc.push_back(cur_n);
        chunk_b += cur_n;
        cur_n = 0;
      }
    }
    if (cur_n == 0) {
      cur_lo = lo;
      cur_hi = hi;
    } else {
      cur_lo = std::min(cur_lo, lo);
      cur_hi = std::max(cur_hi, hi);
    }
    cur_n += c_;
    run_b = run_e;
  }
  cb.push_back(chunk_b);
  cc.push_back(cur_n);
  return true;
}

void plan_schur_core(const int32_t* mi, const int32_t* mj, const int32_t* mk,
                     int64_t n_mul, int64_t n_hpl, int64_t n_hsc,
                     int64_t chunk, int64_t slot_block, int64_t max_kwin,
                     const int32_t* col, SchurPlanCore* res) {
  // source ranges: dense strides unless the dense packing violates the
  // window and a landmark-granular re-chunk is possible
  std::vector<int64_t> cb, cc;
  int64_t C = std::max<int64_t>((n_mul + chunk - 1) / chunk, 1);
  bool dense_ok = true;
  for (int64_t c = 0; c < C && dense_ok; ++c) {
    const int64_t b = c * chunk, e = std::min<int64_t>(b + chunk, n_mul);
    if (b >= e) continue;
    int64_t smin = std::numeric_limits<int64_t>::max(), smax = -1;
    for (int64_t t = b; t < e; ++t) {
      smin = std::min<int64_t>(smin, std::min(mi[t], mj[t]));
      smax = std::max<int64_t>(smax, std::max(mi[t], mj[t]));
    }
    if (smax - (smin / slot_block) * slot_block >= 2 * slot_block)
      dense_ok = false;
  }
  if (dense_ok || col == nullptr ||
      !chunk_ranges_by_landmark(mi, mj, n_mul, col, chunk, slot_block, cb,
                                cc)) {
    cb.resize(C);
    cc.resize(C);
    for (int64_t c = 0; c < C; ++c) {
      cb[c] = c * chunk;
      cc[c] = std::max<int64_t>(
          0, std::min<int64_t>(chunk, n_mul - c * chunk));
    }
  } else {
    C = static_cast<int64_t>(cb.size());
  }
  res->chunks = C;
  res->sb.resize(C);
  res->li.assign(C * chunk, -1);
  res->lj.assign(C * chunk, -1);
  res->lk.assign(C * chunk, -1);
  // pass 1: per-chunk slot windows + distinct-k counts (k ranges)
  std::vector<int64_t> kmin_c(C, 0);
  int64_t max_sb = 0, max_distinct = 1;
  std::vector<int32_t> mark;  // dense k-range scratch, reset per chunk
  std::vector<int32_t> kbuf;  // sort fallback scratch
  for (int64_t c = 0; c < C; ++c) {
    const int64_t b = cb[c], e = cb[c] + cc[c];
    int64_t smin = 0, smax = 0, kmin = 0, kmax = -1;
    if (b < e) {
      smin = std::numeric_limits<int64_t>::max();
      smax = -1;
      kmin = std::numeric_limits<int64_t>::max();
      for (int64_t t = b; t < e; ++t) {
        smin = std::min<int64_t>(smin, std::min(mi[t], mj[t]));
        smax = std::max<int64_t>(smax, std::max(mi[t], mj[t]));
        kmin = std::min<int64_t>(kmin, mk[t]);
        kmax = std::max<int64_t>(kmax, mk[t]);
      }
    }
    const int64_t sbc = smin / slot_block;
    res->sb[c] = static_cast<int32_t>(sbc);
    max_sb = std::max(max_sb, sbc);
    if (smax - sbc * slot_block >= 2 * slot_block) res->ok = 0;
    int64_t distinct = 0;
    if (kmax >= kmin) {
      const int64_t range = kmax - kmin + 1;
      if (range <= 65536) {
        if (static_cast<int64_t>(mark.size()) < range) mark.resize(range);
        std::fill(mark.begin(), mark.begin() + range, 0);
        for (int64_t t = b; t < e; ++t) mark[mk[t] - kmin] = 1;
        for (int64_t r = 0; r < range; ++r) distinct += mark[r];
      } else {
        kbuf.assign(mk + b, mk + e);
        std::sort(kbuf.begin(), kbuf.end());
        distinct = std::unique(kbuf.begin(), kbuf.end()) - kbuf.begin();
      }
    }
    kmin_c[c] = kmin;
    max_distinct = std::max(max_distinct, distinct);
  }
  int64_t kwin = std::min<int64_t>(
      max_kwin, std::max<int64_t>(round_up_i64(max_distinct, 128), 128));
  if (max_distinct > kwin) res->ok = 0;
  res->kwin = static_cast<int32_t>(kwin);
  res->gid.assign(C * kwin, -1);
  // pass 2: gid tables (ascending distinct ks) + local ids
  for (int64_t c = 0; c < C; ++c) {
    const int64_t b = cb[c], e = cb[c] + cc[c];
    if (b >= e) continue;
    const int64_t base = static_cast<int64_t>(res->sb[c]) * slot_block;
    const int64_t kmin = kmin_c[c];
    int64_t kmax = 0;
    for (int64_t t = b; t < e; ++t)
      kmax = std::max<int64_t>(kmax, mk[t]);
    const int64_t range = kmax - kmin + 1;
    if (range <= 65536 && res->ok) {
      if (static_cast<int64_t>(mark.size()) < range) mark.resize(range);
      std::fill(mark.begin(), mark.begin() + range, -1);
      for (int64_t t = b; t < e; ++t) mark[mk[t] - kmin] = 0;
      int32_t rank = 0;
      for (int64_t r = 0; r < range; ++r) {
        if (mark[r] == 0) {
          mark[r] = rank;
          if (rank < kwin)
            res->gid[c * kwin + rank] = static_cast<int32_t>(kmin + r);
          ++rank;
        }
      }
      for (int64_t t = b; t < e; ++t) {
        res->li[c * chunk + (t - b)] = static_cast<int32_t>(mi[t] - base);
        res->lj[c * chunk + (t - b)] = static_cast<int32_t>(mj[t] - base);
        res->lk[c * chunk + (t - b)] = mark[mk[t] - kmin];
      }
    } else {
      kbuf.assign(mk + b, mk + e);
      std::sort(kbuf.begin(), kbuf.end());
      kbuf.erase(std::unique(kbuf.begin(), kbuf.end()), kbuf.end());
      for (size_t r = 0; r < kbuf.size() && static_cast<int64_t>(r) < kwin;
           ++r)
        res->gid[c * kwin + r] = kbuf[r];
      for (int64_t t = b; t < e; ++t) {
        const auto it = std::lower_bound(kbuf.begin(), kbuf.end(), mk[t]);
        res->li[c * chunk + (t - b)] = static_cast<int32_t>(mi[t] - base);
        res->lj[c * chunk + (t - b)] = static_cast<int32_t>(mj[t] - base);
        res->lk[c * chunk + (t - b)] =
            static_cast<int32_t>(it - kbuf.begin());
      }
    }
  }
  res->slot_pad =
      std::max((max_sb + 2) * slot_block,
               round_up_i64(std::max<int64_t>(n_hpl, 1), slot_block));
  res->hsc_pad = round_up_i64(std::max<int64_t>(n_hsc, 1), 128);
}

}  // namespace

extern "C" {

// ABI version of this library.  The Python binding gates feature reads on
// this instead of hasattr() probes: a stale .so that already exported the
// ba_fsp_* getters but predates the 8-arg ba_symbolic_compile would plan at
// a hardcoded chunk size, so ba_fsp_copy would overflow a caller buffer
// sized for the requested geometry.  Bump whenever the signature or buffer
// contract of any exported function changes.
//   2 = geometry-parameterized ba_symbolic_compile (8 args) + fused plan
int32_t ba_abi_version(void) { return 2; }

void* ba_symbolic_compile(const int32_t* e_pi, const int32_t* e_li,
                          int64_t n_edges, int32_t num_p, int32_t num_l,
                          int32_t sp_chunk, int32_t sp_slot_block,
                          int32_t sp_max_kwin) {
  auto* res = new SymbolicResult();

  // --- deduplicated free-pair slots, sorted by (landmark, pose) ----------
  // counting-sort by landmark column, then sort+dedup rows per column.
  std::vector<int64_t> free_edge_ids;
  free_edge_ids.reserve(n_edges);
  for (int64_t e = 0; e < n_edges; ++e) {
    if (e_pi[e] < num_p && e_li[e] < num_l) free_edge_ids.push_back(e);
  }
  // bucket edges by landmark column
  std::vector<int64_t> col_cnt(static_cast<size_t>(num_l) + 1, 0);
  for (int64_t e : free_edge_ids) col_cnt[e_li[e] + 1]++;
  std::partial_sum(col_cnt.begin(), col_cnt.end(), col_cnt.begin());
  std::vector<int64_t> by_col(free_edge_ids.size());
  {
    std::vector<int64_t> cursor(col_cnt.begin(), col_cnt.end() - 1);
    for (int64_t e : free_edge_ids) by_col[cursor[e_li[e]]++] = e;
  }

  res->edge2hpl.assign(n_edges, 0);  // fill below; default patched after n_hpl known
  std::vector<int64_t> slot_of_edge(n_edges, -1);

  std::vector<int32_t> col_rows;  // scratch: unique rows of one column
  std::vector<int64_t> col_start(static_cast<size_t>(num_l) + 1, 0);
  for (int32_t l = 0; l < num_l; ++l) {
    col_start[l] = static_cast<int64_t>(res->hpl_row.size());
    int64_t b = col_cnt[l], eend = col_cnt[l + 1];
    col_rows.clear();
    for (int64_t k = b; k < eend; ++k) col_rows.push_back(e_pi[by_col[k]]);
    std::sort(col_rows.begin(), col_rows.end());
    col_rows.erase(std::unique(col_rows.begin(), col_rows.end()), col_rows.end());
    int64_t base = static_cast<int64_t>(res->hpl_row.size());
    for (int32_t r : col_rows) {
      res->hpl_row.push_back(r);
      res->hpl_col.push_back(l);
    }
    for (int64_t k = b; k < eend; ++k) {
      int64_t e = by_col[k];
      auto it = std::lower_bound(col_rows.begin(), col_rows.end(), e_pi[e]);
      slot_of_edge[e] = base + (it - col_rows.begin());
    }
  }
  const int64_t n_hpl = static_cast<int64_t>(res->hpl_row.size());
  col_start[num_l] = n_hpl;
  for (int64_t e = 0; e < n_edges; ++e)
    res->edge2hpl[e] =
        slot_of_edge[e] < 0 ? static_cast<int32_t>(n_hpl) : static_cast<int32_t>(slot_of_edge[e]);

  // --- Hsc block pattern + mul triplets (landmark-major order) -----------
  // per landmark column: all slot pairs (a, b), a <= b (row_a <= row_b since
  // rows are sorted within a column); output block = (row_a, row_b).  Block
  // ids are assigned via a small hash map in first-seen order, then
  // renumbered to row-major rank with one sort of the ~n_hsc unique keys —
  // the triplet list itself is never sorted.
  int64_t n_pairs = 0;
  for (int32_t l = 0; l < num_l; ++l) {
    int64_t len = col_start[l + 1] - col_start[l];
    n_pairs += len * (len + 1) / 2;
  }
  res->mul_i.resize(n_pairs);
  res->mul_j.resize(n_pairs);
  res->mul_k.resize(n_pairs);
  std::vector<int64_t> uniq_keys;  // first-seen order
  uniq_keys.reserve(16384);
  KeyIdMap map(16384);
  {
    int64_t t = 0;
    for (int32_t l = 0; l < num_l; ++l) {
      for (int64_t a = col_start[l]; a < col_start[l + 1]; ++a) {
        const int64_t ra = res->hpl_row[a];
        for (int64_t b = a; b < col_start[l + 1]; ++b, ++t) {
          const int64_t key = ra * num_p + res->hpl_row[b];
          bool inserted;
          const int32_t id =
              map.get_or_insert(key, static_cast<int32_t>(uniq_keys.size()), &inserted);
          if (inserted) uniq_keys.push_back(key);
          res->mul_i[t] = static_cast<int32_t>(a);
          res->mul_j[t] = static_cast<int32_t>(b);
          res->mul_k[t] = id;  // provisional (first-seen) id
        }
      }
    }
  }
  // renumber: provisional id -> row-major rank
  const int64_t n_hsc = static_cast<int64_t>(uniq_keys.size());
  std::vector<int64_t> sorted_keys(uniq_keys);
  std::sort(sorted_keys.begin(), sorted_keys.end());
  res->hsc_row.resize(n_hsc);
  res->hsc_col.resize(n_hsc);
  for (int64_t r = 0; r < n_hsc; ++r) {
    res->hsc_row[r] = static_cast<int32_t>(sorted_keys[r] / num_p);
    res->hsc_col[r] = static_cast<int32_t>(sorted_keys[r] % num_p);
  }
  std::vector<int32_t> remap(n_hsc);
  {
    // provisional -> final: binary search each first-seen key (n_hsc log n_hsc)
    for (int64_t p = 0; p < n_hsc; ++p) {
      const auto it = std::lower_bound(sorted_keys.begin(), sorted_keys.end(), uniq_keys[p]);
      remap[p] = static_cast<int32_t>(it - sorted_keys.begin());
    }
    for (int64_t t = 0; t < n_pairs; ++t) res->mul_k[t] = remap[res->mul_k[t]];
  }

  // --- fused Schur chunk plan (triplets already landmark-major) ----------
  // geometry comes from the caller (the session's plan geometry); the core
  // re-chunks at landmark granularity when tight slot windows make the
  // dense packing infeasible
  {
    SchurPlanCore core;
    plan_schur_core(res->mul_i.data(), res->mul_j.data(), res->mul_k.data(),
                    n_pairs, n_hpl, n_hsc, sp_chunk, sp_slot_block,
                    sp_max_kwin, res->hpl_col.data(), &core);
    res->sp_kwin = core.kwin;
    res->sp_ok = core.ok;
    res->sp_chunks = core.chunks;
    res->sp_slot_pad = core.slot_pad;
    res->sp_hsc_pad = core.hsc_pad;
    res->sp_sb = std::move(core.sb);
    res->sp_li = std::move(core.li);
    res->sp_lj = std::move(core.lj);
    res->sp_lk = std::move(core.lk);
    res->sp_gid = std::move(core.gid);
  }

  return res;
}

int64_t ba_n_hpl(const void* h) {
  return static_cast<const SymbolicResult*>(h)->hpl_row.size();
}
int64_t ba_n_hsc(const void* h) {
  return static_cast<const SymbolicResult*>(h)->hsc_row.size();
}
int64_t ba_n_mul(const void* h) {
  return static_cast<const SymbolicResult*>(h)->mul_i.size();
}
static void copy32(const std::vector<int32_t>& v, int32_t* dst) {
  std::memcpy(dst, v.data(), v.size() * sizeof(int32_t));
}

void ba_copy_hpl(const void* h, int32_t* row, int32_t* col, int32_t* edge2hpl) {
  const auto* r = static_cast<const SymbolicResult*>(h);
  copy32(r->hpl_row, row);
  copy32(r->hpl_col, col);
  copy32(r->edge2hpl, edge2hpl);
}
void ba_copy_hsc(const void* h, int32_t* row, int32_t* col) {
  const auto* r = static_cast<const SymbolicResult*>(h);
  copy32(r->hsc_row, row);
  copy32(r->hsc_col, col);
}
void ba_copy_mul(const void* h, int32_t* i, int32_t* j, int32_t* k) {
  const auto* r = static_cast<const SymbolicResult*>(h);
  copy32(r->mul_i, i);
  copy32(r->mul_j, j);
  copy32(r->mul_k, k);
}
// fused Schur-plan getters (chunk=1024, slot_block=512, max_kwin=1024)
int32_t ba_fsp_kwin(const void* h) { return static_cast<const SymbolicResult*>(h)->sp_kwin; }
int32_t ba_fsp_ok(const void* h) { return static_cast<const SymbolicResult*>(h)->sp_ok; }
int64_t ba_fsp_chunks(const void* h) { return static_cast<const SymbolicResult*>(h)->sp_chunks; }
int64_t ba_fsp_slot_pad(const void* h) {
  return static_cast<const SymbolicResult*>(h)->sp_slot_pad;
}
int64_t ba_fsp_hsc_pad(const void* h) {
  return static_cast<const SymbolicResult*>(h)->sp_hsc_pad;
}
void ba_fsp_copy(const void* h, int32_t* sb, int32_t* li, int32_t* lj,
                 int32_t* lk, int32_t* gid) {
  const auto* r = static_cast<const SymbolicResult*>(h);
  copy32(r->sp_sb, sb);
  copy32(r->sp_li, li);
  copy32(r->sp_lj, lj);
  copy32(r->sp_lk, lk);
  copy32(r->sp_gid, gid);
}

void ba_symbolic_free(void* h) { delete static_cast<SymbolicResult*>(h); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Schur-kernel chunk planning (C++ port of ops/segmm.py::plan_schur).
// Sorts the multiplication triplets into landmark-major order, derives
// per-chunk slot windows and compact distinct-block lists for the fused
// Pallas kernel.  Pure indexing work that dominates engine construction in
// NumPy (~0.6s at kitti00 scale).
// ---------------------------------------------------------------------------

namespace {

struct SchurPlanResult {
  int32_t kwin = 0;
  int32_t ok = 1;
  int64_t num_chunks = 0;
  int64_t n_slot_pad = 0;
  int64_t n_hsc_pad = 0;
  std::vector<int32_t> sb;   // [C]
  std::vector<int32_t> li;   // [C*chunk]
  std::vector<int32_t> lj;   // [C*chunk]
  std::vector<int32_t> lk;   // [C*chunk]
  std::vector<int32_t> gid;  // [C*kwin]
};

}  // namespace

extern "C" {

void* ba_schur_plan(const int32_t* mul_i, const int32_t* mul_j,
                    const int32_t* mul_k, int64_t n_mul, int32_t n_hpl,
                    int32_t n_hsc, int32_t chunk, int32_t slot_block,
                    int32_t max_kwin, const int32_t* col) {
  auto* res = new SchurPlanResult();
  // stable counting sort by mul_i (landmark-major slot order), then the
  // shared planning core (which re-chunks at landmark granularity — using
  // ``col``, nullable — when tight slot windows break the dense packing)
  std::vector<int64_t> cnt(static_cast<size_t>(n_hpl) + 1, 0);
  for (int64_t t = 0; t < n_mul; ++t) cnt[mul_i[t] + 1]++;
  std::partial_sum(cnt.begin(), cnt.end(), cnt.begin());
  std::vector<int32_t> smi(n_mul), smj(n_mul), smk(n_mul);
  {
    std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
    for (int64_t t = 0; t < n_mul; ++t) {
      const int64_t d = cur[mul_i[t]]++;
      smi[d] = mul_i[t];
      smj[d] = mul_j[t];
      smk[d] = mul_k[t];
    }
  }
  SchurPlanCore core;
  plan_schur_core(smi.data(), smj.data(), smk.data(), n_mul, n_hpl, n_hsc,
                  chunk, slot_block, max_kwin, col, &core);
  res->kwin = core.kwin;
  res->ok = core.ok;
  res->num_chunks = core.chunks;
  res->n_slot_pad = core.slot_pad;
  res->n_hsc_pad = core.hsc_pad;
  res->sb = std::move(core.sb);
  res->li = std::move(core.li);
  res->lj = std::move(core.lj);
  res->lk = std::move(core.lk);
  res->gid = std::move(core.gid);
  return res;
}

int32_t ba_sp_kwin(const void* h) { return static_cast<const SchurPlanResult*>(h)->kwin; }
int32_t ba_sp_ok(const void* h) { return static_cast<const SchurPlanResult*>(h)->ok; }
int64_t ba_sp_chunks(const void* h) { return static_cast<const SchurPlanResult*>(h)->num_chunks; }
int64_t ba_sp_slot_pad(const void* h) { return static_cast<const SchurPlanResult*>(h)->n_slot_pad; }
int64_t ba_sp_hsc_pad(const void* h) { return static_cast<const SchurPlanResult*>(h)->n_hsc_pad; }
void ba_sp_copy(const void* h, int32_t* sb, int32_t* li, int32_t* lj,
                int32_t* lk, int32_t* gid) {
  const auto* r = static_cast<const SchurPlanResult*>(h);
  copy32(r->sb, sb);
  copy32(r->li, li);
  copy32(r->lj, lj);
  copy32(r->lk, lk);
  copy32(r->gid, gid);
}
void ba_sp_free(void* h) { delete static_cast<SchurPlanResult*>(h); }

// ---------------------------------------------------------------------------
// Tile min/max scans for the window planners (ops/segmm.py::plan_tiles /
// plan_gather_tiles / plan_accum_windows).  These are single passes over
// multi-million-element id tables that cost ~5-10ms each as NumPy
// ufunc.at / reshape-reduce calls; here they run at memory bandwidth.
//   mode 0 (expand): per OUTPUT tile t = ids[x]/tile over valid ids,
//       mn[t] = min x, mx[t] = max x  (x = input position)
//   mode 1 (gather): per INPUT chunk c = x/tile,
//       mn[c] = min valid ids[x], mx[c] = max valid ids[x]
// Valid means 0 <= ids[x] < bound.  mn init = INT64_MAX, mx init = -1;
// the (tiny) finishing arithmetic stays in NumPy.
// ---------------------------------------------------------------------------

void ba_tile_minmax(const int32_t* ids, int64_t n, int64_t bound,
                    int64_t tile, int32_t mode, int64_t num_tiles,
                    int64_t* mn, int64_t* mx) {
  for (int64_t t = 0; t < num_tiles; ++t) {
    mn[t] = std::numeric_limits<int64_t>::max();
    mx[t] = -1;
  }
  // tile is a power of two in every caller (128/512/1024); a shift avoids
  // the per-element integer division (~25 cycles each over ~12M elements
  // per engine ctor — measured ~60 ms of the ctor's host time)
  const bool pow2 = tile > 0 && (tile & (tile - 1)) == 0;
  const int shift = pow2 ? __builtin_ctzll(static_cast<uint64_t>(tile)) : 0;
  if (mode == 0) {
    for (int64_t x = 0; x < n; ++x) {
      const int32_t v = ids[x];
      if (v < 0 || v >= bound) continue;
      const int64_t t = pow2 ? (static_cast<int64_t>(v) >> shift) : v / tile;
      mn[t] = std::min(mn[t], x);
      mx[t] = std::max(mx[t], x);
    }
  } else {
    for (int64_t x = 0; x < n; ++x) {
      const int32_t v = ids[x];
      if (v < 0 || v >= bound) continue;
      const int64_t c = pow2 ? (x >> shift) : x / tile;
      mn[c] = std::min<int64_t>(mn[c], v);
      mx[c] = std::max<int64_t>(mx[c], v);
    }
  }
}

// ---------------------------------------------------------------------------
// Locality reorder (C++ port of solver/structure.py::_locality_reorder):
// renumber ACTIVE landmarks by min observing pose, then sort each edge type
// by (new landmark, pose).  Writes results into caller-allocated buffers:
//   rank       [num_l]   int64  new index per old active-landmark index
//   *_perm     [n_*]     int64  sort permutation per edge type
//   *_new_li   [n_*]     int32  remapped landmark index, permuted (sorted)
// ---------------------------------------------------------------------------

void ba_locality_reorder(const int32_t* mono_pi, const int32_t* mono_li,
                         int64_t n_mono, const int32_t* stereo_pi,
                         const int32_t* stereo_li, int64_t n_stereo,
                         int32_t total_p, int32_t total_l, int32_t num_l,
                         int64_t* rank, int64_t* mono_perm,
                         int64_t* stereo_perm, int32_t* mono_new_li,
                         int32_t* stereo_new_li) {
  // min observing pose per active landmark; total_p = "never observed"
  std::vector<int32_t> minp(num_l, total_p);
  auto scan = [&](const int32_t* pi, const int32_t* li, int64_t n) {
    for (int64_t e = 0; e < n; ++e)
      if (li[e] < num_l) minp[li[e]] = std::min(minp[li[e]], pi[e]);
  };
  scan(mono_pi, mono_li, n_mono);
  scan(stereo_pi, stereo_li, n_stereo);
  // stable counting sort of landmarks by minp -> rank
  std::vector<int64_t> cnt(static_cast<size_t>(total_p) + 2, 0);
  for (int32_t l = 0; l < num_l; ++l) cnt[minp[l] + 1]++;
  std::partial_sum(cnt.begin(), cnt.end(), cnt.begin());
  for (int32_t l = 0; l < num_l; ++l) rank[l] = cnt[minp[l]]++;

  // per edge type: stable sort by (new landmark, pose)
  auto remap_sort = [&](const int32_t* pi, const int32_t* li, int64_t n,
                        int64_t* perm, int32_t* new_li) {
    std::vector<int64_t> keys(n), idx(n);
    for (int64_t e = 0; e < n; ++e) {
      const int64_t nl = li[e] < num_l ? rank[li[e]] : li[e];
      keys[e] = nl * total_p + pi[e];
      idx[e] = e;
    }
    radix_sort_pairs(keys, idx, static_cast<int64_t>(total_l) * total_p);
    for (int64_t e = 0; e < n; ++e) {
      perm[e] = idx[e];
      new_li[e] = static_cast<int32_t>(keys[e] / total_p);
    }
  };
  remap_sort(mono_pi, mono_li, n_mono, mono_perm, mono_new_li);
  remap_sort(stereo_pi, stereo_li, n_stereo, stereo_perm, stereo_new_li);
}

// Wire-packer helper (engine._try_d8): probe whether the intra-chunk first
// differences of x[:V] fit int8/int16, where V is the index after the last
// non-pad value (pad = x[n-1]) and chunk leads are excluded (they ride as
// int32 bases).  kind: 0 = int8, 1 = int16, 2 = not encodable / too short.
void ba_delta_probe(const int32_t* x, int64_t n, int64_t chunk,
                    int64_t* V_out, int32_t* kind_out) {
  const int32_t pad = x[n - 1];
  int64_t V = 0;
  for (int64_t i = n; i > 0; --i) {
    if (x[i - 1] != pad) { V = i; break; }
  }
  *V_out = V;
  if (V < 2048) { *kind_out = 2; return; }
  int64_t dmin = 0, dmax = 0;
  for (int64_t i = 1; i < V; ++i) {
    if (i % chunk == 0) continue;
    const int64_t d = static_cast<int64_t>(x[i]) - x[i - 1];
    if (d < dmin) dmin = d;
    if (d > dmax) dmax = d;
  }
  *kind_out = (dmax <= 127 && dmin >= -128) ? 0
            : (dmax <= 32767 && dmin >= -32768) ? 1 : 2;
}

// Canonical-enumeration check for the Schur local-id streams (C++ twin of
// mxu._canonical_schur_ntri — the NumPy version's three np.diff passes over
// ~3.6M triplets cost ~0.15s of serial ctor time at kitti00 scale).  The
// canonical order is: for slot s = 0..n_hpl-1 (landmark-major), j from s to
// the end of s's landmark run.  li/lj are chunk-local ids (li[t] + sb[t /
// chunk] * slot_block = global slot); padding (-1) must sit at chunk TAILS
// (re-chunked plans pad per chunk; dense plans only the last chunk).
// Returns the valid triplet count, or -1 if non-canonical.
int64_t ba_canonical_ntri(const int32_t* li, const int32_t* lj,
                          const int32_t* sb, int64_t C, int32_t chunk,
                          int32_t slot_block, const int32_t* col,
                          int64_t n_hpl) {
  if (n_hpl == 0 || C == 0) return -1;
  // end of the landmark run containing each slot (col is non-decreasing)
  std::vector<int64_t> ends(n_hpl);
  {
    int64_t run_end = n_hpl;
    for (int64_t s = n_hpl - 1; s >= 0; --s) {
      ends[s] = run_end;
      if (s > 0 && col[s - 1] != col[s]) run_end = s;
    }
  }
  const int64_t total = C * chunk;
  int64_t s = 0, jj = 0;
  int64_t n_tri = 0;
  for (int64_t t = 0; t < total; ++t) {
    const int32_t a = li[t];
    if (a < 0) {
      // padding must extend to this chunk's end: re-chunked plans
      // (landmark-granular chunking for tighter slot windows) pad each
      // chunk's tail; densely packed plans only the last chunk's
      const int64_t ce = (t / chunk + 1) * chunk;
      for (int64_t u = t; u < ce; ++u)
        if (li[u] >= 0) return -1;
      t = ce - 1;
      continue;
    }
    const int64_t base = static_cast<int64_t>(sb[t / chunk]) * slot_block;
    if (a + base != s || static_cast<int64_t>(lj[t]) + base != jj) return -1;
    ++n_tri;
    if (++jj == ends[s]) { ++s; jj = s; }
  }
  // complete enumeration: every slot's run consumed exactly
  if (s != n_hpl || n_tri < 2) return -1;
  return n_tri;
}

// Fill the delta stream for a successful probe: out has ceil(V/chunk)*chunk
// entries, chunk leads and the tail beyond V are zero.  Exactly one of
// d8/d16 is non-null (matching the probe's kind).
void ba_delta_fill(const int32_t* x, int64_t V, int64_t chunk,
                   int64_t total, int8_t* d8, int16_t* d16) {
  if (d8) std::fill(d8, d8 + total, static_cast<int8_t>(0));
  if (d16) std::fill(d16, d16 + total, static_cast<int16_t>(0));
  for (int64_t i = 1; i < V; ++i) {
    if (i % chunk == 0) continue;
    const int64_t d = static_cast<int64_t>(x[i]) - x[i - 1];
    if (d8) d8[i] = static_cast<int8_t>(d);
    else d16[i] = static_cast<int16_t>(d);
  }
}

}  // extern "C"
