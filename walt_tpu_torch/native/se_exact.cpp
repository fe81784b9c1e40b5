// Exact single-end fallback mapping at C speed.
//
// Reads whose candidates overflow the device pipeline's fixed shapes (or
// touch flagged buckets) replay the reference's exact sequential semantics
// on the host: seed hash -> bucket -> per-cared-position binary-search
// refinement (src/walt/mapping.cpp:166-222) -> -b cap -> verification ->
// the order-dependent BestMatch fold (mapping.cpp:224-316).  This module is
// a from-spec port of walt_tpu/core/refmap.py::enumerate_candidates plus
// walt_tpu/host/replay.py::replay_single (the validated Python spec),
// driven over whole fallback batches through ctypes with a thread pool --
// replacing a ~2 ms/read Python loop that serialized repeat-heavy batches.
//
// Genome sequences arrive PADDED with the oracle's LOOKUP_PAD byte (200),
// so out-of-range cared-position probes behave exactly like the Python
// spec (the reference itself reads undefined heap bytes there).

#include <cstdint>
#include <thread>
#include <vector>

#include "pq.hpp"

namespace {

struct Best {
  uint32_t pos = 0;
  int32_t times = 0;
  uint8_t strand = 0;  // 0 = '+', 1 = '-'
  int32_t mm = 0;
};

struct Table {
  const uint8_t* seq;       // padded converted genome codes
  const uint32_t* counter;  // CSR offsets (n_buckets + 1)
  const uint32_t* index;    // bucket-sorted genome positions
};

// chromosome of a concatenated-genome position (reference.cpp:43-60)
inline int chrom_of(const uint32_t* start, int n_chroms, int64_t pos) {
  int lo = 0, hi = n_chroms;  // start has n_chroms + 1 entries
  while (hi - lo > 1) {
    int mid = (lo + hi) / 2;
    if ((int64_t)start[mid] <= pos) lo = mid; else hi = mid;
  }
  return lo;
}

struct Params {
  const uint32_t* cared;
  int32_t key_weight, pattern_len, exit1_seed;
  const int32_t* skips;  // (shift, min_rep, pos) triples
  int32_t n_skips;
  int32_t b, max_mm;
  const uint32_t* start;
  int32_t n_chroms;
};

// seed gate at the top of the seed loop (mapping.cpp:248-263)
inline bool seed_allowed(int32_t best_mm, int seed_i, int exit1_seed) {
  if (best_mm == 0 && seed_i) return false;
  if (best_mm == 1 && seed_i >= exit1_seed) return false;
  return true;
}

// Enumerate the verified candidates of one (table, seed shift) in the
// reference's examination order, calling sink(gpos, mm) for each candidate
// with mm <= max_mm (refmap.enumerate_candidates semantics).
template <typename Sink>
void enum_seed(const Table& tb, const uint8_t* conv, int32_t len,
               int32_t repeats, int32_t seed_len, int seed_i, const Params& P,
               Sink&& sink) {
  const uint8_t* sh = conv + seed_i;  // shifted read
  uint32_t key = 0;
  for (int i = 0; i < P.key_weight; ++i)
    key = (key << 2) | sh[P.cared[i]];
  int64_t lo = tb.counter[key], hi = tb.counter[key + 1];
  if (lo == hi) return;
  // IndexRegion: per-cared-position lower/upper bound (mapping.cpp:166-222)
  int64_t l = lo, u = hi - 1;
  for (int p = P.key_weight; p < seed_len; ++p) {
    int64_t cp = P.cared[p];
    uint8_t c = sh[cp];
    int64_t low = l, high = u;
    while (low < high) {  // LowerBound
      int64_t mid = low + (high - low) / 2;
      if (tb.seq[(int64_t)tb.index[mid] + cp] >= c) high = mid;
      else low = mid + 1;
    }
    l = low;
    low = l; high = u;
    while (low < high) {  // UpperBound
      int64_t mid = low + (high - low + 1) / 2;
      if (tb.seq[(int64_t)tb.index[mid] + cp] <= c) low = mid;
      else high = mid - 1;
    }
    u = low;
    if (l == u && tb.seq[(int64_t)tb.index[l] + cp] != c) return;
  }
  if (l > u) return;
  if (u - l + 1 > P.b) return;  // -b cap (mapping.cpp:275-277)
  for (int64_t e = l; e <= u; ++e) {
    int64_t entry = tb.index[e];
    int ch = chrom_of(P.start, P.n_chroms, entry);
    if (entry - (int64_t)P.start[ch] < seed_i) continue;
    int64_t gpos = entry - seed_i;
    if (gpos + len >= (int64_t)P.start[ch + 1]) continue;
    int32_t mm = 0;
    const uint8_t* w = tb.seq + gpos;
    for (int j = 0; j < len; ++j) mm += (w[j] != conv[j]);
    for (int s = 0; s < P.n_skips; ++s) {
      const int32_t* sk = P.skips + 3 * s;
      if (seed_i == sk[0] && repeats >= sk[1])
        mm -= (w[sk[2]] != conv[sk[2]]);
    }
    if (mm > P.max_mm) continue;
    sink((uint32_t)gpos, mm);
  }
}

void map_one(const uint8_t* conv, int32_t len, int32_t repeats,
             int32_t seed_len, const Table* tables, const Params& P,
             Best* out) {
  Best bm;
  bm.mm = P.max_mm;
  for (int t = 0; t < 2; ++t) {
    for (int seed_i = 0; seed_i < P.pattern_len; ++seed_i) {
      // the gate re-evaluates only at seed boundaries, exactly like
      // replay_single / the reference's per-seed check
      if (!seed_allowed(bm.mm, seed_i, P.exit1_seed)) continue;
      enum_seed(tables[t], conv, len, repeats, seed_len, seed_i, P,
                [&](uint32_t gpos, int32_t mm) {
        // BestMatch fold (mapping.cpp:306-313)
        if (mm < bm.mm) {
          bm.pos = gpos;
          bm.times = 1;
          bm.strand = (uint8_t)t;
          bm.mm = mm;
        } else if (mm == bm.mm && bm.pos != gpos) {
          bm.pos = gpos;
          bm.strand = (uint8_t)t;
          bm.times += 1;
        }
      });
    }
  }
  *out = bm;
}

// PairEndMapping heap fold + drain for one mate (paired.cpp:106-201,
// 684-692 via host/replay.py::replay_paired_topk): the gate consults the
// heap top once the heap is full; pushes use the bounded
// replace-if-strictly-better rule with libstdc++-exact element movement.
int topk_one(const uint8_t* conv, int32_t len, int32_t repeats,
             int32_t seed_len, const Table* tables, const Params& P,
             int top_k, waltx::Cand* out) {
  waltx::StdPQ pq;
  for (int t = 0; t < 2; ++t) {
    for (int seed_i = 0; seed_i < P.pattern_len; ++seed_i) {
      if (pq.size() >= (size_t)top_k &&
          !seed_allowed(pq.top().mm, seed_i, P.exit1_seed))
        continue;
      enum_seed(tables[t], conv, len, repeats, seed_len, seed_i, P,
                [&](uint32_t gpos, int32_t mm) {
        waltx::Cand c{mm, gpos, (uint8_t)t};
        if (pq.size() < (size_t)top_k)
          pq.push(c);
        else if (c.mm < pq.top().mm) {
          pq.pop();
          pq.push(c);
        }
      });
    }
  }
  int n = 0;
  while (pq.size()) out[n++] = pq.pop();
  return n;
}

}  // namespace

extern "C" {

// Exact BestMatch for a batch of fallback reads.  conv: (n, lmax) converted
// read codes; seq* are LOOKUP_PAD-padded converted genomes ('+' table then
// '-' table, file order of mapping.cpp:491-499).
void se_exact_batch(
    int64_t n, const uint8_t* conv, int32_t lmax, const int32_t* lens,
    const int32_t* repeats, const int32_t* seed_len,
    const uint8_t* seq0, const uint32_t* counter0, const uint32_t* index0,
    const uint8_t* seq1, const uint32_t* counter1, const uint32_t* index1,
    const uint32_t* start, int32_t n_chroms,
    const uint32_t* cared, int32_t key_weight, int32_t pattern_len,
    int32_t exit1_seed, const int32_t* skips, int32_t n_skips,
    int32_t b, int32_t max_mm, int32_t nthreads,
    uint32_t* out_pos, int32_t* out_times, uint8_t* out_strand,
    int32_t* out_mm) {
  Table tables[2] = {{seq0, counter0, index0}, {seq1, counter1, index1}};
  Params P{cared, key_weight, pattern_len, exit1_seed,
           skips, n_skips, b, max_mm, start, n_chroms};

  auto worker = [&](int64_t a, int64_t z) {
    for (int64_t i = a; i < z; ++i) {
      Best bm;
      map_one(conv + i * lmax, lens[i], repeats[i], seed_len[i], tables, P,
              &bm);
      out_pos[i] = bm.pos;
      out_times[i] = bm.times;
      out_strand[i] = bm.strand;
      out_mm[i] = bm.mm;
    }
  };
  int nt = nthreads < 1 ? 1 : nthreads;
  if (nt == 1 || n < 2 * nt) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t step = (n + nt - 1) / nt;
  for (int64_t a = 0; a < n; a += step)
    ts.emplace_back(worker, a, a + step < n ? a + step : n);
  for (auto& t : ts) t.join();
}

// Exact ranked top-k candidates (drain order) for a batch of fallback reads
// of ONE mate.  Same table/pattern arguments as se_exact_batch; outputs are
// (n, top_k) row-major with out_n valid entries per row.
void pe_exact_ranked(
    int64_t n, const uint8_t* conv, int32_t lmax, const int32_t* lens,
    const int32_t* repeats, const int32_t* seed_len,
    const uint8_t* seq0, const uint32_t* counter0, const uint32_t* index0,
    const uint8_t* seq1, const uint32_t* counter1, const uint32_t* index1,
    const uint32_t* start, int32_t n_chroms,
    const uint32_t* cared, int32_t key_weight, int32_t pattern_len,
    int32_t exit1_seed, const int32_t* skips, int32_t n_skips,
    int32_t b, int32_t max_mm, int32_t top_k, int32_t nthreads,
    int32_t* out_n, int32_t* out_mm, uint32_t* out_pos, uint8_t* out_strand) {
  Table tables[2] = {{seq0, counter0, index0}, {seq1, counter1, index1}};
  Params P{cared, key_weight, pattern_len, exit1_seed,
           skips, n_skips, b, max_mm, start, n_chroms};

  auto worker = [&](int64_t a, int64_t z) {
    std::vector<waltx::Cand> ranked(top_k);
    for (int64_t i = a; i < z; ++i) {
      int k = topk_one(conv + i * lmax, lens[i], repeats[i], seed_len[i],
                       tables, P, top_k, ranked.data());
      out_n[i] = k;
      for (int j = 0; j < k; ++j) {
        out_mm[i * top_k + j] = ranked[j].mm;
        out_pos[i * top_k + j] = ranked[j].pos;
        out_strand[i * top_k + j] = ranked[j].strand;
      }
    }
  };
  int nt = nthreads < 1 ? 1 : nthreads;
  if (nt == 1 || n < 2 * nt) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t step = (n + nt - 1) / nt;
  for (int64_t a = 0; a < n; a += step)
    ts.emplace_back(worker, a, a + step < n ? a + step : n);
  for (auto& t : ts) t.join();
}

}  // extern "C"
