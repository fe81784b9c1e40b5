// Bounded top-k candidate heap with libstdc++-exact element movement.
//
// The retention and DRAIN ORDER of equal-mismatch candidates is observable
// in the output (MergePairedEndResults iterates drain order and its tie
// counting is order-dependent, src/walt/paired.cpp:472-513), so this mirrors
// libstdc++ __push_heap / __adjust_heap exactly -- the validated spec is
// walt_tpu/host/heap.py, cross-checked against a real std::priority_queue in
// tests/test_heap.py.  Shared by finalize.cpp (slab-stream replay) and
// se_exact.cpp (live exact enumeration for fallback pairs).

#ifndef WALTX_PQ_HPP
#define WALTX_PQ_HPP

#include <cstdint>
#include <vector>

namespace waltx {

struct Cand {
  int32_t mm;
  uint32_t pos;
  uint8_t strand;  // 0 = '+', 1 = '-'
};

// std::priority_queue element movement (max-heap by mm only)
struct StdPQ {
  std::vector<Cand> v;

  size_t size() const { return v.size(); }
  const Cand& top() const { return v[0]; }

  void push_heap(size_t hole, size_t top_i, const Cand& value) {
    size_t parent = (hole - 1) / 2;
    while (hole > top_i && v[parent].mm < value.mm) {
      v[hole] = v[parent];
      hole = parent;
      parent = (hole - 1) / 2;
    }
    v[hole] = value;
  }

  void push(const Cand& value) {
    v.push_back(value);
    push_heap(v.size() - 1, 0, value);
  }

  Cand pop() {
    Cand result = v[0];
    size_t len = v.size();
    if (len > 1) {
      Cand value = v[len - 1];
      v[len - 1] = v[0];
      adjust_heap(0, len - 1, value);
    }
    v.pop_back();
    return result;
  }

  void adjust_heap(size_t hole, size_t length, const Cand& value) {
    size_t top_i = hole;
    size_t second = hole;
    while (second < (length - 1) / 2) {
      second = 2 * (second + 1);
      if (v[second].mm < v[second - 1].mm) second--;
      v[hole] = v[second];
      hole = second;
    }
    if ((length & 1) == 0 && second == (length - 2) / 2) {
      second = 2 * (second + 1);
      v[hole] = v[second - 1];
      hole = second - 1;
    }
    push_heap(hole, top_i, value);
  }
};

// Gate at the top of the seed loop (mapping.cpp:248-263 / paired.cpp:131-149)
inline bool seed_allowed(int32_t best_mm, int seed_i, int exit1_seed) {
  if (best_mm == 0 && seed_i) return false;
  if (best_mm == 1 && seed_i >= exit1_seed) return false;
  return true;
}

}  // namespace waltx

#endif  // WALTX_PQ_HPP
