"""Bounded top-k candidate heap with libstdc++-exact element movement.

The reference keeps the top-k paired-end candidates in a
``std::priority_queue<CandidatePosition>`` ordered by mismatch count only
(``src/walt/paired.hpp:35-74``).  Because the comparator ignores position,
the retention and drain order of *equal-mismatch* candidates is decided by
the mechanics of libstdc++'s ``push_heap`` / ``pop_heap``.  That order is
observable in the output (it picks which ambiguous pair is reported), so this
module reimplements the exact element movement of libstdc++'s
``__push_heap`` / ``__adjust_heap`` (std_heap.h) rather than using Python's
``heapq``.  Cross-checked against a real std::priority_queue in
tests/test_heap.py.
"""

from __future__ import annotations


class StdPriorityQueue:
    """std::priority_queue over items, max-heap by key(item) = item[0]."""

    __slots__ = ("v",)

    def __init__(self):
        self.v = []

    def __len__(self):
        return len(self.v)

    def top(self):
        return self.v[0]

    def push(self, value):
        v = self.v
        v.append(value)
        self._push_heap(len(v) - 1, 0, value)

    def _push_heap(self, hole, top, value):
        v = self.v
        parent = (hole - 1) // 2
        while hole > top and v[parent][0] < value[0]:
            v[hole] = v[parent]
            hole = parent
            parent = (hole - 1) // 2
        v[hole] = value

    def pop(self):
        v = self.v
        result = v[0]
        if len(v) > 1:
            value = v[-1]
            v[-1] = v[0]
            self._adjust_heap(0, len(v) - 1, value)
        v.pop()
        return result

    def _adjust_heap(self, hole, length, value):
        v = self.v
        top = hole
        second = hole
        while second < (length - 1) // 2:
            second = 2 * (second + 1)
            if v[second][0] < v[second - 1][0]:
                second -= 1
            v[hole] = v[second]
            hole = second
        if (length & 1) == 0 and second == (length - 2) // 2:
            second = 2 * (second + 1)
            v[hole] = v[second - 1]
            hole = second - 1
        self._push_heap(hole, top, value)


class TopCandidates:
    """Bounded heap with WALT's replace-if-better rule (paired.hpp:51-74)."""

    __slots__ = ("pq", "max_size")

    def __init__(self, max_size: int):
        self.pq = StdPriorityQueue()
        self.max_size = max_size

    def empty(self) -> bool:
        return len(self.pq) == 0

    def full(self) -> bool:
        return len(self.pq) >= self.max_size

    def top(self):
        return self.pq.top()

    def push(self, cand) -> None:
        if len(self.pq) < self.max_size:
            self.pq.push(cand)
        elif cand[0] < self.pq.top()[0]:
            self.pq.pop()
            self.pq.push(cand)

    def drain(self):
        """Pop everything (worst mismatch first), as paired.cpp:684-692."""
        out = []
        while len(self.pq):
            out.append(self.pq.pop())
        return out
