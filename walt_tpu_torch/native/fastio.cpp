// Native FASTQ batch parsing and MR batch emission.
//
// The reference's read loading and output writing are C++ (component #10 of
// SURVEY.md: smithlab_os.cpp:203-364 FASTQ reading; mapping.cpp:347-419
// output) and the TPU framework keeps that boundary native: the Python host
// pipeline hands whole buffers to these entry points instead of running
// per-read interpreter loops.  Semantics are a from-spec port of
// walt_tpu/host/fastq.py (_load_batch_fast) and walt_tpu/host/emit.py
// (write_single_batch MR path) -- the validated Python specs of the
// reference behavior -- NOT of the reference's own code.
//
// Fast-path contract (identical to _load_batch_fast): regular 4-line
// records, no empty logical lines, no line over MAX_LINE_LENGTH-2 content
// bytes, EOF only at a record boundary with a trailing newline.  Anything
// else returns -1 and the caller falls back to the exact Python
// line-by-line loop.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr int kMaxLine = 1000;  // MAX_LINE_LENGTH, util.hpp:43
constexpr uint8_t kPadCode = 254;

// glibc rand() TYPE_3 additive feedback generator, from-spec port of
// walt_tpu/glibc_rand.py (verified there against the C library).
struct GlibcRand {
  std::vector<uint32_t> r;
  size_t i;

  explicit GlibcRand(int32_t seed) {
    if (seed == 0) seed = 1;
    r.resize(344);
    r[0] = static_cast<uint32_t>(seed);
    int64_t word = seed;
    for (int k = 1; k < 31; ++k) {
      int64_t hi = word / 127773;  // C truncating division
      int64_t lo = word - hi * 127773;
      word = 16807 * lo - 2836 * hi;
      if (word < 0) word += 2147483647;
      r[k] = static_cast<uint32_t>(word);
    }
    for (int k = 31; k < 34; ++k) r[k] = r[k - 31];
    for (int k = 34; k < 344; ++k) r[k] = r[k - 31] + r[k - 3];
    i = 344;
  }

  uint32_t next() {
    uint32_t v = r[i - 31] + r[i - 3];
    r.push_back(v);
    ++i;
    return v >> 1;
  }
};

inline int8_t base_code(uint8_t b) {
  switch (b) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return -1;
  }
}

const char kCodeToBase[5] = "ACGT";

// Buffered write() of n bytes, handling short writes.
inline int write_all(int fd, const char* p, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t w = write(fd, p + off, n - off);
    if (w < 0) return -1;
    off += static_cast<size_t>(w);
  }
  return 0;
}

// Append ``n`` bytes to ``fd``, pushing 4 KB-aligned middles through
// O_DIRECT.  On this host class buffered writeback runs at ~4 MB/s (each
// dirtied page-cache page takes the slow VMM path) while O_DIRECT streams
// at ~100 MB/s, so large output files MUST bypass the page cache.  The
// unaligned head (to reach a 4 KB file offset) and tail go through normal
// buffered writes; O_DIRECT data is staged in a reused aligned bounce
// buffer.  Falls back to plain writes wherever O_DIRECT is unsupported.
inline int direct_write(int fd, const char* p, size_t n) {
  constexpr size_t kAlign = 4096;
  constexpr size_t kBounce = size_t{4} << 20;
  static char* bounce = nullptr;
  if (bounce == nullptr &&
      posix_memalign(reinterpret_cast<void**>(&bounce), kAlign, kBounce)) {
    bounce = nullptr;
  }
  off_t pos = lseek(fd, 0, SEEK_CUR);
  if (bounce == nullptr || pos < 0 || n < 2 * kAlign) {
    return write_all(fd, p, n);
  }
  size_t head = (kAlign - static_cast<size_t>(pos) % kAlign) % kAlign;
  if (head >= n) return write_all(fd, p, n);
  size_t mid = ((n - head) / kAlign) * kAlign;
  if (head && write_all(fd, p, head) < 0) return -1;
  int flags = fcntl(fd, F_GETFL);
  if (mid && flags >= 0 && fcntl(fd, F_SETFL, flags | O_DIRECT) == 0) {
    size_t done = 0;
    while (done < mid) {
      size_t chunk = mid - done < kBounce ? mid - done : kBounce;
      memcpy(bounce, p + head + done, chunk);
      ssize_t w = write(fd, bounce, chunk);
      if (w < 0) {  // EINVAL etc: give up on O_DIRECT for the rest
        fcntl(fd, F_SETFL, flags);
        return write_all(fd, p + head + done, n - head - done);
      }
      done += static_cast<size_t>(w);
    }
    fcntl(fd, F_SETFL, flags);
  } else if (mid && write_all(fd, p + head, mid) < 0) {
    return -1;
  }
  return write_all(fd, p + head + mid, n - head - mid);
}

}  // namespace

extern "C" {

// Append a pre-assembled buffer through the O_DIRECT-capable writer; the
// Python DirectFile wrapper batches small text writes and flushes here.
int dio_write(int fd, const uint8_t* p, int64_t n) {
  return direct_write(fd, reinterpret_cast<const char*>(p),
                      static_cast<size_t>(n));
}

// Newlines in buf[0, n), counted up to ``need``: whether the loader's
// buffer holds a batch's lines (FgetsLines.fill).  *end is the offset just
// past the last newline counted (0 when none).
int64_t count_newlines(const uint8_t* buf, int64_t n, int64_t need,
                       int64_t* end) {
  int64_t count = 0, pos = 0;
  while (count < need && pos < n) {
    const void* nl = memchr(buf + pos, '\n', static_cast<size_t>(n - pos));
    if (nl == nullptr) break;
    pos = static_cast<const uint8_t*>(nl) - buf + 1;
    ++count;
  }
  *end = pos;
  return count;
}

// Pass 1: structure scan.  Returns 0 on fast-path success (outputs filled),
// -1 when the buffer needs the exact Python fallback, 1 when the buffer is
// empty.  consumed = bytes of complete records; n_reads; lmax = longest
// sequence line.
int fastq_scan(const uint8_t* buf, int64_t n, int64_t max_reads,
               int64_t* consumed, int64_t* n_reads, int32_t* lmax) {
  *consumed = 0;
  *n_reads = 0;
  *lmax = 0;
  if (n == 0) return 1;
  int64_t reads = 0, pos = 0, last_rec_end = 0;
  int32_t lm = 0;
  while (reads < max_reads && pos < n) {
    int64_t rec_start = pos;
    int32_t seq_len = 0;
    int line;
    for (line = 0; line < 4; ++line) {
      const void* nl = memchr(buf + pos, '\n', static_cast<size_t>(n - pos));
      // EOF mid-record: the exact loop keeps the whole records before it
      if (nl == nullptr) return -1;
      int64_t e = static_cast<const uint8_t*>(nl) - buf;
      int64_t len = e - pos;  // content bytes
      if (len == 0 || len > kMaxLine - 2) return -1;
      if (line == 1) seq_len = static_cast<int32_t>(len);
      pos = e + 1;
    }
    if (seq_len > lm) lm = seq_len;
    last_rec_end = pos;
    ++reads;
    (void)rec_start;
  }
  if (reads == 0) return -1;
  // EOF tail oddities (no trailing newline, partial record) -> the loop
  // above already returned -1; a clean boundary lands exactly on a newline.
  *consumed = last_rec_end;
  *n_reads = reads;
  *lmax = lm;
  return 0;
}

// Pass 2: fill codes / decoded bases / record offsets.  codes and seqbytes
// are (n_reads, lmax) row-major; codes are PAD-filled past each length,
// seqbytes zero-filled.  Non-ACGT bases consume glibc rand()%4 in read
// order, base order (srand(0) per batch, mapping.cpp:73, util.hpp:156-163).
// Name offsets point into buf after '@', truncated at the first space.
void fastq_fill(const uint8_t* buf, int64_t consumed, int64_t n_reads,
                int32_t lmax, uint8_t* codes, uint8_t* seqbytes,
                int32_t* slens, int64_t* name_off, int32_t* name_len,
                int64_t* qual_off, int32_t* qual_len) {
  GlibcRand rng(0);
  memset(codes, kPadCode, static_cast<size_t>(n_reads) * lmax);
  memset(seqbytes, 0, static_cast<size_t>(n_reads) * lmax);
  int64_t pos = 0;
  for (int64_t r = 0; r < n_reads; ++r) {
    // line 0: name
    const uint8_t* nl =
        static_cast<const uint8_t*>(memchr(buf + pos, '\n', consumed - pos));
    int64_t e = nl - buf;
    name_off[r] = pos + 1;  // skip '@'
    const void* sp = memchr(buf + pos + 1, ' ', e - pos - 1);
    name_len[r] = static_cast<int32_t>(
        (sp ? static_cast<const uint8_t*>(sp) - buf : e) - (pos + 1));
    pos = e + 1;
    // line 1: sequence
    nl = static_cast<const uint8_t*>(memchr(buf + pos, '\n', consumed - pos));
    e = nl - buf;
    int32_t len = static_cast<int32_t>(e - pos);
    slens[r] = len;
    uint8_t* crow = codes + r * lmax;
    uint8_t* srow = seqbytes + r * lmax;
    for (int32_t k = 0; k < len; ++k) {
      int8_t c = base_code(buf[pos + k]);
      if (c < 0) c = static_cast<int8_t>(rng.next() & 3);
      crow[k] = static_cast<uint8_t>(c);
      srow[k] = static_cast<uint8_t>(kCodeToBase[c]);
    }
    pos = e + 1;
    // line 2: '+'
    nl = static_cast<const uint8_t*>(memchr(buf + pos, '\n', consumed - pos));
    pos = (nl - buf) + 1;
    // line 3: quality
    nl = static_cast<const uint8_t*>(memchr(buf + pos, '\n', consumed - pos));
    e = nl - buf;
    qual_off[r] = pos;
    qual_len[r] = static_cast<int32_t>(e - pos);
    pos = e + 1;
  }
}

// Batched MR emission (write_single_batch MR path, emit.py; the per-line
// format is mapping.cpp:347-356).  Writes complete buffers to the raw fds
// (callers flush their Python-level buffering first).  strands/starts/mm
// are the post-fold BestMatch arrays; chr_names is a concatenated name
// blob.  Returns 0, or -1 on a write error.
int mr_emit_batch(int64_t n, int fd_main, int fd_amb, int fd_unm,
                  const uint8_t* buf,  // fastq buffer (names + quals)
                  const int64_t* name_off, const int32_t* name_len,
                  const int64_t* qual_off, const int32_t* qual_len,
                  const uint8_t* seqbytes, int32_t lmax, const int32_t* slens,
                  const int32_t* times, const uint8_t* minus,
                  const int64_t* starts, const int32_t* mm,
                  const int32_t* chr_id, const uint8_t* chr_names,
                  const int64_t* chr_off, const int32_t* chr_len,
                  int ag_wildcard) {
  // Buffers are static and bounded: on virtualized hosts where dirtying a
  // NEW page costs a ~40us VMM round trip (and grows with total dirty
  // memory), per-call allocations of tens of MB dominate the whole batch.
  // clear() keeps capacity, so after the first call no new pages are
  // touched; the flush threshold bounds the capacity that sticks around.
  constexpr size_t kFlushAt = size_t{4} << 20;
  static std::string main_s, amb_s, unm_s;
  main_s.clear();
  amb_s.clear();
  unm_s.clear();
  int write_err = 0;
  auto flush = [&](int fd, std::string& s) {
    if (direct_write(fd, s.data(), s.size()) < 0) write_err = -1;
    s.clear();
  };
  char num[32];
  // rseq in [0, lmax), rqual in [lmax, lmax + kMaxLine): a quality line may
  // be longer than the longest sequence, but never than an fgets line
  static std::vector<uint8_t> tmp;
  tmp.resize(static_cast<size_t>(lmax) + kMaxLine);
  for (int64_t j = 0; j < n; ++j) {
    if (main_s.size() > kFlushAt) flush(fd_main, main_s);
    if (amb_s.size() > kFlushAt) flush(fd_amb, amb_s);
    if (unm_s.size() > kFlushAt) flush(fd_unm, unm_s);
    int32_t t = times[j];
    bool want_amb = t >= 2 && fd_amb >= 0;
    bool want_unm = t == 0 && fd_unm >= 0;
    if (t != 1 && !want_amb && !want_unm) continue;
    const uint8_t* seq = seqbytes + j * lmax;
    const uint8_t* qual = buf + qual_off[j];
    int32_t sl = slens[j], ql = qual_len[j];
    uint8_t* rseq = tmp.data();
    uint8_t* rqual = tmp.data() + lmax;
    if (ag_wildcard) {
      // A/G-wildcard reads report the reverse complement with reversed
      // quality (mapping.cpp:342-345, :362-367)
      for (int32_t k = 0; k < sl; ++k) {
        uint8_t b = seq[sl - 1 - k];
        rseq[k] = b == 'A' ? 'T' : b == 'C' ? 'G' : b == 'G' ? 'C'
                  : b == 'T' ? 'A' : b;
      }
      for (int32_t k = 0; k < ql; ++k) rqual[k] = qual[ql - 1 - k];
      seq = rseq;
      qual = rqual;
    }
    std::string& out = want_unm ? unm_s : (t == 1 ? main_s : amb_s);
    if (want_unm) {
      out.append(reinterpret_cast<const char*>(buf + name_off[j]), name_len[j]);
      out.push_back('\t');
      out.append(reinterpret_cast<const char*>(seq), sl);
      out.push_back('\t');
      out.append(reinterpret_cast<const char*>(qual), ql);
      out.push_back('\n');
      continue;
    }
    char strand = minus[j] ? '-' : '+';
    if (ag_wildcard) strand = minus[j] ? '+' : '-';
    int32_t c = chr_id[j];
    out.append(reinterpret_cast<const char*>(chr_names + chr_off[c]),
               chr_len[c]);
    out.push_back('\t');
    out.append(num, snprintf(num, sizeof num, "%lld",
                             static_cast<long long>(starts[j])));
    out.push_back('\t');
    out.append(num, snprintf(num, sizeof num, "%lld",
                             static_cast<long long>(starts[j] + sl)));
    out.push_back('\t');
    out.append(reinterpret_cast<const char*>(buf + name_off[j]), name_len[j]);
    out.push_back('\t');
    out.append(num, snprintf(num, sizeof num, "%d", mm[j]));
    out.push_back('\t');
    out.push_back(strand);
    out.push_back('\t');
    out.append(reinterpret_cast<const char*>(seq), sl);
    out.push_back('\t');
    out.append(reinterpret_cast<const char*>(qual), ql);
    out.push_back('\n');
  }
  if (!main_s.empty()) flush(fd_main, main_s);
  if (!amb_s.empty()) flush(fd_amb, amb_s);
  if (!unm_s.empty()) flush(fd_unm, unm_s);
  return write_err;
}

// Batched SE SAM emission (write_single_batch SAM path, emit.py; per-line
// format is OutputSingleSAM, mapping.cpp:382-419).  Everything goes to the
// main fd; ambiguous/unmapped records are gated by flags and distinguished
// by FLAG bits 0x100/0x4.  starts are 0-based forward-chromosome coords
// (the +1 happens here).  Returns 0, or -1 on a write error.
int sam_emit_batch(int64_t n, int fd_main,
                   const uint8_t* buf, const int64_t* name_off,
                   const int32_t* name_len, const int64_t* qual_off,
                   const int32_t* qual_len, const uint8_t* seqbytes,
                   int32_t lmax, const int32_t* slens, const int32_t* times,
                   const uint8_t* minus, const int64_t* starts,
                   const int32_t* mm, const int32_t* chr_id,
                   const uint8_t* chr_names, const int64_t* chr_off,
                   const int32_t* chr_len, int ambiguous, int unmapped) {
  constexpr size_t kFlushAt = size_t{4} << 20;
  static std::string out;
  out.clear();
  int write_err = 0;
  char num[32];
  static std::vector<uint8_t> tmp;
  tmp.resize(static_cast<size_t>(lmax) + kMaxLine);
  auto rc = [](uint8_t b) -> uint8_t {
    return b == 'A' ? 'T' : b == 'C' ? 'G' : b == 'G' ? 'C'
           : b == 'T' ? 'A' : b;
  };
  for (int64_t j = 0; j < n; ++j) {
    if (out.size() > kFlushAt) {
      if (direct_write(fd_main, out.data(), out.size()) < 0) write_err = -1;
      out.clear();
    }
    int32_t t = times[j];
    bool neg = minus[j] != 0;
    if (t == 0 && !unmapped) continue;
    if (t >= 2 && !ambiguous) continue;
    int flag = (t == 0 ? 0x4 : 0) | (neg ? 0x10 : 0) | (t >= 2 ? 0x100 : 0);
    const uint8_t* seq = seqbytes + j * lmax;
    const uint8_t* qual = buf + qual_off[j];
    int32_t sl = slens[j], ql = qual_len[j];
    if (neg) {
      uint8_t* rs = tmp.data();
      uint8_t* rq = tmp.data() + lmax;
      for (int32_t k = 0; k < sl; ++k) rs[k] = rc(seq[sl - 1 - k]);
      for (int32_t k = 0; k < ql; ++k) rq[k] = qual[ql - 1 - k];
      seq = rs;
      qual = rq;
    }
    out.append(reinterpret_cast<const char*>(buf + name_off[j]), name_len[j]);
    out.push_back('\t');
    out.append(num, snprintf(num, sizeof num, "%d", flag));
    out.push_back('\t');
    if (t == 0) {
      out.append("*\t0\t255\t*\t*\t0\t0\t");
    } else {
      int32_t c = chr_id[j];
      out.append(reinterpret_cast<const char*>(chr_names + chr_off[c]),
                 chr_len[c]);
      out.push_back('\t');
      out.append(num, snprintf(num, sizeof num, "%lld",
                               static_cast<long long>(starts[j] + 1)));
      out.append("\t255\t", 5);
      out.append(num, snprintf(num, sizeof num, "%dM", sl));
      out.append("\t*\t0\t0\t", 7);
    }
    out.append(reinterpret_cast<const char*>(seq), sl);
    out.push_back('\t');
    out.append(reinterpret_cast<const char*>(qual), ql);
    out.append("\tNM:i:", 6);
    out.append(num, snprintf(num, sizeof num, "%d", t == 0 ? 0 : mm[j]));
    out.push_back('\n');
  }
  if (!out.empty() &&
      direct_write(fd_main, out.data(), out.size()) < 0) write_err = -1;
  return write_err;
}

// Batched paired-end SAM emission (the _emit_pair_finalized SAM path of
// core/paired_end + OutputPairedSAM, paired.cpp:333-435).  Per pair: FLAGs
// via GetSAMFLAG (paired.cpp:80-95), one line per mate, both to the main
// fd; ambiguous/unmapped mates gated by the amb/unm flags.  Display arrays
// (times/start/chr/mm/minus per mate; times==1 rows for unique pairs) are
// precomputed vectorized by the caller; frag is 0 for non-unique pairs.
// Returns 0, or -1 on a write error.
int pe_sam_emit_batch(
    int64_t n, int fd_main,
    const uint8_t* buf1, const int64_t* noff1, const int32_t* nlen1,
    const int64_t* qoff1, const int32_t* qlen1, const uint8_t* seqb1,
    int32_t lmax1, const int32_t* len1,
    const uint8_t* buf2, const int64_t* qoff2, const int32_t* qlen2,
    const uint8_t* seqb2, int32_t lmax2, const int32_t* len2,
    const uint8_t* code, const int32_t* frag,
    const int32_t* times1, const int64_t* start1, const int32_t* chr1,
    const int32_t* mm1, const uint8_t* minus1,
    const int32_t* times2, const int64_t* start2, const int32_t* chr2,
    const int32_t* mm2, const uint8_t* minus2,
    const uint8_t* chr_names, const int64_t* chr_off, const int32_t* chr_len,
    int ambiguous, int unmapped) {
  constexpr size_t kFlushAt = size_t{4} << 20;
  static std::string out;
  out.clear();
  int write_err = 0;
  char num[32];
  static std::vector<uint8_t> tmp;
  tmp.resize(static_cast<size_t>(lmax1 > lmax2 ? lmax1 : lmax2) + kMaxLine);
  auto rc = [](uint8_t b) -> uint8_t {
    return b == 'A' ? 'T' : b == 'C' ? 'G' : b == 'G' ? 'C'
           : b == 'T' ? 'A' : b;
  };
  auto put_num = [&](long long v) {
    out.append(num, snprintf(num, sizeof num, "%lld", v));
  };
  for (int64_t j = 0; j < n; ++j) {
    if (out.size() > kFlushAt) {
      if (direct_write(fd_main, out.data(), out.size()) < 0) write_err = -1;
      out.clear();
    }
    bool is_pm = code[j] == 0;
    int32_t t1 = times1[j], t2 = times2[j];
    bool n1 = minus1[j] != 0, n2 = minus2[j] != 0;
    int flag1 = 0x1 | (is_pm ? 0x2 : 0) | (t1 == 0 ? 0x4 : 0) |
                (t2 == 0 ? 0x8 : 0) | (n1 ? 0x10 : 0) | (n2 ? 0x20 : 0) |
                0x40 | (t1 >= 2 ? 0x100 : 0);
    int flag2 = 0x1 | (is_pm ? 0x2 : 0) | (t2 == 0 ? 0x4 : 0) |
                (t1 == 0 ? 0x8 : 0) | (n2 ? 0x10 : 0) | (n1 ? 0x20 : 0) |
                0x80 | (t2 >= 2 ? 0x100 : 0);
    // 1-based display starts; 0 when unmapped (paired_sam)
    long long s1 = t1 == 0 ? 0 : start1[j] + 1;
    long long s2 = t2 == 0 ? 0 : start2[j] + 1;
    int32_t m1 = t1 == 0 ? 0 : mm1[j];
    int32_t m2 = t2 == 0 ? 0 : mm2[j];
    long long fl = frag[j];
    for (int mate = 1; mate <= 2; ++mate) {
      int32_t t = mate == 1 ? t1 : t2;
      if (t == 0 && !unmapped) continue;
      if (t >= 2 && !ambiguous) continue;
      bool neg = mate == 1 ? n1 : n2;
      const uint8_t* seq = (mate == 1 ? seqb1 : seqb2) +
                           j * (mate == 1 ? lmax1 : lmax2);
      const uint8_t* qual = (mate == 1 ? buf1 : buf2) +
                            (mate == 1 ? qoff1 : qoff2)[j];
      int32_t sl = (mate == 1 ? len1 : len2)[j];
      int32_t ql = (mate == 1 ? qlen1 : qlen2)[j];
      if (neg) {
        uint8_t* rs = tmp.data();
        uint8_t* rq = tmp.data() + (mate == 1 ? lmax1 : lmax2);
        for (int32_t k = 0; k < sl; ++k) rs[k] = rc(seq[sl - 1 - k]);
        for (int32_t k = 0; k < ql; ++k) rq[k] = qual[ql - 1 - k];
        seq = rs;
        qual = rq;
      }
      int flag = mate == 1 ? flag1 : flag2;
      int32_t mt = mate == 1 ? t2 : t1;   // the OTHER mate
      int32_t mc = mate == 1 ? chr2[j] : chr1[j];
      long long ms = mate == 1 ? s2 : s1;
      long long tlen = neg ? -fl : fl;
      out.append(reinterpret_cast<const char*>(buf1 + noff1[j]), nlen1[j]);
      out.push_back('\t');
      put_num(flag);
      out.push_back('\t');
      if (t == 0) {
        out.append("*\t", 2);
        put_num(mate == 1 ? s1 : s2);
        out.append("\t255\t*\t", 7);
      } else {
        int32_t c = mate == 1 ? chr1[j] : chr2[j];
        out.append(reinterpret_cast<const char*>(chr_names + chr_off[c]),
                   chr_len[c]);
        out.push_back('\t');
        put_num(mate == 1 ? s1 : s2);
        out.append("\t255\t", 5);
        out.append(num, snprintf(num, sizeof num, "%dM", sl));
        out.push_back('\t');
      }
      // RNEXT: "=" when the pair mapped; else mate's chrom or "*"
      if (is_pm) {
        out.push_back('=');
      } else if (mt == 0) {
        out.push_back('*');
      } else {
        out.append(reinterpret_cast<const char*>(chr_names + chr_off[mc]),
                   chr_len[mc]);
      }
      out.push_back('\t');
      put_num(ms);
      out.push_back('\t');
      put_num(tlen);
      out.push_back('\t');
      out.append(reinterpret_cast<const char*>(seq), sl);
      out.push_back('\t');
      out.append(reinterpret_cast<const char*>(qual), ql);
      out.append("\tNM:i:", 6);
      put_num(mate == 1 ? m1 : m2);
      out.push_back('\n');
    }
  }
  if (!out.empty() &&
      direct_write(fd_main, out.data(), out.size()) < 0) write_err = -1;
  return write_err;
}

// Batched paired-end MR emission (the per-pair loop of
// core/paired_end.process_paired_end): for each pair either the merged
// FRAG record (OutputBestPairedResults, paired.cpp:210-294) or the two
// per-mate single records (OutputSingleResults, mapping.cpp:358-380, with
// mate 2 A/G-wildcard so its seq/qual report reverse-complemented).  All
// pair verdicts and forward-chromosome coordinates are precomputed
// (vectorized) by the caller; this function only splices bytes and formats
// lines.  Returns 0, or -1 on a write error.
int pe_emit_batch(
    int64_t n, int fd_main, int fd_amb1, int fd_unm1, int fd_amb2,
    int fd_unm2,
    // mate 1 batch (names + quals in buf1, seq text rows in seqb1)
    const uint8_t* buf1, const int64_t* noff1, const int32_t* nlen1,
    const int64_t* qoff1, const int32_t* qlen1, const uint8_t* seqb1,
    int32_t lmax1, const int32_t* len1,
    // mate 2 batch
    const uint8_t* buf2, const int64_t* qoff2, const int32_t* qlen2,
    const uint8_t* seqb2, int32_t lmax2, const int32_t* len2,
    const uint8_t* code,  // 0 unique, 1 ambiguous, 2 unmapped
    // unique pairs: forward-chrom coords of both mates + r1 strand
    const int32_t* uchr, const int64_t* s1, const int64_t* e1,
    const int64_t* s2, const int64_t* e2, const uint8_t* plus,
    const int32_t* r1mm, const int32_t* r2mm, const int32_t* frag,
    // non-unique pairs: per-mate BestMatch display data
    const int32_t* times1, const int64_t* start1, const int32_t* chr1,
    const int32_t* mm1, const uint8_t* minus1,
    const int32_t* times2, const int64_t* start2, const int32_t* chr2,
    const int32_t* mm2, const uint8_t* minus2,
    const uint8_t* chr_names, const int64_t* chr_off, const int32_t* chr_len,
    int32_t frag_range, int pbat) {
  constexpr size_t kFlushAt = size_t{4} << 20;
  static std::string main_s, amb1_s, unm1_s, amb2_s, unm2_s;
  main_s.clear();
  amb1_s.clear();
  unm1_s.clear();
  amb2_s.clear();
  unm2_s.clear();
  int write_err = 0;
  auto flush = [&](int fd, std::string& s) {
    if (direct_write(fd, s.data(), s.size()) < 0) write_err = -1;
    s.clear();
  };
  char num[32];
  auto put_num = [&](std::string& out, long long v) {
    out.append(num, snprintf(num, sizeof num, "%lld", v));
  };
  auto rc = [](uint8_t b) -> uint8_t {
    return b == 'A' ? 'T' : b == 'C' ? 'G' : b == 'G' ? 'C'
           : b == 'T' ? 'A' : b;
  };
  // merged fragment + per-mate revcomp scratch
  static std::vector<uint8_t> fseq, fqual, rbuf;
  fseq.reserve(4096);
  fqual.reserve(4096);
  rbuf.resize(static_cast<size_t>(lmax1 > lmax2 ? lmax1 : lmax2) + kMaxLine);

  // one mate's single record (emit.single_mr): ag-wildcard mates report
  // revcomp(seq) / reversed qual and a flipped strand character
  auto single = [&](int64_t j, int mate, std::string* main, std::string* amb,
                    std::string* unm) {
    bool ag = (mate == 2) != (pbat != 0);
    int32_t t = mate == 1 ? times1[j] : times2[j];
    std::string* out = t == 0 ? unm : (t == 1 ? main : amb);
    if (out == nullptr) return;
    const uint8_t* seq = (mate == 1 ? seqb1 : seqb2) +
                         j * (mate == 1 ? lmax1 : lmax2);
    const uint8_t* qual = (mate == 1 ? buf1 : buf2) +
                          (mate == 1 ? qoff1 : qoff2)[j];
    int32_t sl = (mate == 1 ? len1 : len2)[j];
    int32_t ql = (mate == 1 ? qlen1 : qlen2)[j];
    uint8_t* rs = rbuf.data();
    uint8_t* rq = rbuf.data() + (mate == 1 ? lmax1 : lmax2);
    if (ag) {
      for (int32_t k = 0; k < sl; ++k) rs[k] = rc(seq[sl - 1 - k]);
      for (int32_t k = 0; k < ql; ++k) rq[k] = qual[ql - 1 - k];
      seq = rs;
      qual = rq;
    }
    if (t == 0) {
      out->append(reinterpret_cast<const char*>(buf1 + noff1[j]), nlen1[j]);
      out->push_back('\t');
      out->append(reinterpret_cast<const char*>(seq), sl);
      out->push_back('\t');
      out->append(reinterpret_cast<const char*>(qual), ql);
      out->push_back('\n');
      return;
    }
    bool neg = (mate == 1 ? minus1 : minus2)[j] != 0;
    char strand = ag ? (neg ? '+' : '-') : (neg ? '-' : '+');
    int32_t c = (mate == 1 ? chr1 : chr2)[j];
    int64_t st = (mate == 1 ? start1 : start2)[j];
    out->append(reinterpret_cast<const char*>(chr_names + chr_off[c]),
                chr_len[c]);
    out->push_back('\t');
    put_num(*out, st);
    out->push_back('\t');
    put_num(*out, st + sl);
    out->push_back('\t');
    out->append(reinterpret_cast<const char*>(buf1 + noff1[j]), nlen1[j]);
    out->push_back('\t');
    put_num(*out, (mate == 1 ? mm1 : mm2)[j]);
    out->push_back('\t');
    out->push_back(strand);
    out->push_back('\t');
    out->append(reinterpret_cast<const char*>(seq), sl);
    out->push_back('\t');
    out->append(reinterpret_cast<const char*>(qual), ql);
    out->push_back('\n');
  };

  for (int64_t j = 0; j < n; ++j) {
    if (main_s.size() > kFlushAt) flush(fd_main, main_s);
    if (amb1_s.size() > kFlushAt) flush(fd_amb1, amb1_s);
    if (unm1_s.size() > kFlushAt) flush(fd_unm1, unm1_s);
    if (amb2_s.size() > kFlushAt) flush(fd_amb2, amb2_s);
    if (unm2_s.size() > kFlushAt) flush(fd_unm2, unm2_s);
    if (code[j] != 0) {
      single(j, 1, &main_s, fd_amb1 >= 0 ? &amb1_s : nullptr,
             fd_unm1 >= 0 ? &unm1_s : nullptr);
      single(j, 2, &main_s, fd_amb2 >= 0 ? &amb2_s : nullptr,
             fd_unm2 >= 0 ? &unm2_s : nullptr);
      continue;
    }
    // unique pair: merged fragment (OutputBestPairedResults)
    int64_t S1 = s1[j], E1 = e1[j], S2 = s2[j], E2 = e2[j];
    bool pl = plus[j] != 0;
    int64_t ov_s = S1 > S2 ? S1 : S2, ov_e = E1 < E2 ? E1 : E2;
    int64_t one_l = pl ? S1 : (ov_e > S1 ? ov_e : S1);
    int64_t one_r = pl ? (ov_s < E1 ? ov_s : E1) : E1;
    int64_t two_l = pl ? (ov_e > S2 ? ov_e : S2) : S2;
    int64_t two_r = pl ? E2 : (ov_s < E2 ? ov_s : E2);
    int64_t fl = frag[j];
    int64_t show = fl > 0 ? fl : 0;
    fseq.assign(show, 'N');
    fqual.assign(show, 'B');
    const uint8_t* q1 = buf1 + qoff1[j];
    const uint8_t* q2 = buf2 + qoff2[j];
    const uint8_t* sq1 = seqb1 + j * lmax1;
    const uint8_t* sq2 = seqb2 + j * lmax2;
    int32_t L1 = len1[j], L2 = len2[j];
    if (fl > 0 && fl <= frag_range) {
      int64_t lim_one = one_r - one_l;
      for (int64_t k = 0; k < lim_one; ++k) {
        fseq[k] = sq1[k];
        fqual[k] = q1[k];
      }
      int64_t lim_two = two_r - two_l;
      // mate 2 reports reverse-complemented: rev index into sq2/q2
      for (int64_t k = 0; k < lim_two; ++k) {
        int64_t dst = fl - lim_two + k;
        int64_t src = (L2 - lim_two + k);  // index into seq2_rev
        fseq[dst] = rc(sq2[L2 - 1 - src]);
        fqual[dst] = q2[L2 - 1 - src];
      }
      if (ov_s < ov_e) {
        int32_t n1c = 0, n2c = 0;
        for (int32_t k = 0; k < L1; ++k) n1c += sq1[k] == 'N';
        for (int32_t k = 0; k < L2; ++k) n2c += sq2[k] == 'N';
        int32_t info_one = L1 - (n1c + r1mm[j]);
        int32_t info_two = L2 - (n2c + r2mm[j]);
        if (info_one >= info_two) {
          int64_t a = pl ? ov_s - S1 : E1 - ov_e;
          int64_t b = pl ? ov_e - S1 : E1 - ov_s;
          for (int64_t k = 0; k < b - a; ++k) {
            fseq[lim_one + k] = sq1[a + k];
            fqual[lim_one + k] = q1[a + k];
          }
        } else {
          int64_t a = pl ? ov_s - S2 : E2 - ov_e;
          int64_t b = pl ? ov_e - S2 : E2 - ov_s;
          for (int64_t k = 0; k < b - a; ++k) {
            fseq[lim_one + k] = rc(sq2[L2 - 1 - (a + k)]);
            fqual[lim_one + k] = q2[L2 - 1 - (a + k)];
          }
        }
      }
    }
    int64_t start_pos = pl ? S1 : S2;
    int32_t c = uchr[j];
    std::string& out = main_s;
    out.append(reinterpret_cast<const char*>(chr_names + chr_off[c]),
               chr_len[c]);
    out.push_back('\t');
    put_num(out, start_pos);
    out.push_back('\t');
    put_num(out, start_pos + fl);
    out.push_back('\t');
    out.append("FRAG:", 5);
    out.append(reinterpret_cast<const char*>(buf1 + noff1[j]), nlen1[j]);
    out.push_back('\t');
    put_num(out, r1mm[j] + r2mm[j]);
    out.push_back('\t');
    out.push_back(pl ? '+' : '-');
    out.push_back('\t');
    out.append(reinterpret_cast<const char*>(fseq.data()), fseq.size());
    out.push_back('\t');
    out.append(reinterpret_cast<const char*>(fqual.data()), fqual.size());
    out.push_back('\n');
  }
  if (!main_s.empty()) flush(fd_main, main_s);
  if (!amb1_s.empty()) flush(fd_amb1, amb1_s);
  if (!unm1_s.empty()) flush(fd_unm1, unm1_s);
  if (!amb2_s.empty()) flush(fd_amb2, amb2_s);
  if (!unm2_s.empty()) flush(fd_unm2, unm2_s);
  return write_err;
}

}  // extern "C"
