// Native FASTA/FASTQ parser + 2-bit-code encoder.
//
// Reference counterpart: SURVEY.md R1/R2 (Python FASTA reader + base encoder).
// The device pipeline consumes dense [R, read_len] int8 code matrices (A=0 C=1
// G=2 T=3, N/pad=4); parsing millions of reads in Python dominates host time,
// so this single-pass C++ codec writes the code matrix directly from the raw
// file bytes. Quality masking (phred < min_qual -> N) happens in the same pass
// (SPEC config 3). Exposed as plain C symbols for ctypes (no pybind11 in this
// environment); gzip inputs fall back to the Python path.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = st.st_size;
  madvise(p, st.st_size, MADV_SEQUENTIAL);
  return m;
}

void unmap(Mapped& m) {
  if (m.data) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
}

// base -> 2-bit code lookup (A/a=0 C/c=1 G/g=2 T/t=3, everything else 4)
struct Lut {
  int8_t v[256];
  Lut() {
    memset(v, 4, sizeof(v));
    v[(unsigned char)'A'] = v[(unsigned char)'a'] = 0;
    v[(unsigned char)'C'] = v[(unsigned char)'c'] = 1;
    v[(unsigned char)'G'] = v[(unsigned char)'g'] = 2;
    v[(unsigned char)'T'] = v[(unsigned char)'t'] = 3;
  }
};
const Lut kLut;

inline const char* next_line(const char* p, const char* end) {
  const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
  return nl ? nl + 1 : end;
}

// Encode one sequence line span into a row of the output matrix.
inline void encode_row(const char* seq, size_t seq_len, const char* qual,
                       int8_t min_qual, int8_t* row, int32_t read_len) {
  size_t n = seq_len < (size_t)read_len ? seq_len : (size_t)read_len;
  for (size_t i = 0; i < n; ++i) row[i] = kLut.v[(unsigned char)seq[i]];
  if (qual && min_qual > 0) {
    const char thresh = (char)(min_qual + 33);
    for (size_t i = 0; i < n; ++i)
      if (qual[i] < thresh) row[i] = 4;
  }
  if (n < (size_t)read_len) memset(row + n, 4, read_len - n);
}

// --- byte-range resync (per-host file shards, SURVEY.md D2) ---------------
//
// A shard owns the records that START inside its byte range [begin, end);
// ranges are resynced forward to the next record boundary, so N shards
// covering [0, size) parse every record exactly once and each host touches
// only ~size/N bytes (vs. record striding, which re-parses the whole file on
// every host).

inline int64_t line_len(const char* s, const char* after) {
  return (after - s) - (after > s && after[-1] == '\n' ? 1 : 0);
}

// First FASTQ record start at or after byte `off`. A line is a record header
// iff it starts with '@', the line two below starts with '+', and the
// sequence/quality line lengths match (guards against '@' in quality lines).
int64_t fq_resync(const char* data, int64_t size, int64_t off) {
  if (off <= 0) return 0;
  if (off >= size) return size;
  const char* end = data + size;
  const char* p = data + off;
  if (data[off - 1] != '\n') p = next_line(p, end);
  while (p < end) {
    if (*p == '@') {
      const char* l1 = next_line(p, end);
      const char* l2 = next_line(l1, end);
      if (l2 < end && *l2 == '+') {
        const char* l3 = next_line(l2, end);
        const char* l4 = next_line(l3, end);
        if (line_len(l1, l2) == line_len(l3, l4)) return p - data;
      }
    }
    p = next_line(p, end);
  }
  return size;
}

// First FASTA record start ('>' at line start) at or after byte `off`.
int64_t fa_resync(const char* data, int64_t size, int64_t off) {
  if (off <= 0) return 0;
  if (off >= size) return size;
  const char* end = data + size;
  const char* p = data + off;
  if (data[off - 1] != '\n') p = next_line(p, end);
  while (p < end && *p != '>') p = next_line(p, end);
  return p - data;
}

}  // namespace

extern "C" {

// Scan a FASTQ file: record count and maximum sequence length.
// Returns 0 on success, -1 on open failure.
int fq_scan(const char* path, int64_t* n_reads, int64_t* max_len) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t count = 0, maxlen = 0;
  while (p < end) {
    if (*p != '@') break;  // malformed; stop
    p = next_line(p, end);                       // header
    const char* seq = p;
    p = next_line(p, end);                       // sequence
    int64_t len = (p - seq) - (p > seq && p[-1] == '\n' ? 1 : 0);
    if (len > maxlen) maxlen = len;
    p = next_line(p, end);                       // +
    p = next_line(p, end);                       // qual
    ++count;
  }
  unmap(m);
  *n_reads = count;
  *max_len = maxlen;
  return 0;
}

// Parse + encode a FASTQ file into out[max_reads][read_len] (int8, row-major).
// Reads shorter than min_len_keep are skipped. Returns number of rows written,
// or -1 on open failure.
int64_t fq_encode(const char* path, int8_t* out, int64_t max_reads,
                  int32_t read_len, int8_t min_qual, int32_t min_len_keep) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t r = 0;
  while (p < end && r < max_reads) {
    if (*p != '@') break;
    p = next_line(p, end);
    const char* seq = p;
    p = next_line(p, end);
    int64_t slen = (p - seq) - (p > seq && p[-1] == '\n' ? 1 : 0);
    p = next_line(p, end);  // +
    const char* qual = p;
    p = next_line(p, end);
    if (slen >= min_len_keep) {
      encode_row(seq, slen, min_qual > 0 ? qual : nullptr, min_qual,
                 out + r * (int64_t)read_len, read_len);
      ++r;
    }
  }
  unmap(m);
  return r;
}

// Scan a FASTA file: record count and maximum sequence length (multi-line
// records are concatenated).
int fa_scan(const char* path, int64_t* n_reads, int64_t* max_len) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t count = 0, maxlen = 0, cur = -1;
  while (p < end) {
    if (*p == '>') {
      if (cur > maxlen) maxlen = cur;
      ++count;
      cur = 0;
      p = next_line(p, end);
    } else {
      const char* seq = p;
      p = next_line(p, end);
      int64_t len = (p - seq) - (p > seq && p[-1] == '\n' ? 1 : 0);
      if (cur >= 0) cur += len;  // ignore junk before the first header
    }
  }
  if (cur > maxlen) maxlen = cur;
  unmap(m);
  *n_reads = count;
  *max_len = maxlen;
  return 0;
}

// Parse + encode a FASTA file. Multi-line sequences are concatenated, then
// truncated/padded to read_len. Returns rows written, or -1 on open failure.
int64_t fa_encode(const char* path, int8_t* out, int64_t max_reads,
                  int32_t read_len, int32_t min_len_keep) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t r = 0;
  int8_t* row = nullptr;
  int64_t filled = -1;  // -1 = no open record
  while (p < end && r < max_reads) {
    if (*p == '>') {
      if (filled >= 0) {  // close previous record
        if (filled >= min_len_keep) {
          if (filled < read_len) memset(row + filled, 4, read_len - filled);
          ++r;
        }
      }
      row = out + r * (int64_t)read_len;
      filled = 0;
      p = next_line(p, end);
    } else {
      const char* seq = p;
      p = next_line(p, end);
      int64_t len = (p - seq) - (p > seq && p[-1] == '\n' ? 1 : 0);
      if (filled < 0) continue;  // junk before first header
      for (int64_t i = 0; i < len && filled < read_len; ++i, ++filled)
        row[filled] = kLut.v[(unsigned char)seq[i]];
      if (filled >= read_len) {
        // keep consuming but drop overflow (record truncated at read_len)
        filled = read_len;
      }
    }
  }
  if (filled >= 0 && r < max_reads && filled >= min_len_keep) {
    if (filled < read_len) memset(row + filled, 4, read_len - filled);
    ++r;
  }
  unmap(m);
  return r;
}

// Scan one byte-range shard of a FASTQ file: count + max length of records
// STARTING in [begin, end) after resync. shard i of n passes
// begin = i*size/n, end = (i+1)*size/n (any cover of [0, size) works).
int fq_scan_range(const char* path, int64_t begin, int64_t end_off,
                  int64_t* n_reads, int64_t* max_len) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const int64_t b = fq_resync(m.data, m.size, begin);
  const int64_t e = fq_resync(m.data, m.size, end_off);
  const char* p = m.data + b;
  const char* stop = m.data + e;  // records must START before stop
  const char* end = m.data + m.size;
  int64_t count = 0, maxlen = 0;
  while (p < stop) {
    if (*p != '@') break;
    p = next_line(p, end);
    const char* seq = p;
    p = next_line(p, end);
    int64_t len = line_len(seq, p);
    if (len > maxlen) maxlen = len;
    p = next_line(p, end);
    p = next_line(p, end);
    ++count;
  }
  unmap(m);
  *n_reads = count;
  *max_len = maxlen;
  return 0;
}

// Parse + encode one byte-range shard of a FASTQ file (see fq_scan_range).
int64_t fq_encode_range(const char* path, int64_t begin, int64_t end_off,
                        int8_t* out, int64_t max_reads, int32_t read_len,
                        int8_t min_qual, int32_t min_len_keep) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const int64_t b = fq_resync(m.data, m.size, begin);
  const int64_t e = fq_resync(m.data, m.size, end_off);
  const char* p = m.data + b;
  const char* stop = m.data + e;
  const char* end = m.data + m.size;
  int64_t r = 0;
  while (p < stop && r < max_reads) {
    if (*p != '@') break;
    p = next_line(p, end);
    const char* seq = p;
    p = next_line(p, end);
    int64_t slen = line_len(seq, p);
    p = next_line(p, end);
    const char* qual = p;
    p = next_line(p, end);
    if (slen >= min_len_keep) {
      encode_row(seq, slen, min_qual > 0 ? qual : nullptr, min_qual,
                 out + r * (int64_t)read_len, read_len);
      ++r;
    }
  }
  unmap(m);
  return r;
}

// Scan one byte-range shard of a FASTA file (records starting in range;
// multi-line records owned by this shard are followed past end_off).
int fa_scan_range(const char* path, int64_t begin, int64_t end_off,
                  int64_t* n_reads, int64_t* max_len) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const int64_t b = fa_resync(m.data, m.size, begin);
  const int64_t e = fa_resync(m.data, m.size, end_off);
  const char* p = m.data + b;
  const char* stop = m.data + e;
  const char* end = m.data + m.size;
  int64_t count = 0, maxlen = 0, cur = -1;
  while (p < end) {
    if (*p == '>') {
      if (p >= stop) break;  // next shard's record
      if (cur > maxlen) maxlen = cur;
      ++count;
      cur = 0;
      p = next_line(p, end);
    } else {
      const char* seq = p;
      p = next_line(p, end);
      if (cur >= 0) cur += line_len(seq, p);
    }
  }
  if (cur > maxlen) maxlen = cur;
  unmap(m);
  *n_reads = count;
  *max_len = maxlen;
  return 0;
}

// Parse + encode one byte-range shard of a FASTA file (see fa_scan_range).
int64_t fa_encode_range(const char* path, int64_t begin, int64_t end_off,
                        int8_t* out, int64_t max_reads, int32_t read_len,
                        int32_t min_len_keep) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const int64_t b = fa_resync(m.data, m.size, begin);
  const int64_t e = fa_resync(m.data, m.size, end_off);
  const char* p = m.data + b;
  const char* stop = m.data + e;
  const char* end = m.data + m.size;
  int64_t r = 0;
  int8_t* row = nullptr;
  int64_t filled = -1;
  while (p < end && r < max_reads) {
    if (*p == '>') {
      if (filled >= 0 && filled >= min_len_keep) {
        if (filled < read_len) memset(row + filled, 4, read_len - filled);
        ++r;
      }
      if (p >= stop || r >= max_reads) {
        filled = -1;  // next shard's record (or out of rows)
        break;
      }
      row = out + r * (int64_t)read_len;
      filled = 0;
      p = next_line(p, end);
    } else {
      const char* seq = p;
      p = next_line(p, end);
      int64_t len = line_len(seq, p);
      if (filled < 0) continue;
      for (int64_t i = 0; i < len && filled < read_len; ++i, ++filled)
        row[filled] = kLut.v[(unsigned char)seq[i]];
      if (filled >= read_len) filled = read_len;
    }
  }
  if (filled >= 0 && r < max_reads && filled >= min_len_keep) {
    if (filled < read_len) memset(row + filled, 4, read_len - filled);
    ++r;
  }
  unmap(m);
  return r;
}

// Pack an [R, L] int8 code matrix for H2D transfer (2.25 bits/base): packed
// [R, ceil(L/4)] uint8 little-endian 2-bit groups, nmask [R, ceil(L/8)] uint8
// 1 bit per base set where the code is N/pad (>=4 or <0). Bit-compatible with
// the numpy reference tpu_euler/io/encode.py:pack_codes_np (pads past L count
// as N). Threaded over row blocks; the numpy path costs ~150 ms per 2^18x100
// batch on this host, which is on the benchmark's critical path.
void pack_codes(const int8_t* codes, int64_t R, int32_t L, uint8_t* packed,
                uint8_t* nmask, int32_t n_threads) {
  const int32_t L4 = (L + 3) / 4, L8 = (L + 7) / 8;
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const int8_t* row = codes + r * (int64_t)L;
      uint8_t* prow = packed + r * (int64_t)L4;
      uint8_t* nrow = nmask + r * (int64_t)L8;
      for (int32_t j = 0; j < L4; ++j) {
        uint8_t acc = 0;
        const int32_t base = 4 * j;
        const int32_t lim = (L - base) < 4 ? (L - base) : 4;
        for (int32_t b = 0; b < lim; ++b)
          acc |= (uint8_t)(row[base + b] & 3) << (2 * b);
        prow[j] = acc;
      }
      for (int32_t j = 0; j < L8; ++j) {
        uint8_t acc = 0;
        const int32_t base = 8 * j;
        for (int32_t b = 0; b < 8; ++b) {
          const int32_t i = base + b;
          const bool n = (i >= L) || (row[i] >= 4) || (row[i] < 0);
          acc |= (uint8_t)(n ? 1 : 0) << b;
        }
        nrow[j] = acc;
      }
    }
  };
  if (n_threads == 1 || R < 4096) {
    work(0, R);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t step = (R + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t r0 = t * step;
    const int64_t r1 = (r0 + step) < R ? (r0 + step) : R;
    if (r0 >= r1) break;
    ts.emplace_back(work, r0, r1);
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
