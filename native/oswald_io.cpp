// oswald_io: native IO layer for oswald-tpu.
//
// Native replacement for the hot host-side data path, mirroring the role of
// the reference's C host data layer (/root/reference/host/src/sequences.c:
// preprocess_db :4-220, load_query_sequences :223-391) and its vendored
// C++ utility layer (common/src/AOCL_Utils.cpp).  The device compute path is
// JAX/Pallas; this library feeds it:
//
//   - oswald_fasta_scan:   single pass over a FASTA buffer -> record count,
//                          per-record residue lengths, encoded residues
//                          (codes 0..23, J/O/U and unknown bytes -> dummy),
//                          header byte ranges.  OpenMP-parallel over chunks.
//   - oswald_pack_group:   scatter length-sorted encoded sequences into one
//                          [L, 1024] lane-major group (the [8,128] VPU tile
//                          flattened), dummy-padded.
//
// Exact behavioral parity with the Python implementation in
// oswald_tpu/io/fasta.py is enforced by tests/test_native_io.py.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int8_t kDummy = 23;

// residue LUT matching oswald_tpu.alphabet: 'A'..'Z' minus J/O/U densely
// mapped to 0..22 (case-insensitive), everything else dummy.
struct Lut {
  int8_t m[256];
  bool skip[256];  // bytes dropped inside sequence lines: \r, space, \t
  Lut() {
    const char* alpha = "ABCDEFGHIKLMNPQRSTVWXYZ";
    for (int i = 0; i < 256; ++i) m[i] = kDummy;
    for (int i = 0; alpha[i]; ++i) {
      m[(unsigned char)alpha[i]] = (int8_t)i;
      m[(unsigned char)(alpha[i] + 32)] = (int8_t)i;
    }
    for (int i = 0; i < 256; ++i) skip[i] = false;
    skip[(unsigned char)'\r'] = skip[(unsigned char)' '] =
        skip[(unsigned char)'\t'] = true;
  }
};
const Lut kLut;

}  // namespace

extern "C" {

// Pass 1: count records and the total residue bytes (upper bound: all
// non-header, non-newline, non-skip bytes).  Returns record count.
int64_t oswald_fasta_count(const uint8_t* buf, int64_t n,
                           int64_t* total_residues_ub) {
  int64_t records = 0, resid = 0;
  bool at_line_start = true, in_header = false;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t c = buf[i];
    if (at_line_start) {
      in_header = (c == '>');
      if (in_header) ++records;
      at_line_start = false;
    }
    if (c == '\n') {
      at_line_start = true;
      in_header = false;
      continue;
    }
    if (!in_header && !kLut.skip[c]) ++resid;
  }
  *total_residues_ub = resid;
  return records;
}

// Pass 2: encode residues and record lengths + header extents.
// Preconditions: arrays sized from oswald_fasta_count.
//   seq_out:       int8 [total_residues_ub]
//   lengths_out:   int64 [records]
//   hdr_starts/hdr_ends: int64 [records], byte offsets of header text
//                  (after '>', up to but excluding '\n'/'\r')
// Returns number of residues written (== sum(lengths_out)).
int64_t oswald_fasta_encode(const uint8_t* buf, int64_t n, int8_t* seq_out,
                            int64_t* lengths_out, int64_t* hdr_starts,
                            int64_t* hdr_ends) {
  int64_t rec = -1, w = 0;
  bool at_line_start = true, in_header = false;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t c = buf[i];
    if (at_line_start) {
      in_header = (c == '>');
      if (in_header) {
        ++rec;
        lengths_out[rec] = 0;
        hdr_starts[rec] = i + 1;
        hdr_ends[rec] = i + 1;
      }
      at_line_start = false;
    }
    if (c == '\n') {
      at_line_start = true;
      in_header = false;
      continue;
    }
    if (in_header) {
      if (c != '\r') hdr_ends[rec] = i + 1;
    } else if (rec >= 0 && !kLut.skip[c]) {
      seq_out[w++] = kLut.m[c];
      ++lengths_out[rec];
    }
  }
  return w;
}

// Pack one group of up to 1024 length-sorted sequences into a lane-major
// [L, 1024] int8 block (dummy-padded), the flattened [L, 8, 128] VPU tile.
//   seqs:     concatenated encoded residues
//   offsets:  int64 [count+1] into seqs (sequence k = [offsets[k],
//             offsets[k+1]))
//   count:    sequences in this group (<= 1024); lanes >= count stay dummy
//   L:        padded group length
//   out:      int8 [L * 1024]
void oswald_pack_group(const int8_t* seqs, const int64_t* offsets,
                       int64_t count, int64_t L, int8_t* out) {
  std::memset(out, kDummy, (size_t)(L * 1024));
  for (int64_t k = 0; k < count; ++k) {
    const int8_t* src = seqs + offsets[k];
    int64_t len = offsets[k + 1] - offsets[k];
    if (len > L) len = L;
    for (int64_t p = 0; p < len; ++p) out[p * 1024 + k] = src[p];
  }
}

// Pack many groups in parallel (OpenMP over groups).
//   group_starts: int64 [n_groups+1], sequence index where each group begins
//   offsets:      int64 [total_seqs+1]
//   Ls:           int64 [n_groups] padded lengths
//   outs:         int8, concatenated [L_g * 1024] blocks in group order
//   out_offsets:  int64 [n_groups] byte offset of each group's block in outs
void oswald_pack_groups(const int8_t* seqs, const int64_t* offsets,
                        const int64_t* group_starts, int64_t n_groups,
                        const int64_t* Ls, int8_t* outs,
                        const int64_t* out_offsets) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t g = 0; g < n_groups; ++g) {
    int64_t lo = group_starts[g], hi = group_starts[g + 1];
    oswald_pack_group(seqs, offsets + lo, hi - lo, Ls[g],
                      outs + out_offsets[g]);
  }
}

// ---- OpenMP-parallel scan (the bulk-preprocess path) ----
//
// The buffer splits into per-thread chunks cut at line starts, so every
// chunk begins with a fully determined parser state (at_line_start=true;
// in_header depends only on the first byte).  Record indices and residue
// write offsets are resolved with a counting pass + prefix sums; residues
// of a record that straddles a chunk boundary land contiguously because
// write offsets are prefix sums in file order.

namespace {

struct ChunkMeta {
  int64_t recs;    // records starting in this chunk
  int64_t r_pre;   // residue bytes before the chunk's first header
  int64_t r_post;  // residue bytes at/after the chunk's first header
};

void chunk_bounds(const uint8_t* buf, int64_t n, int nt,
                  std::vector<int64_t>* cb) {
  cb->assign(nt + 1, 0);
  (*cb)[nt] = n;
  for (int t = 1; t < nt; ++t) {
    int64_t p = n * t / nt;
    while (p < n && buf[p - 1] != '\n') ++p;
    (*cb)[t] = p;
  }
  for (int t = 1; t < nt; ++t)
    if ((*cb)[t] < (*cb)[t - 1]) (*cb)[t] = (*cb)[t - 1];
}

void scan_chunk(const uint8_t* buf, int64_t lo, int64_t hi, ChunkMeta* m) {
  int64_t recs = 0, r_pre = 0, r_post = 0;
  bool at_ls = true, in_hdr = false, seen = false;
  for (int64_t i = lo; i < hi; ++i) {
    uint8_t c = buf[i];
    if (at_ls) {
      in_hdr = (c == '>');
      if (in_hdr) {
        ++recs;
        seen = true;
      }
      at_ls = false;
    }
    if (c == '\n') {
      at_ls = true;
      in_hdr = false;
      continue;
    }
    if (!in_hdr && !kLut.skip[c]) {
      if (seen) ++r_post;
      else ++r_pre;
    }
  }
  m->recs = recs;
  m->r_pre = r_pre;
  m->r_post = r_post;
}

int num_chunks(int64_t n) {
#ifdef _OPENMP
  if (n >= (int64_t)4 << 20) return omp_get_max_threads();
#endif
  (void)n;
  return 1;
}

}  // namespace

int64_t oswald_fasta_count_mt(const uint8_t* buf, int64_t n,
                              int64_t* total_residues_ub) {
  int nt = num_chunks(n);
  if (nt <= 1) return oswald_fasta_count(buf, n, total_residues_ub);
  std::vector<int64_t> cb;
  chunk_bounds(buf, n, nt, &cb);
  std::vector<ChunkMeta> meta(nt);
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int t = 0; t < nt; ++t) scan_chunk(buf, cb[t], cb[t + 1], &meta[t]);
  int64_t recs = 0, resid = 0;
  for (int t = 0; t < nt; ++t) {
    recs += meta[t].recs;
    resid += meta[t].r_pre + meta[t].r_post;  // UB like the serial count
  }
  *total_residues_ub = resid;
  return recs;
}

int64_t oswald_fasta_encode_mt(const uint8_t* buf, int64_t n,
                               int8_t* seq_out, int64_t* lengths_out,
                               int64_t* hdr_starts, int64_t* hdr_ends) {
  int nt = num_chunks(n);
  if (nt <= 1)
    return oswald_fasta_encode(buf, n, seq_out, lengths_out, hdr_starts,
                               hdr_ends);
  std::vector<int64_t> cb;
  chunk_bounds(buf, n, nt, &cb);
  std::vector<ChunkMeta> meta(nt);
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int t = 0; t < nt; ++t) scan_chunk(buf, cb[t], cb[t + 1], &meta[t]);
  std::vector<int64_t> rec_base(nt + 1, 0), w_base(nt + 1, 0);
  for (int t = 0; t < nt; ++t) {
    rec_base[t + 1] = rec_base[t] + meta[t].recs;
    // residues before a chunk's first header belong to the carry-in
    // record; with no record before the chunk they are dropped (content
    // before the file's first '>')
    int64_t resid = meta[t].r_post + (rec_base[t] > 0 ? meta[t].r_pre : 0);
    w_base[t + 1] = w_base[t] + resid;
  }
  std::vector<int64_t> carry_len(nt, 0);
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int t = 0; t < nt; ++t) {
    int64_t rec = rec_base[t] - 1;  // carry-in record (-1: none yet)
    int64_t w = w_base[t], clen = 0;
    bool at_ls = true, in_hdr = false;
    for (int64_t i = cb[t]; i < cb[t + 1]; ++i) {
      uint8_t c = buf[i];
      if (at_ls) {
        in_hdr = (c == '>');
        if (in_hdr) {
          ++rec;
          lengths_out[rec] = 0;
          hdr_starts[rec] = i + 1;
          hdr_ends[rec] = i + 1;
        }
        at_ls = false;
      }
      if (c == '\n') {
        at_ls = true;
        in_hdr = false;
        continue;
      }
      if (in_hdr) {
        if (c != '\r') hdr_ends[rec] = i + 1;
      } else if (rec >= 0 && !kLut.skip[c]) {
        seq_out[w++] = kLut.m[c];
        if (rec >= rec_base[t]) ++lengths_out[rec];
        else ++clen;  // carry-in record: resolved serially below
      }
    }
    carry_len[t] = clen;
  }
  for (int t = 0; t < nt; ++t)
    if (rec_base[t] > 0 && carry_len[t])
      lengths_out[rec_base[t] - 1] += carry_len[t];
  return w_base[nt];
}

// Like encode_mt but ALSO emits every header's bytes + '\n' into
// titles_out (the bulk-preprocess path: one walk produces residues,
// lengths, extents and the spill-ready title byte stream, replacing a
// numpy gather that cost more than the scan itself).  Header lines never
// straddle chunks (chunks are cut at line starts), so title bytes need
// only a per-chunk prefix sum.  titles_out must hold n bytes (UB);
// *titles_written gets the byte count.
int64_t oswald_fasta_encode_titles_mt(const uint8_t* buf, int64_t n,
                                      int8_t* seq_out, int64_t* lengths_out,
                                      int64_t* hdr_starts, int64_t* hdr_ends,
                                      uint8_t* titles_out,
                                      int64_t* titles_written) {
  int nt = num_chunks(n);
  std::vector<int64_t> cb;
  chunk_bounds(buf, n, nt, &cb);
  std::vector<ChunkMeta> meta(nt);
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int t = 0; t < nt; ++t) scan_chunk(buf, cb[t], cb[t + 1], &meta[t]);
  std::vector<int64_t> rec_base(nt + 1, 0), w_base(nt + 1, 0);
  for (int t = 0; t < nt; ++t) {
    rec_base[t + 1] = rec_base[t] + meta[t].recs;
    int64_t resid = meta[t].r_post + (rec_base[t] > 0 ? meta[t].r_pre : 0);
    w_base[t + 1] = w_base[t] + resid;
  }
  // title byte counts need a per-chunk pre-pass (header bytes incl. the
  // '\n' separator, excluding '\r' and the '>')
  std::vector<int64_t> t_base(nt + 1, 0);
  {
    std::vector<int64_t> tcount(nt, 0);
#ifdef _OPENMP
#pragma omp parallel for
#endif
    for (int t = 0; t < nt; ++t) {
      int64_t bytes = 0;
      bool at_ls = true, in_hdr = false;
      int64_t h_start = 0, h_end = 0;
      for (int64_t i = cb[t]; i < cb[t + 1]; ++i) {
        uint8_t c = buf[i];
        if (at_ls) {
          if (in_hdr) bytes += (h_end - h_start) + 1;  // flushed on '\n'
          in_hdr = (c == '>');
          if (in_hdr) {
            h_start = i + 1;
            h_end = i + 1;
          }
          at_ls = false;
        }
        if (c == '\n') {
          at_ls = true;
          continue;
        }
        if (in_hdr && c != '\r') h_end = i + 1;
      }
      if (in_hdr) bytes += (h_end - h_start) + 1;
      tcount[t] = bytes;
    }
    for (int t = 0; t < nt; ++t) t_base[t + 1] = t_base[t] + tcount[t];
  }
  std::vector<int64_t> carry_len(nt, 0);
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int t = 0; t < nt; ++t) {
    int64_t rec = rec_base[t] - 1;
    int64_t w = w_base[t], tw = t_base[t], clen = 0;
    bool at_ls = true, in_hdr = false;
    for (int64_t i = cb[t]; i < cb[t + 1]; ++i) {
      uint8_t c = buf[i];
      if (at_ls) {
        if (in_hdr) {  // flush previous header's title + separator
          int64_t hl = hdr_ends[rec] - hdr_starts[rec];
          std::memcpy(titles_out + tw, buf + hdr_starts[rec], (size_t)hl);
          tw += hl;
          titles_out[tw++] = '\n';
        }
        in_hdr = (c == '>');
        if (in_hdr) {
          ++rec;
          lengths_out[rec] = 0;
          hdr_starts[rec] = i + 1;
          hdr_ends[rec] = i + 1;
        }
        at_ls = false;
      }
      if (c == '\n') {
        at_ls = true;
        continue;
      }
      if (in_hdr) {
        if (c != '\r') hdr_ends[rec] = i + 1;
      } else if (rec >= 0 && !kLut.skip[c]) {
        seq_out[w++] = kLut.m[c];
        if (rec >= rec_base[t]) ++lengths_out[rec];
        else ++clen;
      }
    }
    if (in_hdr) {  // header line is the chunk's last line
      int64_t hl = hdr_ends[rec] - hdr_starts[rec];
      std::memcpy(titles_out + tw, buf + hdr_starts[rec], (size_t)hl);
      tw += hl;
      titles_out[tw++] = '\n';
    }
    carry_len[t] = clen;
  }
  for (int t = 0; t < nt; ++t)
    if (rec_base[t] > 0 && carry_len[t])
      lengths_out[rec_base[t] - 1] += carry_len[t];
  *titles_written = t_base[nt];
  return w_base[nt];
}

// Parallel span gather: out[dst_off[k] : dst_off[k]+lens[k]] =
// src[starts[k] : ...] for every record (the sorted-title rewrite and any
// other permutation copy; separators are whatever `out` was prefilled
// with).
void oswald_gather_spans(const uint8_t* src, const int64_t* starts,
                         const int64_t* lens, const int64_t* dst_off,
                         int64_t nrec, uint8_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t k = 0; k < nrec; ++k)
    std::memcpy(out + dst_off[k], src + starts[k], (size_t)lens[k]);
}

// Pack from (starts, lens) extents instead of a contiguous offsets table —
// the out-of-core path packs groups straight from the FILE-ORDER residue
// staging area with sorted-order extents, skipping a whole permuted
// rewrite of the residue data.
void oswald_pack_group_sl(const int8_t* seqs, const int64_t* starts,
                          const int64_t* lens, int64_t count, int64_t L,
                          int8_t* out) {
  std::memset(out, kDummy, (size_t)(L * 1024));
  bool ascending = true;
  for (int64_t k = 1; k < count; ++k)
    if (lens[k] < lens[k - 1]) {
      ascending = false;
      break;
    }
  if (ascending) {
    // position-major: sequential 1024-lane writes; per-lane reads are
    // 1-byte streams whose lines stay resident (<= 64 KiB live lines).
    // Lengths ascend (length-sorted groups), so the lanes active at
    // position p are the suffix [k0, count) — branch-free inner loop.
    int64_t k0 = 0;
    for (int64_t p = 0; p < L; ++p) {
      while (k0 < count && lens[k0] <= p) ++k0;
      if (k0 >= count) break;
      int8_t* row = out + p * 1024;
      for (int64_t k = k0; k < count; ++k) row[k] = seqs[starts[k] + p];
    }
  } else {
    for (int64_t k = 0; k < count; ++k) {
      const int8_t* src = seqs + starts[k];
      int64_t len = lens[k] < L ? lens[k] : L;
      for (int64_t p = 0; p < len; ++p) out[p * 1024 + k] = src[p];
    }
  }
}

void oswald_pack_groups_sl(const int8_t* seqs, const int64_t* starts,
                           const int64_t* lens, const int64_t* group_starts,
                           int64_t n_groups, const int64_t* Ls, int8_t* outs,
                           const int64_t* out_offsets) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t g = 0; g < n_groups; ++g) {
    int64_t lo = group_starts[g], hi = group_starts[g + 1];
    oswald_pack_group_sl(seqs, starts + lo, lens + lo, hi - lo, Ls[g],
                         outs + out_offsets[g]);
  }
}

// ---- two-walk plan/execute FASTA pipeline ----
//
// parse_fasta_bytes previously walked the input FOUR times per block
// (count_mt's scan, encode's scan, the title-byte pre-pass, the main
// encode).  plan() folds the first three into ONE parallel walk whose
// per-chunk prefix tables are handed back to execute() (the main walk) —
// 2 walks total, halving the scan cost of the streaming preprocess.

int oswald_fasta_num_chunks(int64_t n) { return num_chunks(n); }

// One parallel walk.  Arrays cb/rec_base/w_base/t_base: int64[nt+1],
// caller-allocated with nt = oswald_fasta_num_chunks(n).  Returns the
// record count; *seq_bytes = exact residues execute() will write,
// *title_bytes = exact title stream bytes ("title\n" per record).
int64_t oswald_fasta_plan(const uint8_t* buf, int64_t n, int nt,
                          int64_t* cb_out, int64_t* rec_base,
                          int64_t* w_base, int64_t* t_base,
                          int64_t* seq_bytes, int64_t* title_bytes) {
  std::vector<int64_t> cb;
  chunk_bounds(buf, n, nt, &cb);
  for (int t = 0; t <= nt; ++t) cb_out[t] = cb[t];
  std::vector<ChunkMeta> meta(nt);
  std::vector<int64_t> tcount(nt, 0);
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int t = 0; t < nt; ++t) {
    // scan_chunk + title-byte count fused into one pass over the chunk
    int64_t recs = 0, r_pre = 0, r_post = 0, tbytes = 0;
    int64_t h_start = 0, h_end = 0;
    bool at_ls = true, in_hdr = false, seen = false;
    for (int64_t i = cb[t]; i < cb[t + 1]; ++i) {
      uint8_t c = buf[i];
      if (at_ls) {
        if (in_hdr) tbytes += (h_end - h_start) + 1;  // flushed on '\n'
        in_hdr = (c == '>');
        if (in_hdr) {
          ++recs;
          seen = true;
          h_start = i + 1;
          h_end = i + 1;
        }
        at_ls = false;
      }
      if (c == '\n') {
        at_ls = true;
        continue;
      }
      if (in_hdr) {
        if (c != '\r') h_end = i + 1;
      } else if (!kLut.skip[c]) {
        if (seen) ++r_post;
        else ++r_pre;
      }
    }
    if (in_hdr) tbytes += (h_end - h_start) + 1;
    meta[t].recs = recs;
    meta[t].r_pre = r_pre;
    meta[t].r_post = r_post;
    tcount[t] = tbytes;
  }
  rec_base[0] = w_base[0] = t_base[0] = 0;
  for (int t = 0; t < nt; ++t) {
    rec_base[t + 1] = rec_base[t] + meta[t].recs;
    int64_t resid = meta[t].r_post + (rec_base[t] > 0 ? meta[t].r_pre : 0);
    w_base[t + 1] = w_base[t] + resid;
    t_base[t + 1] = t_base[t] + tcount[t];
  }
  *seq_bytes = w_base[nt];
  *title_bytes = t_base[nt];
  return rec_base[nt];
}

// The main walk, driven by plan()'s tables.  Identical output semantics to
// oswald_fasta_encode_titles_mt.  Returns residues written (w_base[nt]).
int64_t oswald_fasta_execute(const uint8_t* buf, int64_t n, int nt,
                             const int64_t* cb, const int64_t* rec_base,
                             const int64_t* w_base, const int64_t* t_base,
                             int8_t* seq_out, int64_t* lengths_out,
                             int64_t* hdr_starts, int64_t* hdr_ends,
                             uint8_t* titles_out) {
  (void)n;
  std::vector<int64_t> carry_len(nt, 0);
#ifdef _OPENMP
#pragma omp parallel for
#endif
  for (int t = 0; t < nt; ++t) {
    int64_t rec = rec_base[t] - 1;
    int64_t w = w_base[t], tw = t_base[t], clen = 0;
    bool at_ls = true, in_hdr = false;
    for (int64_t i = cb[t]; i < cb[t + 1]; ++i) {
      uint8_t c = buf[i];
      if (at_ls) {
        if (in_hdr) {  // flush previous header's title + separator
          int64_t hl = hdr_ends[rec] - hdr_starts[rec];
          std::memcpy(titles_out + tw, buf + hdr_starts[rec], (size_t)hl);
          tw += hl;
          titles_out[tw++] = '\n';
        }
        in_hdr = (c == '>');
        if (in_hdr) {
          ++rec;
          lengths_out[rec] = 0;
          hdr_starts[rec] = i + 1;
          hdr_ends[rec] = i + 1;
        }
        at_ls = false;
      }
      if (c == '\n') {
        at_ls = true;  // in_hdr survives to the line start for the flush
        continue;
      }
      if (in_hdr) {
        if (c != '\r') hdr_ends[rec] = i + 1;
      } else if (rec >= 0 && !kLut.skip[c]) {
        seq_out[w++] = kLut.m[c];
        if (rec >= rec_base[t]) ++lengths_out[rec];
        else ++clen;
      }
    }
    if (in_hdr) {  // header line is the chunk's last line
      int64_t hl = hdr_ends[rec] - hdr_starts[rec];
      std::memcpy(titles_out + tw, buf + hdr_starts[rec], (size_t)hl);
      tw += hl;
      titles_out[tw++] = '\n';
    }
    carry_len[t] = clen;
  }
  for (int t = 0; t < nt; ++t)
    if (rec_base[t] > 0 && carry_len[t])
      lengths_out[rec_base[t] - 1] += carry_len[t];
  return w_base[nt];
}

// ABI version; oswald_tpu.io.native refuses to use a library whose version
// does not match its expectation (a stale build from an older checkout
// could otherwise silently diverge from this source).
int oswald_io_version() { return 5; }

}  // extern "C"
