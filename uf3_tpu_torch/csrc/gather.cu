// The three neighbor gathers of the MD step, as plain copies of bits:
//
//   gather_rows   out[s, c] = table[idx[s], c]           (table (R, W))
//   gather_lanes  out[a, b] = t[a, li[a, b]]              (t (A, T))
//   rev_gather    out[s, c] = part[idx[s], rev[s], c]     (part (R, Kp, W))
//
// where s runs over the entries of an index array of any shape (flat
// here) and c over the W columns of a row.  Together they are the
// gathers the MD step pays twice: the neighbor positions out
// (gather_rows) and the packed slot partials back through the
// reverse slots (rev_gather, the gather of ops/trio.py's
// assemble_forces), with the intra-row lane gather between them.
//
// Replaces the Pallas TPU gather probes (benchmarks/): the row gathers
// gk (step_anatomy.py), kernel0 and kernel3 (probe_dynamic_gather.py),
// kernel_a, kernel_b and kernel_d (probe_dg2.py), the bcast / grid
// kernels of probe_dg3.py, p7 and p7b (probe_gather2.py), P3 and P4
// (probe_wg.py), kernel2 (proto_dyngather.py) and kernel
// (proto_pallas_gather.py); the lane gathers kernel1
// (probe_dynamic_gather.py), p1 and p4 (probe_gather2.py), P1
// (probe_wg.py), kernel_lane (proto_dyngather.py) and lane_taa_k16 /
// lane_taa_256 (probe_mosaic.py); the reverse-slot gather kernel_c
// (probe_dg2.py) and the column gathers take_along_axis(axis=0) of a
// materialized table (probe_dg3.py's table kernel, probe_gather2.py's
// p6, probe_wg.py's P2), which are rev_gather with rev[s] = the column.
//
// What bounds it on the card: bytes.  There is no arithmetic beyond the
// addresses; the least time is the index arrays read once, the output
// written once and, of the table, the 32-byte sectors the indices reach
// (at most the whole table; ops/gather.py's gather_bytes counts them
// from the data), over 3.35 TB/s.  At the MD step's shapes that is
// 1-8 us, under or near a graph node's own floor (~1 us), so what a
// design can cut there is latency and instructions: how many dependent
// memory trips a thread makes, how many it keeps in flight, and how
// much integer work stands before its first load.
//
// Every value moves as 32-bit words (a float64 is two), so float32 and
// float64 come out bit for bit as the plain versions give them;
// indices are int32 or int64 and are not range-checked on the card (a
// check would cost the host a sync): the wrappers' callers pass
// neighbor lists, which hold rows of the table by construction.
// Offsets are 32-bit wherever the operands fit in 2^31 words (every MD
// size) and 64-bit otherwise.  ops/gather.py's gather_plan alone picks
// the instance and passes its code in, with the alignment it read off the
// table's pointer and row width; the entries here only dispatch on it.
//
// gather_rows.  A warp copies a span of 64 consecutive entries, two
// groups of 32, at every size (one group a warp: within the run-to-run
// swing below 2^20 entries, 7-11% slower past them; four: 20-40% slower
// at W = 3 below 2^20; PERF.md section 6).  Each lane
// first loads its two indices (entries lane and lane + 32: coalesced,
// each index read once), then every table load of the span, then every
// store: 2 W independent index -> row chains in flight a thread.  The
// span's output words are dealt to the lanes in order and each lane
// takes its word's row index from the lane that read it by a shuffle,
// so a load instruction reads 32 consecutive words of the rows (about
// 32 / W rows; a thread per entry would touch 32 rows, three times the
// L1 wavefronts at W = 3) and a store writes 128 contiguous bytes:
// whole sectors, not the 4-byte pieces of a 12-byte row.  Where W is a
// multiple of 4 (or 2) words and the rows are aligned to it, the words
// go as 16-byte (8-byte) chunks.  The row width in words is a template
// argument (1, 2, 3, 4, 6, 8, 16: float32 W = 1, 2, 3, 4, 6, 8 and
// float64 W = 1, 2, 3, 4, 8), so the word -> row arithmetic is by
// constants and the copies sit in registers.  Other widths below 32
// words a row (float32 W = 5, ...) take gather_rows_any: the same deal,
// one group a warp, with the width at run time; rows of 32 words or more
// take gather_rows_wide: a warp per entry, its lanes over the row's
// words (one index load a warp, no division), in blocks of two warps so
// that a few hundred entries still spread over the SMs.
//
// gather_lanes.  At T <= 32 a row of t fits in a warp's registers: a
// warp covers 32 / T' rows (T' = T rounded up to a power of two, a
// template argument), each lane loads the lane indices of its outputs
// and its own t[a, lane] (two coalesced reads issued together), and a
// shuffle takes each entry from the lane that holds it, so no load
// waits for another.  Wider tables keep one thread per output (a load
// of li, then of t[a, li]): proto_dyngather.py's 128-lane case already
// reaches its bound that way.
//
// rev_gather: one thread per output element, W consecutive threads on
// one row (67% of its bound at the step's shape).  No shared memory: the
// tables the MD step gathers from (0.1-0.4 MB) stay in the 50 MB L2
// across the gather.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;      // groups of 32 entries a row-gather warp
constexpr int kWideWords = 32;  // rows this wide take gather_rows_wide
constexpr int kWideWarps = 2;   // warps a block of gather_rows_wide
constexpr unsigned kFull = 0xffffffffu;

// n words from p into v: as 16-byte vectors where align (the bytes both
// p and every row start are multiples of) allows and n is a multiple of
// 4, else as 8-byte vectors where n is even, else word by word.
template <int N>
__device__ __forceinline__ void load_words(const unsigned* p, int align,
                                           unsigned* v) {
  if constexpr (N % 4 == 0) {
    if (align >= 16) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + q);
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
      return;
    }
  }
  if constexpr (N % 2 == 0) {
    if (align >= 8) {
#pragma unroll
      for (int q = 0; q < N / 2; ++q) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(p) + q);
        v[2 * q] = x.x;
        v[2 * q + 1] = x.y;
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < N; ++c) v[c] = __ldg(p + c);
}

// v's n words to p (n = 1, 2 or 4; p aligned to 4n bytes) in one store.
template <int N>
__device__ __forceinline__ void store_words(unsigned* p, const unsigned* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// A warp's copy of one group of 32 entries of WW words (32 WW words from
// dst on), in chunks of V words (V divides WW, so no chunk spans two
// rows): lane l copies chunks c = l + 32 k, k < WW / V, of entry
// j = c V / WW, whose row offset lane j holds in `row` (where V = WW,
// j = l: no shuffle); `left` entries of the group are there (32 where
// it is full).
template <int WW, int V, typename O>
__device__ __forceinline__ void load_group(const unsigned* table, O row,
                                           int lane, int left, unsigned* v) {
#pragma unroll
  for (int k = 0; k < WW / V; ++k) {
    const int c = lane + 32 * k, j = c * V / WW;
    const O r = V == WW ? row : __shfl_sync(kFull, row, j);
    if (j < left)
      load_words<V>(table + r * WW + (c * V - j * WW), 4 * V, v + k * V);
  }
}

template <int WW, int V>
__device__ __forceinline__ void store_group(unsigned* dst, int lane,
                                            int left, const unsigned* v) {
#pragma unroll
  for (int k = 0; k < WW / V; ++k) {
    const int c = lane + 32 * k;
    if (c * V / WW < left) store_words<V>(dst + c * V, v + k * V);
  }
}

// kGroups groups of 32 entries from dst on: every group's loads, then
// every group's stores.
template <int WW, int V, typename O>
__device__ __forceinline__ void copy_span(const unsigned* table,
                                          const O* rows, unsigned* dst,
                                          int lane, O left) {
  unsigned v[kGroups * WW];
  int here[kGroups];
#pragma unroll
  for (int e = 0; e < kGroups; ++e) {
    here[e] = left > (O)(32 * e)
                  ? (left - 32 * e < (O)32 ? (int)(left - 32 * e) : 32)
                  : 0;
    load_group<WW, V, O>(table, rows[e], lane, here[e], v + e * WW);
  }
#pragma unroll
  for (int e = 0; e < kGroups; ++e)
    store_group<WW, V>(dst + 32 * e * WW, lane, here[e], v + e * WW);
}

// gather_rows for rows of WW words: a warp copies a span of 32 kGroups
// consecutive entries (see the top of the file).  table_align is the
// bytes the table's rows are aligned to.  The launch gives one span a
// warp.
template <int WW, typename I, typename O>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const unsigned* __restrict__ table,
                   const void* __restrict__ index,
                   unsigned* __restrict__ out, long long n_entries, int ww,
                   int table_align) {
  const I* __restrict__ idx = static_cast<const I*>(index);
  const int lane = threadIdx.x & 31;
  const O n = (O)n_entries;
  const O first = ((O)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
                  (32 * kGroups);
  if (first >= n) return;
  O rows[kGroups];
#pragma unroll
  for (int e = 0; e < kGroups; ++e) {
    const O j = first + 32 * e + lane;
    rows[e] = j < n ? (O)__ldg(idx + j) : (O)0;
  }
  unsigned* dst = out + first * WW;
  if constexpr (WW % 4 == 0) {
    if (table_align >= 16) {
      copy_span<WW, 4, O>(table, rows, dst, lane, n - first);
      return;
    }
  }
  if constexpr (WW % 2 == 0) {
    if (table_align >= 8) {
      copy_span<WW, 2, O>(table, rows, dst, lane, n - first);
      return;
    }
  }
  copy_span<WW, 1, O>(table, rows, dst, lane, n - first);
}

// gather_rows for a row width ww (in words) below kWideWords with no
// instance of its own: a warp copies a span of 32 entries, lane j loads
// entry j's index, and word q of the span's output (entry q / ww,
// column q mod ww) takes it from lane q / ww by a shuffle.
template <typename I, typename O>
__global__ void __launch_bounds__(kThreads)
gather_rows_any(const unsigned* __restrict__ table,
                const void* __restrict__ index, unsigned* __restrict__ out,
                long long n_entries, int ww, int table_align) {
  const I* __restrict__ idx = static_cast<const I*>(index);
  const O n = (O)n_entries, w = (O)ww;
  const int lane = threadIdx.x & 31;
  const O first = ((O)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * 32;
  if (first >= n) return;
  const O row = first + lane < n ? (O)__ldg(idx + first + lane) : (O)0;
  const O left = n - first;
  const unsigned words = (unsigned)(left < 32 ? left : 32) * ww;
  unsigned* dst = out + first * w;
#pragma unroll 4
  for (unsigned q0 = 0; q0 < 32u * ww; q0 += 32) {
    const unsigned q = q0 + lane;
    const unsigned j = q / (unsigned)ww;
    const O r = __shfl_sync(kFull, row, (int)(j & 31));
    if (q < words) dst[q] = __ldg(table + r * w + (q - j * ww));
  }
}

// gather_rows for rows of kWideWords words or more: a warp copies one
// entry (blocks of kWideWarps warps), its lanes load the entry's index
// (one request), then words lane, lane + 32, ... of its row.
template <typename I, typename O>
__global__ void __launch_bounds__(32 * kWideWarps)
gather_rows_wide(const unsigned* __restrict__ table,
                 const void* __restrict__ index, unsigned* __restrict__ out,
                 long long n_entries, int ww, int table_align) {
  const I* __restrict__ idx = static_cast<const I*>(index);
  const O n = (O)n_entries, w = (O)ww;
  const O j = (O)blockIdx.x * kWideWarps + (threadIdx.x >> 5);
  if (j >= n) return;
  const unsigned* src = table + (O)__ldg(idx + j) * w;
  unsigned* dst = out + j * w;
#pragma unroll 4
  for (int c = threadIdx.x & 31; c < ww; c += 32) dst[c] = __ldg(src + c);
}

// gather_lanes at T <= 32, T' = 2^L >= T: a warp covers 32 / T' rows
// from a0 on; lane l holds t[a0 + l / T', l mod T'], and output o of the
// warp's outputs (row o / B) takes lane (o / B) T' + li[o] by a shuffle.
// WPE words an element.  The launch gives one warp its rows.
template <int WPE, int L, typename I>
__global__ void __launch_bounds__(kThreads)
gather_lanes_shuffle(const unsigned* __restrict__ t,
                     const void* __restrict__ lane_index,
                     unsigned* __restrict__ out, long long n_rows, int b,
                     long long width) {
  constexpr unsigned kRows = 32u >> L;
  const I* __restrict__ li = static_cast<const I*>(lane_index);
  const unsigned lane = threadIdx.x & 31, rows = (unsigned)n_rows;
  const unsigned a0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
                      kRows;
  if (a0 >= rows) return;
  const unsigned nb = (unsigned)b, base = a0 * nb;
  const unsigned count = (rows - a0 < kRows ? rows - a0 : kRows) * nb;
  unsigned l0 = lane < count ? (unsigned)__ldg(li + base + lane) : 0u;
  const unsigned a = a0 + (lane >> L), col = lane & ((1u << L) - 1);
  unsigned tv[WPE] = {};
  if (a < rows && col < (unsigned)width)
    load_words<WPE>(t + (a * (unsigned)width + col) * WPE, 8, tv);
  for (unsigned o = lane; o - lane < kRows * nb; o += 32) {
    if (o != lane) l0 = o < count ? (unsigned)__ldg(li + base + o) : 0u;
    const unsigned row = nb == (1u << L) ? o >> L : o / nb;
    const int src = (int)(((row << L) + l0) & 31);
    unsigned v[WPE];
#pragma unroll
    for (int k = 0; k < WPE; ++k) v[k] = __shfl_sync(kFull, tv[k], src);
    if (o < count) store_words<WPE>(out + (base + o) * WPE, v);
  }
}

// gather_lanes on wider tables: one thread per output, a load of li and
// then of t[a, li].
template <int WPE, typename I, typename O>
__global__ void __launch_bounds__(kThreads)
gather_lanes_direct(const unsigned* __restrict__ t,
                    const void* __restrict__ lane_index,
                    unsigned* __restrict__ out, long long n_rows, int b,
                    long long width) {
  const I* __restrict__ li = static_cast<const I*>(lane_index);
  const O e = (O)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (O)n_rows * (O)b) return;
  const O a = e / (O)b;
  const O src = (a * (O)width + (O)__ldg(li + e)) * WPE;
#pragma unroll
  for (int k = 0; k < WPE; ++k) out[e * WPE + k] = __ldg(t + src + k);
}

template <typename E, typename I>
__global__ void rev_gather_kernel(const E* __restrict__ part,
                                  const I* __restrict__ idx,
                                  const I* __restrict__ rev,
                                  E* __restrict__ out, long long total,
                                  int w, int kp) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long s = e / w;
  const long long c = e - s * w;
  const long long row =
      (long long)__ldg(idx + s) * kp + (long long)__ldg(rev + s);
  out[e] = __ldg(part + row * w + c);
}

long long blocks_for(long long total) {
  return (total + kThreads - 1) / kThreads;
}

// f(kernel, entries a block, threads a block) for the gather_rows_kernel
// of WW words.
template <int WW, typename I, typename O, typename F>
int rows_fixed(F&& f) {
  return f(gather_rows_kernel<WW, I, O>, kThreads * kGroups, kThreads);
}

// The same for the row-gather instance ``code`` (the row width in words
// for gather_rows_kernel, 0 for gather_rows_any, kWideWords for
// gather_rows_wide) with indices I and offsets O; -1 where none exists.
template <typename I, typename O, typename F>
int rows_of(int code, F&& f) {
  switch (code) {
    case 0: return f(gather_rows_any<I, O>, kThreads, kThreads);
    case kWideWords:
      return f(gather_rows_wide<I, O>, kWideWarps, 32 * kWideWarps);
    case 1: return rows_fixed<1, I, O>(f);
    case 2: return rows_fixed<2, I, O>(f);
    case 3: return rows_fixed<3, I, O>(f);
    case 4: return rows_fixed<4, I, O>(f);
    case 6: return rows_fixed<6, I, O>(f);
    case 8: return rows_fixed<8, I, O>(f);
    case 16: return rows_fixed<16, I, O>(f);
    default: return -1;
  }
}

// rows_of for index_bytes 4 or 8 and 64-bit offsets (wide) or not.
template <typename F>
int rows_instance(int code, int wide, int index_bytes, F&& f) {
  if (index_bytes == 4)
    return wide ? rows_of<int, unsigned long long>(code, f)
                : rows_of<int, unsigned>(code, f);
  if (index_bytes == 8)
    return wide ? rows_of<long long, unsigned long long>(code, f)
                : rows_of<long long, unsigned>(code, f);
  return -1;
}

// f(kernel, rows a warp, threads a block) for the lane-gather instance
// ``lanes``: the shuffle of T' = 2^lanes lanes (0 <= lanes <= 5, 32-bit
// offsets) or, at -1, one thread per output (rows a warp 0); WPE words
// an element, indices I; -1 where none exists.
template <int WPE, typename I, typename F>
int lanes_of(int lanes, int wide, F&& f) {
  if (lanes < 0)
    return wide ? f(gather_lanes_direct<WPE, I, unsigned long long>, 0,
                    kThreads)
                : f(gather_lanes_direct<WPE, I, unsigned>, 0, kThreads);
  if (wide) return -1;
  switch (lanes) {
    case 0: return f(gather_lanes_shuffle<WPE, 0, I>, 32, kThreads);
    case 1: return f(gather_lanes_shuffle<WPE, 1, I>, 16, kThreads);
    case 2: return f(gather_lanes_shuffle<WPE, 2, I>, 8, kThreads);
    case 3: return f(gather_lanes_shuffle<WPE, 3, I>, 4, kThreads);
    case 4: return f(gather_lanes_shuffle<WPE, 4, I>, 2, kThreads);
    case 5: return f(gather_lanes_shuffle<WPE, 5, I>, 1, kThreads);
    default: return -1;
  }
}

template <typename F>
int lanes_instance(int lanes, int wide, int elem_bytes, int index_bytes,
                   F&& f) {
  if (elem_bytes == 4 && index_bytes == 4)
    return lanes_of<1, int>(lanes, wide, f);
  if (elem_bytes == 4 && index_bytes == 8)
    return lanes_of<1, long long>(lanes, wide, f);
  if (elem_bytes == 8 && index_bytes == 4)
    return lanes_of<2, int>(lanes, wide, f);
  if (elem_bytes == 8 && index_bytes == 8)
    return lanes_of<2, long long>(lanes, wide, f);
  return -1;
}

// elem_bytes 4 or 8 (float32 or float64 as words), index_bytes 4 or 8
// (int32 or int64); any other size is -1.
#define UF3_GATHER_DISPATCH(LAUNCH)                                       \
  if (elem_bytes == 4 && index_bytes == 4) {                              \
    LAUNCH(unsigned int, int);                                            \
  } else if (elem_bytes == 4 && index_bytes == 8) {                       \
    LAUNCH(unsigned int, long long);                                      \
  } else if (elem_bytes == 8 && index_bytes == 4) {                       \
    LAUNCH(unsigned long long, int);                                      \
  } else if (elem_bytes == 8 && index_bytes == 8) {                       \
    LAUNCH(unsigned long long, long long);                                \
  } else {                                                                \
    return -1;                                                            \
  }

}  // namespace

// Each entry launches on ``stream`` and returns cudaGetLastError(), or
// -1 for arguments it has no instance for; 0 elements launch nothing.
//
// gather_rows: ``code`` is the instance gather_plan chose (the row
// width in 32-bit words, 0 for gather_rows_any, 32 for
// gather_rows_wide); ``wide`` 1 for 64-bit offsets; ``table_align`` the
// bytes the table's rows are aligned to.
extern "C" int uf3_gather_rows(const void* table, const void* idx,
                               void* out, long long n_entries, int w,
                               int elem_bytes, int index_bytes, int code,
                               int wide, int table_align, void* stream) {
  if (n_entries <= 0 || w <= 0) return 0;
  if (elem_bytes != 4 && elem_bytes != 8) return -1;
  const int ww = w * elem_bytes / 4;
  if (code == 0 ? ww >= kWideWords
                : (code == kWideWords ? ww < kWideWords : code != ww))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return rows_instance(code, wide, index_bytes,
                       [&](auto kernel, int per_block, int threads) {
    const long long blocks = (n_entries + per_block - 1) / per_block;
    kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const unsigned*)table, idx, (unsigned*)out, n_entries, ww,
        table_align);
    return (int)cudaGetLastError();
  });
}

// gather_lanes: ``lanes`` is the instance gather_plan chose (log2 of
// the shuffle's lane group T', which must hold the table's width; -1
// for one thread per output); ``wide`` 1 for 64-bit offsets.
extern "C" int uf3_gather_lanes(const void* t, const void* li, void* out,
                                long long n_rows, int b, long long width,
                                int elem_bytes, int index_bytes, int lanes,
                                int wide, void* stream) {
  const long long total = n_rows * b;
  if (total <= 0) return 0;
  if (lanes >= 0 && (lanes > 5 || width > (1LL << lanes))) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  return lanes_instance(lanes, wide, elem_bytes, index_bytes,
                        [&](auto kernel, int rows_a_warp, int threads) {
    const long long per_block = rows_a_warp * (threads / 32);
    const long long blocks = rows_a_warp
                                 ? (n_rows + per_block - 1) / per_block
                                 : blocks_for(total);
    kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const unsigned*)t, li, (unsigned*)out, n_rows, b, width);
    return (int)cudaGetLastError();
  });
}

// The plan of the instance a gather call would run, nothing launched:
// kind 0 rows, 1 lanes, ``code`` as uf3_gather_rows or uf3_gather_lanes
// takes it; out[0..5] = registers, local bytes a thread, static shared
// bytes a block, threads a block, resident blocks an SM, resident warps
// an SM.
extern "C" int uf3_gather_occupancy(int kind, int code, int wide,
                                    int elem_bytes, int index_bytes,
                                    int* out) {
  auto plan = [&](auto kernel, int, int threads) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = (int)attr.sharedSizeBytes;
    out[3] = threads;
    out[4] = blocks;
    out[5] = blocks * threads / 32;
    return 0;
  };
  if (kind == 0) return rows_instance(code, wide, index_bytes, plan);
  if (kind == 1)
    return lanes_instance(code, wide, elem_bytes, index_bytes, plan);
  return -1;
}

extern "C" int uf3_rev_gather(const void* part, const void* idx,
                              const void* rev, void* out, long long n_entries,
                              int w, int kp, int elem_bytes, int index_bytes,
                              void* stream) {
  const long long total = n_entries * w;
  if (total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(E, I)                                                      \
  rev_gather_kernel<E, I><<<(unsigned)blocks_for(total), kThreads, 0, s>>>( \
      (const E*)part, (const I*)idx, (const I*)rev, (E*)out, total, w, kp)
  UF3_GATHER_DISPATCH(LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
