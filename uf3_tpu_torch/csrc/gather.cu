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
// from the data), over 3.35 TB/s.  At the MD
// step's shapes that is 1-8 us, so a launch's own latency (a few us)
// is of the same size: these kernels are timed in CUDA graphs.
//
// The design: one thread per output element, W consecutive threads on
// one row, so that the writes of a warp are contiguous and its reads
// of a row fall on one or two cache lines.  Indices and table go
// through the read-only path (__ldg); a row's index is read by each of
// its W threads, which L1 serves after the first.  No shared memory:
// the tables the MD step gathers from (0.1-0.3 MB) stay in the 50 MB L2
// across the gather, and nothing is reused within a block that L1 does
// not already hold.  Elements are copied as 4- or 8-byte words, so
// float32 and float64 come out bit for bit as the plain versions give
// them; indices are int32 or int64.  Indices are not range-checked on
// the card (a check would cost the host a sync): the wrappers' callers
// pass neighbor lists, which hold rows of the table by construction.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename E, typename I>
__global__ void gather_rows_kernel(const E* __restrict__ table,
                                   const I* __restrict__ idx,
                                   E* __restrict__ out, long long total,
                                   int w) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long s = e / w;
  const long long c = e - s * w;
  const long long row = (long long)__ldg(idx + s);
  out[e] = __ldg(table + row * w + c);
}

template <typename E, typename I>
__global__ void gather_lanes_kernel(const E* __restrict__ t,
                                    const I* __restrict__ li,
                                    E* __restrict__ out, long long total,
                                    int b, int width) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long a = e / b;
  out[e] = __ldg(t + a * width + (long long)__ldg(li + e));
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

unsigned int blocks_for(long long total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
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

// Each entry launches on ``stream`` and returns cudaGetLastError(); 0
// elements launch nothing.
extern "C" int uf3_gather_rows(const void* table, const void* idx,
                               void* out, long long n_entries, int w,
                               int elem_bytes, int index_bytes,
                               void* stream) {
  const long long total = n_entries * w;
  if (total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(E, I)                                                      \
  gather_rows_kernel<E, I><<<blocks_for(total), kThreads, 0, s>>>(        \
      (const E*)table, (const I*)idx, (E*)out, total, w)
  UF3_GATHER_DISPATCH(LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int uf3_gather_lanes(const void* t, const void* li, void* out,
                                long long n_rows, int b, int width,
                                int elem_bytes, int index_bytes,
                                void* stream) {
  const long long total = n_rows * b;
  if (total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(E, I)                                                      \
  gather_lanes_kernel<E, I><<<blocks_for(total), kThreads, 0, s>>>(       \
      (const E*)t, (const I*)li, (E*)out, total, b, width)
  UF3_GATHER_DISPATCH(LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int uf3_rev_gather(const void* part, const void* idx,
                              const void* rev, void* out, long long n_entries,
                              int w, int kp, int elem_bytes, int index_bytes,
                              void* stream) {
  const long long total = n_entries * w;
  if (total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(E, I)                                                      \
  rev_gather_kernel<E, I><<<blocks_for(total), kThreads, 0, s>>>(         \
      (const E*)part, (const I*)idx, (const I*)rev, (E*)out, total, w, kp)
  UF3_GATHER_DISPATCH(LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
