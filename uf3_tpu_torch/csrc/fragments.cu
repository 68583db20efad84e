// The fragments of the fused trio block that the TPU probes compiled one
// by one, as three kernels:
//
//   relayout       out[o] = x[src(o)] (and out2[o] = out[o]): a copy through
//                  an index map, one map per mode:
//                    copy       src = o                      (a reshape)
//                    transpose  x (R, C) -> out (C, R)
//                    tile       out[a, j] = x[a, j mod W]     (x (A, W))
//                    repeat     out[a, j] = x[a, j div reps]
//                    select     out[a, j] = h[a K + q div w, off + q mod w],
//                               q = j mod (K w)  (h's (K, 3, 9) slice 1,
//                               tiled along the row)
//   lane_contract  out[a, j] = sum over t < T, in the order t = 0 .. T-1,
//                  of x[a, j sj + t st] * w[t, j] (w = 1 where absent): the
//                  K x K sums over either axis and the (M, 3) @ (3, 27)
//                  product
//   lane_map       the elementwise chains: the 3-D one-hot count, the
//                  unrolled 2-D one-hot sum, the cardinal interval, the
//                  grid-scalar sum, the r-chain, and two outputs of one read
//
// Replaces the Pallas TPU fragment probes: benchmarks/probe_mosaic.py's
// try_kernel (call :43) kernels #1 tile_lanes (:70), #2 repeat_lanes (:78),
// #3 pltpu_repeat (:86), #7 reshape_4d_index (:137) and
// benchmarks/probe_gather2.py's p2 (:124), p3 (:142), p5 (:161), p5b (:186)
// (relayout); #6 matmul_tiny_k3 (:126), #8 reshape_kk_reduce (:146), #9
// reshape_kk_reduce_ax1 (:155) (lane_contract); #4 onehot_3d_middle (:98),
// #5 onehot_2d_unrolled (:110), #10 cardinal_interval (:164), #14
// grid3_scalar_index (:218), #15 sqrt_where_div (:229) and k_multi (call
// :200) (lane_map).  The lane gathers #11 and #12 are gather.cu's.
//
// What bounds them on the card: bytes.  The heaviest chain does 36
// operations per 12 bytes it moves; the product 162 per 120-byte row; the
// card does 20 float32 operations in the time it moves a byte.  The least
// time is every input read once and every output written once over 3.35
// TB/s: 1-17 us at the full 9,856-row system, well under a launch's own
// latency at the probes' 512-row blocks (which is why they are timed in
// CUDA graphs).
//
// The design: one thread per output element, grid-stride, consecutive
// threads on consecutive outputs so that a warp's writes are contiguous;
// inputs through the read-only path (__ldg).  Offsets are 32-bit where the
// arrays allow it (the index maps divide by run-time widths, which costs
// 64-bit arithmetic several times more).  lane_contract keeps w (at most
// 48 KB; the product's 81 weights) in shared memory.  Every floating
// operation of lane_contract and lane_map is written with an explicit
// rounding intrinsic (__fmul_rn, __dadd_rn, __fsqrt_rn, ...), so that nvcc
// contracts nothing into an FMA and each operation rounds once, in the
// order of the plain versions in ops/fragments.py: the results equal
// theirs bit for bit.  No --use_fast_math: subnormals are kept, sqrt and
// division are IEEE.  relayout copies 4- or 8-byte words, so float32 and
// float64 come out as they went in.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks of 256 on each of 132 SMs

// relayout modes (ops/fragments.py's RELAYOUT_MODES)
enum { kCopy = 0, kTranspose = 1, kTile = 2, kRepeat = 3, kSelect = 4 };
// lane_map ops (ops/fragments.py's LANE_MAP_OPS)
enum {
  kOnehotCount = 0,
  kOnehotSum = 1,
  kCardinal = 2,
  kGrid3 = 3,
  kRchain = 4,
  kMulti = 5
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float floor_of(float a) { return floorf(a); }
__device__ __forceinline__ double floor_of(double a) { return ::floor(a); }

unsigned int blocks_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return (unsigned int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// E: the copied word (4 or 8 bytes); I: the offset type (32 or 64 bits).
template <typename E, typename I, int MODE>
__global__ void relayout_kernel(const E* __restrict__ x, E* __restrict__ out,
                                E* __restrict__ out2, I n, I in_cols,
                                I out_cols, I k, I w, I offset) {
  for (I o = (I)blockIdx.x * kThreads + threadIdx.x; o < n;
       o += (I)gridDim.x * kThreads) {
    I src;
    if (MODE == kCopy) {
      src = o;
    } else {
      const I a = o / out_cols;
      const I j = o - a * out_cols;
      if (MODE == kTranspose) {
        src = j * in_cols + a;
      } else if (MODE == kTile) {
        src = a * in_cols + j % in_cols;
      } else if (MODE == kRepeat) {
        src = a * in_cols + j / k;
      } else {  // kSelect
        const I q = j % (k * w);
        const I r = q / w;
        src = (a * k + r) * in_cols + offset + (q - r * w);
      }
    }
    const E v = __ldg(x + src);
    out[o] = v;
    if (out2 != nullptr) out2[o] = v;
  }
}

template <typename T, typename I>
__global__ void lane_contract_kernel(const T* __restrict__ x,
                                     const T* __restrict__ w,
                                     T* __restrict__ out, I n, I cols_out,
                                     int terms, I in_cols, I sj, I st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  if (w != nullptr) {
    for (int e = threadIdx.x; e < terms * (int)cols_out; e += kThreads)
      ws[e] = __ldg(w + e);
    __syncthreads();
  }
  for (I o = (I)blockIdx.x * kThreads + threadIdx.x; o < n;
       o += (I)gridDim.x * kThreads) {
    const I a = o / cols_out;
    const I j = o - a * cols_out;
    const T* row = x + a * in_cols + j * sj;
    T acc = T(0);
    if (w != nullptr) {
      for (int t = 0; t < terms; ++t)
        acc = add_rn(acc,
                     mul_rn(__ldg(row + (I)t * st), ws[t * cols_out + j]));
    } else {
      for (int t = 0; t < terms; ++t)
        acc = add_rn(acc, __ldg(row + (I)t * st));
    }
    out[o] = acc;
  }
}

template <typename T, typename I, int OP>
__global__ void lane_map_kernel(const T* __restrict__ x,
                                const int* __restrict__ idx,
                                const T* __restrict__ grid,
                                T* __restrict__ out, T* __restrict__ out2,
                                I n, int n_classes, int g_s0, int g_s1) {
  T g[9];
  if (OP == kGrid3) {
    for (int b = 0; b < 3; ++b)
      for (int c = 0; c < 3; ++c)
        g[b * 3 + c] = __ldg(grid + b * (g_s0 + g_s1) + c);
  }
  for (I o = (I)blockIdx.x * kThreads + threadIdx.x; o < n;
       o += (I)gridDim.x * kThreads) {
    if (OP == kOnehotCount) {
      // sum over w of (w == idx), as (iota == idx) summed over the iota axis
      const int v = __ldg(idx + o);
      T acc = T(0);
      for (int c = 0; c < n_classes; ++c)
        acc = add_rn(acc, v == c ? T(1) : T(0));
      out[o] = acc;
    } else if (OP == kOnehotSum) {
      // acc + (idx == w ? x : 0) (w + 1), w = 0 .. n_classes - 1: the
      // probe's (idx == w) * x as XLA compiles it, a select
      const int v = __ldg(idx + o);
      const T xv = __ldg(x + o);
      T acc = T(0);
      for (int c = 0; c < n_classes; ++c)
        acc = add_rn(acc, mul_rn(v == c ? xv : T(0), T(c + 1)));
      out[o] = acc;
    } else if (OP == kCardinal) {
      // t = 2.5 x + 4; i = clip(floor t, 0, 8); u = t - i; u u (3 - 2u) + i
      const T t = add_rn(mul_rn(__ldg(x + o), T(2.5)), T(4));
      const T f = floor_of(t);
      // as the plain version's clamp: NaN stays NaN (u is NaN either way)
      const T i = f < T(0) ? T(0) : (f > T(8) ? T(8) : f);
      const T u = sub_rn(t, i);
      out[o] = add_rn(mul_rn(mul_rn(u, u), sub_rn(T(3), mul_rn(T(2), u))), i);
    } else if (OP == kGrid3) {
      // acc + g[b, b, c] x over b, c < 3, in that order
      const T xv = __ldg(x + o);
      T acc = T(0);
      for (int e = 0; e < 9; ++e) acc = add_rn(acc, mul_rn(g[e], xv));
      out[o] = acc;
    } else if (OP == kRchain) {
      // x / sqrt(where(x x > 0, x x, 1))
      const T xv = __ldg(x + o);
      const T r2 = mul_rn(xv, xv);
      out[o] = div_rn(xv, sqrt_rn(r2 > T(0) ? r2 : T(1)));
    } else {  // kMulti: 2 x and x + 1 from one read
      const T xv = __ldg(x + o);
      out[o] = mul_rn(xv, T(2));
      out2[o] = add_rn(xv, T(1));
    }
  }
}

bool fits_32(long long n) { return n < (1LL << 31); }

template <typename E, typename I>
int launch_relayout(const void* x, void* out, void* out2, long long n,
                    int mode, long long in_cols, long long out_cols, int k,
                    int w, int offset, cudaStream_t s) {
  const unsigned int blocks = blocks_for(n);
#define UF3_RELAYOUT(M)                                                   \
  relayout_kernel<E, I, M><<<blocks, kThreads, 0, s>>>(                   \
      (const E*)x, (E*)out, (E*)out2, (I)n, (I)in_cols, (I)out_cols,      \
      (I)k, (I)w, (I)offset)
  switch (mode) {
    case kCopy: UF3_RELAYOUT(kCopy); break;
    case kTranspose: UF3_RELAYOUT(kTranspose); break;
    case kTile: UF3_RELAYOUT(kTile); break;
    case kRepeat: UF3_RELAYOUT(kRepeat); break;
    case kSelect: UF3_RELAYOUT(kSelect); break;
    default: return -1;
  }
#undef UF3_RELAYOUT
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch_lane_contract(const void* x, const void* w, void* out,
                         long long n, long long cols_out, int terms,
                         long long in_cols, long long sj, long long st,
                         cudaStream_t s) {
  const size_t smem = w != nullptr ? sizeof(T) * terms * cols_out : 0;
  lane_contract_kernel<T, I><<<blocks_for(n), kThreads, smem, s>>>(
      (const T*)x, (const T*)w, (T*)out, (I)n, (I)cols_out, terms,
      (I)in_cols, (I)sj, (I)st);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch_lane_map(int op, const void* x, const void* idx, const void* grid,
                    void* out, void* out2, long long n, int n_classes,
                    int g_s0, int g_s1, cudaStream_t s) {
  const unsigned int blocks = blocks_for(n);
#define UF3_LANE_MAP(OP)                                                  \
  lane_map_kernel<T, I, OP><<<blocks, kThreads, 0, s>>>(                  \
      (const T*)x, (const int*)idx, (const T*)grid, (T*)out, (T*)out2,    \
      (I)n, n_classes, g_s0, g_s1)
  switch (op) {
    case kOnehotCount: UF3_LANE_MAP(kOnehotCount); break;
    case kOnehotSum: UF3_LANE_MAP(kOnehotSum); break;
    case kCardinal: UF3_LANE_MAP(kCardinal); break;
    case kGrid3: UF3_LANE_MAP(kGrid3); break;
    case kRchain: UF3_LANE_MAP(kRchain); break;
    case kMulti: UF3_LANE_MAP(kMulti); break;
    default: return -1;
  }
#undef UF3_LANE_MAP
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches on ``stream`` and returns cudaGetLastError(), or -1
// for a mode, op or element size it does not know; 0 elements launch
// nothing.  ``max_offset`` is the largest element offset into any operand
// (the wrapper's count): below 2^31 the offsets are 32-bit.

// out (and out2 unless null) get n words of elem_bytes (4 or 8) each.
extern "C" int uf3_relayout(const void* x, void* out, void* out2,
                            long long n, long long max_offset, int mode,
                            long long in_cols, long long out_cols, int k,
                            int w, int offset, int elem_bytes, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool small = fits_32(max_offset);
#define UF3_ARGS x, out, out2, n, mode, in_cols, out_cols, k, w, offset, s
  if (elem_bytes == 4)
    return small ? launch_relayout<unsigned int, unsigned int>(UF3_ARGS)
                 : launch_relayout<unsigned int, long long>(UF3_ARGS);
  if (elem_bytes == 8)
    return small ? launch_relayout<unsigned long long, unsigned int>(UF3_ARGS)
                 : launch_relayout<unsigned long long, long long>(UF3_ARGS);
#undef UF3_ARGS
  return -1;
}

// out (n = rows x cols_out) in float32 (is_f64 0) or float64; w null for
// the plain sums, else (terms, cols_out) in shared memory.
extern "C" int uf3_lane_contract(const void* x, const void* w, void* out,
                                 long long n, long long max_offset,
                                 long long cols_out, int terms,
                                 long long in_cols, long long sj,
                                 long long st, int is_f64, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool small = fits_32(max_offset);
#define UF3_ARGS x, w, out, n, cols_out, terms, in_cols, sj, st, s
  if (is_f64)
    return small ? launch_lane_contract<double, unsigned int>(UF3_ARGS)
                 : launch_lane_contract<double, long long>(UF3_ARGS);
  return small ? launch_lane_contract<float, unsigned int>(UF3_ARGS)
               : launch_lane_contract<float, long long>(UF3_ARGS);
#undef UF3_ARGS
}

// x, idx (int32), grid as the op reads them (null where it reads none);
// out2 for kMulti only.  grid[b, b, c] lies at b (g_s0 + g_s1) + c.
extern "C" int uf3_lane_map(int op, const void* x, const void* idx,
                            const void* grid, void* out, void* out2,
                            long long n, int n_classes, int g_s0, int g_s1,
                            int is_f64, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool small = fits_32(n);
#define UF3_ARGS op, x, idx, grid, out, out2, n, n_classes, g_s0, g_s1, s
  if (is_f64)
    return small ? launch_lane_map<double, unsigned int>(UF3_ARGS)
                 : launch_lane_map<double, long long>(UF3_ARGS);
  return small ? launch_lane_map<float, unsigned int>(UF3_ARGS)
               : launch_lane_map<float, long long>(UF3_ARGS);
#undef UF3_ARGS
}
