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
// The design of relayout and lane_map: one thread per output element,
// grid-stride, consecutive threads on consecutive outputs so that a warp's
// writes are contiguous; inputs through the read-only path (__ldg).
// Offsets are 32-bit where the arrays allow it (the index maps divide by
// run-time widths, which costs 64-bit arithmetic several times more).
//
// relayout's transpose has a kernel of its own, transpose_kernel: one
// output a thread put a warp's 32 loads on rows in_cols words apart (at
// (16, 9,856): 16 rows, two words each) behind a division per output.
// A block stages a tile of 16 rows x 128 bytes of x (32 float32 or 16
// float64 columns) in shared memory: each of its 128 threads loads one
// 16-byte chunk of a row (words where x or its rows are not aligned to
// 16 bytes), a warp two whole 128-byte lines, and the chunks of a row
// are placed by an XOR with the row so that the column reads hit 32
// banks; after one barrier the block writes the tile transposed.  Where
// x has at most 16 rows (every probe's) the tile is the only one of its
// column, found with no division, and its output is one contiguous run:
// each thread stores one 16-byte vector of it.  x of exactly 16 rows
// runs an instance with its rows known at compile time (the store's
// word map by shifts).  Taller x writes each output row's 16 words of a
// tile.  At the probes' sizes the kernel is a graph node's floor, one
// memory trip and the stores' drain, so the instructions ahead of the
// load and between the barrier and the store count: the block index's
// division and the store map's division by the run-time rows cost 6% at
// (16, 9,856).  Tried and left out (PERF.md section 6, kernel_variants
// relayout on the patches fragments_transpose_*.patch): tiles of 32 rows
// (half the load slots idle at 16 rows), 16-row tiles of 64, 256 or 512
// bytes, loads by cp.async, loads by the bulk copy engine (TMA, a copy a
// row on an mbarrier: 17-40% slower than the same tile's 16-byte loads),
// a carveout preference that left one block an SM, scalar stores, and a
// tile a warp.  Gathering each 16-byte output vector straight from V
// rows with no shared memory (fragments_transpose_vectors.patch) was 1-2%
// faster at (16, 9,856) and as fast at (16, 128), but ran 1-4% over the
// earlier one-output-a-thread kernel at (16, 128) after a memcpy node,
// where this tile does not; its warp loads 4 rows x 32 bytes an
// instruction at 16 rows, and fewer bytes of each sector as x grows
// taller, where the tile's loads stay whole lines.
//
// lane_contract is bound by bytes only once its instructions are few: one
// thread per output, as first written, divided every output index by the
// run-time width and read each x value once for each of the 27 outputs
// that use it, and the product took 2.9x its bound.  So:
// * the product (w given): a block stages w once, then a tile of rows of
//   x with 16-byte loads into shared memory (the tiles spread the rows
//   over one wave of resident blocks); each thread computes 4 (float32)
//   or 2 (float64) consecutive outputs of the tile and stores them as one
//   16-byte vector.  A thread's first output is the same in every tile
//   and its next one a fixed step further on: one division per thread.
// * the K x K sums: each thread owns a group of 16 bytes of consecutive
//   outputs of one row and reads 16-byte vectors, along the outputs (the
//   sum over axis 1) or along each output's terms (axis 2), eight loads
//   in flight before their sums; the same one division per thread.
// * one thread per output (the sums' kernel with one-output groups)
//   where the work is smaller (sums below a block of groups for every
//   SM, the product below a vector for every thread of a wave of
//   resident blocks: the probes' 512- and 8,192-row blocks), and where a
//   width or an address gives no 16-byte vector: there more threads put
//   more loads in flight than vectors would, and no staging waits.
// Tried and left out (PERF.md section 6: benchmarks/kernel_variants.py
// on the patches in benchmarks_data/artifacts_torch/kernel_variants/):
// two tiles a block, so that one tile's stores overlap the next one's
// loads, was slower than one; tiles and vectors at every size, with no
// floor, were slower at the probes' blocks.
//
// relayout's copy (the reshape) stays one word a thread, as first
// written.  At the probes' sizes (64 KB and 631 KB) a copy is one wave of
// loads, and its time is a graph node's launch and drain.  Tried and left
// out (PERF.md section 6: kernel_variants relayout): 16-byte vectors, two
// or four a thread, 128- or 1024-thread blocks and an L2 prefetch hint
// were no faster; a programmatic dependent launch (griddepcontrol)
// overlaps only a copy that follows another such launch, which no path
// runs, gained nothing after a memcpy and was 10-15% slower after a plain
// kernel.  The copy stays 3-6% over the library's, a memcpy node.
//
// Every floating operation of lane_contract and lane_map is written with
// an explicit rounding intrinsic (__fmul_rn, __dadd_rn, __fsqrt_rn, ...),
// so that nvcc contracts nothing into an FMA and each operation rounds
// once, in the order of the plain versions in ops/fragments.py (a zero
// accumulator, then t = 0 .. T-1): the results equal theirs bit for bit.
// No --use_fast_math: subnormals are kept, sqrt and division are IEEE.
// relayout copies 4- or 8-byte words, so float32 and float64 come out as
// they went in.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks of 256 on each of 132 SMs
constexpr int kResident = 132 * 8;    // one wave: 8 blocks of 256 per SM
constexpr int kChunk = 8;             // vector loads issued before their sums
// 16-byte vectors where they still give every SM a block of threads,
// and the product's tiles where they give every thread of a wave of
// resident blocks a vector; fewer outputs run one a thread (more
// threads, more loads in flight, no staging)
constexpr long long kVectorFloor = 132LL * kThreads;
constexpr long long kTileFloor = (long long)kResident * kThreads;

// relayout's transpose: the rows of x a tile holds, the bytes of each of
// its rows (64 float32 or 32 float64 columns), and a block's threads, one
// 16-byte chunk of the tile each
constexpr int kTileRows = 16;
constexpr int kTileBytes = 128;
constexpr int kTileThreads = kTileRows * kTileBytes / 16;

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
      if (MODE == kTile) {
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

// 16 bytes as words of E.
template <typename E>
union Words16 {
  uint4 v;
  E e[16 / sizeof(E)];
};

// The place of word (r, c) of a transpose tile in shared memory: row r's
// 16-byte chunk k stands at chunk k ^ ((r / V) (V / 2)) (within the row's
// chunks), so that a warp's column reads (V consecutive rows of 32 / V
// columns, at 16 rows) hit 32 banks.
template <typename E>
__device__ __forceinline__ int transpose_at(int r, int c) {
  constexpr int V = 16 / sizeof(E);
  constexpr int TC = kTileBytes / sizeof(E);
  return r * TC + (((c / V) ^ ((r / V * (V / 2)) & (TC / V - 1))) * V) +
         c % V;
}

// relayout's transpose, out (cols, rows) = x (rows, cols)^T, a tile of
// kTileRows rows x TC = kTileBytes / sizeof(E) columns a block: tile
// (b / tiles_c, b mod tiles_c) for block b, tile (0, b) where rows <=
// kTileRows (no division).  R > 0: x has R rows, known at compile time.
// Thread t loads 16 bytes of the tile's row t / (TC / V) (one 16-byte
// load where vec_in: x aligned to 16 bytes and cols a multiple of V;
// else words) into shared memory, where chunk k of row r stands at chunk
// k ^ swizzle(r).  Where rows <= kTileRows the tile's output is one run
// of nc rows words from out + c0 rows (word o = tile[o mod rows, o /
// rows]), and thread t stores words t V .. t V + V - 1 of it (one
// 16-byte store where vec_out: out aligned to 16 bytes); taller x writes
// each output row's nr words of the tile.
template <typename E, typename I, int R>
__global__ void __launch_bounds__(kTileThreads)
transpose_kernel(const E* __restrict__ x, E* __restrict__ out, I rows,
                 I cols, int tiles_c, int vec_in, int vec_out) {
  constexpr int V = 16 / sizeof(E);
  constexpr int TC = kTileBytes / sizeof(E);
  __shared__ __align__(16) E tile[kTileRows * TC];
  if (R > 0) rows = R;
  const bool short_x = rows <= (I)kTileRows;
  const int t = threadIdx.x;
  const int tr = short_x ? 0 : (int)blockIdx.x / tiles_c;
  const I r0 = (I)tr * kTileRows;
  const I c0 = (I)((int)blockIdx.x - tr * tiles_c) * TC;
  const int nr = (int)(rows - r0 < (I)kTileRows ? rows - r0 : (I)kTileRows);
  const int nc = (int)(cols - c0 < (I)TC ? cols - c0 : (I)TC);
  // the load: row lr's 16-byte chunk lk, columns lc .. lc + V - 1
  const int lr = t / (TC / V), lk = t - lr * (TC / V), lc = lk * V;
  if (lr < nr && lc < nc) {
    const E* src = x + (r0 + (I)lr) * cols + c0 + lc;
    E* dst = tile + transpose_at<E>(lr, lc);
    if (vec_in) {
      *reinterpret_cast<uint4*>(dst) =
          __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      E v[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (lc + j < nc) v[j] = __ldg(src + j);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (lc + j < nc) dst[j] = v[j];
    }
  }
  // the store's first word, found while the loads are out
  const int nrows = rows < (I)kTileRows ? (int)rows : kTileRows;
  const int n_out = nc * nrows, o0 = t * V;
  int c = o0 / nrows, r = o0 - c * nrows;
  __syncthreads();
  if (short_x) {
    if (o0 >= n_out) return;
    E* dst = out + c0 * rows;
    if (vec_out && o0 + V <= n_out) {
      Words16<E> w;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        w.e[j] = tile[transpose_at<E>(r, c)];
        if (++r == nrows) {
          r = 0;
          ++c;
        }
      }
      reinterpret_cast<uint4*>(dst)[t] = w.v;
      return;
    }
    for (int o = o0; o < n_out && o < o0 + V; ++o) {
      dst[o] = tile[transpose_at<E>(r, c)];
      if (++r == nrows) {
        r = 0;
        ++c;
      }
    }
    return;
  }
  // out[c0 + c, r0 + r] = tile[r, c]
  for (int q = t; q < nc * kTileRows; q += kTileThreads) {
    const int qc = q / kTileRows, qr = q - qc * kTileRows;
    if (qr < nr)
      out[(c0 + (I)qc) * rows + r0 + qr] = tile[transpose_at<E>(qr, qc)];
  }
}

// 16 bytes of T: the vector a thread loads and stores at once.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void split(const float4& v, float* e) {
    e[0] = v.x;
    e[1] = v.y;
    e[2] = v.z;
    e[3] = v.w;
  }
  __device__ static float4 join(const float* e) {
    return make_float4(e[0], e[1], e[2], e[3]);
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void split(const double2& v, double* e) {
    e[0] = v.x;
    e[1] = v.y;
  }
  __device__ static double2 join(const double* e) {
    return make_double2(e[0], e[1]);
  }
};

// lane_contract's product (w given): each block stages w once and then,
// tile by tile (tile_rows rows of x, a multiple of V), the tile's x with
// 16-byte loads (ALIGNED) into shared memory; each thread computes V
// consecutive outputs of the tile's contiguous (rows, cols_out) block
// and stores them as one 16-byte vector.  A thread's first output in a
// tile is the same in every tile, and its next one V * kThreads further
// on: one division per thread, then (step_rows, step_cols) steps.
template <typename T, typename I, bool ALIGNED>
__global__ void contract_tile_kernel(const T* __restrict__ x,
                                     const T* __restrict__ w,
                                     T* __restrict__ out, I rows, int terms,
                                     int cols_out, int tile_rows, int tiles,
                                     int w_pad, int step_rows,
                                     int step_cols) {
  using V16 = Vec16<T>;
  constexpr int V = V16::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* xs = ws + w_pad;
  for (int e = threadIdx.x; e < terms * cols_out; e += kThreads)
    ws[e] = __ldg(w + e);
  const int o0 = threadIdx.x * V;
  const int a0 = o0 / cols_out;
  const int j0 = o0 - a0 * cols_out;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const I row0 = (I)tile * (I)tile_rows;
    const int n_rows = (int)(rows - row0 < (I)tile_rows ? rows - row0
                                                        : (I)tile_rows);
    const int n_x = n_rows * terms;
    const T* xt = x + row0 * (I)terms;
    // the last tile's reads of xs are done (the first tile's x loads go
    // out with w's)
    if (tile != (int)blockIdx.x) __syncthreads();
    int head = 0;
    if (ALIGNED) {
      head = n_x / V * V;
      for (int v = threadIdx.x; v < n_x / V; v += kThreads)
        reinterpret_cast<typename V16::type*>(xs)[v] =
            __ldg(reinterpret_cast<const typename V16::type*>(xt) + v);
    }
    for (int e = head + threadIdx.x; e < n_x; e += kThreads)
      xs[e] = __ldg(xt + e);
    __syncthreads();
    const int n_out = n_rows * cols_out;
    T* ot = out + row0 * (I)cols_out;
    int a = a0, j = j0;
    for (int o = o0; o < n_out; o += kThreads * V) {
      T acc[V];
      int aa = a, jj = j;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        T sum = T(0);
        if (aa < n_rows) {
          const T* xr = xs + aa * terms;
          for (int t = 0; t < terms; ++t)
            sum = add_rn(sum, mul_rn(xr[t], ws[t * cols_out + jj]));
        }
        acc[q] = sum;
        if (++jj == cols_out) {
          jj = 0;
          ++aa;
        }
      }
      if (ALIGNED && o + V <= n_out) {
        *reinterpret_cast<typename V16::type*>(ot + o) = V16::join(acc);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q)
          if (o + q < n_out) ot[o + q] = acc[q];
      }
      a += step_rows;
      j += step_cols;
      if (j >= cols_out) {
        j -= cols_out;
        ++a;
      }
    }
  }
}

// lane_contract's sums (no w) and any shape the tile does not take: each
// thread owns groups of V consecutive outputs of one row (g = a *
// groups_per_row + j / V) with a grid stride, one division per thread
// and (step_rows, step_groups) steps after it.  V > 1 reads 16-byte
// vectors: along the outputs (ALONG_T false: sj = 1, a term's V values
// of the group lie side by side) or along the terms (ALONG_T true: st =
// 1, each output's terms lie side by side).  Every output sums its
// terms in the order t = 0 .. T-1 either way.
template <typename T, typename I, int V, bool ALONG_T>
__global__ void contract_rows_kernel(const T* __restrict__ x,
                                     const T* __restrict__ w,
                                     T* __restrict__ out, I groups,
                                     int groups_per_row, int cols_out,
                                     int terms, I in_cols, I sj, I st,
                                     int step_rows, int step_groups) {
  using V16 = Vec16<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  if (w != nullptr) {
    for (int e = threadIdx.x; e < terms * cols_out; e += kThreads)
      ws[e] = __ldg(w + e);
    __syncthreads();
  }
  const I g0 = (I)blockIdx.x * kThreads + threadIdx.x;
  I a = g0 / (I)groups_per_row;
  int jg = (int)(g0 - a * (I)groups_per_row);
  for (I g = g0; g < groups; g += (I)gridDim.x * kThreads) {
    const int j = jg * V;
    const T* row = x + a * in_cols;
    T acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = T(0);
    if constexpr (V == 1) {
      const T* xj = row + (I)j * sj;
      if (w != nullptr) {
        for (int t = 0; t < terms; ++t)
          acc[0] = add_rn(acc[0],
                          mul_rn(__ldg(xj + (I)t * st), ws[t * cols_out + j]));
      } else {
        for (int t = 0; t < terms; ++t)
          acc[0] = add_rn(acc[0], __ldg(xj + (I)t * st));
      }
    } else if constexpr (ALONG_T) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const typename V16::type* xq =
            reinterpret_cast<const typename V16::type*>(row + (I)(j + q) * sj);
        for (int t = 0; t < terms / V; ++t) {
          T e[V];
          V16::split(__ldg(xq + t), e);
#pragma unroll
          for (int c = 0; c < V; ++c) acc[q] = add_rn(acc[q], e[c]);
        }
      }
    } else {
      // kChunk loads in flight before their sums
      const typename V16::type* xv =
          reinterpret_cast<const typename V16::type*>(row + j);
      const I sv = st / V;
      for (int t0 = 0; t0 < terms; t0 += kChunk) {
        typename V16::type v[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (t0 + u < terms) v[u] = __ldg(xv + (I)(t0 + u) * sv);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (t0 + u < terms) {
            T e[V];
            V16::split(v[u], e);
#pragma unroll
            for (int q = 0; q < V; ++q) acc[q] = add_rn(acc[q], e[q]);
          }
        }
      }
    }
    T* o = out + a * (I)cols_out + j;
    if constexpr (V == 1)
      o[0] = acc[0];
    else
      *reinterpret_cast<typename V16::type*>(o) = V16::join(acc);
    a += step_rows;
    jg += step_groups;
    if (jg >= groups_per_row) {
      jg -= groups_per_row;
      ++a;
    }
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

// The launch plan of kernel k at `threads` threads a block and smem
// bytes of dynamic shared memory: out = {registers per thread, local
// (spill) bytes per thread, resident blocks per SM, warps per SM}.
template <typename K>
int plan_of(K k, size_t smem, int* out, int threads = kThreads) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = blocks * threads / 32;
  return 0;
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <typename E, typename I>
int launch_relayout(const void* x, void* out, void* out2, long long n,
                    int mode, long long in_cols, long long out_cols, int k,
                    int w, int offset, cudaStream_t s) {
  if (mode == kTranspose) {
    // x (out_cols, in_cols) -> out (in_cols, out_cols)
    constexpr long long V = 16 / sizeof(E), TC = kTileBytes / sizeof(E);
    const long long tiles_c = (in_cols + TC - 1) / TC;
    const long long tiles = (out_cols + kTileRows - 1) / kTileRows * tiles_c;
#define UF3_TRANSPOSE(R)                                                  \
  transpose_kernel<E, I, R><<<(unsigned)tiles, kTileThreads, 0, s>>>(     \
      (const E*)x, (E*)out, (I)out_cols, (I)in_cols, (int)tiles_c,        \
      aligned16(x) && in_cols % V == 0, aligned16(out))
    if (out_cols == kTileRows)  // every probe's x: the store's map compiled
      UF3_TRANSPOSE(kTileRows);
    else
      UF3_TRANSPOSE(0);
#undef UF3_TRANSPOSE
    return (int)cudaGetLastError();
  }
  const unsigned int blocks = blocks_for(n);
#define UF3_RELAYOUT(M)                                                   \
  relayout_kernel<E, I, M><<<blocks, kThreads, 0, s>>>(                   \
      (const E*)x, (E*)out, (E*)out2, (I)n, (I)in_cols, (I)out_cols,      \
      (I)k, (I)w, (I)offset)
  switch (mode) {
    case kCopy: UF3_RELAYOUT(kCopy); break;
    case kTile: UF3_RELAYOUT(kTile); break;
    case kRepeat: UF3_RELAYOUT(kRepeat); break;
    case kSelect: UF3_RELAYOUT(kSelect); break;
    default: return -1;
  }
#undef UF3_RELAYOUT
  return (int)cudaGetLastError();
}

// The product's tile: the rows spread over one wave of resident blocks
// (kResident), a multiple of V rows, with x and w within 48 KB of shared
// memory; 0 where not even V rows fit (the rows kernel takes the product
// then).
template <typename T>
long long product_tile_rows(long long rows, int terms, int w_pad) {
  constexpr int V = Vec16<T>::n;
  const long long room = (48 * 1024 / (long long)sizeof(T) - w_pad)
                         / (terms > 0 ? terms : 1) / V * V;
  long long tr = ((rows + kResident - 1) / kResident + V - 1) / V * V;
  tr = tr < room ? tr : room;
  return tr < V ? 0 : tr;
}

// Launches lane_contract's kernel for the shape, or, with plan, launches
// nothing and gives its launch plan: plan_of's four numbers, the kernel
// (0 the product's tile, 1 one output a thread, 2 vectors along the
// outputs, 3 along the terms) and the blocks it would launch.
template <typename T, typename I>
int launch_lane_contract(const void* x, const void* w, void* out,
                         long long n, long long cols_out, int terms,
                         long long in_cols, long long sj, long long st,
                         cudaStream_t s, int* plan) {
  constexpr int V = Vec16<T>::n;
  const long long rows = n / cols_out;
  const bool aligned = aligned16(x) && aligned16(out);
  if (w != nullptr) {
    const int w_pad = (int)((terms * cols_out + V - 1) / V * V);
    const long long tile_rows = product_tile_rows<T>(rows, terms, w_pad);
    if (tile_rows > 0 && in_cols == terms && sj == 0 && st == 1
        && n / V >= kTileFloor) {
      const long long tiles = (rows + tile_rows - 1) / tile_rows;
      const long long step = (long long)kThreads * V;
      const size_t smem =
          sizeof(T) * ((size_t)w_pad + (size_t)tile_rows * terms);
      const unsigned int blocks =
          (unsigned int)(tiles < kResident ? tiles : kResident);
      const auto kernel = aligned ? contract_tile_kernel<T, I, true>
                                  : contract_tile_kernel<T, I, false>;
      if (plan != nullptr) {
        plan[4] = 0;
        plan[5] = (int)blocks;
        return plan_of(kernel, smem, plan);
      }
      kernel<<<blocks, kThreads, smem, s>>>(
          (const T*)x, (const T*)w, (T*)out, (I)rows, terms, (int)cols_out,
          (int)tile_rows, (int)tiles, w_pad, (int)(step / cols_out),
          (int)(step % cols_out));
      return (int)cudaGetLastError();
    }
  }
  // groups of V outputs where the layout gives 16-byte vectors
  int vec = 0;  // 0: scalar; 1: along the outputs; 2: along the terms
  if (w == nullptr && aligned && cols_out % V == 0 && in_cols % V == 0
      && n / V >= kVectorFloor) {
    if (sj == 1 && st % V == 0)
      vec = 1;
    else if (st == 1 && sj % V == 0 && terms % V == 0)
      vec = 2;
  }
  const int width = vec ? V : 1;
  const long long per_row = cols_out / width;
  const long long groups = rows * per_row;
  const unsigned int blocks = blocks_for(groups);
  const long long step = (long long)blocks * kThreads;
  const size_t smem = w != nullptr ? sizeof(T) * terms * cols_out : 0;
  const auto kernel = vec == 1   ? contract_rows_kernel<T, I, V, false>
                      : vec == 2 ? contract_rows_kernel<T, I, V, true>
                                 : contract_rows_kernel<T, I, 1, false>;
  if (plan != nullptr) {
    plan[4] = vec == 0 ? 1 : vec + 1;
    plan[5] = (int)blocks;
    return plan_of(kernel, smem, plan);
  }
  kernel<<<blocks, kThreads, smem, s>>>(
      (const T*)x, (const T*)w, (T*)out, (I)groups, (int)per_row,
      (int)cols_out, terms, (I)in_cols, (I)sj, (I)st, (int)(step / per_row),
      (int)(step % per_row));
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

// The launch plan (plan_of) of relayout's kernel for `mode` on words of
// E with 32-bit offsets.
template <typename E>
int relayout_occupancy(int mode, int* out) {
  switch (mode) {
    case kCopy: return plan_of(relayout_kernel<E, unsigned int, kCopy>, 0, out);
    case kTranspose:
      return plan_of(transpose_kernel<E, unsigned int, kTileRows>, 0, out,
                     kTileThreads);
    case kTile: return plan_of(relayout_kernel<E, unsigned int, kTile>, 0, out);
    case kRepeat:
      return plan_of(relayout_kernel<E, unsigned int, kRepeat>, 0, out);
    case kSelect:
      return plan_of(relayout_kernel<E, unsigned int, kSelect>, 0, out);
    default: return -1;
  }
}

extern "C" int uf3_relayout_occupancy(int mode, int elem_bytes, int* out) {
  if (elem_bytes == 4) return relayout_occupancy<unsigned int>(mode, out);
  if (elem_bytes == 8)
    return relayout_occupancy<unsigned long long>(mode, out);
  return -1;
}

static int lane_contract_entry(const void* x, const void* w, void* out,
                               long long n, long long max_offset,
                               long long cols_out, int terms,
                               long long in_cols, long long sj,
                               long long st, int is_f64, cudaStream_t s,
                               int* plan) {
  if (n <= 0) return plan != nullptr ? -1 : 0;
  const bool small = fits_32(max_offset);
#define UF3_ARGS x, w, out, n, cols_out, terms, in_cols, sj, st, s, plan
  if (is_f64)
    return small ? launch_lane_contract<double, unsigned int>(UF3_ARGS)
                 : launch_lane_contract<double, long long>(UF3_ARGS);
  return small ? launch_lane_contract<float, unsigned int>(UF3_ARGS)
               : launch_lane_contract<float, long long>(UF3_ARGS);
#undef UF3_ARGS
}

// out (n = rows x cols_out) in float32 (is_f64 0) or float64; w null for
// the plain sums, else (terms, cols_out) in shared memory.
extern "C" int uf3_lane_contract(const void* x, const void* w, void* out,
                                 long long n, long long max_offset,
                                 long long cols_out, int terms,
                                 long long in_cols, long long sj,
                                 long long st, int is_f64, void* stream) {
  return lane_contract_entry(x, w, out, n, max_offset, cols_out, terms,
                             in_cols, sj, st, is_f64, (cudaStream_t)stream,
                             nullptr);
}

// The launch plan of uf3_lane_contract on the same arguments, launching
// nothing: plan = {registers per thread, local bytes per thread, resident
// blocks per SM, warps per SM, kernel (0 the product's tile, 1 one output
// a thread, 2 vectors along the outputs, 3 along the terms), blocks}.
extern "C" int uf3_lane_contract_occupancy(
    const void* x, const void* w, void* out, long long n,
    long long max_offset, long long cols_out, int terms, long long in_cols,
    long long sj, long long st, int is_f64, int* plan) {
  return lane_contract_entry(x, w, out, n, max_offset, cols_out, terms,
                             in_cols, sj, st, is_f64, nullptr, plan);
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
