// Fused 3-body pair-lane pass of the UF3 potential, per center atom:
// energy, center force and the slot partials S1, S3', V3' that the
// reverse-slot assembly gathers into neighbor forces.
//
// Replaces the Pallas TPU kernel make_trio_kernel / trio_forces_pallas
// and its XLA twin trio_forces_unrolled, whose shared per-block body is
// _trio_block_compute (uf3_tpu/ops/pallas_trio.py).  Lane roles as
// there: pair lane (m, n) takes its third leg d[n] - d[m], H from row m
// and the first-leg basis from row n.
//
// What bounds it on the card: issued instructions, not bytes.  An
// atom's I/O is K*4 values in and K*5 + 4 out (~0.6 KB at K = 16),
// while each live pair lane evaluates a third-leg basis and up to
// 4 x 4 (b, c) terms.  Tensor cores and TMA stay out: the contractions
// are (K x 3).(3 x Ww*Cw) per atom and at most 4 x 4 per lane, far
// below a wgmma tile, a tile of I/O per atom is too small for TMA to
// pay, and in float32 a tensor core would mean TF32, which the port
// keeps out of every grid contraction.  All arithmetic is plain FMA in
// the working type.
//
// The design:
// * One warp per atom, several atoms per block (at most 8; fewer when a
//   wide window makes the warps' shared-memory slices large).  The only
//   block-wide barrier stages the leg tables and the grid window once
//   per block; an atom's work syncs with __syncwarp only.  A ragged
//   last block masks its missing atoms.
// * Thread lane = h * KMAX + m owns pair row m (TPR = 32 / KMAX threads
//   per row, in different half-warps so that their reads of row m's H
//   fall on different banks) and walks its share of the valid n.  The sums over n (S1,
//   S3', V3', E) stay in registers; the TPR partial rows and the sums
//   over m (center force, energy) combine with __shfl_xor_sync.
// * Only live work: a warp ballot over `valid` gives the slots (any
//   mask, not only a prefix); a row skips the empty slots and its
//   diagonal, and a lane that fails the 1e-10 A^2 or range gate adds
//   nothing.  Per lane, the <= 4 non-zero first-leg taps b of row n and
//   the <= 4 non-zero third-leg taps c are read from H[m, b, c] by
//   index; taps outside the live window are masked.  Dead (b, c) blocks
//   inside the window hold exact zeros in H (their grid column is 0),
//   so no live mask is needed.
// * No division: each leg's interval lookup (transform, floor, clamp)
//   is followed by Horner on that interval's cubic coefficients (the
//   (n_int, 20) tables of ops/splines.horner_table; the derivative's
//   coefficients follow from the value's), and every 1/r is one rsqrt
//   (r = r^2 / r).
// * An optional (N,) center weight (the halo path's owner weight): a
//   warp whose center weighs 0 writes zeros and returns before any leg
//   basis; any other weight scales the row's outputs as they are
//   written, so a null weight leaves every output's bits as they were.
// * A triangle-lane mode (TRI) for grids symmetric in the first two
//   legs, after the XLA twin's _trio_block_compute_tri: the lanes are
//   the unordered pairs m < n of live slots, each carrying a second
//   derivative chain t2 = sum da_n[b] c[c] H_m[b, c] for slot n's w.
//   A row's lanes would leave slot 0 with K - 1 of them and slot K - 1
//   with none, so the live pairs are dealt round-robin over all 32
//   threads instead.  Every lane then emits partials for two slots that
//   other threads own: it writes (t1, t2, g3) into two (K, K) scratch
//   arrays of its warp slice, and after a __syncwarp each slot's
//   thread sums its column in a fixed order (no atomics: the bits do
//   not vary between runs).  Energy is the plain sum over the lanes.
// * Sizes at compile time (KMAX = 16 or 32 slots, energy or not, full
//   or triangle lanes), generality at run time (any K <= KMAX, any
//   window, the four knot kinds, float32 and float64).
//
// The multi-species pass over every ordered trio type is its own kernel
// (trio_multi.cu); the helpers both use are in trio_common.cuh.

#include "trio_common.cuh"

namespace {

// Byte offsets of the dynamic shared memory: the leg tables and the
// grid window once per block, then one slice per warp.
struct Layout {
  int n_tab;       // table entries (both legs)
  int tab_n;       // first entry of the third leg's rows
  int g_off;       // the (Ww, Ww*Cw) grid window
  int warp_off;    // warp slices
  int hh_off;      // (H, H1) within a warp slice
  int tri_off;     // the triangle mode's two (K, K) scratch arrays
  int warp_bytes;  // one warp slice
};

// The sums of pair lane (m, n): its third leg d[n] - d[m] and, over the
// live (b, c) taps, value = sum a_n[b] c[c] H_m[b, c], t1 the same with
// H1_m, g3 = (the same with dc) / r_mn and, for TRI, t2 the same with
// da_n.  Returns false, writing nothing, where the third leg fails its
// 1e-10 A^2 or range gate.
template <typename T, int KMAX, bool ENERGY, bool TRI>
__device__ __forceinline__ bool lane_sums(
    const Quad<T>& dm, const Quad<T>& dn, int m, int n, const T* tab_n,
    const Leg& leg_n, const Quad<T>* s_a, const Quad<T>* s_da,
    const int* s_idx, const Pair<T>* s_hh, int w_lo, int ww, int c_lo,
    int cw, T& value, T& t1, T& t2, T& g3) {
  const T dx = dn.v[0] - dm.v[0];
  const T dy = dn.v[1] - dm.v[1];
  const T dz = dn.v[2] - dm.v[2];
  const T rmn2 = dx * dx + dy * dy + dz * dz;
  if (!(rmn2 > T(1e-10))) return false;
  const T inv_r = rsqrt_t(rmn2);
  const T rmn = rmn2 * inv_r;
  if (!(rmn >= T(leg_n.t_min) && rmn <= T(leg_n.t_max))) return false;
  const int cidx = leg_interval<T>(leg_n, rmn, rmn2, inv_r);
  T cv[4], cdv[4];
  leg_basis<T>(tab_n, cidx, rmn, T(1), cv, cdv);
  int coff[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = cidx + q - c_lo;
    const bool in = c >= 0 && c < cw;
    cv[q] = in ? cv[q] : T(0);
    cdv[q] = in ? cdv[q] : T(0);
    coff[q] = (in ? c : 0) * KMAX + m;
  }
  const Quad<T> an = s_a[n];
  Quad<T> dan;
  if (TRI) dan = s_da[n];
  const int b0 = s_idx[n] - w_lo;
  const int cwk = cw * KMAX;
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int b = b0 + p;
    if (b < 0 || b >= ww) continue;
    const Pair<T>* hb = s_hh + b * cwk;
    T db = T(0), d1b = T(0), d3b = T(0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const Pair<T> hh = hb[coff[q]];
      if (ENERGY || TRI) db = db + cv[q] * hh.h;
      d1b = d1b + cv[q] * hh.h1;
      d3b = d3b + cdv[q] * hh.h;
    }
    if (ENERGY) a0 = a0 + an.v[p] * db;
    a1 = a1 + an.v[p] * d1b;
    if (TRI) a2 = a2 + dan.v[p] * db;
    a3 = a3 + an.v[p] * d3b;
  }
  value = a0;
  t1 = a1;
  t2 = a2;
  g3 = a3 * inv_r;
  return true;
}

// One block's atoms, one warp each: the body of both kernels below.
template <typename T, int KMAX, bool ENERGY, bool TRI>
__device__ __forceinline__ void trio_rows(
    const T* __restrict__ d, const T* __restrict__ valid,
    const T* __restrict__ cweight, const T* __restrict__ gwin,
    const T* __restrict__ tables, T* __restrict__ energy,
    T* __restrict__ fc, T* __restrict__ part, int n_atoms, int K,
    Leg leg_l, Leg leg_n, int w_lo, int ww, int c_lo, int cw,
    const Layout& lay) {
  constexpr int TPR = kWarp / KMAX;  // threads per pair row
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_g = reinterpret_cast<T*>(smem + lay.g_off);
  const int wc = ww * cw;
  for (int i = threadIdx.x; i < lay.n_tab; i += blockDim.x)
    s_tab[i] = tables[i];
  for (int i = threadIdx.x; i < ww * wc; i += blockDim.x) s_g[i] = gwin[i];
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long atom =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (atom >= n_atoms) return;  // ragged last block
  if (cweight != nullptr && cweight[atom] == T(0)) {
    // a center of weight 0 (a halo row): zeros, no leg basis
    for (int i = lane; i < 5 * K; i += kWarp) part[atom * 5 * K + i] = T(0);
    if (lane == 0) {
      fc[atom * 3] = fc[atom * 3 + 1] = fc[atom * 3 + 2] = T(0);
      energy[atom] = T(0);
    }
    return;
  }
  unsigned char* ws = smem + lay.warp_off + warp * lay.warp_bytes;
  Quad<T>* s_d = reinterpret_cast<Quad<T>*>(ws);  // (KMAX) x, y, z, -
  Quad<T>* s_a = s_d + KMAX;                      // first-leg values
  Quad<T>* s_da = s_a + KMAX;                     // and d/dr, 4 taps
  T* s_ir = reinterpret_cast<T*>(s_da + KMAX);    // (KMAX) 1 / |d|
  int* s_idx = reinterpret_cast<int*>(s_ir + KMAX);  // first tap
  int* s_live = s_idx + KMAX;  // TRI: the live slots in ascending order
  Pair<T>* s_hh = reinterpret_cast<Pair<T>*>(ws + lay.hh_off);
  // s_hh[col * KMAX + m], col = (b - w_lo) * Cw + (c - c_lo)

  const T* d_atom = d + atom * 3 * K;
  for (int i = lane; i < 3 * K; i += kWarp) {
    const int m = i / 3;
    s_d[m].v[i - 3 * m] = d_atom[i];
  }
  const bool v_lane = lane < K && valid[atom * K + lane] != T(0);
  const unsigned vmask = __ballot_sync(kFull, v_lane);
  if (TRI && v_lane) s_live[__popc(vmask & ((1u << lane) - 1u))] = lane;
  __syncwarp();

  // first-leg bases, one slot per lane
  if (lane < K) {
    const Quad<T> p = s_d[lane];
    T r2 = p.v[0] * p.v[0] + p.v[1] * p.v[1] + p.v[2] * p.v[2];
    r2 = r2 > T(0) ? r2 : T(1);
    const T inv_r = rsqrt_t(r2);
    const T r = r2 * inv_r;
    const T gate = (v_lane && r >= T(leg_l.t_min) && r <= T(leg_l.t_max))
                       ? T(1) : T(0);
    const int idx = leg_interval<T>(leg_l, r, r2, inv_r);
    Quad<T> a, da;
    leg_basis<T>(s_tab, idx, r, gate, a.v, da.v);
    s_a[lane] = a;
    s_da[lane] = da;
    s_ir[lane] = inv_r;
    s_idx[lane] = idx;
  }
  __syncwarp();

  // H[m, col] = sum_l A[m, l] G[l, col] over the <= 4 taps of row m
  for (int i = lane; i < KMAX * wc; i += kWarp) {
    const int m = i % KMAX;
    if (m >= K || !((vmask >> m) & 1u)) continue;
    const int col = i / KMAX;
    const int l0 = s_idx[m] - w_lo;
    const Quad<T> a = s_a[m], da = s_da[m];
    T h = T(0), h1 = T(0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = l0 + q;
      if (l >= 0 && l < ww) {
        const T g = s_g[l * wc + col];
        h = h + a.v[q] * g;
        h1 = h1 + da.v[q] * g;
      }
    }
    s_hh[i] = Pair<T>{h, h1};
  }
  __syncwarp();

  // the slot m whose partials this thread sums (TPR threads per slot)
  const int m = lane % KMAX;
  const bool row_ok = m < K && ((vmask >> m) & 1u);
  const T* tab_n = s_tab + lay.tab_n;
  T w = T(0), s3 = T(0), vx = T(0), vy = T(0), vz = T(0), e = T(0);
  if constexpr (TRI) {
    // s_w[b * K + a]: lane {a, b}'s term of w_a; s_g3 the lane's g3
    T* s_w = reinterpret_cast<T*>(ws + lay.tri_off);
    T* s_g3 = s_w + K * K;
    // this thread's lanes: numbers lane, lane + 32, ... of the live
    // pairs (i < j) of the P live slots, row-major
    const int P = __popc(vmask);
    int i = 0, rem = lane;
    while (i < P - 1 && rem >= P - 1 - i) {
      rem -= P - 1 - i;
      ++i;
    }
    while (i < P - 1) {
      const int a = s_live[i], b = s_live[i + 1 + rem];  // a < b
      T value = T(0), t1 = T(0), t2 = T(0), g3 = T(0);
      lane_sums<T, KMAX, ENERGY, true>(s_d[a], s_d[b], a, b, tab_n, leg_n,
                                       s_a, s_da, s_idx, s_hh, w_lo, ww,
                                       c_lo, cw, value, t1, t2, g3);
      s_w[b * K + a] = t1;
      s_w[a * K + b] = t2;
      s_g3[b * K + a] = g3;
      s_g3[a * K + b] = g3;
      if (ENERGY) e = e + value;
      rem += kWarp;
      while (i < P - 1 && rem >= P - 1 - i) {
        rem -= P - 1 - i;
        ++i;
      }
    }
    __syncwarp();
    // slot m's column over this thread's share of its live partners
    if (row_ok) {
      unsigned bits = vmask & ~(1u << m);
      for (int j = 0; bits; bits &= bits - 1, ++j) {
        if (j % TPR != lane / KMAX) continue;
        const int b = __ffs(bits) - 1;
        const T g3 = s_g3[b * K + m];
        const Quad<T> db = s_d[b];
        w = w + s_w[b * K + m];
        s3 = s3 + g3;
        vx = vx + g3 * db.v[0];
        vy = vy + g3 * db.v[1];
        vz = vz + g3 * db.v[2];
      }
    }
  } else {
    // pair lanes of row m: this thread's share of the valid n != m
    const Quad<T> dm = s_d[m];
    unsigned mine = 0;
    if (row_ok) {
      unsigned bits = vmask & ~(1u << m);
      for (int j = 0; bits; bits &= bits - 1, ++j)
        if (j % TPR == lane / KMAX) mine |= bits & (0u - bits);
    }
    while (mine) {
      const int n = __ffs(mine) - 1;
      mine &= mine - 1;
      const Quad<T> dn = s_d[n];
      T value, t1, t2, g3;
      if (!lane_sums<T, KMAX, ENERGY, false>(dm, dn, m, n, tab_n, leg_n,
                                             s_a, s_da, s_idx, s_hh, w_lo,
                                             ww, c_lo, cw, value, t1, t2,
                                             g3))
        continue;
      w = w + t1;
      s3 = s3 + g3;
      vx = vx + g3 * dn.v[0];
      vy = vy + g3 * dn.v[1];
      vz = vz + g3 * dn.v[2];
      if (ENERGY) e = e + value;
    }
  }
#pragma unroll
  for (int off = KMAX; off < kWarp; off <<= 1) {
    w = w + __shfl_xor_sync(kFull, w, off);
    s3 = s3 + __shfl_xor_sync(kFull, s3, off);
    vx = vx + __shfl_xor_sync(kFull, vx, off);
    vy = vy + __shfl_xor_sync(kFull, vy, off);
    vz = vz + __shfl_xor_sync(kFull, vz, off);
    if (ENERGY) e = e + __shfl_xor_sync(kFull, e, off);
  }
  // the center's weight scales its row's outputs (1 without weights:
  // the same bits)
  const T w_c = cweight != nullptr ? cweight[atom] : T(1);
  const bool head = lane < KMAX;
  if (head && m < K) {
    T* out = part + (atom * K + m) * 5;
    out[0] = w * w_c;
    out[1] = s3 * w_c;
    out[2] = vx * w_c;
    out[3] = vy * w_c;
    out[4] = vz * w_c;
  }
  // center force sum_m w_m / r_m d_m and energy over the warp (the
  // triangle's threads hold lanes of every row: their e sums the same
  // way)
  T fx = T(0), fy = T(0), fz = T(0);
  if (head && row_ok) {
    const T wr = w * s_ir[m];
    const Quad<T> dm = s_d[m];
    fx = wr * dm.v[0];
    fy = wr * dm.v[1];
    fz = wr * dm.v[2];
  }
  e = head ? e : T(0);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    fx = fx + __shfl_xor_sync(kFull, fx, off);
    fy = fy + __shfl_xor_sync(kFull, fy, off);
    fz = fz + __shfl_xor_sync(kFull, fz, off);
    if (ENERGY) e = e + __shfl_xor_sync(kFull, e, off);
  }
  if (lane == 0) {
    fc[atom * 3] = fx * w_c;
    fc[atom * 3 + 1] = fy * w_c;
    fc[atom * 3 + 2] = fz * w_c;
    energy[atom] = (TRI ? e : T(0.5) * e) * w_c;
  }
}

// Full lanes, at ptxas's own register target.
template <typename T, int KMAX, bool ENERGY>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
trio_kernel(const T* __restrict__ d, const T* __restrict__ valid,
            const T* __restrict__ cweight, const T* __restrict__ gwin,
            const T* __restrict__ tables, T* __restrict__ energy,
            T* __restrict__ fc, T* __restrict__ part, int n_atoms, int K,
            Leg leg_l, Leg leg_n, int w_lo, int ww, int c_lo, int cw,
            Layout lay) {
  trio_rows<T, KMAX, ENERGY, false>(d, valid, cweight, gwin, tables, energy,
                                    fc, part, n_atoms, K, leg_l, leg_n, w_lo,
                                    ww, c_lo, cw, lay);
}

// Triangle lanes.  Their scratch leaves room for at most 2 blocks of 8
// warps per SM in float64 (4 in float32), so the registers may grow to
// that occupancy: at ptxas's own target the float64 instance spills.
template <typename T, int KMAX, bool ENERGY>
__global__ void __launch_bounds__(kWarp * kMaxWarps, sizeof(T) == 8 ? 2 : 4)
trio_tri_kernel(const T* __restrict__ d, const T* __restrict__ valid,
                const T* __restrict__ cweight, const T* __restrict__ gwin,
                const T* __restrict__ tables, T* __restrict__ energy,
                T* __restrict__ fc, T* __restrict__ part, int n_atoms,
                int K, Leg leg_l, Leg leg_n, int w_lo, int ww, int c_lo,
                int cw, Layout lay) {
  trio_rows<T, KMAX, ENERGY, true>(d, valid, cweight, gwin, tables, energy,
                                   fc, part, n_atoms, K, leg_l, leg_n, w_lo,
                                   ww, c_lo, cw, lay);
}

template <typename T, int KMAX, bool ENERGY, bool TRI>
constexpr auto kernel_of() {
  if constexpr (TRI)
    return trio_tri_kernel<T, KMAX, ENERGY>;
  else
    return trio_kernel<T, KMAX, ENERGY>;
}

struct Args {
  const void* d;
  const void* valid;
  const void* cweight;  // (N,) center weights, or null
  const void* gwin;
  const void* tables;
  void* energy;
  void* fc;
  void* part;
  int n_atoms, K;
  Leg leg_l, leg_n;
  int w_lo, ww, c_lo, cw;
  void* stream;
};

// Launch (occ == nullptr) or report the plan: occ = {atoms per block,
// shared bytes per block, resident blocks per SM, registers per thread,
// local (spill) bytes per thread}.
template <typename T, int KMAX, bool ENERGY, bool TRI>
int run(const Args& a, int* occ) {
  Layout lay;
  lay.n_tab = (a.leg_l.n_int + a.leg_n.n_int) * kTab;
  lay.tab_n = a.leg_l.n_int * kTab;
  lay.g_off = int(round32(size_t(lay.n_tab) * sizeof(T)));
  lay.warp_off = lay.g_off
                 + int(round32(size_t(a.ww) * a.ww * a.cw * sizeof(T)));
  lay.hh_off = int(round32(KMAX * (13 * sizeof(T)
                                    + (TRI ? 2 : 1) * sizeof(int))));
  lay.tri_off = lay.hh_off
                + int(round32(size_t(KMAX) * a.ww * a.cw * 2 * sizeof(T)));
  lay.warp_bytes = lay.tri_off
                   + (TRI ? int(round32(size_t(2) * a.K * a.K * sizeof(T)))
                          : 0);
  int warps = kMaxWarps;
  while (warps > 1
         && size_t(lay.warp_off) + size_t(warps) * lay.warp_bytes
                > kSmemLimit)
    --warps;
  const size_t smem = size_t(lay.warp_off) + size_t(warps) * lay.warp_bytes;
  if (smem > kSmemLimit) return kErrSmem;
  auto kernel = kernel_of<T, KMAX, ENERGY, TRI>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  if (occ != nullptr) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return int(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, warps * kWarp, smem);
    if (err != cudaSuccess) return int(err);
    occ[0] = warps;
    occ[1] = int(smem);
    occ[2] = blocks;
    occ[3] = attr.numRegs;
    occ[4] = int(attr.localSizeBytes);
    return 0;
  }
  if (a.n_atoms == 0) return 0;
  const int grid = (a.n_atoms + warps - 1) / warps;
  kernel<<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const T*>(a.d), static_cast<const T*>(a.valid),
      static_cast<const T*>(a.cweight), static_cast<const T*>(a.gwin),
      static_cast<const T*>(a.tables), static_cast<T*>(a.energy),
      static_cast<T*>(a.fc),
      static_cast<T*>(a.part), a.n_atoms, a.K, a.leg_l, a.leg_n, a.w_lo,
      a.ww, a.c_lo, a.cw, lay);
  return int(cudaGetLastError());
}

template <typename T, int KMAX>
int pick(const Args& a, int with_energy, int triangle, int* occ) {
  if (triangle)
    return with_energy ? run<T, KMAX, true, true>(a, occ)
                       : run<T, KMAX, false, true>(a, occ);
  return with_energy ? run<T, KMAX, true, false>(a, occ)
                     : run<T, KMAX, false, false>(a, occ);
}

template <typename T>
int dispatch(const Args& a, int with_energy, int triangle, int* occ) {
  if (a.K > 32) return int(cudaErrorInvalidValue);
  if (a.K <= 16) return pick<T, 16>(a, with_energy, triangle, occ);
  return pick<T, 32>(a, with_energy, triangle, occ);
}

Args make_args(const void* d, const void* valid, const void* cweight,
               const void* gwin, const void* tables, void* energy,
               void* fc, void* part, int n_atoms, int K,
               const double* legs, const int* ints,
               int w_lo, int ww, int c_lo, int cw, void* stream) {
  Args a;
  a.d = d;
  a.valid = valid;
  a.cweight = cweight;
  a.gwin = gwin;
  a.tables = tables;
  a.energy = energy;
  a.fc = fc;
  a.part = part;
  a.n_atoms = n_atoms;
  a.K = K;
  a.leg_l = Leg{ints[0], ints[1], legs[0], legs[1], legs[2], legs[3]};
  a.leg_n = Leg{ints[2], ints[3], legs[4], legs[5], legs[6], legs[7]};
  a.w_lo = w_lo;
  a.ww = ww;
  a.c_lo = c_lo;
  a.cw = cw;
  a.stream = stream;
  return a;
}

}  // namespace

// cweight: the (N,) center weights, or null for none: a center of
// weight 0 gets zeros and skips its work, any other weight scales its
// energy, center force and partials.  triangle: 1 for the triangle
// lanes (a grid symmetric in its first two legs only), 0 for full
// lanes.  legs: (u0, 1/h, t_min, t_max) of
// the first legs, then of the third leg; ints: (kind, n_int) of the
// first legs, then of the third leg; tables: the first legs' (n_int,
// 20) Horner rows, then the third leg's.  Returns cudaGetLastError()
// after the launch (0 on success), or -1 when one warp's shared memory
// for this K and window exceeds 227 KB.
extern "C" int uf3_trio_partials_f32(
    const void* d, const void* valid, const void* cweight, const void* gwin,
    const void* tables, void* energy, void* fc, void* part, int n_atoms, int K,
    const double* legs, const int* ints, int w_lo, int ww, int c_lo, int cw,
    int with_energy, int triangle, void* stream) {
  return dispatch<float>(make_args(d, valid, cweight, gwin, tables, energy,
                                   fc, part, n_atoms, K, legs, ints, w_lo,
                                   ww, c_lo, cw, stream),
                         with_energy, triangle, nullptr);
}

extern "C" int uf3_trio_partials_f64(
    const void* d, const void* valid, const void* cweight, const void* gwin,
    const void* tables, void* energy, void* fc, void* part, int n_atoms, int K,
    const double* legs, const int* ints, int w_lo, int ww, int c_lo, int cw,
    int with_energy, int triangle, void* stream) {
  return dispatch<double>(make_args(d, valid, cweight, gwin, tables, energy,
                                    fc, part, n_atoms, K, legs, ints, w_lo,
                                    ww, c_lo, cw, stream),
                          with_energy, triangle, nullptr);
}

// The launch plan of the kernel that uf3_trio_partials_{f32,f64} would
// run for these sizes and mode: out = {atoms per block, shared bytes per
// block, resident blocks per SM, registers per thread, local bytes per
// thread}.
extern "C" int uf3_trio_occupancy(int is_f64, int K, const int* ints, int ww,
                                  int cw, int with_energy, int triangle,
                                  int* out) {
  const double legs[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, 0, K, legs, ints, 0, ww,
                           0, cw, nullptr);
  return is_f64 ? dispatch<double>(a, with_energy, triangle, out)
                : dispatch<float>(a, with_energy, triangle, out);
}
