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
// What bounds it on the card: issued instructions and their latency, not
// bytes.  An atom's I/O is K*4 values in and K*5 + 4 out (~0.6 KB at
// K = 16), while each live pair lane runs one dependent chain (rsqrt,
// interval, Horner for 4 values and 4 derivatives, then up to 4 x 4
// (b, c) terms read from H in shared memory).  So the design is about
// keeping all 32 threads of a warp on live lanes and enough warps on an
// SM to hide the chains.  Tensor cores and TMA stay out: the
// contractions are (K x 3).(3 x Ww*Cw) per atom and at most 4 x 4 per
// lane, far below a wgmma tile, a tile of I/O per atom is too small for
// TMA to pay, and in float32 a tensor core would mean TF32, which the
// port keeps out of every grid contraction.  All arithmetic is plain FMA
// in the working type.
//
// The design:
// * One warp per atom, 8 warps a block, persistent blocks: the grid is
//   at most the resident blocks of every SM (the occupancy query, once
//   per instance and shared-memory size, kept), each warp walks the
//   atoms with a grid stride, and the block stages the leg tables and
//   the grid window once, not once per 8 atoms; a warp past the last
//   atom stops.
// * Rows by live rank, not by slot: a warp ballot over `valid` gives the
//   live slots (any mask) and their ranks; row r is the r-th live slot.
//   A pass takes at most 16 live rows, R of them rounded up to a power
//   of two, each served by 32 / R threads (lane = h * R + r) that split
//   its live partners and combine with __shfl_xor_sync over offsets R
//   .. 16.  A K = 20-32 list with 14 live slots runs 2 threads a row as
//   the K = 16 one does (by slot, 18 of 32 threads sat idle); a list
//   with more than 16 live slots takes a second pass.  H holds 16 rows
//   (hh[col * 16 + r]), so a KMAX = 32 warp's slice is sized like a
//   KMAX = 16 one's.  Dead slots' partial rows are written as zeros.
// * Only live work: a row walks its live partners but itself; a lane
//   whose third leg fails the 1e-10 A^2 or range gate evaluates with a
//   zero gate and adds zeros (no branch).  Per lane, the <= 4 non-zero
//   first-leg taps b of row n and the <= 4 non-zero third-leg taps c
//   are read from H[r, b, c] by index; taps outside the live window are
//   masked.  Dead (b, c) blocks inside the window hold exact zeros in H
//   (their grid column is 0), so no live mask is needed.
// * No division: each leg's interval lookup (transform, floor, clamp)
//   is followed by Horner on that interval's cubic coefficients (the
//   (n_int, 20) tables of ops/splines.horner_table; the derivative's
//   coefficients follow from the value's), and every 1/r is one rsqrt
//   (r = r^2 / r).
// * Fixed sums: a row's threads add their lanes in rank order and
//   combine in a fixed shuffle order, with no atomics, so the bits do
//   not vary between runs.
// * An optional (N,) center weight (the halo path's owner weight): a
//   warp whose center weighs 0 writes zeros and moves on before any leg
//   basis; any other weight scales the row's outputs as they are
//   written, so a null weight leaves every output's bits as they were.
// * A triangle-lane mode (TRI) for grids symmetric in the first two
//   legs, after the XLA twin's _trio_block_compute_tri: the lanes are
//   the unordered pairs of live ranks i < j, each carrying a second
//   derivative chain t2 = sum da_n[b] c[c] H_m[b, c] for slot n's w.
//   A row's lanes would leave rank 0 with P - 1 of them and rank P - 1
//   with none, so the live pairs (of the pass's rows i) are dealt
//   round-robin over all 32 threads instead.  Every lane writes (t1, t2,
//   g3) into two (K, K) scratch arrays of its warp slice; after a
//   __syncwarp each slot's row sums its column by rank as above.  Energy
//   is the plain sum over the lanes.
// * Registers: the float32 full-lane and KMAX = 16 triangle instances
//   are held to 64 registers (32 warps per SM) by their launch bounds,
//   the KMAX = 32 triangle ones to 80 (their scratch allows 24 warps at
//   most); float64 keeps ptxas's own count on full lanes (16 warps per
//   SM) and 128 on triangle lanes; no instance spills.
// * Sizes at compile time (KMAX = 16 or 32 slots, energy or not, full
//   or triangle lanes), generality at run time (any K <= KMAX, any
//   window, the four knot kinds, float32 and float64).
//
// Measured and left out (PERF.md section 6: benchmarks/kernel_variants.py
// on the patches in benchmarks_data/artifacts_torch/kernel_variants/):
// two partners a thread side by side in one loop step, to overlap their
// chains, ran slower on every full-lane list (more registers: 8 bytes of
// spills at 64 in float32, 8 warps per SM in float64 with energy); the
// float64 full lanes held to 80 registers for 24 warps per SM spilled
// and ran slower.  Float64 at ptxas's own count (16 warps per SM, where
// the rows by slot took 80 registers and 24 warps at KMAX = 16) is still
// faster than the rows by slot, with and without energy.
//
// The multi-species pass over every ordered trio type is its own kernel
// (trio_multi.cu); the helpers both use are in trio_common.cuh.

#include "trio_common.cuh"

namespace {

struct Layout {
  int n_tab;       // table entries (both legs)
  int tab_n;       // first entry of the third leg's rows
  int g_off;       // the (Ww, Ww*Cw) grid window
  int warp_off;    // warp slices
  int hh_off;      // (H, H1) within a warp slice
  int tri_off;     // the triangle mode's two (K, K) scratch arrays
  int warp_bytes;  // one warp slice
};

// The least power of two >= p (1 for p <= 1).
__device__ __forceinline__ int pow2_ceil(int p) {
  return p <= 1 ? 1 : 1 << (32 - __clz(p - 1));
}

// The sums of pair lane (m, n), with no branch: a lane that fails the
// 1e-10 A^2 or range gate of its third leg d[n] - d[m] (n == m among
// them) evaluates with a zero gate and gives zeros.  hrow: row m's H row
// in the slice (its rank in the pass).
template <typename T, int CAP, bool ENERGY, bool TRI>
__device__ __forceinline__ void lane_sums(
    const Quad<T>& dm, const Quad<T>& dn, int hrow, int n, const T* tab_n,
    const Leg& leg_n, const Quad<T>* s_a, const Quad<T>* s_da,
    const int* s_idx, const Pair<T>* s_hh, int w_lo, int ww, int c_lo,
    int cw, T& value, T& t1, T& t2, T& g3) {
  const T dx = dn.v[0] - dm.v[0];
  const T dy = dn.v[1] - dm.v[1];
  const T dz = dn.v[2] - dm.v[2];
  const T raw2 = dx * dx + dy * dy + dz * dz;
  bool ok = raw2 > T(1e-10);
  const T rmn2 = ok ? raw2 : T(1);
  const T inv_r = rsqrt_t(rmn2);
  const T rmn = rmn2 * inv_r;
  ok = ok && rmn >= T(leg_n.t_min) && rmn <= T(leg_n.t_max);
  const int cidx = leg_interval<T>(leg_n, rmn, rmn2, inv_r);
  T cv[4], cdv[4];
  leg_basis<T>(tab_n, cidx, rmn, ok ? T(1) : T(0), cv, cdv);
  int coff[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = cidx + q - c_lo;
    const bool in = c >= 0 && c < cw;
    cv[q] = in ? cv[q] : T(0);
    cdv[q] = in ? cdv[q] : T(0);
    coff[q] = (in ? c : 0) * CAP + hrow;
  }
  const Quad<T> an = s_a[n];
  Quad<T> dan;
  if (TRI) dan = s_da[n];
  const int b0 = s_idx[n] - w_lo;
  const int cwk = cw * CAP;
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
}

// The pointers of one warp's slice.
template <typename T, int KMAX>
struct Slice {
  Quad<T>* d;      // (KMAX) x, y, z, -
  Quad<T>* a;      // first-leg values
  Quad<T>* da;     // and d/dr, 4 taps
  T* ir;           // (KMAX) 1 / |d|
  int* idx;        // first tap
  int* live;       // the live slots by rank
  Pair<T>* hh;     // hh[col * CAP + r], col = (b - w_lo) * Cw + (c - c_lo)
  T* w;            // TRI: s_w[b * K + a], lane {a, b}'s term of w_a
  T* g3;           // TRI: the lane's g3
  __device__ Slice(unsigned char* ws, const Layout& lay, int K) {
    d = reinterpret_cast<Quad<T>*>(ws);
    a = d + KMAX;
    da = a + KMAX;
    ir = reinterpret_cast<T*>(da + KMAX);
    idx = reinterpret_cast<int*>(ir + KMAX);
    live = idx + KMAX;
    hh = reinterpret_cast<Pair<T>*>(ws + lay.hh_off);
    w = reinterpret_cast<T*>(ws + lay.tri_off);
    g3 = w + K * K;
  }
};

// One atom on one warp.
template <typename T, int KMAX, int CAP, bool ENERGY, bool TRI>
__device__ __forceinline__ void trio_atom(
    long long atom, int lane, const Slice<T, KMAX>& s, const T* s_tab,
    const T* s_g, const T* __restrict__ d, const T* __restrict__ valid,
    const T* __restrict__ cweight, T* __restrict__ energy,
    T* __restrict__ fc, T* __restrict__ part, int K, const Leg& leg_l,
    const Leg& leg_n, int w_lo, int ww, int c_lo, int cw, int tab_off) {
  if (cweight != nullptr && cweight[atom] == T(0)) {
    // a center of weight 0 (a halo row): zeros, no leg basis
    for (int i = lane; i < 5 * K; i += kWarp) part[atom * 5 * K + i] = T(0);
    if (lane == 0) {
      fc[atom * 3] = fc[atom * 3 + 1] = fc[atom * 3 + 2] = T(0);
      energy[atom] = T(0);
    }
    return;
  }
  const int wc = ww * cw;
  const T* d_atom = d + atom * 3 * K;
  for (int i = lane; i < 3 * K; i += kWarp) {
    const int m = i / 3;
    s.d[m].v[i - 3 * m] = d_atom[i];
  }
  const bool v_lane = lane < K && valid[atom * K + lane] != T(0);
  const unsigned vmask = __ballot_sync(kFull, v_lane);
  const int P = __popc(vmask);
  if (v_lane) s.live[__popc(vmask & ((1u << lane) - 1u))] = lane;
  __syncwarp();

  // first-leg bases, one slot per lane
  if (lane < K) {
    const Quad<T> p = s.d[lane];
    T r2 = p.v[0] * p.v[0] + p.v[1] * p.v[1] + p.v[2] * p.v[2];
    r2 = r2 > T(0) ? r2 : T(1);
    const T inv_r = rsqrt_t(r2);
    const T r = r2 * inv_r;
    const T gate = (v_lane && r >= T(leg_l.t_min) && r <= T(leg_l.t_max))
                       ? T(1) : T(0);
    const int idx = leg_interval<T>(leg_l, r, r2, inv_r);
    Quad<T> a, da;
    leg_basis<T>(s_tab, idx, r, gate, a.v, da.v);
    s.a[lane] = a;
    s.da[lane] = da;
    s.ir[lane] = inv_r;
    s.idx[lane] = idx;
    if (!v_lane) {  // a dead slot's partial row: explicit zeros
      T* out = part + (atom * K + lane) * 5;
#pragma unroll
      for (int c = 0; c < 5; ++c) out[c] = T(0);
    }
  }
  __syncwarp();

  const T w_c = cweight != nullptr ? cweight[atom] : T(1);
  const T* tab_n = s_tab + tab_off;
  T fx = T(0), fy = T(0), fz = T(0), e = T(0);
  // passes of at most CAP live rows (one pass when P <= CAP)
  const int passes_end = CAP >= KMAX ? 1 : P;
  for (int base = 0; base < passes_end; base += CAP) {
    const int np = min(P - base, CAP);
    const int R = pow2_ceil(np);
    const int lg = __ffs(R) - 1;
    // H[r, col] = sum_l A[m, l] G[l, col] over the <= 4 taps of row m
    for (int i = lane; i < R * wc; i += kWarp) {
      const int r = i & (R - 1);
      if (r >= np) continue;
      const int col = i >> lg;
      const int m = s.live[base + r];
      const int l0 = s.idx[m] - w_lo;
      const Quad<T> a = s.a[m], da = s.da[m];
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
      s.hh[col * CAP + r] = Pair<T>{h, h1};
    }
    __syncwarp();
    if constexpr (TRI) {
      // this thread's lanes: numbers lane, lane + 32, ... of the live
      // pairs (i < j) with i in this pass, row-major
      const int i_end = min(base + np, P - 1);
      int i = base, rem = lane;
      while (i < i_end && rem >= P - 1 - i) {
        rem -= P - 1 - i;
        ++i;
      }
      while (i < i_end) {
        const int a = s.live[i], b = s.live[i + 1 + rem];  // a < b
        T value, t1, t2, g3;
        lane_sums<T, CAP, ENERGY, true>(s.d[a], s.d[b], i - base, b, tab_n,
                                        leg_n, s.a, s.da, s.idx, s.hh, w_lo,
                                        ww, c_lo, cw, value, t1, t2, g3);
        s.w[b * K + a] = t1;
        s.w[a * K + b] = t2;
        s.g3[b * K + a] = g3;
        s.g3[a * K + b] = g3;
        if (ENERGY) e = e + value;
        rem += kWarp;
        while (i < i_end && rem >= P - 1 - i) {
          rem -= P - 1 - i;
          ++i;
        }
      }
    } else {
      // row r of the pass: slot m = live[base + r], served by the
      // threads lane = h * R + r, each over its share of the partners
      const int r = lane & (R - 1);
      const int h = lane >> lg;
      const int tpr = kWarp >> lg;
      const int rr = base + r;
      const bool row_ok = r < np;
      const int m = row_ok ? s.live[rr] : 0;
      const Quad<T> dm = s.d[m];
      T w = T(0), s3 = T(0), vx = T(0), vy = T(0), vz = T(0);
      if (row_ok) {
        for (int q = h; q < P; q += tpr) {
          if (q == rr) continue;
          const int n = s.live[q];
          const Quad<T> dn = s.d[n];
          T value, t1, t2, g3;
          lane_sums<T, CAP, ENERGY, false>(dm, dn, r, n, tab_n, leg_n, s.a,
                                           s.da, s.idx, s.hh, w_lo, ww, c_lo,
                                           cw, value, t1, t2, g3);
          w = w + t1;
          s3 = s3 + g3;
          vx = vx + g3 * dn.v[0];
          vy = vy + g3 * dn.v[1];
          vz = vz + g3 * dn.v[2];
          if (ENERGY) e = e + value;
        }
      }
      for (int off = R; off < kWarp; off <<= 1) {
        w = w + __shfl_xor_sync(kFull, w, off);
        s3 = s3 + __shfl_xor_sync(kFull, s3, off);
        vx = vx + __shfl_xor_sync(kFull, vx, off);
        vy = vy + __shfl_xor_sync(kFull, vy, off);
        vz = vz + __shfl_xor_sync(kFull, vz, off);
      }
      if (row_ok && h == 0) {
        T* out = part + (atom * K + m) * 5;
        out[0] = w * w_c;
        out[1] = s3 * w_c;
        out[2] = vx * w_c;
        out[3] = vy * w_c;
        out[4] = vz * w_c;
        const T wr = w * s.ir[m];
        fx = fx + wr * dm.v[0];
        fy = fy + wr * dm.v[1];
        fz = fz + wr * dm.v[2];
      }
    }
    __syncwarp();  // the next pass overwrites H
  }
  if constexpr (TRI) {
    // slot m = live[r]'s column over this thread's share of its live
    // partners, in rank order
    const int R = pow2_ceil(P);
    const int lg = __ffs(R) - 1;
    const int r = lane & (R - 1);
    const int h = lane >> lg;
    const int tpr = kWarp >> lg;
    const bool row_ok = r < P;
    const int m = row_ok ? s.live[r] : 0;
    T w = T(0), s3 = T(0), vx = T(0), vy = T(0), vz = T(0);
    if (row_ok) {
      for (int q = h; q < P; q += tpr) {
        if (q == r) continue;
        const int b = s.live[q];
        const T g3 = s.g3[b * K + m];
        const Quad<T> db = s.d[b];
        w = w + s.w[b * K + m];
        s3 = s3 + g3;
        vx = vx + g3 * db.v[0];
        vy = vy + g3 * db.v[1];
        vz = vz + g3 * db.v[2];
      }
    }
    for (int off = R; off < kWarp; off <<= 1) {
      w = w + __shfl_xor_sync(kFull, w, off);
      s3 = s3 + __shfl_xor_sync(kFull, s3, off);
      vx = vx + __shfl_xor_sync(kFull, vx, off);
      vy = vy + __shfl_xor_sync(kFull, vy, off);
      vz = vz + __shfl_xor_sync(kFull, vz, off);
    }
    if (row_ok && h == 0) {
      T* out = part + (atom * K + m) * 5;
      out[0] = w * w_c;
      out[1] = s3 * w_c;
      out[2] = vx * w_c;
      out[3] = vy * w_c;
      out[4] = vz * w_c;
      const T wr = w * s.ir[m];
      const Quad<T> dm = s.d[m];
      fx = wr * dm.v[0];
      fy = wr * dm.v[1];
      fz = wr * dm.v[2];
    }
  }
  // center force sum_m w_m / r_m d_m and energy over the warp
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

// The block's warps walk the atoms with a grid stride, after one
// staging of the leg tables and the grid window.
template <typename T, int KMAX, bool ENERGY, bool TRI>
__device__ __forceinline__ void trio_rows(
    const T* __restrict__ d, const T* __restrict__ valid,
    const T* __restrict__ cweight, const T* __restrict__ gwin,
    const T* __restrict__ tables, T* __restrict__ energy,
    T* __restrict__ fc, T* __restrict__ part, int n_atoms, int K,
    Leg leg_l, Leg leg_n, int w_lo, int ww, int c_lo, int cw,
    const Layout& lay) {
  constexpr int CAP = KMAX > 16 ? 16 : KMAX;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_g = reinterpret_cast<T*>(smem + lay.g_off);
  const int wc = ww * cw;
  for (int i = threadIdx.x; i < lay.n_tab; i += blockDim.x)
    s_tab[i] = tables[i];
  for (int i = threadIdx.x; i < ww * wc; i += blockDim.x) s_g[i] = gwin[i];
  __syncthreads();
  const int warps = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const Slice<T, KMAX> s(smem + lay.warp_off + warp * lay.warp_bytes, lay,
                         K);
  for (long long atom = static_cast<long long>(blockIdx.x) * warps + warp;
       atom < n_atoms; atom += static_cast<long long>(gridDim.x) * warps) {
    trio_atom<T, KMAX, CAP, ENERGY, TRI>(atom, lane, s, s_tab, s_g, d, valid,
                                         cweight, energy, fc, part, K, leg_l,
                                         leg_n, w_lo, ww, c_lo, cw,
                                         lay.tab_n);
    __syncwarp();  // the next atom overwrites the slice
  }
}

template <typename T, int KMAX, bool ENERGY>
__global__ void __launch_bounds__(kWarp * kMaxWarps, sizeof(T) == 8 ? 1 : 4)
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

template <typename T, int KMAX, bool ENERGY>
__global__ void __launch_bounds__(kWarp * kMaxWarps,
                                  sizeof(T) == 8 ? 2 : KMAX > 16 ? 3 : 4)
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

// The resident blocks per SM and the SM count of one instance at one
// shared-memory size on the current device, queried once and kept.
struct Residency {
  int device = -1;
  size_t smem = 0;
  int blocks = 0;
  int sms = 0;
};

template <typename T, int KMAX, bool ENERGY, bool TRI>
int residency(size_t smem, int threads, Residency& out) {
  static Residency kept;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  if (kept.device != device || kept.smem != smem) {
    auto kernel = kernel_of<T, KMAX, ENERGY, TRI>();
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
      if (err != cudaSuccess) return int(err);
    }
    Residency r;
    r.device = device;
    r.smem = smem;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.blocks, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return int(err);
    err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return int(err);
    kept = r;
  }
  out = kept;
  return 0;
}

// The persistent grid for n_atoms atoms: one block per `warps` atoms,
// at most the resident blocks of every SM (one per SM where the query
// gives none); 0 for no atoms.
long long grid_of(int n_atoms, int warps, const Residency& res) {
  const long long blocks = (static_cast<long long>(n_atoms) + warps - 1)
                           / warps;
  const long long resident = static_cast<long long>(
      res.blocks > 0 ? res.blocks : 1) * res.sms;
  return blocks < resident ? blocks : resident;
}

// Launch (occ == nullptr) or report the plan: occ = {atoms per block,
// shared bytes per block, resident blocks per SM, registers per thread,
// local (spill) bytes per thread, SMs, grid for a.n_atoms}.
template <typename T, int KMAX, bool ENERGY, bool TRI>
int run(const Args& a, int* occ) {
  constexpr int CAP = KMAX > 16 ? 16 : KMAX;
  Layout lay;
  lay.n_tab = (a.leg_l.n_int + a.leg_n.n_int) * kTab;
  lay.tab_n = a.leg_l.n_int * kTab;
  lay.g_off = int(round32(size_t(lay.n_tab) * sizeof(T)));
  lay.warp_off = lay.g_off
                 + int(round32(size_t(a.ww) * a.ww * a.cw * sizeof(T)));
  lay.hh_off = int(round32(KMAX * (13 * sizeof(T) + 2 * sizeof(int))));
  lay.tri_off = lay.hh_off
                + int(round32(size_t(CAP) * a.ww * a.cw * 2 * sizeof(T)));
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
  Residency res;
  int err = residency<T, KMAX, ENERGY, TRI>(smem, warps * kWarp, res);
  if (err != 0) return err;
  auto kernel = kernel_of<T, KMAX, ENERGY, TRI>();
  if (occ != nullptr) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return int(e);
    occ[0] = warps;
    occ[1] = int(smem);
    occ[2] = res.blocks;
    occ[3] = attr.numRegs;
    occ[4] = int(attr.localSizeBytes);
    occ[5] = res.sms;
    occ[6] = int(grid_of(a.n_atoms, warps, res));
    return 0;
  }
  const long long grid = grid_of(a.n_atoms, warps, res);
  if (grid == 0) return 0;
  kernel<<<unsigned(grid), warps * kWarp, smem,
           static_cast<cudaStream_t>(a.stream)>>>(
      static_cast<const T*>(a.d), static_cast<const T*>(a.valid),
      static_cast<const T*>(a.cweight), static_cast<const T*>(a.gwin),
      static_cast<const T*>(a.tables), static_cast<T*>(a.energy),
      static_cast<T*>(a.fc), static_cast<T*>(a.part), a.n_atoms, a.K,
      a.leg_l, a.leg_n, a.w_lo, a.ww, a.c_lo, a.cw, lay);
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
// lanes.  legs: (u0, 1/h, t_min, t_max) of the first legs, then of the
// third leg; ints: (kind, n_int) of the first legs, then of the third
// leg; tables: the first legs' (n_int, 20) Horner rows, then the third
// leg's.  The grid is persistent (see run()); no atoms launch nothing.
// Returns cudaGetLastError() after the launch (0 on success), or -1
// when one warp's shared memory for this K and window exceeds 227 KB.
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
// run for n_atoms atoms at these sizes and mode: out = {atoms per block,
// shared bytes per block, resident blocks per SM, registers per thread,
// local bytes per thread, SMs, grid (blocks launched)}.
extern "C" int uf3_trio_occupancy(int is_f64, int n_atoms, int K,
                                  const int* ints, int ww, int cw,
                                  int with_energy, int triangle, int* out) {
  const double legs[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, n_atoms, K, legs, ints,
                           0, ww, 0, cw, nullptr);
  return is_f64 ? dispatch<double>(a, with_energy, triangle, out)
                : dispatch<float>(a, with_energy, triangle, out);
}
