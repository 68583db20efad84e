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
// * Sizes at compile time (KMAX = 16 or 32 slots, energy or not),
//   generality at run time (any K <= KMAX, any window, the four knot
//   kinds, float32 and float64).
//
// The species-gated instance (GATED) runs one ordered trio type
// (s_c, s_m, s_n) of a multi-species model per launch: the reference's
// _trio_block_compute_multi, which it runs as XLA inside
// trio_forces_multi.  Against the unary instance:
// * two slot masks: row m owns H where its slot is valid and of species
//   s_m (the center's species s_c is checked first: a warp whose center
//   is another species exits at once), and the ballot that lists the n
//   of a row reads the slots valid and of species s_n;
// * a third leg table: row n's basis is the second leg's (its own spec,
//   range gate and interval), no longer row m's first-leg basis;
// * three windows (l, b, c): H = A.G over the l rows of the type's grid
//   window, for its b x c columns;
// * outputs are added to (energy, center force, partials), which the
//   caller zeroes once and sums over the types' launches.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;            // atoms per block at most
constexpr int kTab = 20;                // entries per interval row
constexpr size_t kSmemLimit = 232448;   // 227 KB opt-in per block, sm_90
constexpr int kErrSmem = -1;            // window too wide for one warp
constexpr unsigned kFull = 0xffffffffu;

struct Leg {
  int kind;       // 0 linear, 1 lammps r^2, 2 geometric, 3 inverse
  int n_int;      // number of intervals
  double u0;      // first knot in the transformed coordinate
  double inv_h;   // 1 / knot spacing in the transformed coordinate
  double t_min;   // inclusive range gate
  double t_max;
};

template <typename T>
struct alignas(4 * sizeof(T) > 16 ? 16 : 4 * sizeof(T)) Quad {
  T v[4];
};

template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T h, h1;  // H = A.G and H1 = dA.G at one (b, c) column of row m
};

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// Interval of r on a leg: floor((transform(r) - u0) / h), clamped to
// [0, n_int - 1].  r2 = r*r and inv_r = 1/r are the caller's.
template <typename T>
__device__ __forceinline__ int leg_interval(const Leg& s, T r, T r2,
                                            T inv_r) {
  T t;
  switch (s.kind) {
    case 0: t = r; break;
    case 1: t = r2; break;
    case 2: t = log(r); break;
    default: t = inv_r;
  }
  T f = floor((t - T(s.u0)) * T(s.inv_h));
  f = f > T(0) ? f : T(0);
  f = f < T(s.n_int - 1) ? f : T(s.n_int - 1);
  return int(f);
}

// Values and d/dr of the 4 non-zero basis functions B_{idx + q} at r,
// by Horner on interval idx's row of a leg table, times gate:
// B = sum_p beta[q][p] u^p, dB/dr = (dB/du) / (t_{idx+1} - t_idx).
template <typename T>
__device__ __forceinline__ void leg_basis(const T* tab, int idx, T r,
                                          T gate, T val[4], T der[4]) {
  const Quad<T>* row = reinterpret_cast<const Quad<T>*>(tab + idx * kTab);
  const Quad<T> head = row[0];
  const T u = (r - head.v[0]) * head.v[1];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Quad<T> b = row[1 + q];
    val[q] = gate * (((b.v[3] * u + b.v[2]) * u + b.v[1]) * u + b.v[0]);
    der[q] = gate * ((((T(3) * b.v[3]) * u + T(2) * b.v[2]) * u + b.v[1])
                     * head.v[1]);
  }
}

// The species of one ordered trio type (GATED instance).
struct Species {
  int c, m, n;
};

// Values of the 4 non-zero basis functions B_{idx + q} at r, times gate.
template <typename T>
__device__ __forceinline__ void leg_values(const T* tab, int idx, T r,
                                           T gate, T val[4]) {
  const Quad<T>* row = reinterpret_cast<const Quad<T>*>(tab + idx * kTab);
  const Quad<T> head = row[0];
  const T u = (r - head.v[0]) * head.v[1];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const Quad<T> b = row[1 + q];
    val[q] = gate * (((b.v[3] * u + b.v[2]) * u + b.v[1]) * u + b.v[0]);
  }
}

// Byte offsets of the dynamic shared memory: the leg tables and the
// grid window once per block, then one slice per warp.
struct Layout {
  int n_tab;       // table entries (all legs)
  int tab_b;       // first entry of the second leg's rows (GATED)
  int tab_n;       // first entry of the third leg's rows
  int g_off;       // the (Lw, Bw*Cw) grid window
  int warp_off;    // warp slices
  int hh_off;      // (H, H1) within a warp slice
  int warp_bytes;  // one warp slice
};

size_t round32(size_t bytes) { return (bytes + 31) & ~size_t(31); }

// One warp per atom (see the design above).  Unary instance: leg_b,
// b_lo, bw repeat leg_l, w_lo, ww, and s_slot, s_center, sp are unused.
#define TRIO_PARAMS                                                          \
  const T *__restrict__ d, const T *__restrict__ valid,                      \
      const long long *__restrict__ s_slot,                                  \
      const long long *__restrict__ s_center, const T *__restrict__ gwin,    \
      const T *__restrict__ tables, T *__restrict__ energy,                  \
      T *__restrict__ fc, T *__restrict__ part, int n_atoms, int K,          \
      Leg leg_l, Leg leg_b, Leg leg_n, int w_lo, int ww, int b_lo, int bw,   \
      int c_lo, int cw, Species sp, Layout lay
#define TRIO_ARGS                                                            \
  d, valid, s_slot, s_center, gwin, tables, energy, fc, part, n_atoms, K,    \
      leg_l, leg_b, leg_n, w_lo, ww, b_lo, bw, c_lo, cw, sp, lay

template <typename T, int KMAX, bool ENERGY, bool GATED>
__device__ __forceinline__ void trio_body(TRIO_PARAMS) {
  constexpr int TPR = kWarp / KMAX;  // threads per pair row
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem);
  T* s_g = reinterpret_cast<T*>(smem + lay.g_off);
  const int wc = bw * cw;  // columns of the grid window and of H
  for (int i = threadIdx.x; i < lay.n_tab; i += blockDim.x)
    s_tab[i] = tables[i];
  for (int i = threadIdx.x; i < ww * wc; i += blockDim.x) s_g[i] = gwin[i];
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long atom =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (atom >= n_atoms) return;  // ragged last block
  if (GATED && s_center[atom] != sp.c) return;  // no row of this type
  unsigned char* ws = smem + lay.warp_off + warp * lay.warp_bytes;
  Quad<T>* s_d = reinterpret_cast<Quad<T>*>(ws);  // (KMAX) x, y, z, -
  Quad<T>* s_a = s_d + KMAX;                      // first-leg values
  Quad<T>* s_da = s_a + KMAX;                     // and d/dr, 4 taps
  Quad<T>* s_b = GATED ? s_da + KMAX : s_a;       // second-leg values
  T* s_ir = reinterpret_cast<T*>(s_da + (GATED ? 2 : 1) * KMAX);  // 1/|d|
  int* s_idx = reinterpret_cast<int*>(s_ir + KMAX);  // first tap
  int* s_bidx = GATED ? s_idx + KMAX : s_idx;        // second leg's
  Pair<T>* s_hh = reinterpret_cast<Pair<T>*>(ws + lay.hh_off);
  // s_hh[col * KMAX + m], col = (b - b_lo) * Cw + (c - c_lo)

  const bool v_lane = lane < K && valid[atom * K + lane] != T(0);
  const long long s_lane = GATED && lane < K ? s_slot[atom * K + lane] : 0;
  const bool m_lane = v_lane && (!GATED || s_lane == sp.m);
  const bool n_lane = v_lane && (!GATED || s_lane == sp.n);
  const unsigned vmask = __ballot_sync(kFull, m_lane);  // rows m
  const unsigned nmask = GATED ? __ballot_sync(kFull, n_lane) : vmask;
  if (GATED && (vmask == 0u || nmask == 0u)) return;  // adds nothing
  const T* d_atom = d + atom * 3 * K;
  for (int i = lane; i < 3 * K; i += kWarp) {
    const int m = i / 3;
    s_d[m].v[i - 3 * m] = d_atom[i];
  }
  __syncwarp();

  // first-leg bases, one slot per lane
  if (lane < K) {
    const Quad<T> p = s_d[lane];
    T r2 = p.v[0] * p.v[0] + p.v[1] * p.v[1] + p.v[2] * p.v[2];
    r2 = r2 > T(0) ? r2 : T(1);
    const T inv_r = rsqrt_t(r2);
    const T r = r2 * inv_r;
    const T gate = (m_lane && r >= T(leg_l.t_min) && r <= T(leg_l.t_max))
                       ? T(1) : T(0);
    const int idx = leg_interval<T>(leg_l, r, r2, inv_r);
    Quad<T> a, da;
    leg_basis<T>(s_tab, idx, r, gate, a.v, da.v);
    s_a[lane] = a;
    s_da[lane] = da;
    s_ir[lane] = inv_r;
    s_idx[lane] = idx;
    if (GATED) {
      const T gate_b =
          (n_lane && r >= T(leg_b.t_min) && r <= T(leg_b.t_max)) ? T(1)
                                                                  : T(0);
      const int bidx = leg_interval<T>(leg_b, r, r2, inv_r);
      Quad<T> b;
      leg_values<T>(s_tab + lay.tab_b, bidx, r, gate_b, b.v);
      s_b[lane] = b;
      s_bidx[lane] = bidx;
    }
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

  // pair lanes of row m: this thread's share of the valid n != m
  const int m = lane % KMAX;
  const bool row_ok = m < K && ((vmask >> m) & 1u);
  unsigned mine = 0;
  if (row_ok) {
    unsigned bits = nmask & ~(1u << m);
    for (int j = 0; bits; bits &= bits - 1, ++j)
      if (j % TPR == lane / KMAX) mine |= bits & (0u - bits);
  }
  Quad<T> dm;
  dm.v[0] = dm.v[1] = dm.v[2] = dm.v[3] = T(0);
  if (row_ok) dm = s_d[m];
  const int cwk = cw * KMAX;
  T w = T(0), s3 = T(0), vx = T(0), vy = T(0), vz = T(0), e = T(0);
  while (mine) {
    const int n = __ffs(mine) - 1;
    mine &= mine - 1;
    const Quad<T> dn = s_d[n];
    const T dx = dn.v[0] - dm.v[0];
    const T dy = dn.v[1] - dm.v[1];
    const T dz = dn.v[2] - dm.v[2];
    const T rmn2 = dx * dx + dy * dy + dz * dz;
    if (!(rmn2 > T(1e-10))) continue;
    const T inv_r = rsqrt_t(rmn2);
    const T rmn = rmn2 * inv_r;
    if (!(rmn >= T(leg_n.t_min) && rmn <= T(leg_n.t_max))) continue;
    const int cidx = leg_interval<T>(leg_n, rmn, rmn2, inv_r);
    T cv[4], cdv[4];
    leg_basis<T>(s_tab + lay.tab_n, cidx, rmn, T(1), cv, cdv);
    int coff[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = cidx + q - c_lo;
      const bool in = c >= 0 && c < cw;
      cv[q] = in ? cv[q] : T(0);
      cdv[q] = in ? cdv[q] : T(0);
      coff[q] = (in ? c : 0) * KMAX + m;
    }
    const Quad<T> an = s_b[n];
    const int b0 = s_bidx[n] - b_lo;
    T t1 = T(0), t3 = T(0), value = T(0);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int b = b0 + p;
      if (b < 0 || b >= bw) continue;
      const Pair<T>* hb = s_hh + b * cwk;
      T db = T(0), d1b = T(0), d3b = T(0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const Pair<T> hh = hb[coff[q]];
        if (ENERGY) db = db + cv[q] * hh.h;
        d1b = d1b + cv[q] * hh.h1;
        d3b = d3b + cdv[q] * hh.h;
      }
      if (ENERGY) value = value + an.v[p] * db;
      t1 = t1 + an.v[p] * d1b;
      t3 = t3 + an.v[p] * d3b;
    }
    const T g3 = t3 * inv_r;
    w = w + t1;
    s3 = s3 + g3;
    vx = vx + g3 * dn.v[0];
    vy = vy + g3 * dn.v[1];
    vz = vz + g3 * dn.v[2];
    if (ENERGY) e = e + value;
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
  const bool head = lane < KMAX;
  if (head && m < K && (!GATED || row_ok)) {
    T* out = part + (atom * K + m) * 5;
    if (GATED) {
      out[0] += w;
      out[1] += s3;
      out[2] += vx;
      out[3] += vy;
      out[4] += vz;
    } else {
      out[0] = w;
      out[1] = s3;
      out[2] = vx;
      out[3] = vy;
      out[4] = vz;
    }
  }
  // center force sum_m w_m / r_m d_m and energy over the warp
  const T wr = head && row_ok ? w * s_ir[m] : T(0);
  T fx = wr * dm.v[0], fy = wr * dm.v[1], fz = wr * dm.v[2];
  e = head ? e : T(0);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    fx = fx + __shfl_xor_sync(kFull, fx, off);
    fy = fy + __shfl_xor_sync(kFull, fy, off);
    fz = fz + __shfl_xor_sync(kFull, fz, off);
    if (ENERGY) e = e + __shfl_xor_sync(kFull, e, off);
  }
  if (lane == 0) {
    if (GATED) {
      fc[atom * 3] += fx;
      fc[atom * 3 + 1] += fy;
      fc[atom * 3 + 2] += fz;
      if (ENERGY) energy[atom] += T(0.5) * e;
    } else {
      fc[atom * 3] = fx;
      fc[atom * 3 + 1] = fy;
      fc[atom * 3 + 2] = fz;
      energy[atom] = T(0.5) * e;
    }
  }
}

template <typename T, int KMAX, bool ENERGY>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
trio_kernel(TRIO_PARAMS) {
  trio_body<T, KMAX, ENERGY, false>(TRIO_ARGS);
}

// The gated instance names one resident block per SM as its minimum: at
// ptxas's default register budget its float64 KMAX = 16 no-energy
// instance spilled (80 registers); with it, none spills.
template <typename T, int KMAX, bool ENERGY>
__global__ void __launch_bounds__(kWarp * kMaxWarps, 1)
trio_gated_kernel(TRIO_PARAMS) {
  trio_body<T, KMAX, ENERGY, true>(TRIO_ARGS);
}

struct Args {
  const void* d;
  const void* valid;
  const void* s_slot;
  const void* s_center;
  const void* gwin;
  const void* tables;
  void* energy;
  void* fc;
  void* part;
  int n_atoms, K;
  Leg leg_l, leg_b, leg_n;
  int w_lo, ww, b_lo, bw, c_lo, cw;
  Species sp;
  void* stream;
};

// Launch (occ == nullptr) or report the plan: occ = {atoms per block,
// shared bytes per block, resident blocks per SM, registers per thread,
// local (spill) bytes per thread}.
template <typename T, int KMAX, bool ENERGY, bool GATED>
int run(const Args& a, int* occ) {
  Layout lay;
  lay.tab_b = a.leg_l.n_int * kTab;
  lay.tab_n = lay.tab_b + (GATED ? a.leg_b.n_int * kTab : 0);
  lay.n_tab = lay.tab_n + a.leg_n.n_int * kTab;
  lay.g_off = int(round32(size_t(lay.n_tab) * sizeof(T)));
  lay.warp_off = lay.g_off
                 + int(round32(size_t(a.ww) * a.bw * a.cw * sizeof(T)));
  // per slot: d, A, dA (+ the second leg's values) and 1/|d|; the taps
  lay.hh_off = int(round32(KMAX * ((GATED ? 17 : 13) * sizeof(T)
                                   + (GATED ? 2 : 1) * sizeof(int))));
  lay.warp_bytes = lay.hh_off
                   + int(round32(size_t(KMAX) * a.bw * a.cw * 2 * sizeof(T)));
  int warps = kMaxWarps;
  while (warps > 1
         && size_t(lay.warp_off) + size_t(warps) * lay.warp_bytes
                > kSmemLimit)
    --warps;
  const size_t smem = size_t(lay.warp_off) + size_t(warps) * lay.warp_bytes;
  if (smem > kSmemLimit) return kErrSmem;
  auto kernel = GATED ? trio_gated_kernel<T, KMAX, ENERGY>
                      : trio_kernel<T, KMAX, ENERGY>;
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
      static_cast<const long long*>(a.s_slot),
      static_cast<const long long*>(a.s_center),
      static_cast<const T*>(a.gwin), static_cast<const T*>(a.tables),
      static_cast<T*>(a.energy), static_cast<T*>(a.fc),
      static_cast<T*>(a.part), a.n_atoms, a.K, a.leg_l, a.leg_b, a.leg_n,
      a.w_lo, a.ww, a.b_lo, a.bw, a.c_lo, a.cw, a.sp, lay);
  return int(cudaGetLastError());
}

template <typename T, bool GATED>
int dispatch(const Args& a, int with_energy, int* occ) {
  if (a.K > 32) return int(cudaErrorInvalidValue);
  if (a.K <= 16)
    return with_energy ? run<T, 16, true, GATED>(a, occ)
                       : run<T, 16, false, GATED>(a, occ);
  return with_energy ? run<T, 32, true, GATED>(a, occ)
                     : run<T, 32, false, GATED>(a, occ);
}

Leg make_leg(const double* legs, const int* ints, int i) {
  return Leg{ints[2 * i], ints[2 * i + 1], legs[4 * i], legs[4 * i + 1],
             legs[4 * i + 2], legs[4 * i + 3]};
}

Args make_args(const void* d, const void* valid, const void* gwin,
               const void* tables, void* energy, void* fc, void* part,
               int n_atoms, int K, const double* legs, const int* ints,
               int w_lo, int ww, int c_lo, int cw, void* stream) {
  Args a;
  a.d = d;
  a.valid = valid;
  a.s_slot = nullptr;
  a.s_center = nullptr;
  a.gwin = gwin;
  a.tables = tables;
  a.energy = energy;
  a.fc = fc;
  a.part = part;
  a.n_atoms = n_atoms;
  a.K = K;
  a.leg_l = make_leg(legs, ints, 0);
  a.leg_b = a.leg_l;
  a.leg_n = make_leg(legs, ints, 1);
  a.w_lo = w_lo;
  a.ww = ww;
  a.b_lo = w_lo;
  a.bw = ww;
  a.c_lo = c_lo;
  a.cw = cw;
  a.sp = Species{0, 0, 0};
  a.stream = stream;
  return a;
}

// legs: (u0, 1/h, t_min, t_max) of the first, second and third legs;
// ints: (kind, n_int) of each; win: (l_lo, l_hi, b_lo, b_hi, c_lo, c_hi);
// species: (s_c, s_m, s_n).
Args make_multi_args(const void* d, const void* valid, const void* s_slot,
                     const void* s_center, const void* gwin,
                     const void* tables, void* energy, void* fc, void* part,
                     int n_atoms, int K, const double* legs, const int* ints,
                     const int* win, const int* species, void* stream) {
  Args a = make_args(d, valid, gwin, tables, energy, fc, part, n_atoms, K,
                     legs, ints, win[0], win[1] - win[0], win[4],
                     win[5] - win[4], stream);
  a.s_slot = s_slot;
  a.s_center = s_center;
  a.leg_b = make_leg(legs, ints, 1);
  a.leg_n = make_leg(legs, ints, 2);
  a.b_lo = win[2];
  a.bw = win[3] - win[2];
  a.sp = Species{species[0], species[1], species[2]};
  return a;
}

}  // namespace

// legs: (u0, 1/h, t_min, t_max) of the first legs, then of the third
// leg; ints: (kind, n_int) of the first legs, then of the third leg;
// tables: the first legs' (n_int, 20) Horner rows, then the third
// leg's.  Returns cudaGetLastError() after the launch (0 on success),
// or -1 when one warp's shared memory for this K and window exceeds
// 227 KB.
extern "C" int uf3_trio_partials_f32(
    const void* d, const void* valid, const void* gwin, const void* tables,
    void* energy, void* fc, void* part, int n_atoms, int K,
    const double* legs, const int* ints, int w_lo, int ww, int c_lo, int cw,
    int with_energy, void* stream) {
  return dispatch<float, false>(make_args(d, valid, gwin, tables, energy,
                                          fc, part, n_atoms, K, legs, ints,
                                          w_lo, ww, c_lo, cw, stream),
                                with_energy, nullptr);
}

extern "C" int uf3_trio_partials_f64(
    const void* d, const void* valid, const void* gwin, const void* tables,
    void* energy, void* fc, void* part, int n_atoms, int K,
    const double* legs, const int* ints, int w_lo, int ww, int c_lo, int cw,
    int with_energy, void* stream) {
  return dispatch<double, false>(make_args(d, valid, gwin, tables, energy,
                                           fc, part, n_atoms, K, legs, ints,
                                           w_lo, ww, c_lo, cw, stream),
                                 with_energy, nullptr);
}

// The launch plan of the kernel that uf3_trio_partials_{f32,f64} would
// run for these sizes: out = {atoms per block, shared bytes per block,
// resident blocks per SM, registers per thread, local bytes per thread}.
extern "C" int uf3_trio_occupancy(int is_f64, int K, const int* ints, int ww,
                                  int cw, int with_energy, int* out) {
  const double legs[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, 0, K, legs, ints, 0, ww, 0, cw,
                           nullptr);
  return is_f64 ? dispatch<double, false>(a, with_energy, out)
                : dispatch<float, false>(a, with_energy, out);
}

// The species-gated instance: one ordered trio type (s_c, s_m, s_n) per
// launch, its energy, center force and partials ADDED to energy, fc and
// part (zeroed by the caller once for all types).  s_slot (N, K) and
// s_center (N,) are int64 species ids; gwin is the type's (Lw, Bw*Cw)
// grid window; tables the three legs' Horner rows in order.  Same
// return codes as uf3_trio_partials_*.
extern "C" int uf3_trio_multi_partials_f32(
    const void* d, const void* valid, const void* s_slot,
    const void* s_center, const void* gwin, const void* tables,
    void* energy, void* fc, void* part, int n_atoms, int K,
    const double* legs, const int* ints, const int* win, const int* species,
    int with_energy, void* stream) {
  return dispatch<float, true>(
      make_multi_args(d, valid, s_slot, s_center, gwin, tables, energy, fc,
                      part, n_atoms, K, legs, ints, win, species, stream),
      with_energy, nullptr);
}

extern "C" int uf3_trio_multi_partials_f64(
    const void* d, const void* valid, const void* s_slot,
    const void* s_center, const void* gwin, const void* tables,
    void* energy, void* fc, void* part, int n_atoms, int K,
    const double* legs, const int* ints, const int* win, const int* species,
    int with_energy, void* stream) {
  return dispatch<double, true>(
      make_multi_args(d, valid, s_slot, s_center, gwin, tables, energy, fc,
                      part, n_atoms, K, legs, ints, win, species, stream),
      with_energy, nullptr);
}

// The launch plan of the species-gated instance (as uf3_trio_occupancy).
extern "C" int uf3_trio_multi_occupancy(int is_f64, int K, const int* ints,
                                        const int* win, int with_energy,
                                        int* out) {
  const double legs[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  const int species[3] = {0, 0, 0};
  const Args a = make_multi_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, 0, K,
                                 legs, ints, win, species, nullptr);
  return is_f64 ? dispatch<double, true>(a, with_energy, out)
                : dispatch<float, true>(a, with_energy, out);
}
