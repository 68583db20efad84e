// The multi-species 3-body pass of the UF3 potential in one launch: per
// center atom, energy, center force and the slot partials S1, S3', V3'
// that the reverse-slot assembly gathers into neighbor forces, summed
// over every ordered trio type (s_c, s_m, s_n) of the model.
//
// Replaces _trio_block_compute_multi (uf3_tpu/ops/pallas_trio.py:1337),
// which the reference runs as XLA inside trio_forces_multi (:1438): the
// distances and pair-lane masks shared across types, each type adding
// its species-gated terms in the same block body.  Lane roles as in
// trio.cu: pair lane (m, n) takes its third leg d[n] - d[m], H from row
// m and the second-leg basis from row n.
//
// What bounds it on the card: issued instructions and their latency.  On
// the 8,788-atom Ne/Xe cell (24 slots, 18 of them live, 8 ordered types)
// the pass needs 2.349e8 flop over the types' live lanes against 9.5e6
// bytes: 3.5 us at the float32 rate against 2.8 us at the memory rate,
// and each live pair lane is one dependent chain (rsqrt, interval,
// Horner for 4 values and 4 derivatives, then up to 4 x 4 (b, c) terms
// read from H in shared memory).  So the design keeps every live lane of
// an atom in one launch, all 32 threads of a warp on live lanes, and
// enough warps on an SM to hide the chains:
// * One warp per center atom, up to eight atoms per block, its species
//   s_c read once.  A pair lane takes its ordered type from
//   type_of[s_c][s_m][s_n] in shared memory; -1 (the model has no such
//   type) adds nothing, as the reference's loop over descs adds nothing.
//   Every type runs the same code on other table addresses.
// * Rows by live rank, not by slot: a warp ballot over `valid` gives the
//   live slots (any mask) and their ranks; row r of a sub-pass is the
//   (base + r)-th live slot.  A sub-pass takes at most 16 live rows, R of
//   them rounded up to a power of two, each served by 32 / R threads
//   (lane = h * R + r) that split the row's live partners of each
//   species in rank order and combine with __shfl_xor_sync over offsets
//   R .. 16.  The route's 18-live K = 24 lists run 16 rows x 2 threads,
//   then 2 rows x 16 threads (by slot, 18 of 32 threads had work and
//   each walked its partners alone).
// * The species passes inside the sub-pass.  Each ordered type has its
//   own leg knots, so a slot's bases depend on the other leg's species:
//   as row n, a slot stages the second-leg basis of (s_c, s, s_n) for
//   every species s of row m, once per atom; in pass s of a sub-pass,
//   each of its rows stages the first-leg basis of (s_c, s_m, s) and H
//   = A.G over that type's grid window, then its lanes (m, n) with n of
//   species s run.  A thread's row stays the same over the passes, so
//   its sums w, s3, v stay in registers and its partial row is written
//   once, after the last pass; a pass with no slot of its species, or
//   no row with a type in it, is skipped whole.
// * H holds 16 rows (hh[col * 16 + r]) and is staged for the sub-pass's
//   rows only, so a KMAX = 32 warp's slice holds half the H it did by
//   slot.  Dead slots' partial rows are written as zeros.
// * The per-type metadata is packed once, at construction (ops/multi.py
//   pack_trio_multi): type_of, and per type the three legs (kind,
//   n_int, table offset; u0, 1/h, t_min, t_max), the window and the
//   grid offset; each distinct leg table once, the grid windows end to
//   end.  A block stages them into shared memory with cp.async.bulk on
//   one mbarrier, while its warps load their first atom's rows; a copy
//   that never lands traps.  Tables or grids too large to sit beside
//   eight warps' slices stay in device memory (read through L1); a
//   window too wide for one warp's slice returns -1, as in trio.cu.
// * Registers: the float32 instances are held to 64 registers (32 warps
//   per SM) by their launch bounds; float64 keeps ptxas's own count; no
//   instance spills.  What that took: the atom index in 32 bits, and
//   with energy each lane's (b, c) terms summed one by one; the tables
//   and grids addressed as shared memory by an instance of their own
//   spilled more, not less (8-16 bytes).
// * Fixed sums: a row's threads add their lanes in rank order and
//   combine in a fixed shuffle order, the center force sums the slots'
//   w in a fixed tree, with no atomics, so the bits do not vary between
//   runs.
// * No tensor cores: a lane contracts at most 4 x 4 (b, c) terms of H,
//   and H per row is (<= 4 taps) x (Bw Cw) columns, far below a wgmma
//   tile; in float32 a tensor core would mean TF32, which the port keeps
//   out of every grid contraction.  All arithmetic is plain FMA in the
//   working type, with trio.cu's division-free legs (Horner, rsqrt).
// * Sizes at compile time (KMAX = 16 or 32 slots, energy or not),
//   generality at run time (any K <= KMAX, any number of species and
//   types, any windows, the four knot kinds, float32 and float64).
//   Every output is written once; the caller zeroes nothing.
//
// Measured (PERF.md section 6: benchmarks/kernel_variants.py on the
// patches in benchmarks_data/artifacts_torch/kernel_variants/; float32
// without energy on the 8,788-atom binary K = 24 rows and the 4,000-atom
// ternary rows, float64 with energy on the calculator's K = 18 rows; on
// the H100): live-rank rows with H for 32 rows gained 1-2% in float32
// (18 live rows, one thread each) and 31% in float64 (at most 16 live
// rows there); the 16-row H took float32 from 0.0855 to 0.0678 ms
// (binary) and 0.0533 to 0.0447 (ternary); the 64-register bound from
// 24 to 32 warps per SM, 0.0655 and 0.0423 (the kernel by slot:
// 0.0868, 0.0544, 0.1063 float64; now 0.0736).  Left out: a persistent grid
// (resident blocks x SMs, each warp walking atoms with a grid stride,
// the metadata staged once per resident block) was slower everywhere:
// at 64 registers it spills (0.0693, 0.0447), at 80 registers 24 warps
// per SM (0.0688, 0.0499), and in float64 it needs 144 registers, 8
// warps per SM (0.0952).
//
// The unary pass is its own kernel (trio.cu); the helpers both use are in
// trio_common.cuh.

#include "trio_common.cuh"

namespace {

// Rows of H a sub-pass stages: the live rows by rank it takes at most.
constexpr int kCap = 16;

// One type's record in the int metadata, after the (S, S, S) type_of
// table: per leg (first, second, third) kind, n_int and the entry
// offset of its Horner rows in the tables; the window (l_lo, Lw, b_lo,
// Bw, c_lo, Cw); the entry offset of its (Lw, Bw*Cw) grid window.
constexpr int kRec = 16;
enum { kLeg1 = 0, kLeg2 = 3, kLeg3 = 6, kLLo = 9, kLW, kBLo, kBW, kCLo, kCW,
       kGOff };
// One type's reals: (u0, 1/h, t_min, t_max) of the three legs.
constexpr int kReal = 12;

template <typename T>
struct LegT {
  int kind, n_int;
  T u0, inv_h, t_min, t_max;
};

// Leg j (0, 1, 2) of a type from its record and reals.
template <typename T>
__device__ __forceinline__ LegT<T> type_leg(const int* rec, const T* re,
                                            int j) {
  return LegT<T>{rec[3 * j], rec[3 * j + 1], re[4 * j], re[4 * j + 1],
                 re[4 * j + 2], re[4 * j + 3]};
}

// The ordered type of (s_c, s_m, s_n), or -1 (no such type, or a species
// id outside [0, S)).
__device__ __forceinline__ int type_at(const int* type_of, int S, int c,
                                       int m, int n) {
  return (unsigned(c) < unsigned(S) && unsigned(m) < unsigned(S)
          && unsigned(n) < unsigned(S))
             ? type_of[(c * S + m) * S + n]
             : -1;
}

// The least power of two >= p (1 for p <= 1).
__device__ __forceinline__ int pow2_ceil(int p) {
  return p <= 1 ? 1 : 1 << (32 - __clz(p - 1));
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// Asynchronous bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) from device to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait for the phase; a copy that has not landed after ~2e9 cycles
// (~1 s) traps, so that a fault ends the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  const long long start = clock64();
  unsigned done = 0;
  do {
    if (clock64() - start > 2000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// Kernel operands and the shared-memory plan (byte offsets).
template <typename T>
struct MultiParams {
  const T* d;                 // (N, K, 3)
  const T* valid;             // (N, K)
  const long long* s_slot;    // (N, K) species of each slot
  const long long* s_center;  // (N,)
  const int* ints;            // type_of, then the type records
  const T* reals;             // per type the legs' reals
  const T* tables;            // distinct legs' Horner rows
  const T* grids;             // the types' grid windows
  T* energy;                  // (N,)
  T* fc;                      // (N, 3)
  T* part;                    // (N, K, 5)
  int n_atoms, K, S, max_cols;
  // elements of each metadata buffer, each a multiple of 4 (so that its
  // bytes are a multiple of 16, as cp.async.bulk needs)
  int n_ints, n_reals, n_tables, n_grids;
  int stage_tables, stage_grids;  // copied into shared memory, or not
  int ints_off, reals_off, tab_off, grid_off, warp_off;
  int hh_off, warp_bytes;         // (H, H1) within a warp slice; a slice
};

// One atom's rows in registers, lane-strided as they are read.
template <typename T, int KMAX>
struct Rows {
  T d[(3 * KMAX + kWarp - 1) / kWarp];
  T valid;
  int s_slot, s_center;
};

template <typename T, int KMAX>
__device__ __forceinline__ void load_rows(const MultiParams<T>& p,
                                          long long atom, int lane,
                                          Rows<T, KMAX>& rows) {
  if (atom >= p.n_atoms) return;
  const int K = p.K;
  const T* d_atom = p.d + atom * 3 * K;
#pragma unroll
  for (int j = 0; j < (3 * KMAX + kWarp - 1) / kWarp; ++j) {
    const int i = lane + j * kWarp;
    rows.d[j] = i < 3 * K ? d_atom[i] : T(0);
  }
  rows.valid = lane < K ? p.valid[atom * K + lane] : T(0);
  rows.s_slot = lane < K ? int(p.s_slot[atom * K + lane]) : -1;
  rows.s_center = int(p.s_center[atom]);
}

// The metadata as the block staged it.
template <typename T>
struct Meta {
  const int* type_of;  // (S, S, S)
  const int* recs;     // kRec ints per type
  const T* reals;      // kReal reals per type
  const T* tables;     // shared memory or device memory
  const T* grids;
};

// The pointers of one warp's slice: first the arrays of fixed size (at
// offsets known at compile time), then the S species' second-leg bases,
// then H.
template <typename T, int KMAX, int CAP>
struct Slice {
  // bytes of the fixed arrays (a multiple of 16, as the Quads need)
  static constexpr int kFixed =
      ((KMAX + 2 * CAP) * int(sizeof(Quad<T>)) + 2 * KMAX * int(sizeof(T))
       + (2 * KMAX + 2 * CAP) * int(sizeof(int)) + 15) / 16 * 16;
  Quad<T>* d;      // (KMAX) x, y, z, -
  Quad<T>* a;      // (CAP) this pass's first-leg values by rank
  Quad<T>* da;     // and d/dr, 4 taps
  T* ir;           // (KMAX) 1 / |d|
  T* w;            // (KMAX) each live slot's w
  int* sp;         // (KMAX) species of each slot
  int* live;       // (KMAX) the live slots by rank
  int* idx;        // (CAP) first-leg tap by rank
  int* t;          // (CAP) this pass's type by rank, or -1
  Quad<T>* b;      // (S, KMAX) second-leg values, per species of row m
  int* bidx;       // (S, KMAX) second-leg first tap
  Pair<T>* hh;     // hh[col * CAP + r], col = (b - b_lo) * Cw + (c - c_lo)
  __device__ Slice(unsigned char* ws, int S, int hh_off) {
    d = reinterpret_cast<Quad<T>*>(ws);
    a = d + KMAX;
    da = a + CAP;
    ir = reinterpret_cast<T*>(da + CAP);
    w = ir + KMAX;
    sp = reinterpret_cast<int*>(w + KMAX);
    live = sp + KMAX;
    idx = live + KMAX;
    t = idx + CAP;
    b = reinterpret_cast<Quad<T>*>(ws + kFixed);
    bidx = reinterpret_cast<int*>(b + S * KMAX);
    hh = reinterpret_cast<Pair<T>*>(ws + hh_off);
  }
  // bytes before H
  static size_t head_bytes(int S) {
    return round32(size_t(kFixed)
                   + size_t(S) * KMAX * (sizeof(Quad<T>) + sizeof(int)));
  }
};

// The sums of row r's lanes (m, n) in one species pass: this thread's
// share (every tpr-th partner in rank order, from h) of row m's valid
// partners n != m in `nmask`, all of type t.
template <typename T, int KMAX, int CAP, bool ENERGY>
__device__ __forceinline__ void row_lanes(
    const Slice<T, KMAX, CAP>& s, const Meta<T>& meta, int t, int r, int m,
    int s_row, unsigned nmask, int h, int tpr, T& w, T& s3, T& vx, T& vy,
    T& vz, T& e) {
  const int* rec = meta.recs + t * kRec;
  const LegT<T> leg_n = type_leg<T>(rec, meta.reals + t * kReal, 2);
  const T* tab_n = meta.tables + rec[kLeg3 + 2];
  const int b_lo = rec[kBLo], bw = rec[kBW];
  const int c_lo = rec[kCLo], cw = rec[kCW];
  const int cwk = cw * CAP;
  const Quad<T>* s_bm = s.b + s_row * KMAX;  // under row m's species
  const int* s_bidxm = s.bidx + s_row * KMAX;
  unsigned mine = 0;
  unsigned bits = nmask & ~(1u << m);
  for (int j = 0; bits; bits &= bits - 1, ++j)
    if ((j & (tpr - 1)) == h) mine |= bits & (0u - bits);
  const Quad<T> dm = s.d[m];
  while (mine) {
    const int n = __ffs(mine) - 1;
    mine &= mine - 1;
    const Quad<T> dn = s.d[n];
    const T dx = dn.v[0] - dm.v[0];
    const T dy = dn.v[1] - dm.v[1];
    const T dz = dn.v[2] - dm.v[2];
    const T rmn2 = dx * dx + dy * dy + dz * dz;
    if (!(rmn2 > T(1e-10))) continue;
    const T inv_rmn = rsqrt_t(rmn2);
    const T rmn = rmn2 * inv_rmn;
    if (!(rmn >= leg_n.t_min && rmn <= leg_n.t_max)) continue;
    const int cidx = leg_interval<T>(leg_n, rmn, rmn2, inv_rmn);
    T cv[4], cdv[4];
    leg_basis<T>(tab_n, cidx, rmn, T(1), cv, cdv);
    int coff[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = cidx + q - c_lo;
      const bool in = c >= 0 && c < cw;
      cv[q] = in ? cv[q] : T(0);
      cdv[q] = in ? cdv[q] : T(0);
      coff[q] = (in ? c : 0) * CAP + r;
    }
    const Quad<T> an = s_bm[n];
    const int b0 = s_bidxm[n] - b_lo;
    T t1 = T(0), t3 = T(0), value = T(0);
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      const int b = b0 + pp;
      if (b < 0 || b >= bw) continue;
      const Pair<T>* hb = s.hh + b * cwk;
      if (ENERGY) {
        // term by term, without the per-b sums: at 64 registers the
        // per-b sums spilled in this instance
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const Pair<T> hh = hb[coff[q]];
          const T ac = an.v[pp] * cv[q];
          value = value + ac * hh.h;
          t1 = t1 + ac * hh.h1;
          t3 = t3 + (an.v[pp] * cdv[q]) * hh.h;
        }
      } else {
        T d1b = T(0), d3b = T(0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const Pair<T> hh = hb[coff[q]];
          d1b = d1b + cv[q] * hh.h1;
          d3b = d3b + cdv[q] * hh.h;
        }
        t1 = t1 + an.v[pp] * d1b;
        t3 = t3 + an.v[pp] * d3b;
      }
    }
    const T g3 = t3 * inv_rmn;
    w = w + t1;
    s3 = s3 + g3;
    vx = vx + g3 * dn.v[0];
    vy = vy + g3 * dn.v[1];
    vz = vz + g3 * dn.v[2];
    if (ENERGY) e = e + value;
  }
}

// One atom on one warp (see the design above).
template <typename T, int KMAX, int CAP, bool ENERGY>
__device__ __forceinline__ void multi_atom(const MultiParams<T>& p,
                                           const Meta<T>& meta,
                                           const Slice<T, KMAX, CAP>& s,
                                           int atom, int lane,
                                           const Rows<T, KMAX>& cur) {
  const int K = p.K, S = p.S;
  // this atom's rows into shared memory
#pragma unroll
  for (int j = 0; j < (3 * KMAX + kWarp - 1) / kWarp; ++j) {
    const int i = lane + j * kWarp;
    if (i < 3 * K) {
      const int slot = i / 3;
      s.d[slot].v[i - 3 * slot] = cur.d[j];
    }
  }
  const bool v_lane = lane < K && cur.valid != T(0);
  const int s_lane = cur.s_slot;
  const int s_c = cur.s_center;
  const unsigned vmask = __ballot_sync(kFull, v_lane);
  const int P = __popc(vmask);
  if (v_lane) s.live[__popc(vmask & ((1u << lane) - 1u))] = lane;
  __syncwarp();

  // per slot: 1/|d|, its species, and as row n the second-leg basis of
  // (s_c, s, s_n) for every species s of row m; a dead slot's partial
  // row: zeros
  if (lane < K) {
    const Quad<T> q = s.d[lane];
    T r2 = q.v[0] * q.v[0] + q.v[1] * q.v[1] + q.v[2] * q.v[2];
    r2 = r2 > T(0) ? r2 : T(1);
    const T inv_r = rsqrt_t(r2);
    const T r = r2 * inv_r;
    s.ir[lane] = inv_r;
    s.sp[lane] = s_lane;
    for (int sm = 0; sm < S; ++sm) {
      const int t = v_lane ? type_at(meta.type_of, S, s_c, sm, s_lane) : -1;
      Quad<T> b;
      b.v[0] = b.v[1] = b.v[2] = b.v[3] = T(0);
      int bidx = 0;
      if (t >= 0) {
        const int* rec = meta.recs + t * kRec;
        const LegT<T> leg = type_leg<T>(rec, meta.reals + t * kReal, 1);
        const T gate = (r >= leg.t_min && r <= leg.t_max) ? T(1) : T(0);
        bidx = leg_interval<T>(leg, r, r2, inv_r);
        leg_values<T>(meta.tables + rec[kLeg2 + 2], bidx, r, gate, b.v);
      }
      s.b[sm * KMAX + lane] = b;
      s.bidx[sm * KMAX + lane] = bidx;
    }
    if (!v_lane) {
      T* out = p.part + (static_cast<long long>(atom) * K + lane) * 5;
#pragma unroll
      for (int c = 0; c < 5; ++c) out[c] = T(0);
    }
  }
  __syncwarp();

  T e = T(0);
  // sub-passes of at most CAP live rows (one when P <= CAP)
  for (int base = 0; base < P; base += CAP) {
    const int np = min(P - base, CAP);
    const int R = pow2_ceil(np);
    const int lg = __ffs(R) - 1;
    // row r of the sub-pass: slot m = live[base + r], served by the
    // threads lane = h * R + r; lane j < np also stages row j
    const int r = lane & (R - 1);
    const int h = lane >> lg;
    const int tpr = kWarp >> lg;
    const bool row_ok = r < np;
    const int m = row_ok ? s.live[base + r] : 0;
    const int s_row = s.sp[m];
    T w = T(0), s3 = T(0), vx = T(0), vy = T(0), vz = T(0);
    for (int sn = 0; sn < S; ++sn) {
      const unsigned nmask = __ballot_sync(kFull, v_lane && s_lane == sn);
      if (nmask == 0u) continue;  // no row n of this species
      // row j = lane: the first-leg basis of (s_c, s_m, sn)
      int t_j = -1;
      if (lane < np) {
        const int mj = s.live[base + lane];
        t_j = type_at(meta.type_of, S, s_c, s.sp[mj], sn);
        Quad<T> a, da;
        a.v[0] = a.v[1] = a.v[2] = a.v[3] = T(0);
        da = a;
        int idx = 0;
        if (t_j >= 0) {
          const Quad<T> q = s.d[mj];
          T r2 = q.v[0] * q.v[0] + q.v[1] * q.v[1] + q.v[2] * q.v[2];
          r2 = r2 > T(0) ? r2 : T(1);
          const T inv_r = s.ir[mj];
          const T rj = r2 * inv_r;
          const int* rec = meta.recs + t_j * kRec;
          const LegT<T> leg = type_leg<T>(rec, meta.reals + t_j * kReal, 0);
          const T gate = (rj >= leg.t_min && rj <= leg.t_max) ? T(1) : T(0);
          idx = leg_interval<T>(leg, rj, r2, inv_r);
          leg_basis<T>(meta.tables + rec[kLeg1 + 2], idx, rj, gate, a.v,
                       da.v);
        }
        s.a[lane] = a;
        s.da[lane] = da;
        s.idx[lane] = idx;
        s.t[lane] = t_j;
      }
      const unsigned tmask = __ballot_sync(kFull, t_j >= 0);  // rows
      if (tmask == 0u) continue;
      __syncwarp();

      // H[r, col] = sum_l A[r, l] G[l, col] over the <= 4 taps of row
      // r, on row r's type's window
      for (int i = lane; i < R * p.max_cols; i += kWarp) {
        const int rr = i & (R - 1);
        if (!((tmask >> rr) & 1u)) continue;
        const int* rec = meta.recs + s.t[rr] * kRec;
        const int cols = rec[kBW] * rec[kCW];
        const int col = i >> lg;
        if (col >= cols) continue;
        const T* g = meta.grids + rec[kGOff];
        const int lw = rec[kLW];
        const int l0 = s.idx[rr] - rec[kLLo];
        const Quad<T> a = s.a[rr], da = s.da[rr];
        T hv = T(0), h1 = T(0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int l = l0 + q;
          if (l >= 0 && l < lw) {
            const T gv = g[l * cols + col];
            hv = hv + a.v[q] * gv;
            h1 = h1 + da.v[q] * gv;
          }
        }
        s.hh[col * CAP + rr] = Pair<T>{hv, h1};
      }
      __syncwarp();

      if (row_ok && ((tmask >> r) & 1u))
        row_lanes<T, KMAX, CAP, ENERGY>(s, meta, s.t[r], r, m, s_row, nmask,
                                        h, tpr, w, s3, vx, vy, vz, e);
      __syncwarp();  // before the next pass restages A and H
    }
    for (int off = R; off < kWarp; off <<= 1) {
      w = w + __shfl_xor_sync(kFull, w, off);
      s3 = s3 + __shfl_xor_sync(kFull, s3, off);
      vx = vx + __shfl_xor_sync(kFull, vx, off);
      vy = vy + __shfl_xor_sync(kFull, vy, off);
      vz = vz + __shfl_xor_sync(kFull, vz, off);
    }
    if (row_ok && h == 0) {
      T* out = p.part + (static_cast<long long>(atom) * K + m) * 5;
      out[0] = w;
      out[1] = s3;
      out[2] = vx;
      out[3] = vy;
      out[4] = vz;
      s.w[m] = w;
    }
  }
  __syncwarp();

  // center force sum_m w_m / r_m d_m over the live slots, and energy
  T fx = T(0), fy = T(0), fz = T(0);
  if (v_lane) {
    const T wr = s.w[lane] * s.ir[lane];
    const Quad<T> dm = s.d[lane];
    fx = wr * dm.v[0];
    fy = wr * dm.v[1];
    fz = wr * dm.v[2];
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    fx = fx + __shfl_xor_sync(kFull, fx, off);
    fy = fy + __shfl_xor_sync(kFull, fy, off);
    fz = fz + __shfl_xor_sync(kFull, fz, off);
    if (ENERGY) e = e + __shfl_xor_sync(kFull, e, off);
  }
  if (lane == 0) {
    p.fc[atom * 3] = fx;
    p.fc[atom * 3 + 1] = fy;
    p.fc[atom * 3 + 2] = fz;
    p.energy[atom] = T(0.5) * e;
  }
}

// One warp per atom, up to eight atoms a block (see the design above).
// The minimum of resident blocks per SM asked of ptxas: 4 in float32
// (at most 64 registers, 32 warps per SM), 1 in float64 (ptxas's own
// count).
template <typename T, int KMAX, bool ENERGY>
__global__ void __launch_bounds__(kWarp * kMaxWarps, sizeof(T) == 4 ? 4 : 1)
trio_multi_kernel(const MultiParams<T> p) {
  constexpr int CAP = KMAX > kCap ? kCap : KMAX;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int atom = int(blockIdx.x) * (blockDim.x / kWarp) + warp;

  // the metadata, tables and grids, once per block, by bulk copy
  const unsigned bar = smem_u32(smem);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned b_ints = unsigned(p.n_ints) * sizeof(int);
    const unsigned b_reals = unsigned(p.n_reals) * sizeof(T);
    const unsigned b_tab = p.stage_tables ? p.n_tables * sizeof(T) : 0u;
    const unsigned b_grid = p.stage_grids ? p.n_grids * sizeof(T) : 0u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(b_ints + b_reals + b_tab + b_grid)
                 : "memory");
    bulk_copy(smem + p.ints_off, p.ints, b_ints, bar);
    if (b_reals) bulk_copy(smem + p.reals_off, p.reals, b_reals, bar);
    if (b_tab) bulk_copy(smem + p.tab_off, p.tables, b_tab, bar);
    if (b_grid) bulk_copy(smem + p.grid_off, p.grids, b_grid, bar);
  }
  Rows<T, KMAX> cur{};
  load_rows<T, KMAX>(p, atom, lane, cur);  // overlaps the copies
  mbar_wait(bar, 0);
  if (atom >= p.n_atoms) return;

  Meta<T> meta;
  meta.type_of = reinterpret_cast<const int*>(smem + p.ints_off);
  meta.recs = meta.type_of + p.S * p.S * p.S;
  meta.reals = reinterpret_cast<const T*>(smem + p.reals_off);
  meta.tables = p.stage_tables
                    ? reinterpret_cast<const T*>(smem + p.tab_off)
                    : p.tables;
  meta.grids = p.stage_grids
                   ? reinterpret_cast<const T*>(smem + p.grid_off)
                   : p.grids;
  const Slice<T, KMAX, CAP> s(smem + p.warp_off + warp * p.warp_bytes, p.S,
                              p.hh_off);
  multi_atom<T, KMAX, CAP, ENERGY>(p, meta, s, atom, lane, cur);
}

struct MultiArgs {
  const void* d;
  const void* valid;
  const void* s_slot;
  const void* s_center;
  const void* ints;
  const void* reals;
  const void* tables;
  const void* grids;
  void* energy;
  void* fc;
  void* part;
  int n_atoms, K, S, max_cols, n_ints, n_reals, n_tables, n_grids;
  void* stream;
};

// The shared-memory plan: the mbarrier, the int metadata and the reals
// always; the tables and the grids, or the tables only, where that
// leaves room for kMaxWarps warp slices, else neither and as many warps
// as fit.  Returns kErrSmem when not even one warp's slice fits.
template <typename T, int KMAX>
int multi_plan(const MultiArgs& a, MultiParams<T>& p, int* warps_out,
               size_t* smem_out) {
  constexpr int CAP = KMAX > kCap ? kCap : KMAX;
  p.ints_off = 16;
  p.reals_off = p.ints_off + int(round32(size_t(a.n_ints) * sizeof(int)));
  const size_t fixed = p.reals_off + round32(size_t(a.n_reals) * sizeof(T));
  const size_t tab_b = round32(size_t(a.n_tables) * sizeof(T));
  const size_t grid_b = round32(size_t(a.n_grids) * sizeof(T));
  // the slice's arrays (Slice), then H for CAP rows
  p.hh_off = int(Slice<T, KMAX, CAP>::head_bytes(a.S));
  p.warp_bytes = p.hh_off + int(round32(size_t(CAP) * a.max_cols * 2
                                        * sizeof(T)));
  const size_t staged[3][2] = {{tab_b, grid_b}, {tab_b, 0}, {0, 0}};
  int choice = 2, warps = 0;
  for (int c = 0; c < 3; ++c) {
    const size_t base = fixed + staged[c][0] + staged[c][1];
    int w = kMaxWarps;
    while (w > 0 && base + size_t(w) * p.warp_bytes > kSmemLimit) --w;
    if (w == kMaxWarps || c == 2) {
      choice = c;
      warps = w;
      break;
    }
  }
  if (warps == 0) return kErrSmem;
  p.stage_tables = choice < 2;
  p.stage_grids = choice == 0;
  p.tab_off = int(fixed);
  p.grid_off = p.tab_off + int(p.stage_tables ? tab_b : 0);
  p.warp_off = p.grid_off + int(p.stage_grids ? grid_b : 0);
  *warps_out = warps;
  *smem_out = size_t(p.warp_off) + size_t(warps) * p.warp_bytes;
  p.d = static_cast<const T*>(a.d);
  p.valid = static_cast<const T*>(a.valid);
  p.s_slot = static_cast<const long long*>(a.s_slot);
  p.s_center = static_cast<const long long*>(a.s_center);
  p.ints = static_cast<const int*>(a.ints);
  p.reals = static_cast<const T*>(a.reals);
  p.tables = static_cast<const T*>(a.tables);
  p.grids = static_cast<const T*>(a.grids);
  p.energy = static_cast<T*>(a.energy);
  p.fc = static_cast<T*>(a.fc);
  p.part = static_cast<T*>(a.part);
  p.n_atoms = a.n_atoms;
  p.K = a.K;
  p.S = a.S;
  p.max_cols = a.max_cols;
  p.n_ints = a.n_ints;
  p.n_reals = a.n_reals;
  p.n_tables = a.n_tables;
  p.n_grids = a.n_grids;
  return 0;
}

constexpr int kMaxDevices = 16;

// Launch (occ == nullptr) or report the plan: occ = {atoms (warps) per
// block, shared bytes per block, resident blocks per SM, registers per
// thread, local (spill) bytes per thread, tables staged, grids staged,
// blocks launched for a.n_atoms, SMs}.  The dynamic shared-memory limit
// and the resident blocks are asked of the runtime once per instance,
// device and size, not at every launch.
template <typename T, int KMAX, bool ENERGY>
int run_multi(const MultiArgs& a, int* occ) {
  MultiParams<T> p;
  int warps = 0;
  size_t smem = 0;
  int err = multi_plan<T, KMAX>(a, p, &warps, &smem);
  if (err != 0) return err;
  auto kernel = trio_multi_kernel<T, KMAX, ENERGY>;
  static int attr_smem[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  static int occ_key[kMaxDevices][2] = {};
  static int occ_blocks[kMaxDevices] = {};
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr != cudaSuccess) return int(cerr);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && int(smem) > attr_smem[dev]) {
    cerr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (cerr != cudaSuccess) return int(cerr);
    attr_smem[dev] = int(smem);
  }
  if (sms[dev] == 0) {
    cerr = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                  dev);
    if (cerr != cudaSuccess) return int(cerr);
  }
  if (occ_key[dev][0] != int(smem) || occ_key[dev][1] != warps) {
    int blocks = 0;
    cerr = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, warps * kWarp, smem);
    if (cerr != cudaSuccess) return int(cerr);
    occ_key[dev][0] = int(smem);
    occ_key[dev][1] = warps;
    occ_blocks[dev] = blocks > 0 ? blocks : 1;
  }
  const long long grid = (static_cast<long long>(a.n_atoms) + warps - 1)
                         / warps;
  if (occ != nullptr) {
    cudaFuncAttributes attr;
    cerr = cudaFuncGetAttributes(&attr, kernel);
    if (cerr != cudaSuccess) return int(cerr);
    occ[0] = warps;
    occ[1] = int(smem);
    occ[2] = occ_blocks[dev];
    occ[3] = attr.numRegs;
    occ[4] = int(attr.localSizeBytes);
    occ[5] = p.stage_tables;
    occ[6] = p.stage_grids;
    occ[7] = int(grid);
    occ[8] = sms[dev];
    return 0;
  }
  if (a.n_atoms == 0) return 0;
  kernel<<<unsigned(grid), warps * kWarp, smem,
           static_cast<cudaStream_t>(a.stream)>>>(p);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_multi(const MultiArgs& a, int with_energy, int* occ) {
  if (a.K > 32 || a.S < 1 || a.max_cols < 1)
    return int(cudaErrorInvalidValue);
  if (a.K <= 16)
    return with_energy ? run_multi<T, 16, true>(a, occ)
                       : run_multi<T, 16, false>(a, occ);
  return with_energy ? run_multi<T, 32, true>(a, occ)
                     : run_multi<T, 32, false>(a, occ);
}

MultiArgs make_multi_args(const void* d, const void* valid,
                          const void* s_slot, const void* s_center,
                          const void* ints, const void* reals,
                          const void* tables, const void* grids,
                          void* energy, void* fc, void* part, int n_atoms,
                          int K, int n_species, int max_cols, int n_ints,
                          int n_reals, int n_tables, int n_grids,
                          void* stream) {
  MultiArgs a;
  a.d = d;
  a.valid = valid;
  a.s_slot = s_slot;
  a.s_center = s_center;
  a.ints = ints;
  a.reals = reals;
  a.tables = tables;
  a.grids = grids;
  a.energy = energy;
  a.fc = fc;
  a.part = part;
  a.n_atoms = n_atoms;
  a.K = K;
  a.S = n_species;
  a.max_cols = max_cols;
  a.n_ints = n_ints;
  a.n_reals = n_reals;
  a.n_tables = n_tables;
  a.n_grids = n_grids;
  a.stream = stream;
  return a;
}

}  // namespace

// The multi-species pass over every ordered trio type: energy (N,),
// center force (N, 3) and partials (N, K, 5) written once.  s_slot
// (N, K) and s_center (N,) are int64 species ids; ints, reals, tables
// and grids the packed metadata of ops/multi.py pack_trio_multi (16-byte
// aligned, element counts multiples of 4); max_cols the widest Bw*Cw of
// the types.  Returns cudaGetLastError() after the launch (0 on success), or
// -1 when one warp's shared memory for this K and the widest window
// exceeds 227 KB.
extern "C" int uf3_trio_multi_f32(
    const void* d, const void* valid, const void* s_slot,
    const void* s_center, const void* ints, const void* reals,
    const void* tables, const void* grids, void* energy, void* fc,
    void* part, int n_atoms, int K, int n_species, int max_cols, int n_ints,
    int n_reals, int n_tables, int n_grids, int with_energy, void* stream) {
  return dispatch_multi<float>(
      make_multi_args(d, valid, s_slot, s_center, ints, reals, tables, grids,
                      energy, fc, part, n_atoms, K, n_species, max_cols,
                      n_ints, n_reals, n_tables, n_grids, stream),
      with_energy, nullptr);
}

extern "C" int uf3_trio_multi_f64(
    const void* d, const void* valid, const void* s_slot,
    const void* s_center, const void* ints, const void* reals,
    const void* tables, const void* grids, void* energy, void* fc,
    void* part, int n_atoms, int K, int n_species, int max_cols, int n_ints,
    int n_reals, int n_tables, int n_grids, int with_energy, void* stream) {
  return dispatch_multi<double>(
      make_multi_args(d, valid, s_slot, s_center, ints, reals, tables, grids,
                      energy, fc, part, n_atoms, K, n_species, max_cols,
                      n_ints, n_reals, n_tables, n_grids, stream),
      with_energy, nullptr);
}

// The launch plan of uf3_trio_multi_{f32,f64} for these sizes: out =
// {atoms per block, shared bytes per block, resident blocks per SM,
// registers per thread, local bytes per thread, tables staged, grids
// staged, blocks launched for n_atoms, SMs}.
extern "C" int uf3_trio_multi_occupancy(int is_f64, int n_atoms, int K,
                                        int n_species, int max_cols,
                                        int n_ints, int n_reals,
                                        int n_tables, int n_grids,
                                        int with_energy, int* out) {
  const MultiArgs a = make_multi_args(
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, n_atoms, K, n_species, max_cols, n_ints,
      n_reals, n_tables, n_grids, nullptr);
  return is_f64 ? dispatch_multi<double>(a, with_energy, out)
                : dispatch_multi<float>(a, with_energy, out);
}
