// What the trio kernels share (trio.cu, the unary pass; trio_multi.cu,
// the multi-species pass over every ordered trio type): sizes, the
// vector types of the shared-memory slices, and the closed-form leg
// helpers (interval lookup, then Horner on that interval's row of the
// (n_int, 20) tables of ops/splines.horner_table).

#pragma once

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
// [0, n_int - 1].  r2 = r*r and inv_r = 1/r are the caller's.  L is a
// Leg or any struct with its fields.
template <typename T, typename L>
__device__ __forceinline__ int leg_interval(const L& s, T r, T r2,
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

size_t round32(size_t bytes) { return (bytes + 31) & ~size_t(31); }

}  // namespace
