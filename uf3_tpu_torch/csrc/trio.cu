// Fused 3-body pair-lane pass of the UF3 potential, per center atom:
// energy, center force and the slot partials S1, S3', V3' that the
// reverse-slot assembly gathers into neighbor forces.
//
// Replaces the Pallas TPU kernel make_trio_kernel / trio_forces_pallas
// and its XLA twin trio_forces_unrolled, whose shared per-block body is
// _trio_block_compute (uf3_tpu/ops/pallas_trio.py).
//
// What bounds it on the card: arithmetic, not bytes.  Per atom it reads
// K*3 + K values and writes K*5 + 4, while each of the K*K pair lanes
// runs a de Boor recursion plus ~3 FMAs per live (b, c) block (27 at the
// bench model); the dense leg bases and H = A.G, H1 = dA.G (K x Ww*Cw)
// stay in shared memory, so no intermediate reaches device memory.  The
// design: one thread block per center atom with one thread per pair lane
// p = m*K + n (K = 16 -> 256 threads); the live (b, c) mask and the leg
// specs are runtime arguments, so one build serves every model.  All
// arithmetic is plain FMA in the working type (no TF32, no library
// matmul).  Blocks are independent: nothing carries across atoms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Leg {
  int kind;      // 0 linear, 1 lammps r^2, 2 geometric, 3 inverse
  double u0;     // first knot in the transformed coordinate
  double h;      // knot spacing in the transformed coordinate
  int n_int;     // number of intervals
  double t_min;  // inclusive range gate
  double t_max;
};

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  return den != T(0) ? num / den : T(0);
}

template <typename T>
__device__ __forceinline__ T knot_value(const Leg& s, int k) {
  T u = T(s.u0) + T(k) * T(s.h);
  switch (s.kind) {
    case 0: return u;
    case 1: return sqrt(u > T(0) ? u : T(0));
    case 2: return exp(u);
    default: return T(1) / u;
  }
}

template <typename T>
__device__ __forceinline__ T transform(const Leg& s, T r) {
  switch (s.kind) {
    case 0: return r;
    case 1: return r * r;
    case 2: return log(r);
    default: return T(1) / r;
  }
}

// Values and d/dr of the 4 non-zero clamped cubic basis functions at r
// (de Boor over the analytic knot window, zero denominators at the
// clamped ends give zero terms), gated by valid * (t_min <= r <= t_max).
// Returns the interval index (first non-zero basis function).
template <typename T>
__device__ int leg_basis(T r, T valid, const Leg& s, T* val, T* der) {
  T raw = floor((transform<T>(s, r) - T(s.u0)) / T(s.h));
  raw = raw < T(0) ? T(0) : raw;
  raw = raw > T(s.n_int - 1) ? T(s.n_int - 1) : raw;
  const int idx = int(raw);
  T tk[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int k = idx + j - 3;
    k = k < 0 ? 0 : (k > s.n_int ? s.n_int : k);
    tk[j] = knot_value<T>(s, k);
  }
  T b[4] = {T(0), T(0), T(0), T(1)};
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    T nb[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int p = 3 - k; p < 4; ++p) {
      T term = safe_div(r - tk[p], tk[p + k] - tk[p]) * b[p];
      if (p + 1 <= 3)
        term = term + safe_div(tk[p + k + 1] - r, tk[p + k + 1] - tk[p + 1])
                          * b[p + 1];
      nb[p] = term;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) b[p] = nb[p];
  }
  const T gate = valid * (r >= T(s.t_min) ? T(1) : T(0))
                 * (r <= T(s.t_max) ? T(1) : T(0));
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    T term = safe_div(r - tk[p], tk[p + 3] - tk[p]) * b[p];
    T dterm = T(3) * safe_div(b[p], tk[p + 3] - tk[p]);
    if (p + 1 <= 3) {
      term = term + safe_div(tk[p + 4] - r, tk[p + 4] - tk[p + 1]) * b[p + 1];
      dterm = dterm - T(3) * safe_div(b[p + 1], tk[p + 4] - tk[p + 1]);
    }
    val[p] = term * gate;
    der[p] = dterm * gate;
  }
  return idx;
}

// Entry w of a dense basis row: the tap (w - idx) of the 4 active values,
// zero outside them (selects, so the tap arrays stay in registers).
template <typename T>
__device__ __forceinline__ T tap_of(const T* v, int tap) {
  return tap == 0 ? v[0] : tap == 1 ? v[1] : tap == 2 ? v[2]
       : tap == 3 ? v[3] : T(0);
}

template <typename T>
__global__ void trio_partials_kernel(
    const T* __restrict__ d, const T* __restrict__ valid,
    const T* __restrict__ gwin, const uint8_t* __restrict__ live,
    T* __restrict__ energy, T* __restrict__ fc, T* __restrict__ part,
    int K, Leg leg_l, Leg leg_n, int w_lo, int ww, int c_lo, int cw,
    int with_energy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wc = ww * cw;
  const int kk = K * K;
  T* sd = reinterpret_cast<T*>(smem_raw);  // (K, 3) displacements
  T* sval = sd + 3 * K;                    // (K,) slot mask
  T* sr = sval + K;                        // (K,) |d|
  T* sa = sr + K;                          // (K, Ww) leg basis
  T* sda = sa + K * ww;                    // (K, Ww) its derivative
  T* sh = sda + K * ww;                    // (K, Ww*Cw) H = A.G
  T* sh1 = sh + K * wc;                    // (K, Ww*Cw) H1 = dA.G
  T* st1 = sh1 + K * wc;                   // (K*K,) t1 per lane
  T* sg3 = st1 + kk;                       // (K*K,) t3 / r_mn per lane
  T* sv = sg3 + kk;                        // (K*K,) value per lane
  T* sfc = sv + kk;                        // (K, 3) w_m / r_m * d_m
  T* serow = sfc + 3 * K;                  // (K,) energy row sums
  int* slive = reinterpret_cast<int*>(serow + K);  // (Ww*Cw,) live mask

  const size_t atom = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * K; i += blockDim.x) sd[i] = d[atom * 3 * K + i];
  for (int i = tid; i < K; i += blockDim.x) sval[i] = valid[atom * K + i];
  for (int i = tid; i < wc; i += blockDim.x) slive[i] = live[i];
  __syncthreads();

  // dense first-leg bases over the live window, one slot per thread
  for (int m = tid; m < K; m += blockDim.x) {
    const T x = sd[3 * m], y = sd[3 * m + 1], z = sd[3 * m + 2];
    const T r2 = x * x + y * y + z * z;
    const T r = sqrt(r2 > T(0) ? r2 : T(1));
    sr[m] = r;
    T v[4], dv[4];
    const int idx = leg_basis<T>(r, sval[m], leg_l, v, dv);
    for (int w = 0; w < ww; ++w) {
      sa[m * ww + w] = tap_of(v, w_lo + w - idx);
      sda[m * ww + w] = tap_of(dv, w_lo + w - idx);
    }
  }
  __syncthreads();

  // grid contraction over the window: H[m, j] = sum_l A[m, l] G[l, j]
  for (int i = tid; i < K * wc; i += blockDim.x) {
    const int m = i / wc, j = i - (i / wc) * wc;
    T h = T(0), h1 = T(0);
    for (int l = 0; l < ww; ++l) {
      const T g = gwin[l * wc + j];
      h = h + sa[m * ww + l] * g;
      h1 = h1 + sda[m * ww + l] * g;
    }
    sh[i] = h;
    sh1[i] = h1;
  }
  __syncthreads();

  // pair lanes p = m*K + n: third leg d[n] - d[m], H from row m, A from
  // row n, accumulated over the live (b, c) blocks in (b, c) order
  for (int p = tid; p < kk; p += blockDim.x) {
    const int m = p / K, n = p - (p / K) * K;
    const T dx = sd[3 * n] - sd[3 * m];
    const T dy = sd[3 * n + 1] - sd[3 * m + 1];
    const T dz = sd[3 * n + 2] - sd[3 * m + 2];
    const T rmn2 = dx * dx + dy * dy + dz * dz;
    const T rmn = sqrt(rmn2 > T(0) ? rmn2 : T(1));
    const T pv = sval[m] * sval[n] * (rmn2 > T(1e-10) ? T(1) : T(0));
    T cv[4], cdv[4];
    const int cidx = leg_basis<T>(rmn, pv, leg_n, cv, cdv);
    const T* hm = sh + m * wc;
    const T* h1m = sh1 + m * wc;
    T value = T(0), t1 = T(0), t3 = T(0);
    for (int b = 0; b < ww; ++b) {
      T db = T(0), d1b = T(0), d3b = T(0);
      bool any = false;
      for (int c = 0; c < cw; ++c) {
        const int col = b * cw + c;
        if (!slive[col]) continue;
        any = true;
        const int tap = c_lo + c - cidx;
        const T cp = tap_of(cv, tap);
        const T cdp = tap_of(cdv, tap);
        if (with_energy) db = db + cp * hm[col];
        d1b = d1b + cp * h1m[col];
        d3b = d3b + cdp * hm[col];
      }
      if (!any) continue;
      const T bcol = sa[n * ww + b];
      if (with_energy) value = value + bcol * db;
      t1 = t1 + bcol * d1b;
      t3 = t3 + bcol * d3b;
    }
    st1[p] = t1;
    sg3[p] = t3 / rmn;
    sv[p] = value;
  }
  __syncthreads();

  // per-slot reductions over n: S1 = w_m, S3' and V3'
  for (int m = tid; m < K; m += blockDim.x) {
    T w = T(0), s3 = T(0), vx = T(0), vy = T(0), vz = T(0), e = T(0);
    for (int n = 0; n < K; ++n) {
      const T g = sg3[m * K + n];
      w = w + st1[m * K + n];
      s3 = s3 + g;
      vx = vx + g * sd[3 * n];
      vy = vy + g * sd[3 * n + 1];
      vz = vz + g * sd[3 * n + 2];
      e = e + sv[m * K + n];
    }
    T* out = part + (atom * K + m) * 5;
    out[0] = w;
    out[1] = s3;
    out[2] = vx;
    out[3] = vy;
    out[4] = vz;
    const T wr = w / sr[m];
    sfc[3 * m] = wr * sd[3 * m];
    sfc[3 * m + 1] = wr * sd[3 * m + 1];
    sfc[3 * m + 2] = wr * sd[3 * m + 2];
    serow[m] = e;
  }
  __syncthreads();

  if (tid == 0) {
    T fx = T(0), fy = T(0), fz = T(0), e = T(0);
    for (int m = 0; m < K; ++m) {
      fx = fx + sfc[3 * m];
      fy = fy + sfc[3 * m + 1];
      fz = fz + sfc[3 * m + 2];
      e = e + serow[m];
    }
    fc[atom * 3] = fx;
    fc[atom * 3 + 1] = fy;
    fc[atom * 3 + 2] = fz;
    energy[atom] = T(0.5) * e;
  }
}

template <typename T>
size_t smem_bytes(int K, int ww, int cw) {
  const size_t n_t = 3 * K + K + K + 2 * K * ww + 2 * K * ww * cw
                     + 3 * K * K + 3 * K + K;
  return n_t * sizeof(T) + ww * cw * sizeof(int);
}

template <typename T>
int launch(const void* d, const void* valid, const void* gwin,
           const void* live, void* energy, void* fc, void* part,
           int n_atoms, int K, const double* legs, const int* ints,
           int w_lo, int ww, int c_lo, int cw, int with_energy,
           void* stream) {
  if (n_atoms == 0) return 0;
  Leg leg_l{ints[0], legs[0], legs[1], ints[1], legs[2], legs[3]};
  Leg leg_n{ints[2], legs[4], legs[5], ints[3], legs[6], legs[7]};
  const size_t smem = smem_bytes<T>(K, ww, cw);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        trio_partials_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
  }
  trio_partials_kernel<T><<<n_atoms, K * K, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d), static_cast<const T*>(valid),
      static_cast<const T*>(gwin), static_cast<const uint8_t*>(live),
      static_cast<T*>(energy), static_cast<T*>(fc), static_cast<T*>(part),
      K, leg_l, leg_n, w_lo, ww, c_lo, cw, with_energy);
  return int(cudaGetLastError());
}

}  // namespace

// legs: (u0, h, t_min, t_max) of the first legs, then of the third leg;
// ints: (kind, n_int) of the first legs, then of the third leg.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int uf3_trio_partials_f32(
    const void* d, const void* valid, const void* gwin, const void* live,
    void* energy, void* fc, void* part, int n_atoms, int K,
    const double* legs, const int* ints, int w_lo, int ww, int c_lo, int cw,
    int with_energy, void* stream) {
  return launch<float>(d, valid, gwin, live, energy, fc, part, n_atoms, K,
                       legs, ints, w_lo, ww, c_lo, cw, with_energy, stream);
}

extern "C" int uf3_trio_partials_f64(
    const void* d, const void* valid, const void* gwin, const void* live,
    void* energy, void* fc, void* part, int n_atoms, int K,
    const double* legs, const int* ints, int w_lo, int ww, int c_lo, int cw,
    int with_energy, void* stream) {
  return launch<double>(d, valid, gwin, live, energy, fc, part, n_atoms, K,
                        legs, ints, w_lo, ww, c_lo, cw, with_energy, stream);
}
