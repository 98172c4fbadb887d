// Batched displacement operator D(mu) by the Zassenhaus split, for NVIDIA
// Hopper (sm_90a):
//
//   D(mu) = exp(-|mu|^2 / 2) . L(mu) . U(mu),
//   L[j, m] = mu^(j-m) c[j, m]     (lower triangular, exp(mu a^dagger)),
//   U[m, k] = nu^(k-m) c[k, m]     (upper triangular, exp(-mu* a)),
//   nu = -mu* = (-re, +im),  c[j, m] = sqrt(j!/m!) / (j-m)!  for j >= m.
//
// Replaces the Pallas TPU kernel
// repro/kernels/displacement_expm.py::displacement_expm.
//
// What bounds it: the output's bytes (2 . B . d^2 words, 1.29 ms at B = 2^20,
// d = 16 in fp64 at 3.35 TB/s); the arithmetic is far below that.  So the
// design spends few instructions an output and stores whole sectors.
//
// The product L.U, summed per element.  Since mu . nu = -|mu|^2 is real,
// every term of (L.U)[j, k] = sum_{m <= min(j, k)} c[j, m] c[k, m]
// mu^(j-m) nu^(k-m) carries the same power z^|j-k| (z = mu below the
// diagonal, nu above it) times a power of x = -|mu|^2:
//
//   D[j, k] = pref . z^|j-k| . Q_jk(x),
//   Q_jk(x) = sum_{m <= min(j, k)} c[j, m] c[k, m] x^(min(j, k) - m),
//
// so a sample's d^2 elements are real polynomials of degree min(j, k) in one
// real x (Horner: min(j, k) FMAs each, d^3/3 in all, where L.U takes four
// times as many in complex arithmetic), each times one complex power; and
// nu^p = (-1)^p conj(mu^p), so one table of powers serves both triangles.
// These are the same sums as L.U, with the common factor taken out: the
// plain version's rounding bound (8 d eps times the summed magnitudes of
// the terms) holds here too, as long as every element's summed magnitude
// is a normal number.  The powers pref . mu^p are repeated products, so
// mu = 0 gives the identity exactly (x = 0, Q_jj(0) = 1, 0^p = 0); no
// log(r) branch.
//
// Samples whose sums reach below the smallest normal number.  The least
// summed magnitude of a sample is pref (the diagonal) or pref |mu|^(d-1)
// c[d-1, 0] (the corner): in fp32 the corner falls below 2^-126 at
// |mu| < 0.007 (d = 16), pref at |mu| > 13.2.  There the results round in
// subnormal steps, an absolute error no relative bound covers, so once the
// block has stored everything, the warp of such a sample writes it over
// element by element as the plain version forms it: L[j, m] and U[m, k]
// rounded from repeated powers and the same table c, summed from
// m = min(j, k) down, then times pref, whose |mu|^2 is rounded term by
// term as PyTorch's elementwise ops round it.  That is the arithmetic
// of this kernel's first version, which met the bound in every run on the
// random draws of |mu| <= 1.5 (about 3 samples in 10^5 take this path in
// fp32 at d = 16; in fp64 only mu = 0).  It does not make the two round
// alike everywhere: where mu's powers fall below the smallest normal
// number too (fp32, d = 16, |mu| < 0.0055) or pref does, PyTorch's cumprod
// and matmul still round some elements apart from it, as they did from
// the first version (PERF.md section 6).
//
// The coefficient tables come from the caller, computed once in float64
// from lgamma as the reference's table: q = c[j, m] c[k, m] (j >= k >= m,
// for all j below MAX_D: it does not depend on d), which a block stages in
// shared memory, where every lane reads the same word; and c itself
// (MAX_D x MAX_D, the plain version's table), read from global memory by
// the samples above only.
//
// Layout.  A block takes a run of S = 128 samples, a thread each: every lane
// of a warp evaluates the same element (j, k), so the lanes do even work
// and all index arithmetic is 32-bit and the same across the warp.  d is a
// template parameter (one kernel for each d = 1..16), so the loops over
// powers unroll and the element offsets are constants.  The outputs go
// through shared memory a few rows at a time (a chunk, [part][element]
// [sample], lanes on neighbouring words): each sample's part of a chunk is
// a contiguous piece of the output (128 bytes in each plane where d
// allows), which the block stores as 16-byte vectors
// where d's parity allows (8 or 4 bytes else), neighbouring threads on
// neighbouring vectors, so every store instruction writes whole 32-byte
// sectors.  The stores stream past L2 (st.global.cs, evict first: the
// output, 4.3 GB at B = 2^20, d = 16, outgrows L2 many times): 3-17 %
// faster than plain stores, and at d = 16 in fp64 the interleaved entry
// 1.41 against 1.91 ms; 64-byte pieces (fp32, a row) ran 1.5x slower than
// 128-byte ones, 256-byte ones 1.1-1.5x slower (PERF.md section 6).
//
// Two output layouts: re and im planes (B, d, d) each, the TPU kernel's;
// or (re, im) interleaved, the memory of a (B, d, d) complex tensor, read
// from an interleaved mu (a complex (B,) tensor).
//
// C interface (loaded with ctypes): each entry launches on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 16;
// samples (and threads) a block; bytes of a sample's piece of a chunk in
// each plane (twice that interleaved)
constexpr int S = 128, PIECE = 128;

// offset of Q_jk's coefficients (j >= k) in the table: pairs in order of j,
// then k; k + 1 coefficients each, that of x^k first
__host__ __device__ constexpr int qoff(int j, int k) {
  return j * (j + 1) * (j + 2) / 6 + k * (k + 1) / 2;
}

// rows a chunk: the most that divide d and fit a piece
template <typename T>
__host__ __device__ constexpr int chunk_rows(int d) {
  int r = 1;
  for (int c = 1; c <= d; ++c)
    if (d % c == 0 && c * d * (int)sizeof(T) <= PIECE) r = c;
  return r;
}

// the staging of a chunk, [re, im][element of the chunk][sample], rows of
// S + 1 words (lanes write neighbouring words; the reads of a piece's
// vectors fall in distinct banks)
template <typename T, int D>
struct Stage {
  static constexpr int CH = chunk_rows<T>(D) * D, LDS = S + 1;
  static constexpr int BYTES = 2 * CH * LDS * (int)sizeof(T);
};

// elements of T a vector store writes: 16 bytes where every piece's offset
// is a multiple of it (pieces start at multiples of `unit` elements)
template <typename T>
__host__ __device__ constexpr int vec_elems(int unit) {
  int v = 16 / (int)sizeof(T);
  while (unit % v != 0) v /= 2;
  return v;
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// 16 bytes (or V elements) to global memory, streamed past L2 (evict first)
template <typename T, int V>
__device__ __forceinline__ void store(T* dst, const Vec<T, V>& val) {
  if constexpr (V == 1) {
    __stcs(dst, val.v[0]);
  } else if constexpr (sizeof(T) * V == 16 && sizeof(T) == 8) {
    __stcs(reinterpret_cast<double2*>(dst), make_double2(val.v[0], val.v[1]));
  } else if constexpr (sizeof(T) * V == 16) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(val.v[0], val.v[1], val.v[2], val.v[3]));
  } else {
    __stcs(reinterpret_cast<float2*>(dst), make_float2(val.v[0], val.v[1]));
  }
}

// Q(x) by Horner from its coefficients q[0..deg] (x^deg first)
template <typename T>
__device__ __forceinline__ T horner(const T* q, int deg, T x) {
  T acc = q[0];
  for (int m = 1; m <= deg; ++m) acc = acc * x + q[m];
  return acc;
}

// the dtype's smallest normal number; a * b and a + b rounded once each
// (not contracted into an FMA)
template <typename T> __device__ __forceinline__ T smallest_normal();
template <> __device__ __forceinline__ float smallest_normal() {
  return FLT_MIN;
}
template <> __device__ __forceinline__ double smallest_normal() {
  return DBL_MIN;
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// Element (j, k) of D(mu) as the plain version forms it: L[j, m] =
// mu^(j-m) c[j, m] and U[m, k] = nu^(k-m) c[k, m] (nu = -mu*) from repeated
// products, summed from m = min(j, k) down to 0, times pref.
template <typename T>
__device__ void element_lu(const T* __restrict__ c, T re, T im, T pref,
                           int j, int k, T& out_re, T& out_im) {
  const T nre = -re, nim = im;
  const int mn = j < k ? j : k;
  T xr = T(1), xi = T(0);          // mu^(j - m)
#pragma unroll 1
  for (int p = 0; p < j - mn; ++p) {
    const T r = xr * re - xi * im;
    xi = xr * im + xi * re;
    xr = r;
  }
  T yr = T(1), yi = T(0);          // nu^(k - m)
#pragma unroll 1
  for (int p = 0; p < k - mn; ++p) {
    const T r = yr * nre - yi * nim;
    yi = yr * nim + yi * nre;
    yr = r;
  }
  T ar = T(0), ai = T(0);
#pragma unroll 1
  for (int m = mn;; --m) {
    const T cj = __ldg(c + j * MAX_D + m), ck = __ldg(c + k * MAX_D + m);
    const T lr = xr * cj, li = xi * cj;
    const T ur = yr * ck, ui = yi * ck;
    ar += lr * ur - li * ui;
    ai += lr * ui + li * ur;
    if (m == 0) break;
    T r = xr * re - xi * im;
    xi = xr * im + xi * re;
    xr = r;
    r = yr * nre - yi * nim;
    yi = yr * nim + yi * nre;
    yr = r;
  }
  out_re = ar * pref;
  out_im = ai * pref;
}

// One chunk's pieces from shared memory to the output: planes (out_im not
// null: re and im, each d^2 a sample) or interleaved ((re, im) pairs, 2 d^2
// a sample), the block's samples [0, n) from its base pointers.
template <typename T, int D, bool INTERLEAVED>
__device__ __forceinline__ void store_chunk(const T* st, int n, int e0,
                                            T* out_re, T* out_im) {
  using SG = Stage<T, D>;
  constexpr int PARTS = INTERLEAVED ? 1 : 2;
  constexpr int W = INTERLEAVED ? 2 : 1;            // words an element
  constexpr int V = vec_elems<T>(W * D);
  constexpr int NV = W * SG::CH / V;                // vectors of a piece
  static_assert(NV * V == W * SG::CH, "whole vectors in a piece");
  for (int i = threadIdx.x; i < n * NV; i += S) {
    const int s = i / NV, w = i - s * NV;
#pragma unroll
    for (int part = 0; part < PARTS; ++part) {
      Vec<T, V> val;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int word = w * V + e;                 // of the piece
        const int at = INTERLEAVED ? (word % 2) * SG::CH + word / 2
                                   : part * SG::CH + word;
        val.v[e] = st[at * SG::LDS + s];
      }
      T* dst = (part == 0 ? out_re : out_im) + (s * D * D + e0) * W + w * V;
      store(dst, val);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(S)
displacement_kernel(const T* __restrict__ mu_re, const T* __restrict__ mu_im,
                    int mu_step, const T* __restrict__ q,
                    const T* __restrict__ c, T* __restrict__ out_re,
                    T* __restrict__ out_im, int batch) {
  using SG = Stage<T, D>;
  constexpr int RJ = chunk_rows<T>(D), NQ = qoff(D, 0);
  __shared__ T qs[NQ];
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  T* st = reinterpret_cast<T*>(stage_bytes);
  for (int i = threadIdx.x; i < NQ; i += S) qs[i] = q[i];

  const int b0 = blockIdx.x * S, s = threadIdx.x;
  const int n = batch - b0 < S ? batch - b0 : S;
  T re = T(0), im = T(0);
  if (s < n) {
    re = mu_re[(size_t)b0 * mu_step + s * mu_step];
    im = mu_im[(size_t)b0 * mu_step + s * mu_step];
  }
  const T r2 = re * re + im * im, x = -r2;
  T wr[D], wi[D];                  // pref . mu^p
  wr[0] = exp(T(-0.5) * r2);
  wi[0] = T(0);
#pragma unroll
  for (int p = 1; p < D; ++p) {
    wr[p] = wr[p - 1] * re - wi[p - 1] * im;
    wi[p] = wr[p - 1] * im + wi[p - 1] * re;
  }
  const bool interleaved = out_im == nullptr;
  T* base_re = out_re + (size_t)b0 * D * D * (interleaved ? 2 : 1);
  T* base_im = interleaved ? nullptr : out_im + (size_t)b0 * D * D;
  T* st_re = st + s;               // element e of the chunk: [e * LDS]
  T* st_im = st + SG::CH * SG::LDS + s;
  __syncthreads();                 // qs is staged
  // a sum below the smallest normal number: the plain version's order
  const T tiny = T(2) * smallest_normal<T>();
  const bool as_plain =
      s < n &&
      !(wr[0] >= tiny &&
        (fabs(wr[D - 1]) + fabs(wi[D - 1])) * qs[qoff(D - 1, 0)] >= tiny);

#pragma unroll 1
  for (int j0 = 0; j0 < D; j0 += RJ) {
#pragma unroll 1
    for (int jj = 0; jj < RJ; ++jj) {
      const int j = j0 + jj;
#pragma unroll
      for (int p = 0; p < D; ++p) {
        if (p <= j) {              // (j, j - p): z^p = mu^p
          const T v = horner(qs + qoff(j, j - p), j - p, x);
          const int e = (jj * D + j - p) * SG::LDS;
          st_re[e] = v * wr[p];
          st_im[e] = v * wi[p];
        }
        if (p > 0 && j + p < D) {  // (j, j + p): nu^p = (-1)^p conj(mu^p)
          const T v = horner(qs + qoff(j + p, j), j, x);
          const T sv = p % 2 ? -v : v;
          const int e = (jj * D + j + p) * SG::LDS;
          st_re[e] = sv * wr[p];
          st_im[e] = -(sv * wi[p]);
        }
      }
    }
    __syncthreads();
    if (interleaved)
      store_chunk<T, D, true>(st, n, j0 * D, base_re, nullptr);
    else
      store_chunk<T, D, false>(st, n, j0 * D, base_re, base_im);
    __syncthreads();
  }
  // Such a sample is written over after the block's stores (the barrier
  // above orders them first), by its warp together, lanes on elements.
  // Its mu is read again: kept in registers across the loop above, or
  // written over by its own thread alone, it slowed that loop at d = 16 in
  // fp32.
  unsigned flagged = __ballot_sync(0xffffffffu, as_plain);
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x & ~31;
  while (flagged) {
    const int ws = warp0 + __ffs(flagged) - 1;
    flagged &= flagged - 1;
    const size_t at = ((size_t)b0 + ws) * mu_step;
    const T ure = __ldcg(mu_re + at), uim = __ldcg(mu_im + at);
    const T pref =
        exp(T(-0.5) * add_rn(mul_rn(ure, ure), mul_rn(uim, uim)));
    for (int e = lane; e < D * D; e += 32) {
      T vr, vi;
      element_lu(c, ure, uim, pref, e / D, e % D, vr, vi);
      if (interleaved) {
        base_re[(ws * D * D + e) * 2] = vr;
        base_re[(ws * D * D + e) * 2 + 1] = vi;
      } else {
        base_re[ws * D * D + e] = vr;
        base_im[ws * D * D + e] = vi;
      }
    }
  }
}

// out_im null: interleaved (mu_re and out_re the (re, im) pairs)
template <typename T, int D = 1>
int launch(const T* mu_re, const T* mu_im, int mu_step, const T* q,
           const T* c, T* out_re, T* out_im, int batch, int d,
           cudaStream_t stream) {
  if constexpr (D > MAX_D) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (d != D)
      return launch<T, D + 1>(mu_re, mu_im, mu_step, q, c, out_re, out_im,
                              batch, d, stream);
    if ((uintptr_t)out_re % 16 != 0 || (uintptr_t)out_im % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    constexpr int smem = Stage<T, D>::BYTES;
    if constexpr (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          displacement_kernel<T, D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (int)(((long long)batch + S - 1) / S);
    displacement_kernel<T, D><<<blocks, S, smem, stream>>>(
        mu_re, mu_im, mu_step, q, c, out_re, out_im, batch);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int displacement(const T* mu_re, const T* mu_im, int mu_step, const T* q,
                 const T* c, T* out_re, T* out_im, int batch, int d,
                 cudaStream_t stream) {
  if (d < 1 || d > MAX_D || batch < 1) return (int)cudaErrorInvalidValue;
  return launch<T>(mu_re, mu_im, mu_step, q, c, out_re, out_im, batch, d,
                   stream);
}

}  // namespace

extern "C" {

// q: the coefficient table of the sums (qoff(MAX_D, 0) = 816 values), c:
// the MAX_D x MAX_D table c[j, m], both in the inputs' type.  Planes:
// mu_re, mu_im (B,) -> out_re, out_im (B, d, d).
int fastmps_displacement_expm_f64(const double* mu_re, const double* mu_im, const double* q, const double* c, double* out_re, double* out_im, int batch, int d, void* stream) {
  return displacement<double>(mu_re, mu_im, 1, q, c, out_re, out_im, batch,
                              d, (cudaStream_t)stream);
}

int fastmps_displacement_expm_f32(const float* mu_re, const float* mu_im, const float* q, const float* c, float* out_re, float* out_im, int batch, int d, void* stream) {
  return displacement<float>(mu_re, mu_im, 1, q, c, out_re, out_im, batch,
                             d, (cudaStream_t)stream);
}

// Interleaved: mu (B,) complex -> out (B, d, d) complex, (re, im) pairs.
int fastmps_displacement_expm_c128(const double* mu, const double* q, const double* c, double* out, int batch, int d, void* stream) {
  return displacement<double>(mu, mu + 1, 2, q, c, out, nullptr, batch, d,
                              (cudaStream_t)stream);
}

int fastmps_displacement_expm_c64(const float* mu, const float* q, const float* c, float* out, int batch, int d, void* stream) {
  return displacement<float>(mu, mu + 1, 2, q, c, out, nullptr, batch, d,
                             (cudaStream_t)stream);
}

}  // extern "C"
