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
// Why the TPU layout is not carried over.  The TPU kernel puts the batch on
// the 128-wide lane axis, builds mu^m in polar form (r^m, m.theta) for the
// whole (d, d, lanes) slab and multiplies the factors by d rank-1 updates.
// Here one thread owns one output element (sample b, row j, column k):
//
//   out[b, j, k] = pref_b . sum_{m <= min(j, k)} L[j, m] . U[m, k].
//
// Walking m from min(j, k) down to 0 raises both powers by one each step,
// so the thread needs no table of powers: it starts from mu^(j - min) and
// nu^(k - min) (one of the two exponents is 0) and multiplies by mu and nu.
// The powers are plain repeated products, as the plain PyTorch version's
// cumprod: at mu = 0 they are 1, 0, 0, ... and D(0) = I exactly, with no
// log(r) branch to guard.  Consecutive threads write consecutive (j, k) of
// one sample, so the (B, d, d) re and im planes are written coalesced.
// The d x d coefficient table comes from the caller (the host computes it
// with lgamma in float64, as the reference) and is staged in shared memory.
//
// Bound: the output bytes (2 . B . d^2 words); the complex multiply-adds are
// at most d per element.  Every sum is in the input's precision.
//
// C interface (loaded with ctypes): each entry launches on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 16;
constexpr int THREADS = 256;

template <typename T>
__global__ void displacement_kernel(const T* __restrict__ mu_re,
                                    const T* __restrict__ mu_im,
                                    const T* __restrict__ coeff,
                                    T* __restrict__ out_re,
                                    T* __restrict__ out_im, int64_t total,
                                    int d) {
  __shared__ T c[MAX_D * MAX_D];
  const int dd = d * d;
  for (int i = threadIdx.x; i < dd; i += blockDim.x) c[i] = coeff[i];
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t b = t / dd;
  const int e = (int)(t - b * dd);
  const int j = e / d, k = e - (e / d) * d;
  const T re = mu_re[b], im = mu_im[b];
  const T nre = -re, nim = im;  // nu = -mu*
  const int mn = j < k ? j : k;
  T xr = T(1), xi = T(0);  // mu^(j - m)
  for (int p = 0; p < j - mn; ++p) {
    const T r = xr * re - xi * im;
    xi = xr * im + xi * re;
    xr = r;
  }
  T yr = T(1), yi = T(0);  // nu^(k - m)
  for (int p = 0; p < k - mn; ++p) {
    const T r = yr * nre - yi * nim;
    yi = yr * nim + yi * nre;
    yr = r;
  }
  T ar = T(0), ai = T(0);
  for (int m = mn;; --m) {
    const T cj = c[j * d + m], ck = c[k * d + m];
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
  const T pref = exp(T(-0.5) * (re * re + im * im));
  out_re[t] = ar * pref;
  out_im[t] = ai * pref;
}

template <typename T>
int displacement(const T* mu_re, const T* mu_im, const T* coeff, T* out_re,
                 T* out_im, int batch, int d, cudaStream_t stream) {
  if (d < 1 || d > MAX_D || batch < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)batch * d * d;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  displacement_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      mu_re, mu_im, coeff, out_re, out_im, total, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fastmps_displacement_expm_f64(const double* mu_re, const double* mu_im, const double* coeff, double* out_re, double* out_im, int batch, int d, void* stream) {
  return displacement<double>(mu_re, mu_im, coeff, out_re, out_im, batch, d,
                              (cudaStream_t)stream);
}

int fastmps_displacement_expm_f32(const float* mu_re, const float* mu_im, const float* coeff, float* out_re, float* out_im, int batch, int d, void* stream) {
  return displacement<float>(mu_re, mu_im, coeff, out_re, out_im, batch, d,
                             (cudaStream_t)stream);
}

}  // extern "C"
