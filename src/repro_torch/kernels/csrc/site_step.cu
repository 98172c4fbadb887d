// Fused MPS site step for NVIDIA Hopper (sm_90a): one site of Alg. 1,
//   contract -> measure -> inverse-CDF draw -> collapse -> per-sample rescale,
// for linear semantics (real fp32/fp64) and Born semantics (complex64/128),
// and the three stages the tensor-parallel schedules run on bond shards.
//
// Replaces the Pallas TPU kernels repro/kernels/site_step.py::site_step_linear
// (_linear_kernel) and ::site_step_born (_born_kernel); and, for the TP
// schedules, repro/kernels/contract_measure.py::contract_measure,
// repro/kernels/site_step.py::measure_probs (_measure_kernel) and
// repro/kernels/collapse_select.py::collapse_select (see "TP stages" below).
//
// Why the TPU design is not carried over.  The TPU kernel keeps a
// (BN, chi_r, d) slab of temp = env . Gamma in VMEM for the whole site.  At
// chi = 1e4, d = 4 one sample's slab is 320 KB in fp64: more than the 227 KB
// of shared memory a Hopper block can have, so the slab cannot live on the SM.
// It also relies on the TPU running grid steps in order (probs += across
// r tiles); Hopper blocks run in no order, so every cross-block reduction here
// is a second pass, and none uses floating-point atomics (their run-to-run
// order would move the drawn samples).
//
// Linear (measure first, temp never exists):
//   1. measure_weights: W[l, s] = sum_r Gamma[l, r, s] * Lambda[r]
//      -- one pass over Gamma: bound by its bytes.
//   2. probs_draw: probs[n, s] = sum_l env[n, l] * W[l, s], then the draw.
//   3. bucket: a stable counting sort of the rows by drawn outcome.
//   4. collapse: env'[n, :] = env[n, :] . Gamma[:, :, s_n] as a GEMM grouped
//      by outcome -- 2*N*chi^2 flops, 1/d of the full contraction; bound by
//      fp64 operations at the full width (fp64: collapse_f64_kernel, on the
//      fp64 tensor cores, below).
//   5. rescale: per-row max (exact, order-free) and division.
// Born (|sum|^2 != sum|.|^2, so measure-first is invalid):
//   1. contract: the full complex GEMM temp = env . Gamma over the
//      flattened (r, s) columns, written to global memory (N, chi_r, d) --
//      the N*chi^2*d complex multiply-adds are the bound; writing and
//      re-reading temp costs well under 1 % of that at the full width.
//      complex128 runs it on the fp64 tensor cores (contract_c128_kernel,
//      four real DMMA products per complex one, below).
//   2. probs_draw: probs[n, s] = sum_r |temp[n, r, s] * lambda_r|^2 per row
//      (fixed order), then the draw.
//   3. born_collapse: env'[n, :] = temp[n, :, s_n] * lambda, a gather.
//   4. rescale as linear.
//
// TP stages (env and Gamma are bond shards: L != R in general):
//   contract_measure: temp = env . Gamma written out, then probs[n, s] =
//      sum_r temp[n, r, s] * Lambda[r] in a second pass, one block per row
//      in a fixed order.  The TPU kernel adds probs across r tiles in grid
//      order; Hopper blocks cannot, and the second pass reads temp once more
//      (N*R*d words, < 1 % of the GEMM at the full width).  Probs come from
//      the temp the caller receives, as in the reference.  Bound by fp64
//      operations (2*N*L*R*d) at the fp64 tensor cores' rate, so the fp64
//      GEMM is contract_f64_kernel: mma.sync m16n8k8 .f64 (DMMA) on 128 x 64
//      block tiles, 32 x 32 per warp, a 3-stage cp.async ring of 16-deep
//      env and Gamma tiles (Gamma read along its contiguous (r, s) axis),
//      edges zero-filled.  m16n8k8 is one of Hopper's fp64 shapes; Ampere's
//      m8n8k4 in the same kernel was about 1.7x slower.  fp32 keeps the FMA
//      tile below (no TF32).
//   measure_probs: probs = env . W, the probs half of probs_draw without
//      the draw.  Bound by env's bytes: measure_probs_kernel takes many
//      rows a block and stages W in shared memory once for all of them.
//   collapse_select: env'[n, :] = env[n, :] . Gamma[:, :, s_n] with s from
//      the caller: the bucket sort and grouped collapse GEMM of the linear
//      step (1/d of the TPU kernel's d masked GEMMs).  A row whose outcome is
//      outside [0, d) comes out zero, as with the masks.  Bound by fp64
//      operations (2*N*L*R).
//
// bf16 inputs (the reference's compute_dtype=bf16: its mxu_bf16 and
// store_bf16 tiers, the bf16 mode of _linear_kernel, _measure_kernel,
// contract_measure and collapse_select).  Every GEMM operand is rounded to
// bf16 (fp64 through fp32, as the frameworks round it) and its products are
// summed in fp32; Gamma may be fp32 (mxu_bf16) or stored in bf16 beside an
// fp32 env (store_bf16, half its bytes).  At the full width a GEMM of
// 2*N*chi^2 flops takes ~0.2 ms at the 989 TFLOP/s bf16 rate, about what
// the linear step's Gamma read takes (0.8 GB in bf16, 1.6 GB in fp32 at
// chi = 1e4, d = 4), so a GEMM has to run near that rate: on wgmma, fed by
// TMA (wgmma_bf16_kernel, below), from bf16 operands prepared in device
// memory (TMA copies bytes as they lie: it neither converts nor gathers).
//   site_step_linear_bf16: the linear step above, measure first: W = sum_r
//      bf16(Gamma) * Lambda (W itself is not rounded: the reference rounds
//      temp's inputs, and sum_l bf16(env) * W is its sum_r [sum_l bf16(env)
//      * bf16(Gamma)] * Lambda in another order), the W pass also writing
//      the rounded Gamma as bf16 planes (d, L, R), plane s contiguous along
//      r (0.8 GB at chi = 1e4, d = 4); probs = bf16(env) . W in env's type,
//      the draw and bucket sort unchanged; env rounded to bf16 in bucket
//      order (bf16_rows_kernel, so that a group's rows are one TMA range);
//      the grouped collapse on wgmma_bf16_kernel (plane s the B of group
//      s's tiles), then the rescale.
//   contract_measure_bf16: env rounded to bf16, Gamma too unless it is
//      stored in bf16 with 16-byte aligned rows (then read as it lies);
//      temp by wgmma_bf16_kernel, written in env's type (the reference
//      casts its fp32 temp to env's dtype), then the fixed-order probs pass.
//   measure_probs_bf16: probs = bf16(env) . bf16(W) in fp32, by
//      measure_probs_kernel with those roundings.  Bound by env's bytes
//      (d <= 16 columns), so it stays on the FMA units: a product of two
//      bf16 values is exact in fp32, so the FMA sum is what the tensor
//      cores would compute.
//   collapse_select_bf16: the bf16 step's collapse on the caller's
//      samples: Gamma's bf16 planes by the W pass without W
//      (weights_planes_kernel<.., false>), the bucket sort (rows of no
//      outcome in [0, d) last), their rows of env' zeroed, env rounded in
//      bucket order and the grouped collapse on wgmma_bf16_kernel; env' in
//      fp32 whatever env's type, as the reference's collapse returns it.
//      Gamma[:, :, s] is not read by TMA as it lies: with the 128-byte
//      swizzle a box's inner extent is at most 128 bytes, 16 useful bf16
//      values at d = 4 with element strides, and each 32-byte sector of
//      Gamma carries all d outcomes, so every group's tiles would fetch d
//      times their bytes; the planes pass reads Gamma once.
//
// The draw is op for op repro/kernels/site_impls.py::draw_from_uniform:
// clip(probs, 0), row total, probs/total (1/d where the total is 0), a
// sequential cumsum, count(u > cdf) with a strict '>', clipped to [0, d-1].
// Without bf16 inputs every sum accumulates in the input's precision (fp64
// stays fp64, no TF32).
//
// What bounds the GEMMs is their fp64 operations (2*N*chi^2 and more at
// chi = 1e4), which the card does at 67 TFLOP/s only on its fp64 tensor
// cores.  Every fp64 GEMM runs there, on one DMMA main loop:
// contract_measure's (contract_f64_kernel), the Born step's complex128
// contraction (contract_c128_kernel) and the grouped collapse of the linear
// step and collapse_select (collapse_f64_kernel, its rows gathered by
// outcome).  wgmma has no fp64 form.  The fp32 and complex64 GEMMs keep a
// plain shared-memory tile with FMA (64x64 output tile, 16-deep k step, 4x4
// outputs per thread): without TF32, which would round otherwise, the card
// has no fp32 tensor-core product.
//
// C interface (loaded with ctypes): each entry launches its kernels on the
// given stream and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int MAX_D = 16;        // largest physical dimension supported
constexpr int THREADS = 256;     // every kernel: 256 threads per block
constexpr int BM = 64;           // GEMM tile rows (samples)
constexpr int BN = 64;           // GEMM tile columns
constexpr int BK = 16;           // GEMM k step
constexpr int TM = 4;            // rows per thread: ty + 16 * i
constexpr int TN = 4;            // columns per thread: tx + 16 * j
constexpr int APAD = BM + 1;     // padded A tile row (store without conflicts)
constexpr int MAX_GRID_Y = 65535;

// shared bytes of the FMA GEMM tiles (sized for double-complex operands)
constexpr int SMEM_BYTES = 2 * (BK * APAD + BK * BN) * 8;

#define RETURN_IF_ERROR()                         \
  do {                                            \
    cudaError_t err_ = cudaGetLastError();        \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// ---------------------------------------------------------------------------
// Block reductions (fixed order: warp shuffles, then the warps' results)
// ---------------------------------------------------------------------------

template <typename T>
__device__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T out = T(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) out += red[w];
  __syncthreads();
  return out;  // valid in thread 0 only
}

template <typename T>
__device__ T block_max(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) {
    T o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T m = red[0];
    for (int w = 1; w < THREADS / 32; ++w) m = red[w] > m ? red[w] : m;
    red[0] = m;
  }
  __syncthreads();
  T out = red[0];
  __syncthreads();
  return out;  // valid in every thread
}

// ---------------------------------------------------------------------------
// bf16 inputs: an operand rounded to bf16 to nearest even -- fp64 through
// fp32, as torch's and XLA's casts round it on the CPU -- then read as the
// sum's type (a product of two bf16 values is exact in fp32).
// ---------------------------------------------------------------------------

__device__ __forceinline__ bf16 to_bf16(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ bf16 to_bf16(double x) {
  return __float2bfloat16_rn(__double2float_rn(x));
}
__device__ __forceinline__ bf16 to_bf16(bf16 x) { return x; }

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same_v<T, bf16>)
    return __float2bfloat16_rn(0.f);
  else
    return T(0);
}

// x as T, rounded to bf16 first when RND
template <typename T, bool RND, typename S>
__device__ __forceinline__ T as(S x) {
  if constexpr (RND)
    return T(__bfloat162float(to_bf16(x)));
  else
    return T(x);
}

template <typename T, bool RND, typename S>
__device__ __forceinline__ T ld(const S* p) {
  return as<T, RND>(*p);
}

// ---------------------------------------------------------------------------
// The draw (Alg. 1 lines 2-4), op for op as draw_from_uniform
// ---------------------------------------------------------------------------

template <typename T>
__device__ int draw(const T* probs, int d, T u) {
  T p[MAX_D];
  T total = T(0);
#pragma unroll
  for (int s = 0; s < MAX_D; ++s)
    if (s < d) {
      p[s] = probs[s] < T(0) ? T(0) : probs[s];   // clip(probs, 0); NaN stays
      total += p[s];
    }
  const T uniform_p = T(1) / T(d);
  T cdf = T(0);
  int count = 0;
#pragma unroll
  for (int s = 0; s < MAX_D; ++s)
    if (s < d) {
      cdf += total > T(0) ? p[s] / total : uniform_p;
      count += u > cdf ? 1 : 0;
    }
  return count < d - 1 ? count : d - 1;
}

// ---------------------------------------------------------------------------
// Linear step 1: W[l, s] = sum_r Gamma[l, r, s] * Lambda[r]   (grid: L)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
measure_weights_kernel(const T* __restrict__ gamma, const T* __restrict__ lam,
                       int R, int d, T* __restrict__ w) {
  __shared__ T red[THREADS / 32];
  const int l = blockIdx.x;
  const T* row = gamma + (size_t)l * R * d;
  T acc[MAX_D];
#pragma unroll
  for (int s = 0; s < MAX_D; ++s) acc[s] = T(0);
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const T lr = lam[r];
    const T* g = row + (size_t)r * d;
#pragma unroll
    for (int s = 0; s < MAX_D; ++s)
      if (s < d) acc[s] += g[s] * lr;
  }
#pragma unroll
  for (int s = 0; s < MAX_D; ++s)
    if (s < d) {
      T tot = block_sum(acc[s], red);
      if (threadIdx.x == 0) w[(size_t)l * d + s] = tot;
    }
}


// Gamma[l, r, :] (d values) of one r into g, zeros where !in: VEC, as
// 16-byte vectors (8 for bf16) where d fills them and the row is aligned
template <typename TG> struct RVec;
template <> struct RVec<float> {
  using V = float4;
  static constexpr int N = 4;
  __device__ static float at(const V& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <> struct RVec<double> {
  using V = double2;
  static constexpr int N = 2;
  __device__ static double at(const V& v, int i) { return i == 0 ? v.x : v.y; }
};
template <> struct RVec<bf16> {
  using V = uint2;
  static constexpr int N = 4;
  __device__ static bf16 at(const V& v, int i) {
    const uint32_t word = i < 2 ? v.x : v.y;
    return __ushort_as_bfloat16((unsigned short)(word >> (16 * (i & 1))));
  }
};

template <typename TG, int DB, bool VEC>
__device__ __forceinline__ void load_r(TG (&g)[DB], const TG* __restrict__ p,
                                       int d, bool in) {
  using RV = RVec<TG>;
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < DB / RV::N; ++q)
      if (q * RV::N < d) {
        typename RV::V v{};
        if (in) v = reinterpret_cast<const typename RV::V*>(p)[q];
#pragma unroll
        for (int i = 0; i < RV::N; ++i) g[q * RV::N + i] = RV::at(v, i);
      }
  } else {
#pragma unroll
    for (int s = 0; s < DB; ++s)
      if (s < d) g[s] = in ? p[s] : zero_of<TG>();
  }
}

// the bf16 step's W pass: W[l, s] = sum_r bf16(Gamma[l, r, s]) Lambda[r]
// (W itself is not rounded), and the rounded values written out as Gamma's
// bf16 planes (d, L, ldp): plane s holds them contiguous along r, rows
// padded with zeros to ldp, the B operands of the bf16 grouped collapse.  Bound by
// Gamma's bytes read and the planes' written.  A warp takes 64 neighbouring
// r at a time, lane i the r of 64 w + i and 64 w + 32 + i, each read as
// vectors of its d values (neighbouring lanes, neighbouring bytes); a plane
// is then written as 4-byte pairs of neighbouring r, exchanged between
// lanes by shuffles (128 bytes a warp's store).  DB bounds d at compile
// time (4: the GBS cutoff, or MAX_D), so that d <= 4 holds few registers
// and keeps U windows of loads in flight a warp: with one window and
// arrays of MAX_D the pass waited on its loads, at 2.2 TB/s (fp32 Gamma)
// and 1.3 TB/s (bf16) where Gamma.to(bf16) moves the same bytes at 3.0
// (PERF.md section 6).  Without MEASURE it writes the planes alone (lam
// and w unused): collapse_select's bf16 entry, whose caller drew already.
template <typename T, typename TG, int DB, bool VEC, bool MEASURE = true>
__global__ void __launch_bounds__(THREADS)
weights_planes_kernel(const TG* __restrict__ gamma,
                      const T* __restrict__ lam, int R, int d,
                      T* __restrict__ w, bf16* __restrict__ planes,
                      int ldp) {
  constexpr int U = DB <= 4 ? 4 : 1;            // windows in flight a warp
  constexpr int STEP = 64 * (THREADS / 32);     // a block's r a window
  __shared__ T red[THREADS / 32];
  const int l = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TG* row = gamma + (size_t)l * R * d;
  const int src = (2 * lane) & 31;   // holds r 2 lane and 2 lane + 1 of 64
  T acc[DB];
#pragma unroll
  for (int s = 0; s < DB; ++s) acc[s] = T(0);
  for (int r0 = 64 * warp; r0 < ldp; r0 += STEP * U) {
    TG ga[U][DB], gb[U][DB];
    T la[U], lb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ra = r0 + STEP * u + lane, rb = ra + 32;
      load_r<TG, DB, VEC>(ga[u], row + (size_t)ra * d, d, ra < R);
      load_r<TG, DB, VEC>(gb[u], row + (size_t)rb * d, d, rb < R);
      la[u] = MEASURE && ra < R ? lam[ra] : T(0);
      lb[u] = MEASURE && rb < R ? lam[rb] : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rw = r0 + STEP * u;               // the window's first r
#pragma unroll
      for (int s = 0; s < DB; ++s)
        if (s < d) {
          const bf16 a = to_bf16(ga[u][s]), b = to_bf16(gb[u][s]);
          if constexpr (MEASURE) {
            acc[s] += T(__bfloat162float(a)) * la[u];
            acc[s] += T(__bfloat162float(b)) * lb[u];
          }
          const uint32_t mine = (uint32_t)__bfloat16_as_ushort(a) |
                                ((uint32_t)__bfloat16_as_ushort(b) << 16);
          const uint32_t x0 = __shfl_sync(0xffffffffu, mine, src);
          const uint32_t x1 = __shfl_sync(0xffffffffu, mine, src + 1);
          const int half = lane < 16 ? 0 : 16;   // a of lanes src.. or b
          const uint32_t pair =
              ((x0 >> half) & 0xffffu) | ((x1 >> half) << 16);
          if (rw + 2 * lane < ldp)
            *reinterpret_cast<uint32_t*>(
                planes + ((size_t)s * gridDim.x + l) * ldp + rw + 2 * lane) =
                pair;
        }
    }
  }
  if constexpr (MEASURE) {
#pragma unroll
    for (int s = 0; s < DB; ++s)
      if (s < d) {
        T tot = block_sum(acc[s], red);
        if (threadIdx.x == 0) w[(size_t)l * d + s] = tot;
      }
  }
}

// ---------------------------------------------------------------------------
// Step 2: per-row probs, then the draw.  One block per sample row.
//   ENV_W:       probs[s] = sum_l env[n, l] * W[l, s]       (linear)
//   TEMP_LINEAR: probs[s] = sum_r temp[n, r, s] * Lambda[r] (linear, TP)
//   TEMP_BORN:   probs[s] = sum_r |temp[n, r, s] * lambda_r|^2
// Sums in T.  ENV_W reads env as TS and W as TW, rounded to bf16 first
// where RND has bit 1 (env) or bit 2 (W) set.
// ---------------------------------------------------------------------------

enum Measure { ENV_W, TEMP_LINEAR, TEMP_BORN };

// probs of row blockIdx.x into probs[0..d) (written by thread 0)
template <typename T, Measure M, typename TS = T, typename TW = T, int RND = 0>
__device__ void row_probs(const TS* __restrict__ src,
                          const TW* __restrict__ w, int L, int d, T* probs,
                          T* red) {
  const int n = blockIdx.x;
  T acc[MAX_D];
#pragma unroll
  for (int s = 0; s < MAX_D; ++s) acc[s] = T(0);
  if constexpr (M == TEMP_BORN) {
    // src: temp (N, L, d) complex, L = chi_r here; w: lambda (L)
    const T* row = src + (size_t)n * L * d * 2;
    for (int r = threadIdx.x; r < L; r += THREADS) {
      const T lr = w[r];
      const T* t = row + (size_t)r * d * 2;
#pragma unroll
      for (int s = 0; s < MAX_D; ++s)
        if (s < d) {
          const T vr = t[2 * s] * lr, vi = t[2 * s + 1] * lr;
          acc[s] += vr * vr + vi * vi;
        }
    }
  } else if constexpr (M == TEMP_LINEAR) {
    // src: temp (N, L, d) real, L = chi_r here; w: Lambda (L)
    const T* row = src + (size_t)n * L * d;
    for (int r = threadIdx.x; r < L; r += THREADS) {
      const T lr = w[r];
      const T* t = row + (size_t)r * d;
#pragma unroll
      for (int s = 0; s < MAX_D; ++s)
        if (s < d) acc[s] += t[s] * lr;
    }
  } else {
    // src: env (N, L); w: the (L, d) measure weights
    const TS* e = src + (size_t)n * L;
    for (int l = threadIdx.x; l < L; l += THREADS) {
      const T el = ld<T, (RND & 1) != 0>(e + l);
#pragma unroll
      for (int s = 0; s < MAX_D; ++s)
        if (s < d) acc[s] += el * ld<T, (RND & 2) != 0>(w + (size_t)l * d + s);
    }
  }
#pragma unroll
  for (int s = 0; s < MAX_D; ++s)
    if (s < d) {
      T tot = block_sum(acc[s], red);
      if (threadIdx.x == 0) probs[s] = tot;
    }
}

template <typename T, Measure M, typename TS = T, typename TW = T, int RND = 0>
__global__ void __launch_bounds__(THREADS)
probs_draw_kernel(const TS* __restrict__ src, const TW* __restrict__ w,
                  const T* __restrict__ u, int L, int d,
                  int32_t* __restrict__ samples) {
  __shared__ T red[THREADS / 32];
  __shared__ T probs[MAX_D];
  row_probs<T, M, TS, TW, RND>(src, w, L, d, probs, red);
  if (threadIdx.x == 0) samples[blockIdx.x] = draw(probs, d, u[blockIdx.x]);
}

// the same probs written out (N, d): no draw
template <typename T, Measure M>
__global__ void __launch_bounds__(THREADS)
probs_kernel(const T* __restrict__ src, const T* __restrict__ w, int L, int d,
             T* __restrict__ out) {
  __shared__ T red[THREADS / 32];
  __shared__ T probs[MAX_D];
  row_probs<T, M>(src, w, L, d, probs, red);
  if (threadIdx.x == 0)
    for (int s = 0; s < d; ++s) out[(size_t)blockIdx.x * d + s] = probs[s];
}

// ---------------------------------------------------------------------------
// measure_probs: probs (N, d) = env (N, L) . W (L, d), summed in T; env as
// TS and W rounded to bf16 first where RND has bit 1 (env) or bit 2 (W)
// set.  Bound by env's bytes (W is d columns).  A block takes RB = 32 / DB
// rows (DB: d rounded up to 4, 8 or 16, so that a thread keeps RB x DB = 32
// sums) and stages W through shared memory once for all of them, transposed
// to [s][l] in chunks of LC = WORDS / DB l's.  Its threads walk l with
// 16-byte loads of env (VEC: the rows are 16-byte aligned; else one element
// at a time), each load of W from shared memory serving the RB rows.  The
// sums are then reduced in a fixed order, a shuffle tree in each warp and
// the warps' results in warp order: no atomics, runs repeat bit for bit.
// ---------------------------------------------------------------------------

namespace mp {
constexpr int WORDS = 5120;     // W chunk in shared memory, elements of T
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int DB, typename TS, int RND, bool VEC>
__global__ void __launch_bounds__(THREADS)
measure_probs_kernel(const TS* __restrict__ env, const TS* __restrict__ w,
                     int n, int L, int d, T* __restrict__ out) {
  constexpr int RB = 32 / DB;                    // rows of the block
  constexpr int VW = VEC ? 16 / (int)sizeof(TS) : 1;   // env elements a load
  constexpr int LC = mp::WORDS / DB;             // l's of a chunk
  static_assert(LC % 4 == 0, "whole vectors in a chunk");
  __shared__ __align__(16) T ws[mp::WORDS];
  __shared__ T red[THREADS / 32][32];
  const int r0 = blockIdx.x * RB;
  T acc[RB][DB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int s = 0; s < DB; ++s) acc[r][s] = T(0);

  for (int l0 = 0; l0 < L; l0 += LC) {
    const int lc = L - l0 < LC ? L - l0 : LC;
    __syncthreads();                             // the last chunk is used
    for (int l = threadIdx.x; l < lc; l += THREADS) {
      const TS* wl = w + (size_t)(l0 + l) * d;
#pragma unroll
      for (int s = 0; s < DB; ++s)
        if (s < d) ws[s * LC + l] = ld<T, (RND & 2) != 0>(wl + s);
    }
    __syncthreads();
    for (int l = threadIdx.x * VW; l < lc; l += THREADS * VW) {
      Vec<TS, VW> e[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r0 + r < n) {
          e[r] = *reinterpret_cast<const Vec<TS, VW>*>(
              env + (size_t)(r0 + r) * L + l0 + l);
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j) e[r].v[j] = TS(0);
        }
      }
#pragma unroll
      for (int s = 0; s < DB; ++s) {
        if (s >= d) break;
        const Vec<T, VW> wv = *reinterpret_cast<const Vec<T, VW>*>(
            ws + s * LC + l);
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int j = 0; j < VW; ++j)
            acc[r][s] += as<T, (RND & 1) != 0>(e[r].v[j]) * wv.v[j];
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int s = 0; s < DB; ++s) {
      T v = acc[r][s];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][r * DB + s] = v;
    }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int r = threadIdx.x / DB, s = threadIdx.x % DB;
    T tot = T(0);
    for (int wp = 0; wp < THREADS / 32; ++wp) tot += red[wp][threadIdx.x];
    if (r0 + r < n && s < d) out[(size_t)(r0 + r) * d + s] = tot;
  }
}

template <typename T, int DB, typename TS, int RND>
int measure_probs_db(const TS* env, const TS* w, T* probs, int n, int L,
                     int d, cudaStream_t stream) {
  constexpr int RB = 32 / DB;
  const int blocks = (n + RB - 1) / RB;
  const bool vec = (size_t)L * sizeof(TS) % 16 == 0 && (uintptr_t)env % 16 == 0;
  if (vec)
    measure_probs_kernel<T, DB, TS, RND, true>
        <<<blocks, THREADS, 0, stream>>>(env, w, n, L, d, probs);
  else
    measure_probs_kernel<T, DB, TS, RND, false>
        <<<blocks, THREADS, 0, stream>>>(env, w, n, L, d, probs);
  return (int)cudaGetLastError();
}

template <typename T, typename TS, int RND>
int measure_probs_launch(const TS* env, const TS* w, T* probs, int n, int L,
                         int d, cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  if (d <= 4) return measure_probs_db<T, 4, TS, RND>(env, w, probs, n, L, d,
                                                     stream);
  if (d <= 8) return measure_probs_db<T, 8, TS, RND>(env, w, probs, n, L, d,
                                                     stream);
  return measure_probs_db<T, 16, TS, RND>(env, w, probs, n, L, d, stream);
}

// ---------------------------------------------------------------------------
// Step 3: stable counting sort of rows by outcome (one block).
// meta: [count[d], offset[d], tile_start[d], total_tiles], in tiles of bm
// rows (the collapse GEMM's).  Rows whose outcome is outside [0, d) join no
// group: they come last in perm (in order), which is then a permutation of
// all n rows.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
bucket_kernel(const int32_t* __restrict__ samples, int n, int d, int bm,
              int32_t* __restrict__ perm, int32_t* __restrict__ meta) {
  __shared__ int cnt[THREADS][MAX_D + 1];   // slot d: rows of no group
  const int t = threadIdx.x;
  const int chunk = (n + THREADS - 1) / THREADS;
  const int lo = t * chunk < n ? t * chunk : n;
  const int hi = lo + chunk < n ? lo + chunk : n;
  for (int s = 0; s <= d; ++s) cnt[t][s] = 0;
  for (int i = lo; i < hi; ++i) {
    const int s = samples[i];
    cnt[t][s >= 0 && s < d ? s : d] += 1;
  }
  __syncthreads();
  if (t == 0) {
    int base = 0, tiles = 0;
    for (int s = 0; s <= d; ++s) {
      int tot = 0;
      for (int tt = 0; tt < THREADS; ++tt) {
        const int c = cnt[tt][s];
        cnt[tt][s] = base + tot;
        tot += c;
      }
      if (s == d) break;
      meta[s] = tot;
      meta[d + s] = base;
      meta[2 * d + s] = tiles;
      base += tot;
      tiles += (tot + bm - 1) / bm;
    }
    meta[3 * d] = tiles;
  }
  __syncthreads();
  for (int i = lo; i < hi; ++i) {
    const int s = samples[i];
    perm[cnt[t][s >= 0 && s < d ? s : d]++] = i;
  }
}

// ---------------------------------------------------------------------------
// The shared-memory GEMM main loop: acc[m][c] = sum_k A[row(m), k] * B(k, c)
// A is env (N, L), rows given per tile; B(k, c) is Gamma at
// bofs + k * ldb + c * bstride (in elements; complex elements interleaved).
// ---------------------------------------------------------------------------

template <typename T, bool CPLX>
__device__ void gemm_tile(const T* __restrict__ env, int L,
                          const int (&arow)[4],
                          const T* __restrict__ gamma, size_t bofs, size_t ldb,
                          int bstride, int c0, int ncols,
                          T* smem, T (&acc_re)[TM][TN], T (&acc_im)[TM][TN]) {
  constexpr int CW = CPLX ? 2 : 1;
  T* a_re = smem;
  T* b_re = a_re + BK * APAD;
  T* a_im = b_re + BK * BN;
  T* b_im = a_im + BK * APAD;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc_re[i][j] = acc_im[i][j] = T(0);

  for (int k0 = 0; k0 < L; k0 += BK) {
    // A tile (BM x BK): thread loads rows ty + 16 e at column tx
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = ty + 16 * e, gk = k0 + tx;
      T vr = T(0), vi = T(0);
      if (arow[e] >= 0 && gk < L) {
        const size_t off = ((size_t)arow[e] * L + gk) * CW;
        vr = env[off];
        if constexpr (CPLX) vi = env[off + 1];
      }
      a_re[tx * APAD + m] = vr;
      if constexpr (CPLX) a_im[tx * APAD + m] = vi;
    }
    // B tile (BK x BN): thread loads k = t/64 + 4 e at column t % 64
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = (t >> 6) + 4 * e, c = t & 63;
      const int gk = k0 + k, gc = c0 + c;
      T vr = T(0), vi = T(0);
      if (gk < L && gc < ncols) {
        const size_t off = (bofs + (size_t)gk * ldb + (size_t)gc * bstride) * CW;
        vr = gamma[off];
        if constexpr (CPLX) vi = gamma[off + 1];
      }
      b_re[k * BN + c] = vr;
      if constexpr (CPLX) b_im[k * BN + c] = vi;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T ar[TM], br[TN], ai[TM], bi[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ar[i] = a_re[k * APAD + ty + 16 * i];
        if constexpr (CPLX) ai[i] = a_im[k * APAD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        br[j] = b_re[k * BN + tx + 16 * j];
        if constexpr (CPLX) bi[j] = b_im[k * BN + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_re[i][j] += ar[i] * br[j];
          if constexpr (CPLX) {
            acc_re[i][j] -= ai[i] * bi[j];
            acc_im[i][j] += ar[i] * bi[j];
            acc_im[i][j] += ai[i] * br[j];
          }
        }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Linear step 4 in fp32: the collapse, a GEMM grouped by drawn outcome (fp64
// runs collapse_f64_kernel, below).  grid.x: row tiles over the outcome
// groups (fastest, so the blocks in flight share Gamma's column panel in
// L2); grid.y: column tiles over R.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
collapse_kernel(const T* __restrict__ env, const T* __restrict__ gamma, int L,
                int R, int d, const int32_t* __restrict__ perm,
                const int32_t* __restrict__ meta, T* __restrict__ out) {
  __shared__ __align__(16) unsigned char smem_raw[SMEM_BYTES];
  const int bx = blockIdx.x;
  if (bx >= meta[3 * d]) return;
  int s = 0;
  for (int q = 0; q < d; ++q)
    if (meta[q] > 0 && meta[2 * d + q] <= bx) s = q;
  const int count = meta[s], offset = meta[d + s];
  const int r0 = (bx - meta[2 * d + s]) * BM;   // first row of this tile
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  int arow[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = r0 + ty + 16 * e;
    arow[e] = i < count ? perm[offset + i] : -1;
  }
  const int c0 = blockIdx.y * BN;
  T acc_re[TM][TN], acc_im[TM][TN];
  gemm_tile<T, false>(env, L, arow, gamma, (size_t)s, (size_t)R * d, d, c0, R,
                      reinterpret_cast<T*>(smem_raw), acc_re, acc_im);
  // rows: the thread loaded rows ty + 16 e, and owns outputs ty + 16 i
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (arow[i] < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < R) out[(size_t)arow[i] * R + c] = acc_re[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// The complex64 Born step 1 and the fp32 contract_measure: temp = env . Gamma
// over columns c = r * d + s, written out.  grid.x: row tiles; grid.y:
// column tiles.
// ---------------------------------------------------------------------------

template <typename T, bool CPLX>
__global__ void __launch_bounds__(THREADS)
contract_kernel(const T* __restrict__ env, const T* __restrict__ gamma, int n,
                int L, int ncols, T* __restrict__ temp) {
  __shared__ __align__(16) unsigned char smem_raw[SMEM_BYTES];
  constexpr int CW = CPLX ? 2 : 1;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  int arow[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = r0 + ty + 16 * e;
    arow[e] = row < n ? row : -1;
  }
  T acc_re[TM][TN], acc_im[TM][TN];
  gemm_tile<T, CPLX>(env, L, arow, gamma, 0, (size_t)ncols, 1, c0, ncols,
                     reinterpret_cast<T*>(smem_raw), acc_re, acc_im);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    if (arow[i] < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c >= ncols) continue;
      const size_t off = ((size_t)arow[i] * ncols + c) * CW;
      temp[off] = acc_re[i][j];
      if constexpr (CPLX) temp[off + 1] = acc_im[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// The fp64 GEMMs on the fp64 tensor cores: temp (n, ncols) = env (n, L) .
// Gamma (L, ncols), both row-major, real (contract_measure's fp64 GEMM,
// contract_f64_kernel) or complex128 with (re, im) interleaved (the Born
// step's contraction, contract_c128_kernel).  mma.sync m16n8k8 .f64 (DMMA);
// a block computes a BM x BN tile, each warp a WM x WN part of it as
// (WM/16) x (WN/8) accumulators (two, re and im, when complex); env and
// Gamma tiles come in by cp.async into a ring of STAGES, so the next tiles'
// copies overlap this tile's products.  A complex multiply-add is the
// reference's four real products (_born_kernel, mm(ere, gre) - mm(eim, gim)
// and mm(ere, gim) + mm(eim, gre)) on the tensor cores:
//   acc_re += a_re . b_re + (-a_im) . b_im
//   acc_im += a_re . b_im + a_im . b_re
// with a_im negated in registers (exact); not the 3M form, which rounds
// otherwise.  Each fragment feeds two products, so a complex tile moves half
// the shared-memory bytes per product of a real one.  Every output adds its
// k terms in one fixed order (no atomics, no split k): runs repeat bit for
// bit.
// ---------------------------------------------------------------------------

// The block, k and warp tiles, the ring depth and the blocks an SM must
// hold on the 16-byte path (MINB, which caps a thread's registers at
// 65536 / (MINB x threads)): BM, BN, BK, STAGES, WM, WN, MINB, of the real
// GEMM, of the complex GEMM and of the grouped collapse.  A file that
// defines FASTMPS_DMMA_TILE, FASTMPS_DMMA_C128_TILE or
// FASTMPS_DMMA_COLLAPSE_TILE and then includes this one builds another
// tile (scripts/tile_sweep.py).  The real tiles ask for two blocks (128
// registers; left to itself the allocator takes more, one block fits and
// the GEMM runs about 1.2x slower); the 8-byte path would spill there and
// keeps one.  The complex tile holds 32 x 16 outputs a warp: at 32 x 32
// its accumulators and fragments pass 255 registers and spill.
#ifndef FASTMPS_DMMA_TILE
#define FASTMPS_DMMA_TILE 128, 64, 16, 3, 32, 32, 2
#endif
#ifndef FASTMPS_DMMA_C128_TILE
#define FASTMPS_DMMA_C128_TILE 64, 64, 16, 3, 32, 16, 1
#endif
#ifndef FASTMPS_DMMA_COLLAPSE_TILE
#define FASTMPS_DMMA_COLLAPSE_TILE 128, 64, 16, 3, 32, 32, 2
#endif

template <bool CPLX_, int BM_, int BN_, int BK_, int STAGES_, int WM_, int WN_,
          int MINB_>
struct DmmaTile {
  static constexpr bool CPLX = CPLX_;
  static constexpr int CW = CPLX ? 2 : 1;         // fp64 words per element
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WM = WM_, WN = WN_;         // warp tile
  static constexpr int MINB = MINB_;
  static constexpr int MI = WM / 16, NJ = WN / 8;  // m16n8 accumulators
  static constexpr int NT = (BM / WM) * (BN / WN) * 32;
  // Rows padded (in elements) so that the lanes of one fragment load hit
  // distinct banks: 8-byte words are served 16 lanes at a time, so real
  // rows are 4 mod 16 words (a fragment's 4 rows x 4 columns fall on 16
  // distinct bank pairs); 16-byte complex elements 8 lanes at a time, so
  // env rows (4 x 2 per phase) are 4 mod 8 elements and Gamma rows
  // (2 columns x 4 k rows) 2 mod 8.
  static constexpr int LDA = BK + 4;               // env tile: BM rows of BK
  static constexpr int LDB = BN + (CPLX ? 2 : 4);  // Gamma tile: BK rows of BN
  static constexpr int STAGE = (BM * LDA + BK * LDB) * CW;   // words
  static constexpr int SMEM_BYTES = STAGES * STAGE * 8;
  static_assert(CPLX ? LDA % 8 == 4 && LDB % 8 == 2
                     : LDA % 16 == 4 && LDB % 16 == 4,
                "conflict-free fragments");
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 8 == 0, "whole fragments");
};
using F64Tile = DmmaTile<false, FASTMPS_DMMA_TILE>;
using C128Tile = DmmaTile<true, FASTMPS_DMMA_C128_TILE>;
using CollapseTile = DmmaTile<false, FASTMPS_DMMA_COLLAPSE_TILE>;

// W words global -> shared (W = 1 or 2); zero-filled when !pred
template <int W>
__device__ __forceinline__ void cp_async_words(uint32_t dst,
                                               const double* src, bool pred) {
  const int n = pred ? 8 * W : 0;
  if constexpr (W == 2)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
}

// c (16 x 8) += a (16 x 8, row) . b (8 x 8, col), mma.sync m16n8k8.  Lane
// (g, t) = (lane / 4, lane % 4) holds a[e] = A[g + 8 (e % 2)][t + 4 (e / 2)],
// b[e] = B[t + 4 e][g], and c[e] = C[g + 8 (e / 2)][2 t + e % 2].
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// one stage: env rows x k [k0, k0 + BK) and Gamma k rows [k0, k0 + BK) x
// columns [c0, c0 + BN); out of range -> 0.  Copies are of words, WA of env
// and WB of Gamma at a time: 2 is 16 bytes (one complex element, or two real
// ones where the row is of even length), from 16-byte aligned operands.
// Dense (!GATHER): env rows r0 + r below n, Gamma (L, ncols) row-major.
// GATHER (real): env row rows[r], an index list in shared memory (-1: none),
// and B(k, c) = gamma[(k * ncols + c) * cs] (cs 1 where WB is 2).
template <class TL, int WA, int WB, bool GATHER>
__device__ __forceinline__ void dmma_load(double* As, double* Bs,
                                          const double* __restrict__ env,
                                          const double* __restrict__ gamma,
                                          int n, int L, int ncols, int r0,
                                          int c0, int k0, const int* rows,
                                          int cs) {
  constexpr int CW = TL::CW;
  constexpr int ACH = TL::BK * CW / WA, BCH = TL::BN * CW / WB;  // per row
  constexpr int NT = TL::NT;
  static_assert(!(GATHER && TL::CPLX), "gathered operands are real");
  static_assert(TL::BM * ACH % NT == 0 && TL::BK * BCH % NT == 0,
                "whole copies");
#pragma unroll
  for (int it = 0; it < TL::BM * ACH / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    const int r = idx / ACH, kw = (idx % ACH) * WA;   // word in the row
    if constexpr (GATHER) {
      const int row = rows[r], k = k0 + kw;
      const bool ok = row >= 0 && k < L;
      cp_async_words<WA>(smem_addr(As + r * TL::LDA + kw),
                         ok ? env + (size_t)row * L + k : env, ok);
    } else {
      const int row = r0 + r, k = k0 + kw / CW;
      const bool ok = row < n && k < L;
      cp_async_words<WA>(smem_addr(As + r * TL::LDA * CW + kw),
                         ok ? env + ((size_t)row * L + k) * CW + kw % CW
                            : env,
                         ok);
    }
  }
#pragma unroll
  for (int it = 0; it < TL::BK * BCH / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    const int kr = idx / BCH, cw = (idx % BCH) * WB;
    const int k = k0 + kr, col = c0 + cw / CW;
    const bool ok = k < L && col < ncols;
    if constexpr (GATHER)
      cp_async_words<WB>(
          smem_addr(Bs + kr * TL::LDB + cw),
          ok ? gamma + ((size_t)k * ncols + col) * (WB == 2 ? 1 : cs) : gamma,
          ok);
    else
      cp_async_words<WB>(smem_addr(Bs + kr * TL::LDB * CW + cw),
                         ok ? gamma + ((size_t)k * ncols + col) * CW + cw % CW
                            : gamma,
                         ok);
  }
}

// element idx of a stage's tile into v[0] (re) and, complex, v[1] (im)
template <class TL>
__device__ __forceinline__ void dmma_frag(const double* tile, int idx,
                                          double& re, double& im) {
  if constexpr (TL::CPLX) {
    const double2 v = reinterpret_cast<const double2*>(tile)[idx];
    re = v.x;
    im = v.y;
  } else {
    re = tile[idx];
  }
}

// The block's tile at (r0, c0): acc[0] the real parts, acc[1] the
// imaginary ones (complex only).  Operands as dmma_load's.
template <class TL, int WA, int WB, bool GATHER = false>
__device__ __forceinline__ void dmma_gemm(
    const double* __restrict__ env, const double* __restrict__ gamma, int n,
    int L, int ncols, int r0, int c0, double* sm,
    double (&acc)[TL::CW][TL::MI][TL::NJ][4], const int* rows = nullptr,
    int cs = 0) {
  constexpr int BM = TL::BM, BK = TL::BK, STAGES = TL::STAGES;
  constexpr int MI = TL::MI, NJ = TL::NJ, CW = TL::CW;
  constexpr int LDA = TL::LDA, LDB = TL::LDB, STAGE = TL::STAGE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp % (BM / TL::WM)) * TL::WM;
  const int wn = (warp / (BM / TL::WM)) * TL::WN;
  const int n_k = (L + BK - 1) / BK;
  // gathered rows come first in a tile, -1 after: a fragment whose first
  // row is -1 is padding, and its products are skipped
  bool live[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) live[i] = !GATHER || rows[wm + 16 * i] >= 0;
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][i][j][e] = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k)
      dmma_load<TL, WA, WB, GATHER>(sm + s * STAGE,
                                    sm + s * STAGE + BM * LDA * CW, env,
                                    gamma, n, L, ncols, r0, c0, s * BK, rows,
                                    cs);
    cp_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();         // ... for every thread; tile kt - 1 is consumed
    const int nxt = kt + STAGES - 1;
    if (nxt < n_k) {
      double* st = sm + (nxt % STAGES) * STAGE;
      dmma_load<TL, WA, WB, GATHER>(st, st + BM * LDA * CW, env, gamma, n, L,
                                    ncols, r0, c0, nxt * BK, rows, cs);
    }
    cp_commit();
    const double* As = sm + (kt % STAGES) * STAGE;
    const double* Bs = As + BM * LDA * CW;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      double a[CW][MI][4], b[CW][NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dmma_frag<TL>(As, (wm + 16 * i + g + 8 * (e % 2)) * LDA + kk + t4
                                + 4 * (e / 2),
                        a[0][i][e], a[CW - 1][i][e]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dmma_frag<TL>(Bs, (kk + t4 + 4 * e) * LDB + wn + 8 * j + g,
                        b[0][j][e], b[CW - 1][j][e]);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if constexpr (GATHER)
          if (!live[i]) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_f64(acc[0][i][j], a[0][i], b[0][j]);
      }
      if constexpr (TL::CPLX) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            mma_f64(acc[1][i][j], a[0][i], b[1][j]);
            mma_f64(acc[1][i][j], a[1][i], b[0][j]);
          }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[1][i][e] = -a[1][i][e];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_f64(acc[0][i][j], a[1][i], b[1][j]);
      }
    }
  }
}

// the block's outputs: temp[row, col] (complex: its (re, im) pair), rows
// r0 + m below n, or (GATHER) rows[m] where it is not -1
template <class TL, bool GATHER = false>
__device__ __forceinline__ void dmma_store(
    const double (&acc)[TL::CW][TL::MI][TL::NJ][4], int n, int ncols, int r0,
    int c0, double* __restrict__ temp, const int* rows = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp % (TL::BM / TL::WM)) * TL::WM;
  const int wn = (warp / (TL::BM / TL::WM)) * TL::WN;
#pragma unroll
  for (int i = 0; i < TL::MI; ++i)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int m = wm + 16 * i + g + 8 * (e / 2);
      const int row = GATHER ? rows[m] : r0 + m;
      if (GATHER ? row < 0 : row >= n) continue;
#pragma unroll
      for (int j = 0; j < TL::NJ; ++j) {
        const int col = c0 + wn + 8 * j + 2 * t4;
        if constexpr (TL::CPLX) {
          double2* o = reinterpret_cast<double2*>(temp) +
                       (size_t)row * ncols + col;
          if (col < ncols)
            o[0] = make_double2(acc[0][i][j][e], acc[1][i][j][e]);
          if (col + 1 < ncols)
            o[1] = make_double2(acc[0][i][j][e + 1], acc[1][i][j][e + 1]);
        } else {
          double* o = temp + (size_t)row * ncols + col;
          if (col < ncols) o[0] = acc[0][i][j][e];
          if (col + 1 < ncols) o[1] = acc[0][i][j][e + 1];
        }
      }
    }
}

template <class TL, bool VEC>
__device__ __forceinline__ void dmma_contract(const double* __restrict__ env,
                                              const double* __restrict__ gamma,
                                              int n, int L, int ncols,
                                              double* __restrict__ temp,
                                              double* sm) {
  const int r0 = blockIdx.x * TL::BM, c0 = blockIdx.y * TL::BN;
  double acc[TL::CW][TL::MI][TL::NJ][4];
  dmma_gemm<TL, VEC ? 2 : 1, VEC ? 2 : 1>(env, gamma, n, L, ncols, r0, c0, sm,
                                          acc);
  dmma_store<TL>(acc, n, ncols, r0, c0, temp);
}

// contract_measure's fp64 GEMM
template <bool VEC>
__global__ void __launch_bounds__(F64Tile::NT, VEC ? F64Tile::MINB : 1)
contract_f64_kernel(const double* __restrict__ env,
                    const double* __restrict__ gamma, int n, int L, int ncols,
                    double* __restrict__ temp) {
  extern __shared__ __align__(16) unsigned char dmma_smem[];
  dmma_contract<F64Tile, VEC>(env, gamma, n, L, ncols, temp,
                              reinterpret_cast<double*>(dmma_smem));
}

// the Born step's complex128 contraction (operands and temp interleaved)
template <bool VEC>
__global__ void __launch_bounds__(C128Tile::NT, VEC ? C128Tile::MINB : 1)
contract_c128_kernel(const double* __restrict__ env,
                     const double* __restrict__ gamma, int n, int L,
                     int ncols, double* __restrict__ temp) {
  extern __shared__ __align__(16) unsigned char dmma_smem[];
  dmma_contract<C128Tile, VEC>(env, gamma, n, L, ncols, temp,
                               reinterpret_cast<double*>(dmma_smem));
}

using DmmaKernel = void (*)(const double*, const double*, int, int, int,
                            double*);

// grid.x: row tiles (fastest, so the blocks in flight share Gamma's column
// panel in L2); grid.y: column tiles
template <class TL>
int dmma_launch(DmmaKernel kernel, const double* env, const double* gamma,
                int n, int L, int ncols, double* temp, cudaStream_t stream) {
  const dim3 grid((n + TL::BM - 1) / TL::BM, (ncols + TL::BN - 1) / TL::BN);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, TL::NT, TL::SMEM_BYTES, stream>>>(env, gamma, n, L, ncols,
                                                    temp);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

int contract_f64(const double* env, const double* gamma, int n, int L,
                 int ncols, double* temp, cudaStream_t stream) {
  const bool vec = L % 2 == 0 && ncols % 2 == 0 && aligned16(env) &&
                   aligned16(gamma);
  return dmma_launch<F64Tile>(
      vec ? contract_f64_kernel<true> : contract_f64_kernel<false>, env,
      gamma, n, L, ncols, temp, stream);
}

// n, L, ncols in complex elements; temp 16-byte aligned (the wrapper's)
int contract_c128(const double* env, const double* gamma, int n, int L,
                  int ncols, double* temp, cudaStream_t stream) {
  const bool vec = aligned16(env) && aligned16(gamma);
  return dmma_launch<C128Tile>(
      vec ? contract_c128_kernel<true> : contract_c128_kernel<false>, env,
      gamma, n, L, ncols, temp, stream);
}

// ---------------------------------------------------------------------------
// The fp64 grouped collapse on the fp64 tensor cores (the linear step's and
// collapse_select's): env'[n, :] = env[n, :] . Gamma_s for the rows n of
// each outcome group s, by the DMMA main loop above with A's rows gathered
// through the bucket sort's perm (staged once in shared memory, a group's
// rows spread evenly over its row tiles; -1 past them, zero-filled, not
// stored, their 16-row fragments' products skipped) and B(k, c) =
// Gamma[k, c, s], read as it lies: column stride d, a word at a time
// (8-byte cp.async; 16 bytes where d = 1), so that each word costs its whole
// 32-byte sector from L2 (at d = 4, four times the bytes of a contiguous
// B).  A (d, L, R) copy of Gamma's planes would make B contiguous, but
// writing it costs more than it saves (PERF.md §6).  grid.x: the
// groups' row tiles (fastest, so that the row tiles of one column panel run
// together and share it in L2); grid.y: column tiles.  VA, VB: 16-byte
// copies of env (L even, env aligned) and of Gamma (d = 1, R even, aligned).
// ---------------------------------------------------------------------------

template <bool VA, bool VB>
__global__ void __launch_bounds__(CollapseTile::NT,
                                  VA ? CollapseTile::MINB : 1)
collapse_f64_kernel(const double* __restrict__ env,
                    const double* __restrict__ gamma, int L, int R, int d,
                    const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ meta,
                    double* __restrict__ out) {
  using TL = CollapseTile;
  extern __shared__ __align__(16) unsigned char dmma_smem[];
  __shared__ int rows[TL::BM];
  const int bx = blockIdx.x;
  if (bx >= meta[3 * d]) return;
  int s = 0;
  for (int q = 0; q < d; ++q)
    if (meta[q] > 0 && meta[2 * d + q] <= bx) s = q;
  const int count = meta[s], offset = meta[d + s];
  // the group's rows spread evenly over its row tiles, h a tile: tiles of a
  // group's last few rows alone, which skip most of their products, slowed
  // the whole collapse by a third on a walk's draws (PERF.md §6)
  const int tiles = (count + TL::BM - 1) / TL::BM;
  const int h = (count + tiles - 1) / tiles;
  const int r0 = (bx - meta[2 * d + s]) * h;   // first row of the tile
  for (int m = threadIdx.x; m < TL::BM; m += TL::NT)
    rows[m] = m < h && r0 + m < count ? perm[offset + r0 + m] : -1;
  __syncthreads();
  const int c0 = blockIdx.y * TL::BN;
  double acc[1][TL::MI][TL::NJ][4];
  dmma_gemm<TL, VA ? 2 : 1, VB ? 2 : 1, true>(
      env, gamma + s, 0, L, R, 0, c0, reinterpret_cast<double*>(dmma_smem),
      acc, rows, d);
  dmma_store<TL, true>(acc, 0, R, 0, c0, out, rows);
}

using CollapseKernel = void (*)(const double*, const double*, int, int, int,
                                const int32_t*, const int32_t*, double*);

// after bucket_kernel with CollapseTile::BM
int collapse_f64(const double* env, const double* gamma, const int32_t* perm,
                 const int32_t* meta, int n, int L, int R, int d, double* out,
                 cudaStream_t stream) {
  using TL = CollapseTile;
  const dim3 grid((n + TL::BM - 1) / TL::BM + d, (R + TL::BN - 1) / TL::BN);
  if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
  const bool va = L % 2 == 0 && aligned16(env);
  const bool vb = d == 1 && R % 2 == 0 && aligned16(gamma);
  const CollapseKernel kernel =
      va ? (vb ? collapse_f64_kernel<true, true>
               : collapse_f64_kernel<true, false>)
         : (vb ? collapse_f64_kernel<false, true>
               : collapse_f64_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, TL::NT, TL::SMEM_BYTES, stream>>>(env, gamma, L, R, d, perm,
                                                    meta, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 GEMMs on wgmma fed by TMA (kernels 1 and 3 in bf16): out = A . B with
// A a bf16 env (rows, L) and B a bf16 (L, columns) matrix, both prepared in
// device memory (below), fp32 sums in registers.  Bound by bf16 operations
// at the full width (2 N chi^2, 0.2 ms at 989 TFLOP/s): the GEMM has to run
// near the tensor cores' rate, which only wgmma reaches.
//
// A block of 384 threads computes 128 x BN tiles over k steps of BK = 64:
// warpgroup 0 is the producer, one thread of which keeps a ring of STAGES
// shared-memory stages filled by TMA (A as a 64 x 128 box, B as BN / 64
// boxes of 64 x 64, each row 128 bytes, 128-byte swizzled), each stage's
// "full" mbarrier counting its bytes; warpgroups 1 and 2 are the consumers,
// each 64 rows of the tile, issuing four wgmma.m64nBNk16 a stage (A
// K-major, B MN-major: wgmma's transpose bit), then releasing the stage
// before on its "empty" mbarrier (one arrival a consumer) once the products
// reading it have completed (wgmma.wait_group 1), so that one stage's
// products overlap the next stage's wait.  setmaxnreg moves registers from
// the producer (40) to the consumers (232): BN = 256 holds 128 fp32
// accumulators a thread.  Tails of K, of the columns and of the rows are
// zero-filled by TMA's out-of-bounds fill: the tensor maps carry the true
// extents, the padded strides only align rows to 16 bytes, as TMA needs.
// Each output adds its K terms in one fixed order (no split-K, no atomics),
// so two calls give the same bits.  The epilogue stages each consumer's
// outputs through shared memory of its own and stores 16-byte row pieces
// in env's type (wgmma_store).
//
// Dense (contract_measure): row tile bx holds rows 128 bx + m.  COLLAPSE
// (the linear step): A's rows are env's in the bucket sort's order, so that
// an outcome group's rows are one range TMA can copy; the tiles of group s
// are as collapse_f64_kernel's (its rows spread evenly over them) and B is
// Gamma's plane s, a 3-D tensor map; row m of a tile is stored to
// env'[perm[offset + r0 + m]], the rows past the group's unstored.  Tiles
// are numbered row tile fastest, so that the tiles of one column panel run
// together and share B in L2; a block an SM (persistent) takes every
// gridDim.x-th, its ring running on from one tile into the next, so that
// one tile's epilogue overlaps the next one's loads (a tile a block was up
// to 10 % slower, PERF.md section 6).
//
// The tile (BN, STAGES) is FASTMPS_WGMMA_TILE; a file that defines it and
// then includes this one builds another (scripts/tile_sweep.py).
// ---------------------------------------------------------------------------

#ifndef FASTMPS_WGMMA_TILE
#define FASTMPS_WGMMA_TILE 256, 3
#endif

template <int BN_, int STAGES_>
struct WgmmaTile {
  static constexpr int BM = 128, BN = BN_, BK = 64, STAGES = STAGES_;
  static constexpr int NT = 384;                       // 3 warpgroups
  static constexpr int A_BYTES = BM * BK * 2;          // 128 rows x 128 B
  static constexpr int B_BOX = BK * 128;               // 64 x 64 bf16
  static constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * B_BOX;
  // the epilogue's staging, a consumer's 64 rows x 128 bytes of outputs at
  // a time (EC columns of TO), rows padded by 32 bytes (the fp32 pairs a
  // warp writes fall in distinct banks)
  template <typename TO>
  static constexpr int EC = 128 / (int)sizeof(TO);
  template <typename TO>
  static constexpr int LDE = EC<TO> + 32 / (int)sizeof(TO);
  static constexpr int EPI_BYTES = 2 * 64 * 160;
  // the stages, 1024-byte aligned (the swizzle's period), the epilogue's
  // staging, then 2 x STAGES mbarriers
  static constexpr int SMEM_BYTES =
      1024 + STAGES * STAGE_BYTES + EPI_BYTES + 16 * STAGES;
  static_assert(BN == 128 || BN == 256, "a wgmma N of 128 or 256");
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
};
using WgTile = WgmmaTile<FASTMPS_WGMMA_TILE>;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity; a wait of
// more than 2^32 cycles (seconds) traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 32))
      __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: the start address, the
// leading and stride byte offsets (all in 16-byte units).  A, K-major:
// 8-row groups 1024 bytes apart (stride), the leading offset unused.  B,
// MN-major: 64-column boxes B_BOX apart (leading), 8 k rows 1024 bytes
// apart (stride).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define FASTMPS_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FASTMPS_D16(i) \
  FASTMPS_D4(i), FASTMPS_D4(i + 4), FASTMPS_D4(i + 8), FASTMPS_D4(i + 12)

// d (64 x N, fp32, the warpgroup's accumulator layout) += A (64 x 16, bf16,
// K-major) . B (16 x N, bf16, MN-major), from shared memory
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db) {
  static_assert(N == 128 || N == 256, "N");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : FASTMPS_D16(0), FASTMPS_D16(16), FASTMPS_D16(32), FASTMPS_D16(48)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : FASTMPS_D16(0), FASTMPS_D16(16), FASTMPS_D16(32), FASTMPS_D16(48),
          FASTMPS_D16(64), FASTMPS_D16(80), FASTMPS_D16(96), FASTMPS_D16(112)
        : "l"(da), "l"(db), "r"(1));
  }
}
#undef FASTMPS_D16
#undef FASTMPS_D4

// tile t of the GEMM: row tile t % rt (fastest, so that the tiles of one
// column panel run together and share B in L2), column tile t / rt
struct WgmmaTileAt {
  int s = 0, count, offset = 0, h, r0, c0;   // A's first row: offset + r0
};

template <class TL, bool COLLAPSE>
__device__ __forceinline__ WgmmaTileAt wgmma_tile_at(
    int t, int rt, int n, int d, const int32_t* __restrict__ meta) {
  WgmmaTileAt at;
  const int bx = t % rt;
  at.c0 = (t / rt) * TL::BN;
  if constexpr (COLLAPSE) {
    for (int q = 0; q < d; ++q)
      if (meta[q] > 0 && meta[2 * d + q] <= bx) at.s = q;
    at.count = meta[at.s];
    at.offset = meta[d + at.s];
    const int tiles = (at.count + TL::BM - 1) / TL::BM;
    at.h = (at.count + tiles - 1) / tiles;
    at.r0 = (bx - meta[2 * d + at.s]) * at.h;
  } else {
    at.count = n;
    at.h = TL::BM;
    at.r0 = bx * TL::BM;
  }
  return at;
}

// A consumer's 64 x BN outputs to out in TO, through shared memory: EC
// columns at a time are written there from the accumulators (thread (warp
// w, lane l) holds, for each 8-column block j, rows 16 w + l / 4 (+ 8) and
// columns 8 j + 2 (l % 4) (+ 1)), then read back as 16-byte row pieces and
// stored (a 4-byte store an output, straight from the accumulators, cost
// about a quarter of a K = 2500 tile's time).  Rows past the tile's (or the
// group's) are not stored; columns past ncols neither.
template <class TL, bool COLLAPSE, typename TO>
__device__ __forceinline__ void wgmma_store(
    const float (&acc)[TL::BN / 2], const WgmmaTileAt& at, int c, int n,
    int ncols, const int32_t* __restrict__ perm, TO* __restrict__ out,
    uint32_t buf) {
  constexpr int EC = TL::template EC<TO>, LDE = TL::template LDE<TO>;
  constexpr int V = 16 / (int)sizeof(TO);          // a piece's outputs
  const int t = threadIdx.x % 128, lane = t & 31, w = t / 32;
  TO* sbuf = reinterpret_cast<TO*>(__cvta_shared_to_generic(buf));
  // the global rows of this thread's pieces: tile rows 64 c + t / 8 + 16 q
  int rows[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int m = 64 * c + t / 8 + 16 * q;
    if constexpr (COLLAPSE)
      rows[q] = m < at.h && at.r0 + m < at.count
                    ? perm[at.offset + at.r0 + m] : -1;
    else
      rows[q] = at.r0 + m < n ? at.r0 + m : -1;
  }
  const bool vec = ncols % V == 0 && (uintptr_t)out % 16 == 0;
#pragma unroll
  for (int cc = 0; cc < TL::BN / EC; ++cc) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
#pragma unroll
    for (int jj = 0; jj < EC / 8; ++jj) {
      const int j = cc * (EC / 8) + jj;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        TO* p = sbuf + (16 * w + lane / 4 + 8 * hh) * LDE + 8 * jj +
                2 * (lane & 3);
        p[0] = TO(acc[4 * j + 2 * hh]);
        p[1] = TO(acc[4 * j + 2 * hh + 1]);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (rows[q] < 0) continue;
      const int piece = t % 8, col = at.c0 + cc * EC + V * piece;
      const TO* src = sbuf + (t / 8 + 16 * q) * LDE + V * piece;
      TO* dst = out + (size_t)rows[q] * ncols + col;
      if (vec && col + V <= ncols) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (col + e < ncols) dst[e] = src[e];
      }
    }
  }
}

template <class TL, typename TO, bool COLLAPSE>
__global__ void __launch_bounds__(TL::NT, 1)
wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, int n, int L,
                  int ncols, int d, const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ meta, TO* __restrict__ out) {
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, STAGES = TL::STAGES;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023) & ~1023u;
  const uint32_t epi = base + STAGES * TL::STAGE_BYTES;
  const uint32_t bars = epi + TL::EPI_BYTES;
  // full[st] at bars + 8 st, empty[st] at bars + 8 (STAGES + st); the ring
  // position it (k steps over this block's tiles so far) is at stage
  // it % STAGES in round it / STAGES, whose parity the waits take
  const int rt = COLLAPSE ? meta[3 * d] : (n + BM - 1) / BM;
  const int n_tiles = rt * ((ncols + BN - 1) / BN);
  if ((int)blockIdx.x >= n_tiles) return;
  const int n_k = (L + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bars + 8 * st, 1);                   // the producer
      mbar_init(bars + 8 * (STAGES + st), 2);        // the two consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {   // the producer: one thread
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const WgmmaTileAt at = wgmma_tile_at<TL, COLLAPSE>(t, rt, n, d, meta);
      for (int i = 0; i < n_k; ++i, ++it) {
        const int st = it % STAGES;
        const uint32_t full = bars + 8 * st;
        mbar_wait(bars + 8 * (STAGES + st), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, TL::STAGE_BYTES);
        const uint32_t sa = base + st * TL::STAGE_BYTES;
        tma_load(sa, &map_a, full, i * BK, at.offset + at.r0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j) {
          const uint32_t sb = sa + TL::A_BYTES + j * TL::B_BOX;
          if constexpr (COLLAPSE)
            tma_load(sb, &map_b, full, at.c0 + 64 * j, i * BK, at.s);
          else
            tma_load(sb, &map_b, full, at.c0 + 64 * j, i * BK);
        }
      }
    }
  } else {         // the consumers: rows 64 (wg - 1) .. of each tile
    // what the producer frees: 384 x 168 registers at launch hold 128 x 40
    // + 256 x 232 (an increase beyond what the pool holds waits for ever)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const bool signals = threadIdx.x % 128 == 0;   // one arrival a consumer
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const WgmmaTileAt at = wgmma_tile_at<TL, COLLAPSE>(t, rt, n, d, meta);
      float acc[BN / 2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
      for (int i = 0; i < n_k; ++i, ++it) {
        const int st = it % STAGES;
        mbar_wait(bars + 8 * st, (it / STAGES) & 1);
        const uint32_t sa = base + st * TL::STAGE_BYTES + (wg - 1) * 64 * 128;
        const uint32_t sb = base + st * TL::STAGE_BYTES + TL::A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)   // 16 k: 32 bytes of A's rows,
          wgmma_bf16<BN>(acc, gmma_desc(sa + 32 * kk, 16, 1024),  // 16 of B's
                         gmma_desc(sb + 2048 * kk, TL::B_BOX, 1024));
        wgmma_commit();
        wgmma_wait<1>();                       // position it - 1 is read
        if (i > 0 && signals)
          mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
      }
      wgmma_wait<0>();
      if (signals) mbar_arrive(bars + 8 * (STAGES + (it - 1) % STAGES));
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        asm volatile("" : "+f"(acc[e])::"memory");
      wgmma_store<TL, COLLAPSE>(acc, at, wg - 1, n, ncols, perm, out,
                                epi + (wg - 1) * (TL::EPI_BYTES / 2));
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 operands in device memory, rounded as the frameworks round them
// (to_bf16): bytes-bound passes of their own, and the W pass's planes above.
// bf16_rows_kernel: out[m, k] = bf16(src[row(m), k]) for k < K and 0 for
// K <= k < ldo, row(m) = perm[m] (the collapse's env, in bucket order) or
// m.  One block a row, two columns a thread (ldo is even).
// ---------------------------------------------------------------------------

template <typename TS>
__global__ void __launch_bounds__(THREADS)
bf16_rows_kernel(const TS* __restrict__ src, const int32_t* __restrict__ perm,
                 int K, int ldo, bf16* __restrict__ out) {
  const int m = blockIdx.x;
  const TS* row = src + (size_t)(perm != nullptr ? perm[m] : m) * K;
  __nv_bfloat162* o =
      reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * ldo);
  for (int k = 2 * threadIdx.x; k < ldo; k += 2 * THREADS) {
    __nv_bfloat162 v;
    v.x = k < K ? to_bf16(row[k]) : zero_of<bf16>();
    v.y = k + 1 < K ? to_bf16(row[k + 1]) : zero_of<bf16>();
    o[k / 2] = v;
  }
}

// out[n, :] = 0 for the rows n whose outcome is outside [0, d): they join
// no group of the collapse (collapse_select's rows "of no outcome").  One
// block a row; the other rows' blocks return at once.
__global__ void __launch_bounds__(THREADS)
zero_rows_kernel(const int32_t* __restrict__ samples, int R, int d,
                 float* __restrict__ out) {
  const int s = samples[blockIdx.x];
  if (s >= 0 && s < d) return;
  float* row = out + (size_t)blockIdx.x * R;
  for (int r = threadIdx.x; r < R; r += THREADS) row[r] = 0.f;
}

// k rounded up to 16 bytes of bf16: TMA's unit of a row stride
int padded(int k) { return (k + 7) / 8 * 8; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry, found through the CUDA runtime
// (the library links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map, 128-byte swizzle, zeros out of bounds: dims innermost
// first, the byte strides of dims 1.., the box
int bf16_map(CUtensorMap* map, const bf16* ptr, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<bf16*>(ptr),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// out (rows, ncols) in TO = a (rows, L; row stride lda) . b, on the wgmma
// kernel.  Dense: b (L, ncols; row stride ldb), rows = n.  COLLAPSE: b the
// planes (d, L, ldb) of ncols = R columns, a in bucket order; after
// bucket_kernel with WgTile::BM.  The host's part (tensor maps, the
// kernel's shared-memory attribute, the grid: a block an SM, or fewer
// where there are fewer tiles) is made up by the constructor, before an
// entry's first launch; launch() then enqueues the kernel.
template <typename TO, bool COLLAPSE>
struct WgmmaGemm {
  using TL = WgTile;
  CUtensorMap map_a, map_b;
  int blocks = 0, err = 0;

  WgmmaGemm(const bf16* a, int lda, const bf16* b, int ldb, int n, int L,
            int ncols, int d) {
    const cuuint64_t a_dims[2] = {(cuuint64_t)L, (cuuint64_t)n};
    const cuuint64_t a_strides[1] = {(cuuint64_t)lda * 2};
    const cuuint32_t a_box[2] = {TL::BK, TL::BM};
    // B: (L, ncols), or the planes (d, L, ldb) as (ncols, L, d), innermost
    // first; boxes of 64 columns x BK rows
    const cuuint64_t b_dims[3] = {(cuuint64_t)ncols, (cuuint64_t)L,
                                  (cuuint64_t)d};
    const cuuint64_t b_strides[2] = {(cuuint64_t)ldb * 2,
                                     (cuuint64_t)ldb * 2 * L};
    const cuuint32_t b_box[3] = {64, TL::BK, 1};
    err = bf16_map(&map_a, a, 2, a_dims, a_strides, a_box);
    if (err == 0)
      err = bf16_map(&map_b, b, COLLAPSE ? 3 : 2, b_dims, b_strides, b_box);
    if (err == 0)
      err = (int)cudaFuncSetAttribute(
          wgmma_bf16_kernel<TL, TO, COLLAPSE>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM_BYTES);
    // the collapse's row tiles are known on the device only (meta), so its
    // tiles are counted at the most they can be
    const long long tiles = (long long)((n + TL::BM - 1) / TL::BM +
                                        (COLLAPSE ? d : 0)) *
                            ((ncols + TL::BN - 1) / TL::BN);
    int dev = 0, sms = 0;
    if (err == 0) err = (int)cudaGetDevice(&dev);
    if (err == 0)
      err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev);
    blocks = tiles < sms ? (int)tiles : sms;
  }

  int launch(int n, int L, int ncols, int d, const int32_t* perm,
             const int32_t* meta, TO* out, cudaStream_t stream) const {
    if (err != 0) return err;
    wgmma_bf16_kernel<TL, TO, COLLAPSE>
        <<<blocks, TL::NT, TL::SMEM_BYTES, stream>>>(
            map_a, map_b, n, L, ncols, d, perm, meta, out);
    return (int)cudaGetLastError();
  }
};

// ---------------------------------------------------------------------------
// Born step 3: env'[n, r] = temp[n, r, s_n] * lambda_r.  One block per row.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
born_collapse_kernel(const T* __restrict__ temp, const T* __restrict__ lam,
                     const int32_t* __restrict__ samples, int R, int d,
                     T* __restrict__ out) {
  const int n = blockIdx.x, s = samples[n];
  const T* row = temp + (size_t)n * R * d * 2;
  T* o = out + (size_t)n * R * 2;
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const T lr = lam[r];
    const size_t off = ((size_t)r * d + s) * 2;
    o[2 * r] = row[off] * lr;
    o[2 * r + 1] = row[off + 1] * lr;
  }
}

// ---------------------------------------------------------------------------
// Step 5: per-sample rescale (per_sample) -- or dlog = 0 (none).
// ---------------------------------------------------------------------------

template <typename T, bool CPLX>
__global__ void __launch_bounds__(THREADS)
rescale_kernel(T* __restrict__ env, int R, int per_sample,
               T* __restrict__ dlog) {
  __shared__ T red[THREADS / 32];
  const int n = blockIdx.x;
  constexpr int CW = CPLX ? 2 : 1;
  T* row = env + (size_t)n * R * CW;
  if (!per_sample) {
    if (threadIdx.x == 0) dlog[n] = T(0);
    return;
  }
  T m = T(0);
  for (int r = threadIdx.x; r < R; r += THREADS) {
    T a;
    if constexpr (CPLX) {
      const T re = row[2 * r], im = row[2 * r + 1];
      a = sqrt(re * re + im * im);
    } else {
      a = fabs(row[r]);
    }
    m = a > m ? a : m;
  }
  m = block_max(m, red);
  const T factor = m > T(0) ? m : T(1);
  for (int r = threadIdx.x; r < R * CW; r += THREADS) row[r] = row[r] / factor;
  if (threadIdx.x == 0) dlog[n] = log10(factor);
}

// Linear steps 3-4: the rows bucketed by outcome, then the grouped
// collapse GEMM, fp64 on the fp64 tensor cores (collapse_f64_kernel), fp32
// on the FMA tile (no TF32)
template <typename T>
int grouped_collapse(const T* env, const T* gamma, const int32_t* samples,
                     int32_t* perm, int32_t* meta, int n, int L, int R, int d,
                     T* out, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, double>) {
    bucket_kernel<<<1, THREADS, 0, stream>>>(samples, n, d, CollapseTile::BM,
                                             perm, meta);
    RETURN_IF_ERROR();
    return collapse_f64(env, gamma, perm, meta, n, L, R, d, out, stream);
  } else {
    const dim3 grid((n + BM - 1) / BM + d, (R + BN - 1) / BN);
    if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
    bucket_kernel<<<1, THREADS, 0, stream>>>(samples, n, d, BM, perm, meta);
    RETURN_IF_ERROR();
    collapse_kernel<T><<<grid, THREADS, 0, stream>>>(env, gamma, L, R, d,
                                                     perm, meta, out);
    RETURN_IF_ERROR();
    return 0;
  }
}

template <typename T>
int site_step_linear(const T* env, const T* gamma, const T* lam, const T* u,
                     T* env_out, int32_t* samples, T* dlog, T* w,
                     int32_t* perm, int32_t* meta, int n, int L, int R, int d,
                     int per_sample, cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  measure_weights_kernel<T><<<L, THREADS, 0, stream>>>(gamma, lam, R, d, w);
  RETURN_IF_ERROR();
  probs_draw_kernel<T, ENV_W><<<n, THREADS, 0, stream>>>(env, w, u, L, d,
                                                         samples);
  RETURN_IF_ERROR();
  const int err = grouped_collapse(env, gamma, samples, perm, meta, n, L, R, d,
                                   env_out, stream);
  if (err != 0) return err;
  rescale_kernel<T, false><<<n, THREADS, 0, stream>>>(env_out, R, per_sample,
                                                      dlog);
  RETURN_IF_ERROR();
  return 0;
}

template <typename T>
int site_step_born(const T* env, const T* gamma, const T* lam, const T* u,
                   T* env_out, int32_t* samples, T* dlog, T* temp, int n,
                   int L, int R, int d, int per_sample, cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, double>) {   // the fp64 tensor cores
    const int err = contract_c128(env, gamma, n, L, R * d, temp, stream);
    if (err != 0) return err;
  } else {                                      // complex64: FMA, no TF32
    const dim3 grid((n + BM - 1) / BM, (R * d + BN - 1) / BN);
    if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
    contract_kernel<T, true><<<grid, THREADS, 0, stream>>>(env, gamma, n, L,
                                                           R * d, temp);
    RETURN_IF_ERROR();
  }
  probs_draw_kernel<T, TEMP_BORN><<<n, THREADS, 0, stream>>>(temp, lam, u, R,
                                                             d, samples);
  RETURN_IF_ERROR();
  born_collapse_kernel<T><<<n, THREADS, 0, stream>>>(temp, lam, samples, R, d,
                                                     env_out);
  RETURN_IF_ERROR();
  rescale_kernel<T, true><<<n, THREADS, 0, stream>>>(env_out, R, per_sample,
                                                     dlog);
  RETURN_IF_ERROR();
  return 0;
}

template <typename T>
int contract_measure(const T* env, const T* gamma, const T* lam, T* temp,
                     T* probs, int n, int L, int R, int d,
                     cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, double>) {   // the fp64 tensor cores
    const int err = contract_f64(env, gamma, n, L, R * d, temp, stream);
    if (err != 0) return err;
  } else {                                      // fp32: FMA, no TF32
    const dim3 grid((n + BM - 1) / BM, (R * d + BN - 1) / BN);
    if (grid.y > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
    contract_kernel<T, false><<<grid, THREADS, 0, stream>>>(env, gamma, n, L,
                                                            R * d, temp);
    RETURN_IF_ERROR();
  }
  probs_kernel<T, TEMP_LINEAR><<<n, THREADS, 0, stream>>>(temp, lam, R, d,
                                                          probs);
  RETURN_IF_ERROR();
  return 0;
}

template <typename T>
int collapse_select(const T* env, const T* gamma, const int32_t* samples,
                    T* out, int32_t* perm, int32_t* meta, int n, int L, int R,
                    int d, cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  // rows whose outcome is outside [0, d) join no group and stay zero
  const cudaError_t zeroed =
      cudaMemsetAsync(out, 0, (size_t)n * R * sizeof(T), stream);
  if (zeroed != cudaSuccess) return (int)zeroed;
  return grouped_collapse(env, gamma, samples, perm, meta, n, L, R, d, out,
                          stream);
}

// ---------------------------------------------------------------------------
// bf16 inputs (compute_dtype=bf16): env TE (fp32 or fp64), Gamma TG (TE, or
// bf16 beside an fp32 env); Lambda, u, W, env' and dlog in TE; sums in fp32
// except where the reference sums in env's type (the draw's probs and W).
// ---------------------------------------------------------------------------

template <typename TE, typename TG>
int site_step_linear_bf16(const TE* env, const TG* gamma, const TE* lam,
                          const TE* u, TE* env_out, int32_t* samples,
                          TE* dlog, TE* w, int32_t* perm, int32_t* meta,
                          bf16* env16, bf16* planes, int n, int L, int R,
                          int d, int per_sample, cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  const int lda = padded(L), ldp = padded(R);
  const WgmmaGemm<TE, true> collapse(env16, lda, planes, ldp, n, L, R, d);
  if (collapse.err != 0) return collapse.err;
  using RV = RVec<TG>;
  const bool vec = d % RV::N == 0 &&
                   (uintptr_t)gamma % sizeof(typename RV::V) == 0;
  const auto planes_pass =
      d <= 4 ? (vec ? weights_planes_kernel<TE, TG, 4, true>
                    : weights_planes_kernel<TE, TG, 4, false>)
             : (vec ? weights_planes_kernel<TE, TG, MAX_D, true>
                    : weights_planes_kernel<TE, TG, MAX_D, false>);
  planes_pass<<<L, THREADS, 0, stream>>>(gamma, lam, R, d, w, planes, ldp);
  RETURN_IF_ERROR();
  probs_draw_kernel<TE, ENV_W, TE, TE, 1><<<n, THREADS, 0, stream>>>(
      env, w, u, L, d, samples);
  RETURN_IF_ERROR();
  bucket_kernel<<<1, THREADS, 0, stream>>>(samples, n, d, WgTile::BM, perm,
                                           meta);
  RETURN_IF_ERROR();
  bf16_rows_kernel<TE><<<n, THREADS, 0, stream>>>(env, perm, L, lda, env16);
  RETURN_IF_ERROR();
  const int err = collapse.launch(n, L, R, d, perm, meta, env_out, stream);
  if (err != 0) return err;
  rescale_kernel<TE, false><<<n, THREADS, 0, stream>>>(env_out, R, per_sample,
                                                       dlog);
  RETURN_IF_ERROR();
  return 0;
}

// gamma16: the bf16 copy of Gamma (L, padded(R d)) to write, or null to
// read a bf16 Gamma as it lies (R d a multiple of 8, 16-byte aligned)
template <typename TE, typename TG>
int contract_measure_bf16(const TE* env, const TG* gamma, const TE* lam,
                          TE* temp, TE* probs, bf16* env16, bf16* gamma16,
                          int n, int L, int R, int d, cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  const int lda = padded(L), ncols = R * d;
  const bf16* b = gamma16;
  int ldb = padded(ncols);
  if (gamma16 == nullptr) {
    if constexpr (!std::is_same_v<TG, bf16>) {
      return (int)cudaErrorInvalidValue;
    } else {
      if (ncols % 8 != 0 || !aligned16(gamma))
        return (int)cudaErrorInvalidValue;
      b = gamma;
      ldb = ncols;
    }
  }
  const WgmmaGemm<TE, false> gemm(env16, lda, b, ldb, n, L, ncols, 1);
  if (gemm.err != 0) return gemm.err;
  bf16_rows_kernel<TE><<<n, THREADS, 0, stream>>>(env, nullptr, L, lda,
                                                  env16);
  RETURN_IF_ERROR();
  if (gamma16 != nullptr) {
    bf16_rows_kernel<TG><<<L, THREADS, 0, stream>>>(gamma, nullptr, ncols,
                                                    ldb, gamma16);
    RETURN_IF_ERROR();
  }
  const int err = gemm.launch(n, L, ncols, 1, nullptr, nullptr, temp, stream);
  if (err != 0) return err;
  probs_kernel<TE, TEMP_LINEAR><<<n, THREADS, 0, stream>>>(temp, lam, R, d,
                                                           probs);
  RETURN_IF_ERROR();
  return 0;
}

// env16 (n, padded(L)) and planes (d, L, padded(R)): the bf16 operands to
// write.  Rows of no outcome in [0, d) are zeroed alone (zero_rows_kernel),
// not the whole of env'.
template <typename TE, typename TG>
int collapse_select_bf16(const TE* env, const TG* gamma,
                         const int32_t* samples, float* out, int32_t* perm,
                         int32_t* meta, bf16* env16, bf16* planes, int n,
                         int L, int R, int d, cudaStream_t stream) {
  if (n <= 0 || d < 1 || d > MAX_D) return (int)cudaErrorInvalidValue;
  const int lda = padded(L), ldp = padded(R);
  const WgmmaGemm<float, true> collapse(env16, lda, planes, ldp, n, L, R, d);
  if (collapse.err != 0) return collapse.err;
  using RV = RVec<TG>;
  const bool vec = d % RV::N == 0 &&
                   (uintptr_t)gamma % sizeof(typename RV::V) == 0;
  const auto planes_pass =
      d <= 4 ? (vec ? weights_planes_kernel<float, TG, 4, true, false>
                    : weights_planes_kernel<float, TG, 4, false, false>)
             : (vec ? weights_planes_kernel<float, TG, MAX_D, true, false>
                    : weights_planes_kernel<float, TG, MAX_D, false, false>);
  planes_pass<<<L, THREADS, 0, stream>>>(gamma, nullptr, R, d, nullptr,
                                         planes, ldp);
  RETURN_IF_ERROR();
  bucket_kernel<<<1, THREADS, 0, stream>>>(samples, n, d, WgTile::BM, perm,
                                           meta);
  RETURN_IF_ERROR();
  zero_rows_kernel<<<n, THREADS, 0, stream>>>(samples, R, d, out);
  RETURN_IF_ERROR();
  bf16_rows_kernel<TE><<<n, THREADS, 0, stream>>>(env, perm, L, lda, env16);
  RETURN_IF_ERROR();
  return collapse.launch(n, L, R, d, perm, meta, out, stream);
}

}  // namespace

extern "C" {

int fastmps_max_d() { return MAX_D; }

int fastmps_site_step_linear_f64(const double* env, const double* gamma,
                                 const double* lam, const double* u,
                                 double* env_out, int32_t* samples,
                                 double* dlog, double* w, int32_t* perm,
                                 int32_t* meta, int n, int L, int R, int d,
                                 int per_sample, void* stream) {
  return site_step_linear<double>(env, gamma, lam, u, env_out, samples, dlog,
                                  w, perm, meta, n, L, R, d, per_sample,
                                  (cudaStream_t)stream);
}

int fastmps_site_step_linear_f32(const float* env, const float* gamma,
                                 const float* lam, const float* u,
                                 float* env_out, int32_t* samples, float* dlog,
                                 float* w, int32_t* perm, int32_t* meta, int n,
                                 int L, int R, int d, int per_sample,
                                 void* stream) {
  return site_step_linear<float>(env, gamma, lam, u, env_out, samples, dlog, w,
                                 perm, meta, n, L, R, d, per_sample,
                                 (cudaStream_t)stream);
}

// complex operands are interleaved (re, im) pairs of the real type;
// temp is the (N, R, d) complex scratch of the contraction
int fastmps_site_step_born_c128(const double* env, const double* gamma,
                                const double* lam, const double* u,
                                double* env_out, int32_t* samples,
                                double* dlog, double* temp, int n, int L,
                                int R, int d, int per_sample, void* stream) {
  return site_step_born<double>(env, gamma, lam, u, env_out, samples, dlog,
                                temp, n, L, R, d, per_sample,
                                (cudaStream_t)stream);
}

int fastmps_site_step_born_c64(const float* env, const float* gamma,
                               const float* lam, const float* u,
                               float* env_out, int32_t* samples, float* dlog,
                               float* temp, int n, int L, int R, int d,
                               int per_sample, void* stream) {
  return site_step_born<float>(env, gamma, lam, u, env_out, samples, dlog,
                               temp, n, L, R, d, per_sample,
                               (cudaStream_t)stream);
}

// TP stages: temp (N, R, d) and probs (N, d) out; W (L, d); samples (N)
// int32; perm (N) and meta (3d + 1) int32 scratch of collapse_select
int fastmps_contract_measure_f64(const double* env, const double* gamma,
                                 const double* lam, double* temp,
                                 double* probs, int n, int L, int R, int d,
                                 void* stream) {
  return contract_measure<double>(env, gamma, lam, temp, probs, n, L, R, d,
                                  (cudaStream_t)stream);
}

int fastmps_contract_measure_f32(const float* env, const float* gamma,
                                 const float* lam, float* temp, float* probs,
                                 int n, int L, int R, int d, void* stream) {
  return contract_measure<float>(env, gamma, lam, temp, probs, n, L, R, d,
                                 (cudaStream_t)stream);
}

int fastmps_measure_probs_f64(const double* env, const double* w,
                              double* probs, int n, int L, int d,
                              void* stream) {
  return measure_probs_launch<double, double, 0>(env, w, probs, n, L, d,
                                                 (cudaStream_t)stream);
}

int fastmps_measure_probs_f32(const float* env, const float* w, float* probs,
                              int n, int L, int d, void* stream) {
  return measure_probs_launch<float, float, 0>(env, w, probs, n, L, d,
                                               (cudaStream_t)stream);
}

int fastmps_collapse_select_f64(const double* env, const double* gamma,
                                const int32_t* samples, double* out,
                                int32_t* perm, int32_t* meta, int n, int L,
                                int R, int d, void* stream) {
  return collapse_select<double>(env, gamma, samples, out, perm, meta, n, L,
                                 R, d, (cudaStream_t)stream);
}

int fastmps_collapse_select_f32(const float* env, const float* gamma,
                                const int32_t* samples, float* out,
                                int32_t* perm, int32_t* meta, int n, int L,
                                int R, int d, void* stream) {
  return collapse_select<float>(env, gamma, samples, out, perm, meta, n, L, R,
                                d, (cudaStream_t)stream);
}

// bf16 inputs, named by (env, Gamma) types: f32_f32 (mxu_bf16), f32_bf16
// (store_bf16), f64_f64 (an fp64 chain); measure_probs by env = W's type.
// Arguments as the entries above; collapse_select's out and measure_probs'
// probs are fp32 whatever env's type.  The bf16 scratch of the site step,
// contract_measure and collapse_select: env16 (N, padded(L)) the rounded
// env; planes (d, L, padded(R)) Gamma's rounded planes; gamma16 (L,
// padded(R d)) Gamma's rounded copy, or null for a bf16 Gamma read as it
// lies.
int fastmps_site_step_linear_bf16_f32_f32(
    const float* env, const float* gamma, const float* lam, const float* u,
    float* env_out, int32_t* samples, float* dlog, float* w, int32_t* perm,
    int32_t* meta, bf16* env16, bf16* planes, int n, int L, int R, int d,
    int per_sample, void* stream) {
  return site_step_linear_bf16<float, float>(
      env, gamma, lam, u, env_out, samples, dlog, w, perm, meta, env16,
      planes, n, L, R, d, per_sample, (cudaStream_t)stream);
}

int fastmps_site_step_linear_bf16_f32_bf16(
    const float* env, const bf16* gamma, const float* lam, const float* u,
    float* env_out, int32_t* samples, float* dlog, float* w, int32_t* perm,
    int32_t* meta, bf16* env16, bf16* planes, int n, int L, int R, int d,
    int per_sample, void* stream) {
  return site_step_linear_bf16<float, bf16>(
      env, gamma, lam, u, env_out, samples, dlog, w, perm, meta, env16,
      planes, n, L, R, d, per_sample, (cudaStream_t)stream);
}

int fastmps_site_step_linear_bf16_f64_f64(
    const double* env, const double* gamma, const double* lam,
    const double* u, double* env_out, int32_t* samples, double* dlog,
    double* w, int32_t* perm, int32_t* meta, bf16* env16, bf16* planes,
    int n, int L, int R, int d, int per_sample, void* stream) {
  return site_step_linear_bf16<double, double>(
      env, gamma, lam, u, env_out, samples, dlog, w, perm, meta, env16,
      planes, n, L, R, d, per_sample, (cudaStream_t)stream);
}

int fastmps_contract_measure_bf16_f32_f32(const float* env,
                                          const float* gamma,
                                          const float* lam, float* temp,
                                          float* probs, bf16* env16,
                                          bf16* gamma16, int n, int L, int R,
                                          int d, void* stream) {
  return contract_measure_bf16<float, float>(env, gamma, lam, temp, probs,
                                             env16, gamma16, n, L, R, d,
                                             (cudaStream_t)stream);
}

int fastmps_contract_measure_bf16_f32_bf16(const float* env,
                                           const bf16* gamma,
                                           const float* lam, float* temp,
                                           float* probs, bf16* env16,
                                           bf16* gamma16, int n, int L, int R,
                                           int d, void* stream) {
  return contract_measure_bf16<float, bf16>(env, gamma, lam, temp, probs,
                                            env16, gamma16, n, L, R, d,
                                            (cudaStream_t)stream);
}

int fastmps_contract_measure_bf16_f64_f64(const double* env,
                                          const double* gamma,
                                          const double* lam, double* temp,
                                          double* probs, bf16* env16,
                                          bf16* gamma16, int n, int L, int R,
                                          int d, void* stream) {
  return contract_measure_bf16<double, double>(
      env, gamma, lam, temp, probs, env16, gamma16, n, L, R, d,
      (cudaStream_t)stream);
}

int fastmps_measure_probs_bf16_f32(const float* env, const float* w,
                                   float* probs, int n, int L, int d,
                                   void* stream) {
  return measure_probs_launch<float, float, 3>(env, w, probs, n, L, d,
                                               (cudaStream_t)stream);
}

int fastmps_measure_probs_bf16_f64(const double* env, const double* w,
                                   float* probs, int n, int L, int d,
                                   void* stream) {
  return measure_probs_launch<float, double, 3>(env, w, probs, n, L, d,
                                                (cudaStream_t)stream);
}

int fastmps_collapse_select_bf16_f32_f32(
    const float* env, const float* gamma, const int32_t* samples, float* out,
    int32_t* perm, int32_t* meta, bf16* env16, bf16* planes, int n, int L,
    int R, int d, void* stream) {
  return collapse_select_bf16<float, float>(
      env, gamma, samples, out, perm, meta, env16, planes, n, L, R, d,
      (cudaStream_t)stream);
}

int fastmps_collapse_select_bf16_f32_bf16(
    const float* env, const bf16* gamma, const int32_t* samples, float* out,
    int32_t* perm, int32_t* meta, bf16* env16, bf16* planes, int n, int L,
    int R, int d, void* stream) {
  return collapse_select_bf16<float, bf16>(
      env, gamma, samples, out, perm, meta, env16, planes, n, L, R, d,
      (cudaStream_t)stream);
}

int fastmps_collapse_select_bf16_f64_f64(
    const double* env, const double* gamma, const int32_t* samples, float* out,
    int32_t* perm, int32_t* meta, bf16* env16, bf16* planes, int n, int L,
    int R, int d, void* stream) {
  return collapse_select_bf16<double, double>(
      env, gamma, samples, out, perm, meta, env16, planes, n, L, R, d,
      (cudaStream_t)stream);
}

}  // extern "C"
