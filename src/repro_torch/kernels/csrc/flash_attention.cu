// Forward flash attention for NVIDIA Hopper (sm_90a): online-softmax
// attention with causal masking and grouped KV heads, without the
// (B, H, S, T) score matrix ever reaching device memory.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention.
//
//   q (B, S, H, Dh), k/v (B, T, KVH, Dh), bf16 or fp32, contiguous
//   out (B, S, H, Dh) in q's type; Dh = 64 or 128; H a multiple of KVH.
//
// What the TPU kernel does and how it is carried over.  Its grid is
// (B.H, S/BQ, T/BK) with the key blocks innermost, run in order on one core,
// so the running max, denominator and accumulator live in VMEM scratch
// across grid steps.  Hopper blocks run in no order, so here one block owns a
// query tile's whole key loop: grid (S/64, B.H), and the block walks the key
// tiles in order.  Nothing is summed across blocks, so a run repeats itself
// bit for bit.  The KV head of query head h is h / (H / KVH), read in place
// (never duplicated), as the TPU kernel's BlockSpec index map.  Key tiles
// wholly above the causal diagonal are skipped, as the TPU kernel's
// pl.when(live).
//
// The block: 256 threads as 16 x 16; thread (ty, tx) owns query rows
// ty*4 .. ty*4+3 and, of the 64 x 64 score tile, the columns tx + 16*j.
// Q, the K and V tiles and the probabilities tile are staged in shared
// memory as fp32 (a bf16 input converts exactly); rows of Q and K are padded
// by one word so the 16 columns a half-warp reads fall in 16 banks.  Scores,
// the running max m, the denominator l and the output accumulator are fp32;
// m and l reduce across the 16 threads of a row by warp shuffles.  Masked
// scores are -1e30 (the TPU kernel's NEG_INF), not -inf, so a row whose tile
// is wholly masked gives exp(0) and no NaN, and alpha = exp(m_prev - m_new)
// washes such a tile out once a live score arrives; the final division is
// guarded by l > 0.  Out-of-range key rows load as zeros and score -1e30.
//
// Bound: 4.B.H.S.T.Dh flops (halved when causal) on the tensor cores; this
// first kernel multiplies on the FMA units from shared memory (no mma.sync,
// no wgmma/TMA), so it is far from that bound.
//
// C interface (loaded with ctypes): each entry launches on the given stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TR = 4;         // query rows per thread: ty*4 + i
constexpr int TC = BK / 16;   // score columns per thread: tx + 16*j
constexpr float NEG_INF = -1e30f;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1);
}

// rows [row0, row0 + 64) of one head of a (B, rows, heads, DH) tensor into
// a (64, stride) fp32 tile; rows at or past n_rows are zero
template <typename Tin, int DH>
__device__ void load_tile(float* tile, int stride, const Tin* __restrict__ g,
                          int b, int row0, int n_rows, int heads, int head) {
  for (int idx = threadIdx.x; idx < 64 * DH; idx += THREADS) {
    const int r = idx / DH, c = idx - (idx / DH) * DH;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n_rows)
      x = to_float(g[(((int64_t)b * n_rows + row) * heads + head) * DH + c]);
    tile[r * stride + c] = x;
  }
}

template <typename Tin, int DH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
             const Tin* __restrict__ v, Tin* __restrict__ out, int S, int T,
             int H, int KVH, int causal) {
  constexpr int QP = DH + 1, KP = DH + 1, PP = BK + 1;
  constexpr int OC = DH / 16;  // output columns per thread: tx + 16*c
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * KP;
  float* Ps = Vs + BK * DH;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh - (bh / H) * H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const float scale = (float)(1.0 / sqrt((double)DH));

  load_tile<Tin, DH>(Qs, QP, q, b, q0, S, H, h);

  float m[TR], l[TR], acc[TR][OC];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (T + BK - 1) / BK;
  if (causal) {  // skip key tiles wholly above the diagonal
    const int live = (q0 + BQ - 1) / BK + 1;
    n_tiles = live < n_tiles ? live : n_tiles;
  }
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<Tin, DH>(Ks, KP, k, b, k0, T, KVH, kvh);
    load_tile<Tin, DH>(Vs, DH, v, b, k0, T, KVH, kvh);
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = Qs[(ty * TR + i) * QP + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) kv[j] = Ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty * TR + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= T || (causal && row < col)) x = NEG_INF;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * TR + i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[TR], vv[OC];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = Ps[(ty * TR + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = Vs[kk * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty * TR + i;
    if (row >= S) continue;
    const float inv = 1.f / (l[i] > 0.f ? l[i] : 1.f);
    Tin* o = out + (((int64_t)b * S + row) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < OC; ++c) store(o + tx + 16 * c, acc[i][c] * inv);
  }
}

template <typename Tin, int DH>
int launch_dh(const Tin* q, const Tin* k, const Tin* v, Tin* out, int B,
              int S, int T, int H, int KVH, int causal, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<Tin, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_kernel<Tin, DH><<<grid, THREADS, bytes, stream>>>(q, k, v, out, S, T,
                                                          H, KVH, causal);
  return (int)cudaGetLastError();
}

template <typename Tin>
int flash(const Tin* q, const Tin* k, const Tin* v, Tin* out, int B, int S,
          int T, int H, int KVH, int Dh, int causal, cudaStream_t stream) {
  if (B < 1 || S < 1 || T < 1 || KVH < 1 || H % KVH != 0 ||
      (int64_t)B * H > MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  if (Dh == 64)
    return launch_dh<Tin, 64>(q, k, v, out, B, S, T, H, KVH, causal, stream);
  if (Dh == 128)
    return launch_dh<Tin, 128>(q, k, v, out, B, S, T, H, KVH, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int fastmps_flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B, int S, int T, int H, int KVH, int Dh, int causal, void* stream) {
  return flash<__nv_bfloat16>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, B, S, T, H, KVH, Dh,
      causal, (cudaStream_t)stream);
}

int fastmps_flash_attention_f32(const float* q, const float* k, const float* v, float* out, int B, int S, int T, int H, int KVH, int Dh, int causal, void* stream) {
  return flash<float>(q, k, v, out, B, S, T, H, KVH, Dh, causal,
                      (cudaStream_t)stream);
}

}  // extern "C"
