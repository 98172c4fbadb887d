// Forward flash attention for NVIDIA Hopper (sm_90a): online-softmax
// attention with causal masking and grouped KV heads, without the
// (B, H, S, T) score matrix ever reaching device memory.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention.
//
//   q (B, S, H, Dh), k/v (B, T, KVH, Dh), bf16 or fp32, contiguous
//   out (B, S, H, Dh) in q's type; Dh = 64, 112 or 128; H a multiple of
//   KVH.  (112 is kimi-k2's head: 7168 / 64.)
//
// What the TPU kernel does and how it is carried over.  Its grid is
// (B.H, S/BQ, T/BK) with the key blocks innermost, run in order on one core,
// so the running max, denominator and accumulator live in VMEM scratch
// across grid steps.  Hopper blocks run in no order, so here one block owns a
// query tile's whole key loop: grid (S/BQ, B.H), and the block walks the key
// tiles in order.  Nothing is summed across blocks, so a run repeats itself
// bit for bit.  The KV head of query head h is h / (H / KVH), read in place
// (never duplicated), as the TPU kernel's BlockSpec index map.  Key tiles
// wholly above the causal diagonal are skipped, as the TPU kernel's
// pl.when(live).  Masked scores are -1e30 (the TPU kernel's NEG_INF), not
// -inf, so a row whose tile is wholly masked gives exp(0) and no NaN, and
// alpha = exp(m_prev - m_new) washes such a tile out once a live score
// arrives; the final division is guarded by l > 0.  Out-of-range key rows
// load as zeros and score -1e30.
//
// What bounds it: 4.B.H.S.T.Dh flops (halved when causal) at the tensor
// cores' bf16 rate; the bytes (Q, K, V and O once) are far below that.
//
// bf16 (flash_tc_kernel): both products on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  Each warp owns MT 16-row
// query tiles of the block's BQ rows; their Q fragments are read once with
// ldmatrix and stay in registers for the whole key loop.  K and V tiles
// (64 keys) stay bf16 in shared memory, brought in by cp.async into a ring
// of two stages so the next tile's copy overlaps this tile's products; rows
// are padded by 16 bytes so the eight rows an ldmatrix phase reads fall in
// distinct banks.  K is read with ldmatrix, V with ldmatrix.trans.  The
// scores S = Q.K^T stay in the accumulator fragments: the row max and the
// row sum reduce across the four lanes of a quad by shuffles, and the
// exponentials are exp2 of log2(e)-scaled scores.  P is rounded to bf16 in
// registers (as the TPU kernel's p.astype(v.dtype)) and used directly as the
// A operand of P.V -- the m16n8k16 accumulator layout of two adjacent 8-key
// blocks is the A layout of one 16-key step -- so P never touches shared
// memory.  The row sum l adds the unrounded fp32 p, as the TPU kernel's
// l_ref.  P is rounded relative to the running max, as in the TPU kernel's
// key blocks; the plain version rounds it relative to the final max, so the
// two differ by about one bf16 rounding of P and one of the output (the
// bound is flash_attention.rounding_bound).  A warp whose rows all lie above
// a tile's keys skips the tile: its scores would all be -1e30 below a live
// running max (key 0 is live for every row), so p = 0 exactly and skipping
// changes no value.  Query tiles are issued heaviest first under the causal
// mask.
//
// Dh = 112 (7 k-steps of 16 for Q.K^T, 14 output blocks of 8 for P.V, so
// the fragment loops above hold) has tiles of its own: a row is 14 16-byte
// chunks, so a 64-key tile is 896 chunks, which 128 threads divide and 256
// do not; it runs 4 warps of one 16-row query tile each (BQ = 64).  Its
// shared rows are 240 bytes (Dh + 8 halves), so the eight rows an ldmatrix
// phase reads still fall in distinct banks.
//
// fp32 (flash_kernel): the reference scores fp32 inputs in fp32, and TF32
// would keep about three digits, so fp32 stays on the FMA units: 256 threads
// as 16 x 16, thread (ty, tx) owns query rows ty*4 .. ty*4+3 and the score
// columns tx + 16*j of a 64 x 64 tile; Q, K, V and P tiles in shared memory
// (rows padded by one word), m and l reduced by warp shuffles.
//
// C interface (loaded with ctypes): each entry launches on the given stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_GRID_Y = 65535;

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async ring, P in registers
// ---------------------------------------------------------------------------

constexpr int KT = 64;      // keys per tile
constexpr int STAGES = 2;   // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

// warps per block and 16-row query tiles per warp at Dh = 64, then at
// Dh = 128, then at Dh = 112.  A file that defines FASTMPS_FLASH_TILES and
// then includes this one builds other tiles (scripts/tile_sweep.py).
#ifndef FASTMPS_FLASH_TILES
#define FASTMPS_FLASH_TILES 4, 2, 8, 1, 4, 1
#endif
constexpr int FLASH_TILES[] = {FASTMPS_FLASH_TILES};
template <int DH> struct TcShape;
template <> struct TcShape<64> {
  static constexpr int WARPS = FLASH_TILES[0], MT = FLASH_TILES[1];
};
template <> struct TcShape<128> {
  static constexpr int WARPS = FLASH_TILES[2], MT = FLASH_TILES[3];
};
template <> struct TcShape<112> {
  static constexpr int WARPS = FLASH_TILES[4], MT = FLASH_TILES[5];
};

// rows [row0, row0 + ROWS) of one head of a (B, n_rows, heads, DH) bf16
// tensor into a (ROWS, DH + 8) shared tile by cp.async; rows at or past
// n_rows are zero
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void load_rows(bf16* tile,
                                          const bf16* __restrict__ g, int b,
                                          int row0, int n_rows, int heads,
                                          int head) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NT; ++it) {
    const int idx = threadIdx.x + it * NT;
    const int r = idx / CH, c = idx % CH;
    const int row = row0 + r;
    const bool ok = row < n_rows;
    const bf16* src =
        ok ? g + (((int64_t)b * n_rows + row) * heads + head) * DH + c * 8
           : g;
    cp_async16(smem_addr(tile + r * (DH + 8) + c * 8), src, ok);
  }
}

template <int DH>
constexpr int tc_smem_bytes() {
  return (16 * TcShape<DH>::WARPS * TcShape<DH>::MT + 2 * STAGES * KT) *
         (DH + 8) * 2;
}

template <int DH>
__global__ void __launch_bounds__(TcShape<DH>::WARPS * 32)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                int T, int H, int KVH, int causal) {
  constexpr int WARPS = TcShape<DH>::WARPS, MT = TcShape<DH>::MT;
  constexpr int NT = WARPS * 32, BQ = 16 * WARPS * MT, LD = DH + 8;
  constexpr int KC = DH / 16;   // 16-deep steps of Q.K^T
  constexpr int NB = KT / 8;    // 8-key blocks of a score tile
  constexpr int ND = DH / 8;    // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;              // [STAGES][KT][LD]
  bf16* Vs = Ks + STAGES * KT * LD;     // [STAGES][KT][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh - (bh / H) * H;
  const int kvh = h / (H / KVH);
  // heaviest query tiles first under the causal mask
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int w0 = q0 + warp * 16 * MT;   // this warp's first query row
  const float sl2 = (float)(1.0 / sqrt((double)DH)) * LOG2E;

  int n_tiles = (T + KT - 1) / KT;
  if (causal) {  // skip key tiles wholly above the diagonal
    const int live = (q0 + BQ - 1) / KT + 1;
    n_tiles = live < n_tiles ? live : n_tiles;
  }

  load_rows<DH, BQ, NT>(Qs, q, b, q0, S, H, h);
  load_rows<DH, KT, NT>(Ks, k, b, 0, T, KVH, kvh);
  load_rows<DH, KT, NT>(Vs, v, b, 0, T, KVH, kvh);
  cp_commit();

  uint32_t qf[MT][KC][4];
  float o[MT][ND][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = NEG_INF;
      l[mt][i] = 0.f;
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nd][e] = 0.f;
  }

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * KT;
    if (jt + 1 < n_tiles) {  // the next tile into the other stage
      const int st = (jt + 1) % STAGES;
      load_rows<DH, KT, NT>(Ks + st * KT * LD, k, b, k0 + KT, T, KVH, kvh);
      load_rows<DH, KT, NT>(Vs + st * KT * LD, v, b, k0 + KT, T, KVH, kvh);
    }
    cp_commit();
    cp_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    if (jt == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          ldsm_x4(smem_addr(Qs + (warp * 16 * MT + mt * 16 + (lane & 15)) * LD
                            + kc * 16 + (lane >> 4) * 8),
                  qf[mt][kc]);
    }
    const bf16* Kt = Ks + (jt % STAGES) * KT * LD;
    const bf16* Vt = Vs + (jt % STAGES) * KT * LD;
    // a warp whose rows all lie above this tile's keys contributes p = 0
    const bool live = !causal || k0 <= w0 + 16 * MT - 1;
    if (live) {
      float s[MT][NB][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nb][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int nb = 0; nb < NB; nb += 2) {
          uint32_t kf[4];
          ldsm_x4(smem_addr(Kt + (nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD
                            + kc * 16 + ((lane >> 3) & 1) * 8),
                  kf);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][nb], qf[mt][kc], kf[0], kf[1]);
            mma_bf16(s[mt][nb + 1], qf[mt][kc], kf[2], kf[3]);
          }
        }

      const bool edge = k0 + KT > T || (causal && k0 + KT - 1 > w0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {   // rows g and g + 8 of the 16
          const int row = w0 + mt * 16 + g + 8 * i;
          float mx = NEG_INF;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = s[mt][nb][2 * i + e] * sl2;
              if (edge) {
                const int col = k0 + nb * 8 + 2 * t4 + e;
                if (col >= T || (causal && row < col)) x = NEG_INF;
              }
              s[mt][nb][2 * i + e] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[mt][i], mx);
          const float alpha = exp2f(m[mt][i] - m_new);
          m[mt][i] = m_new;
          float rs = 0.f;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = exp2f(s[mt][nb][2 * i + e] - m_new);
              s[mt][nb][2 * i + e] = p;
              rs += p;
            }
          l[mt][i] = alpha * l[mt][i] + rs;  // this lane's share of the row
#pragma unroll
          for (int nd = 0; nd < ND; ++nd) {
            o[mt][nd][2 * i] *= alpha;
            o[mt][nd][2 * i + 1] *= alpha;
          }
        }
      }
#pragma unroll
      for (int kc = 0; kc < KT / 16; ++kc) {
        // P rounded to bf16: the A fragments of P.V for keys 16kc..16kc+15
        uint32_t pf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pf[mt][0] = pack_bf16(s[mt][2 * kc][0], s[mt][2 * kc][1]);
          pf[mt][1] = pack_bf16(s[mt][2 * kc][2], s[mt][2 * kc][3]);
          pf[mt][2] = pack_bf16(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
          pf[mt][3] = pack_bf16(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
        }
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t vf[4];
          ldsm_x4_t(smem_addr(Vt + (kc * 16 + (lane & 15)) * LD + nd * 8
                              + (lane >> 4) * 8),
                    vf);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][nd], pf[mt], vf[0], vf[1]);
            mma_bf16(o[mt][nd + 1], pf[mt], vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lt = l[mt][i];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = w0 + mt * 16 + g + 8 * i;
      if (row >= S) continue;
      const float inv = 1.f / (lt > 0.f ? lt : 1.f);
      bf16* orow = out + (((int64_t)b * S + row) * H + h) * DH + 2 * t4;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8) =
            __floats2bfloat162_rn(o[mt][nd][2 * i] * inv,
                                  o[mt][nd][2 * i + 1] * inv);
    }
}

template <int DH>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
              int S, int T, int H, int KVH, int causal, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<DH>();
  constexpr int BQ = 16 * TcShape<DH>::WARPS * TcShape<DH>::MT;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_tc_kernel<DH><<<grid, TcShape<DH>::WARPS * 32, bytes, stream>>>(
      q, k, v, out, S, T, H, KVH, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA units, fp32 tiles in shared memory
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int TR = 4;         // query rows per thread: ty*4 + i
constexpr int TC = BK / 16;   // score columns per thread: tx + 16*j

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1);
}

// rows [row0, row0 + 64) of one head of a (B, rows, heads, DH) tensor into
// a (64, stride) tile; rows at or past n_rows are zero
template <int DH>
__device__ void load_tile(float* tile, int stride, const float* __restrict__ g,
                          int b, int row0, int n_rows, int heads, int head) {
  for (int idx = threadIdx.x; idx < 64 * DH; idx += THREADS) {
    const int r = idx / DH, c = idx - (idx / DH) * DH;
    const int row = row0 + r;
    float x = 0.f;
    if (row < n_rows)
      x = g[(((int64_t)b * n_rows + row) * heads + head) * DH + c];
    tile[r * stride + c] = x;
  }
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int T, int H, int KVH, int causal) {
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

  load_tile<DH>(Qs, QP, q, b, q0, S, H, h);

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
    load_tile<DH>(Ks, KP, k, b, k0, T, KVH, kvh);
    load_tile<DH>(Vs, DH, v, b, k0, T, KVH, kvh);
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
    float* o = out + (((int64_t)b * S + row) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[tx + 16 * c] = acc[i][c] * inv;
  }
}

template <int DH>
int launch_f32(const float* q, const float* k, const float* v, float* out,
               int B, int S, int T, int H, int KVH, int causal,
               cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_kernel<DH><<<grid, THREADS, bytes, stream>>>(q, k, v, out, S, T, H,
                                                     KVH, causal);
  return (int)cudaGetLastError();
}

bool bad_sizes(int B, int S, int T, int H, int KVH) {
  return B < 1 || S < 1 || T < 1 || KVH < 1 || H % KVH != 0 ||
         (int64_t)B * H > MAX_GRID_Y;
}

}  // namespace

extern "C" {

// q, k, v and out 16-byte aligned (the wrapper sees to it)
int fastmps_flash_attention_bf16(const void* q, const void* k, const void* v, void* out, int B, int S, int T, int H, int KVH, int Dh, int causal, void* stream) {
  if (bad_sizes(B, S, T, H, KVH)) return (int)cudaErrorInvalidValue;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  bf16* ob = (bf16*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 64) return launch_tc<64>(qb, kb, vb, ob, B, S, T, H, KVH, causal, st);
  if (Dh == 112) return launch_tc<112>(qb, kb, vb, ob, B, S, T, H, KVH, causal, st);
  if (Dh == 128) return launch_tc<128>(qb, kb, vb, ob, B, S, T, H, KVH, causal, st);
  return (int)cudaErrorInvalidValue;
}

int fastmps_flash_attention_f32(const float* q, const float* k, const float* v, float* out, int B, int S, int T, int H, int KVH, int Dh, int causal, void* stream) {
  if (bad_sizes(B, S, T, H, KVH)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 64) return launch_f32<64>(q, k, v, out, B, S, T, H, KVH, causal, st);
  if (Dh == 112) return launch_f32<112>(q, k, v, out, B, S, T, H, KVH, causal, st);
  if (Dh == 128) return launch_f32<128>(q, k, v, out, B, S, T, H, KVH, causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
