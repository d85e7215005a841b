// Mamba-2 SSD chunked scan forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_chunked_pallas` in
// src/repro/kernels/ssd_scan.py:24.  Same function: for each (batch, head)
// the sequence is walked in chunks of Q tokens, carrying a (P,N) float32
// state h.  Within a chunk, with cum the inclusive cumsum of dt*A
// (A = -exp(a_log)):
//   y   = (C B^T . decay . dt^T) x + exp(cum) . (C h^T),
//         decay[i,j] = exp(cum_i - cum_j) for i >= j, else 0
//   h  <- exp(cum_Q) h + x^T (B . exp(cum_Q - cum) . dt)
// B and C of group h / (H/G) serve head h.  Inputs are float32 or bf16, the
// state and all arithmetic float32, y is written in x's type.
//
// What bounds it on the H100: operations.  One call of the main path (one
// replica's shard at R=4: B 2, L 2048, H 64, P 64, N 128, Q 128) counts the
// causal triangle only, 7.36 MFLOP per (b, h, chunk), 1.51e10 FLOP in all:
// 0.225 ms at the 67 TFLOP/s float32 rate (float32 parity keeps it off the
// tensor cores), against 0.14 GB of inputs and outputs (0.042 ms).
//
// What the design does about it, simply and correctly first:
//  * one block per (head, batch) walks its chunks in order and keeps the
//    state in shared memory (P x N float32, 32 KB): the sequential chunk
//    grid axis of the TPU kernel becomes a loop inside the block.  At the
//    main path's shapes that is 128 blocks, about one per SM;
//  * a chunk's x (Q x P) and B (Q x N) are staged in shared memory as
//    float32; C and the (Q x Q) score matrix do not fit beside them in the
//    227 KB a block may use, so the chunk's query rows go in tiles of 32:
//    C rows of the tile and a 32 x Q score tile (166 KB in all at the main
//    path's shapes, above the 48 KB default, so the attribute is set);
//  * the causal mask is applied before exp: above the diagonal cum_i - cum_j
//    is positive and can overflow, and inf * 0 would be NaN;  key columns
//    past the tile's last row are never computed;
//  * the cumsum of a chunk is a warp scan (4 values a lane), so Q <= 128;
//  * each thread owns a 2 x 8 tile of scores, a 2 x 4 tile of y and a 4 x 8
//    tile of the state update in registers; rows of B, h and the scores are
//    padded by one float so the column walks hit distinct banks.
// Speed is later work: every product runs on the float32 FMA units from
// shared memory, and 128 blocks leave the card's SMs one block deep.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int QT = 32;          // query rows per tile
constexpr int MAX_Q = 128;      // the warp scan holds 4 values per lane
constexpr int MAX_P = 64;       // y: 4 columns x 16 threads
constexpr int MAX_N = 128;      // scores / state: 8 columns x 16 threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

struct Dims {
  int L, H, G, P, N, Q;
  long long x_sb, x_sl, x_sh, b_sb, b_sl, b_sg, c_sb, c_sl, c_sg;
};

size_t smem_bytes(int Q, int P, int N) {
  const size_t ldn = N + 1, lds = Q + 1;
  return sizeof(float) * ((size_t)Q * P + (size_t)Q * ldn + (size_t)P * ldn +
                          (size_t)QT * ldn + (size_t)QT * lds + 3 * (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, Dims d) {
  const int Q = d.Q, P = d.P, N = d.N;
  const int LDN = N + 1, LDS = Q + 1;
  extern __shared__ float smem[];
  float* sX = smem;               // Q x P     x of the chunk
  float* sB = sX + Q * P;         // Q x LDN   B of the chunk
  float* sH = sB + Q * LDN;       // P x LDN   carried state
  float* sC = sH + P * LDN;       // QT x LDN  C rows of the query tile
  float* sS = sC + QT * LDN;      // QT x LDS  scores of the query tile
  float* sCum = sS + QT * LDS;    // Q         inclusive cumsum of dt*A
  float* sDt = sCum + Q;          // Q         dt
  float* sW = sDt + Q;            // Q         exp(cum_end - cum_j) dt_j

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int g = h / (d.H / d.G);
  const float A = -expf(a_log[h]);
  const T* xb = x + b * d.x_sb + h * d.x_sh;
  const T* bb = bm + b * d.b_sb + g * d.b_sg;
  const T* cb = cm + b * d.c_sb + g * d.c_sg;
  const float* dtb = dt + (long long)b * d.L * d.H + h;
  T* yb = y + (long long)b * d.L * d.H * P + (long long)h * P;
  const long long y_sl = (long long)d.H * P;

  for (int i = tid; i < P * LDN; i += NTHREADS) sH[i] = 0.f;

  const int ty = tid >> 4, tx = tid & 15;
  const int r0 = 2 * ty, r1 = r0 + 1;     // this thread's rows of a query tile

  for (int l0 = 0; l0 < d.L; l0 += Q) {
    __syncthreads();            // the previous chunk is done with sX, sB, sW
    for (int i = tid; i < Q * P; i += NTHREADS) {
      const int j = i / P, p = i - j * P;
      sX[i] = to_f(xb[(l0 + j) * d.x_sl + p]);
    }
    for (int i = tid; i < Q * N; i += NTHREADS) {
      const int j = i / N, n = i - j * N;
      sB[j * LDN + n] = to_f(bb[(l0 + j) * d.b_sl + n]);
    }
    for (int j = tid; j < Q; j += NTHREADS) sDt[j] = dtb[(long long)(l0 + j) * d.H];
    __syncthreads();
    if (tid < 32) {             // inclusive scan of dt*A by one warp
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * tid + e;
        v[e] = idx < Q ? sDt[idx] * A : 0.f;
      }
      v[1] += v[0]; v[2] += v[1]; v[3] += v[2];
      float run = v[3];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += t;
      }
      const float excl = run - v[3];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * tid + e;
        if (idx < Q) sCum[idx] = v[e] + excl;
      }
    }
    __syncthreads();
    const float cum_end = sCum[Q - 1];
    for (int j = tid; j < Q; j += NTHREADS) sW[j] = expf(cum_end - sCum[j]) * sDt[j];

    for (int q0 = 0; q0 < Q; q0 += QT) {
      const int rows = min(QT, Q - q0);
      const int jmax = q0 + rows;     // keys [0, jmax) reach some row of the tile
      __syncthreads();                // the previous tile is done with sC, sS
      for (int i = tid; i < rows * N; i += NTHREADS) {
        const int r = i / N, n = i - r * N;
        sC[r * LDN + n] = to_f(cb[(l0 + q0 + r) * d.c_sl + n]);
      }
      __syncthreads();

      // scores of rows r0, r1 against keys tx + 16k
      const int i0 = q0 + r0, i1 = q0 + r1;
      const bool ok0 = r0 < rows, ok1 = r1 < rows;
      const float cum0 = ok0 ? sCum[i0] : 0.f, cum1 = ok1 ? sCum[i1] : 0.f;
      {
        float a0[8], a1[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) a0[k] = a1[k] = 0.f;
        const float* c0p = sC + r0 * LDN;
        const float* c1p = sC + r1 * LDN;
#pragma unroll 2
        for (int n = 0; n < N; ++n) {
          const float cv0 = c0p[n], cv1 = c1p[n];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int j = tx + 16 * k;
            if (j < jmax) {
              const float bv = sB[j * LDN + n];
              a0[k] += cv0 * bv;
              a1[k] += cv1 * bv;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int j = tx + 16 * k;
          if (j < jmax) {
            const float cj = sCum[j], dtj = sDt[j];
            // mask before exp: for j > i the exponent is positive
            sS[r0 * LDS + j] = (ok0 && j <= i0) ? a0[k] * expf(cum0 - cj) * dtj : 0.f;
            sS[r1 * LDS + j] = (ok1 && j <= i1) ? a1[k] * expf(cum1 - cj) * dtj : 0.f;
          }
        }
      }
      __syncthreads();

      // y of rows r0, r1 at columns tx + 16k
      {
        float y0[4], y1[4], z0[4], z1[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) y0[k] = y1[k] = z0[k] = z1[k] = 0.f;
        const float* s0p = sS + r0 * LDS;
        const float* s1p = sS + r1 * LDS;
#pragma unroll 2
        for (int j = 0; j < jmax; ++j) {
          const float s0 = s0p[j], s1 = s1p[j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = tx + 16 * k;
            if (p < P) {
              const float xv = sX[j * P + p];
              y0[k] += s0 * xv;
              y1[k] += s1 * xv;
            }
          }
        }
        const float* c0p = sC + r0 * LDN;
        const float* c1p = sC + r1 * LDN;
#pragma unroll 2
        for (int n = 0; n < N; ++n) {
          const float cv0 = c0p[n], cv1 = c1p[n];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = tx + 16 * k;
            if (p < P) {
              const float hv = sH[p * LDN + n];
              z0[k] += cv0 * hv;
              z1[k] += cv1 * hv;
            }
          }
        }
        const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = tx + 16 * k;
          if (p < P) {
            if (ok0) store_f(y0[k] + e0 * z0[k], &yb[(l0 + i0) * y_sl + p]);
            if (ok1) store_f(y1[k] + e1 * z1[k], &yb[(l0 + i1) * y_sl + p]);
          }
        }
      }
    }
    __syncthreads();            // every tile has read the previous state

    // state update: rows pg + 16a (a < 4) by columns ng + 16c (c < 8)
    {
      const int pg = tid >> 4, ng = tid & 15;
      float acc[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
#pragma unroll 2
      for (int j = 0; j < Q; ++j) {
        const float w = sW[j];
        float xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int p = pg + 16 * a;
          xv[a] = p < P ? sX[j * P + p] * w : 0.f;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = ng + 16 * c;
          if (n < N) {
            const float bv = sB[j * LDN + n];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][c] += xv[a] * bv;
          }
        }
      }
      const float decay_end = expf(cum_end);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int p = pg + 16 * a;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = ng + 16 * c;
          if (p < P && n < N) sH[p * LDN + n] = sH[p * LDN + n] * decay_end + acc[a][c];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, void* y, int B, const Dims& d, cudaStream_t stream) {
  const size_t smem = smem_bytes(d.Q, d.P, d.N);
  auto kern = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(d.H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), d);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B,L,H,P); b, c: (B,L,G,N); last dims contiguous, the other strides in
// elements in `strides` = {x_sb, x_sl, x_sh, b_sb, b_sl, b_sg, c_sb, c_sl,
// c_sg}.  dt: contiguous (B,L,H) float32; a_log: (H,) float32.  y: contiguous
// (B,L,H,P) of x's type.  dtype: 0 float32, 1 bfloat16 (x, b, c, y).
// Needs chunk <= 128 dividing L, P <= 64, N <= 128, G dividing H.  Returns a
// cudaError_t (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                            const void* b, const void* c, void* y, int B, int L,
                            int H, int G, int P, int N, int chunk,
                            const long long* strides, int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || P <= 0 || N <= 0 || H % G != 0 ||
      chunk <= 0 || chunk > MAX_Q || L % chunk != 0 || P > MAX_P || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  Dims d{L, H, G, P, N, chunk, strides[0], strides[1], strides[2], strides[3],
         strides[4], strides[5], strides[6], strides[7], strides[8]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, a_log, b, c, y, B, d, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dt, a_log, b, c, y, B, d, st);
  return (int)cudaErrorInvalidValue;
}
