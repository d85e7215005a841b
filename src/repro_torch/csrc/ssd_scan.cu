// Mamba-2 SSD chunked scan forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_chunked_pallas` in
// src/repro/kernels/ssd_scan.py:24.  Same function: for each (batch, head)
// the sequence is cut into chunks of Q tokens and a (P,N) float32 state h is
// carried across them.  Within a chunk, with cum the inclusive cumsum of
// dt*A (A = -exp(a_log)):
//   y   = (C B^T . decay . dt^T) x + exp(cum) . (C h^T),
//         decay[i,j] = exp(cum_i - cum_j) for i >= j, else 0
//   h  <- exp(cum_Q) h + x^T (B . exp(cum_Q - cum) . dt)
// B and C of group h / (H/G) serve head h.  Inputs are float32 or bf16, the
// state and all arithmetic float32, y is written in x's type.
//
// What bounds it on the H100: operations.  One call of the main path (one
// replica's shard at R=4: B 2, L 2048, H 64, P 64, N 128, Q 128) counts
// 1.51e10 FLOP in the causal triangle: 0.225 ms at the 67 TFLOP/s float32
// rate (float32 parity keeps it off the tensor cores), against 0.14 GB of
// inputs and outputs (0.042 ms).
//
// The TPU kernel walks the chunks of a (batch, head) in order.  Only the
// (P,N) state carry is sequential, so this is Mamba-2's own split into three
// launches on one stream:
//  1. chunk states, grid (chunk, head, batch): the chunk's cumsum (in
//     order, by one thread, as the reference sums it) to a (B,nc,H,Q) scratch, and its
//     own state contribution S_c = (B . w)^T x, w_j = exp(cum_Q - cum_j) dt_j,
//     to a (B,nc,H,N,P) scratch (state stored transposed, n-major, so that
//     phase 3 reads it as float4 rows of p);
//  2. state passing, grid (N*P / 256, head, batch): a thread walks the
//     chunks of one state element, h_in[0] = 0, h_in[c+1] = exp(cum_Q[c])
//     h_in[c] + S_c (a product, never a division: exp(cum_Q) may underflow
//     to 0), and writes h_in[c] over S_c;
//  3. chunk scan, grid (query tile of 64 rows, chunk, head x batch):
//     y = exp(cum) . (C h_in^T) + sum over key tiles of 64 of
//     (C B^T . decay . dt) x, with the score tile masked BEFORE exp (above
//     the diagonal cum_i - cum_j > 0 can pass fp32's exp limit, and inf * 0
//     would be NaN).  y is written once.
// All products are register-tiled on the FMA units: a thread owns a 4 x 4
// (or 8 x 4) micro-tile, operands come as float4 rows from shared memory
// padded by 4 floats (rows 4 banks apart), so one shared load feeds 8 or
// more FMAs.  float32 tiles with 16-byte aligned rows arrive by cp.async
// (zero-filled past the chunk's end); bf16 and unaligned views are loaded,
// widened and stored.  Strided views (slices of the model's conv output)
// are read in place.  Shared memory is 102-104 KB a block, so two blocks
// (16 warps) share an SM in phases 1 and 3.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int NT = 256;
constexpr int MAX_Q = 128;     // rows of a chunk tile
constexpr int MAX_P = 64;      // tiles are padded to these widths
constexpr int MAX_N = 128;
constexpr int LDX = MAX_P + 4;    // rows of x and of the n-major state
constexpr int LDB = MAX_N + 4;    // rows of B and C
constexpr int QT = 64;         // query rows per phase-3 block
constexpr int KT = 64;         // keys per phase-3 tile
constexpr int LDS = KT + 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

struct Dims {
  int L, H, G, P, N, Q, nc;
  long long x_sb, x_sl, x_sh, b_sb, b_sl, b_sg, c_sb, c_sl, c_sg;
  int vec;                      // float32 inputs with 16-byte aligned rows
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, ROWS) x columns [0, COLS) of a row-major tile (row stride
// `stride` elements) into shared memory as float32 (row stride `ld`); rows
// >= nrows and columns >= ncols are zero.  With `vec` (float32, 16-byte
// aligned rows) the copy is cp.async and completes at the next wait.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride, int nrows,
                                          int ncols, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int C4 = COLS / 4;
      for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
        const int r = i / C4, c = 4 * (i - r * C4);
        const int bytes = r < nrows ? 4 * max(0, min(4, ncols - c)) : 0;
        cp_async16(dst + r * ld + c, bytes ? src + r * stride + c : src, bytes);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
    const int r = i / COLS, c = i - r * COLS;
    dst[r * ld + c] = (r < nrows && c < ncols) ? to_f(src[r * stride + c]) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// 1. chunk states
// ---------------------------------------------------------------------------
constexpr size_t STATE_SMEM =
    sizeof(float) * ((size_t)MAX_Q * LDX + (size_t)MAX_Q * LDB + 3 * MAX_Q);

template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a_log, const T* __restrict__ bm,
                       float* __restrict__ cum, float* __restrict__ st, Dims d) {
  extern __shared__ float4 smem_f4[];
  float* sX = reinterpret_cast<float*>(smem_f4);   // MAX_Q x LDX
  float* sB = sX + MAX_Q * LDX;                    // MAX_Q x LDB
  float* sDt = sB + MAX_Q * LDB;                   // Q
  float* sCum = sDt + MAX_Q;                       // Q
  float* sW = sCum + MAX_Q;                        // Q

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = d.Q, tid = threadIdx.x;
  const int l0 = c * Q;
  const int g = h / (d.H / d.G);
  const long long bch = ((long long)b * d.nc + c) * d.H + h;   // (b, c, h)
  load_tile<T, MAX_Q, MAX_P>(sX, LDX, x + b * d.x_sb + l0 * d.x_sl + h * d.x_sh,
                             d.x_sl, Q, d.P, d.vec);
  load_tile<T, MAX_Q, MAX_N>(sB, LDB, bm + b * d.b_sb + l0 * d.b_sl + g * d.b_sg,
                             d.b_sl, Q, d.N, d.vec);
  cp_async_commit();
  const float* dtb = dt + ((long long)b * d.L + l0) * d.H + h;
  for (int j = tid; j < Q; j += NT) sDt[j] = dtb[(long long)j * d.H];
  __syncthreads();
  if (tid == 0) {
    // inclusive cumsum of dt*A, in order, as the reference sums it: the
    // rounding of the terms before j then cancels in cum_i - cum_j, the
    // exponent of the decays that matter (a tree scan rounds the two
    // differently and leaves ~3x the reference's error in y)
    const float A = -expf(a_log[h]);
    float run = 0.f;
#pragma unroll 8
    for (int j = 0; j < Q; ++j) {
      run = __fadd_rn(run, __fmul_rn(sDt[j], A));
      sCum[j] = run;
    }
  }
  __syncthreads();
  for (int j = tid; j < Q; j += NT) cum[bch * Q + j] = sCum[j];
  const float cum_end = sCum[Q - 1];
  for (int j = tid; j < Q; j += NT) sW[j] = expf(cum_end - sCum[j]) * sDt[j];
  cp_async_wait<0>();
  __syncthreads();

  // S_c^T[n][p] = sum_j B[j][n] w_j x[j][p]: n in {4tn + e, 64 + 4tn + e},
  // p = 4tp + k
  const int tp = tid & 15, tn = tid >> 4;
  float acc[8][4];
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[e][k] = 0.f;
#pragma unroll 4
  for (int j = 0; j < Q; ++j) {
    const float w = sW[j];
    float4 xv = ld4(sX + j * LDX + 4 * tp);
    xv.x *= w; xv.y *= w; xv.z *= w; xv.w *= w;
    const float4 b0 = ld4(sB + j * LDB + 4 * tn);
    const float4 b1 = ld4(sB + j * LDB + 64 + 4 * tn);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float bv0 = comp(b0, e), bv1 = comp(b1, e);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[e][k] = fmaf(bv0, comp(xv, k), acc[e][k]);
        acc[4 + e][k] = fmaf(bv1, comp(xv, k), acc[4 + e][k]);
      }
    }
  }
  float* sc = st + bch * d.N * d.P;
  const int p0 = 4 * tp;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int n = (e < 4 ? 0 : 64) + 4 * tn + (e & 3);
    if (n >= d.N || p0 >= d.P) continue;
    float* row = sc + (long long)n * d.P;
    if (p0 + 4 <= d.P && (d.P & 3) == 0) {
      *reinterpret_cast<float4*>(row + p0) =
          make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (p0 + k < d.P) row[p0 + k] = acc[e][k];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. state passing
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
ssd_state_pass_kernel(const float* __restrict__ cum, float* __restrict__ st, Dims d) {
  const int NP = d.N * d.P;
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= NP) return;
  const int h = blockIdx.y, b = blockIdx.z;
  constexpr int U = 8;          // chunks whose loads are in flight together
  float hs = 0.f;
  for (int c0 = 0; c0 < d.nc; c0 += U) {
    float s[U], decay[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long bch = ((long long)b * d.nc + c0 + u) * d.H + h;
      if (c0 + u < d.nc) {
        s[u] = st[bch * NP + e];
        decay[u] = expf(cum[bch * d.Q + d.Q - 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long bch = ((long long)b * d.nc + c0 + u) * d.H + h;
      if (c0 + u < d.nc) {
        st[bch * NP + e] = hs;  // the state that enters chunk c0 + u
        hs = fmaf(hs, decay[u], s[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. chunk scan
// ---------------------------------------------------------------------------
// sX and sS lie back to back and hold h_in^T (N x LDX) until the first key
// tile: the first B tile loads beside h_in and C
static_assert((size_t)KT * LDX + (size_t)QT * LDS >= (size_t)MAX_N * LDX,
              "h_in^T must fit over sX and sS");
static_assert(QT == KT, "a query tile's diagonal key tile is the one at q0");
constexpr size_t SCAN_SMEM =
    sizeof(float) * ((size_t)QT * LDB + (size_t)KT * LDB + (size_t)KT * LDX +
                     (size_t)QT * LDS + 2 * MAX_Q);

// s[a][e] += C[ty + 16a] . B[tx + 16e] over n < n_end.  On the diagonal
// tile, key tx + 16e > row ty + 16a whenever e > a: those are masked and
// not computed.
template <bool DIAG>
__device__ __forceinline__ void score_tile(float (&s)[4][4], const float* sC,
                                           const float* sB, int ty, int tx,
                                           int n_end) {
#pragma unroll 2
  for (int n = 0; n < n_end; n += 4) {
    float4 ca[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) ca[a] = ld4(sC + (ty + 16 * a) * LDB + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = ld4(sB + (tx + 16 * e) * LDB + n);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (DIAG && e > a) continue;
        float v = s[a][e];
        v = fmaf(ca[a].x, bv[e].x, v);
        v = fmaf(ca[a].y, bv[e].y, v);
        v = fmaf(ca[a].z, bv[e].z, v);
        v = fmaf(ca[a].w, bv[e].w, v);
        s[a][e] = v;
      }
  }
}

// acc[a][k] += sum_j S[ty + 16a][j] x[j][4tx + k] over the tile's keys.  On
// the diagonal tile, S[row][j] = 0 for j past the row's 16-key group, so
// key group g only reaches rows ty + 16a with a >= g.
template <bool DIAG>
__device__ __forceinline__ void sx_tile(float (&acc)[4][4], const float* sS,
                                        const float* sX, int ty, int tx) {
#pragma unroll
  for (int grp = 0; grp < 4; ++grp) {
#pragma unroll 2
    for (int j = 16 * grp; j < 16 * grp + 16; j += 4) {
      float4 xv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[e] = ld4(sX + (j + e) * LDX + 4 * tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (DIAG && a < grp) continue;
        const float4 sa = ld4(sS + (ty + 16 * a) * LDS + j);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[a][k] = fmaf(comp(sa, e), comp(xv[e], k), acc[a][k]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ cum, const float* __restrict__ st,
                      T* __restrict__ y, Dims d) {
  extern __shared__ float4 smem_f4[];
  float* sC = reinterpret_cast<float*>(smem_f4);   // QT x LDB   C rows of the tile
  float* sB = sC + QT * LDB;                       // KT x LDB   B of the key tile
  float* sX = sB + KT * LDB;                       // KT x LDX   x of the key tile
  float* sS = sX + KT * LDX;                       // QT x LDS   masked scores
  float* sH = sX;                                  // N x LDX    h_in^T, first
  float* sCum = sS + QT * LDS;                     // Q
  float* sDt = sCum + MAX_Q;                       // Q

  const int Q = d.Q, tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * QT;   // longest tiles first
  const int c = blockIdx.y;
  const int h = blockIdx.z % d.H, b = blockIdx.z / d.H;
  const int rows = min(QT, Q - q0);
  const int l0 = c * Q;
  const int g = h / (d.H / d.G);
  const long long bch = ((long long)b * d.nc + c) * d.H + h;
  const T* xb = x + b * d.x_sb + l0 * d.x_sl + h * d.x_sh;
  const T* bb = bm + b * d.b_sb + l0 * d.b_sl + g * d.b_sg;
  const int jmax = q0 + rows;   // keys [0, jmax) reach some row of the tile
  const int n_kt = (jmax + KT - 1) / KT;

  load_tile<T, QT, MAX_N>(sC, LDB, cm + b * d.c_sb + (l0 + q0) * d.c_sl + g * d.c_sg,
                          d.c_sl, rows, d.N, d.vec);
  load_tile<float, MAX_N, MAX_P>(sH, LDX, st + bch * d.N * d.P, d.P, d.N, d.P,
                                 (d.P & 3) == 0);
  load_tile<T, KT, MAX_N>(sB, LDB, bb, d.b_sl, min(KT, Q), d.N, d.vec);
  cp_async_commit();
  for (int j = tid; j < jmax; j += NT) {
    sCum[j] = cum[bch * Q + j];
    sDt[j] = dt[((long long)b * d.L + l0 + j) * d.H + h];
  }
  cp_async_wait<0>();
  __syncthreads();

  const int ty = tid >> 4, tx = tid & 15;    // rows ty + 16a, columns 4tx + k
  const int n_end = (d.N + 3) & ~3;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] = 0.f;

  // inter-chunk term: exp(cum_i) (C h_in^T)[i][p]
#pragma unroll 2
  for (int n = 0; n < n_end; n += 4) {
    float4 ca[4], hv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) ca[a] = ld4(sC + (ty + 16 * a) * LDB + n);
#pragma unroll
    for (int e = 0; e < 4; ++e) hv[e] = ld4(sH + (n + e) * LDX + 4 * tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[a][k] = fmaf(comp(ca[a], e), comp(hv[e], k), acc[a][k]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    const float ei = i < rows ? expf(sCum[q0 + i]) : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[a][k] *= ei;
  }

  // intra-chunk term, one key tile at a time: x of the tile loads while its
  // scores are computed, B of the next tile while S x runs
  for (int kt = 0; kt < n_kt; ++kt) {
    const int j0 = kt * KT;
    const bool diag = j0 == q0;
    __syncthreads();            // sX and sS (h_in^T first) are free
    load_tile<T, KT, MAX_P>(sX, LDX, xb + j0 * d.x_sl, d.x_sl, min(KT, Q - j0),
                            d.P, d.vec);
    cp_async_commit();
    cp_async_wait<1>();         // B of this tile has landed
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[a][e] = 0.f;
    if (diag) score_tile<true>(s, sC, sB, ty, tx, n_end);
    else score_tile<false>(s, sC, sB, ty, tx, n_end);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + ty + 16 * a;
      const float cum_i = i < jmax ? sCum[i] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + tx + 16 * e;
        // mask before exp: for j > i the exponent is positive
        sS[(ty + 16 * a) * LDS + tx + 16 * e] =
            (i < jmax && j <= i) ? s[a][e] * expf(cum_i - sCum[j]) * sDt[j] : 0.f;
      }
    }
    __syncthreads();            // sS is complete and sB is free
    if (kt + 1 < n_kt) {
      load_tile<T, KT, MAX_N>(sB, LDB, bb + (j0 + KT) * d.b_sl, d.b_sl,
                              min(KT, Q - j0 - KT), d.N, d.vec);
      cp_async_commit();
      cp_async_wait<1>();       // x of this tile has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (diag) sx_tile<true>(acc, sS, sX, ty, tx);
    else sx_tile<false>(acc, sS, sX, ty, tx);
  }

  const long long y_sl = (long long)d.H * d.P;
  T* yb = y + ((long long)b * d.L + l0 + q0) * y_sl + (long long)h * d.P;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (i >= rows) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * tx + k;
      if (p < d.P) store_f(acc[a][k], &yb[i * y_sl + p]);
    }
  }
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, void* y, float* cum, float* st, int B, const Dims& d,
           cudaStream_t stream) {
  cudaError_t e = prepare(ssd_chunk_state_kernel<T>, STATE_SMEM);
  if (e == cudaSuccess) e = prepare(ssd_chunk_scan_kernel<T>, SCAN_SMEM);
  if (e != cudaSuccess) return (int)e;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const float* dtf = static_cast<const float*>(dt);
  ssd_chunk_state_kernel<T><<<dim3(d.nc, d.H, B), NT, STATE_SMEM, stream>>>(
      xt, dtf, static_cast<const float*>(a_log), bt, cum, st, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_state_pass_kernel<<<dim3((d.N * d.P + NT - 1) / NT, d.H, B), NT, 0, stream>>>(
      cum, st, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_scan_kernel<T><<<dim3((d.Q + QT - 1) / QT, d.nc, d.H * B), NT, SCAN_SMEM,
                             stream>>>(xt, dtf, bt, static_cast<const T*>(c), cum, st,
                                       static_cast<T*>(y), d);
  return (int)cudaGetLastError();
}

// registers, local (spill) bytes a thread, shared bytes and resident blocks
// an SM of one kernel at its launch configuration
template <typename Kern>
int kernel_info(Kern kern, size_t smem, int* info) {
  cudaError_t e = smem ? prepare(kern, smem) : cudaSuccess;
  cudaFuncAttributes a{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kern, NT, smem);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)(a.sharedSizeBytes + smem);
  return (int)e;
}

}  // namespace

// Kernel i (0..4): its name and info = {registers, local bytes a thread,
// shared bytes a block, blocks an SM}.  Returns a cudaError_t, or -1 past
// the last kernel.
extern "C" int ssd_scan_kernel_info(int i, const char** name, int* info) {
  switch (i) {
    case 0: *name = "ssd_chunk_state_kernel<float>";
      return kernel_info(ssd_chunk_state_kernel<float>, STATE_SMEM, info);
    case 1: *name = "ssd_chunk_state_kernel<bf16>";
      return kernel_info(ssd_chunk_state_kernel<__nv_bfloat16>, STATE_SMEM, info);
    case 2: *name = "ssd_state_pass_kernel";
      return kernel_info(ssd_state_pass_kernel, 0, info);
    case 3: *name = "ssd_chunk_scan_kernel<float>";
      return kernel_info(ssd_chunk_scan_kernel<float>, SCAN_SMEM, info);
    case 4: *name = "ssd_chunk_scan_kernel<bf16>";
      return kernel_info(ssd_chunk_scan_kernel<__nv_bfloat16>, SCAN_SMEM, info);
    default: return -1;
  }
}

// x: (B,L,H,P); b, c: (B,L,G,N); last dims contiguous, the other strides in
// elements in `strides` = {x_sb, x_sl, x_sh, b_sb, b_sl, b_sg, c_sb, c_sl,
// c_sg}.  dt: contiguous (B,L,H) float32; a_log: (H,) float32.  y: contiguous
// (B,L,H,P) of x's type.  Scratch, float32, contiguous: cum (B,nc,H,chunk)
// and states (B,nc,H,N,P), nc = L / chunk.  dtype: 0 float32, 1 bfloat16
// (x, b, c, y).  Needs chunk <= 128 dividing L, P <= 64, N <= 128, G
// dividing H.  Returns a cudaError_t (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                            const void* b, const void* c, void* y, void* cum,
                            void* states, int B, int L, int H, int G, int P,
                            int N, int chunk, const long long* strides,
                            int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || G <= 0 || P <= 0 || N <= 0 || H % G != 0 ||
      chunk <= 0 || chunk > MAX_Q || L % chunk != 0 || P > MAX_P || N > MAX_N)
    return (int)cudaErrorInvalidValue;
  bool vec = dtype == 0 &&
             ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
               reinterpret_cast<uintptr_t>(c)) % 16) == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 4 == 0;
  Dims d{L, H, G, P, N, chunk, L / chunk, strides[0], strides[1], strides[2],
         strides[3], strides[4], strides[5], strides[6], strides[7], strides[8],
         vec ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* cf = static_cast<float*>(cum);
  float* sf = static_cast<float*>(states);
  if (dtype == 0) return launch<float>(x, dt, a_log, b, c, y, cf, sf, B, d, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dt, a_log, b, c, y, cf, sf, B, d, st);
  return (int)cudaErrorInvalidValue;
}
