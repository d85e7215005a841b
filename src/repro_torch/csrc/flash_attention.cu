// Causal GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_fwd` in
// src/repro/kernels/flash_attention.py.  Same function: softmax(q k^T * scale)
// v with an online softmax whose running max, denominator and accumulator are
// float32; q head h reads KV head h / G, so repeated KV is never stored.  It
// also writes the row log-sum-exp (B,H,S) float32 for a later backward kernel.
//
// What bounds it on the H100: operations.  The training path runs it in
// float32 (TF32 is off for parity), so the products cannot use the tensor
// cores; the floor is the 67 TFLOP/s float32 rate.  One call of the main path
// (B 2, S 2048, H 32, hd 128, causal) is 6.9e10 FLOP, about 1.0 ms at that
// rate, against 0.13 GB of inputs and outputs.
//
// What the design does about it, simply and correctly first:
//  * one block per (q-tile of 64 rows, head, batch); the sequential k-block
//    grid axis of the TPU kernel becomes a loop inside the block, and k-tiles
//    above the diagonal are never visited;
//  * K/V tiles of 32 rows are staged in shared memory as float32 (bf16 inputs
//    are widened on load) and reused by all 64 query rows; rows are padded by
//    one float so the column walks hit distinct banks;
//  * 4 threads share a query row: each keeps 8 scores and hd/4 output columns
//    in registers, and the row's max and sum are reduced with warp shuffles;
//  * the (B,S,H,hd) layout is read through strides, with no transposes, and
//    the ragged edge (S not a multiple of a tile) is masked.
// Speed is later work: the score loop is bound by shared-memory loads, and
// the tensor cores (wgmma on bf16) are not used yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // keys per shared-memory tile
constexpr int NTHREADS = 256;   // BQ rows x 4 threads per row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (HD + 1) + (size_t)BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int G,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 float scale, int causal) {
  constexpr int LD = HD + 1;
  constexpr int PLD = BK + 1;
  constexpr int NJ = BK / 4;    // scores per thread
  constexpr int ND = HD / 4;    // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // BQ x LD, pre-scaled
  float* sK = sQ + BQ * LD;     // BK x LD
  float* sV = sK + BK * LD;     // BK x LD
  float* sP = sV + BK * LD;     // BQ x PLD probabilities of the current tile

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 2;       // query row within the tile
  const int quad = tid & 3;     // which quarter of the row this thread owns
  const int row = q0 + r;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / G) * k_sh;
  const T* vb = v + b * v_sb + (h / G) * v_sh;

  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int rr = i / HD, d = i % HD, s = q0 + rr;
    sQ[rr * LD + d] = s < S ? to_f(qb[s * q_ss + d]) * scale : 0.f;
  }

  float acc[ND];
#pragma unroll
  for (int dd = 0; dd < ND; ++dd) acc[dd] = 0.f;
  float m = -FLT_MAX, l = 0.f;

  // keys [0, k_end) can reach some row of this tile
  const int k_end = causal ? min(q0 + BQ, S) : S;
  const int n_tiles = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();            // previous tile fully consumed (and sQ written)
    for (int i = tid; i < BK * HD; i += NTHREADS) {
      const int c = i / HD, d = i % HD, s = k0 + c;
      const bool ok = s < S;
      sK[c * LD + d] = ok ? to_f(kb[s * k_ss + d]) : 0.f;
      sV[c * LD + d] = ok ? to_f(vb[s * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qv = sQ[r * LD + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) sc[j] += qv * sK[(quad + 4 * j) * LD + d];
    }

    float mx = -FLT_MAX;
    bool valid[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = k0 + quad + 4 * j;
      valid[j] = col < S && (!causal || col <= row);
      if (valid[j]) mx = fmaxf(mx, sc[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = valid[j] ? expf(sc[j] - m_new) : 0.f;
      sP[r * PLD + quad + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();               // the row's 4 threads share one warp

#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc[dd] *= alpha;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = sP[r * PLD + c];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) acc[dd] += p * sV[c * LD + quad + 4 * dd];
    }
  }

  if (row < S) {
    T* ob = o + ((long long)b * S + row) * H * HD + (long long)h * HD;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) store_f(acc[dd] / denom, &ob[quad + 4 * dd]);
    if (quad == 0) lse[((long long)b * H + h) * S + row] = m + logf(denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int KV, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, H / KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int S, int H, int KV, const long long* st,
                float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, S, H, KV, st, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, H, KV, st, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, H, KV, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, H, KV, st, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B,S,H,hd), k/v: (B,S,KV,hd), last dim contiguous, strides in elements
// in `strides` = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh}.
// o: contiguous (B,S,H,hd) of q's type; lse: contiguous (B,H,S) float32.
// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int S, int H,
                                   int KV, int hd, const long long* strides,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, lse, B, S, H, KV, strides, scale, causal, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, S, H, KV, strides, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
