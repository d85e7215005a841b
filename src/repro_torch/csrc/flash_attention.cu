// Causal GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_fwd` in
// src/repro/kernels/flash_attention.py:26.  Same function: softmax(q k^T *
// scale) v with an online softmax whose running max, denominator and
// accumulator are float32; q head h reads KV head h / G, so repeated KV is
// never stored.  It also writes the row log-sum-exp (B,H,S) float32 for a
// later backward kernel.
//
// Two instantiations of one algorithm, one per input type:
//
// * bfloat16: on the tensor cores.  What bounds it on the H100 is
//   operations at the 989 TFLOP/s bf16 rate (6.9e10 FLOP on the main path's
//   shape, B 2, S 2048, H 32, hd 128, causal: 0.07 ms).  A block holds 128
//   query rows of one head: 4 warps of 32 rows, two 16-row blocks each, so
//   that every K or V fragment read from shared memory feeds two products.
//   K and V tiles of 64 keys sit in a two-stage cp.async ring in shared
//   memory (rows padded by 16 bytes so that ldmatrix's 8 row addresses hit
//   8 distinct bank groups); the next tile is in flight while the current
//   one is used.  S = Q K^T and O += P V are mma.sync.m16n8k16 (bf16 in,
//   fp32 accumulators in registers: 255 a thread, two blocks an SM); Q and
//   K fragments come by ldmatrix, V by ldmatrix.trans.  The online softmax
//   runs on the score fragments in registers (a row is held by 4 lanes; max
//   by two shuffles; the scale folded into one FFMA before ex2), and P is
//   converted to bf16 in registers and fed straight back as the A operand
//   of the second product: the accumulator layout of two n8 tiles is the A
//   layout of one k16 step.  Hopper's wgmma with TMA-fed rings is the next
//   step for this kernel (mma.sync reaches about two thirds of its rate).
// * float32: on the FMA units (the training path keeps TF32 off for parity
//   with the reference, so the tensor cores are ruled out); the floor is
//   1.0 ms at the 67 TFLOP/s float32 rate.  A block holds 64 query rows and
//   walks K/V tiles of 64 keys; each thread owns a 4 x 4 micro-tile of
//   scores (rows ty + 16a, keys tx + 16b) and a 4 x hd/16 micro-tile of O.
//   Q and K stay row-major in shared memory, rows padded by 4 floats, and
//   each float4 of 4 Q rows and 4 K rows feeds 64 FMAs: 8 FMAs per shared
//   load, the same as a d-major copy would give, but the tiles arrive by
//   16-byte cp.async with no transpose.  K(t+1) is fetched while the
//   softmax and P V(t) run, V(t+1) while Q K(t+1)^T runs.
//
// Both: tiles above the causal diagonal are never loaded; the grid is
// (H, B, query tiles) with the longest causal rows dispatched first, so the
// last wave is not all long tiles; the (B,S,H,hd) layout is read through
// strides (rows 16-byte aligned, which the wrapper ensures); rows past S are
// zero-filled by cp.async and masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `bytes` < 16 zero-fills the rest.
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

// rows [row0, row0 + ROWS) of one head, HD elements each, into shared memory
// with row stride LD elements; rows at or past S are zero-filled.
template <typename T, int ROWS, int HD, int LD, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride,
                                          int row0, int S) {
  constexpr int PER_ROW = HD * (int)sizeof(T) / 16;
  constexpr int EPC = 16 / (int)sizeof(T);     // elements per 16-byte chunk
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i - r * PER_ROW) * EPC;
    const int s = row0 + r;
    const bool ok = s < S;
    cp_async16(dst + r * LD + c, ok ? src + s * stride + c : src, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
namespace bf {

constexpr int MT = 2;          // 16-row blocks a warp holds
constexpr int NT = 128;        // 4 warps
constexpr int BQ = 4 * 16 * MT;   // query rows per block
constexpr int BK = 64;         // keys per tile

template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }    // row stride, elements (odd x 16 B)

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)ld<HD>() * (BQ + 4 * BK);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x in one MUFU op (2^-inf = 0); P is rounded to bf16 before it is used
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Online softmax of one warp's 16-row block of scores (fragments of n8
// tiles: lane holds rows g and g + 8, keys 8n + 2tq + {0, 1}), in place: s
// becomes P (unnormalised), acc is rescaled, m and l (this lane's share of
// the row sum) are updated.  The max is taken on the raw scores and the
// scale folded into the exponent, p = 2^(s * scale * log2(e) - m).
template <int NS, int NO>
__device__ __forceinline__ void softmax_rows(float (&s)[NS][4], float (&acc)[NO][4],
                                             float (&m)[2], float (&l)[2],
                                             bool edge, int k0, int row0, int S,
                                             int causal, int tq, float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    if (edge) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * tq + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (col >= S || (causal && col > row)) s[n][e] = -INFINITY;
      }
    }
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float ms[2], al[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * scale_log2);
    // a row with no key yet keeps -inf; subtract 0 so 2^x gives 0, not NaN
    ms[r] = mn == -INFINITY ? 0.f : mn;
    al[r] = ex2(m[r] - ms[r]);
    m[r] = mn;
  }
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = ex2(fmaf(s[n][e], scale_log2, -ms[e >> 1]));
      rs[e >> 1] += s[n][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + rs[r];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= al[0];
    acc[n][1] *= al[0];
    acc[n][2] *= al[1];
    acc[n][3] *= al[1];
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, int H, int G, long long q_sb, long long q_ss,
                      long long q_sh, long long k_sb, long long k_ss,
                      long long k_sh, long long v_sb, long long v_ss,
                      long long v_sh, float scale_log2, int causal) {
  constexpr int LD = ld<HD>();
  constexpr int KS = HD / 16;    // k-steps of Q K^T
  constexpr int NS = BK / 8;     // n8 tiles of a score row block
  constexpr int NO = HD / 8;     // n8 tiles of an output row block
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* sK = sQ + BQ * LD;          // 2 stages of BK x LD
  __nv_bfloat16* sV = sK + 2 * BK * LD;      // 2 stages of BK x LD

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest rows first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + (h / G) * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + (h / G) * v_sh;

  const int k_end = causal ? min(q0 + BQ, S) : S;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_rows<__nv_bfloat16, BQ, HD, LD, NT>(sQ, qb, q_ss, q0, S);
  load_rows<__nv_bfloat16, BK, HD, LD, NT>(sK, kb, k_ss, 0, S);
  load_rows<__nv_bfloat16, BK, HD, LD, NT>(sV, vb, v_ss, 0, S);
  cp_async_commit();

  float acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) { m[mt][r] = -INFINITY; l[mt][r] = 0.f; }
  const int wrow = q0 + warp * 16 * MT;       // first query row of this warp
  const __nv_bfloat16* sQw = sQ + (warp * 16 * MT + (lane & 15)) * LD + (lane >> 4) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {      // the other stage was released at the end of t-1
      const int nk = (t + 1) * BK;
      load_rows<__nv_bfloat16, BK, HD, LD, NT>(sK + (stage ^ 1) * BK * LD, kb, k_ss, nk, S);
      load_rows<__nv_bfloat16, BK, HD, LD, NT>(sV + (stage ^ 1) * BK * LD, vb, v_ss, nk, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sKs = sK + stage * BK * LD;
    const __nv_bfloat16* sVs = sV + stage * BK * LD;

    // S = Q K^T: MT row blocks of 16 x 64 keys per warp; each K fragment
    // feeds 2 MT products
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4(qa[mt], sQw + mt * 16 * LD + kk * 16);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, sKs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qa[mt], kf[0], kf[1]);
          mma(s[mt][2 * np + 1], qa[mt], kf[2], kf[3]);
        }
      }
    }

    const int k0 = t * BK;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int rb = wrow + mt * 16;           // first row of this row block
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > rb);
      softmax_rows<NS, NO>(s[mt], acc[mt], m[mt], l[mt], edge, k0, rb + g, S,
                           causal, tq, scale_log2);
    }

    // O += P V: P from the score fragments (the accumulator layout of two n8
    // tiles is the A layout of one k16 step), V by ldmatrix.trans; each V
    // fragment feeds 2 MT products
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, sVs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][2 * dp], pa[mt], vf[0], vf[1]);
          mma(acc[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();            // this stage is free for tile t + 2
  }

  const long long o_ss = (long long)H * HD;
  __nv_bfloat16* ob = o + (long long)b * S * o_ss + (long long)h * HD + 2 * tq;
  float* lb = lse + ((long long)b * H + h) * S;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lt = l[mt][r];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      lt = fmaxf(lt, 1e-30f);
      const float inv = 1.f / lt;
      const int row = wrow + mt * 16 + g + 8 * r;
      if (row >= S) continue;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * o_ss + n * 8) =
            __floats2bfloat162_rn(acc[mt][n][2 * r] * inv, acc[mt][n][2 * r + 1] * inv);
      if (tq == 0) lb[row] = (m[mt][r] + log2f(lt)) * LN2;
    }
  }
}

}  // namespace bf

// ---------------------------------------------------------------------------
// float32: register-tiled on the FMA units
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NT = 256;        // 16 x 16 threads
constexpr int LDP = BK + 4;

template <int HD>
__host__ __device__ constexpr int ldq() { return HD + 4; }   // Q and K rows: 4 banks apart

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + BK) * ldq<HD>() + (size_t)BK * HD +
                          (size_t)BQ * LDP);
}

// VW consecutive floats from shared memory
template <int VW>
__device__ __forceinline__ void lds(float (&r)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x; r[1] = t.y;
  } else {
    r[0] = *p;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int G,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     float scale_log2, int causal) {
  constexpr int LDQ = ldq<HD>();
  constexpr int VW = HD >= 64 ? 4 : HD / 16;   // output columns per vector
  constexpr int NV = HD / (16 * VW);           // vectors per thread
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);   // BQ x LDQ
  float* sK = sQ + BQ * LDQ;                       // BK x LDQ
  float* sV = sK + BK * LDQ;                       // BK x HD
  float* sP = sV + BK * HD;                        // BQ x LDP

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest rows first
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + (h / G) * k_sh;
  const float* vb = v + b * v_sb + (h / G) * v_sh;

  const int k_end = causal ? min(q0 + BQ, S) : S;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_rows<float, BQ, HD, LDQ, NT>(sQ, qb, q_ss, q0, S);
  load_rows<float, BK, HD, LDQ, NT>(sK, kb, k_ss, 0, S);
  cp_async_commit();
  load_rows<float, BK, HD, HD, NT>(sV, vb, v_ss, 0, S);
  cp_async_commit();

  float acc[4][NV * VW];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NV * VW; ++c) acc[a][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) { m[a] = -INFINITY; l[a] = 0.f; }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const bool more = t + 1 < n_tiles;
    cp_async_wait<1>();         // K(t) (and Q) landed; V(t) may be in flight
    __syncthreads();

    // scores of rows ty + 16a against keys tx + 16c
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * a) * LDQ + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kc[c] = *reinterpret_cast<const float4*>(sK + (tx + 16 * c) * LDQ + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[a][c];
          x = fmaf(qa[a].x, kc[c].x, x);
          x = fmaf(qa[a].y, kc[c].y, x);
          x = fmaf(qa[a].z, kc[c].z, x);
          x = fmaf(qa[a].w, kc[c].w, x);
          s[a][c] = x;
        }
    }
    __syncthreads();            // every warp is done with sK
    if (more) {
      load_rows<float, BK, HD, LDQ, NT>(sK, kb, k_ss, k0 + BK, S);
      cp_async_commit();
    }

    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[a][c] * scale_log2;
        if (edge) {
          const int col = k0 + tx + 16 * c;
          if (col >= S || (causal && col > row)) x = -INFINITY;
        }
        s[a][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[a], mx);
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float alpha = exp2f(m[a] - ms);
      m[a] = mn;
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[a][c] - ms);
        sP[(ty + 16 * a) * LDP + tx + 16 * c] = p;
        ps += p;
      }
      l[a] = l[a] * alpha + ps;   // this thread's share of the row
#pragma unroll
      for (int c = 0; c < NV * VW; ++c) acc[a][c] *= alpha;
    }
    if (more) cp_async_wait<1>(); else cp_async_wait<0>();   // V(t) landed
    __syncthreads();            // and sP is complete

    // O += P V: rows ty + 16a, columns tx*VW + 16*VW*c + w
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(sP + (ty + 16 * a) * LDP + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float vv[VW];
          lds<VW>(vv, sV + (j + e) * HD + tx * VW + 16 * VW * c);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float p = e == 0 ? pa[a].x : e == 1 ? pa[a].y : e == 2 ? pa[a].z : pa[a].w;
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[a][c * VW + w] = fmaf(p, vv[w], acc[a][c * VW + w]);
          }
        }
      }
    }
    __syncthreads();            // every warp is done with sV and sP
    if (more) {
      load_rows<float, BK, HD, HD, NT>(sV, vb, v_ss, k0 + BK, S);
      cp_async_commit();
    }
  }

  const long long o_ss = (long long)H * HD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float lt = l[a];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + ty + 16 * a;
    if (row >= S) continue;
    lt = fmaxf(lt, 1e-30f);
    const float inv = 1.f / lt;
    float* orow = o + ((long long)b * S + row) * o_ss + (long long)h * HD;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float* p = orow + tx * VW + 16 * VW * c;
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[a][4 * c] * inv, acc[a][4 * c + 1] * inv,
                        acc[a][4 * c + 2] * inv, acc[a][4 * c + 3] * inv);
      } else {
#pragma unroll
        for (int w = 0; w < VW; ++w) p[w] = acc[a][c * VW + w] * inv;
      }
    }
    if (tx == 0) lse[((long long)b * H + h) * S + row] = (m[a] + log2f(lt)) * LN2;
  }
}

}  // namespace f32

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, int KV, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int BQ = BF ? bf::BQ : f32::BQ;
  constexpr int NT = BF ? bf::NT : f32::NT;
  constexpr size_t smem = BF ? bf::smem_bytes<HD>() : f32::smem_bytes<HD>();
  auto kern = [] {
    if constexpr (BF) return bf::flash_fwd_bf16_kernel<HD>;
    else return f32::flash_fwd_f32_kernel<HD>;
  }();
  const cudaError_t ready = prepare(kern, smem);
  if (ready != cudaSuccess) return (int)ready;
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, H / KV, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale * LOG2E, causal);
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

// registers, local (spill) bytes a thread, shared bytes and resident blocks
// an SM of one kernel at its launch configuration
template <typename Kern>
int kernel_info(Kern kern, size_t smem, int threads, int* info) {
  cudaError_t e = prepare(kern, smem);
  cudaFuncAttributes a{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kern, threads, smem);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)(a.sharedSizeBytes + smem);
  return (int)e;
}

template <int HD>
int info_hd(int bf16, int* info) {
  return bf16 ? kernel_info(bf::flash_fwd_bf16_kernel<HD>, bf::smem_bytes<HD>(), bf::NT, info)
              : kernel_info(f32::flash_fwd_f32_kernel<HD>, f32::smem_bytes<HD>(), f32::NT, info);
}

}  // namespace

// Kernel i (0..7: float32 then bfloat16, hd 16, 32, 64, 128): its name and
// info = {registers, local bytes a thread, shared bytes a block, blocks an
// SM}.  Returns a cudaError_t, or -1 past the last kernel.
extern "C" int flash_attention_kernel_info(int i, const char** name, int* info) {
  static const char* names[8] = {
      "flash_fwd_f32_kernel<16>", "flash_fwd_f32_kernel<32>",
      "flash_fwd_f32_kernel<64>", "flash_fwd_f32_kernel<128>",
      "flash_fwd_bf16_kernel<16>", "flash_fwd_bf16_kernel<32>",
      "flash_fwd_bf16_kernel<64>", "flash_fwd_bf16_kernel<128>"};
  if (i < 0 || i >= 8) return -1;
  *name = names[i];
  switch (i % 4) {
    case 0: return info_hd<16>(i / 4, info);
    case 1: return info_hd<32>(i / 4, info);
    case 2: return info_hd<64>(i / 4, info);
    default: return info_hd<128>(i / 4, info);
  }
}

// q: (B,S,H,hd), k/v: (B,S,KV,hd), last dim contiguous, the other strides in
// elements in `strides` = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
// v_sh}; every row 16-byte aligned (pointers and strides).  o: contiguous
// (B,S,H,hd) of q's type; lse: contiguous (B,H,S) float32.  dtype: 0
// float32, 1 bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int S, int H,
                                   int KV, int hd, const long long* strides,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const int align = dtype == 0 ? 4 : 8;      // elements in 16 bytes
  for (int i = 0; i < 9; ++i)
    if (strides[i] % align) return (int)cudaErrorMisalignedAddress;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, lse, B, S, H, KV, strides, scale, causal, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, S, H, KV, strides, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
