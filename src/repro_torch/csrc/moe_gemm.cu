// Ragged batched float32 products of the MoE experts for Hopper (sm_90a),
// plain C interface.
//
// Replaces no TPU kernel: the JAX package leaves the experts' einsum to XLA
// over the padded (E, B*C, D) slot layout.  It was added because that padded
// product, run as a float32 `torch.bmm`, multiplied rows of zeros: under
// capacity most of each expert's B*C slots hold no token.  The gather
// dispatch (`models/moe.py`) puts each expert's kept rows first in its slot
// block and hands over their count `rows[e]` as a device tensor, so the
// products can skip the empty rows without a host sync.  Three forms, each
// batched over the experts e, with T = B*C slots an expert:
//
//   NN  Y[e] = X[e] @ W[e]        X (E,T,K), W (E,K,N) -> Y (E,T,N)
//   NT  D[e] = G[e] @ W[e]^T      G (E,T,N), W (E,K,N) -> D (E,T,K)
//   TN  V[e] = X[e]^T @ G[e]      X (E,T,K), G (E,T,N) -> V (E,K,N)
//
// NN and NT compute rows [0, rows[e]) and store zeros in rows [rows[e], T);
// TN sums over rows [0, rows[e]) only, and an expert with no rows gets a
// zero V[e].  Rows past rows[e] are never read, so every output equals
// `torch.bmm` over the same layout whose rows past rows[e] are zero.
//
// What bounds it on the H100: operations.  float32 with TF32 off has no
// tensor-core path, so the products run on the FFMA units (67 TFLOP/s at
// 700 W); at the experts' widths (granite-moe: K, N of 512 and 1536) a tile
// does hundreds of FMAs for every byte it loads.
//
// What the design does about it: a register-blocked tile GEMM.  A block of
// 256 threads computes a 128 x 128 tile of one expert, each thread an 8 x 8
// micro-tile held in registers (two 4-row by two 4-column quads, so its
// shared-memory reads are 16-byte and conflict-free), over k-steps of 8.  A
// and B tiles are staged k-major in shared memory through a four-stage
// cp.async ring; each thread makes 4-byte copies, which lets one loader
// serve a tile stored either way round (a transposing store into the ring
// for operands contiguous along k), masks ragged edges of any width by
// zero-filling (no alignment is required of D or F), and keeps three tiles
// in flight while the fourth is multiplied.  Row tiles that start at or
// past rows[e] store zeros and return; the TN form's loop ends at rows[e].
// Sums run in one fixed order a block, with no split-K and no atomics, so
// the results are deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int STAGES = 4;
constexpr int NT = 256;
constexpr int LD = BM + 4;      // a k-row of a staged tile: padded against bank conflicts

// C (M x N a batch) = sum over k < K of A(m, k) B(k, n), for each batch e.
// A(m, k) = a[e * a_e + m * lda_m + k * lda_k], B(k, n) likewise, C(m, n) =
// c[e * c_e + m * ldc + n].  rows[e] bounds m (ragged_m) or k.
struct Problem {
  const float* a;
  const float* b;
  float* c;
  const int* rows;
  int M, N, K;
  int lda_m, lda_k, ldb_k, ldb_n, ldc;
  long long a_e, b_e, c_e;
  int vec_c;                    // C's rows and base allow 16-byte stores
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte global -> shared copy; ok false zero-fills and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A_K: A is contiguous along k (else along m); B_K: B along k (else along
// n); RAGGED_M: rows[e] bounds the output rows (else the reduction)
template <bool A_K, bool B_K, bool RAGGED_M>
__global__ void __launch_bounds__(NT, 2) moe_gemm_kernel(Problem p) {
  __shared__ __align__(16) float As[STAGES][BK][LD];
  __shared__ __align__(16) float Bs[STAGES][BK][LD];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int rows = min(max(p.rows[e], 0), RAGGED_M ? p.M : p.K);
  const int m_lim = RAGGED_M ? rows : p.M;
  const int k_lim = RAGGED_M ? p.K : rows;
  float* c = p.c + e * p.c_e;

  if (m0 >= m_lim) {            // a row tile wholly past rows[e]: zeros
    for (int i = tid; i < BM * BN; i += NT) {
      const int r = m0 + i / BN, col = n0 + i % BN;
      if (r < p.M && col < p.N) c[(long long)r * p.ldc + col] = 0.f;
    }
    return;
  }

  const float* a = p.a + e * p.a_e;
  const float* b = p.b + e * p.b_e;
  // this thread's four elements of each staged A and B tile: neighbouring
  // threads on neighbouring addresses of the contiguous dimension
  int a_m[4], a_k[4], b_n[4], b_k[4], a_off[4], b_off[4];
  bool a_ok[4], b_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a_m[i] = A_K ? tid / BK + 32 * i : tid % BM;
    a_k[i] = A_K ? tid % BK : tid / BM + 2 * i;
    b_n[i] = B_K ? tid / BK + 32 * i : tid % BN;
    b_k[i] = B_K ? tid % BK : tid / BN + 2 * i;
    a_ok[i] = m0 + a_m[i] < m_lim;
    b_ok[i] = n0 + b_n[i] < p.N;
    a_off[i] = (m0 + a_m[i]) * p.lda_m + a_k[i] * p.lda_k;
    b_off[i] = (n0 + b_n[i]) * p.ldb_n + b_k[i] * p.ldb_k;
  }
  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = a_ok[i] && k0 + a_k[i] < k_lim;
      cp_async4(&As[stage][a_k[i]][a_m[i]], ok ? a + a_off[i] + k0 * p.lda_k : a, ok);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = b_ok[i] && k0 + b_k[i] < k_lim;
      cp_async4(&Bs[stage][b_k[i]][b_n[i]], ok ? b + b_off[i] + k0 * p.ldb_k : b, ok);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ktiles = (k_lim + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    // tile kt has landed, and every thread is done with the stage that
    // tile kt + STAGES - 1 overwrites
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const int s = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[s][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // rows of a ragged tile past rows[e] read zeros, so they store zeros
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= p.M) continue;
    float* crow = c + (long long)r * p.ldc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (p.vec_c && col + 3 < p.N) {
        *reinterpret_cast<float4*>(crow + col) = make_float4(
            acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < p.N) crow[col + j] = acc[i][h * 4 + j];
      }
    }
  }
}

template <bool A_K, bool B_K, bool RAGGED_M>
int launch(const Problem& p, int E, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, E);
  moe_gemm_kernel<A_K, B_K, RAGGED_M><<<grid, NT, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename Kern>
int kernel_info(Kern kern, int* info) {
  cudaFuncAttributes a{};
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], kern, NT, 0);
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = (int)a.sharedSizeBytes;
  return (int)e;
}

}  // namespace

// Kernel i (0..2: the NN, NT and TN forms): its name and info = {registers,
// local bytes a thread, shared bytes a block, blocks an SM}.  Returns a
// cudaError_t, or -1 past the last kernel.
extern "C" int moe_gemm_kernel_info(int i, const char** name, int* info) {
  static const char* names[3] = {"moe_gemm_kernel<nn>", "moe_gemm_kernel<nt>",
                                 "moe_gemm_kernel<tn>"};
  if (i < 0 || i >= 3) return -1;
  *name = names[i];
  switch (i) {
    case 0: return kernel_info(moe_gemm_kernel<true, false, true>, info);
    case 1: return kernel_info(moe_gemm_kernel<true, true, true>, info);
    default: return kernel_info(moe_gemm_kernel<false, false, false>, info);
  }
}

// form 0 (NN): a = X (E,T,K), b = W (E,K,N), c = Y (E,T,N); form 1 (NT):
// a = G (E,T,N), b = W (E,K,N), c = D (E,T,K); form 2 (TN): a = X (E,T,K),
// b = G (E,T,N), c = V (E,K,N).  All contiguous float32 on the device; rows:
// device int32 (E,), each clamped to [0, T].  Returns a cudaError_t (0 on
// success).
extern "C" int moe_gemm(int form, const void* a, const void* b, void* c,
                        const void* rows, int E, int T, int K, int N,
                        void* stream) {
  // offsets inside one expert's matrices, a tile's masked edge included,
  // are 32-bit
  const long long widest = T > K ? (T > N ? T : N) : (K > N ? K : N);
  if (E <= 0 || T <= 0 || K <= 0 || N <= 0 || E > 65535 ||
      (widest + BM) * (K > N ? K : N) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Problem p{static_cast<const float*>(a), static_cast<const float*>(b),
            static_cast<float*>(c), static_cast<const int*>(rows)};
  const long long tk = (long long)T * K, tn = (long long)T * N, kn = (long long)K * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0:   // A = X (m = t, k), B = W (k, n)
      p.M = T; p.N = N; p.K = K;
      p.lda_m = K; p.lda_k = 1; p.ldb_k = N; p.ldb_n = 1; p.ldc = N;
      p.a_e = tk; p.b_e = kn; p.c_e = tn;
      break;
    case 1:   // A = G (m = t, k = n), B(k = n, n = k) = W[k, n]
      p.M = T; p.N = K; p.K = N;
      p.lda_m = N; p.lda_k = 1; p.ldb_k = 1; p.ldb_n = N; p.ldc = K;
      p.a_e = tn; p.b_e = kn; p.c_e = tk;
      break;
    case 2:   // A(m = k, k = t) = X[t, k], B = G (k = t, n)
      p.M = K; p.N = N; p.K = T;
      p.lda_m = 1; p.lda_k = K; p.ldb_k = N; p.ldb_n = 1; p.ldc = N;
      p.a_e = tk; p.b_e = tn; p.c_e = kn;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  p.vec_c = p.ldc % 4 == 0 && p.c_e % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
  switch (form) {
    case 0: return launch<true, false, true>(p, E, st);
    case 1: return launch<true, true, true>(p, E, st);
    default: return launch<false, false, false>(p, E, st);
  }
}
