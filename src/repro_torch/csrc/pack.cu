// Fused gather/pack of same-dtype leaves for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel `_pack_kernel` / `pack_leaves_pallas` in
// src/repro/kernels/pack.py.  Same function: every leaf is raveled and
// zero-padded to a multiple of a 1024-element tile (8 x 128) and the leaves
// are laid end to end, leaf-major, in one buffer, so the device->host
// snapshot that follows is one large copy per dtype group instead of one
// small copy per leaf.  The output equals `pack_leaves_ref` byte for byte.
//
// What bounds it on the H100: bytes.  It reads each leaf once and writes the
// packed buffer once; for the 4.87 GB of float32 parameters of the depth-4
// yi-6b job that is about 2.9 ms at 3.35 TB/s.  The device->host copy of the
// packed buffer after it is bound by the host link and takes far longer.
//
// What the design does about it: the grid runs over output tiles, one block
// per tile, leaf-major, as the TPU grid did; blocks run in any order, so each
// block finds its own leaf by a binary search over a small device table of
// (pointer, first tile, numel) and copies with neighbouring threads on
// neighbouring elements (coalesced reads and writes), writing zeros into the
// padding.  Elements are moved as unsigned integers of the dtype's size, so
// one kernel serves every dtype.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 8 * 128;
constexpr int NTHREADS = 256;

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
pack_kernel(const long long* __restrict__ table, int n_leaves, T* __restrict__ out) {
  const long long* ptrs = table;
  const long long* starts = table + n_leaves;
  const long long* numels = table + 2 * n_leaves;
  const long long tile = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;            // last leaf whose first tile <= tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const T* src = reinterpret_cast<const T*>(ptrs[lo]);
  const long long base = (tile - starts[lo]) * TILE;
  const long long numel = numels[lo];
  T* dst = out + tile * TILE;
  for (int e = threadIdx.x; e < TILE; e += NTHREADS) {
    const long long idx = base + e;
    dst[e] = idx < numel ? src[idx] : T(0);
  }
}

template <typename T>
int launch(const void* table, int n_leaves, long long total_tiles, void* out,
           cudaStream_t stream) {
  pack_kernel<T><<<(unsigned int)total_tiles, NTHREADS, 0, stream>>>(
      static_cast<const long long*>(table), n_leaves, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// table: device int64[3 * n_leaves] = {pointers, first tiles, numels}, first
// tiles ascending; out: device buffer of total_tiles * 1024 elements of
// `elem_size` bytes.  Returns a cudaError_t (0 on success).
extern "C" int pack_leaves(const void* table, int n_leaves, long long total_tiles,
                           void* out, int elem_size, void* stream) {
  if (n_leaves <= 0 || total_tiles <= 0 || total_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 1: return launch<uint8_t>(table, n_leaves, total_tiles, out, st);
    case 2: return launch<uint16_t>(table, n_leaves, total_tiles, out, st);
    case 4: return launch<uint32_t>(table, n_leaves, total_tiles, out, st);
    case 8: return launch<uint64_t>(table, n_leaves, total_tiles, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
