// Batched KV page gather for claim offload and restore, written for Hopper
// (sm_90a).  Replaces kernels/kv_block_copy.py:kv_block_copy_pallas:
// dst[m] = src[idx[m]] for whole pages.
//
// The kernel copies bytes, so float32, bfloat16 and int32 pages take the
// same code.  What bounds it on the card: bytes (every byte is read once and
// written once, with no arithmetic).  The design gives each destination page
// a row of CTAs along gridDim.y, each copying one contiguous slice with
// 16-byte vector loads and stores, so a gather of a few large pages still
// spreads over many SMs; pages whose size or addresses are not 16-byte
// aligned take the byte loop.  Indices are validated by the caller before
// the launch.  The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSliceVecs = kThreads * 8;  // 16-byte vectors per CTA slice

__global__ void __launch_bounds__(kThreads)
    kv_block_copy_vec(const uint4* src, const int* idx, uint4* dst, long long page_vecs) {
  const long long m = blockIdx.x;
  const uint4* s = src + (long long)idx[m] * page_vecs;
  uint4* d = dst + m * page_vecs;
  const long long lo = (long long)blockIdx.y * kSliceVecs;
  const long long hi = lo + kSliceVecs < page_vecs ? lo + kSliceVecs : page_vecs;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
    kv_block_copy_bytes(const uint8_t* src, const int* idx, uint8_t* dst, long long page_bytes) {
  const long long m = blockIdx.x;
  const uint8_t* s = src + (long long)idx[m] * page_bytes;
  uint8_t* d = dst + m * page_bytes;
  const long long slice = kSliceVecs * 16;
  const long long lo = (long long)blockIdx.y * slice;
  const long long hi = lo + slice < page_bytes ? lo + slice : page_bytes;
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) d[i] = s[i];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch.
int kv_block_copy(const void* src, const int* idx, void* dst, long long page_bytes, int M,
                  void* stream) {
  if (M <= 0 || page_bytes <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = page_bytes % 16 == 0 && (uintptr_t)src % 16 == 0 && (uintptr_t)dst % 16 == 0;
  if (vec) {
    const long long page_vecs = page_bytes / 16;
    const long long slices = (page_vecs + kSliceVecs - 1) / kSliceVecs;
    if (slices > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(M, (unsigned)slices);
    kv_block_copy_vec<<<grid, kThreads, 0, s>>>(static_cast<const uint4*>(src), idx,
                                                static_cast<uint4*>(dst), page_vecs);
  } else {
    const long long slices = (page_bytes + kSliceVecs * 16 - 1) / (kSliceVecs * 16);
    if (slices > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid(M, (unsigned)slices);
    kv_block_copy_bytes<<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(src), idx,
                                                  static_cast<uint8_t*>(dst), page_bytes);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
