// Batched KV page gather for claim offload and restore, written for Hopper
// (sm_90a).  Replaces kernels/kv_block_copy.py:kv_block_copy_pallas:
// dst[m] = src[idx[m]] for whole pages.
//
// The kernel copies bytes, so float32, bfloat16, int8 and int32 pages take
// the same code.  What bounds it on the card: bytes (every byte is read once
// and written once, with no arithmetic).  The design gives each destination
// page a row of CTAs along gridDim.y, each copying one contiguous 32 KiB
// slice, so a gather of a few large pages still spreads over many SMs.  One
// body, templated on the word it moves, takes the widest of 16, 8, 4, 2 and
// 1 bytes that divides the page size and both base addresses (then every
// page starts on a word); words narrower than 16 bytes are moved several to
// a thread per round, so each thread keeps 16 bytes in flight as the
// 16-byte path does.  A snapshot page of 4 mod 16 bytes thus moves 4-byte
// words.  Indices are validated by the caller before the launch.  The
// kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kSliceBytes = kThreads * 8 * 16;  // bytes per CTA slice

template <typename Word>
__global__ void __launch_bounds__(kThreads)
    kv_block_copy_words(const Word* __restrict__ src, const int* __restrict__ idx,
                        Word* __restrict__ dst, long long page_words) {
  // 16 / sizeof(Word) words a round (at most 8): one 16-byte word for the
  // vector path, four 4-byte words for a 4 mod 16 page
  constexpr int kUnroll = 16 / sizeof(Word) < 8 ? 16 / sizeof(Word) : 8;
  constexpr long long kSliceWords = kSliceBytes / sizeof(Word);
  const long long m = blockIdx.x;
  const Word* s = src + (long long)idx[m] * page_words;
  Word* d = dst + m * page_words;
  const long long lo = (long long)blockIdx.y * kSliceWords;
  const long long hi = lo + kSliceWords < page_words ? lo + kSliceWords : page_words;
  long long i = lo + threadIdx.x;
  if constexpr (kUnroll > 1) {
    for (; i + (kUnroll - 1) * kThreads < hi; i += kUnroll * kThreads) {
      Word r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = s[i + u * kThreads];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d[i + u * kThreads] = r[u];
    }
  }
  for (; i < hi; i += kThreads) d[i] = s[i];
}

template <typename Word>
cudaError_t launch_words(const void* src, const int* idx, void* dst, long long page_bytes, int M,
                         cudaStream_t stream) {
  const long long page_words = page_bytes / (long long)sizeof(Word);
  const long long slices = (page_bytes + kSliceBytes - 1) / kSliceBytes;
  if (slices > 65535) return cudaErrorInvalidValue;
  dim3 grid(M, (unsigned)slices);
  kv_block_copy_words<Word><<<grid, kThreads, 0, stream>>>(
      static_cast<const Word*>(src), idx, static_cast<Word*>(dst), page_words);
  return cudaGetLastError();
}

// The word width (bytes) the gather moves for these operands: the widest of
// 16, 8, 4, 2, 1 dividing page_bytes and both base addresses.
int word_bytes(const void* src, const void* dst, long long page_bytes) {
  const uint64_t a = (uint64_t)page_bytes | (uint64_t)(uintptr_t)src | (uint64_t)(uintptr_t)dst;
  for (int w = 16; w > 1; w /= 2)
    if (a % w == 0) return w;
  return 1;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch.
int kv_block_copy(const void* src, const int* idx, void* dst, long long page_bytes, int M,
                  void* stream) {
  if (M <= 0 || page_bytes <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes(src, dst, page_bytes)) {
    case 16: return (int)launch_words<uint4>(src, idx, dst, page_bytes, M, s);
    case 8: return (int)launch_words<uint2>(src, idx, dst, page_bytes, M, s);
    case 4: return (int)launch_words<uint32_t>(src, idx, dst, page_bytes, M, s);
    case 2: return (int)launch_words<uint16_t>(src, idx, dst, page_bytes, M, s);
    default: return (int)launch_words<uint8_t>(src, idx, dst, page_bytes, M, s);
  }
}

}  // extern "C"
