// Tensor-core and asynchronous-copy primitives shared by the bf16 attention
// kernels of this directory (flash_attention.cu, paged_attention.cu):
// mma.sync.m16n8k16 bf16 products with f32 sums, ldmatrix fragment loads
// from XOR-swizzled shared tiles, 16-byte cp.async copies, and what each
// padded tile width sets.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_kernels {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// Element offset of 16-byte chunk c of row r in a [rows][DP] bf16 tile.
// Chunks are XOR-swizzled by row inside groups of 8 (the last group of a
// row of 20 chunks, DP = 160, is 4 wide), so the 8 rows one ldmatrix reads
// at the same logical chunk land in different banks: no conflict in a
// group of 8, two-way in the 4-wide group of DP = 160 (a 320-byte row puts
// rows r and r + 4 on the same banks there).
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = DP / 8;
  constexpr int kFull = kChunks / 8 * 8;  // chunks in whole groups of 8
  constexpr int kRest = kChunks - kFull;  // width of the last, partial group
  static_assert(DP % 16 == 0 && (kRest == 0 || kRest == 2 || kRest == 4),
                "padded widths 16, 32, 64, 128, 160 and 256");
  const int mask = c < kFull ? 7 : kRest - 1;
  return r * DP + ((c ^ (r & mask)) << 3);
}

// What the padded width DP sets in the tensor-core kernels (64 stacked
// rows and two warpgroups of 64-key tiles per CTA): K/V tiles in flight
// per warpgroup (shared memory holds one at DP = 256), whether the Q
// fragments live in registers (up to 128) or are re-read from shared
// memory at each k-step, and how many 16-column V fragments are loaded
// before their mma chains.
template <int DP>
struct TcShape {
  static constexpr int kStages = DP <= 160 ? 2 : 1;
  static constexpr bool kQRegs = DP <= 128;
  static constexpr int kVChunk = DP <= 128 ? DP / 16 : DP == 160 ? 5 : 2;
  static_assert((DP / 16) % kVChunk == 0, "V fragments in whole chunks");
};

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a score in log2 units: s * scale * log2(e), or with soft-capping
// cap * tanh(s * scale / cap) * log2(e); a and b are precomputed per launch
template <bool kSoftcap>
__device__ __forceinline__ float score_log2(float s, float a, float b) {
  return kSoftcap ? b * tanhf(s * a) : s * a;
}

// barrier of one group of kThreads threads (ids from 1; 0 is __syncthreads)
template <int kThreads>
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kThreads) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace repro_kernels
