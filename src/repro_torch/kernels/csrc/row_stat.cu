// Row statistics of the norms (mean, mean of squares, variance over the
// last dim of f32 rows) in one fixed order, written for Hopper (sm_90a).
// Replaces no TPU kernel: the reference reduces with jnp.mean / jnp.var
// inside rms_norm and layer_norm, which XLA lowers per shape.  On the card
// a library reduction spreads a row over more threads when fewer rows ride
// with it, so a decode step (a few rows) and a prefill chunk (hundreds)
// round the same row's sum differently, and the bits of a warm turn (a
// continuation fed through decode steps) leave those of a cold prefill.
// Here one warp reduces one row, whatever the number of rows: lane l adds
// the elements 4 (l + 32 k) + j, k ascending, j = 0..3, one round-to-
// nearest add at a time, and the lanes' sums meet in a fixed xor-shuffle
// tree.  A row of width d % 4 == 0 on a 16-byte boundary loads float4s,
// any other row the same elements one by one: the same adds in the same
// order, so the bits of a row never depend on the rows beside it, the
// number of rows, or its alignment.
//
// What bounds it on the card: bytes (each element read once, one float
// written per row).  Eight rows per 256-thread CTA; the loads of a lane are
// unrolled so several are in flight before the dependent adds.
//
// The kernel allocates nothing and does not synchronise; the caller passes
// the stream and checks the returned cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerCta = 8;
constexpr int kThreads = 32 * kRowsPerCta;

enum Stat { kMean = 0, kMeanSquare = 1, kVariance = 2 };

__device__ __forceinline__ float term(float x, int stat, float mu) {
  if (stat == kMeanSquare) return __fmul_rn(x, x);
  if (stat == kVariance) {
    const float c = __fsub_rn(x, mu);
    return __fmul_rn(c, c);
  }
  return x;
}

// The lane's sum of term(x[i]) over its elements, in the fixed order.
__device__ __forceinline__ float lane_sum(const float* __restrict__ xr, int d, bool vec, int lane,
                                          int stat, float mu) {
  float s = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll 8
    for (int i = lane; i < d / 4; i += 32) {
      const float4 v = x4[i];
      s = __fadd_rn(s, term(v.x, stat, mu));
      s = __fadd_rn(s, term(v.y, stat, mu));
      s = __fadd_rn(s, term(v.z, stat, mu));
      s = __fadd_rn(s, term(v.w, stat, mu));
    }
  } else {
    for (int base = 4 * lane; base < d; base += 128) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (base + j < d) s = __fadd_rn(s, term(xr[base + j], stat, mu));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;  // every lane holds the row's sum
}

__global__ void __launch_bounds__(kThreads)
    row_stat_kernel(const float* __restrict__ x, float* __restrict__ out, long long R, int d,
                    int stat) {
  const long long row = (long long)blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= R) return;
  const int lane = threadIdx.x & 31;
  const float* xr = x + row * (long long)d;
  const bool vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  const float n = (float)d;
  float mu = 0.f;
  if (stat == kVariance) mu = __fdiv_rn(lane_sum(xr, d, vec, lane, kMean, 0.f), n);
  const float s = lane_sum(xr, d, vec, lane, stat, mu);
  if (lane == 0) out[row] = __fdiv_rn(s, n);
}

}  // namespace

extern "C" {

// x: [R, d] f32 contiguous; out: [R] f32; stat: 0 mean, 1 mean of squares,
// 2 variance (population).  Returns cudaGetLastError() after the launch.
int row_stat_forward(const float* x, float* out, long long R, int d, int stat, void* stream) {
  if (R <= 0 || d <= 0 || stat < 0 || stat > 2) return (int)cudaErrorInvalidValue;
  const long long blocks = (R + kRowsPerCta - 1) / kRowsPerCta;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  row_stat_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, R, d, stat);
  return (int)cudaGetLastError();
}

}  // extern "C"
