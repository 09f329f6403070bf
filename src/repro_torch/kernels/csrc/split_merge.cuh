// The ordered merge of split-KV attention partials, shared by the split-KV
// decode kernel (paged_decode.cu) and the tensor-core chunked-prefill
// kernel (paged_attention.cu).
//
// Each (sequence, kv head) has R output rows (the G grouped queries at
// decode, the G * C (head, chunk position) rows at prefill) and n_split
// splits of its keys, the first n_pre over the block-table prefix and the
// rest over the in-flight keys (the decode tail, or the prefill chunk).
// Split i left f32 (m, l, acc) per row: m the largest score (natural log
// units), l the sum of exp(s - m), acc the sum of exp(s - m) v; an empty
// split has m = -inf and wrote no acc.  The merge gives
//   out = sum_i acc_i exp(m_i - M) / max(sum_i l_i exp(m_i - M), 1e-30),
// M = max_i m_i, skipping empty splits, computed in one pass with a running
// max (each fold rescales the sums to the larger max).  One CTA takes
// rows_per_cta rows of one (sequence, kv head); each thread 4 columns of a
// row (two 8-byte loads of acc) for one of `parts` parts (a constant of the
// caller): part j folds the prefix splits j, j + parts, ..., then the
// in-flight splits j, j + parts, ..., and part 0 folds in the other parts
// in order.  A split's place in the
// sums depends only on its index within the prefix or the in-flight keys,
// and the block table's width (which sets n_pre) adds only empty prefix
// splits, so a row's result does not depend on the batch width, its place
// in the batch or the table width.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_kernels {

struct SplitMerge {
  const float* part;  // m [BKV, n_split, R], l (same), acc [BKV, n_split, R, D]
  void* out;          // [BKV, R, D] contiguous
  int BKV, R, D, n_pre, n_split;
  int parts;          // threads per output element, 1 to 4, fixed per caller: the
                      // table's width must not move a split between parts
  int rows_per_cta;   // set by launch_split_merge
};

constexpr int kMergeThreads = 256;
constexpr int kMergeMaxParts = 4;

// Thread (part, row, 4 columns) folds its share of the row's splits into
// a running (M, L, O) in split order (the loads of several splits in flight
// at once), then part 0 folds in the other parts in order and writes the 4
// outputs.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) split_merge_kernel(SplitMerge p) {
  __shared__ float4 po[kMergeThreads];
  __shared__ float pm[kMergeThreads], pl[kMergeThreads];
  const int nq = p.D / 4, RQ = p.rows_per_cta * nq;
  const int idx = threadIdx.x % RQ, part = threadIdx.x / RQ;
  const int row = blockIdx.y * p.rows_per_cta + idx / nq, d4 = idx % nq * 4;
  const bool live = row < p.R;
  const long long total = (long long)p.BKV * p.n_split * p.R;
  const long long first = (long long)blockIdx.x * p.n_split * p.R + row;  // (bkv, split 0, row)
  const float* m = p.part + first;
  const float* l = p.part + total + first;
  const float* acc = p.part + 2 * total + first * p.D + d4;  // 8-byte aligned
  float M = -INFINITY, L = 0.f;
  float4 O = make_float4(0.f, 0.f, 0.f, 0.f);
  // (M, L, O) += split (mi, li, ai), rescaled to the larger max
  auto fold = [&](float mi, float li, const float4& a) {
    const float mn = fmaxf(M, mi);
    const float c = expf(M - mn), w = expf(mi - mn);
    L = fmaf(li, w, L * c);
    O.x = fmaf(a.x, w, O.x * c);
    O.y = fmaf(a.y, w, O.y * c);
    O.z = fmaf(a.z, w, O.z * c);
    O.w = fmaf(a.w, w, O.w * c);
    M = mn;
  };
  // prefix split i goes to part i % parts, in-flight split j to part
  // j % parts: the block table's width, which sets n_pre, moves no split
  // between parts
  auto add = [&](int first_split, int count) {
#pragma unroll 4
    for (int j = part; j < count; j += p.parts) {
      const long long r = (long long)(first_split + j) * p.R;
      const float mi = m[r], li = l[r];
      const float2 a0 = *reinterpret_cast<const float2*>(acc + r * p.D);
      const float2 a1 = *reinterpret_cast<const float2*>(acc + r * p.D + 2);
      const float4 a = make_float4(a0.x, a0.y, a1.x, a1.y);
      if (mi != -INFINITY) fold(mi, li, a);  // an empty split wrote no acc
    }
  };
  if (live) {
    add(0, p.n_pre);
    add(p.n_pre, p.n_split - p.n_pre);
  }
  po[threadIdx.x] = O;
  pm[threadIdx.x] = M;
  pl[threadIdx.x] = L;
  __syncthreads();
  if (part != 0 || !live) return;
  for (int j = 1; j < p.parts; ++j) {
    const float mj = pm[j * RQ + idx];
    if (mj != -INFINITY) fold(mj, pl[j * RQ + idx], po[j * RQ + idx]);
  }
  L = fmaxf(L, 1e-30f);
  T* out = static_cast<T*>(p.out) + ((long long)blockIdx.x * p.R + row) * p.D + d4;
  out[0] = from_f<T>(O.x / L);
  out[1] = from_f<T>(O.y / L);
  out[2] = from_f<T>(O.z / L);
  out[3] = from_f<T>(O.w / L);
}

// Launches the merge: parts threads per 4 output columns, as many rows per
// CTA as fill kMergeThreads.  A row needs D / 4 * parts <= kMergeThreads
// threads: D a multiple of 4 up to 256 at parts = 4 (the decode kernel; at
// D = 256 one row fills a CTA), up to 1024 at parts = 1 (the prefill
// kernel); anything else is refused.
template <typename T>
cudaError_t launch_split_merge(SplitMerge p, cudaStream_t s) {
  const int per_row = p.D / 4 * p.parts;
  if (p.parts < 1 || p.parts > kMergeMaxParts || p.D <= 0 || p.D % 4 || per_row > kMergeThreads)
    return cudaErrorInvalidValue;
  p.rows_per_cta = min(p.R, kMergeThreads / per_row);
  const dim3 grid(p.BKV, (p.R + p.rows_per_cta - 1) / p.rows_per_cta);
  split_merge_kernel<T><<<grid, p.rows_per_cta * per_row, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace repro_kernels
