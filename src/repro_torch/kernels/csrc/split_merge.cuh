// The ordered merge of split-KV attention partials, shared by every
// attention kernel of this directory (paged_decode.cu, paged_attention.cu,
// flash_attention.cu).
//
// The keys of a query row are cut into splits of kSplitKeys positions
// (attention_split.cuh).  Split i leaves f32 (m, l, acc) per row: m the
// largest score in log2 units, l the sum of exp2(s - m), acc the sum of
// exp2(s - m) v; a split in which the row attends no key has m = -inf.
// The merge folds the splits in ascending index into a running (M, L, O),
// skipping the empty ones:
//   M' = max(M, m_i),  c = exp2(M - M'),  w = exp2(m_i - M'),
//   L' = l_i w + L c,  O' = acc_i w + O c,
// and the output is O / max(L, 1e-30).  Every step is written with
// explicit round-to-nearest intrinsics, so no caller's inlining can fuse
// it differently: the split-KV kernels' merge kernel below and the flash
// kernel's in-CTA fold (which folds each split as soon as it is computed)
// give a row the same bits for the same partials.  A row's result depends
// only on its partials and their order, never on the batch width, its
// place in the batch, the table width or the kernel that made them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace repro_kernels {

// (M, L) += split (mi, li); returns the rescale factors c (old) and w (split)
__device__ __forceinline__ void fold_stats(float& M, float& L, float mi, float li, float& c,
                                           float& w) {
  const float mn = fmaxf(M, mi);
  c = exp2f(M - mn);
  w = exp2f(mi - mn);
  L = __fmaf_rn(li, w, __fmul_rn(L, c));
  M = mn;
}

__device__ __forceinline__ float fold_value(float o, float a, float c, float w) {
  return __fmaf_rn(a, w, __fmul_rn(o, c));
}

__device__ __forceinline__ float fold_finish(float o, float L) {
  return __fdiv_rn(o, fmaxf(L, 1e-30f));
}

// The output of a query row with no valid key at column col: the plain
// mean of the Sk value rows of its kv head (zeros when Sk = 0), as the dense
// reference's uniform softmax over masked scores gives it.  Only such rows
// call it; kept out of line so that its loop does not change the register
// allocation of the callers' main path.
template <typename T>
__device__ __noinline__ float mean_value(const T* vb, long long v_ss, int Sk, int col) {
  float sum = 0.f;
  for (int key = 0; key < Sk; ++key) sum += to_f<T>(vb[(long long)key * v_ss + col]);
  return Sk > 0 ? sum / (float)Sk : 0.f;
}

// Partials of BKV (sequence, kv head) pairs with R rows each: m [BKV,
// n_split, R], l (same), acc [BKV, n_split, R, D], contiguous.  Row r = g *
// RQ + i is query head g of the kv head at query index i, written to out
// + b * o_sb + (kv * G + g) * o_sh + i * o_si.  With mean_v set (the flash
// kernel's wide route), a row with no valid key gets the mean of its kv
// head's Sk value rows; otherwise zeros.
struct SplitMerge {
  const float* part;
  void* out;
  long long o_sb, o_sh, o_si;
  int BKV, KV, G, RQ, D, n_split;
  const void* mean_v;
  long long v_sb, v_sh, v_ss;
  int Sk;
};

constexpr int kMergeThreads = 256;

// One thread per (pair, row, 4 columns) folds the row's splits in order,
// the loads of several splits in flight at once.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) split_merge_kernel(SplitMerge p) {
  const int nq = p.D / 4, R = p.G * p.RQ;
  const long long idx = (long long)blockIdx.x * kMergeThreads + threadIdx.x;
  if (idx >= (long long)p.BKV * R * nq) return;
  const int bkv = (int)(idx / ((long long)R * nq));
  const int rem = (int)(idx % ((long long)R * nq));
  const int r = rem / nq, d4 = rem % nq * 4;
  const long long total = (long long)p.BKV * p.n_split * R;
  const long long first = (long long)bkv * p.n_split * R + r;  // (bkv, split 0, r)
  const float* m = p.part + first;
  const float* l = p.part + total + first;
  const float* acc = p.part + 2 * total + first * p.D + d4;  // 8-byte aligned
  float M = -INFINITY, L = 0.f;
  float O[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int i = 0; i < p.n_split; ++i) {
    const long long o = (long long)i * R;
    const float mi = m[o];
    if (mi == -INFINITY) continue;  // an empty split
    const float2 a0 = *reinterpret_cast<const float2*>(acc + o * p.D);
    const float2 a1 = *reinterpret_cast<const float2*>(acc + o * p.D + 2);
    float c, w;
    fold_stats(M, L, mi, l[o], c, w);
    O[0] = fold_value(O[0], a0.x, c, w);
    O[1] = fold_value(O[1], a0.y, c, w);
    O[2] = fold_value(O[2], a1.x, c, w);
    O[3] = fold_value(O[3], a1.y, c, w);
  }
  const int b = bkv / p.KV, kv = bkv % p.KV, g = r / p.RQ, i = r % p.RQ;
  T* out = static_cast<T*>(p.out) + b * p.o_sb + (long long)(kv * p.G + g) * p.o_sh +
           (long long)i * p.o_si + d4;
  if (L == 0.f && p.mean_v != nullptr) {
    const T* vb = static_cast<const T*>(p.mean_v) + b * p.v_sb + kv * p.v_sh;
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = from_f<T>(mean_value(vb, p.v_ss, p.Sk, d4 + e));
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = from_f<T>(fold_finish(O[e], L));
}

// Launches the merge; D must be a multiple of 4 (any width).
template <typename T>
cudaError_t launch_split_merge(const SplitMerge& p, cudaStream_t s) {
  if (p.D <= 0 || p.D % 4 || p.n_split < 1) return cudaErrorInvalidValue;
  const long long n = (long long)p.BKV * p.G * p.RQ * (p.D / 4);
  const long long blocks = (n + kMergeThreads - 1) / kMergeThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  split_merge_kernel<T><<<(unsigned)blocks, kMergeThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace repro_kernels
