// The split-KV attention kernels shared by the three attention entry
// points of this directory, each of which supplies a front end:
//   paged_decode.cu    (K1/K4: one query per sequence over pool pages and a
//                       dense in-flight tail),
//   paged_attention.cu (K2: a chunk of queries over pool pages and the
//                       chunk's own keys),
//   flash_attention.cu (K5: queries over contiguous K/V; its bf16 route
//                       folds its splits in-CTA, see there).
//
// One key order for every route.  A query row's keys are cut into splits
// of kSplitKeys (64) by ABSOLUTE POSITION: split j holds positions [64 j,
// 64 j + 64), wherever the keys are stored (pool pages, the decode tail,
// the prefill chunk, contiguous K/V), and key slot r of split j is the key
// at position 64 j + r.  Each split's partial (m, l, acc) comes from one
// body per dtype, and split_merge.cuh folds the partials in ascending split
// order.  So the same query over the same keys gives the same bits whatever
// the batch width, the chunk start or the kernel that reached it.
//
// A front end F gives, for one (sequence, kv head) pair bkv and one split:
//   F::T, F::Params (with part, D, BKV, n_split, sm_scale, softcap);
//   rows: the pair's query rows (Rows below);
//   causal, window, uniform: the mask (uniform: a row with no valid key,
//     every present key weighted equally; the decode front end's rule);
//   key(r, k, v, pos): slot r's key and value rows and position, or false.
//
// The bf16 body (tensor_core.cuh: split_partial) runs on the tensor cores
// for head dims up to 256; f32 at every head dim and bf16 past 256 run the
// SIMT body below.  Both give a row's partial independently of the rows
// beside it, so each dtype and width is invariant across the routes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "split_merge.cuh"
#include "tensor_core.cuh"

namespace repro_kernels {

// The query rows of one (sequence, kv head): stacked row s = i * G + g is
// query head g at query index i (position pos0 + i), read from q + g *
// q_sg + i * q_si; its partial row is g * RQ + i.  Stacking query-major
// keeps a row tile's positions contiguous.
template <typename T>
struct Rows {
  const T* q;
  long long q_sg, q_si;
  int G, RQ, pos0;
  __device__ int count() const { return G * RQ; }
  __device__ const T* row(int s) const { return q + (s % G) * q_sg + (long long)(s / G) * q_si; }
  __device__ int pos(int s) const { return pos0 + s / G; }
  __device__ int out_row(int s) const { return (s % G) * RQ + s / G; }
};

// A split's key slots as the front end resolved them (shared memory),
// with the positions' range over the present slots.
template <typename T>
struct Slots {
  const T* k[kSplitKeys];
  const T* v[kSplitKeys];
  int pos[kSplitKeys];
  unsigned present[2];
  int kmin[2], kmax[2];
  __device__ unsigned long long mask() const {
    return (unsigned long long)present[0] | ((unsigned long long)present[1] << 32);
  }
};

// Slots 32 w .. 32 w + 31 by warp w (w < 2; a one-warp CTA takes both).
// The caller syncs before reading them.
template <class F, int kWarps>
__device__ __forceinline__ void resolve_slots(const F& f, Slots<typename F::T>& sl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = warp; w < 2; w += kWarps) {
    const int r = 32 * w + lane;
    const typename F::T* k = nullptr;
    const typename F::T* v = nullptr;
    int pos = 0;
    const bool has = f.key(r, k, v, pos);
    sl.k[r] = has ? k : nullptr;
    sl.v[r] = has ? v : nullptr;
    sl.pos[r] = pos;
    const unsigned bits = __ballot_sync(0xffffffffu, has);
    const int lo = __reduce_min_sync(0xffffffffu, has ? pos : 0x7fffffff);
    const int hi = __reduce_max_sync(0xffffffffu, has ? pos : (int)0x80000000);
    if (lane == 0) {
      sl.present[w] = bits;
      sl.kmin[w] = lo;
      sl.kmax[w] = hi;
    }
  }
}

// Whether no row at positions [qlo, qhi] attends any slot of the split.
template <class F, typename T>
__device__ __forceinline__ bool split_empty(const F& f, const Slots<T>& sl, int qlo, int qhi) {
  if ((sl.present[0] | sl.present[1]) == 0u) return true;
  if (f.uniform) return false;
  const int kmin = min(sl.kmin[0], sl.kmin[1]), kmax = max(sl.kmax[0], sl.kmax[1]);
  return (f.causal && kmin > qhi) || (f.window > 0 && qlo - kmax >= f.window);
}

template <class F>
__device__ __forceinline__ float* partial_base(const typename F::Params& p, int bkv, int split,
                                               int R) {
  return p.part + ((long long)bkv * p.n_split + split) * R;  // m of (bkv, split, row 0)
}

// An empty partial (m = -inf, l = 0) for the CTA's rows [s0, s1)
template <class F>
__device__ __forceinline__ void write_empty(const typename F::Params& p, const F& f, int bkv,
                                            int split, int s0, int s1, int nthreads) {
  const int R = f.rows.count();
  const long long total = (long long)p.BKV * p.n_split * R;
  float* m = partial_base<F>(p, bkv, split, R);
  for (int s = s0 + (int)threadIdx.x; s < s1; s += nthreads) {
    m[f.rows.out_row(s)] = -INFINITY;
    m[total + f.rows.out_row(s)] = 0.f;
  }
}

// ------------------------------------------------------------ bf16, tensor cores

template <int DP, int kWarps>
constexpr size_t tc_split_smem() {
  return sizeof(__nv_bfloat16) * (size_t)(16 * kWarps + 2 * kSplitKeys) * DP;
}

// One CTA of kWarps warps (16 stacked rows each) per (pair, row tile,
// split): the split's key slots are resolved (one round of table reads),
// Q, K and V are copied by cp.async into swizzled tiles (zeros for a slot
// without a key and for columns past D), each warp runs split_partial on
// its 16 rows, and the partial goes to f32 scratch for the merge.
template <class F, int DP, bool kSoftcap, int kWarps>
__global__ void __launch_bounds__(32 * kWarps) tc_split_kernel(typename F::Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kRows = 16 * kWarps, kThreads = 32 * kWarps, kChunks = DP / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [kRows][DP]
  bf16* ks = qs + kRows * DP;                    // [64][DP]
  bf16* vs = ks + kSplitKeys * DP;               // [64][DP]
  __shared__ Slots<bf16> sl;

  const int bkv = blockIdx.x, split = blockIdx.z, s0 = blockIdx.y * kRows;
  const F f(p, bkv, split);
  const int R = f.rows.count(), s1 = min(s0 + kRows, R);
  resolve_slots<F, kWarps>(f, sl);
  __syncthreads();
  if (split_empty(f, sl, f.rows.pos(s0), f.rows.pos(s1 - 1))) {
    write_empty<F>(p, f, bkv, split, s0, s1, kThreads);
    return;
  }
  const int nch = p.D / 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, s = s0 + r;
    const bool ok = s < R && c < nch;
    cp_async16(smem_u32(qs + swz<DP>(r, c)), ok ? f.rows.row(s) + c * 8 : f.rows.q, ok);
  }
  for (int i = threadIdx.x; i < kSplitKeys * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bf16* k = sl.k[r];
    const bool ok = k != nullptr && c < nch;
    cp_async16(smem_u32(ks + swz<DP>(r, c)), ok ? k + c * 8 : f.rows.q, ok);
    cp_async16(smem_u32(vs + swz<DP>(r, c)), ok ? sl.v[r] + c * 8 : f.rows.q, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ra = s0 + 16 * warp + (lane >> 2), rb = ra + 8;
  if (s0 + 16 * warp >= R) return;  // no row of this warp
  SplitMask mk;
  mk.kpos = sl.pos;
  mk.present = sl.mask();
  mk.qpa = f.rows.pos(min(ra, R - 1));
  mk.qpb = f.rows.pos(min(rb, R - 1));
  mk.causal = f.causal;
  mk.window = f.window;
  mk.uniform = f.uniform;
  const float sa = kSoftcap ? p.sm_scale / p.softcap : p.sm_scale * kLog2e;
  const float sb = p.softcap * kLog2e;
  float m_a, m_b, l_a, l_b, acc[DP / 8][4];
  split_partial<DP, kSoftcap>(qs + 16 * warp * DP, ks, vs, mk, sa, sb, m_a, m_b, l_a, l_b, acc);

  const long long total = (long long)p.BKV * p.n_split * R;
  float* m_out = partial_base<F>(p, bkv, split, R);
  float* acc_out = p.part + 2 * total + (m_out - p.part) * p.D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = half ? rb : ra;
    if (s >= R) continue;
    const int r = f.rows.out_row(s);
    float* arow = acc_out + (long long)r * p.D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < p.D)
        *reinterpret_cast<float2*>(arow + d) = make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
    if ((lane & 3) == 0) {
      m_out[r] = half ? m_b : m_a;
      m_out[total + r] = half ? l_b : l_a;
    }
  }
}

template <class F, int DP, bool kSoftcap, int kWarps>
struct TcSplitTag {};

template <class F, int DP, bool kSoftcap, int kWarps>
cudaError_t launch_tc_split(const typename F::Params& p, int R, cudaStream_t s) {
  constexpr size_t smem = tc_split_smem<DP, kWarps>();
  const void* kernel = (const void*)tc_split_kernel<F, DP, kSoftcap, kWarps>;
  cudaError_t err = allow_smem<TcSplitTag<F, DP, kSoftcap, kWarps>>(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.BKV, (R + 16 * kWarps - 1) / (16 * kWarps), p.n_split);
  tc_split_kernel<F, DP, kSoftcap, kWarps><<<grid, 32 * kWarps, smem, s>>>(p);
  return cudaGetLastError();
}

// bf16 up to D = 256: one warp per CTA for up to 16 rows per pair (a
// decode step's G heads), four otherwise
template <class F, int DP>
cudaError_t launch_tc_split_dp(const typename F::Params& p, int R, cudaStream_t s) {
  if (R <= 16)
    return p.softcap > 0.f ? launch_tc_split<F, DP, true, 1>(p, R, s)
                           : launch_tc_split<F, DP, false, 1>(p, R, s);
  return p.softcap > 0.f ? launch_tc_split<F, DP, true, 4>(p, R, s)
                         : launch_tc_split<F, DP, false, 4>(p, R, s);
}

// ------------------------------------------------------------------- SIMT

constexpr int kSimtThreads = 256;
constexpr int kSimtWarps = kSimtThreads / 32;
constexpr int kSimtRows = 8;       // stacked rows per CTA
constexpr int kSimtSlice = 512;    // head-dim columns of Q in shared memory at a time
constexpr int kSimtKeysPerWarp = kSplitKeys / kSimtWarps;

// One CTA of 8 warps per (pair, 8 stacked rows, split), f32 arithmetic.
// Warp w owns slots w, w + 8, ..., w + 56.  The head dim is walked in
// slices of kSimtSlice columns (Q's slice as f32 in shared memory): each
// lane sums q.k over its 16-byte vectors of every slice, in slice order,
// and the warp adds the lanes by a fixed xor tree.  Warp g then takes row
// g's softmax over the 64 slots (lane: slots lane, lane + 32), and each
// thread owns columns d, d + 256, ... of the weighted value sum, keys in
// slot order.  Shared memory bounds the slice, not the head dim.
template <class F, bool kSoftcap>
__global__ void __launch_bounds__(kSimtThreads) simt_split_kernel(typename F::Params p) {
  using T = typename F::T;
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float qs[kSimtRows][kSimtSlice];
  __shared__ float ws[kSimtRows][kSplitKeys];  // scores, then weights
  __shared__ float wm[kSimtRows], wl[kSimtRows];
  __shared__ Slots<T> sl;

  const int bkv = blockIdx.x, split = blockIdx.z, s0 = blockIdx.y * kSimtRows;
  const F f(p, bkv, split);
  const int R = f.rows.count(), s1 = min(s0 + kSimtRows, R), D = p.D;
  resolve_slots<F, kSimtWarps>(f, sl);
  __syncthreads();
  if (split_empty(f, sl, f.rows.pos(s0), f.rows.pos(s1 - 1))) {
    write_empty<F>(p, f, bkv, split, s0, s1, kSimtThreads);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float dot[kSimtKeysPerWarp][kSimtRows];
#pragma unroll
  for (int jj = 0; jj < kSimtKeysPerWarp; ++jj)
#pragma unroll
    for (int g = 0; g < kSimtRows; ++g) dot[jj][g] = 0.f;
  for (int c0 = 0; c0 < D; c0 += kSimtSlice) {
    const int w = min(kSimtSlice, D - c0);
    __syncthreads();  // the previous slice is read
    for (int i = threadIdx.x; i < kSimtRows * w; i += kSimtThreads) {
      const int g = i / w, d = i % w, s = s0 + g;
      qs[g][d] = s < R ? to_f<T>(f.rows.row(s)[c0 + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kSimtKeysPerWarp; ++jj) {
      const T* k = sl.k[warp + kSimtWarps * jj];
      if (k == nullptr) continue;
      for (int v = lane; v < w / kVec; v += 32) {
        float kf[kVec];
        unpack16<T>(kf, reinterpret_cast<const uint4*>(k + c0)[v]);
#pragma unroll
        for (int g = 0; g < kSimtRows; ++g)
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot[jj][g] = fmaf(qs[g][v * kVec + e], kf[e], dot[jj][g]);
      }
    }
  }
  const float sa = kSoftcap ? p.sm_scale / p.softcap : p.sm_scale * kLog2e;
  const float sb = p.softcap * kLog2e;
#pragma unroll
  for (int jj = 0; jj < kSimtKeysPerWarp; ++jj) {
    const int j = warp + kSimtWarps * jj;
    const bool has = sl.k[j] != nullptr;
#pragma unroll
    for (int g = 0; g < kSimtRows; ++g) {
      float x = dot[jj][g];
      for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
      if (lane == g) {
        const int s = s0 + g;
        const int qp = f.rows.pos(min(s, R - 1)), kp = sl.pos[j];
        bool valid = has && s < R;
        if (f.causal) valid = valid && kp <= qp;
        if (f.window > 0) valid = valid && qp - kp < f.window;
        ws[g][j] = !valid ? -INFINITY : f.uniform ? 0.f : score_log2<kSoftcap>(x, sa, sb);
      }
    }
  }
  __syncthreads();
  {  // warp g: row g's max, weights and sum over the 64 slots
    const int g = warp;
    const float a = ws[g][lane], c = ws[g][lane + 32];
    float m = fmaxf(a, c);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float base = m == -INFINITY ? 0.f : m;
    const float pa = exp2f(__fsub_rn(a, base)), pc = exp2f(__fsub_rn(c, base));
    ws[g][lane] = pa;
    ws[g][lane + 32] = pc;
    float l = __fadd_rn(pa, pc);
    for (int o = 16; o > 0; o >>= 1) l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, o));
    if (lane == 0) {
      wm[g] = m;
      wl[g] = l;
    }
  }
  __syncthreads();
  const long long total = (long long)p.BKV * p.n_split * R;
  float* m_out = partial_base<F>(p, bkv, split, R);
  float* acc_out = p.part + 2 * total + (m_out - p.part) * D;
  for (int d = threadIdx.x; d < D; d += kSimtThreads) {
    float acc[kSimtRows];
#pragma unroll
    for (int g = 0; g < kSimtRows; ++g) acc[g] = 0.f;
    for (int j = 0; j < kSplitKeys; ++j) {
      const T* v = sl.v[j];
      if (v == nullptr) continue;
      const float x = to_f<T>(v[d]);
#pragma unroll
      for (int g = 0; g < kSimtRows; ++g) acc[g] = fmaf(ws[g][j], x, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < kSimtRows; ++g)
      if (s0 + g < R) acc_out[(long long)f.rows.out_row(s0 + g) * D + d] = acc[g];
  }
  if (threadIdx.x < kSimtRows && s0 + (int)threadIdx.x < R) {
    const int r = f.rows.out_row(s0 + threadIdx.x);
    m_out[r] = wm[threadIdx.x];
    m_out[total + r] = wl[threadIdx.x];
  }
}

template <class F>
cudaError_t launch_simt_split(const typename F::Params& p, int R, cudaStream_t s) {
  const dim3 grid(p.BKV, (R + kSimtRows - 1) / kSimtRows, p.n_split);
  if (p.softcap > 0.f)
    simt_split_kernel<F, true><<<grid, kSimtThreads, 0, s>>>(p);
  else
    simt_split_kernel<F, false><<<grid, kSimtThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace repro_kernels
