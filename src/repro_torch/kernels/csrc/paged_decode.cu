// Split-KV paged decode attention for Hopper (sm_90a).
//
// Two entry points, one pair of kernels:
//   * paged decode (replaces kernels/paged_attention.py:paged_decode_attention_pallas)
//     rows = the G grouped queries of one (sequence, kv head) at position
//     cur_pos[b]; keys = the block-table prefix pages (k_pos < prefix_len),
//     then the dense in-flight tail whose absolute positions come from
//     tail_pos (-1 = empty slot).
//   * paged attention (replaces kernels/paged_attention.py:paged_attention_pallas)
//     the same with T = 0, null tail pointers and no cur_pos: the query sits
//     at position prefix_len (= lengths), so the mask is k_pos < lengths.
// A key at k_pos is attended iff k_pos >= 0, k_pos <= q_pos and, with a
// window, q_pos - k_pos < window.  Scores are q.k / sqrt(D), optionally
// soft-capped (softcap * tanh(s / softcap)), in f32; only valid keys enter
// the softmax.  A sequence with no valid key at all gets what the
// reference's dense softmax gives it: every key of the gathered window
// weighted equally (every block-table column, its page id wrapped and
// clamped into [0, N) as the reference's gather does, and every tail slot),
// i.e. the plain mean of those value rows.
//
// Domain: D up to 512, a multiple of 8 in bf16 and of 4 in f32; any G.
//
// What bounds it on the card: bytes.  Each key/value element is used for
// 4*G FLOPs (G = 2 on qwen3-1.7b, 4 on stablelm-12b, 1 on deepseek-7b), far
// under the ~295 FLOPs per byte where the tensor cores would bound it.  The
// first kernel of this entry point ran one CTA per (sequence, kv head), 64
// CTAs at 8 sequences x 8 kv heads, each walking up to 17 key tiles in
// series through f32 shared memory: latency, not bytes, bounded it (2.7% of
// the byte bound on the H100).
//
// Design (flash-decoding).  The keys of each (sequence, kv head) are cut
// into fixed splits of kSplit = 64 keys by key index: prefix split i holds
// prefix keys [64 i, 64 i + 64), and the tail is cut the same way after the
// last prefix split.  The grid is (B * KV * head groups, n_split), with
// n_split computed on the host from the block table's width and T, so
// nothing is read back.  A CTA takes at most 8 of the G heads (a head
// group); G > 8 runs ceil(G / 8) CTAs per split, neighbours in the grid, so
// each re-reads its split's K/V (G = 16: twice the K/V bytes from L2, the
// same from device memory when the neighbours run together).  A CTA whose
// split holds no attendable key (past prefix_len, before the window, an
// unused tail split) writes an empty partial (m = -inf, l = 0) and exits.
// Otherwise one thread per key reads the block table (or the tail position)
// and leaves the key's row offset in shared memory, -1 for no key (pid < 0
// or pid >= N is no key): one round of table reads per CTA.  Then its warps
// take 64 / warps keys each: a key's D-row is split into 8-element slices
// over the next power of two >= D / 8 lanes, and each lane starts all its K
// and V loads (16 bytes per slice in bf16) for every key it owns before it
// computes anything, so every page row of the split is in flight at once,
// straight into registers, with no shared-memory staging of K/V.  Three
// instantiations by padded width:
//   * D <= 128: 4 warps of 16 keys, 2 or more keys per warp pass;
//   * D in (128, 160], bf16, G <= 4 (stablelm-12b's decode): 4 warps of 16
//     keys, a key's 20 slices over 10 lanes of 2 slices each, 3 keys per
//     warp pass (30 of 32 lanes busy), 6 passes.  A key's dot product sums
//     over its 10 lanes by a shuffle tree into the group's first lane and
//     a broadcast.  At 255 registers without spills (G = 4) two 128-thread
//     CTAs fit an SM.  On the H100 (scripts/torch_k1_layouts.py) it runs
//     stablelm's decode step in 0.0173 ms and 8 x 2048 keys at D = 160 in
//     0.078 ms, against 0.0357 and 0.189 ms on the 256 layout below and
//     0.0209 and 0.111 ms on an 8-warp version of it (160 registers, one
//     256-thread CTA per SM);
//   * anything else up to 256 (f32, or more heads): 8 warps of 8 keys, one
//     key per warp pass over 32 lanes; at D = 160 12 of the 32 lanes idle.
// The G dot products of a key reduce by warp shuffles; the split's max
// comes from a shared array; each lane then weights its V slices, and the
// split's (m, l, acc[G, D]) goes to f32 scratch (the wrapper's one
// torch.empty) after a sum over the warps in dynamic shared memory (warps
// x heads x D floats: 10 KiB at D = 160 and 4 heads, 64 KiB at D = 256 and
// 8 heads).  A sequence with no valid key (decided per CTA
// from prefix_len, cur_pos, the window and, only when no prefix key
// counts, the T tail positions) gives every key of its split the score 0,
// so each split leaves (m = 0, l = count, acc = sum v) and the merge gives
// the mean.  A second kernel, launched from the same C entry point, merges
// the splits of each (sequence, kv head) in split order (split_merge.cuh,
// shared with the chunked-prefill kernel): M = max m_i, out = sum acc_i
// exp(m_i - M) / max(sum l_i exp(m_i - M), 1e-30), skipping empty splits.
// No atomics touch the values, and split boundaries, head groups and each
// split's place in the sums depend only on the key and head index, so a
// row's result does not depend on the batch width or on its place in the
// batch (empty splits add nothing).
//
// Head dims past 256 (up to 512, both types) take wide_split_kernel, a
// plain SIMT kernel over the same splits, the same partials and the same
// merge (2 threads per output column there, as a row of 512 fills a merge
// CTA): one CTA of 8 warps per (sequence, kv head, head group, split) keeps
// the group's queries in shared memory as f32; each warp takes every 8th
// key of the split and sums q.k over all D columns, 16 bytes per lane per
// step, by a warp shuffle; the weights go to shared memory; then each
// thread owns columns d, d + 256 of the weighted value sum of every head.
// Nothing bounds it but simplicity: the register layouts above hold a
// key's whole row per lane group and spill past 256 columns, and no
// catalogue model has such a head.
//
// The kernels allocate nothing and do not synchronise; the caller passes
// the stream and checks the returned cudaGetLastError().

#include <math.h>

#include "common.cuh"
#include "split_merge.cuh"

namespace {

using repro_kernels::allow_smem;
using repro_kernels::launch_split_merge;
using repro_kernels::SplitMerge;
using repro_kernels::to_f;
using repro_kernels::unpack16;

constexpr int kSplit = 64;      // keys per split
constexpr int kMergeParts = 4;  // threads per output element in the merge (up to 34 splits at 2k keys)
constexpr int kSlice = 8;       // head-dim elements per lane
constexpr int kMaxD = 256;      // the register layouts' widest head dim
constexpr int kMaxWideD = 512;  // wide_split_kernel's widest head dim
constexpr int kMaxGM = 8;       // heads per CTA; more heads take more CTAs
constexpr int kWideThreads = 256;
constexpr int kWideMergeParts = 2;  // a row of up to 512 columns: 256 merge threads

// The CTA's shape for head dims up to the padded width DP.  128 and 256:
// DP / 32 warps of kSplit / warps keys, one 8-element slice per lane over
// the next power of two >= D / 8 lanes per key (kLanes = 0: chosen at run
// time), 8 warp passes in flight either way.  160 (bf16, G <= 4): 4 warps
// of 16 keys, two slices per lane over 10 lanes per key, 3 keys per warp
// pass (30 of 32 lanes), 6 passes.
template <int DP>
struct Shape {
  static constexpr int kWarps = DP / 32;
  static constexpr int kLanes = 0;  // lanes per key; 0: a power of two set by D
  static constexpr int kSpl = 1;    // slices per lane
  static constexpr int kKeysPerWarp = kSplit / kWarps;               // 16 or 8
  static constexpr int kKeysPerPass = 32 * kSlice / DP;              // at D = DP: 2 or 1
  static constexpr int kMaxPasses = kKeysPerWarp / kKeysPerPass;     // 8
};
template <>
struct Shape<160> {
  static constexpr int kWarps = 4;
  static constexpr int kLanes = 10;
  static constexpr int kSpl = 2;
  static constexpr int kKeysPerWarp = kSplit / kWarps;                                 // 16
  static constexpr int kKeysPerPass = 32 / kLanes;                                     // 3
  static constexpr int kMaxPasses = (kKeysPerWarp + kKeysPerPass - 1) / kKeysPerPass;  // 6
};

// The sum of x over each key's group of lanes, in every lane of the group:
// butterfly over a power-of-two group (L = 0, lpk lanes), else a tree into
// the group's first lane (c = lane - first) and a broadcast from it.
template <int L>
__device__ __forceinline__ float group_sum(float x, int lpk, int c, int lane) {
  if constexpr (L == 0) {
    for (int o = lpk >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o >= L) continue;
      const float y = __shfl_down_sync(0xffffffffu, x, o);
      if (c + o < L) x += y;
    }
    return __shfl_sync(0xffffffffu, x, lane - c);
  }
}

struct Params {
  const void* q;             // [B, KV, G, D] by strides, D contiguous
  const void* k_pages;       // [KV, N, page, D] contiguous
  const void* v_pages;
  const int* block_tables;   // [B, P]
  const int* prefix_len;     // [B]
  const void* k_tail;        // [B, KV, T, D] by strides, or null (T = 0)
  const void* v_tail;
  const int* tail_pos;       // [B, T], or null (T = 0)
  const int* cur_pos;        // [B], or null: the query sits at prefix_len
  void* out;                 // [B, KV, G, D] contiguous
  float* part;               // m [B*KV, n_split, G], l (same), acc [B*KV, n_split, G, D]
  long long q_sb, q_skv, q_sg;
  long long e_sb, e_skv, e_st;
  int B, KV, G, D, N, page, P, T, n_pre, n_split, n_hg;
  float sm_scale, softcap;
  int window;
};

// The keys split `split` of sequence b attends: [lo, hi) by key index from
// base (prefix keys, or tail slots), and whether the sequence has no
// attendable key at all (then every key of the split, equally weighted).
struct SplitKeys {
  bool none, prefix;
  int base, lo, hi, cur;
};

// Every thread of the CTA calls it (the tail's positions are read, and
// reduced over the CTA, only when no prefix key counts).
template <int kThreads>
__device__ __forceinline__ SplitKeys split_keys(const Params& p, int b, int split) {
  SplitKeys k;
  const int plen = p.prefix_len[b];
  k.cur = p.cur_pos ? p.cur_pos[b] : plen;
  const int cur = k.cur;
  const int n_prefix = max(0, min(plen, p.P * p.page));
  // does the sequence have any attendable key?  The prefix by arithmetic;
  // the tail positions are read only when no prefix key counts
  bool none = (p.window > 0 ? max(0, cur - p.window + 1) : 0) >= min(n_prefix, cur + 1);
  if (none && p.T > 0) {  // the same branch for every thread of the CTA
    bool any = false;
    for (int t = threadIdx.x; t < p.T; t += kThreads) {
      const int pos = p.tail_pos[(long long)b * p.T + t];
      any |= pos >= 0 && pos <= cur && (p.window <= 0 || cur - pos < p.window);
    }
    none = !__syncthreads_or(any);
  }
  k.none = none;
  k.prefix = split < p.n_pre;
  k.base = (k.prefix ? split : split - p.n_pre) * kSplit;
  k.lo = k.base;
  if (none) {
    // no valid key: every key of the split, equally weighted
    k.hi = min(k.base + kSplit, k.prefix ? p.P * p.page : p.T);
  } else if (k.prefix) {
    // attendable prefix keys: k < prefix_len, k <= cur, cur - k < window
    k.hi = min(min(k.base + kSplit, n_prefix), cur + 1);
    if (p.window > 0) k.lo = max(k.lo, cur - p.window + 1);
  } else {
    k.hi = min(k.base + kSplit, p.T);
  }
  return k;
}

// Where key `key` of the split lives: an element offset into the pool (or
// the tail), -1 for no key (outside [lo, hi), a page id outside [0, N), an
// invalid tail slot).
__device__ __forceinline__ long long key_offset(const Params& p, const SplitKeys& k, int b,
                                                int kv, int key) {
  if (key < k.lo || key >= k.hi) return -1;
  if (k.prefix) {
    int pid = p.block_tables[b * p.P + key / p.page];
    if (k.none) pid = min(max(pid < 0 ? pid + p.N : pid, 0), p.N - 1);  // the reference's gather
    if (pid < 0 || pid >= p.N) return -1;
    return (((long long)kv * p.N + pid) * p.page + key % p.page) * p.D;
  }
  const int pos = p.tail_pos[b * p.T + key];
  if (k.none || (pos >= 0 && pos <= k.cur && (p.window <= 0 || k.cur - pos < p.window)))
    return b * p.e_sb + kv * p.e_skv + (long long)key * p.e_st;
  return -1;
}

template <typename T, int DP, int GM, bool kSoftcap>
__global__ void __launch_bounds__(32 * Shape<DP>::kWarps) split_kernel(Params p) {
  using S = Shape<DP>;
  constexpr int kWarps = S::kWarps, kThreads = 32 * kWarps, kSpl = S::kSpl;
  constexpr int kKeysPerWarp = S::kKeysPerWarp, kMaxPasses = S::kMaxPasses;
  constexpr int kVec = 16 / sizeof(T);               // elements per 16-byte load
  constexpr int kLoads = kSlice / kVec;              // 16-byte loads per slice
  constexpr int kW = kSpl * kSlice;                  // elements of a key per lane
  static_assert(kThreads >= kSplit, "one thread per key of a split");
  extern __shared__ float wacc[];                    // [kWarps][GM][D]
  __shared__ float wmax[kWarps][GM];
  __shared__ float wsum[kWarps][GM];
  __shared__ long long rows[kSplit];

  const int bkv = blockIdx.x / p.n_hg, g0 = blockIdx.x % p.n_hg * kMaxGM;
  const int split = blockIdx.y;
  const int b = bkv / p.KV, kv = bkv % p.KV;
  const int G = min(GM, p.G - g0), D = p.D;  // this CTA's heads g0 .. g0 + G - 1
  const long long total = (long long)p.B * p.KV * p.n_split * p.G;
  const long long row0 = ((long long)bkv * p.n_split + split) * p.G + g0;
  float* m_out = p.part + row0;
  float* l_out = p.part + total + row0;
  float* acc_out = p.part + 2 * total + row0 * D;

  const SplitKeys sk = split_keys<kThreads>(p, b, split);
  const bool none = sk.none, prefix = sk.prefix;
  const int base = sk.base;
  if (sk.lo >= sk.hi) {
    if (threadIdx.x < G) {
      m_out[threadIdx.x] = -INFINITY;
      l_out[threadIdx.x] = 0.f;
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsl = (D + kSlice - 1) / kSlice;  // slices per row (the last may be half, in f32)
  int lpk = S::kLanes;                        // lanes per key
  if (lpk == 0) {
    lpk = 1;
    while (lpk < nsl) lpk <<= 1;
  }
  const int kpp = 32 / lpk;    // keys per pass of a warp
  const int passes = (kKeysPerWarp + kpp - 1) / kpp;
  const int c = lane % lpk, kq = lane / lpk;  // kq == kpp: a lane left over (lpk not a power of 2)
  bool load_in[kSpl][kLoads];  // this lane's 16-byte loads that fall inside D
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l)
      load_in[j][l] = kq < kpp && c + j * lpk < nsl && (c + j * lpk) * kSlice + l * kVec < D;
  }

  float qf[GM][kW];
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kv * p.q_skv + g0 * p.q_sg + c * kSlice;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int j = 0; j < kSpl; ++j) {
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (g < G && load_in[j][l])
          u = reinterpret_cast<const uint4*>(qb + g * p.q_sg + j * lpk * kSlice)[l];
        unpack16<T>(&qf[g][j * kSlice + l * kVec], u);
      }
    }
  }

  // where each key of the split lives (an element offset into the pool or
  // the tail, -1 for no key): one round of block-table reads for the CTA
  if (threadIdx.x < kSplit) rows[threadIdx.x] = key_offset(p, sk, b, kv, base + threadIdx.x);
  __syncthreads();

  // every K and V slice of this lane's keys, all in flight at once
  const T* kbase = static_cast<const T*>(prefix ? p.k_pages : p.k_tail) + c * kSlice;
  const T* vbase = static_cast<const T*>(prefix ? p.v_pages : p.v_tail) + c * kSlice;
  uint4 kr[kMaxPasses][kSpl * kLoads], vr[kMaxPasses][kSpl * kLoads];
  bool has[kMaxPasses];
#pragma unroll
  for (int i = 0; i < kMaxPasses; ++i) {
#pragma unroll
    for (int l = 0; l < kSpl * kLoads; ++l) {
      kr[i][l] = make_uint4(0u, 0u, 0u, 0u);
      vr[i][l] = make_uint4(0u, 0u, 0u, 0u);
    }
    const int jl = i * kpp + kq;
    const long long off =
        i < passes && kq < kpp && jl < kKeysPerWarp ? rows[warp * kKeysPerWarp + jl] : -1;
    has[i] = off >= 0;
    if (has[i]) {
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          if (load_in[j][l]) {
            kr[i][j * kLoads + l] = reinterpret_cast<const uint4*>(kbase + off + j * lpk * kSlice)[l];
            vr[i][j * kLoads + l] = reinterpret_cast<const uint4*>(vbase + off + j * lpk * kSlice)[l];
          }
        }
      }
    }
  }

  // scores of this lane's keys (every lane of a key's group holds them)
  float s[kMaxPasses][GM];
  float mloc[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) mloc[g] = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxPasses; ++i) {
#pragma unroll
    for (int g = 0; g < GM; ++g) s[i][g] = -INFINITY;
    if (i < passes) {
      float kf[kW];
#pragma unroll
      for (int l = 0; l < kSpl * kLoads; ++l) unpack16<T>(&kf[l * kVec], kr[i][l]);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int e = 0; e < kW; e += 2) {
          d0 = fmaf(qf[g][e], kf[e], d0);
          d1 = fmaf(qf[g][e + 1], kf[e + 1], d1);
        }
        const float dot = group_sum<S::kLanes>(d0 + d1, lpk, c, lane);
        float x = dot * p.sm_scale;
        if (kSoftcap) x = p.softcap * tanhf(x / p.softcap);
        if (has[i] && g < G) {
          s[i][g] = none ? 0.f : x;
          mloc[g] = fmaxf(mloc[g], s[i][g]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    for (int o = S::kLanes ? 1 : lpk; o < 32; o <<= 1)
      mloc[g] = fmaxf(mloc[g], __shfl_xor_sync(0xffffffffu, mloc[g], o));
    if (lane == 0) wmax[warp][g] = mloc[g];
  }
  __syncthreads();
  float m[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = wmax[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m[g] = fmaxf(m[g], wmax[w][g]);
  }

  // weights and the weighted value slices
  float lsum[GM], acc[GM][kW];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    lsum[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kW; ++e) acc[g][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kMaxPasses; ++i) {
    if (i < passes && has[i]) {
      float vf[kW];
#pragma unroll
      for (int l = 0; l < kSpl * kLoads; ++l) unpack16<T>(&vf[l * kVec], vr[i][l]);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float w = s[i][g] == -INFINITY ? 0.f : expf(s[i][g] - m[g]);
        if (c == 0) lsum[g] += w;
#pragma unroll
        for (int e = 0; e < kW; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    for (int o = 16; o > 0; o >>= 1) lsum[g] += __shfl_xor_sync(0xffffffffu, lsum[g], o);
    if constexpr (S::kLanes == 0) {
      for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < kW; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    } else {  // the key groups' sums, into the first group (lanes 0 .. kLanes - 1)
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        float t = 0.f;
#pragma unroll
        for (int k = 1; k < S::kKeysPerPass; ++k)
          t += __shfl_down_sync(0xffffffffu, acc[g][e], k * S::kLanes);
        acc[g][e] += t;
      }
    }
    if (lane == 0) wsum[warp][g] = lsum[g];
    if (kq == 0 && g < G) {
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        const int d0 = (c + j * lpk) * kSlice;
#pragma unroll
        for (int e = 0; e < kSlice; ++e)
          if (d0 + e < D) wacc[(warp * GM + g) * D + d0 + e] = acc[g][j * kSlice + e];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float a = wacc[g * D + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += wacc[(w * GM + g) * D + d];
    acc_out[idx] = a;
  }
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mg = wmax[0][g], lg = wsum[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      mg = fmaxf(mg, wmax[w][g]);
      lg += wsum[w][g];
    }
    m_out[g] = mg;
    l_out[g] = lg;
  }
}

// Head dims past 256: the split's partials by a plain SIMT kernel (see the
// header).  Dynamic shared memory holds the GM heads' queries as f32.
template <typename T, int GM, bool kSoftcap>
__global__ void __launch_bounds__(kWideThreads) wide_split_kernel(Params p) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kWarps = kWideThreads / 32;
  extern __shared__ float wq[];         // [GM][D]
  __shared__ float ws[GM][kSplit];      // scores, then weights
  __shared__ float wm[GM], wl[GM];
  __shared__ long long rows[kSplit];

  const int bkv = blockIdx.x / p.n_hg, g0 = blockIdx.x % p.n_hg * kMaxGM;
  const int split = blockIdx.y;
  const int b = bkv / p.KV, kv = bkv % p.KV;
  const int G = min(GM, p.G - g0), D = p.D;
  const long long total = (long long)p.B * p.KV * p.n_split * p.G;
  const long long row0 = ((long long)bkv * p.n_split + split) * p.G + g0;
  float* m_out = p.part + row0;
  float* l_out = p.part + total + row0;
  float* acc_out = p.part + 2 * total + row0 * D;

  const SplitKeys sk = split_keys<kWideThreads>(p, b, split);
  if (sk.lo >= sk.hi) {
    if (threadIdx.x < G) {
      m_out[threadIdx.x] = -INFINITY;
      l_out[threadIdx.x] = 0.f;
    }
    return;
  }
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kv * p.q_skv + g0 * p.q_sg;
  for (int i = threadIdx.x; i < G * D; i += kWideThreads)
    wq[i] = to_f<T>(qb[(i / D) * p.q_sg + i % D]);
  if (threadIdx.x < kSplit) rows[threadIdx.x] = key_offset(p, sk, b, kv, sk.base + threadIdx.x);
  __syncthreads();

  const T* kbase = static_cast<const T*>(sk.prefix ? p.k_pages : p.k_tail);
  const T* vbase = static_cast<const T*>(sk.prefix ? p.v_pages : p.v_tail);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < kSplit; j += kWarps) {
    const long long off = rows[j];  // the same in every lane of the warp
    float dot[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) dot[g] = 0.f;
    if (off >= 0) {
      for (int v = lane; v < D / kVec; v += 32) {
        float kf[kVec];
        unpack16<T>(kf, reinterpret_cast<const uint4*>(kbase + off)[v]);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot[g] = fmaf(wq[g * D + v * kVec + e], kf[e], dot[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g)
        for (int o = 16; o > 0; o >>= 1) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
    }
    if (lane < G) {
      float x = 0.f;
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g == lane) x = dot[g];
      x *= p.sm_scale;
      if (kSoftcap) x = p.softcap * tanhf(x / p.softcap);
      ws[lane][j] = off < 0 ? -INFINITY : (sk.none ? 0.f : x);
    }
  }
  __syncthreads();
  if (warp < G) {  // warp g: head g's max, weights and sum over the split's 64 keys
    const int g = warp;
    const float a = ws[g][lane], c = ws[g][lane + 32];
    float m = fmaxf(a, c);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float wa = a == -INFINITY ? 0.f : expf(a - m);
    const float wc = c == -INFINITY ? 0.f : expf(c - m);
    ws[g][lane] = wa;
    ws[g][lane + 32] = wc;
    float l = wa + wc;
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      wm[g] = m;
      wl[g] = l;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kWideThreads) {
    float acc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) acc[g] = 0.f;
    for (int j = 0; j < kSplit; ++j) {
      const long long off = rows[j];
      if (off < 0) continue;
      const float v = to_f<T>(vbase[off + d]);
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) acc[g] = fmaf(ws[g][j], v, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) acc_out[g * D + d] = acc[g];
  }
  if (threadIdx.x < G) {
    m_out[threadIdx.x] = wm[threadIdx.x];
    l_out[threadIdx.x] = wl[threadIdx.x];
  }
}

template <typename T, int DP, int GM, bool kSoftcap>
struct SplitTag {};

template <typename T, int DP, int GM, bool kSoftcap>
int launch_split(const Params& p, cudaStream_t s) {
  using S = Shape<DP>;
  const void* kernel = (const void*)split_kernel<T, DP, GM, kSoftcap>;
  cudaError_t err = allow_smem<SplitTag<T, DP, GM, kSoftcap>>(kernel, sizeof(float) * S::kWarps * GM * DP);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.KV * p.n_hg, p.n_split);
  const size_t smem = sizeof(float) * S::kWarps * GM * p.D;
  split_kernel<T, DP, GM, kSoftcap><<<grid, 32 * S::kWarps, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int merge(const Params& p, int parts, cudaStream_t s) {
  const SplitMerge m{p.part, p.out, p.B * p.KV, p.G, p.D, p.n_pre, p.n_split, parts, 0};
  return (int)launch_split_merge<T>(m, s);
}

template <typename T, int DP, int GM>
int launch(const Params& p, cudaStream_t s) {
  const int err = p.softcap > 0.f ? launch_split<T, DP, GM, true>(p, s)
                                   : launch_split<T, DP, GM, false>(p, s);
  if (err != 0) return err;
  return merge<T>(p, kMergeParts, s);
}

template <typename T, int GM>
int launch_wide(const Params& p, cudaStream_t s) {
  const dim3 grid(p.B * p.KV * p.n_hg, p.n_split);
  const size_t smem = sizeof(float) * GM * p.D;  // 16 KiB at 8 heads of 512
  if (p.softcap > 0.f)
    wide_split_kernel<T, GM, true><<<grid, kWideThreads, smem, s>>>(p);
  else
    wide_split_kernel<T, GM, false><<<grid, kWideThreads, smem, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return merge<T>(p, kWideMergeParts, s);
}

template <typename T, int DP>
int dispatch_heads(const Params& p, cudaStream_t s) {
  if (p.G <= 2) return launch<T, DP, 2>(p, s);
  if constexpr (DP == 160) {
    return launch<T, DP, 4>(p, s);  // the caller sends G <= 4 only
  } else {
    if (p.G <= 4) return launch<T, DP, 4>(p, s);
    return launch<T, DP, 8>(p, s);  // G > 8: head groups of 8
  }
}

template <typename T>
int dispatch(const Params& p, cudaStream_t s) {
  if (p.D > kMaxD) {
    if (p.G <= 2) return launch_wide<T, 2>(p, s);
    if (p.G <= 4) return launch_wide<T, 4>(p, s);
    return launch_wide<T, kMaxGM>(p, s);  // G > 8: head groups of 8
  }
  if (p.D <= 128) return dispatch_heads<T, 128>(p, s);
  if constexpr (sizeof(T) == 2) {
    // 160's 2 slices x 4 heads of q and accumulators per lane: bf16 up to 4 heads
    if (p.D <= 160 && p.G <= 4) return dispatch_heads<T, 160>(p, s);
  }
  return dispatch_heads<T, 256>(p, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (D a multiple of 4), 1 = bfloat16 (D a multiple of
// 8); D <= 512, any G.  sm_scale multiplies every score: 1 / sqrt(d) of the
// head dim d before the caller zero-padded it to D.  split_keys must equal the kernel's split size
// (64); n_pre = ceil(P * page / split_keys) prefix splits and n_split =
// n_pre + ceil(T / split_keys) (at least 1).  part holds
// B * KV * n_split * G * (D + 2) floats.  Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for shapes the kernels do not take).
int paged_decode_forward(int dtype, const void* q, const void* k_pages, const void* v_pages,
                         const int* block_tables, const int* prefix_len, const void* k_tail,
                         const void* v_tail, const int* tail_pos, const int* cur_pos, void* out,
                         float* part, long long q_sb, long long q_skv, long long q_sg,
                         long long e_sb, long long e_skv, long long e_st, int B, int KV, int G,
                         int D, int N, int page, int P, int T, int split_keys, int n_pre,
                         int n_split, float sm_scale, float softcap, int window, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;  // elements per 16-byte load
  const long long n_hg = (G + kMaxGM - 1) / kMaxGM;
  if (split_keys != kSplit || D <= 0 || D > kMaxWideD || D % vec || B <= 0 || KV <= 0 || G <= 0 ||
      (long long)B * KV * n_hg > 0x7fffffffLL || page <= 0 || P < 0 || T < 0 || n_pre < 0 ||
      n_split < 1 || n_split > 65535 || (long long)n_pre * kSplit < (long long)P * page ||
      (long long)(n_split - n_pre) * kSplit < (long long)T || (T > 0 && tail_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.block_tables = block_tables;
  p.prefix_len = prefix_len;
  p.k_tail = k_tail;
  p.v_tail = v_tail;
  p.tail_pos = tail_pos;
  p.cur_pos = cur_pos;
  p.out = out;
  p.part = part;
  p.q_sb = q_sb;
  p.q_skv = q_skv;
  p.q_sg = q_sg;
  p.e_sb = e_sb;
  p.e_skv = e_skv;
  p.e_st = e_st;
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.D = D;
  p.N = N;
  p.page = page;
  p.P = P;
  p.T = T;
  p.n_pre = n_pre;
  p.n_split = n_split;
  p.n_hg = (int)n_hg;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
