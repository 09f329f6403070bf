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
// the softmax, so a row with no valid key yields zeros.
//
// What bounds it on the card: bytes.  Each key/value element is used for
// 4*G FLOPs (G = 2 on qwen3-1.7b), far under the ~295 FLOPs per byte where
// the tensor cores would bound it.  The first kernel of this entry point ran
// one CTA per (sequence, kv head), 64 CTAs at 8 sequences x 8 kv heads, each
// walking up to 17 key tiles in series through f32 shared memory: latency,
// not bytes, bounded it (2.7% of the byte bound on the H100).
//
// Design (flash-decoding).  The keys of each (sequence, kv head) are cut
// into fixed splits of kSplit = 64 keys by key index: prefix split i holds
// prefix keys [64 i, 64 i + 64), and the tail is cut the same way after the
// last prefix split.  The grid is (B * KV, n_split), with n_split computed
// on the host from the block table's width and T, so nothing is read back.
// A CTA whose split holds no attendable key (past prefix_len, before the
// window, an unused tail split) writes an empty partial (m = -inf, l = 0)
// and exits.  Otherwise one thread per key reads the block table (or the
// tail position) and leaves the key's row offset in shared memory, -1 for no
// key (pid < 0 or pid >= N is no key): one round of table reads per CTA.
// Then its 4 warps take 16 keys each: a key's D-row is split into 8-element
// slices over the next power of two >= D / 8 lanes, and each lane issues
// all its K and V loads (16 bytes per slice in bf16) for every key it owns
// before it computes anything, so every page row of the split is in flight
// at once, straight into registers, with no shared-memory staging of K/V.
// The G dot products of a key reduce by warp shuffles; the split's max
// comes from a 4-entry shared array; each lane then weights its V slices,
// and the split's (m, l, acc[G, D]) goes to f32 scratch (the wrapper's one
// torch.empty).  A second kernel, launched from the same C entry point,
// merges the splits of each (sequence, kv head) in split order
// (split_merge.cuh, shared with the chunked-prefill kernel): M = max m_i,
// out = sum acc_i exp(m_i - M) / max(sum l_i exp(m_i - M), 1e-30), skipping
// empty splits.  No atomics touch the values, and split boundaries and
// each split's place in the sums depend only on the key index, so a row's
// result does not depend on the batch width or on its place in the batch
// (empty splits add nothing).
//
// The kernels allocate nothing and do not synchronise; the caller passes
// the stream and checks the returned cudaGetLastError().

#include <math.h>

#include "common.cuh"
#include "split_merge.cuh"

namespace {

using repro_kernels::launch_split_merge;
using repro_kernels::SplitMerge;
using repro_kernels::unpack16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 64;                                    // keys per split
constexpr int kMergeParts = 4;  // threads per output element in the merge (up to 34 splits at 2k keys)
constexpr int kKeysPerWarp = kSplit / kWarps;                  // 16
constexpr int kSlice = 8;                                      // head-dim elements per lane
constexpr int kMaxD = 128;
constexpr int kMaxPasses = kKeysPerWarp * (kMaxD / kSlice) / 32;  // 8

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
  int B, KV, G, D, N, page, P, T, n_pre, n_split;
  float sm_scale, softcap;
  int window;
};

template <typename T, int GM, bool kSoftcap>
__global__ void __launch_bounds__(kThreads) split_kernel(Params p) {
  constexpr int kLoads = kSlice * sizeof(T) / 16;  // 16-byte loads per slice
  __shared__ float wmax[kWarps][GM];
  __shared__ float wsum[kWarps][GM];
  __shared__ float wacc[kWarps][GM][kMaxD];
  __shared__ long long rows[kSplit];

  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / p.KV, kv = bkv % p.KV;
  const int G = p.G, D = p.D;
  const long long total = (long long)p.B * p.KV * p.n_split * G;
  const long long row0 = ((long long)bkv * p.n_split + split) * G;
  float* m_out = p.part + row0;
  float* l_out = p.part + total + row0;
  float* acc_out = p.part + 2 * total + row0 * D;

  const int plen = p.prefix_len[b];
  const int cur = p.cur_pos ? p.cur_pos[b] : plen;
  const bool prefix = split < p.n_pre;
  const int base = (prefix ? split : split - p.n_pre) * kSplit;
  int lo = base, hi;
  if (prefix) {
    // attendable prefix keys: k < prefix_len, k <= cur, cur - k < window
    hi = min(min(base + kSplit, min(plen, p.P * p.page)), cur + 1);
    if (p.window > 0) lo = max(lo, cur - p.window + 1);
  } else {
    hi = min(base + kSplit, p.T);
  }
  if (lo >= hi) {
    if (threadIdx.x < G) {
      m_out[threadIdx.x] = -INFINITY;
      l_out[threadIdx.x] = 0.f;
    }
    return;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nsl = D / kSlice;  // slices per row
  int lpk = 1;                 // lanes per key
  while (lpk < nsl) lpk <<= 1;
  const int kpp = 32 / lpk;    // keys per pass of a warp
  const int passes = max(1, kKeysPerWarp / kpp);
  const int c = lane % lpk, kq = lane / lpk;
  const bool slice_in = c < nsl;

  float qf[GM][kSlice];
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + kv * p.q_skv + c * kSlice;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (g < G && slice_in) u = reinterpret_cast<const uint4*>(qb + g * p.q_sg)[l];
      unpack16<T>(&qf[g][l * (16 / sizeof(T))], u);
    }
  }

  // where each key of the split lives (an element offset into the pool or
  // the tail, -1 for no key): one round of block-table reads for the CTA
  if (threadIdx.x < kSplit) {
    const int key = base + threadIdx.x;
    long long off = -1;
    if (key >= lo && key < hi) {
      if (prefix) {
        const int pid = p.block_tables[b * p.P + key / p.page];
        if (pid >= 0 && pid < p.N) off = (((long long)kv * p.N + pid) * p.page + key % p.page) * D;
      } else {
        const int pos = p.tail_pos[b * p.T + key];
        if (pos >= 0 && pos <= cur && (p.window <= 0 || cur - pos < p.window))
          off = b * p.e_sb + kv * p.e_skv + (long long)key * p.e_st;
      }
    }
    rows[threadIdx.x] = off;
  }
  __syncthreads();

  // every K and V slice of this lane's keys, all in flight at once
  const T* kbase = static_cast<const T*>(prefix ? p.k_pages : p.k_tail) + c * kSlice;
  const T* vbase = static_cast<const T*>(prefix ? p.v_pages : p.v_tail) + c * kSlice;
  uint4 kr[kMaxPasses][kLoads], vr[kMaxPasses][kLoads];
  bool has[kMaxPasses];
#pragma unroll
  for (int i = 0; i < kMaxPasses; ++i) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      kr[i][l] = make_uint4(0u, 0u, 0u, 0u);
      vr[i][l] = make_uint4(0u, 0u, 0u, 0u);
    }
    const int jl = i * kpp + kq;
    const long long off = i < passes && jl < kKeysPerWarp ? rows[warp * kKeysPerWarp + jl] : -1;
    has[i] = off >= 0;
    if (has[i] && slice_in) {
#pragma unroll
      for (int l = 0; l < kLoads; ++l) {
        kr[i][l] = reinterpret_cast<const uint4*>(kbase + off)[l];
        vr[i][l] = reinterpret_cast<const uint4*>(vbase + off)[l];
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
      float kf[kSlice];
#pragma unroll
      for (int l = 0; l < kLoads; ++l) unpack16<T>(&kf[l * (16 / sizeof(T))], kr[i][l]);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int e = 0; e < kSlice; e += 2) {
          d0 = fmaf(qf[g][e], kf[e], d0);
          d1 = fmaf(qf[g][e + 1], kf[e + 1], d1);
        }
        float dot = d0 + d1;
        for (int o = lpk >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        float x = dot * p.sm_scale;
        if (kSoftcap) x = p.softcap * tanhf(x / p.softcap);
        if (has[i] && g < G) {
          s[i][g] = x;
          mloc[g] = fmaxf(mloc[g], x);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    for (int o = lpk; o < 32; o <<= 1) mloc[g] = fmaxf(mloc[g], __shfl_xor_sync(0xffffffffu, mloc[g], o));
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
  float lsum[GM], acc[GM][kSlice];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    lsum[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kSlice; ++e) acc[g][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kMaxPasses; ++i) {
    if (i < passes && has[i]) {
      float vf[kSlice];
#pragma unroll
      for (int l = 0; l < kLoads; ++l) unpack16<T>(&vf[l * (16 / sizeof(T))], vr[i][l]);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float w = s[i][g] == -INFINITY ? 0.f : expf(s[i][g] - m[g]);
        if (c == 0) lsum[g] += w;
#pragma unroll
        for (int e = 0; e < kSlice; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    for (int o = 16; o > 0; o >>= 1) lsum[g] += __shfl_xor_sync(0xffffffffu, lsum[g], o);
    for (int o = lpk; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < kSlice; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
    if (lane == 0) wsum[warp][g] = lsum[g];
    if (kq == 0 && slice_in) {
#pragma unroll
      for (int e = 0; e < kSlice; ++e) wacc[warp][g][c * kSlice + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float a = wacc[0][g][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += wacc[w][g][d];
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

template <typename T, int GM>
int launch(const Params& p, cudaStream_t s) {
  const dim3 grid(p.B * p.KV, p.n_split);
  if (p.softcap > 0.f)
    split_kernel<T, GM, true><<<grid, kThreads, 0, s>>>(p);
  else
    split_kernel<T, GM, false><<<grid, kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const SplitMerge merge{p.part, p.out, p.B * p.KV, p.G, p.D, p.n_pre, p.n_split, kMergeParts, 0};
  return (int)launch_split_merge<T>(merge, s);
}

template <typename T>
int dispatch(const Params& p, cudaStream_t s) {
  if (p.G <= 2) return launch<T, 2>(p, s);
  if (p.G <= 4) return launch<T, 4>(p, s);
  return launch<T, 8>(p, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  split_keys must equal the kernel's
// split size (64); n_pre = ceil(P * page / split_keys) prefix splits and
// n_split = n_pre + ceil(T / split_keys) (at least 1).  part holds
// B * KV * n_split * G * (D + 2) floats.  Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for shapes the kernels do not take).
int paged_decode_forward(int dtype, const void* q, const void* k_pages, const void* v_pages,
                         const int* block_tables, const int* prefix_len, const void* k_tail,
                         const void* v_tail, const int* tail_pos, const int* cur_pos, void* out,
                         float* part, long long q_sb, long long q_skv, long long q_sg,
                         long long e_sb, long long e_skv, long long e_st, int B, int KV, int G,
                         int D, int N, int page, int P, int T, int split_keys, int n_pre,
                         int n_split, float softcap, int window, void* stream) {
  if (split_keys != kSplit || D <= 0 || D > kMaxD || D % kSlice || B <= 0 || KV <= 0 || G <= 0 ||
      G > 8 || page <= 0 || P < 0 || T < 0 || n_pre < 0 || n_split < 1 || n_split > 65535 ||
      (long long)n_pre * kSplit < (long long)P * page ||
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
  p.sm_scale = 1.0f / sqrtf((float)D);
  p.softcap = softcap;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
