// Paged chunked-prefill attention for the serving path, written for Hopper
// (sm_90a).
//
// The wrappers call this kernel body for one entry point:
//   * chunked prefill (replaces kernels/paged_attention.py:paged_prefill_attention_pallas)
//     rows = G*C chunk queries, row r at chunk offset r % C and absolute
//     position prefix_len + r % C; keys = the prefix pages, then the chunk's
//     own keys at positions prefix_len + t (causal within the chunk).
// The body also takes the decode layout (rows = the G grouped queries at
// cur_pos, keys = the prefix pages then a tail at tail_pos; with T = 0 and
// no cur_pos, the pages-only decode), which paged decode and paged attention
// ran on before they moved to the split-KV kernel of paged_decode.cu.
//
// Masks (every layout): a key at absolute position k_pos is attended by
// a query at q_pos iff k_pos >= 0, k_pos <= q_pos, a prefix key also has
// k_pos < prefix_len, and with a window, q_pos - k_pos < window.  Scores are
// q.k / sqrt(D), optionally soft-capped (softcap * tanh(s / softcap)), and
// reduced with an f32 online softmax; the output is acc / max(l, 1e-30).
// Only valid keys enter the softmax, so a row with no valid key at all
// yields zeros (the reference's dense softmax spreads uniform weights over
// such a row instead; the serving path never produces one).
//
// What bounds it on the card: bytes.  At decode each (sequence, kv head)
// reads its prefix pages and tail once and does 4*G FLOPs per key element;
// at prefill the G*C = 64 rows reuse each key 64 times, still far below the
// ~295 FLOPs/byte where the tensor cores would bound it.  The design loads
// each 32-key tile once per CTA with 16-byte vector loads (coalesced, one
// page row per 16 threads at D=128 bf16) into registers one tile ahead, so
// the next tile's loads are in flight while the current one is computed;
// it reads page ids from the block table inside the kernel, never touches
// pages past prefix_len or before the window, splits each q.k dot product
// over up to 8 lanes when the CTA has few rows (decode: G = 2) with four
// independent partial sums per lane, reduces each row's softmax statistics
// over 16 lanes, and accumulates values key-outermost so that one shared-
// memory load of a value feeds every row a thread owns (the FMA chains of
// different rows run side by side).  Each CTA computes its rows independently
// of the batch width, so a row's result does not depend on where it sits in
// the batch.  Left for later: wgmma for the QK/PV products, TMA page loads,
// and one CTA per (sequence, kv head) instead of re-reading the keys for
// every 16-row tile.
//
// The kernel allocates nothing and does not synchronise; the caller passes
// the stream and checks the returned cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 16;  // query rows per CTA
constexpr int kKeyTile = 32;  // keys per shared-memory tile
constexpr int kMaxD = 128;
constexpr int kAccPerThread = kRowTile * kMaxD / kThreads;  // output rows per thread
constexpr int kLanesPerRow = kThreads / kRowTile;  // softmax lanes per row

struct Params {
  const void* q;             // rows addressed by (b, kv, g, c) strides; D contiguous
  const void* k_pages;       // [KV, N, page, D] contiguous
  const void* v_pages;
  const int* block_tables;   // [B, P]
  const int* prefix_len;     // [B]
  const void* k_extra;       // decode: tail [B, KV, T, D]; prefill: chunk [B, KV, C, D]
  const void* v_extra;
  const int* extra_pos;      // decode: tail_pos [B, T]; prefill: null (prefix_len + t)
  const int* cur_pos;        // decode: [B]; prefill: null (prefix_len + c)
  void* out;                 // [B, KV, G*C, D] contiguous
  long long q_sb, q_skv, q_sg, q_sc;
  long long e_sb, e_skv, e_st;
  int B, KV, G, C, D, N, page, P, T;
  float sm_scale, softcap;
  int window;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T -> floats in shared memory
template <typename T>
__device__ __forceinline__ void unpack16(float* dst, const uint4& u) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < int(16 / sizeof(T)); ++i) dst[i] = to_f<T>(e[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Params p) {
  constexpr int kVec = 16 / sizeof(T);                       // elements per 16-byte load
  constexpr int kLoads = kKeyTile * (kMaxD / kVec) / kThreads;  // max loads per thread per side
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;  // padded row stride: a column read hits 32 banks
  float* qs = smem;                        // [kRowTile][ld]
  float* ks = qs + kRowTile * ld;          // [kKeyTile][ld]
  float* vs = ks + kKeyTile * ld;          // [kKeyTile][ld]
  float* ps = vs + kKeyTile * ld;          // [kRowTile][kKeyTile] scores, then weights
  float* m_s = ps + kRowTile * kKeyTile;   // [kRowTile] running max
  float* l_s = m_s + kRowTile;             // [kRowTile] running sum
  float* corr_s = l_s + kRowTile;          // [kRowTile] this tile's rescale
  int* kpos_s = reinterpret_cast<int*>(corr_s + kRowTile);  // [kKeyTile], -1 = no key
  int* qpos_s = kpos_s + kKeyTile;                           // [kRowTile]

  const int tid = threadIdx.x;
  const int bkv = blockIdx.x;
  const int b = bkv / p.KV;
  const int kv = bkv % p.KV;
  const int R = p.G * p.C;
  const int r0 = blockIdx.y * kRowTile;
  const int nr = min(kRowTile, R - r0);
  const int plen = p.prefix_len[b];
  const int n_prefix = max(0, min(plen, p.P * p.page));
  const int nvec = D / kVec;

  const T* q = static_cast<const T*>(p.q);
  for (int i = tid; i < nr * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int r = r0 + rr;
    const int g = r / p.C, c = r % p.C;
    qs[rr * ld + d] = to_f<T>(q[b * p.q_sb + kv * p.q_skv + g * p.q_sg + c * p.q_sc + d]);
  }
  int qmin = 0x7fffffff;
  for (int rr = 0; rr < nr; ++rr) {
    const int qp = p.cur_pos ? p.cur_pos[b] : plen + (r0 + rr) % p.C;
    qmin = min(qmin, qp);
  }
  if (tid < kRowTile) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    qpos_s[tid] = p.cur_pos ? p.cur_pos[b] : plen + (r0 + tid) % p.C;
  }
  // output layout: each thread owns one column of a power-of-two padded
  // width Dp >= D and the rows row0, row0 + rstride, ...
  const int Dp = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
  const int col = tid % Dp;
  const int row0 = tid / Dp;
  const int rstride = kThreads / Dp;
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  // Tiles: prefix keys [kstart, n_prefix) first — keys before the window of
  // every row in this CTA can never be attended and are not loaded — then
  // the in-flight keys (decode tail slots or the prefill chunk).
  const int kstart = p.window > 0 ? min(n_prefix, max(0, qmin - p.window + 1)) : 0;
  const int n_pre_tiles = (n_prefix - kstart + kKeyTile - 1) / kKeyTile;
  const int n_tiles = n_pre_tiles + (p.T + kKeyTile - 1) / kKeyTile;
  const T* kp_base = static_cast<const T*>(p.k_pages);
  const T* vp_base = static_cast<const T*>(p.v_pages);
  const T* ke = static_cast<const T*>(p.k_extra);
  const T* ve = static_cast<const T*>(p.v_extra);

  // row of key j of tile t, or null when there is no key there
  auto key_row = [&](int t, int j, const T* kb, const T* vb, const T* ek, const T* ev,
                     const T** kr, const T** vr, int* pos) {
    *kr = nullptr;
    *vr = nullptr;
    *pos = -1;
    if (t < n_pre_tiles) {
      const int kidx = kstart + t * kKeyTile + j;
      if (kidx >= n_prefix) return;
      const int pid = p.block_tables[b * p.P + kidx / p.page];
      if (pid < 0 || pid >= p.N) return;
      const long long row = ((long long)kv * p.N + pid) * p.page + kidx % p.page;
      *kr = kb + row * D;
      *vr = vb + row * D;
      *pos = kidx;
    } else {
      const int te = (t - n_pre_tiles) * kKeyTile + j;
      if (te >= p.T) return;
      const long long off = b * p.e_sb + kv * p.e_skv + (long long)te * p.e_st;
      *kr = ek + off;
      *vr = ev + off;
      *pos = p.extra_pos ? p.extra_pos[b * p.T + te] : plen + te;
    }
  };

  uint4 kreg[kLoads], vreg[kLoads];
  auto fetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int v = tid + i * kThreads;
      kreg[i] = make_uint4(0u, 0u, 0u, 0u);
      vreg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (v < kKeyTile * nvec) {
        const T* kr;
        const T* vr;
        int pos;
        key_row(t, v / nvec, kp_base, vp_base, ke, ve, &kr, &vr, &pos);
        if (kr != nullptr) {
          kreg[i] = reinterpret_cast<const uint4*>(kr)[v % nvec];
          vreg[i] = reinterpret_cast<const uint4*>(vr)[v % nvec];
        }
      }
    }
  };
  auto stash = [&](int t) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int v = tid + i * kThreads;
      if (v < kKeyTile * nvec) {
        const int j = v / nvec, dv = v % nvec;
        unpack16<T>(ks + j * ld + dv * kVec, kreg[i]);
        unpack16<T>(vs + j * ld + dv * kVec, vreg[i]);
      }
    }
    if (tid < kKeyTile) {
      const T* kr;
      const T* vr;
      int pos;
      key_row(t, tid, kp_base, vp_base, ke, ve, &kr, &vr, &pos);
      kpos_s[tid] = pos;
    }
  };

  const int npairs = nr * kKeyTile;
  const int spread = kThreads / npairs;
  const int tpp = spread >= 8 ? 8 : spread >= 4 ? 4 : spread >= 2 ? 2 : 1;
  const int sub = tid & (tpp - 1);

  if (n_tiles > 0) fetch(0);
  for (int t = 0; t < n_tiles; ++t) {
    const bool prefix = t < n_pre_tiles;
    stash(t);
    __syncthreads();
    if (t + 1 < n_tiles) fetch(t + 1);  // next tile's loads fly during this tile

    // scores: tpp lanes per (row, key) pair split the head dimension
    for (int base = 0; base < npairs * tpp; base += kThreads) {
      const int pidx = (base + tid) / tpp;
      const bool in = pidx < npairs;
      const int rr = in ? pidx / kKeyTile : 0;
      const int j = in ? pidx % kKeyTile : 0;
      const int kp = kpos_s[j], qp = qpos_s[rr];
      bool valid = in && kp >= 0 && kp <= qp && (!prefix || kp < plen);
      if (p.window > 0) valid = valid && (qp - kp < p.window);
      float dot = 0.f;
      if (valid) {
        // four independent partial sums keep the FMA pipeline busy
        const float* qr = qs + rr * ld;
        const float* kr = ks + j * ld;
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
        int d = sub;
        for (; d + 3 * tpp < D; d += 4 * tpp) {
          d0 = fmaf(qr[d], kr[d], d0);
          d1 = fmaf(qr[d + tpp], kr[d + tpp], d1);
          d2 = fmaf(qr[d + 2 * tpp], kr[d + 2 * tpp], d2);
          d3 = fmaf(qr[d + 3 * tpp], kr[d + 3 * tpp], d3);
        }
        for (; d < D; d += tpp) d0 = fmaf(qr[d], kr[d], d0);
        dot = (d0 + d1) + (d2 + d3);
      }
      for (int o = tpp >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (in && sub == 0) {
        float s = -INFINITY;
        if (valid) {
          s = dot * p.sm_scale;
          if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        }
        ps[rr * kKeyTile + j] = s;
      }
    }
    __syncthreads();

    // online softmax: kLanesPerRow lanes per row
    {
      const int rr = tid / kLanesPerRow, lane = tid % kLanesPerRow;
      const bool live = rr < nr;
      float* pr = ps + rr * kKeyTile;
      float mt = -INFINITY;
      if (live)
        for (int j = lane; j < kKeyTile; j += kLanesPerRow) mt = fmaxf(mt, pr[j]);
      for (int o = kLanesPerRow >> 1; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = live ? m_s[rr] : -INFINITY;
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      if (live) {
        for (int j = lane; j < kKeyTile; j += kLanesPerRow) {
          const float s = pr[j];
          const float e = (s == -INFINITY) ? 0.f : expf(s - m_new);
          pr[j] = e;
          sum += e;
        }
      }
      for (int o = kLanesPerRow >> 1; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (live && lane == 0) {
        const float corr = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        m_s[rr] = m_new;
        l_s[rr] = l_s[rr] * corr + sum;
        corr_s[rr] = corr;
      }
    }
    __syncthreads();

    // weighted values: one value load per key feeds every row of the thread
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int rr = row0 + i * rstride;
      if (rr < nr) acc[i] *= corr_s[rr];
    }
    if (col < D) {
#pragma unroll 4
      for (int j = 0; j < kKeyTile; ++j) {
        const float vj = vs[j * ld + col];
#pragma unroll
        for (int i = 0; i < kAccPerThread; ++i) {
          const int rr = row0 + i * rstride;
          if (rr < nr) acc[i] = fmaf(ps[rr * kKeyTile + j], vj, acc[i]);
        }
      }
    }
    __syncthreads();
  }

  __syncthreads();  // l_s is final (and visible) even when there was no tile
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int rr = row0 + i * rstride;
    if (rr < nr && col < D) {
      const float l = fmaxf(l_s[rr], 1e-30f);
      out[((long long)bkv * R + r0 + rr) * D + col] = from_f<T>(acc[i] / l);
    }
  }
}

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) * (size_t)(kRowTile * ld + 2 * kKeyTile * ld + kRowTile * kKeyTile +
                                  3 * kRowTile) +
         sizeof(int) * (size_t)(kKeyTile + kRowTile);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes the kernel does not take).
int paged_attention_forward(int dtype, const void* q, const void* k_pages, const void* v_pages,
                            const int* block_tables, const int* prefix_len, const void* k_extra,
                            const void* v_extra, const int* extra_pos, const int* cur_pos,
                            void* out, long long q_sb, long long q_skv, long long q_sg,
                            long long q_sc, long long e_sb, long long e_skv, long long e_st, int B,
                            int KV, int G, int C, int D, int N, int page, int P, int T,
                            float softcap, int window, void* stream) {
  if (D <= 0 || D > kMaxD || B <= 0 || KV <= 0 || G <= 0 || C <= 0 || page <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.block_tables = block_tables;
  p.prefix_len = prefix_len;
  p.k_extra = k_extra;
  p.v_extra = v_extra;
  p.extra_pos = extra_pos;
  p.cur_pos = cur_pos;
  p.out = out;
  p.q_sb = q_sb;
  p.q_skv = q_skv;
  p.q_sg = q_sg;
  p.q_sc = q_sc;
  p.e_sb = e_sb;
  p.e_skv = e_skv;
  p.e_st = e_st;
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.C = C;
  p.D = D;
  p.N = N;
  p.page = page;
  p.P = P;
  p.T = T;
  p.sm_scale = 1.0f / sqrtf((float)D);
  p.softcap = softcap;
  p.window = window;
  const int R = G * C;
  dim3 grid(B * KV, (R + kRowTile - 1) / kRowTile);
  const size_t smem = smem_bytes(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    paged_attention_kernel<float><<<grid, kThreads, smem, s>>>(p);
  } else if (dtype == 1) {
    paged_attention_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
