// Split-KV paged decode attention for Hopper (sm_90a).
//
// Two entry points, one front end over the split-KV kernels of
// attention_split.cuh:
//   * paged decode (replaces kernels/paged_attention.py:paged_decode_attention_pallas)
//     rows = the G grouped queries of one (sequence, kv head) at position
//     cur_pos[b]; keys = the block-table prefix pages (k_pos < prefix_len),
//     and the dense in-flight tail whose absolute positions come from
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
// Domain: any D (a multiple of 8 in bf16, of 4 in f32), any G.
//
// What bounds it on the card: bytes.  Each key/value element is used for
// 4*G FLOPs (G = 2 on qwen3-1.7b, 4 on stablelm-12b, 1 on deepseek-7b), far
// under the ~295 FLOPs per byte where the tensor cores would bound it.
//
// Design.  The keys are cut into splits by absolute position, as every
// attention kernel of this directory cuts them (attention_split.cuh): the
// first n_pos = ceil((P * page + T) / 64) splits hold positions [64 j,
// 64 j + 64).  Slot r of split j is position x = 64 j + r: a prefix page
// key when x < min(prefix_len, P * page) (no key when its page id is
// outside [0, N)), else the tail slot t = x - prefix_len when tail_pos[t]
// == x.  So a decoded tail key sits in the same slot of the same split as
// the same position's key of a prefill chunk or of contiguous K/V, and a
// decode step reduces its row in the order of the cold route.  A tail slot
// at any other position (tail_pos[t] != prefix_len + t, or a prefix_len
// past the table) goes to one of ceil(T / 64) more splits by slot index;
// the serving path never fills one.  A sequence with no valid key (decided
// per CTA from prefix_len, cur_pos, the window and, only when no prefix key
// counts, the tail positions) instead walks its gathered window by gathered
// index in the first splits, every present key scoring 0: each split
// leaves (m = 0, l = count, acc = sum v) and the merge gives the mean.
// bfloat16 up to D = 256 runs the tensor-core body (split_partial: a
// decode step's G rows padded to the 16-row mma tile, one warp per CTA up
// to G = 16, QK^T and P V on mma.sync with P split into two bf16 terms);
// float32 and head dims past 256 run the SIMT body.  split_merge.cuh,
// launched by the same C call, folds the splits in ascending order.  No
// atomics touch the values, and a row's splits depend only on its keys'
// positions, so its result does not depend on the batch width, its place
// in the batch or the table width (empty splits add nothing).
//
// The kernels allocate nothing and do not synchronise; the caller passes
// the stream and checks the returned cudaGetLastError().

#include <math.h>

#include "attention_split.cuh"

namespace {

using namespace repro_kernels;  // common.cuh, split_merge.cuh, tensor_core.cuh, attention_split.cuh

struct DecodeParams {
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
  int B, KV, G, D, N, page, P, T, n_pos, n_split, BKV;
  float sm_scale, softcap;
  int window;
};

template <typename TT>
struct DecodeFront {
  using T = TT;
  using Params = DecodeParams;
  const Params& p;
  Rows<T> rows;
  bool uniform, causal;
  int window, b, kv, split, plen, n_prefix;
  bool regular;  // tail slot t at position prefix_len + t joins the position splits

  __device__ DecodeFront(const Params& p_, int bkv, int split_) : p(p_), split(split_) {
    b = bkv / p.KV;
    kv = bkv % p.KV;
    plen = p.prefix_len[b];
    const int cur = p.cur_pos ? p.cur_pos[b] : plen;
    n_prefix = max(0, min(plen, p.P * p.page));
    regular = plen >= 0 && plen <= p.P * p.page;
    rows = Rows<T>{static_cast<const T*>(p.q) + b * p.q_sb + kv * p.q_skv, p.q_sg, 0, p.G, 1, cur};
    // does the sequence have any attendable key?  The prefix by arithmetic;
    // the tail positions are read only when no prefix key counts (the same
    // branch for every thread of the CTA)
    bool none = (p.window > 0 ? max(0, cur - p.window + 1) : 0) >= min(n_prefix, cur + 1);
    if (none && p.T > 0) {
      bool any = false;
      for (int t = threadIdx.x; t < p.T; t += blockDim.x) {
        const int pos = p.tail_pos[(long long)b * p.T + t];
        any |= pos >= 0 && pos <= cur && (p.window <= 0 || cur - pos < p.window);
      }
      none = !__syncthreads_or(any);
    }
    uniform = none;
    causal = !none;
    window = none ? 0 : p.window;
  }

  __device__ const T* tail(const void* base, int t) const {
    return static_cast<const T*>(base) + b * p.e_sb + kv * p.e_skv + (long long)t * p.e_st;
  }
  __device__ const T* page_row(const void* base, int pid, int x) const {
    return static_cast<const T*>(base) + (((long long)kv * p.N + pid) * p.page + x % p.page) * p.D;
  }

  __device__ bool key(int r, const T*& k, const T*& v, int& pos) const {
    const int PP = p.P * p.page;
    if (split < p.n_pos) {
      const int x = split * kSplitKeys + r;  // a position (or, with no valid key, a gathered index)
      pos = x;
      if (uniform) {  // the reference's gather: every table column, then every tail slot
        if (x < PP) {
          int pid = p.block_tables[(long long)b * p.P + x / p.page];
          pid = min(max(pid < 0 ? pid + p.N : pid, 0), p.N - 1);
          k = page_row(p.k_pages, pid, x);
          v = page_row(p.v_pages, pid, x);
          return true;
        }
        if (x - PP >= p.T) return false;
        k = tail(p.k_tail, x - PP);
        v = tail(p.v_tail, x - PP);
        return true;
      }
      if (x < n_prefix) {
        const int pid = p.block_tables[(long long)b * p.P + x / p.page];
        if (pid < 0 || pid >= p.N) return false;
        k = page_row(p.k_pages, pid, x);
        v = page_row(p.v_pages, pid, x);
        return true;
      }
      const int t = x - plen;
      if (!regular || t < 0 || t >= p.T || p.tail_pos[(long long)b * p.T + t] != x) return false;
      k = tail(p.k_tail, t);
      v = tail(p.v_tail, t);
      return true;
    }
    if (uniform) return false;
    const int t = (split - p.n_pos) * kSplitKeys + r;  // a tail slot at another position
    if (t >= p.T) return false;
    pos = p.tail_pos[(long long)b * p.T + t];
    if (pos < 0 || (regular && pos == plen + t)) return false;
    k = tail(p.k_tail, t);
    v = tail(p.v_tail, t);
    return true;
  }
};

template <typename T>
int run(const DecodeParams& p, cudaStream_t s) {
  using F = DecodeFront<T>;
  cudaError_t err = cudaSuccess;
  if constexpr (sizeof(T) == 2) {
#define REPRO_LAUNCH(DP) launch_tc_split_dp<F, DP>(p, p.G, s)
    err = p.D <= 256 ? REPRO_TC_DISPATCH(p.D, REPRO_LAUNCH) : launch_simt_split<F>(p, p.G, s);
#undef REPRO_LAUNCH
  } else {
    err = launch_simt_split<F>(p, p.G, s);
  }
  if (err != cudaSuccess) return (int)err;
  const SplitMerge m{p.part, p.out, (long long)p.KV * p.G * p.D, (long long)p.D, 0,
                     p.BKV, p.KV, p.G, 1, p.D, p.n_split, nullptr, 0, 0, 0, 0};
  return (int)launch_split_merge<T>(m, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (D a multiple of 4), 1 = bfloat16 (D a multiple of
// 8); any D and G.  sm_scale multiplies every score: 1 / sqrt(d) of the
// head dim d before the caller zero-padded it to D.  split_keys must equal
// the kernels' split size (64); n_pos = ceil((P * page + T) / split_keys)
// position splits and n_split = n_pos + ceil(T / split_keys).  part holds
// B * KV * n_split * G * (D + 2) floats.  Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for shapes the kernels do not take).
int paged_decode_forward(int dtype, const void* q, const void* k_pages, const void* v_pages,
                         const int* block_tables, const int* prefix_len, const void* k_tail,
                         const void* v_tail, const int* tail_pos, const int* cur_pos, void* out,
                         float* part, long long q_sb, long long q_skv, long long q_sg,
                         long long e_sb, long long e_skv, long long e_st, int B, int KV, int G,
                         int D, int N, int page, int P, int T, int split_keys, int n_pos,
                         int n_split, float sm_scale, float softcap, int window, void* stream) {
  const int vec = dtype == 0 ? 4 : 8;  // elements per 16-byte load
  const long long rows = G;
  if (split_keys != kSplitKeys || D <= 0 || D % vec || B <= 0 || KV <= 0 || G <= 0 ||
      (long long)B * KV > 0x7fffffffLL || (rows + 15) / 16 > 65535 || page <= 0 || P < 0 ||
      T < 0 || (long long)n_pos * kSplitKeys < (long long)P * page + T ||
      (long long)(n_split - n_pos) * kSplitKeys < (long long)T || n_split > 65535 || n_pos < 1 ||
      (T > 0 && tail_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  DecodeParams p;
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
  p.n_pos = n_pos;
  p.n_split = n_split;
  p.BKV = B * KV;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(p, s);
  if (dtype == 1) return run<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
