// Paged chunked-prefill attention for the serving path, written for Hopper
// (sm_90a).
//
// Replaces kernels/paged_attention.py:paged_prefill_attention_pallas: one
// chunk of C queries per sequence, the G query heads of each kv head, at
// absolute positions prefix_len + c, attends the prefix keys k < prefix_len
// through the block table (a table entry outside [0, N) is no key), then
// the chunk's own C keys at positions prefix_len + t, causally (t <= c).
// With a window a key counts only while q_pos - k_pos < window.  Scores are
// q.k / sqrt(D), optionally soft-capped (softcap * tanh(s / softcap)), and
// reduced with an f32 softmax; the output is acc / max(l, 1e-30).  Only
// valid keys enter the softmax, so a row with no valid key at all yields
// zeros (the reference's dense softmax spreads uniform weights over such a
// row instead; the serving path never produces one: every row attends at
// least itself).
//
// What bounds it on the card.  The G * C rows of one (sequence, kv head)
// share its keys: G * C = 64 on qwen3-1.7b (G = 2, C = 32), so each bf16
// key/value element (2 bytes) feeds 4 * 64 = 256 FLOPs of the reference's
// work, 128 FLOPs per byte, under the bf16 tensor cores' ridge (989
// TFLOP/s over 3.35 TB/s, ~295 FLOPs per byte): bytes bound it.
//
// Design: one front end (PrefillFront) over the split-KV kernels of
// attention_split.cuh.  The keys are cut into splits by absolute position:
// the first n_pos = ceil((P * page + C) / 64) splits hold positions [64 j,
// 64 j + 64), and slot r of split j is position x = 64 j + r: a prefix page
// key when x < min(prefix_len, P * page), else chunk key x - prefix_len.
// The chunk is not a split of its own: a chunk key joins the split its
// position falls in, beside prefix keys from pages, so a chunk that starts
// at 0, 4, 32 or 100 gives each query the bits of the cold route, and of
// a decode step or a flash prefill at the same position.  (A prefix_len
// past the table's P * page puts the chunk in ceil(C / 64) more splits by
// chunk index; the serving path never passes one.)  The grid is (B * KV,
// row tiles, n_split), n_split taken on the host from the table's width,
// so nothing is read back.  A CTA's 64 rows are stacked (chunk position,
// head) pairs s = c * G + g of one kv head, so one K/V tile in shared
// memory serves every head and chunk position.  Each CTA resolves its
// split's 64 key slots in one round of block-table reads and copies Q, K
// and V into swizzled tiles by cp.async (zero-filled for a slot without a
// key), then each warp runs the bf16 body (tensor_core.cuh: split_partial,
// P V with P split into two bf16 terms) on its 16 rows and writes the
// split's f32 partial; split_merge.cuh, launched by the same C call, folds
// the splits in ascending order.  Head dims are multiples of 8 up to 256 in
// bf16, tiles zero-padded to 16, 32, 64, 128, 160 or 256 columns.
// float32 (the card tests' 1e-5 path, which no bf16 or TF32 product
// meets) and head dims past 256 run the SIMT body over the same splits.
// Left for later: wgmma with TMA page loads, and a ring of K/V stages per
// CTA over several splits.
//
// The kernels allocate nothing and do not synchronise; the caller passes
// the stream and the scratch and checks the returned cudaGetLastError().

#include <math.h>

#include "attention_split.cuh"

namespace {

using namespace repro_kernels;  // common.cuh, split_merge.cuh, tensor_core.cuh, attention_split.cuh

struct PrefillParams {
  const void* q;             // [B, KV, G, C, D] by strides, D contiguous
  const void* k_pages;       // [KV, N, page, D] contiguous
  const void* v_pages;
  const int* block_tables;   // [B, P]
  const int* prefix_len;     // [B]
  const void* k_chunk;       // [B, KV, C, D] by strides, D contiguous
  const void* v_chunk;
  void* out;                 // [B, KV, G, C, D] contiguous
  float* part;               // split partials (split_merge.cuh, R = G * C)
  long long q_sb, q_skv, q_sg, q_sc;
  long long e_sb, e_skv, e_st;
  int B, KV, G, C, D, N, page, P, n_pos, n_split, BKV;
  float sm_scale, softcap;
  int window;
};

template <typename TT>
struct PrefillFront {
  using T = TT;
  using Params = PrefillParams;
  const Params& p;
  Rows<T> rows;
  bool uniform = false, causal = true;
  int window, b, kv, split, plen, n_prefix;
  bool regular;  // chunk key t at position prefix_len + t joins the position splits

  __device__ PrefillFront(const Params& p_, int bkv, int split_) : p(p_), split(split_) {
    b = bkv / p.KV;
    kv = bkv % p.KV;
    plen = p.prefix_len[b];
    n_prefix = max(0, min(plen, p.P * p.page));
    regular = plen >= 0 && plen <= p.P * p.page;
    window = p.window;
    rows = Rows<T>{static_cast<const T*>(p.q) + b * p.q_sb + kv * p.q_skv, p.q_sg, p.q_sc, p.G,
                   p.C, plen};
  }

  __device__ void chunk(int t, const T*& k, const T*& v) const {
    const long long off = b * p.e_sb + kv * p.e_skv + (long long)t * p.e_st;
    k = static_cast<const T*>(p.k_chunk) + off;
    v = static_cast<const T*>(p.v_chunk) + off;
  }

  __device__ bool key(int r, const T*& k, const T*& v, int& pos) const {
    if (split < p.n_pos) {
      const int x = split * kSplitKeys + r;
      pos = x;
      if (x < n_prefix) {
        const int pid = p.block_tables[(long long)b * p.P + x / p.page];
        if (pid < 0 || pid >= p.N) return false;
        const long long off = (((long long)kv * p.N + pid) * p.page + x % p.page) * p.D;
        k = static_cast<const T*>(p.k_pages) + off;
        v = static_cast<const T*>(p.v_pages) + off;
        return true;
      }
      const int t = x - plen;
      if (!regular || t < 0 || t >= p.C) return false;
      chunk(t, k, v);
      return true;
    }
    const int t = (split - p.n_pos) * kSplitKeys + r;  // the chunk past a prefix_len > P * page
    if (regular || t >= p.C) return false;
    pos = plen + t;
    chunk(t, k, v);
    return true;
  }
};

template <typename T>
int run(const PrefillParams& p, cudaStream_t s) {
  using F = PrefillFront<T>;
  const int R = p.G * p.C;
  cudaError_t err = cudaSuccess;
  if constexpr (sizeof(T) == 2) {
#define REPRO_LAUNCH(DP) launch_tc_split_dp<F, DP>(p, R, s)
    err = p.D <= 256 ? REPRO_TC_DISPATCH(p.D, REPRO_LAUNCH) : launch_simt_split<F>(p, R, s);
#undef REPRO_LAUNCH
  } else {
    err = launch_simt_split<F>(p, R, s);
  }
  if (err != cudaSuccess) return (int)err;
  const SplitMerge m{p.part, p.out, (long long)p.KV * R * p.D, (long long)p.C * p.D, (long long)p.D,
                     p.BKV, p.KV, p.G, p.C, p.D, p.n_split, nullptr, 0, 0, 0, 0};
  return (int)launch_split_merge<T>(m, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (D a multiple of 4), 1 = bfloat16 (D a multiple of
// 8); any D.  split_keys must equal the kernels' split size (64), n_pos =
// ceil((P * page + C) / split_keys) and n_split = n_pos + ceil(C /
// split_keys); part holds B * KV * n_split * G * C * (D + 2) floats.
// sm_scale multiplies every score: 1 / sqrt(d) of the head dim d before the
// caller zero-padded it to D.  Strides are in elements.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for shapes
// the kernels do not take).
int paged_attention_forward(int dtype, const void* q, const void* k_pages, const void* v_pages,
                            const int* block_tables, const int* prefix_len, const void* k_chunk,
                            const void* v_chunk, void* out, float* part, long long q_sb,
                            long long q_skv, long long q_sg, long long q_sc, long long e_sb,
                            long long e_skv, long long e_st, int B, int KV, int G, int C, int D,
                            int N, int page, int P, int split_keys, int n_pos, int n_split,
                            float sm_scale, float softcap, int window, void* stream) {
  if (D <= 0 || D % (dtype == 0 ? 4 : 8) || B <= 0 || KV <= 0 || G <= 0 || C <= 0 || page <= 0 ||
      P < 0 || part == nullptr || split_keys != kSplitKeys || (long long)B * KV > 0x7fffffffLL ||
      ((long long)G * C + 7) / 8 > 65535 || (long long)n_pos * kSplitKeys < (long long)P * page + C ||
      (long long)(n_split - n_pos) * kSplitKeys < (long long)C || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  PrefillParams p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.block_tables = block_tables;
  p.prefix_len = prefix_len;
  p.k_chunk = k_chunk;
  p.v_chunk = v_chunk;
  p.out = out;
  p.part = part;
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
