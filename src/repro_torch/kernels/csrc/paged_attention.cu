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
// reduced with an f32 online softmax; the output is acc / max(l, 1e-30).
// Only valid keys enter the softmax, so a row with no valid key at all
// yields zeros (the reference's dense softmax spreads uniform weights over
// such a row instead; the serving path never produces one: every row
// attends at least itself).
//
// What bounds it on the card.  The G * C rows of one (sequence, kv head)
// share its keys: G * C = 64 on qwen3-1.7b (G = 2, C = 32), so each bf16
// key/value element (2 bytes) feeds 4 * 64 = 256 FLOPs, i.e. 128 FLOPs per
// byte.  That is under the bf16 tensor cores' ridge (989 TFLOP/s over
// 3.35 TB/s, ~295 FLOPs per byte), so on the tensor cores bytes bound it;
// on the CUDA cores in f32 (67 TFLOP/s, a ridge of ~20 FLOPs per byte) the
// same work is bound by operations, about 3x its byte time at long
// prefixes.  The first kernel of this entry point ran one CTA per (sequence,
// kv head, 16 rows) on the CUDA cores, re-read every key for each 16-row
// tile, and walked 32-key f32 tiles through four barrier-separated phases:
// a serial tile chain, 84x its byte bound on the H100 at the smoke test's
// serving shape.
//
// Two kernels, chosen by dtype (not a fallback: each takes only its type):
//
// * bfloat16, the serving dtype: tc_prefill_kernel, split-KV on the tensor
//   cores.  The prefix keys are cut by key index into splits of kSplitKeys
//   (128) keys, and the chunk's own keys form one more split after them;
//   the grid is (B * KV, 64-row tiles, n_split), with n_split taken on the
//   host from the block table's width, so nothing is read back.  A CTA's 64
//   rows are the stacked (chunk position, head) pairs s = c * G + g of one
//   kv head, query-major (flash_attention.cu's layout), so one K/V tile in
//   shared memory serves every head and chunk position; G * C > 64 walks
//   more row tiles, and the spare rows of a smaller G * C are masked.  The
//   CTA first reads its split's page ids from the block table into shared
//   memory in one round; then each 16-byte cp.async takes its source row
//   from (kv * N + page_id) * page + k % page (zero-filled for an invalid
//   id, a key past prefix_len or before the window, which are never
//   loaded) into XOR-swizzled tiles addressed by the tile row alone, so
//   ldmatrix reads them as if the rows were contiguous.  Two warpgroups
//   take alternate 64-key tiles, each through its own 2-stage cp.async ring
//   (a 128-key split is one tile per warpgroup), with QK^T and PV as
//   mma.sync.m16n8k16 bf16 (V by ldmatrix .trans), P rounded to bf16 for
//   PV, and merge through shared memory at the end, as in
//   flash_attention.cu.  Soft-capping is a template parameter; the mask
//   runs only on edge tiles, with the branch outside the element loop:
//   prefix tiles need no causal term (every prefix key precedes every chunk
//   query), so only the ragged last prefix tile, the window's first tiles
//   and the chunk's own tile mask.  Each CTA writes f32 (m, l, acc) for its
//   rows into scratch, and split_merge.cuh's kernel, launched by the same C
//   call, merges the splits in split order: a row's result does not depend
//   on the batch width, its place in the batch or the table width.  Head
//   dims are multiples of 8 up to 256, tiles zero-padded to 16, 32, 64,
//   128, 160 or 256 columns (24 runs as 32, 80 as 128, 136-160 as 160,
//   168-256 as 256); the padded columns are zeros in Q, K and V, so they add
//   nothing to a score and are never written.  Registers bound the wide
//   tiles: a thread holds DP / 2 f32 accumulators (80 at 160, 128 at 256)
//   besides its 32 scores, so past DP = 128 the Q fragments stay in shared
//   memory and are re-read by ldmatrix at each k-step (one more ldmatrix
//   per four of K), and V's fragments are loaded 5 or 2 at a time; shared
//   memory bounds DP = 256 to one K/V stage per warpgroup (160 KiB with
//   Q), where 160 keeps two (180 KiB).  Left for later: wgmma with TMA page loads (mma.sync's A
//   operand is 16 rows, so each of a warpgroup's 4 warps reads the whole K
//   and V tile from shared memory through ldmatrix, where wgmma reads its B
//   operand once per warpgroup), and fusing the merge into the last CTA of
//   each (sequence, kv head).
//
// * float32 (the card tests' 1e-5 checks, which no bf16 or TF32 product
//   meets; no serving path runs it): simt_prefill_kernel, the first port's
//   kernel.  One CTA per (sequence, kv head, 16 rows) walks 32-key tiles
//   prefetched into registers one tile ahead; the q.k products and the
//   weighted values are f32 FMAs on the CUDA cores.  Head dims are
//   multiples of 4 up to 256, in two instantiations (up to 128 and up to
//   256 columns of accumulators and loads per thread).
//
// The kernels allocate nothing and do not synchronise; the caller passes
// the stream and the scratch and checks the returned cudaGetLastError().

#include <math.h>

#include "common.cuh"
#include "split_merge.cuh"
#include "tensor_core.cuh"

namespace {

using namespace repro_kernels;  // common.cuh, split_merge.cuh, tensor_core.cuh

struct Params {
  const void* q;             // [B, KV, G, C, D] by strides, D contiguous
  const void* k_pages;       // [KV, N, page, D] contiguous
  const void* v_pages;
  const int* block_tables;   // [B, P]
  const int* prefix_len;     // [B]
  const void* k_chunk;       // [B, KV, C, D] by strides, D contiguous
  const void* v_chunk;
  void* out;                 // [B, KV, G, C, D] contiguous
  float* part;               // bfloat16: split partials (split_merge.cuh, R = G * C)
  long long q_sb, q_skv, q_sg, q_sc;
  long long e_sb, e_skv, e_st;
  int B, KV, G, C, D, N, page, P, n_pre, n_split;
  float sm_scale, softcap;
  int window;
};

constexpr int kMaxD = 256;

// ----------------------------------------------------------------- float32

constexpr int kThreads = 256;
constexpr int kRowTile = 16;  // query rows per CTA
constexpr int kKeyTile = 32;  // keys per shared-memory tile
constexpr int kLanesPerRow = kThreads / kRowTile;  // softmax lanes per row

// DM: the widest head dim of the instantiation (128 or 256)
template <int DM>
__global__ void __launch_bounds__(kThreads) simt_prefill_kernel(Params p) {
  constexpr int kAccPerThread = kRowTile * DM / kThreads;   // output rows per thread
  constexpr int kVec = 4;                                    // floats per 16-byte load
  constexpr int kLoads = kKeyTile * (DM / kVec) / kThreads;  // max loads per thread per side
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
  const int r0 = blockIdx.y * kRowTile;  // rows r = g * C + c
  const int nr = min(kRowTile, R - r0);
  const int plen = p.prefix_len[b];
  const int n_prefix = max(0, min(plen, p.P * p.page));
  const int nvec = D / kVec;

  const float* q = static_cast<const float*>(p.q);
  for (int i = tid; i < nr * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int r = r0 + rr;
    const int g = r / p.C, c = r % p.C;
    qs[rr * ld + d] = q[b * p.q_sb + kv * p.q_skv + g * p.q_sg + c * p.q_sc + d];
  }
  int qmin = 0x7fffffff;
  for (int rr = 0; rr < nr; ++rr) qmin = min(qmin, plen + (r0 + rr) % p.C);
  if (tid < kRowTile) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    qpos_s[tid] = plen + (r0 + tid) % p.C;
  }
  // output layout: each thread owns one column of a power-of-two padded
  // width Dp >= D and the rows row0, row0 + rstride, ...
  const int Dp = D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
  const int col = tid % Dp;
  const int row0 = tid / Dp;
  const int rstride = kThreads / Dp;
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  // Tiles: prefix keys [kstart, n_prefix) first — keys before the window of
  // every row in this CTA can never be attended and are not loaded — then
  // the chunk's own keys.
  const int kstart = p.window > 0 ? min(n_prefix, max(0, qmin - p.window + 1)) : 0;
  const int n_pre_tiles = (n_prefix - kstart + kKeyTile - 1) / kKeyTile;
  const int n_tiles = n_pre_tiles + (p.C + kKeyTile - 1) / kKeyTile;
  const float* kp_base = static_cast<const float*>(p.k_pages);
  const float* vp_base = static_cast<const float*>(p.v_pages);
  const float* kc = static_cast<const float*>(p.k_chunk);
  const float* vc = static_cast<const float*>(p.v_chunk);

  // rows of key j of tile t and its position, or null and -1 when there is
  // no key there
  auto key_row = [&](int t, int j, const float** kr, const float** vr, int* pos) {
    *kr = nullptr;
    *vr = nullptr;
    *pos = -1;
    if (t < n_pre_tiles) {
      const int kidx = kstart + t * kKeyTile + j;
      if (kidx >= n_prefix) return;
      const int pid = p.block_tables[b * p.P + kidx / p.page];
      if (pid < 0 || pid >= p.N) return;
      const long long row = ((long long)kv * p.N + pid) * p.page + kidx % p.page;
      *kr = kp_base + row * D;
      *vr = vp_base + row * D;
      *pos = kidx;
    } else {
      const int te = (t - n_pre_tiles) * kKeyTile + j;
      if (te >= p.C) return;
      const long long off = b * p.e_sb + kv * p.e_skv + (long long)te * p.e_st;
      *kr = kc + off;
      *vr = vc + off;
      *pos = plen + te;
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
        const float* kr;
        const float* vr;
        int pos;
        key_row(t, v / nvec, &kr, &vr, &pos);
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
        unpack16<float>(ks + j * ld + dv * kVec, kreg[i]);
        unpack16<float>(vs + j * ld + dv * kVec, vreg[i]);
      }
    }
    if (tid < kKeyTile) {
      const float* kr;
      const float* vr;
      int pos;
      key_row(t, tid, &kr, &vr, &pos);
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
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int rr = row0 + i * rstride;
    if (rr < nr && col < D) {
      const float l = fmaxf(l_s[rr], 1e-30f);
      out[((long long)bkv * R + r0 + rr) * D + col] = acc[i] / l;
    }
  }
}

size_t simt_smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) * (size_t)(kRowTile * ld + 2 * kKeyTile * ld + kRowTile * kKeyTile +
                                  3 * kRowTile) +
         sizeof(int) * (size_t)(kKeyTile + kRowTile);
}

// ---------------------------------------------------------------- bfloat16

constexpr int kTcWarps = 4;                   // warps per warpgroup, 16 rows each
constexpr int kTcRows = 16 * kTcWarps;        // stacked (chunk position, head) rows per CTA
constexpr int kGroupThreads = 32 * kTcWarps;  // one warpgroup
constexpr int kTcGroups = 2;                  // warpgroups, alternate key tiles
constexpr int kTcThreads = kTcGroups * kGroupThreads;
constexpr int kTcKeys = 64;                   // keys per K/V tile
constexpr int kSplitKeys = 128;               // prefix keys per split: 1 tile per warpgroup
constexpr int kMaxSplitPages = kSplitKeys;    // page ids one split can touch (page >= 1)
constexpr int kMergeParts = 1;                // threads per output element in the merge
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kMaxSplitPages <= kTcThreads, "one thread reads each page id of a split");

using bf16 = __nv_bfloat16;

template <int DP>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (size_t)(kTcRows + 2 * kTcGroups * TcShape<DP>::kStages * kTcKeys) * DP;
}

template <int DP, bool kSoftcap>
__global__ void __launch_bounds__(kTcThreads) tc_prefill_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __shared__ int pid_s[kMaxSplitPages];  // page ids of the split's pages, from base / page
  constexpr int kStages = TcShape<DP>::kStages;
  constexpr bool kQRegs = TcShape<DP>::kQRegs;
  constexpr int kVChunk = TcShape<DP>::kVChunk;
  constexpr int kChunks = DP / 8;
  constexpr int kKSteps = DP / 16;      // k-steps of QK^T
  constexpr int kDBlocks = DP / 8;      // 8-column blocks of the output
  constexpr int kNB = kTcKeys / 8;      // 8-key blocks of the scores
  constexpr int kTile = kTcKeys * DP;   // elements of one K or V stage
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [kTcRows][DP]
  bf16* kv_smem = qs + kTcRows * DP;             // K then V: [kTcGroups][kStages][kTcKeys][DP]

  const int bkv = blockIdx.x, b = bkv / p.KV, kv = bkv % p.KV;
  const int s0 = blockIdx.y * kTcRows;  // stacked rows s = c * G + g
  const int split = blockIdx.z;
  const int G = p.G, C = p.C, R = G * C;
  const int nch = p.D / 8;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & (kTcWarps - 1);
  const int grp = threadIdx.x / kGroupThreads, gtid = threadIdx.x % kGroupThreads;
  bf16* ks = kv_smem + grp * kStages * kTile;
  bf16* vs = kv_smem + (kTcGroups + grp) * kStages * kTile;

  // the split's page ids are read while prefix_len is in flight (one round
  // of table reads, independent of it); thread j holds page base / page + j
  const bool prefix = split < p.n_pre;
  const int base = prefix ? split * kSplitKeys : 0;
  const int pgb = base / p.page;
  int pid = -1;
  if (prefix && threadIdx.x < min(p.P, (base + kSplitKeys - 1) / p.page + 1) - pgb)
    pid = p.block_tables[(long long)b * p.P + pgb + threadIdx.x];
  const int plen = p.prefix_len[b];
  const int n_prefix = max(0, min(plen, p.P * p.page));
  const int qlo = plen + s0 / G, qhi = plen + (min(s0 + kTcRows, R) - 1) / G;
  // keys of this split that some row of the CTA can attend: [lo, hi), as
  // prefix key indices or chunk offsets; key k sits at position kpos0 + k
  const int kpos0 = prefix ? 0 : plen;
  const int hi = prefix ? min(base + kSplitKeys, n_prefix) : qhi - plen + 1;
  const int lo = p.window > 0 ? max(base, qlo - p.window + 1 - kpos0) : base;

  const long long prow = ((long long)bkv * p.n_split + split) * R;  // (bkv, split, row 0)
  const long long total = (long long)p.B * p.KV * p.n_split * R;
  float* m_out = p.part + prow;
  float* l_out = p.part + total + prow;
  float* acc_out = p.part + 2 * total + prow * p.D;
  if (lo >= hi) {  // an empty partial for every row of the CTA
    for (int s = s0 + threadIdx.x; s < min(s0 + kTcRows, R); s += kTcThreads) {
      const int r = (s % G) * C + s / G;
      m_out[r] = -INFINITY;
      l_out[r] = 0.f;
    }
    return;
  }

  // Q's copies (commit group 0, with the first K/V tile), then the page ids
  // into shared memory; an invalid id on a page of [lo, hi) makes every tile
  // of the CTA an edge tile
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + kv * p.q_skv;
#pragma unroll
  for (int i = threadIdx.x; i < kTcRows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int s = s0 + r;
    const bool ok = s < R && c < nch;
    const bf16* src = ok ? qb + (s % G) * p.q_sg + (long long)(s / G) * p.q_sc + c * 8 : qb;
    cp_async16(smem_u32(qs + swz<DP>(r, c)), src, ok);
  }
  bool hole = false;
  if (prefix) {
    const int pg = pgb + threadIdx.x;
    if (pg >= lo / p.page && pg <= (hi - 1) / p.page) {
      pid_s[threadIdx.x] = pid;
      hole = pid < 0 || pid >= p.N;
    }
  }
  hole = __syncthreads_or(hole);  // pid_s is visible

  // warpgroup grp takes the tiles grp, grp + 2, ... of [lo, hi), aligned to base
  const int t_first = (lo - base) / kTcKeys;
  const int n_tiles = (hi - 1 - base) / kTcKeys - t_first + 1;
  const int my_tiles = n_tiles > grp ? (n_tiles - grp + kTcGroups - 1) / kTcGroups : 0;
  auto tile_k0 = [&](int u) { return base + (t_first + grp + kTcGroups * u) * kTcKeys; };
  const bf16* kb = static_cast<const bf16*>(prefix ? p.k_pages : p.k_chunk);
  const bf16* vb = static_cast<const bf16*>(prefix ? p.v_pages : p.v_chunk);
  if (!prefix) {
    kb += b * p.e_sb + kv * p.e_skv;
    vb += b * p.e_sb + kv * p.e_skv;
  }
  // keys [k0, k0 + kTcKeys) -> stage st of this warpgroup's ring; a key
  // outside [lo, hi) or on an invalid page, and columns past D, are zeros
  auto load_tile = [&](int st, int k0) {
#pragma unroll
    for (int i = gtid; i < kTcKeys * kChunks; i += kGroupThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int key = k0 + r;
      bool ok = key >= lo && key < hi && c < nch;
      long long off = 0;  // element offset of the key's row
      if (ok && prefix) {
        const int pid = pid_s[key / p.page - pgb];
        ok = pid >= 0 && pid < p.N;
        off = (((long long)kv * p.N + pid) * p.page + key % p.page) * p.D;
      } else if (ok) {
        off = (long long)key * p.e_st;
      }
      const int dst = swz<DP>(r, c);
      cp_async16(smem_u32(ks + st * kTile + dst), ok ? kb + off + c * 8 : kb, ok);
      cp_async16(smem_u32(vs + st * kTile + dst), ok ? vb + off + c * 8 : vb, ok);
    }
  };

  // this lane's two rows of the warp's 16: ra (accumulator slots 0, 1), rb (2, 3)
  const int ra = s0 + 16 * warp + (lane >> 2), rb = ra + 8;
  const int qpa = plen + ra / G, qpb = plen + rb / G;
  const float sa = kSoftcap ? p.sm_scale / p.softcap : p.sm_scale * kLog2e;
  const float sb = p.softcap * kLog2e;

  float acc[kDBlocks][4];
#pragma unroll
  for (int n = 0; n < kDBlocks; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // m in log2 units
  uint32_t qf[kQRegs ? kKSteps : 1][4];

  // commit group u holds this thread's copies of its warpgroup's tile u
  // (group 0 also its share of Q); one group is committed per tile, empty
  // or not
  for (int u = 0; u < kStages; ++u) {
    if (u < my_tiles) load_tile(u, tile_k0(u));
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();  // Q and each warpgroup's first tile are in shared memory
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      ldsm_x4(smem_u32(qs + swz<DP>(16 * warp + (lane & 15), 2 * kk + (lane >> 4))), qf[kk][0],
              qf[kk][1], qf[kk][2], qf[kk][3]);
  }

  // the A fragment of k-step kk: from registers, or re-read from shared memory
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    if constexpr (kQRegs) {
      a[0] = qf[kk][0];
      a[1] = qf[kk][1];
      a[2] = qf[kk][2];
      a[3] = qf[kk][3];
    } else {
      ldsm_x4(smem_u32(qs + swz<DP>(16 * warp + (lane & 15), 2 * kk + (lane >> 4))), a[0], a[1],
              a[2], a[3]);
    }
  };

  for (int u = 0; u < my_tiles; ++u) {
    const int k0 = tile_k0(u);
    const int st = u % kStages;
    if (u > 0) {
      cp_async_wait<kStages - 1>();
      group_sync<kGroupThreads>(grp);
    }
    const bf16* kt = ks + st * kTile;
    const bf16* vt = vs + st * kTile;

    // S = Q K^T over this tile's 64 keys: per k-step, the K fragments of all
    // 8 key blocks are loaded first, then 8 independent mma chains run
    float sc[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t qa[4], kf[kNB / 2][4];
      q_frag(kk, qa);
#pragma unroll
      for (int jp = 0; jp < kNB / 2; ++jp) {
        const int key = 16 * jp + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(smem_u32(kt + swz<DP>(key, 2 * kk + ((lane >> 3) & 1))), kf[jp][0], kf[jp][1],
                kf[jp][2], kf[jp][3]);
      }
#pragma unroll
      for (int jp = 0; jp < kNB / 2; ++jp) {
        mma_bf16(sc[2 * jp], qa, kf[jp][0], kf[jp][1]);
        mma_bf16(sc[2 * jp + 1], qa, kf[jp][2], kf[jp][3]);
      }
    }

    // scale and soft-cap into log2 units, then mask (edge tiles only: the
    // ragged end of the split, the window's first tiles, the chunk's causal
    // tile, or a split with an invalid page); both choices are made outside
    // the element loop
    const int kp0 = kpos0 + k0;
    const bool edge = hole || k0 < lo || k0 + kTcKeys > hi || kp0 + kTcKeys - 1 > qlo ||
                      (p.window > 0 && qhi - kp0 >= p.window);
    float mx_a = -INFINITY, mx_b = -INFINITY;
    if (edge) {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          const int qp = e < 2 ? qpa : qpb;
          const int kp = kpos0 + key;
          bool valid = key >= lo && key < hi && kp <= qp;
          if (p.window > 0) valid = valid && qp - kp < p.window;
          if (hole && valid) {
            const int pid = pid_s[key / p.page - pgb];
            valid = pid >= 0 && pid < p.N;
          }
          sc[j][e] = valid ? score_log2<kSoftcap>(sc[j][e], sa, sb) : -INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = score_log2<kSoftcap>(sc[j][e], sa, sb);
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[j][0], sc[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float corr_a = exp2f(m_a - base_a), corr_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      sc[j][0] = exp2f(sc[j][0] - base_a);
      sc[j][1] = exp2f(sc[j][1] - base_a);
      sc[j][2] = exp2f(sc[j][2] - base_b);
      sc[j][3] = exp2f(sc[j][3] - base_b);
      sum_a += sc[j][0] + sc[j][1];
      sum_b += sc[j][2] + sc[j][3];
    }
    l_a = l_a * corr_a + sum_a;  // this lane's columns; reduced at the end
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < kDBlocks; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // O += P V, P rounded to bf16 straight from the score accumulators; the
    // V fragments of a 16-key step are loaded kVChunk at a time before
    // their mma chains
#pragma unroll
    for (int kt16 = 0; kt16 < kTcKeys / 16; ++kt16) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kt16][0], sc[2 * kt16][1]);
      a[1] = pack_bf16(sc[2 * kt16][2], sc[2 * kt16][3]);
      a[2] = pack_bf16(sc[2 * kt16 + 1][0], sc[2 * kt16 + 1][1]);
      a[3] = pack_bf16(sc[2 * kt16 + 1][2], sc[2 * kt16 + 1][3]);
      const int key = 16 * kt16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int d0 = 0; d0 < kDBlocks / 2; d0 += kVChunk) {
        uint32_t vf[kVChunk][4];
#pragma unroll
        for (int dp = 0; dp < kVChunk; ++dp)
          ldsm_x4_t(smem_u32(vt + swz<DP>(key, 2 * (d0 + dp) + (lane >> 4))), vf[dp][0], vf[dp][1],
                    vf[dp][2], vf[dp][3]);
#pragma unroll
        for (int dp = 0; dp < kVChunk; ++dp) {
          mma_bf16(acc[2 * (d0 + dp)], a, vf[dp][0], vf[dp][1]);
          mma_bf16(acc[2 * (d0 + dp) + 1], a, vf[dp][2], vf[dp][3]);
        }
      }
    }
    group_sync<kGroupThreads>(grp);  // this stage is read: refill it with tile u + kStages
    if (u + kStages < my_tiles) load_tile(st, tile_k0(u + kStages));
    cp_async_commit();
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  // warpgroup 1 hands (m, l, acc) to warpgroup 0 through the K/V stages,
  // slot [register][thread] so the 32 lanes of a warp hit 32 banks
  constexpr int kRegs = 4 * kDBlocks + 4;
  static_assert(kRegs * kGroupThreads * sizeof(float) <= 2 * kTcGroups * kStages * kTile * sizeof(bf16),
                "the hand-over must fit in the K/V stages");
  float* red = reinterpret_cast<float*>(kv_smem);
  cp_async_wait<0>();
  __syncthreads();  // every stage is read
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < kDBlocks; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * n + e) * kGroupThreads + gtid] = acc[n][e];
    red[(kRegs - 4) * kGroupThreads + gtid] = m_a;
    red[(kRegs - 3) * kGroupThreads + gtid] = m_b;
    red[(kRegs - 2) * kGroupThreads + gtid] = l_a;
    red[(kRegs - 1) * kGroupThreads + gtid] = l_b;
  }
  __syncthreads();
  if (grp == 1) return;
  const float om_a = red[(kRegs - 4) * kGroupThreads + gtid];
  const float om_b = red[(kRegs - 3) * kGroupThreads + gtid];
  const float mn_a = fmaxf(m_a, om_a), mn_b = fmaxf(m_b, om_b);
  const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
  const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
  const float c0a = exp2f(m_a - base_a), c1a = exp2f(om_a - base_a);
  const float c0b = exp2f(m_b - base_b), c1b = exp2f(om_b - base_b);
  l_a = l_a * c0a + red[(kRegs - 2) * kGroupThreads + gtid] * c1a;
  l_b = l_b * c0b + red[(kRegs - 1) * kGroupThreads + gtid] * c1b;
#pragma unroll
  for (int n = 0; n < kDBlocks; ++n) {
    acc[n][0] = acc[n][0] * c0a + red[(4 * n + 0) * kGroupThreads + gtid] * c1a;
    acc[n][1] = acc[n][1] * c0a + red[(4 * n + 1) * kGroupThreads + gtid] * c1a;
    acc[n][2] = acc[n][2] * c0b + red[(4 * n + 2) * kGroupThreads + gtid] * c1b;
    acc[n][3] = acc[n][3] * c0b + red[(4 * n + 3) * kGroupThreads + gtid] * c1b;
  }

  // the split's partial of rows ra and rb, at output rows g * C + c; m in
  // natural-log units for the merge
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = half ? rb : ra;
    if (s >= R) continue;
    const int r = (s % G) * C + s / G;
    float* arow = acc_out + (long long)r * p.D;
#pragma unroll
    for (int n = 0; n < kDBlocks; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < p.D) *reinterpret_cast<float2*>(arow + d) = make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
    if ((lane & 3) == 0) {
      m_out[r] = (half ? mn_b : mn_a) * kLn2;
      l_out[r] = half ? l_b : l_a;
    }
  }
}

template <int DP, bool kSoftcap>
struct TcTag {};

template <int DM>
struct SimtTag {};

template <int DM>
int launch_f32(const Params& p, cudaStream_t s) {
  // past D = 144 the tiles need more than 48 KB (84,672 bytes at 256)
  cudaError_t err = allow_smem<SimtTag<DM>>((const void*)simt_prefill_kernel<DM>,
                                            simt_smem_bytes(DM));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.KV, (p.G * p.C + kRowTile - 1) / kRowTile);
  simt_prefill_kernel<DM><<<grid, kThreads, simt_smem_bytes(p.D), s>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, bool kSoftcap>
int launch_tc(const Params& p, cudaStream_t s) {
  constexpr size_t smem = tc_smem_bytes<DP>();
  cudaError_t err =
      allow_smem<TcTag<DP, kSoftcap>>((const void*)tc_prefill_kernel<DP, kSoftcap>, smem);
  if (err != cudaSuccess) return (int)err;
  const int R = p.G * p.C;
  const dim3 grid(p.B * p.KV, (R + kTcRows - 1) / kTcRows, p.n_split);
  tc_prefill_kernel<DP, kSoftcap><<<grid, kTcThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_split_merge<bf16>(
      SplitMerge{p.part, p.out, p.B * p.KV, R, p.D, p.n_pre, p.n_split, kMergeParts, 0}, s);
}

template <int DP>
int launch_tc(const Params& p, cudaStream_t s) {
  return p.softcap > 0.f ? launch_tc<DP, true>(p, s) : launch_tc<DP, false>(p, s);
}

int launch_bf16(const Params& p, cudaStream_t s) {
  if (p.D % 8) return (int)cudaErrorInvalidValue;
  if (p.D <= 16) return launch_tc<16>(p, s);
  if (p.D <= 32) return launch_tc<32>(p, s);
  if (p.D <= 64) return launch_tc<64>(p, s);
  if (p.D <= 128) return launch_tc<128>(p, s);
  if (p.D <= 160) return launch_tc<160>(p, s);
  return launch_tc<256>(p, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (SIMT kernel, D a multiple of 4; part, split_keys,
// n_pre and n_split are not used), 1 = bfloat16 (tensor-core split kernel
// and merge; D a multiple of 8); D <= 256.  For bfloat16, split_keys must equal the kernel's split size (128), n_pre =
// ceil(P * page / split_keys), n_split = n_pre + 1 (the chunk), and part
// holds B * KV * n_split * G * C * (D + 2) floats).  sm_scale multiplies
// every score: 1 / sqrt(d) of the head dim d before the caller zero-padded
// it to D.  Strides are in elements.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for shapes the kernels do not take).
int paged_attention_forward(int dtype, const void* q, const void* k_pages, const void* v_pages,
                            const int* block_tables, const int* prefix_len, const void* k_chunk,
                            const void* v_chunk, void* out, float* part, long long q_sb,
                            long long q_skv, long long q_sg, long long q_sc, long long e_sb,
                            long long e_skv, long long e_st, int B, int KV, int G, int C, int D,
                            int N, int page, int P, int split_keys, int n_pre, int n_split,
                            float sm_scale, float softcap, int window, void* stream) {
  if (D <= 0 || D > kMaxD || D % (dtype == 0 ? 4 : 8) || B <= 0 || KV <= 0 || G <= 0 || C <= 0 ||
      page <= 0 || P < 0 || (G * C + kRowTile - 1) / kRowTile > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
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
  p.n_pre = n_pre;
  p.n_split = n_split;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return D <= 128 ? launch_f32<128>(p, s) : launch_f32<256>(p, s);
  if (dtype != 1 || part == nullptr || split_keys != kSplitKeys ||
      (long long)n_pre != ((long long)P * page + kSplitKeys - 1) / kSplitKeys ||
      n_split != n_pre + 1 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_bf16(p, s);
}

}  // extern "C"
