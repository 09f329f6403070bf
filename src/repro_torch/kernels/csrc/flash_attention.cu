// Flash attention (prefill) for Hopper (sm_90a).
//
// Replaces kernels/flash_attention.py:flash_attention_pallas: tiled forward
// attention with GQA (query head h reads kv head h / (H / KV); KV is never
// repeated in memory), causal alignment with a query offset (q_pos =
// q_offset + row, k_pos = col, also when Sq != Sk; q_offset = 0 is the
// Pallas kernel's top-left alignment, and a rank of a sequence-sharded
// prefill passes the position its query slice starts at), a sliding window
// (q_pos - k_pos < window), tanh
// soft-capping applied before the mask, and masking of the ragged key edge
// (k_pos < Sk).  The softmax statistics and the accumulator are f32, and the
// output is acc / max(l, 1e-30) cast to q's type.  Operands are addressed by
// strides (the head dimension contiguous), so the model hands over
// [B, S, H, D] activations as [B, H, S, D] views without a copy, and the
// output is written through strides too.
//
// Three kernels, chosen by dtype and head dim (not a fallback: each takes
// only its inputs):
//
// * bfloat16 up to D = 256, the serving dtype: tc_flash_kernel, on the
//   tensor cores.  What bounds it: at the serving shape (S = 512, D = 128,
//   16 query heads over 8 kv heads, causal) the call does 4 * S^2 / 2 * D
//   FLOPs per query head and moves q, k, v and the output once, about 170
//   FLOPs per byte, under the H100's bf16 ridge (~295): bytes bound it.
//   Design: the key order and the body of the paged kernels
//   (attention_split.cuh), so a prefill row gets the bits a decode step or
//   a prefill chunk gives the same query over the same keys.  One CTA of
//   two warpgroups per (64 stacked rows, kv head, sequence); the stacked
//   rows are the (query, head) pairs of the kv head's G query heads,
//   query-major (row s = q * G + g), so one K/V tile serves every query
//   head of its group and is loaded once.  The CTA walks the position
//   splits [64 j, 64 j + 64) that any of its rows can attend, the two
//   warpgroups on alternate splits, each through its own ring of cp.async
//   stages (2 up to DP = 160, 1 at 256), zero-filled past Sk; each warp
//   runs split_partial (tensor_core.cuh: QK^T and P V on
//   mma.sync.m16n8k16, P split into two bf16 terms, about 16 of its bits,
//   as the reference keeps P in f32) on its 16 rows, and a round's two
//   partials are folded into the rows' running (M, L, O) in split order
//   with split_merge.cuh's fold, warpgroup 0's first; (M, L, O) live in
//   shared memory, one slot per thread of a warpgroup.  The one-warpgroup
//   version of this design read 0.0357 ms at the serving shape, this one
//   0.0282 (the earlier alternate-tile kernel, which rounded P to bf16 and
//   merged its warpgroups' online softmaxes at the end, 0.0161; SDPA
//   0.0113; NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phase 2).  The q tiles of a causal call are scheduled
//   heaviest first, and splits wholly outside the causal/window range of
//   every row of the CTA are never loaded.  D is any multiple of 8 up to
//   256; the tiles are padded with zeros to 16, 32, 64, 128, 160 or 256
//   columns as in every bf16 attention kernel here, and zero columns add
//   nothing to a score and are never written.  Left for later: wgmma with
//   TMA tile loads and warp specialisation.
//
// * float32 up to D = 256 (the card tests' 1e-5 checks, which no bf16 or
//   TF32 tensor-core product meets): flash_attention_kernel, the SIMT
//   kernel of the first port.  One CTA per (64-row query tile, query head,
//   sequence) walks 64-key tiles with the online-softmax state in
//   registers; 256 threads form a 16 x 16 grid; thread (ty, tx) owns query
//   rows ty + 16 i (i < 4), for the scores keys tx + 16 j (j < 4) of the
//   tile, and for the output columns tx + 16 c (c < 8, or 16 in the
//   instantiation for D above 128) of its rows.  Q, K and V tiles live in
//   shared memory as f32 with an odd row stride (D + 1; 209 KiB at D =
//   256); both products are f32 FMAs.
//
// * head dims past 256, both types, any width: the split-KV SIMT kernel of
//   attention_split.cuh over the same position splits (FlashFront), the
//   head dim walked in slices of 512 columns, then split_merge.cuh writing
//   through the output's strides.  Its partials take B * H * Sq *
//   ceil(Sk / 64) * (D + 2) floats of scratch from the wrapper; no
//   catalogue model has such a head.
//
// A query row with no valid key at all (only possible with Sq > Sk under a
// causal window, or Sk = 0; the model never builds one) gets what the dense
// reference's uniform softmax over its masked scores gives it: the plain
// mean of the Sk value rows of its kv head (zeros when Sk = 0).  Every
// kernel finds such a row by its running sum l, still 0 after the last key
// tile (the wide route's merge by its folded L), and only such a row takes
// the branch that reads the Sk value rows (mean_value), so serving rows
// pay one comparison.  The Pallas kernel
// spreads the weights over the keys of its key blocks, zero padding
// included, so its value depends on the block size.
//
// Head dims that are not a multiple of the vector width (bfloat16 D % 8,
// float32 D % 4) reach the kernels zero-padded to the next multiple by the
// wrapper, which passes the scale 1 / sqrt(D) of the unpadded D (sm_scale):
// zero columns add nothing to a score, and the padded output columns are
// sliced away.
//
// The kernels allocate nothing and do not synchronise; the caller passes
// the stream and checks the returned cudaGetLastError().

#include <math.h>

#include "attention_split.cuh"

namespace {

using namespace repro_kernels;  // common.cuh, split_merge.cuh, tensor_core.cuh, attention_split.cuh

constexpr int kThreads = 256;
constexpr int kSide = 16;              // the 16 x 16 thread grid
constexpr int kTile = 64;              // query rows per CTA and keys per tile
constexpr int kMaxD = 256;             // the tile kernels' widest head dim

struct Params {
  const void* q;  // [B, H, Sq, D] by strides, D contiguous
  const void* k;  // [B, KV, Sk, D] by strides
  const void* v;
  void* out;      // [B, H, Sq, D] by strides
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, KV, Sq, Sk, D;
  int causal, window;
  int q_offset;  // position of query row 0; key j sits at position j
  float sm_scale, softcap;
  float* part;   // past D = 256: split partials (split_merge.cuh, R = G * Sq)
  int n_split, BKV;
};

// Rows [row0, row0 + TILE) of one head -> f32 shared memory with row
// stride ld, by 16-byte vector loads; rows at or past n_rows are zeros.
template <typename T, int TILE>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base, long long stride,
                                          int row0, int n_rows, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = D / kVec;
  for (int i = threadIdx.x; i < TILE * nvec; i += kThreads) {
    const int r = i / nvec, dv = i % nvec;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      u = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * stride + dv * kVec);
    const T* e = reinterpret_cast<const T*>(&u);
    float* d = dst + r * ld + dv * kVec;
#pragma unroll
    for (int t = 0; t < kVec; ++t) d[t] = to_f<T>(e[t]);
  }
}

// DM: the widest head dim of the instantiation (128 or 256); TILE: query
// rows per CTA and keys per tile (64)
template <typename T, int DM, int TILE>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Params p) {
  constexpr int kCols = DM / kSide;   // output columns per thread
  constexpr int kRows = TILE / kSide;  // query rows per thread
  constexpr int kKeys = TILE / kSide;  // keys per thread in the score tile
  constexpr int kPs = TILE + 1;        // row stride of the weight tile
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* qs = smem;             // [TILE][ld]
  float* ks = qs + TILE * ld;   // [TILE][ld]
  float* vs = ks + TILE * ld;   // [TILE][ld]
  float* ps = vs + TILE * ld;   // [TILE][kPs] unnormalised weights

  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile<T, TILE>(qs, ld, qb, p.q_ss, q0, p.Sq, D);

  // keys any row of this CTA can attend: [kbeg, kend) (row r at position
  // q_offset + r)
  const int pos0 = p.q_offset + q0;
  int kend = p.Sk;
  if (p.causal) kend = min(kend, pos0 + TILE);
  const int kbeg = p.window > 0 ? max(0, pos0 - p.window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done; qs is visible
    load_tile<T, TILE>(ks, ld, kb, p.k_ss, k0, kend, D);
    load_tile<T, TILE>(vs, ld, vb, p.v_ss, k0, kend, D);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kSide * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(tx + kSide * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = pos0 + ty + kSide * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kp = k0 + tx + kSide * j;
        bool valid = kp < p.Sk;
        if (p.causal) valid = valid && kp <= qp;
        if (p.window > 0) valid = valid && qp - kp < p.window;
        float x = s[i][j] * p.sm_scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        s[i][j] = valid ? x : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int o = kSide / 2; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float corr = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float e = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        ps[(ty + kSide * i) * kPs + tx + kSide * j] = e;
        sum += e;
      }
      l[i] = l[i] * corr + sum;  // this thread's keys only; reduced at the end
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // weighted values: one load of a value row segment feeds every row
#pragma unroll 2
    for (int j = 0; j < TILE; ++j) {
      float pr[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = ps[(ty + kSide * i) * kPs + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + kSide * c;
        vv[c] = col < D ? vs[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pr[i], vv[c], acc[i][c]);
    }
  }

  T* ob = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float li = l[i];
#pragma unroll
    for (int o = kSide / 2; o > 0; o >>= 1) li += __shfl_xor_sync(0xffffffffu, li, o);
    const int qr = q0 + ty + kSide * i;  // the row (its position is q_offset + qr)
    const float inv = 1.f / fmaxf(li, 1e-30f);
    if (qr >= p.Sq) continue;
    if (li == 0.f) {  // no valid key: the plain mean of the Sk value rows
      for (int col = tx; col < D; col += kSide)
        ob[(long long)qr * p.o_ss + col] = from_f<T>(mean_value(vb, p.v_ss, p.Sk, col));
      continue;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + kSide * c;
      if (col < D) ob[(long long)qr * p.o_ss + col] = from_f<T>(acc[i][c] * inv);
    }
  }
}

size_t smem_bytes(int D, int tile) {
  return sizeof(float) * (size_t)(3 * tile * (D + 1) + tile * (tile + 1));
}

// ---------------------------------------------------------------- bfloat16

constexpr int kTcWarps = 4;                   // warps per warpgroup, 16 rows each
constexpr int kTcRows = 16 * kTcWarps;        // stacked (query, head) rows per CTA
constexpr int kGroupThreads = 32 * kTcWarps;  // one warpgroup
constexpr int kTcGroups = 2;                  // warpgroups, alternate splits
constexpr int kTcThreads = kTcGroups * kGroupThreads;

using bf16 = __nv_bfloat16;

template <int DP>
struct FlashShape {
  static constexpr int kStages = DP <= 160 ? 2 : 1;  // K/V splits in flight per warpgroup
  static constexpr int kState = DP / 2 + 4;          // per thread slot: O, then M_a, M_b, L_a, L_b
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)(kTcRows + kTcGroups * 2 * kStages * kSplitKeys) * DP  // Q, K, V
      + sizeof(float) * (size_t)kState * kGroupThreads;                           // (M, L, O)
};

// One CTA of two warpgroups per (64 stacked rows, kv head, sequence).  The
// stacked rows are the (query, head) pairs of the kv head's G query heads,
// query-major (row s = q * G + g), so one K/V tile serves every query head
// of its group and is loaded once.  The CTA walks the position splits
// [64 j, 64 j + 64) that any of its rows can attend; both warpgroups hold
// the same 64 rows (16 per warp) and take alternate splits, each through
// its own ring of cp.async stages, and each warp runs the shared body
// (split_partial) on its 16 rows.  The running (M, L, O) of a row lives in
// shared memory, one slot per thread of a warpgroup, the same slot for the
// two threads (one per warpgroup) that hold the same fragment; a round of
// two splits is folded in ascending order, warpgroup 0's split, a barrier,
// then warpgroup 1's (split_merge.cuh's fold), so a row gets the bits the
// split-KV kernels and their merge give it while the two warpgroups'
// products run side by side.
template <int DP, bool kSoftcap>
__global__ void __launch_bounds__(kTcThreads) tc_flash_kernel(Params p) {
  using S = FlashShape<DP>;
  constexpr int kStages = S::kStages, kChunks = DP / 8, kDBlocks = DP / 8, kH = DP / 2;
  constexpr int kTile = kSplitKeys * DP;  // elements of one K or V stage
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [kTcRows][DP]
  bf16* kv_smem = qs + kTcRows * DP;             // [group][stage][K, V][64][DP]
  float* st_s = reinterpret_cast<float*>(kv_smem + kTcGroups * 2 * kStages * kTile);
  __shared__ int kpos_s[kTcGroups][kStages][kSplitKeys];

  const int G = p.H / p.KV;
  const int nrows = G * p.Sq;
  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int s0 = tile * kTcRows;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nch = p.D / 8;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & (kTcWarps - 1);
  const int grp = threadIdx.x / kGroupThreads, gtid = threadIdx.x % kGroupThreads;
  bf16* ring = kv_smem + grp * 2 * kStages * kTile;

  // splits any row of this CTA can attend (row q at position q_offset + q);
  // warpgroup grp takes j0 + grp, j0 + grp + 2, ...
  const int qlo = p.q_offset + s0 / G;
  const int qhi = p.q_offset + (min(s0 + kTcRows, nrows) - 1) / G;
  int kend = p.Sk;
  if (p.causal) kend = min(kend, qhi + 1);
  const int kbeg = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
  const int j0 = kbeg / kSplitKeys;
  const int n_splits = kend > kbeg ? (kend - 1) / kSplitKeys - j0 + 1 : 0;
  const int n_rounds = (n_splits + kTcGroups - 1) / kTcGroups;
  const int my_splits = n_splits > grp ? (n_splits - grp + kTcGroups - 1) / kTcGroups : 0;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // split j -> stage st of this warpgroup's ring (keys past Sk and columns
  // past D are zeros), by the warpgroup's threads
  auto load_split = [&](int st, int j) {
    bf16* kt = ring + 2 * st * kTile;
    bf16* vt = kt + kTile;
    for (int i = gtid; i < kSplitKeys * kChunks; i += kGroupThreads) {
      const int r = i / kChunks, c = i % kChunks, key = j * kSplitKeys + r;
      const bool ok = key < p.Sk && c < nch;
      cp_async16(smem_u32(kt + swz<DP>(r, c)), ok ? kb + (long long)key * p.k_ss + c * 8 : kb, ok);
      cp_async16(smem_u32(vt + swz<DP>(r, c)), ok ? vb + (long long)key * p.v_ss + c * 8 : vb, ok);
    }
    if (gtid < kSplitKeys) kpos_s[grp][st][gtid] = j * kSplitKeys + gtid;
  };

  // commit group u holds stage u's copies (group 0 also this thread's share
  // of Q); one group per round, empty or not
  for (int i = threadIdx.x; i < kTcRows * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks, srow = s0 + r;
    const bool ok = srow < nrows && c < nch;
    const bf16* src = qb;
    if (ok) src = qb + (kvh * G + srow % G) * p.q_sh + (long long)(srow / G) * p.q_ss + c * 8;
    cp_async16(smem_u32(qs + swz<DP>(r, c)), src, ok);
  }
  for (int u = 0; u < kStages; ++u) {
    if (u < my_splits) load_split(u, j0 + grp + kTcGroups * u);
    cp_async_commit();
  }

  const int ra = s0 + 16 * warp + (lane >> 2), rb = ra + 8;
  const bool live = s0 + 16 * warp < nrows;
  SplitMask mk;
  mk.qpa = p.q_offset + ra / G;
  mk.qpb = p.q_offset + rb / G;
  mk.causal = p.causal;
  mk.window = p.window;
  mk.uniform = false;
  const float sa = kSoftcap ? p.sm_scale / p.softcap : p.sm_scale * kLog2e;
  const float sb = p.softcap * kLog2e;
  float* slot = st_s + gtid;  // this thread's state: slot[e * kGroupThreads]
  if (grp == 0) {
#pragma unroll
    for (int e = 0; e < kH; ++e) slot[e * kGroupThreads] = 0.f;
    slot[kH * kGroupThreads] = slot[(kH + 1) * kGroupThreads] = -INFINITY;
    slot[(kH + 2) * kGroupThreads] = slot[(kH + 3) * kGroupThreads] = 0.f;
  }

  for (int u = 0; u < n_rounds; ++u) {
    const int j = j0 + grp + kTcGroups * u, st = u % kStages;
    const bool mine = live && u < my_splits;
    cp_async_wait<kStages - 1>();
    __syncthreads();  // this round's stages (and Q, and the state's first values) are visible
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f, acc[kDBlocks][4];
    if (mine) {
      const int nk = p.Sk - j * kSplitKeys;
      mk.kpos = kpos_s[grp][st];
      mk.present = nk >= kSplitKeys ? ~0ull : (1ull << nk) - 1ull;
      const bf16* kt = ring + 2 * st * kTile;
      split_partial<DP, kSoftcap>(qs + 16 * warp * DP, kt, kt + kTile, mk, sa, sb, m_a, m_b, l_a,
                                  l_b, acc);
    }
    // fold in split order: warpgroup 0's split, then warpgroup 1's
#pragma unroll
    for (int g = 0; g < kTcGroups; ++g) {
      __syncthreads();
      if (g != grp || !mine) continue;
      float M_a = slot[kH * kGroupThreads], M_b = slot[(kH + 1) * kGroupThreads];
      float L_a = slot[(kH + 2) * kGroupThreads], L_b = slot[(kH + 3) * kGroupThreads];
      float ca = 0.f, wa = 0.f, cb = 0.f, wb = 0.f;
      const bool fa = m_a != -INFINITY, fb = m_b != -INFINITY;  // an empty split is skipped
      if (fa) fold_stats(M_a, L_a, m_a, l_a, ca, wa);
      if (fb) fold_stats(M_b, L_b, m_b, l_b, cb, wb);
#pragma unroll
      for (int n = 0; n < kDBlocks; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!(e < 2 ? fa : fb)) continue;
          float& o = slot[(4 * n + e) * kGroupThreads];
          o = e < 2 ? fold_value(o, acc[n][e], ca, wa) : fold_value(o, acc[n][e], cb, wb);
        }
      }
      slot[kH * kGroupThreads] = M_a;
      slot[(kH + 1) * kGroupThreads] = M_b;
      slot[(kH + 2) * kGroupThreads] = L_a;
      slot[(kH + 3) * kGroupThreads] = L_b;
    }
    // this warpgroup's stage st is read: refill it with its split of round u + kStages
    if (u + kStages < my_splits) load_split(st, j0 + grp + kTcGroups * (u + kStages));
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the last fold is visible
  if (grp != 0 || !live) return;

  bf16* ob = static_cast<bf16*>(p.out) + b * p.o_sb;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= nrows) continue;
    const float L = slot[(kH + 2 + half) * kGroupThreads];
    bf16* orow = ob + (kvh * G + r % G) * p.o_sh + (long long)(r / G) * p.o_ss;
    if (L == 0.f) {  // no valid key: the plain mean of the Sk value rows
      for (int d = 2 * (lane & 3); d < p.D; d += 8)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            mean_value(vb, p.v_ss, p.Sk, d), mean_value(vb, p.v_ss, p.Sk, d + 1));
      continue;
    }
#pragma unroll
    for (int n = 0; n < kDBlocks; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      const float o0 = slot[(4 * n + 2 * half) * kGroupThreads];
      const float o1 = slot[(4 * n + 2 * half + 1) * kGroupThreads];
      if (d < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(fold_finish(o0, L), fold_finish(o1, L));
    }
  }
}

// ------------------------------------------------------------ wide (D > 256)

// The split-KV front end (attention_split.cuh) of head dims past 256, both
// dtypes: the same position splits over contiguous K/V, the SIMT body, and
// split_merge.cuh writing through the output's strides (a row with no valid
// key gets the mean of its Sk value rows there).
template <typename TT>
struct FlashFront {
  using T = TT;
  using Params = ::Params;
  const Params& p;
  Rows<T> rows;
  bool uniform = false, causal;
  int window, split;
  const T* kb;
  const T* vb;

  __device__ FlashFront(const Params& p_, int bkv, int split_) : p(p_), split(split_) {
    const int b = bkv / p.KV, kvh = bkv % p.KV, G = p.H / p.KV;
    rows = Rows<T>{static_cast<const T*>(p.q) + b * p.q_sb + (long long)kvh * G * p.q_sh, p.q_sh,
                   p.q_ss, G, p.Sq, p.q_offset};
    causal = p.causal != 0;
    window = p.window;
    kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
    vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  }

  __device__ bool key(int r, const T*& k, const T*& v, int& pos) const {
    pos = split * kSplitKeys + r;
    if (pos >= p.Sk) return false;
    k = kb + (long long)pos * p.k_ss;
    v = vb + (long long)pos * p.v_ss;
    return true;
  }
};

template <typename T>
int launch_wide(const Params& p, int B, cudaStream_t s) {
  using F = FlashFront<T>;
  const int G = p.H / p.KV;
  cudaError_t err = launch_simt_split<F>(p, G * p.Sq, s);
  if (err != cudaSuccess) return (int)err;
  const SplitMerge m{p.part, p.out, p.o_sb, p.o_sh, p.o_ss, B * p.KV, p.KV, G, p.Sq, p.D,
                     p.n_split, p.v, p.v_sb, p.v_sh, p.v_ss, p.Sk};
  return (int)launch_split_merge<T>(m, s);
}

template <int DP, bool kSoftcap>
struct TcTag {};

template <typename T, int DM>
struct SimtTag {};

// The SIMT tile kernel: float32 up to D = 256
template <int DM>
int launch_simt(const Params& p, int B, cudaStream_t s) {
  cudaError_t err = allow_smem<SimtTag<float, DM>>(
      (const void*)flash_attention_kernel<float, DM, kTile>, smem_bytes(DM, kTile));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kTile - 1) / kTile, p.H, B);
  flash_attention_kernel<float, DM, kTile><<<grid, kThreads, smem_bytes(p.D, kTile), s>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, bool kSoftcap>
cudaError_t launch_tc(const Params& p, int B, cudaStream_t s) {
  constexpr size_t smem = FlashShape<DP>::kSmem;
  cudaError_t err =
      allow_smem<TcTag<DP, kSoftcap>>((const void*)tc_flash_kernel<DP, kSoftcap>, smem);
  if (err != cudaSuccess) return err;
  const int rows = (p.H / p.KV) * p.Sq;
  dim3 grid((rows + kTcRows - 1) / kTcRows, p.KV, B);
  tc_flash_kernel<DP, kSoftcap><<<grid, kTcThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_tc(const Params& p, int B, cudaStream_t s) {
  return p.softcap > 0.f ? launch_tc<DP, true>(p, B, s) : launch_tc<DP, false>(p, B, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (D a multiple of 4), 1 = bfloat16 (D a multiple of
// 8); any D.  bfloat16 up to D = 256 runs the tensor-core kernel, float32
// up to 256 the SIMT tile kernel; past 256 both run the split-KV SIMT
// kernel and the merge, with n_split = ceil(Sk / 64) (at least 1) and part
// holding B * KV * n_split * H / KV * Sq * (D + 2) floats (otherwise part
// may be null).  sm_scale multiplies every score: 1 / sqrt(d) of the head
// dim d before the caller zero-padded it to D.  Query row i sits at
// position q_offset + i and key j at j, for the causal mask (j <= q_offset
// + i) and the window (q_offset + i - j < window).  Strides are in
// elements.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for shapes the kernels do not take).
int flash_attention_forward(int dtype, const void* q, const void* k, const void* v, void* out,
                            long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                            long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                            long long v_ss, long long o_sb, long long o_sh, long long o_ss, int B,
                            int H, int KV, int Sq, int Sk, int D, int causal, int window,
                            int q_offset, float sm_scale, float softcap, float* part, int n_split,
                            void* stream) {
  if (D <= 0 || D % (dtype == 0 ? 4 : 8) || B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      Sq <= 0 || Sk < 0 || q_offset < 0 || B > 65535 || H > 65535 ||
      (D > kMaxD && (part == nullptr || n_split < 1 || n_split > 65535 ||
                     (long long)n_split * kSplitKeys < Sk ||
                     ((long long)(H / KV) * Sq + kSimtRows - 1) / kSimtRows > 65535)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_ss = q_ss;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_ss = v_ss;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.part = part;
  p.n_split = n_split;
  p.BKV = B * KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (D > kMaxD) return dtype == 0 ? launch_wide<float>(p, B, s) : launch_wide<bf16>(p, B, s);
  if (dtype == 0) return D <= 128 ? launch_simt<128>(p, B, s) : launch_simt<kMaxD>(p, B, s);
#define REPRO_LAUNCH(DP) launch_tc<DP>(p, B, s)
  return (int)REPRO_TC_DISPATCH(D, REPRO_LAUNCH);
#undef REPRO_LAUNCH
}

}  // extern "C"
