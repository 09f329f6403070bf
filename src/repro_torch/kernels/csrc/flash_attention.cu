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
//   tensor cores (wgmma), fed by TMA.  What bounds it: at qwen3-1.7b's
//   dense prefill (S = 512, D = 128, 16 query heads over 8 kv heads,
//   causal) the call does 4 * S^2 / 2 * D FLOPs per query head and moves q,
//   k, v and the output once, about 170 FLOPs per byte, under the H100's
//   bf16 ridge (~295): bytes, and at 128 CTAs of a few splits each, the
//   latency of one split's chain of steps; at the sharded prefill's 4 x
//   2048 tokens the operations (68.7 GFLOP, 103 with P V doubled).
//   Design: the key order and the arithmetic of the paged kernels
//   (attention_split.cuh, tensor_core.cuh), so a prefill row gets the bits
//   a decode step or a prefill chunk gives the same query over the same
//   keys.  A CTA holds 64 or 128 stacked rows, the (query, head) pairs of
//   one kv head's G query heads, query-major (row s = q * G + g), so one
//   K/V tile serves every query head of its group and is loaded once.  A
//   producer warp TMA-loads the position splits [64 j, 64 j + 64) that any
//   of the CTA's rows can attend, in order, into a ring of mbarrier-guarded
//   K/V stages (zeros past Sk and past D from TMA's out-of-bounds fill);
//   each consumer warpgroup owns 64 rows, keeps their running (M, L, O) in
//   registers and runs, per split, S = Q K^T and the doubled P V on
//   wgmma (K5's products need equal bits with K1's and K2's mma.sync:
//   bench/wgmma_probe.py found a wgmma k16 step equal to an mma.sync one
//   on every input class, chip_smoke.py phase 2 checks it), the softmax of
//   split_softmax and split_merge.cuh's fold per split.  No shared-memory
//   fold, no barrier between the consumers.  Q is loaded once per CTA into
//   shared memory and read by wgmma from there.  One consumer warpgroup
//   per CTA while two-warpgroup CTAs would fill less than 3/4 of the SMs
//   (S = 512: 64 of them, so 128 CTAs of one), else two (the 4 x 2048
//   prefill: 0.3564 ms against 0.5301 with one).  The q tiles of a causal call
//   are scheduled heaviest first, and splits wholly outside the
//   causal/window range of every row of a CTA are never loaded (of a
//   warpgroup: never computed).  D is any multiple of 8 up to 256; the
//   tiles are padded with zeros to 16, 32, 64, 128, 160 or 256 columns as
//   in every bf16 attention kernel here (the k16 steps a row meets), and
//   zero columns add nothing to a score and are never written.
//   On the H100 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 2,
//   SDPA in brackets): S = 512 0.0208 ms (0.0115; the alternate-split
//   mma.sync design before it 0.0282), the 4 x 2048 prefill 0.3531
//   (0.1365; that design 0.8152), whisper's encoder
//   0.2073 (0.0858), D = 160 0.0305 (0.0159).  The CUDA-core work of a
//   split (the mask, exp2, P's two bf16 terms, the fold per split) bounds
//   it, not the tensor cores: skipping the mask on splits every row of a
//   warp sees whole was the largest single gain.  Left for later:
//   overlapping one split's softmax with the next split's products inside
//   a warpgroup.
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
#include "hopper.cuh"

namespace {

using namespace repro_kernels;  // common.cuh, split_merge.cuh, tensor_core.cuh, attention_split.cuh,
                                // hopper.cuh

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

using bf16 = __nv_bfloat16;

constexpr int kBox = 64;                 // columns of one 128-byte-swizzled box
constexpr int kBoxBytes = 64 * kBox * 2;  // one box of 64 rows (keys or query rows)

// NC consumer warpgroups of 64 stacked rows each, one producer warpgroup.
// Q stays in shared memory, one 64-row tile per consumer warpgroup, read by
// wgmma through its descriptor: kept in registers as a wgmma A operand
// across the split loop, its registers were handed to other data by the
// compiler in one form of the loop (wrong rows at DP <= 64).
template <int DP, int NC>
struct FlashShape {
  static constexpr int kBoxes = (DP + kBox - 1) / kBox;  // 64-column boxes of a K, V or Q tile,
                                                          // and 64-column chunks of O
  static constexpr int kTileBytes = kBoxes * kBoxBytes;    // one K or V tile, or one warpgroup's Q
  static constexpr int kStages = (200 * 1024 - NC * kTileBytes) / (2 * kTileBytes) < 8
                                     ? (200 * 1024 - NC * kTileBytes) / (2 * kTileBytes)
                                     : 8;
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr size_t kSmem = 1024 + (size_t)(NC + 2 * kStages) * kTileBytes;
  static_assert(kStages >= 2, "a ring of at least two K/V stages");
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One 64-column chunk of a split's P V folded into the rows' running O
// (split_merge.cuh's fold_value: o c + a w, one rounding each).  Where
// c = 1 (the split left a row's running max where it was) o c is o, so the
// product is skipped: the same bits, 32 fewer multiplies.
__device__ __forceinline__ void fold_chunk(float* o, const float (&acc)[32], bool fa, float ca,
                                           float wa, bool fb, float cb, float wb) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // row a: slots 0, 1 of each 8-column block; row b: 2, 3
    const bool f = h ? fb : fa;
    const float c = h ? cb : ca, w = h ? wb : wa;
    if (!f) continue;  // an empty split leaves the row as it was
    if (c == 1.f) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n + 2 * h] = __fmaf_rn(acc[4 * n + 2 * h], w, o[4 * n + 2 * h]);
        o[4 * n + 2 * h + 1] = __fmaf_rn(acc[4 * n + 2 * h + 1], w, o[4 * n + 2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[4 * n + 2 * h] = fold_value(o[4 * n + 2 * h], acc[4 * n + 2 * h], c, w);
        o[4 * n + 2 * h + 1] = fold_value(o[4 * n + 2 * h + 1], acc[4 * n + 2 * h + 1], c, w);
      }
    }
  }
}

// One CTA per (64 NC stacked rows, kv head, sequence).  The stacked rows
// are the (query, head) pairs of the kv head's G query heads, query-major
// (row s = q * G + g), so one K/V tile serves every query head of its group
// and is loaded once.  Warpgroup NC is the producer: one thread walks the
// position splits [64 j, 64 j + 64) that any row of the CTA can attend, in
// ascending order, and TMA-loads each split's K and V (64 keys x DP, zeros
// past Sk and past D) into a ring of mbarrier-guarded stages.  Consumer
// warpgroup c owns rows [64 c, 64 c + 64): it takes every split in order,
// skips those none of its rows can attend, and per split runs
//   S = Q K^T: DP / 16 wgmma m64n64k16 from zero (Q from the warpgroup's
//     shared tile, K K-major from the stage),
//   split_softmax (tensor_core.cuh) on each warp's 16 rows,
//   the fold of the split's (m, l) into the rows' running (M, L)
//     (split_merge.cuh's fold_stats), and per 64-column chunk of O the
//     split's P V, per 16-key step wgmma m64n64k16 with the hi terms of P
//     and then the lo terms as register A operands (V MN-major from the
//     stage) into a zeroed accumulator, folded into the running O
//     (fold_value).
// (M, L, O) stay in registers, and no barrier joins the consumers.  Every
// step is the split-KV kernels' on the same elements in the same order,
// and a wgmma k16 step rounds as an mma.sync one does, so a row gets the
// bits K1 and K2 give the same query over the same keys.
template <int DP, bool kSoftcap, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    tc_flash_kernel(const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, Params p) {
  using S = FlashShape<DP, NC>;
  constexpr int kStages = S::kStages, kBoxes = S::kBoxes;
  constexpr int kTile = S::kTileBytes;
  extern __shared__ unsigned char tc_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(tc_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_smem = smem;                // [NC][kBoxes][64 rows][64 cols]
  unsigned char* ring = smem + NC * kTile;     // [kStages][K, V][kBoxes][64 keys][64 cols]
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const int G = p.H / p.KV;
  const int nrows = G * p.Sq;
  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int s0 = tile * 64 * NC;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  // the splits [j0, j0 + n_splits) any row of this CTA can attend (row q
  // at position q_offset + q), or of warpgroup c's rows alone
  auto span = [&](int r0, int r1, int& j0, int& n) {
    const int qlo = p.q_offset + r0 / G, qhi = p.q_offset + (r1 - 1) / G;
    int kend = p.Sk;
    if (p.causal) kend = min(kend, qhi + 1);
    const int kbeg = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
    j0 = kbeg / kSplitKeys;
    n = r1 > r0 && kend > kbeg ? (kend - 1) / kSplitKeys - j0 + 1 : 0;
  };
  int j0, n_splits;
  span(s0, min(s0 + 64 * NC, nrows), j0, n_splits);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // the producer
    if constexpr (NC > 1) setmaxnreg_dec<40>();
    if (tid != 0) return;
    tma_prefetch_map(&map_k);
    tma_prefetch_map(&map_v);
    int stage = 0, phase = 0;
    for (int u = 0; u < n_splits; ++u) {
      const int key0 = (j0 + u) * kSplitKeys;
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], 2 * kTile);
      unsigned char* kt = ring + stage * 2 * kTile;
#pragma unroll
      for (int bx = 0; bx < kBoxes; ++bx) {
        tma_load_4d(kt + bx * kBoxBytes, &map_k, &full[stage], bx * kBox, key0, kvh, b);
        tma_load_4d(kt + kTile + bx * kBoxBytes, &map_v, &full[stage], bx * kBox, key0, kvh, b);
      }
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    return;
  }

  // ---- a consumer warpgroup: rows r0 .. r0 + 63
  if constexpr (NC > 1) setmaxnreg_inc<232>();
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = s0 + 64 * wg;
  const bool live = r0 < nrows;
  int wj0, wn;
  span(r0, min(r0 + 64, nrows), wj0, wn);

  // Q rows -> this warpgroup's swizzled Q tile (zeros past the rows and
  // past D), read by every split's products through its descriptor
  unsigned char* qt = q_smem + wg * kTile;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const int nch = p.D / 8;
  for (int i = tid; i < 64 * kBoxes * 8; i += 128) {
    const int r = i / (kBoxes * 8), c = i % (kBoxes * 8), srow = r0 + r;
    const bool ok = srow < nrows && c < nch;
    const bf16* src = qb;
    if (ok) src = qb + (kvh * G + srow % G) * p.q_sh + (long long)(srow / G) * p.q_ss + c * 8;
    cp_async16(smem_addr(qt + (c / 8) * kBoxBytes + 2 * tma_swz(r, (c % 8) * 8)), src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();  // generic-proxy writes, read by wgmma
  named_sync(1 + wg, 128);

  // this warp's rows' positions, for the splits it sees whole
  const int wq_lo = p.q_offset + (r0 + 16 * warp) / G;
  const int wq_hi = p.q_offset + (min(r0 + 16 * warp + 15, nrows - 1)) / G;
  SplitMask mk;
  mk.kpos = nullptr;
  mk.qpa = p.q_offset + (r0 + 16 * warp + (lane >> 2)) / G;
  mk.qpb = p.q_offset + (r0 + 16 * warp + (lane >> 2) + 8) / G;
  mk.causal = p.causal;
  mk.window = p.window;
  mk.uniform = false;
  const float sa = kSoftcap ? p.sm_scale / p.softcap : p.sm_scale * kLog2e;
  const float sb = p.softcap * kLog2e;

  float M_a = -INFINITY, M_b = -INFINITY, L_a = 0.f, L_b = 0.f;
  float O[kBoxes * 32];  // 64-column chunk c: O[32 c + 4 n + e] (n: 8-column block)
#pragma unroll
  for (int i = 0; i < kBoxes * 32; ++i) O[i] = 0.f;

  const uint32_t ring_base = smem_addr(ring), q_base = smem_addr(qt);
  int stage = 0, phase = 0;
  for (int u = 0; u < n_splits; ++u) {
    const int j = j0 + u;
    mbar_wait(&full[stage], phase);
    if (live && j >= wj0 && j < wj0 + wn) {  // a split this warpgroup's rows attend
      const uint32_t kt = ring_base + stage * 2 * kTile, vt = kt + kTile;
      // S = Q K^T: DP / 16 wgmma m64n64k16 from zero, Q and K K-major from
      // shared memory
      float sc[kSplitKeys / 8][4];
#pragma unroll
      for (int jb = 0; jb < kSplitKeys / 8; ++jb) sc[jb][0] = sc[jb][1] = sc[jb][2] = sc[jb][3] = 0.f;
      fence_regs(sc);  // the zeros are written before wgmma.fence orders them
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint64_t dk = gmma_desc(kt + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
        const uint64_t dq = gmma_desc(q_base + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
        wgmma_ss_scores(sc, dq, dk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const int nk = p.Sk - j * kSplitKeys;
      mk.present = nk >= kSplitKeys ? ~0ull : (1ull << nk) - 1ull;
      const int kbase = j * kSplitKeys;
      // every slot a key every row of this warp attends: no mask to apply
      const bool all_valid = nk >= kSplitKeys && (!p.causal || kbase + kSplitKeys - 1 <= wq_lo) &&
                             (p.window <= 0 || wq_hi - kbase < p.window);
      float m_a, m_b, l_a, l_b;
      split_softmax<kSoftcap>(sc, mk, [&](int slot) { return kbase + slot; }, sa, sb, m_a, m_b,
                              l_a, l_b, all_valid);
      float ca = 0.f, wa = 0.f, cb = 0.f, wb = 0.f;
      const bool fa = m_a != -INFINITY, fb = m_b != -INFINITY;  // an empty split is skipped
      if (fa) fold_stats(M_a, L_a, m_a, l_a, ca, wa);
      if (fb) fold_stats(M_b, L_b, m_b, l_b, cb, wb);
      uint32_t hi[kSplitKeys / 16][4], lo[kSplitKeys / 16][4];
#pragma unroll
      for (int kt16 = 0; kt16 < kSplitKeys / 16; ++kt16) split_p_frags(sc, kt16, hi[kt16], lo[kt16]);
      // O = P V per 64-column chunk: per 16-key step the hi product, then
      // the lo product, into a zeroed accumulator (V MN-major from the
      // stage), folded into the running O
#pragma unroll
      for (int ch = 0; ch < kBoxes; ++ch) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        fence_regs(acc);
#pragma unroll
        for (int kt16 = 0; kt16 < kSplitKeys / 16; ++kt16) {
          fence_regs(hi[kt16]);
          fence_regs(lo[kt16]);
        }
        wgmma_fence();
#pragma unroll
        for (int kt16 = 0; kt16 < kSplitKeys / 16; ++kt16) {
          const uint64_t dv = gmma_desc(vt + ch * kBoxBytes + kt16 * 16 * 128, kBoxBytes, 1024);
          wgmma_rs<64, 1>(acc, hi[kt16], dv);
          wgmma_rs<64, 1>(acc, lo[kt16], dv);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kt16 = 0; kt16 < kSplitKeys / 16; ++kt16) {  // P is read asynchronously
          fence_regs(hi[kt16]);
          fence_regs(lo[kt16]);
        }
        fold_chunk(&O[32 * ch], acc, fa, ca, wa, fb, cb, wb);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) stage = 0, phase ^= 1;
  }
  if (!live) return;

  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* ob = static_cast<bf16*>(p.out) + b * p.o_sb;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * half;
    if (r >= nrows) continue;
    const float L = half ? L_b : L_a;
    bf16* orow = ob + (kvh * G + r % G) * p.o_sh + (long long)(r / G) * p.o_ss;
    if (L == 0.f) {  // no valid key: the plain mean of the Sk value rows
      for (int d = 2 * (lane & 3); d < p.D; d += 8)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            mean_value(vb, p.v_ss, p.Sk, d), mean_value(vb, p.v_ss, p.Sk, d + 1));
      continue;
    }
#pragma unroll
    for (int cb = 0; cb < kBoxes; ++cb) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = 64 * cb + 8 * n + 2 * (lane & 3);
        if (d < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(fold_finish(O[32 * cb + 4 * n + 2 * half], L),
                                    fold_finish(O[32 * cb + 4 * n + 2 * half + 1], L));
      }
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

template <int DP, bool kSoftcap, int NC>
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

constexpr int kSms = 132;  // the H100 SXM's SMs

// K and V through 4-d tensor maps over their [B, KV, Sk, D] strides (head
// dim contiguous), boxes of 64 columns x 64 keys, 128-byte swizzle, zeros
// past Sk and past D
template <int DP, bool kSoftcap, int NC>
cudaError_t launch_tc(const Params& p, int B, cudaStream_t s) {
  using S = FlashShape<DP, NC>;
  CUtensorMap map_k, map_v;
  const uint32_t box[4] = {kBox, kSplitKeys, 1, 1};
  const uint64_t dims[4] = {(uint64_t)p.D, (uint64_t)p.Sk, (uint64_t)p.KV, (uint64_t)B};
  const uint64_t ks[3] = {2ull * p.k_ss, 2ull * p.k_sh, 2ull * p.k_sb};
  const uint64_t vs[3] = {2ull * p.v_ss, 2ull * p.v_sh, 2ull * p.v_sb};
  if (!make_tensor_map(&map_k, p.k, 4, dims, ks, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tensor_map(&map_v, p.v, 4, dims, vs, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const void* kernel = (const void*)tc_flash_kernel<DP, kSoftcap, NC>;
  cudaError_t err = allow_smem<TcTag<DP, kSoftcap, NC>>(kernel, S::kSmem);
  if (err != cudaSuccess) return err;
  const int rows = (p.H / p.KV) * p.Sq;
  dim3 grid((rows + 64 * NC - 1) / (64 * NC), p.KV, B);
  tc_flash_kernel<DP, kSoftcap, NC><<<grid, S::kThreads, S::kSmem, s>>>(map_k, map_v, p);
  return cudaGetLastError();
}

// groups: consumer warpgroups per CTA, 1 or 2; 0 picks by shape: two while
// two-warpgroup CTAs still fill three quarters of the SMs, else one (twice
// the CTAs; chip_smoke.py phase 2 times both)
template <int DP>
cudaError_t launch_tc(const Params& p, int B, int groups, cudaStream_t s) {
  if (groups == 0) {
    const long long ctas = (long long)((p.H / p.KV) * p.Sq + 127) / 128 * p.KV * B;
    groups = 4 * ctas >= 3 * kSms ? 2 : 1;
  }
  if (groups == 1)
    return p.softcap > 0.f ? launch_tc<DP, true, 1>(p, B, s) : launch_tc<DP, false, 1>(p, B, s);
  return p.softcap > 0.f ? launch_tc<DP, true, 2>(p, B, s) : launch_tc<DP, false, 2>(p, B, s);
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
                            int groups, void* stream) {
  if (D <= 0 || D % (dtype == 0 ? 4 : 8) || B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      Sq <= 0 || Sk < 0 || q_offset < 0 || B > 65535 || H > 65535 || groups < 0 || groups > 2 ||
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
#define REPRO_LAUNCH(DP) launch_tc<DP>(p, B, groups, s)
  return (int)REPRO_TC_DISPATCH(D, REPRO_LAUNCH);
#undef REPRO_LAUNCH
}

}  // extern "C"
