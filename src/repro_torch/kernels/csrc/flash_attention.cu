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
// Two kernels, chosen by dtype (not a fallback: each takes only its type):
//
// * bfloat16, the serving dtype: tc_flash_kernel, on the tensor cores.
//   What bounds it: at the serving shape (S = 512, D = 128, 16 query heads
//   over 8 kv heads, causal) the call does 4 * S^2 / 2 * D FLOPs per query
//   head and moves q, k, v and the output once, about 170 FLOPs per byte,
//   under the H100's bf16 ridge (~295): bytes bound it, and at this size
//   the latency of the longest CTA (the last causal q tile walks every key
//   tile) sets its time.  Design: one CTA of two warpgroups (8 warps) per
//   (64 stacked rows, kv head, sequence).  The stacked rows are the (query,
//   head) pairs of the kv head's G query heads, query-major (row s = q * G +
//   g), so one K/V tile serves every query head of its group and is loaded
//   once.  Both warpgroups hold the same 64 rows (16 per warp) and take
//   alternate 64-key tiles, each with its own online softmax, so the last
//   causal q tile walks half its keys per warpgroup; at the end warpgroup 1
//   hands its (m, l, acc) to warpgroup 0 through shared memory, which merges
//   and writes.  QK^T and PV run as mma.sync.m16n8k16 bf16 with f32
//   accumulators, A and B fragments read from swizzled shared memory by
//   ldmatrix (V with .trans, since it is key-major), each k-step's fragments
//   loaded before its independent mma chains, and P goes from the score
//   accumulators to A fragments in registers, rounded to bf16 (<= 2^-9
//   relative per weight; the reference keeps p in f32, so the card tests
//   hold it at the bf16 tolerance).  Each warpgroup streams its K/V tiles
//   through its own ring of 2 shared-memory stages by cp.async (16 bytes per
//   thread per copy, zero-filled past the key edge), so its next tile is in
//   flight while the current one is computed.  The q tiles of a causal call
//   are scheduled heaviest first; key tiles wholly outside the causal/window
//   range of every row of the CTA are never loaded, and the per-element mask
//   runs only on the diagonal, window-edge and ragged tiles.  D is any
//   multiple of 8 up to 256; the shared tiles are padded with zeros to 16,
//   32, 64, 128, 160 or 256 columns (24 runs as 32, 80 as 128, 136-160 as
//   160, 168-256 as 256), and zero columns in Q, K and V add nothing to a
//   score and are never written.  Registers bound the wide tiles: a thread
//   holds DP / 2 f32 accumulators (80 at 160, 128 at 256) besides its 32
//   scores, so past DP = 128 the Q fragments stay in shared memory and are
//   re-read by ldmatrix at each k-step (one more ldmatrix per four of K),
//   and V's fragments are loaded 5 or 2 at a time; shared memory bounds DP
//   = 256 to one K/V stage per warpgroup (160 KiB with Q), where 160 keeps
//   two (180 KiB).  Left for later: wgmma with TMA tile loads and
//   warp specialisation (this kernel uses the Ampere-style mma.sync path).
//
// * float32 (the card tests' 1e-5 checks, which no bf16 or TF32 tensor-core
//   product meets): flash_attention_kernel, the SIMT kernel of the first
//   port.  One CTA per (64-row query tile, query head, sequence) walks 64-key
//   tiles with the online-softmax state in registers; 256 threads form a
//   16 x 16 grid; thread (ty, tx) owns query rows ty + 16 i (i < 4), for the
//   scores keys tx + 16 j (j < 4) of the tile, and for the output columns
//   tx + 16 c (c < 8, or 16 in the instantiation for D above 128) of its
//   rows.  Q, K and V tiles live in shared memory as f32 with an odd row
//   stride (D + 1; 209 KiB at D = 256); both products are f32 FMAs.  D is
//   any multiple of 4 up to 256.
//
// * head dims past 256, up to 512, in both types: the same SIMT kernel with
//   32-row query tiles and 32-key tiles (four 32 x (D + 1) f32 tiles and the
//   weights: 197 KiB at D = 512), 32 output columns per thread, the tiles
//   converted to f32 as they are loaded.  Every score sums all D columns of
//   q.k in f32.  Nothing bounds it but simplicity: the tensor-core kernel's
//   accumulators (DP / 2 f32 per thread) do not fit registers past 256, and
//   no catalogue model has such a head; a later PR can split D over two
//   warpgroups there.
//
// A query row with no valid key at all (only possible with Sq > Sk under a
// causal window, or Sk = 0; the model never builds one) gets what the dense
// reference's uniform softmax over its masked scores gives it: the plain
// mean of the Sk value rows of its kv head (zeros when Sk = 0).  Both
// kernels find such a row by its running sum l, still 0 after the last key
// tile, and only such a row takes the branch that reads the Sk value rows
// (mean_value), so serving rows pay one comparison.  The Pallas kernel
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

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace repro_kernels;  // common.cuh, tensor_core.cuh

constexpr int kThreads = 256;
constexpr int kSide = 16;              // the 16 x 16 thread grid
constexpr int kTile = 64;              // query rows per CTA, keys per tile, up to D = 256
constexpr int kWideTile = 32;          // the same past D = 256: four tiles fit shared memory
constexpr int kMaxD = 256;             // the tensor-core kernel's widest head dim
constexpr int kMaxWideD = 512;         // the SIMT kernel's widest head dim

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

// The output of a query row with no valid key at column col: the plain
// mean of all Sk value rows of its kv head (zeros when Sk = 0), as the dense
// reference's uniform softmax over masked scores gives it.  Only such rows
// call it, so serving rows pay one comparison; kept out of line so that its
// loop does not change the register allocation of the kernels' main path.
template <typename T>
__device__ __noinline__ float mean_value(const T* vb, long long v_ss, int Sk, int col) {
  float sum = 0.f;
  for (int key = 0; key < Sk; ++key) sum += to_f<T>(vb[(long long)key * v_ss + col]);
  return Sk > 0 ? sum / (float)Sk : 0.f;
}

// DM: the widest head dim of the instantiation (128, 256 or 512); TILE:
// query rows per CTA and keys per tile (64, or 32 past D = 256)
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

constexpr int kTcWarps = 4;                         // warps per warpgroup, 16 rows each
constexpr int kTcRows = 16 * kTcWarps;              // stacked (query, head) rows per CTA
constexpr int kGroupThreads = 32 * kTcWarps;        // one warpgroup
constexpr int kTcGroups = 2;                        // warpgroups, alternate key tiles
constexpr int kTcThreads = kTcGroups * kGroupThreads;
constexpr int kTcKeys = 64;                         // keys per K/V tile

using bf16 = __nv_bfloat16;

template <int DP>
constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * (size_t)(kTcRows + 2 * kTcGroups * TcShape<DP>::kStages * kTcKeys) * DP;
}

// keys [k0, k0 + kTcKeys) of one kv head -> a swizzled [kTcKeys][DP] tile;
// keys at or past kend and columns at or past D are zeros
// (by the 128 threads of one warpgroup, gtid = thread index in the group)
template <int DP>
__device__ __forceinline__ void load_kv_tile(bf16* dst, const bf16* base, long long stride, int k0,
                                             int kend, int nch, int gtid) {
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int i = gtid; i < kTcKeys * kChunks; i += kGroupThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = k0 + r < kend && c < nch;
    const bf16* src = ok ? base + (long long)(k0 + r) * stride + c * 8 : base;
    cp_async16(smem_u32(dst + swz<DP>(r, c)), src, ok);
  }
}

template <int DP, bool kSoftcap>
__global__ void __launch_bounds__(kTcThreads) tc_flash_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
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

  const int G = p.H / p.KV;
  const int nrows = G * p.Sq;  // stacked rows s = q * G + g of this kv head
  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // heaviest first
  const int s0 = tile * kTcRows;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nch = p.D / 8;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & (kTcWarps - 1);
  const int grp = threadIdx.x / kGroupThreads, gtid = threadIdx.x % kGroupThreads;
  bf16* ks = kv_smem + grp * kStages * kTile;
  bf16* vs = kv_smem + (kTcGroups + grp) * kStages * kTile;

  // keys any row of this CTA can attend: [kbeg, kend); warpgroup grp takes
  // key tiles grp, grp + 2, ...  qlo and qhi are positions (query row q at
  // q_offset + q), so the offset shifts every bound below with them
  const int qlo = p.q_offset + s0 / G;
  const int qhi = p.q_offset + (min(s0 + kTcRows, nrows) - 1) / G;
  int kend = p.Sk;
  if (p.causal) kend = min(kend, qhi + 1);
  const int kbeg = p.window > 0 ? max(0, qlo - p.window + 1) : 0;
  const int n_tiles = kend > kbeg ? (kend - kbeg + kTcKeys - 1) / kTcKeys : 0;
  const int my_tiles = n_tiles > grp ? (n_tiles - grp + kTcGroups - 1) / kTcGroups : 0;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  auto tile_k0 = [&](int u) { return kbeg + (grp + kTcGroups * u) * kTcKeys; };

  // this lane's two rows of the warp's 16: ra (accumulator slots 0, 1), rb (2, 3)
  const int ra = s0 + 16 * warp + (lane >> 2), rb = ra + 8;
  const int qpa = p.q_offset + ra / G, qpb = p.q_offset + rb / G;  // positions
  const float sa = kSoftcap ? p.sm_scale / p.softcap : p.sm_scale * kLog2e;
  const float sb = p.softcap * kLog2e;

  float acc[kDBlocks][4];
#pragma unroll
  for (int n = 0; n < kDBlocks; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // m in log2 units
  uint32_t qf[kQRegs ? kKSteps : 1][4];

  if (n_tiles > 0) {
    // commit group u holds this thread's copies of the group's tile u (group
    // 0 also its share of Q); one group is committed per tile, empty or not
#pragma unroll
    for (int i = threadIdx.x; i < kTcRows * kChunks; i += kTcThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int srow = s0 + r;
      const bool ok = srow < nrows && c < nch;
      const bf16* src = qb;
      if (ok) {
        const int qp = srow / G, h = kvh * G + srow % G;
        src = qb + h * p.q_sh + (long long)qp * p.q_ss + c * 8;
      }
      cp_async16(smem_u32(qs + swz<DP>(r, c)), src, ok);
    }
    for (int u = 0; u < kStages; ++u) {
      if (u < my_tiles) {
        load_kv_tile<DP>(ks + u * kTile, kb, p.k_ss, tile_k0(u), kend, nch, gtid);
        load_kv_tile<DP>(vs + u * kTile, vb, p.v_ss, tile_k0(u), kend, nch, gtid);
      }
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

    // scale and soft-cap into log2 units, then mask (diagonal, window-edge
    // and ragged tiles only); both choices are made outside the element loop
    const bool edge = k0 + kTcKeys > p.Sk || (p.causal && k0 + kTcKeys - 1 > qlo) ||
                      (p.window > 0 && qhi - k0 >= p.window);
    float mx_a = -INFINITY, mx_b = -INFINITY;
    if (edge) {
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          const int qp = e < 2 ? qpa : qpb;
          bool valid = key < p.Sk;
          if (p.causal) valid = valid && key <= qp;
          if (p.window > 0) valid = valid && qp - key < p.window;
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
    if (u + kStages < my_tiles) {
      load_kv_tile<DP>(ks + st * kTile, kb, p.k_ss, tile_k0(u + kStages), kend, nch, gtid);
      load_kv_tile<DP>(vs + st * kTile, vb, p.v_ss, tile_k0(u + kStages), kend, nch, gtid);
    }
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

  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  bf16* ob = static_cast<bf16*>(p.out) + b * p.o_sb;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= nrows) continue;
    const float inv = half ? inv_b : inv_a;
    bf16* orow = ob + (kvh * G + r % G) * p.o_sh + (long long)(r / G) * p.o_ss;
    if ((half ? l_b : l_a) == 0.f) {  // no valid key: the plain mean of the Sk value rows
      for (int d = 2 * (lane & 3); d < p.D; d += 8)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            mean_value(vb, p.v_ss, p.Sk, d), mean_value(vb, p.v_ss, p.Sk, d + 1));
      continue;
    }
#pragma unroll
    for (int n = 0; n < kDBlocks; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      if (d < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
    }
  }
}

template <int DP, bool kSoftcap>
struct TcTag {};

template <typename T, int DM>
struct SimtTag {};

// The SIMT kernel: float32 at every head dim, bfloat16 past D = 256
template <typename T, int DM>
int launch_simt(const Params& p, int B, cudaStream_t s) {
  constexpr int kT = DM > kMaxD ? kWideTile : kTile;
  cudaError_t err = allow_smem<SimtTag<T, DM>>((const void*)flash_attention_kernel<T, DM, kT>,
                                               smem_bytes(DM, kT));
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kT - 1) / kT, p.H, B);
  flash_attention_kernel<T, DM, kT><<<grid, kThreads, smem_bytes(p.D, kT), s>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, bool kSoftcap>
int launch_tc(const Params& p, int B, cudaStream_t s) {
  constexpr size_t smem = tc_smem_bytes<DP>();
  cudaError_t err =
      allow_smem<TcTag<DP, kSoftcap>>((const void*)tc_flash_kernel<DP, kSoftcap>, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (p.H / p.KV) * p.Sq;
  dim3 grid((rows + kTcRows - 1) / kTcRows, p.KV, B);
  tc_flash_kernel<DP, kSoftcap><<<grid, kTcThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_tc(const Params& p, int B, cudaStream_t s) {
  return p.softcap > 0.f ? launch_tc<DP, true>(p, B, s) : launch_tc<DP, false>(p, B, s);
}

int launch_bf16(const Params& p, int B, cudaStream_t s) {
  if (p.D % 8) return (int)cudaErrorInvalidValue;
  if (p.D > kMaxD) return launch_simt<bf16, kMaxWideD>(p, B, s);
  if (p.D <= 16) return launch_tc<16>(p, B, s);
  if (p.D <= 32) return launch_tc<32>(p, B, s);
  if (p.D <= 64) return launch_tc<64>(p, B, s);
  if (p.D <= 128) return launch_tc<128>(p, B, s);
  if (p.D <= 160) return launch_tc<160>(p, B, s);
  return launch_tc<256>(p, B, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (SIMT kernel; D a multiple of 4), 1 = bfloat16
// (tensor-core kernel up to D = 256, the SIMT kernel past it; D a multiple
// of 8); D <= 512.  sm_scale multiplies
// every score: 1 / sqrt(d) of the head dim d before the caller zero-padded
// it to D.  Query row i sits at position q_offset + i and key j at j, for
// the causal mask (j <= q_offset + i) and the window (q_offset + i - j <
// window).  Strides are in elements.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for shapes the kernels do not take).
int flash_attention_forward(int dtype, const void* q, const void* k, const void* v, void* out,
                            long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                            long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                            long long v_ss, long long o_sb, long long o_sh, long long o_ss, int B,
                            int H, int KV, int Sq, int Sk, int D, int causal, int window,
                            int q_offset, float sm_scale, float softcap, void* stream) {
  if (D <= 0 || D > kMaxWideD || D % (dtype == 0 ? 4 : 8) || B <= 0 || H <= 0 || KV <= 0 ||
      H % KV != 0 || Sq <= 0 || Sk < 0 || q_offset < 0 || B > 65535 || H > 65535)
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D <= 128) return launch_simt<float, 128>(p, B, s);
    if (D <= kMaxD) return launch_simt<float, kMaxD>(p, B, s);
    return launch_simt<float, kMaxWideD>(p, B, s);
  }
  if (dtype == 1) return launch_bf16(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
