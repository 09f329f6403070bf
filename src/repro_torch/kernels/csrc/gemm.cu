// A row-invariant bf16 GEMM for Hopper (sm_90a): C[M, N] = A[M, K] B.
//
// It replaces no TPU kernel.  It exists because the reference's bitwise
// reuse gate (a warm prefill over reused pages equals a cold one) needs
// products whose rows do not depend on how many rows ride with them: the
// model's projections run at M = the batch width in a decode step, M = 32
// in a prefill chunk and M = S in a monolithic prefill, and a library GEMM
// picks its kernel, split-K included, by shape, so the same activation row
// times the same weight can come out with other bits.
//
// Contract: bf16 in, f32 accumulate, bf16 out rounded once.  Every output
// element sums its k16 steps from k = 0 upward into one f32 accumulator
// that starts at zero; no split-K, no stream-K, no reduction across warps
// or CTAs.  Every tile shape runs the same instruction,
// wgmma.mma_async m64nNk16, whose k16 step gives the bits of mma.sync's
// (bench/wgmma_probe.py) whatever N is, so the shape is chosen by M and N
// alone and row m of C depends only on row m of A and on B.  B is read
// either as [K, N] row-major (a weight: MN-major for wgmma) or as the
// transpose of an [N, K] row-major table (qwen3's tied LM head embed.T:
// K-major), in place, through its own tensor map.
//
// Design (hopper.cuh): one persistent CTA per SM walks the output tiles;
// a producer warpgroup's one thread keeps TMA loads of 64-deep k slices of
// A and B in a ring of mbarrier-guarded stages (zeros past M, N and K come
// from TMA's out-of-bounds fill), and each consumer warpgroup owns 64 rows
// of the tile and keeps one wgmma group in flight.  What bounds it: at
// decode M (1-64) the weight's bytes (K N 2 bytes read once), at prefill M
// the operations (2 M N K on the bf16 tensor cores).  Tiles, the fastest
// of scripts/torch_gemm_tiles.py's sweep at qwen3-1.7b's shapes: M <= 64:
// 64 x 64 of one consumer warpgroup (M of the 64 rows real, a 12-stage
// ring); above: 128 rows (two consumer warpgroups) by 128 columns, or by
// 64 while 128-column tiles would leave SMs idle.  16-column decode tiles
// (N / 16 CTAs, 32-byte swizzled B) were tried and dropped: they cover the
// SMs but read slower, each stage's four dependent k16 steps taking about
// as long as a 64-column stage's.  On the H100
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 2, torch.matmul
// in brackets): M = 8: q/o 0.0077 ms (0.0058), MLP down 0.0183 (0.0125),
// the tied head 0.2148 (0.2064; bound 0.1865); M = 512: q/o 0.0112
// (0.0101), the tied head 0.6062 (0.4210).  At decode each output element's
// chain of dependent k16 steps (one accumulator, no split-K) bounds a tile;
// left for later: a K split fixed at every M whose partials are summed in
// one order, with its chains in flight side by side.
//
// The kernel allocates nothing and does not synchronise; the caller passes
// the stream and checks the returned cudaGetLastError().

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro_kernels;  // common.cuh, hopper.cuh
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;  // k depth of a stage: 4 k16 steps, one 128-byte swizzled row of A
constexpr int kSms = 132;  // the H100 SXM's SMs: the persistent grid's width

struct GemmParams {
  bf16* c;  // [M, N], row stride ldc
  long long ldc;
  int M, N, K;
};

// BN: output columns of a tile; NCONS: consumer warpgroups, 64 rows each
// (BM = 64 NCONS); STAGES: depth of the TMA ring; kKN: B is a [K, N]
// weight (MN-major for wgmma), else the transpose of an [N, K] table
// (K-major).
template <int BN, int NCONS, int STAGES, bool kKN>
struct GemmShape {
  static constexpr int kBM = 64 * NCONS;
  static constexpr int kThreads = 128 * (NCONS + 1);  // + the producer warpgroup
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;  // a [K, N] B: BN / 64 boxes of 64 k rows x 64 columns
  static constexpr size_t kSmem = 1024 + (size_t)STAGES * (kABytes + kBBytes);
  static_assert(BN % 64 == 0, "tiles of whole 64-column boxes");
};

// The matrix descriptors of consumer warpgroup wg's A rows and of B, at
// k16 step kk of a stage.
template <int BN, int NCONS, int STAGES, bool kKN>
__device__ __forceinline__ uint64_t desc_a(uint32_t a_stage, int wg, int kk) {
  return gmma_desc(a_stage + wg * 64 * 128 + kk * 32, 16, 1024);
}

template <int BN, int NCONS, int STAGES, bool kKN>
__device__ __forceinline__ uint64_t desc_b(uint32_t b_stage, int kk) {
  using S = GemmShape<BN, NCONS, STAGES, kKN>;
  if constexpr (kKN)  // MN-major: boxes of 64 columns x 64 k rows, 16 rows a k16 step
    return gmma_desc(b_stage + kk * 16 * 128, 64 * kBK * 2, 1024);
  else  // K-major: BN rows of 64 k
    return gmma_desc(b_stage + kk * 32, 16, 1024);
}

// One persistent CTA per SM walks the output tiles (the M blocks of one
// column block first, so neighbouring CTAs read the same B tile from L2).
// Warpgroup NCONS is the producer: one thread keeps TMA loads of A (BM x
// 64) and B (64 x BN) in a ring of STAGES mbarrier-guarded stages, across
// tiles.  Each consumer warpgroup owns 64 rows of the tile and runs four
// wgmma m64nBNk16 per stage, from k = 0 upward into one f32 accumulator,
// one group in flight while the next stage's wait runs; the stage before
// is released once its group is done.
template <int BN, int NCONS, int STAGES, bool kKN>
__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                GemmParams p) {
  using S = GemmShape<BN, NCONS, STAGES, kKN>;
  extern __shared__ unsigned char g_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(g_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* a_ring = smem;                      // [STAGES][BM rows][128 bytes]
  unsigned char* b_ring = smem + STAGES * S::kABytes;  // [STAGES][B tile]
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NCONS);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_mb = (p.M + S::kBM - 1) / S::kBM, n_nb = (p.N + BN - 1) / BN;
  const int n_tiles = n_mb * n_nb, n_kt = (p.K + kBK - 1) / kBK;

  if (wg == NCONS) {  // the producer
    if constexpr (NCONS > 1) setmaxnreg_dec<40>();
    if (tid != 0) return;
    tma_prefetch_map(&map_a);
    tma_prefetch_map(&map_b);
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile % n_mb * S::kBM, n0 = tile / n_mb * BN;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], S::kABytes + S::kBBytes);
        tma_load_2d(a_ring + stage * S::kABytes, &map_a, &full[stage], kt * kBK, m0);
        unsigned char* bt = b_ring + stage * S::kBBytes;
        if constexpr (kKN) {
#pragma unroll
          for (int bx = 0; bx < BN / 64; ++bx)
            tma_load_2d(bt + bx * 64 * kBK * 2, &map_b, &full[stage], n0 + bx * 64, kt * kBK);
        } else {
          tma_load_2d(bt, &map_b, &full[stage], kt * kBK, n0);
        }
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
  } else {  // a consumer: rows [64 wg, 64 wg + 64) of each tile
    if constexpr (NCONS > 1) setmaxnreg_inc<232>();
    const int lane = tid & 31, warp = tid >> 5;
    const uint32_t a_base = smem_addr(a_ring), b_base = smem_addr(b_ring);
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile % n_mb * S::kBM, n0 = tile / n_mb * BN;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      fence_regs(acc);  // the zeros are written before wgmma.fence orders them
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&full[stage], phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss<BN, kKN ? 1 : 0>(
              acc, desc_a<BN, NCONS, STAGES, kKN>(a_base + stage * S::kABytes, wg, kk),
              desc_b<BN, NCONS, STAGES, kKN>(b_base + stage * S::kBBytes, kk));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group is done: release it
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      // the accumulator: 8-column block j of row r = 16 warp + lane / 4 holds
      // columns 2 (lane % 4) + {0, 1} in acc[4 j], acc[4 j + 1], row r + 8
      // in acc[4 j + 2], acc[4 j + 3]
      const int r0 = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col >= p.N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row < p.M)
            *reinterpret_cast<__nv_bfloat162*>(p.c + row * p.ldc + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

template <int BN, int NCONS, int STAGES, bool kKN>
struct GemmTag {};

template <int BN, int NCONS, int STAGES, bool kKN>
int launch(const bf16* a, const bf16* b, const GemmParams& p, long long lda, long long ldb,
           cudaStream_t s) {
  using S = GemmShape<BN, NCONS, STAGES, kKN>;
  CUtensorMap map_a, map_b;
  const uint64_t adims[2] = {(uint64_t)p.K, (uint64_t)p.M}, astr[1] = {(uint64_t)lda * 2};
  const uint32_t abox[2] = {kBK, S::kBM};
  if (!make_tensor_map(&map_a, a, 2, adims, astr, abox, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const uint64_t bstr[1] = {(uint64_t)ldb * 2};
  bool ok;
  if constexpr (kKN) {
    const uint64_t bdims[2] = {(uint64_t)p.N, (uint64_t)p.K};
    const uint32_t bbox[2] = {64, kBK};
    ok = make_tensor_map(&map_b, b, 2, bdims, bstr, bbox, CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    const uint64_t bdims[2] = {(uint64_t)p.K, (uint64_t)p.N};
    const uint32_t bbox[2] = {kBK, BN};
    ok = make_tensor_map(&map_b, b, 2, bdims, bstr, bbox, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)gemm_kernel<BN, NCONS, STAGES, kKN>;
  cudaError_t err = allow_smem<GemmTag<BN, NCONS, STAGES, kKN>>(kernel, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((p.M + S::kBM - 1) / S::kBM) * ((p.N + BN - 1) / BN);
  const int grid = (int)(tiles < kSms ? tiles : kSms);
  gemm_kernel<BN, NCONS, STAGES, kKN><<<grid, S::kThreads, S::kSmem, s>>>(map_a, map_b, p);
  return (int)cudaGetLastError();
}

// tile: 0 = the shape's own choice; 1-3 = one configuration (the tile sweep)
template <bool kKN>
int dispatch(const bf16* a, const bf16* b, const GemmParams& p, long long lda, long long ldb,
             int tile, cudaStream_t s) {
  if (tile == 0) {
    if (p.M <= 64) tile = 1;
    else tile = (long long)((p.M + 127) / 128) * ((p.N + 127) / 128) >= kSms ? 3 : 2;
  }
  switch (tile) {
    case 1: return launch<64, 1, 12, kKN>(a, b, p, lda, ldb, s);
    case 2: return launch<64, 2, 8, kKN>(a, b, p, lda, ldb, s);
    case 3: return launch<128, 2, 6, kKN>(a, b, p, lda, ldb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// C[M, N] = A[M, K] B in bf16 with f32 sums.  b_kn = 1: B is [K, N] with
// row stride ldb; 0: B is the transpose of an [N, K] table with row stride
// ldb.  K and N multiples of 8, strides multiples of 8 elements, pointers
// 16-byte aligned (what TMA addresses).  tile 0 picks the tiles by shape;
// 1-3 force one configuration (64 x 64 of one consumer warpgroup, 64
// columns x 128 rows of two, 128 x 128 of two; every one gives the same
// bits).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel or TMA does not take).
int gemm_forward(const void* a, const void* b, void* c, int M, int N, int K, long long lda,
                 long long ldb, long long ldc, int b_kn, int tile, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || lda % 8 || ldb % 8 || ldc % 8 ||
      lda < K || ldc < N || ldb < (b_kn ? N : K))
    return (int)cudaErrorInvalidValue;
  const GemmParams p{static_cast<bf16*>(c), ldc, M, N, K};
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return b_kn ? dispatch<true>(pa, pb, p, lda, ldb, tile, s)
              : dispatch<false>(pa, pb, p, lda, ldb, tile, s);
}

}  // extern "C"
