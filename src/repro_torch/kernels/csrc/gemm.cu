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
// element sums its k16 steps from k = 0 upward into one f32 accumulator by
// mma.sync.m16n8k16; no split-K, no stream-K, no reduction across warps or
// CTAs.  The tile shape is chosen by M and N (narrow tiles at decode so that
// the weight's columns still spread over the 132 SMs), which leaves each
// element's order unchanged: row m of C depends only on row m of A and on B.
// B is read either as [K, N] row-major (a weight; its tiles are [64][BN]
// and reach the mma by ldmatrix .trans) or as the transpose of an [N, K]
// row-major table (qwen3's tied LM head embed.T; tiles [BN][64], ldmatrix
// without .trans), without a copy: both give the mma the same fragments.
//
// What bounds it: at decode M (1-8) the weight's bytes (K N 2 bytes read
// once); at prefill M (512-4096) the operations (2 M N K on the bf16 tensor
// cores).  Tiles (64-deep k tiles through a cp.async ring), the fastest of
// scripts/torch_gemm_tiles.py's sweep at qwen3-1.7b's shapes: M <= 16:
// 16 x 64 per 4 warps, 6 stages; M <= 32: 32 x 32 per 4 warps, 6 stages;
// up to M = 128, or while 128 x 128 tiles would leave SMs idle: 64 x 64
// per 4 warps, 4 stages; else 128 x 128 per 8 warps, 3 stages.  On the
// H100 (NVIDIA H100 80GB HBM3, 700.00 W) that sweep read, against
// torch.matmul: q/o 2048 x 2048 at M = 8 0.0187 ms (0.0055), at M = 512
// 0.0313 (0.0099); the MLP's down 6144 x 2048 at M = 8 0.0539 (0.0124);
// the tied LM head at M = 8 0.2098 (0.2068), at M = 512 1.2587 (0.4176):
// 1.0-4.5x cuBLAS, which picks split-K at these widths.  Serving hides it:
// qwen3-1.7b's paged traffic took 29.1 s on the GEMM (its first tiling,
// 16 x 16 at decode) and 30.2-31.2 s on torch.matmul in one call
// (scripts/torch_gemm_serving_ab.py), the step bound by the host.
// Operands must be 16-byte aligned with K and N multiples of 8; the
// wrapper zero-pads anything else.  Left for later: wgmma and TMA.
//
// The kernel allocates nothing and does not synchronise; the caller passes
// the stream and checks the returned cudaGetLastError().

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using namespace repro_kernels;  // common.cuh, tensor_core.cuh
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;  // k depth of a tile: 4 k16 steps

struct GemmParams {
  const bf16* a;  // [M, K], row stride lda
  const bf16* b;  // [K, N] row stride ldb (kn), or [N, K] row stride ldb
  bf16* c;        // [M, N], row stride ldc
  long long lda, ldb, ldc;
  int M, N, K;
};

template <int BM, int BN, int WM, int WN, int STAGES, bool kKN>
struct GemmShape {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kTM = BM / WM, kTN = BN / WN;  // a warp's tile
  static constexpr int kMT = kTM / 16, kNT = kTN / 8;  // its m16 and n8 blocks
  static constexpr int kATile = BM * kBK, kBTile = kBK * BN;
  static constexpr size_t kSmem = sizeof(bf16) * (size_t)STAGES * (kATile + kBTile);
  static_assert(kTM % 16 == 0 && kTN % 16 == 0, "warp tiles of whole m16 x n16 blocks");
};

template <int BM, int BN, int WM, int WN, int STAGES, bool kKN>
__global__ void __launch_bounds__(32 * WM * WN) gemm_kernel(GemmParams p) {
  using S = GemmShape<BM, BN, WM, WN, STAGES, kKN>;
  extern __shared__ __align__(128) unsigned char g_smem[];
  bf16* as = reinterpret_cast<bf16*>(g_smem);  // [STAGES][BM][kBK]
  bf16* bs = as + STAGES * S::kATile;            // [STAGES][kBK][BN] (kn) or [BN][kBK]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int n_kt = (p.K + kBK - 1) / kBK;

  auto load = [&](int st, int kt) {
    const int k0 = kt * kBK;
    bf16* at = as + st * S::kATile;
    for (int i = threadIdx.x; i < BM * (kBK / 8); i += S::kThreads) {
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      const bool ok = m0 + r < p.M && k0 + 8 * c < p.K;
      cp_async16(smem_u32(at + swz<kBK>(r, c)), ok ? p.a + (m0 + r) * p.lda + k0 + 8 * c : p.a, ok);
    }
    bf16* bt = bs + st * S::kBTile;
    if constexpr (kKN) {
      for (int i = threadIdx.x; i < kBK * (BN / 8); i += S::kThreads) {
        const int r = i / (BN / 8), c = i % (BN / 8);
        const bool ok = k0 + r < p.K && n0 + 8 * c < p.N;
        cp_async16(smem_u32(bt + swz<BN>(r, c)), ok ? p.b + (k0 + r) * p.ldb + n0 + 8 * c : p.b, ok);
      }
    } else {
      for (int i = threadIdx.x; i < BN * (kBK / 8); i += S::kThreads) {
        const int r = i / (kBK / 8), c = i % (kBK / 8);
        const bool ok = n0 + r < p.N && k0 + 8 * c < p.K;
        cp_async16(smem_u32(bt + swz<kBK>(r, c)), ok ? p.b + (n0 + r) * p.ldb + k0 + 8 * c : p.b, ok);
      }
    }
  };

  float acc[S::kMT][S::kNT][4];
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int j = 0; j < S::kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int u = 0; u < STAGES - 1; ++u) {
    if (u < n_kt) load(u, u);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt is in shared memory; tile kt - 1's stage is free
    if (kt + STAGES - 1 < n_kt) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const bf16* at = as + (kt % STAGES) * S::kATile;
    const bf16* bt = bs + (kt % STAGES) * S::kBTile;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[S::kMT][4], bf[S::kNT / 2][4];
#pragma unroll
      for (int i = 0; i < S::kMT; ++i)
        ldsm_x4(smem_u32(at + swz<kBK>(wm * S::kTM + 16 * i + (lane & 15), 2 * kk + (lane >> 4))),
                af[i][0], af[i][1], af[i][2], af[i][3]);
#pragma unroll
      for (int jp = 0; jp < S::kNT / 2; ++jp) {
        const int nb = wn * S::kTN + 16 * jp;
        if constexpr (kKN) {
          const int kr = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
          ldsm_x4_t(smem_u32(bt + swz<BN>(kr, nb / 8 + (lane >> 4))), bf[jp][0], bf[jp][1],
                    bf[jp][2], bf[jp][3]);
        } else {
          const int nr = nb + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(smem_u32(bt + swz<kBK>(nr, 2 * kk + ((lane >> 3) & 1))), bf[jp][0], bf[jp][1],
                  bf[jp][2], bf[jp][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < S::kMT; ++i)
#pragma unroll
        for (int jp = 0; jp < S::kNT / 2; ++jp) {
          mma_bf16(acc[i][2 * jp], af[i], bf[jp][0], bf[jp][1]);
          mma_bf16(acc[i][2 * jp + 1], af[i], bf[jp][2], bf[jp][3]);
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < S::kMT; ++i) {
#pragma unroll
    for (int j = 0; j < S::kNT; ++j) {
      const int col = n0 + wn * S::kTN + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * S::kTM + 16 * i + (lane >> 2) + 8 * h;
        if (row < p.M && col < p.N)
          *reinterpret_cast<__nv_bfloat162*>(p.c + row * p.ldc + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <int BM, int BN, int WM, int WN, int STAGES, bool kKN>
struct GemmTag {};

template <int BM, int BN, int WM, int WN, int STAGES, bool kKN>
int launch(const GemmParams& p, cudaStream_t s) {
  using S = GemmShape<BM, BN, WM, WN, STAGES, kKN>;
  const void* kernel = (const void*)gemm_kernel<BM, BN, WM, WN, STAGES, kKN>;
  cudaError_t err = allow_smem<GemmTag<BM, BN, WM, WN, STAGES, kKN>>(kernel, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  gemm_kernel<BM, BN, WM, WN, STAGES, kKN><<<grid, S::kThreads, S::kSmem, s>>>(p);
  return (int)cudaGetLastError();
}

constexpr int kSms = 132;  // the H100 SXM's SMs: 128 x 128 tiles only when they fill them

template <bool kKN>
int dispatch(const GemmParams& p, cudaStream_t s) {
  if (p.M <= 16) return launch<16, 64, 1, 4, 6, kKN>(p, s);
  if (p.M <= 32) return launch<32, 32, 2, 2, 6, kKN>(p, s);
  const long long big = (long long)((p.M + 127) / 128) * ((p.N + 127) / 128);
  if (p.M <= 128 || big < kSms) return launch<64, 64, 2, 2, 4, kKN>(p, s);
  return launch<128, 128, 2, 4, 3, kKN>(p, s);
}

}  // namespace

extern "C" {

// C[M, N] = A[M, K] B in bf16 with f32 sums.  b_kn = 1: B is [K, N] with
// row stride ldb; 0: B is the transpose of an [N, K] table with row stride
// ldb.  K and N multiples of 8, strides multiples of 8 elements, pointers
// 16-byte aligned.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes the kernel does not take).
int gemm_forward(const void* a, const void* b, void* c, int M, int N, int K, long long lda,
                 long long ldb, long long ldc, int b_kn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || lda % 8 || ldb % 8 || ldc % 8 ||
      lda < K || ldc < N || ldb < (b_kn ? N : K) || (M + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  GemmParams p{static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c),
               lda, ldb, ldc, M, N, K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return b_kn ? dispatch<true>(p, s) : dispatch<false>(p, s);
}

}  // extern "C"
