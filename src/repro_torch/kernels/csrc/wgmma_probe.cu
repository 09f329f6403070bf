// A probe of the tensor cores, not a kernel of any path: do wgmma and
// mma.sync give the same bits for the same k16 step?
//
// The bitwise route gates (a query over the same keys gives the same bits
// in K1, K2 and K5) hold only while every route feeds the same products
// to instructions that round the same way.  K1 and K2 run mma.sync with
// 16-row fragments; K5 could run wgmma only if a wgmma k16 step rounds as
// an mma.sync k16 step does.  Each CTA takes one problem: D = A B + C with
// A 16 x 16 and B 16 x 128 in bf16 and C 16 x 128 in f32, computed
//   0: by mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, one per 8 columns;
//   1: by one wgmma m64n128k16 with A from registers (the 16 rows in one
//      warp's share of the 64; the other warps' rows zero) and B K-major
//      (B given as [N][K]) from a 128-byte-swizzled shared tile;
//   2: the same with A from a 128-byte-swizzled shared tile;
//   3: A from registers, B MN-major ([K][N], two 64-column boxes);
//   4: A from shared memory, B MN-major;
// and writes the five [16][128] f32 results.  The caller compares them
// bitwise (bench/wgmma_probe.py).

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

using namespace repro_kernels;
using bf16 = __nv_bfloat16;

constexpr int kN = 128;       // B's columns
constexpr int kVariants = 5;  // the routes above
constexpr size_t kSmem = 1024 + sizeof(bf16) * (64 * 64 + kN * 64 + 64 * kN);

__device__ __forceinline__ uint32_t pack2(const bf16* p, int stride) {
  __nv_bfloat162 v;
  v.x = p[0];
  v.y = p[stride];
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(128) wgmma_probe_kernel(const bf16* a_all, const bf16* b_all,
                                                          const float* c_all, float* out_all) {
  extern __shared__ unsigned char raw[];
  bf16* as = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  bf16* bk = as + 64 * 64;  // [kN n][64 k], K-major
  bf16* bm = bk + kN * 64;  // kN / 64 boxes of [64 k][64 n], MN-major
  const int pidx = blockIdx.x, kw = pidx & 3;  // warp kw holds the 16 real rows
  const bf16* a = a_all + (size_t)pidx * 16 * 16;
  const bf16* b = b_all + (size_t)pidx * 16 * kN;
  const float* c = c_all + (size_t)pidx * 16 * kN;
  float* out = out_all + (size_t)pidx * kVariants * 16 * kN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const bf16 zero = __float2bfloat16_rn(0.f);

  for (int i = tid; i < 64 * 64; i += 128) {
    const int r = i / 64, k = i % 64;
    as[tma_swz(r, k)] = (r >> 4) == kw && k < 16 ? a[(r & 15) * 16 + k] : zero;
  }
  for (int i = tid; i < kN * 64; i += 128) {
    const int n = i / 64, k = i % 64;
    bk[tma_swz(n, k)] = k < 16 ? b[k * kN + n] : zero;
    const int k2 = i / kN, n2 = i % kN;
    bm[(n2 / 64) * 4096 + tma_swz(k2, n2 % 64)] = k2 < 16 ? b[k2 * kN + n2] : zero;
  }
  fence_proxy_async();
  __syncthreads();

  // 0: mma.sync on warp kw
  if (warp == kw) {
    uint32_t af[4] = {pack2(a + g * 16 + 2 * t, 1), pack2(a + (g + 8) * 16 + 2 * t, 1),
                      pack2(a + g * 16 + 2 * t + 8, 1), pack2(a + (g + 8) * 16 + 2 * t + 8, 1)};
    for (int nb = 0; nb < kN / 8; ++nb) {
      const int col = 8 * nb + 2 * t;
      float d[4] = {c[g * kN + col], c[g * kN + col + 1], c[(g + 8) * kN + col],
                    c[(g + 8) * kN + col + 1]};
      const uint32_t b0 = pack2(b + (2 * t) * kN + 8 * nb + g, kN);
      const uint32_t b1 = pack2(b + (2 * t + 8) * kN + 8 * nb + g, kN);
      mma_bf16(d, af, b0, b1);
      out[g * kN + col] = d[0];
      out[g * kN + col + 1] = d[1];
      out[(g + 8) * kN + col] = d[2];
      out[(g + 8) * kN + col + 1] = d[3];
    }
  }

  uint32_t af[4] = {0u, 0u, 0u, 0u};
  if (warp == kw) {
    af[0] = pack2(a + g * 16 + 2 * t, 1);
    af[1] = pack2(a + (g + 8) * 16 + 2 * t, 1);
    af[2] = pack2(a + g * 16 + 2 * t + 8, 1);
    af[3] = pack2(a + (g + 8) * 16 + 2 * t + 8, 1);
  }
  const uint64_t da = gmma_desc(smem_addr(as), 16, 1024);
  const uint64_t dbk = gmma_desc(smem_addr(bk), 16, 1024);
  const uint64_t dbm = gmma_desc(smem_addr(bm), 64 * 64 * 2, 1024);
#pragma unroll
  for (int v = 1; v < kVariants; ++v) {
    float acc[kN / 2];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const bool mine = warp == kw;
      acc[4 * j] = mine ? c[g * kN + col] : 0.f;
      acc[4 * j + 1] = mine ? c[g * kN + col + 1] : 0.f;
      acc[4 * j + 2] = mine ? c[(g + 8) * kN + col] : 0.f;
      acc[4 * j + 3] = mine ? c[(g + 8) * kN + col + 1] : 0.f;
    }
    fence_regs(acc);
    wgmma_fence();
    if (v == 1) wgmma_rs<kN, 0>(acc, af, dbk);
    if (v == 2) wgmma_ss<kN, 0>(acc, da, dbk);
    if (v == 3) wgmma_rs<kN, 1>(acc, af, dbm);
    if (v == 4) wgmma_ss<kN, 1>(acc, da, dbm);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (warp == kw) {
      float* o = out + v * 16 * kN;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int col = 8 * j + 2 * t;
        o[g * kN + col] = acc[4 * j];
        o[g * kN + col + 1] = acc[4 * j + 1];
        o[(g + 8) * kN + col] = acc[4 * j + 2];
        o[(g + 8) * kN + col + 1] = acc[4 * j + 3];
      }
    }
  }
}

}  // namespace

extern "C" {

// P problems: a [P][16][16] bf16, b [P][16][128] bf16, c [P][16][128] f32
// -> out [P][5][16][128] f32 (the five routes above).  Returns
// cudaGetLastError() after the launch.
int wgmma_probe(const void* a, const void* b, const float* c, float* out, int P, void* stream) {
  if (P <= 0) return (int)cudaErrorInvalidValue;
  wgmma_probe_kernel<<<P, 128, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), c, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
