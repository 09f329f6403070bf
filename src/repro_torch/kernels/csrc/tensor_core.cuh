// Tensor-core and asynchronous-copy primitives shared by the bf16
// attention kernels of this directory: mma.sync.m16n8k16 bf16 products with
// f32 sums, ldmatrix fragment loads from XOR-swizzled shared tiles,
// 16-byte cp.async copies, and the arithmetic every bf16 attention kernel
// runs on one split: split_softmax and split_p_frags, and split_partial,
// the split-KV kernels' whole body on mma.sync (K1 and K2).  K5
// (flash_attention.cu) runs split_softmax and split_p_frags around wgmma
// products in the same k-step order (hopper.cuh); wgmma_probe.cu holds
// the two instructions' k16 steps against each other.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_kernels {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

// Element offset of 16-byte chunk c of row r in a [rows][DP] bf16 tile.
// Chunks are XOR-swizzled by row inside groups of 8 (the last group of a
// row of 20 chunks, DP = 160, is 4 wide), so the 8 rows one ldmatrix reads
// at the same logical chunk land in different banks: no conflict in a
// group of 8, two-way in the 4-wide group of DP = 160 (a 320-byte row puts
// rows r and r + 4 on the same banks there).
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = DP / 8;
  constexpr int kFull = kChunks / 8 * 8;  // chunks in whole groups of 8
  constexpr int kRest = kChunks - kFull;  // width of the last, partial group
  static_assert(DP % 16 == 0 && (kRest == 0 || kRest == 2 || kRest == 4),
                "padded widths 16, 32, 64, 128, 160 and 256 (and multiples of 64)");
  const int mask = c < kFull ? 7 : kRest - 1;
  return r * DP + ((c ^ (r & mask)) << 3);
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a score in log2 units: s * scale * log2(e), or with soft-capping
// cap * tanh(s * scale / cap) * log2(e); a and b are precomputed per launch
template <bool kSoftcap>
__device__ __forceinline__ float score_log2(float s, float a, float b) {
  return kSoftcap ? b * tanhf(s * a) : s * a;
}

// bf16 pair (lo, hi) -> one register, each rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// p = hi + lo with hi = bf16(p) and lo = bf16(p - hi): about 16 bits of p
// in two bf16 terms (p - hi is exact in f32)
__device__ __forceinline__ void split_bf16(float p, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(p));
  lo = __fsub_rn(p, hi);
}

// The padded tile width of a head dim (multiples of 8 up to 256): 24 runs
// as 32, 80 as 128, 136-160 as 160, 168-256 as 256.  Every bf16 attention
// kernel pads a head dim the same way, so one (query, keys) pair meets
// the same k-steps in each of them.
#define REPRO_TC_DISPATCH(D, F)                  \
  ((D) <= 16    ? F(16)                          \
   : (D) <= 32  ? F(32)                          \
   : (D) <= 64  ? F(64)                          \
   : (D) <= 128 ? F(128)                         \
   : (D) <= 160 ? F(160)                         \
                : F(256))

constexpr int kSplitKeys = 64;  // keys per split: split j holds positions [64 j, 64 j + 64)

// What the body needs to mask one split's 64 key slots for a warp's rows.
struct SplitMask {
  const int* kpos;         // [kSplitKeys] key positions (shared memory; split_partial)
  unsigned long long present;  // bit r: slot r holds a key
  int qpa, qpb;            // positions of this lane's rows ra and rb
  bool causal;             // a key counts only at kpos <= q_pos
  int window;              // > 0: only while q_pos - kpos < window
  bool uniform;            // every present key scores 0 (a row with no valid key)
};

// The softmax of one split, shared by every bf16 attention kernel: sc
// holds a warp's scores of 16 rows over the split's 64 key slots in the
// mma accumulator layout (8-key block j: slots 0, 1 row ra = lane / 4 and
// 2, 3 row rb = ra + 8, columns 8 j + 2 (lane % 4) + {0, 1}; wgmma's m64
// accumulator gives each warp its 16 rows in the same layout).  Masks each
// element (a slot without a key, a causal or window miss: -inf; slot r's
// position is kpos(r)), scales and optionally soft-caps it into log2 units
// (score_log2), and leaves p = exp2(s - m) in sc with m the row max over the
// 64 slots and l the sum of p, each lane over its 16 slots in slot order,
// then over the lane quad by a fixed xor tree.  With all_valid (every slot
// holds a key that every row of the warp attends) the mask is skipped: the
// same values, fewer instructions.
template <bool kSoftcap, class KPos>
__device__ __forceinline__ void split_softmax(float (&sc)[kSplitKeys / 8][4], const SplitMask& mk,
                                              const KPos& kpos, float sa, float sb, float& m_a,
                                              float& m_b, float& l_a, float& l_b,
                                              bool all_valid = false) {
  constexpr int kNB = kSplitKeys / 8;
  const int lane = threadIdx.x & 31;
  if (all_valid) {  // the caller knows every slot is a key every row attends
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[j][e] = mk.uniform ? 0.f : score_log2<kSoftcap>(sc[j][e], sa, sb);
  } else {
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = 8 * j + 2 * (lane & 3) + (e & 1);
        const int qp = e < 2 ? mk.qpa : mk.qpb;
        const int kp = kpos(slot);
        bool valid = (mk.present >> slot) & 1ull;
        if (mk.causal) valid = valid && kp <= qp;
        if (mk.window > 0) valid = valid && qp - kp < mk.window;
        sc[j][e] = !valid ? -INFINITY : mk.uniform ? 0.f : score_log2<kSoftcap>(sc[j][e], sa, sb);
      }
    }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
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
  const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
  const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    sc[j][0] = exp2f(__fsub_rn(sc[j][0], base_a));
    sc[j][1] = exp2f(__fsub_rn(sc[j][1], base_a));
    sc[j][2] = exp2f(__fsub_rn(sc[j][2], base_b));
    sc[j][3] = exp2f(__fsub_rn(sc[j][3], base_b));
    sum_a = __fadd_rn(sum_a, __fadd_rn(sc[j][0], sc[j][1]));
    sum_b = __fadd_rn(sum_b, __fadd_rn(sc[j][2], sc[j][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    sum_a = __fadd_rn(sum_a, __shfl_xor_sync(0xffffffffu, sum_a, o));
    sum_b = __fadd_rn(sum_b, __shfl_xor_sync(0xffffffffu, sum_b, o));
  }
  m_a = mx_a;
  m_b = mx_b;
  l_a = sum_a;
  l_b = sum_b;
}

// The A fragments of P's 16-key step kt16 (keys 16 kt16 .. 16 kt16 + 15):
// hi = bf16(p) and lo = bf16(p - hi), in the m16n8k16 A layout, which is
// also wgmma's register A layout of a warp's 16 rows.
__device__ __forceinline__ void split_p_frags(const float (&sc)[kSplitKeys / 8][4], int kt16,
                                              uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the A fragment's two 8-key halves
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // rows ra (slots 0, 1), rb (2, 3)
      float h0, l0, h1, l1;
      split_bf16(sc[2 * kt16 + h][2 * rr], h0, l0);
      split_bf16(sc[2 * kt16 + h][2 * rr + 1], h1, l1);
      hi[2 * h + rr] = pack_bf16(h0, h1);
      lo[2 * h + rr] = pack_bf16(l0, l1);
    }
  }
}

// THE attention body of the split-KV kernels.  One warp, 16 stacked query
// rows (this lane's rows ra = lane / 4 and rb = ra + 8), one split of 64
// key slots, all in swizzled shared tiles of padded width DP: q [16][DP], k
// and v [64][DP].  It returns the split's partial of both rows: m (log2
// units), l and acc (accumulator slots 0, 1 of each 8-column block for ra,
// 2, 3 for rb).
//   S = Q K^T: DP / 16 k-steps of mma.sync.m16n8k16 in order, per 8-key
//     block, from zero;
//   the softmax of split_softmax (slot r's position mk.kpos[r]);
//   O = P V in f32 at about the reference's precision: P is split into hi =
//     bf16(p) and lo = bf16(p - hi), and per 16-key step the hi product
//     and then the lo product go into the same f32 accumulator, from zero.
//     That doubles the P V mma.sync count (the reference keeps p in f32,
//     and one bf16 P would carry 8 bits of it).
// The result depends only on the rows' queries, the slots' keys, values
// and positions, and the mask inputs: not on which kernel, which warp of
// the CTA or which rows beside them run it.  flash_attention.cu runs the
// same steps on wgmma, whose k16 step rounds as mma.sync's does
// (bench/wgmma_probe.py), and gives a row the same bits.
template <int DP, bool kSoftcap>
__device__ __forceinline__ void split_partial(const __nv_bfloat16* qs, const __nv_bfloat16* kt,
                                              const __nv_bfloat16* vt, const SplitMask& mk,
                                              float sa, float sb, float& m_a, float& m_b,
                                              float& l_a, float& l_b, float (&acc)[DP / 8][4]) {
  constexpr int kKSteps = DP / 16, kDBlocks = DP / 8, kNB = kSplitKeys / 8;
  const int lane = threadIdx.x & 31;
  float sc[kNB][4];
#pragma unroll
  for (int j = 0; j < kNB; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    uint32_t qa[4], kf[kNB / 2][4];
    ldsm_x4(smem_u32(qs + swz<DP>(lane & 15, 2 * kk + (lane >> 4))), qa[0], qa[1], qa[2], qa[3]);
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
  split_softmax<kSoftcap>(sc, mk, [&](int slot) { return mk.kpos[slot]; }, sa, sb, m_a, m_b, l_a,
                          l_b);
#pragma unroll
  for (int n = 0; n < kDBlocks; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kt16 = 0; kt16 < kSplitKeys / 16; ++kt16) {
    uint32_t hi[4], lo[4];
    split_p_frags(sc, kt16, hi, lo);
    const int key = 16 * kt16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int dp = 0; dp < kDBlocks / 2; ++dp) {
      uint32_t vf[4];
      ldsm_x4_t(smem_u32(vt + swz<DP>(key, 2 * dp + (lane >> 4))), vf[0], vf[1], vf[2], vf[3]);
      mma_bf16(acc[2 * dp], hi, vf[0], vf[1]);
      mma_bf16(acc[2 * dp], lo, vf[0], vf[1]);
      mma_bf16(acc[2 * dp + 1], hi, vf[2], vf[3]);
      mma_bf16(acc[2 * dp + 1], lo, vf[2], vf[3]);
    }
  }
}

}  // namespace repro_kernels
