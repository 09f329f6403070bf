// Flash attention (prefill) for Hopper (sm_90a).
//
// Replaces kernels/flash_attention.py:flash_attention_pallas: tiled forward
// attention with GQA (query head h reads kv head h / (H / KV); KV is never
// repeated in memory), top-left causal alignment (q_pos = row, k_pos = col,
// also when Sq != Sk), a sliding window (q_pos - k_pos < window), tanh
// soft-capping applied before the mask, and masking of the ragged key edge
// (k_pos < Sk).  q, k and v are upcast to f32 before both products; the
// softmax statistics and the accumulator are f32, and the output is
// acc / max(l, 1e-30) cast to q's type.
//
// Design.  The Pallas grid's sequential kv axis becomes a loop inside one
// CTA: one CTA per (64-row query tile, query head, sequence) walks 64-key
// tiles, with the online-softmax state in registers.  256 threads form a
// 16 x 16 grid; thread (ty, tx) owns query rows ty + 16 i (i < 4), for the
// scores keys tx + 16 j (j < 4) of the tile, and for the output columns
// tx + 16 c (c < 8) of its rows.  The 16 threads that share a row sit in one
// half-warp, so the row max is a 4-step shuffle and the rescale factor of a
// row is known to every thread that holds its accumulator; the running sum
// is kept per thread and reduced once at the end.  Q, K and V tiles live in
// shared memory as f32 with an odd row stride (D + 1), so the 16 different
// key rows a half-warp reads hit 16 different banks; the tile's
// unnormalised weights go through shared memory to the PV product.  Key
// tiles wholly outside the causal range or before the window of every row
// of the CTA are never loaded.  Operands are addressed by strides (the head
// dimension contiguous), so the model hands over [B, S, H, D] activations
// as [B, H, S, D] views without a copy, and the output is written through
// strides too.
//
// What bounds it on the card: at the serving shape (S = 512, D = 128, 16
// query heads over 8 kv heads, causal) the call does 4 * S^2 / 2 * D FLOPs
// per query head and moves q, k, v and the output once: about 170 FLOPs per
// byte, under the H100's bf16 ridge (~295), so its roofline bound is bytes.
// This kernel runs both products on the f32 CUDA cores (67 TFLOP/s, not the
// tensor cores), where the same FLOPs take ~16 us: operations bound it.
// Left for later: wgmma for QK^T and PV, TMA tile loads in a ring of
// stages, and sharing one K/V tile across the G query heads of a kv head.
//
// A query row with no valid key at all (only possible with Sq > Sk under a
// causal window, or Sk = 0) yields zeros; the dense reference spreads
// uniform weights over such a row instead.  The model never builds one.
//
// The kernel allocates nothing and does not synchronise; the caller passes
// the stream and checks the returned cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;              // the 16 x 16 thread grid
constexpr int kTile = 64;              // query rows per CTA, keys per tile
constexpr int kMaxD = 128;
constexpr int kRows = kTile / kSide;   // query rows per thread
constexpr int kKeys = kTile / kSide;   // keys per thread in the score tile
constexpr int kCols = kMaxD / kSide;   // output columns per thread
constexpr int kPs = kTile + 1;         // row stride of the weight tile

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
  float sm_scale, softcap;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [row0, row0 + kTile) of one head -> f32 shared memory with row
// stride ld, by 16-byte vector loads; rows at or past n_rows are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base, long long stride,
                                          int row0, int n_rows, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = D / kVec;
  for (int i = threadIdx.x; i < kTile * nvec; i += kThreads) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ld = D + 1;
  float* qs = smem;              // [kTile][ld]
  float* ks = qs + kTile * ld;   // [kTile][ld]
  float* vs = ks + kTile * ld;   // [kTile][ld]
  float* ps = vs + kTile * ld;   // [kTile][kPs] unnormalised weights

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile<T>(qs, ld, qb, p.q_ss, q0, p.Sq, D);

  // keys any row of this CTA can attend: [kbeg, kend)
  int kend = p.Sk;
  if (p.causal) kend = min(kend, q0 + kTile);
  const int kbeg = p.window > 0 ? max(0, q0 - p.window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done; qs is visible
    load_tile<T>(ks, ld, kb, p.k_ss, k0, kend, D);
    load_tile<T>(vs, ld, vb, p.v_ss, k0, kend, D);
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
      const int qp = q0 + ty + kSide * i;
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
    for (int j = 0; j < kTile; ++j) {
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
    const int qp = q0 + ty + kSide * i;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    if (qp < p.Sq) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + kSide * c;
        if (col < D) ob[(long long)qp * p.o_ss + col] = from_f<T>(acc[i][c] * inv);
      }
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * (size_t)(3 * kTile * (D + 1) + kTile * kPs);
}

constexpr int kMaxDevices = 64;

// Raises the dynamic shared-memory limit of one instantiation to what the
// largest head dim needs, once per device rather than before every launch.
template <typename T>
cudaError_t allow_max_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxD));
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t s) {
  const size_t smem = smem_bytes(p.D);
  cudaError_t err = allow_max_smem<T>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.Sq + kTile - 1) / kTile, p.H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes the
// kernel does not take).
int flash_attention_forward(int dtype, const void* q, const void* k, const void* v, void* out,
                            long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                            long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                            long long v_ss, long long o_sb, long long o_sh, long long o_ss, int B,
                            int H, int KV, int Sq, int Sk, int D, int causal, int window,
                            float softcap, void* stream) {
  if (D <= 0 || D > kMaxD || B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Sk < 0 ||
      B > 65535 || H > 65535)
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
  p.sm_scale = 1.0f / sqrtf((float)D);
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
