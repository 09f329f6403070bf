// The norms of the serving path, each in one launch: rms_norm and
// layer_norm over the last dim, written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's rms_norm and layer_norm
// (src/repro/models/layers.py:140-152) run jnp.mean / jnp.var and rsqrt as
// XLA ops; the port ran them as eight plain passes around a row-statistic
// kernel (x.float(), the statistic, + eps, rsqrt, * rsqrt, w.float(), * w,
// the cast), each pass through device memory.  Here one launch computes
//   rms:   y = (x * rsqrt(mean(x x) + eps)) * w
//   layer: y = ((x - mu) * rsqrt(mean((x - mu)^2) + eps)) * w + b,  mu = mean(x)
// in f32 from x's elements and the weight's, cast to x's type, with each
// operation rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn:
// nvcc would contract a*b+c into one FMA, and the plain chain rounds every
// op), rsqrtf as torch.rsqrt calls it, and bf16 rounded to nearest even.
//
// One order per row, whatever the rows beside it: one warp reduces a row;
// lane l adds the elements 4 (l + 32 k) + j, k ascending, j = 0..3, one
// round-to-nearest add at a time, the lanes' sums meet in the xor-shuffle
// tree 16, 8, 4, 2, 1, and the sum is divided by d; the layer norm takes
// the mean first, then the variance about it.  That is the order of the
// statistic kernel this one replaces, so a served row keeps its bits, and
// it depends on d alone: not on the number of rows, the warps per CTA,
// which warp takes a row, the row's alignment, or whether its elements
// arrive in vector loads (d % 4 == 0 on the vector's boundary) or one by
// one.
//
// What bounds it on the card: bytes (x read once, y written once, the
// weights once); there is no tensor-core work.  So:
// - a row of up to 2048 elements stays in a warp's registers between the
//   statistic and the output, as it was loaded (4 bf16 in 8 bytes, 4 f32 in
//   16), K chunks of 4 a lane, K the power of two at or above ceil(d / 128);
//   a wider row (grok-1-314b's 6144, arctic-480b's 7168) is read again for
//   each pass, eight chunks in flight a lane, from L1/L2;
// - a lane keeps its elements of the weight (and bias) in registers and
//   reuses them over the rows its warp walks, loading them again only when
//   the row's weight row changes (a per-head weight [nh, dh]: row r takes
//   weight row r mod nh); past 2048 they are read with the row, from L1;
// - the grid is one wave of resident CTAs, each warp striding over rows, and
//   a CTA has fewer warps when R is small, so 512 rows still fill the 132
//   SMs; a decode step's 8 rows are one launch near the launch floor.
//
// The kernel allocates nothing and does not synchronise; the caller passes
// the stream and checks the returned cudaGetLastError().

#include <atomic>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxWarpsPerCta = 8;
constexpr int kStreamBatch = 8;  // chunks in flight a lane when the row is re-read

// Four consecutive elements of T as one load: 16 bytes of f32, 8 of bf16.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  float4 v;
};
template <>
struct Quad<bf16> {
  uint2 v;
};

__device__ __forceinline__ float elem(const Quad<float>& q, int j) {
  return j == 0 ? q.v.x : j == 1 ? q.v.y : j == 2 ? q.v.z : q.v.w;
}
__device__ __forceinline__ float elem(const Quad<bf16>& q, int j) {
  const uint32_t w = j < 2 ? q.v.x : q.v.y;
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));  // bf16 -> f32, exact
}

// Elements base .. base + 3 of a row (base < d); those at or past d read 0
// and are never added or stored.
__device__ __forceinline__ Quad<float> load_quad(const float* __restrict__ p, int base, int d,
                                                 bool vec) {
  Quad<float> q;
  if (vec) {
    q.v = *reinterpret_cast<const float4*>(p + base);
  } else {
    q.v.x = p[base];
    q.v.y = base + 1 < d ? p[base + 1] : 0.f;
    q.v.z = base + 2 < d ? p[base + 2] : 0.f;
    q.v.w = base + 3 < d ? p[base + 3] : 0.f;
  }
  return q;
}
__device__ __forceinline__ Quad<bf16> load_quad(const bf16* __restrict__ p, int base, int d,
                                                bool vec) {
  Quad<bf16> q;
  if (vec) {
    q.v = *reinterpret_cast<const uint2*>(p + base);
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p) + base;
    const uint32_t e0 = h[0], e1 = base + 1 < d ? h[1] : 0u, e2 = base + 2 < d ? h[2] : 0u,
                   e3 = base + 3 < d ? h[3] : 0u;
    q.v = make_uint2(e0 | (e1 << 16), e2 | (e3 << 16));
  }
  return q;
}

__device__ __forceinline__ void store_quad(float* __restrict__ p, int base, int d, bool vec,
                                           const float (&o)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p + base) = make_float4(o[0], o[1], o[2], o[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (base + j < d) p[base + j] = o[j];
}
__device__ __forceinline__ void store_quad(bf16* __restrict__ p, int base, int d, bool vec,
                                           const float (&o)[4]) {
  uint32_t h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __bfloat16_as_ushort(__float2bfloat16_rn(o[j]));
  if (vec) {
    *reinterpret_cast<uint2*>(p + base) = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    return;
  }
  uint16_t* ph = reinterpret_cast<uint16_t*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (base + j < d) ph[base + j] = (uint16_t)h[j];
}

// The lane's first element of chunk k.
__device__ __forceinline__ int chunk_base(int lane, int k) { return 4 * (lane + 32 * k); }

// The row's sum of term(element) in the fixed order; every lane returns it.
// get(k) gives the lane's chunk k: from registers (K > 0), or loaded
// (K == 0, kStreamBatch chunks at a time so their loads are in flight
// together).
template <int K, typename Get, typename Term>
__device__ __forceinline__ float ordered_sum(Get get, Term term, int d, int lane) {
  float s = 0.f;
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int base = chunk_base(lane, k);
      if (base < d) {
        const auto q = get(k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (base + j < d) s = __fadd_rn(s, term(elem(q, j)));
      }
    }
  } else {
    const int nk = (d + 127) / 128;
    for (int k0 = 0; k0 < nk; k0 += kStreamBatch) {
      decltype(get(0)) q[kStreamBatch];
#pragma unroll
      for (int u = 0; u < kStreamBatch; ++u)
        if (chunk_base(lane, k0 + u) < d) q[u] = get(k0 + u);
#pragma unroll
      for (int u = 0; u < kStreamBatch; ++u) {
        const int base = chunk_base(lane, k0 + u);
        if (base < d) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (base + j < d) s = __fadd_rn(s, term(elem(q[u], j)));
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// One chunk of the output: ((x - mu) * r) * w (+ b), each op rounded.
template <bool kLayer, typename T, typename TW>
__device__ __forceinline__ void out_quad(T* __restrict__ yr, int base, int d, bool vy,
                                         const Quad<T>& xq, const Quad<TW>& wq,
                                         const Quad<TW>& bq, float mu, float r) {
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float t = elem(xq, j);
    if (kLayer) t = __fsub_rn(t, mu);
    t = __fmul_rn(__fmul_rn(t, r), elem(wq, j));
    if (kLayer) t = __fadd_rn(t, elem(bq, j));
    o[j] = t;
  }
  store_quad(yr, base, d, vy, o);
}

// x, y: [R, d]; w (and b): [W, d], row r takes weight row r mod W.  flags:
// bit 0 x, 1 w, 2 b, 3 y may use vector loads/stores (d % 4 == 0 and the
// tensor on the vector's boundary).
template <typename T, typename TW, int K, bool kLayer>
__global__ void __launch_bounds__(32 * kMaxWarpsPerCta)
    norm_kernel(const T* __restrict__ x, const TW* __restrict__ w, const TW* __restrict__ b,
                T* __restrict__ y, long long R, int d, long long W, float eps, int flags) {
  const int lane = threadIdx.x & 31;
  const int warps_per_cta = blockDim.x >> 5;
  const long long stride = (long long)gridDim.x * warps_per_cta;
  const bool vx = flags & 1, vw = flags & 2, vb = flags & 4, vy = flags & 8;
  const float n = (float)d;
  constexpr int KR = K > 0 ? K : 1;
  Quad<TW> wq[KR], bq[KR];  // the lane's weight (and bias) chunks, K > 0
  long long held = -1;      // the weight row they hold
  for (long long row = (long long)blockIdx.x * warps_per_cta + (threadIdx.x >> 5); row < R;
       row += stride) {
    const T* xr = x + row * d;
    T* yr = y + row * d;
    const long long wrow = W == 1 ? 0 : row % W;
    const TW* wr = w + wrow * d;
    const TW* br = kLayer ? b + wrow * d : nullptr;
    Quad<T> xq[KR];
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (chunk_base(lane, k) < d) xq[k] = load_quad(xr, chunk_base(lane, k), d, vx);
      if (wrow != held) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (chunk_base(lane, k) < d) {
            wq[k] = load_quad(wr, chunk_base(lane, k), d, vw);
            if (kLayer) bq[k] = load_quad(br, chunk_base(lane, k), d, vb);
          }
        }
        held = wrow;
      }
    }
    auto getx = [&](int k) -> Quad<T> {
      if constexpr (K > 0) {
        return xq[k];
      } else {
        return load_quad(xr, chunk_base(lane, k), d, vx);
      }
    };
    float mu = 0.f, stat;
    if constexpr (kLayer) {
      mu = __fdiv_rn(ordered_sum<K>(getx, [](float v) { return v; }, d, lane), n);
      stat = __fdiv_rn(ordered_sum<K>(
                           getx,
                           [mu](float v) {
                             const float c = __fsub_rn(v, mu);
                             return __fmul_rn(c, c);
                           },
                           d, lane),
                       n);
    } else {
      stat = __fdiv_rn(ordered_sum<K>(getx, [](float v) { return __fmul_rn(v, v); }, d, lane), n);
    }
    const float r = rsqrtf(__fadd_rn(stat, eps));
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (chunk_base(lane, k) < d)
          out_quad<kLayer>(yr, chunk_base(lane, k), d, vy, xq[k], wq[k], bq[k], mu, r);
    } else {
      const int nk = (d + 127) / 128;
      for (int k0 = 0; k0 < nk; k0 += kStreamBatch) {
        Quad<T> xs[kStreamBatch];
        Quad<TW> ws[kStreamBatch], bs[kStreamBatch];
#pragma unroll
        for (int u = 0; u < kStreamBatch; ++u) {
          const int base = chunk_base(lane, k0 + u);
          if (base < d) {
            xs[u] = load_quad(xr, base, d, vx);
            ws[u] = load_quad(wr, base, d, vw);
            if (kLayer) bs[u] = load_quad(br, base, d, vb);
          }
        }
#pragma unroll
        for (int u = 0; u < kStreamBatch; ++u) {
          const int base = chunk_base(lane, k0 + u);
          if (base < d) out_quad<kLayer>(yr, base, d, vy, xs[u], ws[u], bs[u], mu, r);
        }
      }
    }
  }
}

// rsqrtf over n floats: the probe that holds the kernel's rsqrt against
// torch.rsqrt's on the card.
__global__ void rsqrt_probe_kernel(const float* __restrict__ in, float* __restrict__ out,
                                   long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = rsqrtf(in[i]);
}

constexpr int kMaxDevices = repro_kernels::kMaxDevices;

int sm_count() {
  static std::atomic<int> sms[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  int n = sms[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
    sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <typename T, typename TW, int K, bool kLayer>
int launch(const void* x, const void* w, const void* b, void* y, long long R, int d, long long W,
           float eps, int flags, cudaStream_t stream) {
  // warps per CTA from R: 8, or fewer while the CTAs would not cover the SMs
  const int sms = sm_count();
  int wpc = kMaxWarpsPerCta, slot = 3;
  while (wpc > 1 && (R + wpc - 1) / wpc < sms) wpc >>= 1, --slot;
  // CTAs resident on an SM at this size (one query per instantiation and size)
  static std::atomic<int> resident[4];
  int per_sm = resident[slot].load(std::memory_order_relaxed);
  if (per_sm == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, norm_kernel<T, TW, K, kLayer>,
                                                      32 * wpc, 0) !=
            cudaSuccess ||
        per_sm <= 0)
      per_sm = 1;
    resident[slot].store(per_sm, std::memory_order_relaxed);
  }
  long long blocks = (R + wpc - 1) / wpc;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  norm_kernel<T, TW, K, kLayer><<<(unsigned)blocks, 32 * wpc, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TW*>(w), static_cast<const TW*>(b),
      static_cast<T*>(y), R, d, W, eps, flags);
  return (int)cudaGetLastError();
}

template <typename T, typename TW, bool kLayer>
int by_width(const void* x, const void* w, const void* b, void* y, long long R, int d,
             long long W, float eps, int flags, cudaStream_t s) {
  const int nk = (d + 127) / 128;
  if (nk <= 1) return launch<T, TW, 1, kLayer>(x, w, b, y, R, d, W, eps, flags, s);
  if (nk <= 2) return launch<T, TW, 2, kLayer>(x, w, b, y, R, d, W, eps, flags, s);
  if (nk <= 4) return launch<T, TW, 4, kLayer>(x, w, b, y, R, d, W, eps, flags, s);
  if (nk <= 8) return launch<T, TW, 8, kLayer>(x, w, b, y, R, d, W, eps, flags, s);
  if (nk <= 16) return launch<T, TW, 16, kLayer>(x, w, b, y, R, d, W, eps, flags, s);
  return launch<T, TW, 0, kLayer>(x, w, b, y, R, d, W, eps, flags, s);
}

template <typename T, typename TW>
int by_kind(int kind, const void* x, const void* w, const void* b, void* y, long long R, int d,
            long long W, float eps, int flags, cudaStream_t s) {
  return kind == 1 ? by_width<T, TW, true>(x, w, b, y, R, d, W, eps, flags, s)
                   : by_width<T, TW, false>(x, w, b, y, R, d, W, eps, flags, s);
}

}  // namespace

extern "C" {

// x, y: [R, d] contiguous, x's type (x_dtype: 0 f32, 1 bf16); w, b: [W, d]
// contiguous (w_dtype, the same codes; b unused for kind 0), row r takes
// weight row r mod W; kind: 0 rms, 1 layer; flags as norm_kernel's.
// Returns cudaGetLastError() after the launch.
int norm_forward(const void* x, const void* w, const void* b, void* y, long long R, int d,
                 long long W, float eps, int kind, int x_dtype, int w_dtype, int flags,
                 void* stream) {
  if (R <= 0 || d <= 0 || W <= 0 || kind < 0 || kind > 1 || x_dtype < 0 || x_dtype > 1 ||
      w_dtype < 0 || w_dtype > 1 || (kind == 1 && b == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return w_dtype == 0 ? by_kind<float, float>(kind, x, w, b, y, R, d, W, eps, flags, s)
                        : by_kind<float, bf16>(kind, x, w, b, y, R, d, W, eps, flags, s);
  return w_dtype == 0 ? by_kind<bf16, float>(kind, x, w, b, y, R, d, W, eps, flags, s)
                      : by_kind<bf16, bf16>(kind, x, w, b, y, R, d, W, eps, flags, s);
}

// out[i] = rsqrtf(in[i]) for n floats (tests only).
int norm_rsqrt_probe(const float* in, float* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + 255) / 256;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  rsqrt_probe_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
