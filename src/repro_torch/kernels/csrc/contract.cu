// The recurrences' f32 contractions, row-invariant, written for Hopper (sm_90a).
//
//   y[r, j] = sum_k x[r, k] * W[w(r), k, j],   w(r) = (r / div) % mod
//
// x: R rows of K floats; W: a stack of [K, J] float matrices addressed through
// strides; y: [R, J] floats, contiguous.  w(r) picks a row's matrix: one per
// row (div 1, mod R: the mLSTM's C and n), one per head (div 1, mod nh: the
// sLSTM's recurrent matrices), one per batch row (div = the rows a batch row
// has: the SSM's C_t) or one shared matrix (mod 1: the SSM's dt projection).
//
// Replaces no TPU kernel: the reference runs these contractions as jnp.einsum
// / @ in XLA (src/repro/models/xlstm.py:77-78 and :191, src/repro/models/
// ssm.py:72 and :119).  The port ran them on cuBLAS, which picks another
// kernel (split-K among them) as the batch count grows, so a row's bits
// depended on the rows beside it.  Here every output element sums its K
// products from k = 0 upward into one f32 accumulator, each product and each
// sum rounded on its own (__fmul_rn, then __fadd_rn: nvcc contracts nothing
// into an FMA), with no split of K at any R.  So row r's bits depend on x's
// row r and W[w(r)] alone: not on R, the tile, the grid, or which kernel of
// the two below takes it.  The order is written out in torch ops as
// kernels/contract.py's ordered_contract, which the card tests hold this
// kernel to bitwise.
//
// What bounds it on the card: the bytes of W where every row has its own
// matrix (the mLSTM's 256 x 256 C a row and head: 256 KB read once, 2 flops
// a 4-byte element), the output's bytes or the f32 operations elsewhere.
// The design, simple first:
// - contract_cols (J > 1): a CTA of 128 threads, thread j owning output column
//   j0 + j, takes a tile of up to RT rows that share one matrix (the rows of
//   matrix w, enumerated in order: w's blocks of div consecutive rows, every
//   mod-th block), stages their x in shared memory 256 k at a time, and walks
//   k reading W[w, k, j0:j0 + 128] once for the whole tile: coalesced where
//   W's columns are contiguous, and each W element serves RT rows;
// - contract_rows (J == 1: the mLSTM's n, the SSM's C_t): a thread owns a row
//   and walks its k in the same order;
// - RT is 1, 4 or 16 from the rows a matrix has, so a per-row matrix does
//   not stage 15 empty rows.
//
// The kernels allocate nothing and do not synchronise; the caller passes the
// stream and checks the returned cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // threads, and output columns, of a contract_cols CTA
constexpr int kKc = 256;    // k staged in shared memory at a time
constexpr int kRowsCta = 128;  // rows of a contract_rows CTA

// Row r's first element in x: rows in two levels, r = r1 * xn0 + r0 at
// r1 * xs1 + r0 * xs0 (one level when xn0 >= R).
__device__ __forceinline__ long long x_offset(long long r, long long xn0, long long xs0,
                                              long long xs1) {
  return (r / xn0) * xs1 + (r % xn0) * xs0;
}

template <int RT>
__global__ void __launch_bounds__(kCols)
    contract_cols(const float* __restrict__ x, const float* __restrict__ W, float* __restrict__ y,
                  long long R, int K, int J, long long div, long long mod, long long tiles,
                  long long xn0, long long xs0, long long xs1, long long sw, long long sk,
                  long long sj) {
  // [k][row]: the tile's x, kKc k at a time (a row padded by one float, so the
  // staging writes of consecutive k fall in different banks)
  __shared__ float xs[kKc][RT == 1 ? 1 : RT + 1];
  const long long w = (long long)blockIdx.x / tiles;
  const long long i0 = ((long long)blockIdx.x % tiles) * RT;  // the tile's first row of matrix w
  const int j = blockIdx.y * kCols + threadIdx.x;
  // row i of matrix w: block i / div of w's blocks (every mod-th), offset i % div
  auto row = [&](int u) -> long long {
    const long long i = i0 + u;
    return (i / div) * mod * div + w * div + i % div;
  };
  auto valid = [&](int u) { return row(u) < R; };  // past w's last row, or the ragged end
  float acc[RT];
#pragma unroll
  for (int u = 0; u < RT; ++u) acc[u] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKc) {
    const int kc = min(kKc, K - k0);
    for (int e = threadIdx.x; e < kc * RT; e += kCols) {
      const int u = e / kc, k = e % kc;  // consecutive threads read consecutive k of a row
      xs[k][u] = valid(u) ? x[x_offset(row(u), xn0, xs0, xs1) + k0 + k] : 0.f;
    }
    __syncthreads();
    if (j < J) {
      const float* wk = W + w * sw + (long long)j * sj + (long long)k0 * sk;
#pragma unroll 8
      for (int k = 0; k < kc; ++k) {
        const float wv = wk[(long long)k * sk];
#pragma unroll
        for (int u = 0; u < RT; ++u) acc[u] = __fadd_rn(acc[u], __fmul_rn(xs[k][u], wv));
      }
    }
    __syncthreads();
  }
  if (j >= J) return;
#pragma unroll
  for (int u = 0; u < RT; ++u)
    if (valid(u)) y[row(u) * J + j] = acc[u];
}

__global__ void __launch_bounds__(kRowsCta)
    contract_rows(const float* __restrict__ x, const float* __restrict__ W, float* __restrict__ y,
                  long long R, int K, long long div, long long mod, long long xn0, long long xs0,
                  long long xs1, long long sw, long long sk) {
  const long long r = (long long)blockIdx.x * kRowsCta + threadIdx.x;
  if (r >= R) return;
  const float* xr = x + x_offset(r, xn0, xs0, xs1);
  const float* wm = W + ((r / div) % mod) * sw;
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(xr[k], wm[(long long)k * sk]));
  y[r] = acc;
}

template <int RT>
int launch_cols(const float* x, const float* W, float* y, long long R, int K, int J, long long div,
                long long mod, long long xn0, long long xs0, long long xs1, long long sw,
                long long sk, long long sj, long long per_w, cudaStream_t s) {
  const long long blocks_of_rows = (R + div - 1) / div;
  const long long matrices = blocks_of_rows < mod ? blocks_of_rows : mod;
  const long long tiles = (per_w + RT - 1) / RT;
  const long long gx = matrices * tiles;
  const long long gy = (J + kCols - 1) / kCols;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  contract_cols<RT><<<dim3((unsigned)gx, (unsigned)gy), kCols, 0, s>>>(
      x, W, y, R, K, J, div, mod, tiles, xn0, xs0, xs1, sw, sk, sj);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y [R, J] contiguous = x [R, K] (rows at x_offset, k contiguous) times
// W[w(r)] (element (k, j) of matrix w at w * sw + k * sk + j * sj), w(r) =
// (r / div) % mod.  Returns cudaGetLastError() after the launch.
int contract_forward(const float* x, const float* W, float* y, long long R, int K, int J,
                     long long div, long long mod, long long xn0, long long xs0, long long xs1,
                     long long sw, long long sk, long long sj, void* stream) {
  if (R <= 0 || K <= 0 || J <= 0 || div <= 0 || mod <= 0 || xn0 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (J == 1) {
    const long long blocks = (R + kRowsCta - 1) / kRowsCta;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    contract_rows<<<(unsigned)blocks, kRowsCta, 0, s>>>(x, W, y, R, K, div, mod, xn0, xs0, xs1,
                                                        sw, sk);
    return (int)cudaGetLastError();
  }
  // the most rows one matrix has: its blocks of div rows, every mod-th
  const long long blocks_of_rows = (R + div - 1) / div;
  const long long per_w = (blocks_of_rows + mod - 1) / mod * div;
  if (per_w <= 1)
    return launch_cols<1>(x, W, y, R, K, J, div, mod, xn0, xs0, xs1, sw, sk, sj, per_w, s);
  if (per_w <= 4)
    return launch_cols<4>(x, W, y, R, K, J, div, mod, xn0, xs0, xs1, sw, sk, sj, per_w, s);
  return launch_cols<16>(x, W, y, R, K, J, div, mod, xn0, xs0, xs1, sw, sk, sj, per_w, s);
}

}  // extern "C"
