// K5: k=3 'same' 1-D convolution fused with BatchNorm's per-channel
// statistics, for Hopper (sm_90a), with a plain C interface loaded through
// ctypes by pcgmix_tpu_torch/ops/conv_bn.py.
//
// `pcgmix_conv3_bn_stats` replaces the TPU kernel of
//    scripts/bench_conv_bn_fused.py::make_arms (pallas_call :97, body
//    _kernel :49-69; pallas_call_flat :118, body _kernel_flat :71-95).
// Both Pallas variants compute one function and differ only in the TPU's
// block shape; this kernel replaces both.
//
// What it computes, in the JAX layout: x (B, T, Cin) bf16 (NWC), w (3, Cin,
// Cout) bf16 (WIO),
//    acc[b,t,:] = x[b,t-1]·w[0] + x[b,t]·w[1] + x[b,t+1]·w[2]   (fp32)
// with rows outside [0, T) of each sample zero (per-sample 'same' padding);
// y = bf16(acc), rounded to nearest even once; and, with stats,
//    s1[n] = Σ_{b,t} acc[b,t,n],   s2[n] = Σ_{b,t} acc[b,t,n]²   (fp32)
// from the fp32 accumulator, not from the rounded y, as the Pallas kernel
// sums them (:68-69, :94-95).
//
// Design: an implicit GEMM, M = B·T rows of y, N = Cout, K = 3·Cin.  A
// block owns a 128 × 64 tile of y and loops over (tap, 32-channel chunk of
// Cin): it stages the A tile (x rows shifted by the tap, zero where t±1
// leaves the sample or a row or channel lies past the edge) and the
// matching w[tap] tile in shared memory, and its four warps multiply them
// on the tensor cores (nvcuda::wmma, bf16 in, fp32 accumulate), each warp
// a 64 × 32 sub-tile.  The epilogue goes through shared memory: it stores
// y coalesced and, with stats, sums acc and acc² over the tile's valid rows
// per column.  The Pallas kernel carries its sums across grid steps in
// order (pl.when(g == 0) init); CUDA blocks run in parallel, so each row
// tile writes its partial sums to an fp32 scratch (row_tiles × 2 × Cout)
// and a second small kernel adds them in row-tile order: deterministic,
// unlike atomicAdd.
//
// Bound, on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): res2a
// 64×312×512→512 does 31.4 GFLOP over 42.5 MB, 739 FLOP/B, so it is bound
// by the tensor cores (31.8 µs); conv3 64×1250×128→256 does 15.7 GFLOP over
// 61.6 MB, 255 FLOP/B, under the ~295 ridge, so it is bound by bytes
// (18.4 µs).  This first kernel is simple: synchronous loads, no pipeline,
// mma.sync-class wmma rather than wgmma, and x rows read three times (once
// per tap, mostly from L2).  wgmma, TMA and a ring of stages are the next
// step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // rows of y per block
constexpr int kBN = 64;   // columns of y per block
constexpr int kBK = 32;   // input channels per stage
constexpr int kThreads = 128;  // 4 warps, 2 × 2, each 64 × 32 of the tile
constexpr int kLdA = kBK + 8;  // padded leading dimensions (elements)
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;
constexpr int kBytesA = kBM * kLdA * 2;
constexpr int kBytesB = kBK * kLdB * 2;
constexpr int kBytesC = kBM * kLdC * 4;
// the A and B tiles and the fp32 epilogue tile share one buffer
constexpr int kSmem = kBytesC > kBytesA + kBytesB ? kBytesC : kBytesA + kBytesB;

// Eight bf16 from src[0..8) into dst, zero where !ok or past `limit`
// elements; 16-byte loads when kVec (every group of 8 in or out whole).
template <bool kVec>
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, bool ok,
                                       int limit) {
  if constexpr (kVec) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (ok && limit > 0) v = *reinterpret_cast<const uint4*>(src);
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    for (int e = 0; e < 8; ++e) {
      dst[e] = (ok && e < limit) ? src[e] : __float2bfloat16(0.f);
    }
  }
}

template <bool kVecA, bool kVecB, bool kStats>
__global__ void __launch_bounds__(kThreads) conv3_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    bf16* __restrict__ y, float* __restrict__ partial, int64_t M, int T,
    int Cin, int Cout) {
  __shared__ __align__(128) unsigned char smem[kSmem];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + kBytesA);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A staging: 4 passes of 32 rows, 4 threads per row, 8 channels each
  const int a_col = (tid % 4) * 8;
  int a_t[4];
  bool a_in[4];
  for (int p = 0; p < 4; ++p) {
    const int64_t m = m0 + p * 32 + tid / 4;
    a_in[p] = m < M;
    a_t[p] = a_in[p] ? (int)(m % T) : 0;
  }
  // B staging: 2 passes of 16 rows, 8 threads per row, 8 columns each
  const int b_col = (tid % 8) * 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int tap = 0; tap < 3; ++tap) {
    for (int c0 = 0; c0 < Cin; c0 += kBK) {
      __syncthreads();  // the previous stage has been consumed
      for (int p = 0; p < 4; ++p) {
        const int r = p * 32 + tid / 4;
        const int ts = a_t[p] + tap - 1;  // source time step in the sample
        const bool ok = a_in[p] && ts >= 0 && ts < T;
        const bf16* src = ok ? x + (m0 + r + tap - 1) * Cin + c0 + a_col : x;
        stage8<kVecA>(sA + r * kLdA + a_col, src, ok, Cin - c0 - a_col);
      }
      for (int p = 0; p < 2; ++p) {
        const int r = p * 16 + tid / 8;
        const bool ok = c0 + r < Cin;
        const bf16* src =
            ok ? w + ((int64_t)tap * Cin + c0 + r) * Cout + n0 + b_col : w;
        stage8<kVecB>(sB + r * kLdB + b_col, src, ok, Cout - n0 - b_col);
      }
      __syncthreads();
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
        for (int i = 0; i < 4; ++i)
          wmma::load_matrix_sync(a[i], sA + (wm * 64 + i * 16) * kLdA + kk, kLdA);
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], sB + kk * kLdB + wn * 32 + j * 16, kLdB);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
  }

  __syncthreads();  // the last stage has been consumed: reuse the buffer
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm * 64 + i * 16) * kLdC + wn * 32 + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();

  // neighbouring threads on neighbouring columns: coalesced stores of y
  const int c = tid % kBN;
  const int n = n0 + c;
  float s1 = 0.f, s2 = 0.f;
  if (n < Cout) {
    for (int r = tid / kBN; r < kBM; r += kThreads / kBN) {
      const int64_t m = m0 + r;
      if (m >= M) break;
      const float v = sC[r * kLdC + c];
      y[m * Cout + n] = __float2bfloat16(v);  // round to nearest even
      if constexpr (kStats) {
        s1 += v;
        s2 = fmaf(v, v, s2);
      }
    }
  }
  if constexpr (kStats) {
    __syncthreads();  // every thread has read its part of sC
    sC[tid] = s1;
    sC[kThreads + tid] = s2;
    __syncthreads();
    if (tid < kBN && n < Cout) {
      float* row = partial + (int64_t)blockIdx.x * 2 * Cout;
      row[n] = sC[tid] + sC[tid + kBN];
      row[Cout + n] = sC[kThreads + tid] + sC[kThreads + tid + kBN];
    }
  }
}

// s1[n], s2[n]: the row tiles' partial sums added in row-tile order.
__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ s1,
                                    float* __restrict__ s2, int tiles,
                                    int Cout) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= Cout) return;
  float a = 0.f, b = 0.f;
  for (int t = 0; t < tiles; ++t) {
    a += partial[(int64_t)t * 2 * Cout + n];
    b += partial[(int64_t)t * 2 * Cout + Cout + n];
  }
  s1[n] = a;
  s2[n] = b;
}

template <bool kVecA, bool kVecB>
void launch_conv(dim3 grid, bool stats, const bf16* x, const bf16* w, bf16* y,
                 float* partial, int64_t M, int T, int Cin, int Cout,
                 cudaStream_t s) {
  if (stats) {
    conv3_kernel<kVecA, kVecB, true><<<grid, kThreads, 0, s>>>(
        x, w, y, partial, M, T, Cin, Cout);
  } else {
    conv3_kernel<kVecA, kVecB, false><<<grid, kThreads, 0, s>>>(
        x, w, y, nullptr, M, T, Cin, Cout);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// x (B, T, Cin), w (3, Cin, Cout), y (B, T, Cout), all bf16 and contiguous;
// with_stats: partial (ceil(B·T / 128), 2, Cout), s1, s2 (Cout,) fp32.
// Returns cudaGetLastError() after the launches (0 = launched).
int pcgmix_conv3_bn_stats(const void* x, const void* w, void* y, void* partial,
                          void* s1, void* s2, int B, int T, int Cin, int Cout,
                          int with_stats, void* stream) {
  const int64_t M = (int64_t)B * T;
  const int64_t tiles = (M + kBM - 1) / kBM;
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || tiles > 0x7fffffff ||
      (Cout + kBN - 1) / kBN > 65535 ||
      (with_stats && (partial == nullptr || s1 == nullptr || s2 == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)tiles, (unsigned)((Cout + kBN - 1) / kBN));
  const bool vec_a = Cin % 8 == 0 && aligned16(x);
  const bool vec_b = Cout % 8 == 0 && aligned16(w);
  const bf16* xb = (const bf16*)x;
  const bf16* wb = (const bf16*)w;
  bf16* yb = (bf16*)y;
  float* pb = (float*)partial;
  if (vec_a && vec_b) {
    launch_conv<true, true>(grid, with_stats, xb, wb, yb, pb, M, T, Cin, Cout, s);
  } else if (vec_a) {
    launch_conv<true, false>(grid, with_stats, xb, wb, yb, pb, M, T, Cin, Cout, s);
  } else if (vec_b) {
    launch_conv<false, true>(grid, with_stats, xb, wb, yb, pb, M, T, Cin, Cout, s);
  } else {
    launch_conv<false, false>(grid, with_stats, xb, wb, yb, pb, M, T, Cin, Cout, s);
  }
  if (with_stats) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    stats_reduce_kernel<<<(Cout + 127) / 128, 128, 0, s>>>(
        pb, (float*)s1, (float*)s2, (int)tiles, Cout);
  }
  return (int)cudaGetLastError();
}

int pcgmix_conv3_row_tile(void) { return kBM; }

}  // extern "C"
