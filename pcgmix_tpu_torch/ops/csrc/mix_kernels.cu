// Piecewise segment mix kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by pcgmix_tpu_torch/ops/mix_kernels.py.
//
// K1 `pcgmix_piecewise_mix_pairs` replaces the TPU kernel
//    pcgmix_tpu/ops/pallas_mix.py::piecewise_mix_pairs_pallas
//    (pallas_call at :120, body _kernel :52 -> _mix_body :28-49).
// K2 `pcgmix_plus_fused` replaces the TPU kernel
//    pcgmix_tpu/ops/pallas_mix.py::pcgmix_plus_fused_pallas
//    (-> _fused_call :360-391, pallas_call :382, _kernel_fused :220,
//    _fused_epilogue :209-217).
// K3 `pcgmix_piecewise_mix_prepaired` replaces the TPU kernel
//    pcgmix_tpu/ops/pallas_mix.py::piecewise_mix_prepaired_pallas
//    (pallas_call at :193, body _kernel_prepaired :63 -> _mix_body :28-49).
// K4 `pcgmix_plus_fused_prepaired` replaces the TPU kernel
//    pcgmix_tpu/ops/pallas_mix.py::pcgmix_plus_fused_prepaired_pallas
//    (-> _fused_prepaired_call :326-357, pallas_call :348,
//    _kernel_fused_prepaired :230, _fused_epilogue :209-217).
//
// What they compute: output row i mixes a row d1 with a row d2 over K
// pieces (dst, src, len, sel, alpha):
//    out[c,t] = base[c,t]                                      t uncovered
//    out[c,t] = a·base[c,t] + (1−a)·srcrow[c, clamp(t+off)]    t covered
// where a, off = src−dst and sel are summed over the pieces covering t,
// srcrow = d2 if that sum of sel is non-zero else d1, and base = d1 or 0.
// These are the semantics of pcgmix_tpu/ops/piecewise.py::piecewise_mix
// (:70-86), which the engine's disjoint in-range pieces share with the
// Pallas body.  The four kernels differ only in where the rows come from:
//    K1  d1 = data[idx1[i]], d2 = data[idx2[i]]
//    K2  d1 = data[i],       d2 = data[mix[i]],  base = d1, times the warp
//    K3  d1 = d1_rows[i],    d2 = d2_rows[i]     (partners gathered before)
//    K4  as K3,                                  base = d1, times the warp
// The warp is the magnitude-warp envelope Σ_j basis[t,j]·knots[i,j,c]
// (knot+2 = 6 terms on the main path, unrolled fp32 FMAs: no tensor
// cores, so no TF32).  K3 and K4 are the data-parallel path's kernels: a
// rank gathers its rows and its partners' rows from the corpus it holds,
// then mixes them.
//
// The blend uses explicitly rounded fp32 operations (__fmul_rn, __fadd_rn)
// so the compiler cannot contract it into an FMA: the result is then
// bit-equal to the plain PyTorch version, which rounds every operation.
// bf16 rows are widened with __bfloat162float and narrowed once at the
// store with __float2bfloat16 (round to nearest even, as torch's cast).
//
// Bound: all four move bytes, not operations; a blend costs a few
// operations per element.  Main path: N = 64, C = 4, T = 2500, fp32.
// K1/K2 read the batch (2.56 MB) and write the output (2.56 MB), 5.12 MB
// in all (7.68 MB if the partner rows are counted as a second read), plus
// 60 KB of basis and 6 KB of knots for K2: about 1.5 µs at the H100 SXM's
// 3.35 TB/s.  K3/K4 read two separate row buffers (2 × 2.56 MB) and write
// one (2.56 MB), 7.68 MB plus the plan arrays (and K4's basis and knots):
// about 2.3 µs.  At that size launch overhead dominates.
//
// Design: one grid row (blockIdx.y) per output row, so a block reads its
// row's pieces (and the warp's knots) once into shared memory; blocks
// along x cover C·T with neighbouring threads on neighbouring t, so the
// base read, the source window read (contiguous inside a piece) and the
// store are all coalesced.  Rows are read straight from device memory; the
// whole batch fits in the 50 MB L2, so a second read of a row mostly hits
// L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPieces = 32;      // the multi-cycle variant needs 27
constexpr int kMaxWarpTerms = 256;  // (knot+2)·C envelope coefficients
constexpr int kThreads = 256;
constexpr int kItemsPerThread = 4;

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ int clamp_row(int r, int B) {
  return r < 0 ? 0 : (r >= B ? B - 1 : r);
}

// Where a kernel's rows come from: row i of the output reads row idx[i]
// (clamped to [0, rows)) of base, or row i when idx is null.
template <typename T>
struct RowSource {
  const T* base;
  const int* idx;
  int rows;
};

template <typename T, bool kBaseIsD1, bool kWarp>
__global__ void __launch_bounds__(kThreads) mix_kernel(
    RowSource<T> src1, RowSource<T> src2, T* __restrict__ out,
    const int* __restrict__ dst, const int* __restrict__ src,
    const int* __restrict__ len, const int* __restrict__ sel,
    const float* __restrict__ alpha,
    const float* __restrict__ knots,  // (N, K2, C), warp only
    const float* __restrict__ basis,  // (T, K2), warp only
    int C, int Tlen, int K, int K2) {
  __shared__ int s_start[kMaxPieces];
  __shared__ int s_end[kMaxPieces];
  __shared__ int s_off[kMaxPieces];
  __shared__ int s_sel[kMaxPieces];
  __shared__ float s_alpha[kMaxPieces];
  __shared__ float s_knots[kWarp ? kMaxWarpTerms : 1];

  const int row = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int d = dst[row * K + k];
    s_start[k] = d;
    s_end[k] = d + len[row * K + k];
    s_off[k] = src[row * K + k] - d;
    s_sel[k] = sel[row * K + k];
    s_alpha[k] = alpha[row * K + k];
  }
  if constexpr (kWarp) {
    for (int j = threadIdx.x; j < K2 * C; j += blockDim.x) {
      s_knots[j] = knots[(int64_t)row * K2 * C + j];
    }
  }
  __syncthreads();

  const int64_t row_len = (int64_t)C * Tlen;
  const int r1 = src1.idx == nullptr ? row : clamp_row(src1.idx[row], src1.rows);
  const int r2 = src2.idx == nullptr ? row : clamp_row(src2.idx[row], src2.rows);
  const T* __restrict__ d1 = src1.base + (int64_t)r1 * row_len;
  const T* __restrict__ d2 = src2.base + (int64_t)r2 * row_len;
  T* o = out + (int64_t)row * row_len;

  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < row_len;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(e / Tlen);
    const int t = (int)(e - (int64_t)c * Tlen);
    bool covered = false;
    float a = 0.f;
    int off = 0;
    int sl = 0;
    for (int k = 0; k < K; ++k) {
      if (t >= s_start[k] && t < s_end[k]) {
        covered = true;
        a = __fadd_rn(a, s_alpha[k]);
        off += s_off[k];
        sl += s_sel[k];
      }
    }
    float base = 0.f;
    if constexpr (kBaseIsD1) base = load_f32(d1, e);
    float v = base;
    if (covered) {
      int ti = t + off;
      ti = ti < 0 ? 0 : (ti >= Tlen ? Tlen - 1 : ti);
      const float s = load_f32(sl != 0 ? d2 : d1, (int64_t)c * Tlen + ti);
      v = __fadd_rn(__fmul_rn(a, base), __fmul_rn(__fsub_rn(1.f, a), s));
    }
    if constexpr (kWarp) {
      const float* brow = basis + (int64_t)t * K2;
      float w = 0.f;
      for (int j = 0; j < K2; ++j) {
        w = fmaf(brow[j], s_knots[j * C + c], w);
      }
      v = __fmul_rn(v, w);
    }
    store_f32(o, e, v);
  }
}

dim3 grid_for(int N, int C, int Tlen) {
  const int64_t row_len = (int64_t)C * Tlen;
  const int64_t per_block = (int64_t)kThreads * kItemsPerThread;
  return dim3((unsigned)((row_len + per_block - 1) / per_block), (unsigned)N);
}

// One launch of any of the four kernels; knots == nullptr means no warp.
template <typename T>
void launch(RowSource<T> s1, RowSource<T> s2, void* out, const int* dst,
            const int* src, const int* len, const int* sel,
            const float* alpha, const float* knots, const float* basis,
            int N, int C, int Tlen, int K, int K2, int base_is_d1,
            cudaStream_t stream) {
  const dim3 grid = grid_for(N, C, Tlen);
  T* o = (T*)out;
  if (knots != nullptr) {
    mix_kernel<T, true, true><<<grid, kThreads, 0, stream>>>(
        s1, s2, o, dst, src, len, sel, alpha, knots, basis, C, Tlen, K, K2);
  } else if (base_is_d1) {
    mix_kernel<T, true, false><<<grid, kThreads, 0, stream>>>(
        s1, s2, o, dst, src, len, sel, alpha, nullptr, nullptr, C, Tlen, K, 0);
  } else {
    mix_kernel<T, false, false><<<grid, kThreads, 0, stream>>>(
        s1, s2, o, dst, src, len, sel, alpha, nullptr, nullptr, C, Tlen, K, 0);
  }
}

// Dispatch on dtype_code (0 = float32, 1 = bfloat16); returns
// cudaGetLastError() after the launch (0 = launched).
int dispatch(const void* base1, const int* idx1, int rows1, const void* base2,
             const int* idx2, int rows2, void* out, const int* dst,
             const int* src, const int* len, const int* sel,
             const float* alpha, const float* knots, const float* basis,
             int N, int C, int Tlen, int K, int K2, int base_is_d1,
             int dtype_code, void* stream) {
  const bool warp = knots != nullptr;
  if (rows1 <= 0 || rows2 <= 0 || N <= 0 || N > 65535 || C <= 0 ||
      Tlen <= 0 || K < 0 || K > kMaxPieces ||
      (warp && (K2 <= 0 || K2 * C > kMaxWarpTerms || basis == nullptr)) ||
      (dtype_code != 0 && dtype_code != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype_code == 0) {
    launch<float>({(const float*)base1, idx1, rows1},
                  {(const float*)base2, idx2, rows2}, out, dst, src, len, sel,
                  alpha, knots, basis, N, C, Tlen, K, K2, base_is_d1, s);
  } else {
    using bf16 = __nv_bfloat16;
    launch<bf16>({(const bf16*)base1, idx1, rows1},
                 {(const bf16*)base2, idx2, rows2}, out, dst, src, len, sel,
                 alpha, knots, basis, N, C, Tlen, K, K2, base_is_d1, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: data (B, C, T); idx1 may be NULL (identity).
int pcgmix_piecewise_mix_pairs(const void* data, void* out, const int* idx1,
                               const int* idx2, const int* dst,
                               const int* src, const int* len, const int* sel,
                               const float* alpha, int B, int N, int C,
                               int Tlen, int K, int base_is_d1, int dtype_code,
                               void* stream) {
  return dispatch(data, idx1, B, data, idx2, B, out, dst, src, len, sel,
                  alpha, nullptr, nullptr, N, C, Tlen, K, 0, base_is_d1,
                  dtype_code, stream);
}

// K2: data (B, C, T); knots (B, K2, C); basis (T, K2).
int pcgmix_plus_fused(const void* data, void* out, const int* mix,
                      const int* dst, const int* src, const int* len,
                      const int* sel, const float* alpha, const float* knots,
                      const float* basis, int B, int C, int Tlen, int K,
                      int K2, int dtype_code, void* stream) {
  if (knots == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(data, nullptr, B, data, mix, B, out, dst, src, len, sel,
                  alpha, knots, basis, B, C, Tlen, K, K2, 1, dtype_code,
                  stream);
}

// K3: d1_rows, d2_rows (N, C, T).
int pcgmix_piecewise_mix_prepaired(const void* d1_rows, const void* d2_rows,
                                   void* out, const int* dst, const int* src,
                                   const int* len, const int* sel,
                                   const float* alpha, int N, int C, int Tlen,
                                   int K, int base_is_d1, int dtype_code,
                                   void* stream) {
  return dispatch(d1_rows, nullptr, N, d2_rows, nullptr, N, out, dst, src,
                  len, sel, alpha, nullptr, nullptr, N, C, Tlen, K, 0,
                  base_is_d1, dtype_code, stream);
}

// K4: d1_rows, d2_rows (N, C, T); knots (N, K2, C); basis (T, K2).
int pcgmix_plus_fused_prepaired(const void* d1_rows, const void* d2_rows,
                                void* out, const int* dst, const int* src,
                                const int* len, const int* sel,
                                const float* alpha, const float* knots,
                                const float* basis, int N, int C, int Tlen,
                                int K, int K2, int dtype_code, void* stream) {
  if (knots == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch(d1_rows, nullptr, N, d2_rows, nullptr, N, out, dst, src,
                  len, sel, alpha, knots, basis, N, C, Tlen, K, K2, 1,
                  dtype_code, stream);
}

int pcgmix_max_pieces(void) { return kMaxPieces; }
int pcgmix_max_warp_terms(void) { return kMaxWarpTerms; }

}  // extern "C"
