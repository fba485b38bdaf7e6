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
// Pallas body.  The four differ only in where the rows come from:
//    K1  d1 = data[idx1[i]], d2 = data[idx2[i]]   (no idx1: d1 = data[i])
//    K2  d1 = data[i],       d2 = data[mix[i]],  base = d1, times the warp
//    K3  d1 = d1_rows[i],    d2 = d2_rows[i]     (partners gathered before)
//    K4  as K3,                                  base = d1, times the warp
// The warp is the magnitude-warp envelope Σ_j basis[t,j]·knots[i,j,c]
// (knot+2 = 6 terms on the main path, unrolled fp32 FMAs: no tensor
// cores, so no TF32).  K3 and K4 are the data-parallel path's kernels: a
// rank gathers its rows and its partners' rows from the corpus it holds,
// then mixes them.
//
// Bound: all four move bytes, not operations; a blend costs a few
// operations per element.  Main path: N = 64, C = 4, T = 2500, fp32.
// K1/K2 read the batch (2.56 MB) and write the output (2.56 MB), 5.12 MB
// in all (7.68 MB if the partner rows are counted as a second read), plus
// 60 KB of basis and 6 KB of knots for K2: about 1.5 µs at the H100 SXM's
// 3.35 TB/s.  K3/K4 read two separate row buffers (2 × 2.56 MB) and write
// one (2.56 MB), 7.68 MB plus the plan arrays (and K4's basis and knots):
// about 2.3 µs.  One launch costs about as much as K2's whole bound.
//
// All four are one kernel body, `mix_warp_kernel<T, V, kWarp, kBaseIsD1>`:
// kWarp multiplies by the envelope (K2/K4; without it nothing of the
// envelope is loaded or computed), kBaseIsD1 picks the base (K1/K3 take
// either; with base 0 the base row is never loaded and d1 is read only as
// a source).  The first port's kernel, a grid-stride loop over C·T,
// reached 12–18 % of these bounds (0.010–0.013 ms).  That time is device
// time (the timing queues its launches behind a device sleep), so what
// held it was latency: each thread waited on a chain of dependent round
// trips to memory.
//   1. A grid-stride loop of four single elements per thread over C·T.
//   2. The plan went to shared memory, then a barrier, and only then were
//      the row indices read: two round trips before the first load of data.
//   3. `out` was not __restrict__, so no load of the next iteration could
//      move above this iteration's store: the four ran one after another.
//   4. A 64-bit division e / T per element.
//   5. Six basis values per element (the warp), read from device memory,
//      24 bytes apart between neighbouring threads.
//   6. Scalar 4-byte loads and stores only.
// What this kernel does about each:
//   1. One block per (output row, tile of kWarpThreads·V steps) covering
//      all C channels; each thread owns V consecutive steps, 16 bytes (V = 4
//      in fp32, 8 in bf16), in every channel.  t comes from the block and
//      thread indices and c from a loop over channels: no grid-stride loop.
//      128 threads × 4 = 512 steps per tile gives 5 × 64 = 320 blocks at
//      N = 64, T = 2500 fp32, about 2.4 per SM of the 132, all resident at
//      once (at 128 registers a thread, the warp's instantiation, 4 blocks
//      fit an SM: 528 places), so the whole batch is in flight in one wave.
//   2. One prologue round trip: each piece's five values (thread k loads
//      piece k), the row's knots (every thread) and the row indices (the
//      last thread) go to shared memory; then one barrier, then the loads
//      of data, the source loads needing the offsets, selectors and
//      partner row.  K2/K4 issue the loads that depend on nothing in the
//      plan (the base row's first kChannelGroup channels and the thread's
//      basis rows) before the barrier, beside the plan's.  K1/K3 issue the
//      base row after it, beside the source loads: early base loads are
//      not free, since the plan's loads, which the barrier waits on, queue
//      behind them.  On an H100 SXM (700 W) K1 at the main shape took 3.15
//      µs with its base row issued before the plan's loads, 3.10 after
//      them and 2.86 after the barrier (profiler kernel time).  So K1
//      called with an explicit idx1 (the concat family, idx1[row] loaded
//      beside the partner index) costs no more than the main path's K1,
//      which passes none.
//      These are per-thread loads, not Hopper's bulk copy: the plan arrays
//      are a few dozen bytes at offsets row·K·4 that are not 16-byte
//      aligned, and padding them in the wrapper would add a copy per step,
//      while per-thread loads already issue in the same round as the data.
//   3. __restrict__ on every pointer, `out` included; every read goes
//      through the non-coherent path (__ldg).
//   4. No division: the thread's steps are t0 .. t0+V−1 in every channel.
//   5. The basis in registers: the wrapper pads it to (T, K2 rounded up to
//      kBasisChunk) with zero columns, so one step's chunk of 8 columns is
//      two 16-byte loads at any V; a thread loads its V rows once (K2 ≤ 8,
//      knot ≤ 6: one chunk; more knots take further chunks) and uses them
//      for every channel, and reads the knots from shared memory.  More
//      than kChannelGroup channels are taken a group at a time.  Tensor
//      cores do not fit this product: K2 is 6, and TF32, their fp32 path,
//      keeps 10 mantissa bits, which breaks the 1e-5 bar on an envelope
//      near 1.
//   6. The base row is read and the output written as 16-byte vectors; the
//      source loads stay scalar, but are coalesced, since t + off is
//      contiguous inside a piece.
// Edges: the vector path needs T % V == 0 and every row on a 16-byte
// boundary; the wrapper also wants T ≥ kWarpThreads·V, since a short row's
// one wide tile leaves most of its block idle.  Otherwise the wrapper
// (`mix_kernels.py::_warp_vector_width`) takes the V = 1 instantiation of
// the same kernel (T = 509, T = 1, a bf16 row of odd length, an offset
// view, ResNet9's 312-step latent).  In a last partial tile the threads
// past T take part in the barrier and store nothing.
//
// The blend uses explicitly rounded fp32 operations (__fmul_rn, __fadd_rn)
// so the compiler cannot contract it into an FMA: K1/K3 are then bit-equal
// to the plain PyTorch version, which rounds every operation.  The
// envelope is a chain of fp32 FMAs over j in order, the same in every
// instantiation, so K3 on gathered partners is bit-equal to K1, K4 to K2,
// and V = 1 to V = vec.  bf16 rows are widened exactly on load and
// narrowed once at the store with round to nearest even, as torch's cast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPieces = 32;      // the multi-cycle variant needs 27
constexpr int kMaxWarpTerms = 256;  // (knot+2)·C envelope coefficients
constexpr int kWarpThreads = 128;   // threads per block
constexpr int kChannelGroup = 4;    // channels a thread holds at once
constexpr int kBasisChunk = 8;      // basis columns a thread holds at once
static_assert(kMaxPieces <= kWarpThreads, "one thread loads each piece");

// bf16 → fp32 is exact: the 16 bits become the top of the fp32 word
__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float ldg_f32(const float* __restrict__ p, int64_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* __restrict__ p,
                                         int64_t i) {
  return bf16_bits_to_f32(__ldg(reinterpret_cast<const unsigned short*>(p) + i));
}

// V consecutive elements, widened to fp32: one 16-byte load, or one element
template <int V>
__device__ __forceinline__ void load_steps(const float* __restrict__ p,
                                           float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else {
    static_assert(V == 4, "16 bytes of fp32");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
}
template <int V>
__device__ __forceinline__ void load_steps(const __nv_bfloat16* __restrict__ p,
                                           float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = ldg_f32(p, 0);
  } else {
    static_assert(V == 8, "16 bytes of bf16");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower address is the low half
      v[2 * i] = bf16_bits_to_f32(w[i] & 0xffffu);
      v[2 * i + 1] = bf16_bits_to_f32(w[i] >> 16);
    }
  }
}

template <int V>
__device__ __forceinline__ void store_steps(float* __restrict__ p,
                                            const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}
template <int V>
__device__ __forceinline__ void store_steps(__nv_bfloat16* __restrict__ p,
                                            const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = __float2bfloat16(v[0]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(v[2 * i + 1])) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Columns j0 .. j0+kBasisChunk−1 of the basis rows t0 .. t0+V−1; a row of
// the padded basis is kb floats, a multiple of kBasisChunk, so every load
// is a 16-byte vector
template <int V>
__device__ __forceinline__ void load_basis(const float* __restrict__ basis,
                                           int t0, int kb, int j0,
                                           float (&b)[V][kBasisChunk]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float4* q =
        reinterpret_cast<const float4*>(basis + (int64_t)(t0 + v) * kb + j0);
#pragma unroll
    for (int h = 0; h < kBasisChunk / 4; ++h) {
      const float4 f = __ldg(q + h);
      b[v][4 * h] = f.x;
      b[v][4 * h + 1] = f.y;
      b[v][4 * h + 2] = f.z;
      b[v][4 * h + 3] = f.w;
    }
  }
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

// Channels c0 .. c0+kChannelGroup−1 (those below C) of steps t0 .. t0+V−1
template <typename T, int V>
__device__ __forceinline__ void load_group(const T* __restrict__ row, int c0,
                                           int C, int Tlen, int t0,
                                           float (&x)[kChannelGroup][V]) {
#pragma unroll
  for (int g = 0; g < kChannelGroup; ++g) {
    if (c0 + g < C) load_steps<V>(row + (int64_t)(c0 + g) * Tlen + t0, x[g]);
  }
}

// K1–K4: output row i blends its row from src1 with its partner row from
// src2 over its pieces (base d1, or 0 without kBaseIsD1) and, with kWarp,
// multiplies by the envelope; V steps per thread (see the note above).
// src1.idx is read only without kWarp (K2/K4 take row i).
template <typename T, int V, bool kWarp, bool kBaseIsD1>
__global__ void __launch_bounds__(kWarpThreads) mix_warp_kernel(
    RowSource<T> src1, RowSource<T> src2, T* __restrict__ out,
    const int* __restrict__ dst, const int* __restrict__ src,
    const int* __restrict__ len, const int* __restrict__ sel,
    const float* __restrict__ alpha,
    const float* __restrict__ knots,  // (N, K2, C), kWarp only
    const float* __restrict__ basis,  // (T, kb): K2 columns, then zeros; kWarp only
    int C, int Tlen, int K, int K2) {
  __shared__ int s_start[kMaxPieces];
  __shared__ int s_end[kMaxPieces];
  __shared__ int s_off[kMaxPieces];
  __shared__ int s_sel[kMaxPieces];
  __shared__ float s_alpha[kMaxPieces];
  __shared__ float s_knots[kWarp ? kMaxWarpTerms : 1];
  __shared__ int s_row1, s_row2;

  const int row = blockIdx.y;
  const int t0 = (blockIdx.x * kWarpThreads + threadIdx.x) * V;
  const bool active = t0 < Tlen;
  const int64_t row_len = (int64_t)C * Tlen;
  const int kb = (K2 + kBasisChunk - 1) / kBasisChunk * kBasisChunk;
  // K2/K4 issue the base row's loads before the barrier, beside the
  // plan's; K1/K3 after it, so that the plan's loads, which the barrier
  // waits on, meet no other traffic (K2/K4 take row i; only K1 reads idx1)
  constexpr bool kBaseBeforeBarrier = kWarp;

  // 1. what depends on nothing in the plan: the base row's first channel
  //    group and this thread's basis rows
  float x1[kChannelGroup][V];
  float b[V][kBasisChunk];
  if constexpr (kBaseBeforeBarrier) {
    if (active) {
      load_group<T, V>(src1.base + (int64_t)row * row_len, 0, C, Tlen, t0, x1);
      load_basis<V>(basis, t0, kb, 0, b);
    }
  }

  // 2. the plan, in the same round: thread k loads piece k, every thread
  //    some knots, the last thread the row indices
  const int64_t prow = (int64_t)row * K;
  if ((int)threadIdx.x < K) {
    const int k = threadIdx.x;
    const int d = __ldg(dst + prow + k);
    s_start[k] = d;
    s_end[k] = d + __ldg(len + prow + k);
    s_off[k] = __ldg(src + prow + k) - d;
    s_sel[k] = __ldg(sel + prow + k);
    s_alpha[k] = __ldg(alpha + prow + k);
  }
  if constexpr (kWarp) {
    const float* __restrict__ row_knots = knots + (int64_t)row * K2 * C;
    for (int j = threadIdx.x; j < K2 * C; j += kWarpThreads) {
      s_knots[j] = __ldg(row_knots + j);
    }
  }
  if (threadIdx.x == kWarpThreads - 1) {
    s_row2 = src2.idx == nullptr ? row : clamp_row(__ldg(src2.idx + row), src2.rows);
    if (!kWarp && src1.idx != nullptr) {
      s_row1 = clamp_row(__ldg(src1.idx + row), src1.rows);
    }
  }
  __syncthreads();
  if (!active) return;

  const bool row1_given = !kWarp && src1.idx != nullptr;
  const T* __restrict__ d1 = src1.base + (int64_t)(row1_given ? s_row1 : row) * row_len;
  if (!kBaseBeforeBarrier && kBaseIsD1) load_group<T, V>(d1, 0, C, Tlen, t0, x1);

  // 3. this thread's steps: a, off and sel summed over the covering pieces
  //    in piece order; the source index clamped, as XLA's piecewise_mix
  const T* __restrict__ d2 = src2.base + (int64_t)s_row2 * row_len;
  bool covered[V];
  float a[V];
  int off[V], sl[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    covered[v] = false;
    a[v] = 0.f;
    off[v] = 0;
    sl[v] = 0;
  }
  for (int k = 0; k < K; ++k) {
    const int start = s_start[k], end = s_end[k], ok = s_off[k], sk = s_sel[k];
    const float ak = s_alpha[k];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (t0 + v >= start && t0 + v < end) {
        covered[v] = true;
        a[v] = __fadd_rn(a[v], ak);
        off[v] += ok;
        sl[v] += sk;
      }
    }
  }
  int ti[V];
  const T* srow[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = t0 + v + off[v];
    ti[v] = i < 0 ? 0 : (i >= Tlen ? Tlen - 1 : i);
    srow[v] = sl[v] != 0 ? d2 : d1;
  }

  // 4. channel groups: source loads, envelope, blend, 16-byte stores
  T* __restrict__ o = out + (int64_t)row * row_len + t0;
  for (int c0 = 0; c0 < C; c0 += kChannelGroup) {
    if (c0 > 0) {
      if constexpr (kBaseIsD1) load_group<T, V>(d1, c0, C, Tlen, t0, x1);
      if constexpr (kWarp) {
        if (K2 > kBasisChunk) load_basis<V>(basis, t0, kb, 0, b);
      }
    }
    float s[kChannelGroup][V];
#pragma unroll
    for (int g = 0; g < kChannelGroup; ++g) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        s[g][v] = (c0 + g < C && covered[v])
                      ? ldg_f32(srow[v], (int64_t)(c0 + g) * Tlen + ti[v])
                      : 0.f;
      }
    }
    // Σ_j basis[t, j]·knots[j, c], one fp32 FMA per term, j in order
    float w[kChannelGroup][V];
    if constexpr (kWarp) {
#pragma unroll
      for (int g = 0; g < kChannelGroup; ++g) {
#pragma unroll
        for (int v = 0; v < V; ++v) w[g][v] = 0.f;
      }
      for (int j0 = 0; j0 < K2; j0 += kBasisChunk) {
        if (j0 > 0) load_basis<V>(basis, t0, kb, j0, b);
#pragma unroll
        for (int j = 0; j < kBasisChunk; ++j) {
#pragma unroll
          for (int g = 0; g < kChannelGroup; ++g) {
            if (j0 + j < K2 && c0 + g < C) {
              const float kn = s_knots[(j0 + j) * C + c0 + g];
#pragma unroll
              for (int v = 0; v < V; ++v) w[g][v] = fmaf(b[v][j], kn, w[g][v]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kChannelGroup; ++g) {
      if (c0 + g >= C) continue;
      float y[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float base = kBaseIsD1 ? x1[g][v] : 0.f;
        float val = base;
        if (covered[v]) {
          val = __fadd_rn(__fmul_rn(a[v], base),
                          __fmul_rn(__fsub_rn(1.f, a[v]), s[g][v]));
        }
        if constexpr (kWarp) {
          y[v] = __fmul_rn(val, w[g][v]);
        } else {
          y[v] = val;
        }
      }
      store_steps<V>(o + (int64_t)(c0 + g) * Tlen, y);
    }
  }
}

// One launch with V steps per thread: the envelope's instantiation (K2/K4)
// or the blend's, with base d1 or 0 (K1/K3).
template <typename T, int V>
void launch_warp(RowSource<T> s1, RowSource<T> s2, void* out, const int* dst,
                 const int* src, const int* len, const int* sel,
                 const float* alpha, const float* knots, const float* basis,
                 int N, int C, int Tlen, int K, int K2, bool warp,
                 bool base_is_d1, cudaStream_t stream) {
  const int per_block = kWarpThreads * V;
  const dim3 grid((unsigned)((Tlen + per_block - 1) / per_block), (unsigned)N);
  auto* kernel = warp         ? mix_warp_kernel<T, V, true, true>
                 : base_is_d1 ? mix_warp_kernel<T, V, false, true>
                              : mix_warp_kernel<T, V, false, false>;
  kernel<<<grid, kWarpThreads, 0, stream>>>(s1, s2, (T*)out, dst, src, len, sel,
                                           alpha, knots, basis, C, Tlen, K, K2);
}

// K1–K4: dispatch on dtype_code (0 = float32, 1 = bfloat16) and
// vector_width (16 / sizeof(T) or 1).  Refused where the vector path's
// alignment does not hold, where a null index would read past its rows,
// and, with the warp, without the envelope's inputs.  Returns
// cudaGetLastError() after the launch (0 = launched).
int dispatch_warp(const void* base1, const int* idx1, int rows1,
                  const void* base2, const int* idx2, int rows2, void* out,
                  const int* dst, const int* src, const int* len,
                  const int* sel, const float* alpha, const float* knots,
                  const float* basis, int N, int C, int Tlen, int K, int K2,
                  bool warp, bool base_is_d1, int vector_width, int dtype_code,
                  void* stream) {
  const int v16 = dtype_code == 0 ? 4 : 8;
  const bool aligned =
      Tlen % v16 == 0 &&
      ((uintptr_t)base1 | (uintptr_t)base2 | (uintptr_t)out) % 16 == 0;
  const bool envelope_ok =
      !warp || (K2 > 0 && K2 * C <= kMaxWarpTerms && knots != nullptr &&
                basis != nullptr && (uintptr_t)basis % 16 == 0 &&
                idx1 == nullptr && base_is_d1);
  if (rows1 <= 0 || rows2 <= 0 || N <= 0 || N > 65535 || C <= 0 ||
      Tlen <= 0 || K < 0 || K > kMaxPieces || !envelope_ok ||
      (idx1 == nullptr && N > rows1) || (idx2 == nullptr && N > rows2) ||
      (dtype_code != 0 && dtype_code != 1) ||
      !(vector_width == 1 || (vector_width == v16 && aligned))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype_code == 0) {
    const RowSource<float> s1{(const float*)base1, idx1, rows1};
    const RowSource<float> s2{(const float*)base2, idx2, rows2};
    (vector_width == 1 ? launch_warp<float, 1> : launch_warp<float, 4>)(
        s1, s2, out, dst, src, len, sel, alpha, knots, basis, N, C, Tlen, K,
        K2, warp, base_is_d1, s);
  } else {
    using bf16 = __nv_bfloat16;
    const RowSource<bf16> s1{(const bf16*)base1, idx1, rows1};
    const RowSource<bf16> s2{(const bf16*)base2, idx2, rows2};
    (vector_width == 1 ? launch_warp<bf16, 1> : launch_warp<bf16, 8>)(
        s1, s2, out, dst, src, len, sel, alpha, knots, basis, N, C, Tlen, K,
        K2, warp, base_is_d1, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: data (B, C, T); idx1 may be NULL (row i, as on the main path; then
// N ≤ B); vector_width 16 / sizeof(T) or 1.
int pcgmix_piecewise_mix_pairs(const void* data, void* out, const int* idx1,
                               const int* idx2, const int* dst,
                               const int* src, const int* len, const int* sel,
                               const float* alpha, int B, int N, int C,
                               int Tlen, int K, int base_is_d1,
                               int vector_width, int dtype_code, void* stream) {
  return dispatch_warp(data, idx1, B, data, idx2, B, out, dst, src, len, sel,
                       alpha, nullptr, nullptr, N, C, Tlen, K, 0, false,
                       base_is_d1 != 0, vector_width, dtype_code, stream);
}

// K2: data (B, C, T); knots (B, K2, C); basis (T, K2 rounded up to
// kBasisChunk), zero past column K2; vector_width as K1's.
int pcgmix_plus_fused(const void* data, void* out, const int* mix,
                      const int* dst, const int* src, const int* len,
                      const int* sel, const float* alpha, const float* knots,
                      const float* basis, int B, int C, int Tlen, int K,
                      int K2, int vector_width, int dtype_code, void* stream) {
  return dispatch_warp(data, nullptr, B, data, mix, B, out, dst, src, len, sel,
                       alpha, knots, basis, B, C, Tlen, K, K2, true, true,
                       vector_width, dtype_code, stream);
}

// K3: d1_rows, d2_rows (N, C, T); vector_width as K1's.
int pcgmix_piecewise_mix_prepaired(const void* d1_rows, const void* d2_rows,
                                   void* out, const int* dst, const int* src,
                                   const int* len, const int* sel,
                                   const float* alpha, int N, int C, int Tlen,
                                   int K, int base_is_d1, int vector_width,
                                   int dtype_code, void* stream) {
  return dispatch_warp(d1_rows, nullptr, N, d2_rows, nullptr, N, out, dst,
                       src, len, sel, alpha, nullptr, nullptr, N, C, Tlen, K,
                       0, false, base_is_d1 != 0, vector_width, dtype_code,
                       stream);
}

// K4: d1_rows, d2_rows (N, C, T); knots, basis and vector_width as K2's.
int pcgmix_plus_fused_prepaired(const void* d1_rows, const void* d2_rows,
                                void* out, const int* dst, const int* src,
                                const int* len, const int* sel,
                                const float* alpha, const float* knots,
                                const float* basis, int N, int C, int Tlen,
                                int K, int K2, int vector_width,
                                int dtype_code, void* stream) {
  return dispatch_warp(d1_rows, nullptr, N, d2_rows, nullptr, N, out, dst,
                       src, len, sel, alpha, knots, basis, N, C, Tlen, K, K2,
                       true, true, vector_width, dtype_code, stream);
}

int pcgmix_max_pieces(void) { return kMaxPieces; }
int pcgmix_max_warp_terms(void) { return kMaxWarpTerms; }
int pcgmix_warp_threads(void) { return kWarpThreads; }
int pcgmix_warp_basis_chunk(void) { return kBasisChunk; }

}  // extern "C"
