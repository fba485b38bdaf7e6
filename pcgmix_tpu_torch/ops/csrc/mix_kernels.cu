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
// Pallas body.  The four differ only in where the rows come from (K1/K3
// are `mix_kernel`, K2/K4 `mix_warp_kernel`):
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
// Bound: all four move bytes, not operations; a blend costs a few
// operations per element.  Main path: N = 64, C = 4, T = 2500, fp32.
// K1/K2 read the batch (2.56 MB) and write the output (2.56 MB), 5.12 MB
// in all (7.68 MB if the partner rows are counted as a second read), plus
// 60 KB of basis and 6 KB of knots for K2: about 1.5 µs at the H100 SXM's
// 3.35 TB/s.  K3/K4 read two separate row buffers (2 × 2.56 MB) and write
// one (2.56 MB), 7.68 MB plus the plan arrays (and K4's basis and knots):
// about 2.3 µs.  One launch costs about as much as K2's whole bound.
//
// K1 and K3, `mix_kernel`: one grid row (blockIdx.y) per output row, so a
// block reads its row's pieces once into shared memory; blocks along x
// cover C·T with neighbouring threads on neighbouring t, so the base read,
// the source window read (contiguous inside a piece) and the store are all
// coalesced.  Rows are read straight from device memory; the whole batch
// fits in the 50 MB L2, so a second read of a row mostly hits L2.
//
// K2 and K4, `mix_warp_kernel`.  They were `mix_kernel` with the warp
// fused in, and reached 12–18 % of their bounds (0.0132 ms).  That time is
// device time (the timing queues its launches behind a device sleep), so
// what held them was latency: each thread waited on a chain of dependent
// round trips to memory.
//   1. A grid-stride loop of four single elements per thread over C·T.
//   2. The plan went to shared memory, then a barrier, and only then was
//      the row index idx[row] read: two round trips before the first load
//      of data.
//   3. `out` was not __restrict__, so no load of the next iteration could
//      move above this iteration's store: the four ran one after another.
//   4. A 64-bit division e / T per element.
//   5. Six basis values per element, read from device memory, 24 bytes
//      apart between neighbouring threads.
//   6. Scalar 4-byte loads and stores only.
// What the warp kernel does about each:
//   1. One block per (output row, tile of kWarpThreads·V steps) covering
//      all C channels; each thread owns V consecutive steps, 16 bytes (V = 4
//      in fp32, 8 in bf16), in every channel.  t comes from the block and
//      thread indices and c from a loop over channels: no grid-stride loop.
//      128 threads × 4 = 512 steps per tile gives 5 × 64 = 320 blocks at
//      N = 64, T = 2500 fp32, about 2.4 per SM of the 132, all resident at
//      once (at 128 registers a thread, 4 blocks fit an SM: 528 places),
//      so the whole batch is in flight in one wave.
//   2. One prologue round trip.  The loads that depend on nothing in the
//      plan go first: the base row's first kChannelGroup channels and the
//      thread's basis rows.  In the same round each piece's five values
//      (thread k loads piece k), the row's knots (every thread) and K2's
//      partner index (the last thread) go to shared memory.  Then one
//      barrier, then the source loads, which need the offsets, selectors
//      and the partner row.  These are per-thread loads, not Hopper's bulk
//      copy: the plan arrays are a few dozen bytes at offsets row·K·4 that
//      are not 16-byte aligned, and padding them in the wrapper would add a
//      copy per step, while per-thread loads already issue in the same
//      round as the data.
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
// boundary.  Otherwise the wrapper (`mix_kernels.py::_warp_vector_width`)
// takes the V = 1 instantiation of the same kernel (T = 509, T = 1, a bf16
// row of odd length, an offset view).  In a last partial tile the threads
// past T take part in the barrier and store nothing.
//
// The blend uses explicitly rounded fp32 operations (__fmul_rn, __fadd_rn)
// so the compiler cannot contract it into an FMA: the result is then
// bit-equal to the plain PyTorch version, which rounds every operation.
// The envelope is a chain of fp32 FMAs over j in order, the same in every
// instantiation, so K4 on gathered partners is bit-equal to K2 and V = 1
// to V = 4.  bf16 rows are widened exactly on load and narrowed once at
// the store with round to nearest even, as torch's cast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPieces = 32;      // the multi-cycle variant needs 27
constexpr int kMaxWarpTerms = 256;  // (knot+2)·C envelope coefficients
constexpr int kThreads = 256;       // K1/K3
constexpr int kItemsPerThread = 4;  // K1/K3
constexpr int kWarpThreads = 128;   // K2/K4: threads per block
constexpr int kChannelGroup = 4;    // K2/K4: channels a thread holds at once
constexpr int kBasisChunk = 8;      // K2/K4: basis columns a thread holds at once
static_assert(kMaxPieces <= kWarpThreads, "one thread loads each piece");

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

// K1 and K3
template <typename T, bool kBaseIsD1>
__global__ void __launch_bounds__(kThreads) mix_kernel(
    RowSource<T> src1, RowSource<T> src2, T* __restrict__ out,
    const int* __restrict__ dst, const int* __restrict__ src,
    const int* __restrict__ len, const int* __restrict__ sel,
    const float* __restrict__ alpha, int C, int Tlen, int K) {
  __shared__ int s_start[kMaxPieces];
  __shared__ int s_end[kMaxPieces];
  __shared__ int s_off[kMaxPieces];
  __shared__ int s_sel[kMaxPieces];
  __shared__ float s_alpha[kMaxPieces];

  const int row = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int d = dst[row * K + k];
    s_start[k] = d;
    s_end[k] = d + len[row * K + k];
    s_off[k] = src[row * K + k] - d;
    s_sel[k] = sel[row * K + k];
    s_alpha[k] = alpha[row * K + k];
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
    store_f32(o, e, v);
  }
}

// K2 and K4: output row i blends d1_rows[i] with its partner row from src2
// and multiplies by the envelope; V steps per thread (see the note above)
template <typename T, int V>
__global__ void __launch_bounds__(kWarpThreads) mix_warp_kernel(
    const T* __restrict__ d1_rows, RowSource<T> src2, T* __restrict__ out,
    const int* __restrict__ dst, const int* __restrict__ src,
    const int* __restrict__ len, const int* __restrict__ sel,
    const float* __restrict__ alpha,
    const float* __restrict__ knots,  // (N, K2, C)
    const float* __restrict__ basis,  // (T, kb): K2 columns, then zeros
    int C, int Tlen, int K, int K2) {
  __shared__ int s_start[kMaxPieces];
  __shared__ int s_end[kMaxPieces];
  __shared__ int s_off[kMaxPieces];
  __shared__ int s_sel[kMaxPieces];
  __shared__ float s_alpha[kMaxPieces];
  __shared__ float s_knots[kMaxWarpTerms];
  __shared__ int s_row2;

  const int row = blockIdx.y;
  const int t0 = (blockIdx.x * kWarpThreads + threadIdx.x) * V;
  const bool active = t0 < Tlen;
  const int64_t row_len = (int64_t)C * Tlen;
  const int kb = (K2 + kBasisChunk - 1) / kBasisChunk * kBasisChunk;
  const T* __restrict__ d1 = d1_rows + (int64_t)row * row_len;

  // 1. what depends on nothing in the plan: the base row's first channel
  //    group and this thread's basis rows
  float x1[kChannelGroup][V];
  float b[V][kBasisChunk];
  if (active) {
#pragma unroll
    for (int g = 0; g < kChannelGroup; ++g) {
      if (g < C) load_steps<V>(d1 + (int64_t)g * Tlen + t0, x1[g]);
    }
    load_basis<V>(basis, t0, kb, 0, b);
  }

  // 2. the plan, in the same round: thread k loads piece k, every thread
  //    some knots, the last thread the partner row
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
  const float* __restrict__ row_knots = knots + (int64_t)row * K2 * C;
  for (int j = threadIdx.x; j < K2 * C; j += kWarpThreads) {
    s_knots[j] = __ldg(row_knots + j);
  }
  if (threadIdx.x == kWarpThreads - 1) {
    s_row2 = src2.idx == nullptr ? row : clamp_row(__ldg(src2.idx + row), src2.rows);
  }
  __syncthreads();
  if (!active) return;

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
#pragma unroll
      for (int g = 0; g < kChannelGroup; ++g) {
        if (c0 + g < C) load_steps<V>(d1 + (int64_t)(c0 + g) * Tlen + t0, x1[g]);
      }
      if (K2 > kBasisChunk) load_basis<V>(basis, t0, kb, 0, b);
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
#pragma unroll
    for (int g = 0; g < kChannelGroup; ++g) {
      if (c0 + g >= C) continue;
      float y[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float base = x1[g][v];
        float val = base;
        if (covered[v]) {
          val = __fadd_rn(__fmul_rn(a[v], base),
                          __fmul_rn(__fsub_rn(1.f, a[v]), s[g][v]));
        }
        y[v] = __fmul_rn(val, w[g][v]);
      }
      store_steps<V>(o + (int64_t)(c0 + g) * Tlen, y);
    }
  }
}

dim3 grid_for(int N, int C, int Tlen) {
  const int64_t row_len = (int64_t)C * Tlen;
  const int64_t per_block = (int64_t)kThreads * kItemsPerThread;
  return dim3((unsigned)((row_len + per_block - 1) / per_block), (unsigned)N);
}

// One launch of K1 or K3.
template <typename T>
void launch(RowSource<T> s1, RowSource<T> s2, void* out, const int* dst,
            const int* src, const int* len, const int* sel,
            const float* alpha, int N, int C, int Tlen, int K, int base_is_d1,
            cudaStream_t stream) {
  const dim3 grid = grid_for(N, C, Tlen);
  T* o = (T*)out;
  if (base_is_d1) {
    mix_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        s1, s2, o, dst, src, len, sel, alpha, C, Tlen, K);
  } else {
    mix_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        s1, s2, o, dst, src, len, sel, alpha, C, Tlen, K);
  }
}

// K1/K3: dispatch on dtype_code (0 = float32, 1 = bfloat16); returns
// cudaGetLastError() after the launch (0 = launched).
int dispatch(const void* base1, const int* idx1, int rows1, const void* base2,
             const int* idx2, int rows2, void* out, const int* dst,
             const int* src, const int* len, const int* sel,
             const float* alpha, int N, int C, int Tlen, int K, int base_is_d1,
             int dtype_code, void* stream) {
  if (rows1 <= 0 || rows2 <= 0 || N <= 0 || N > 65535 || C <= 0 ||
      Tlen <= 0 || K < 0 || K > kMaxPieces ||
      (dtype_code != 0 && dtype_code != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype_code == 0) {
    launch<float>({(const float*)base1, idx1, rows1},
                  {(const float*)base2, idx2, rows2}, out, dst, src, len, sel,
                  alpha, N, C, Tlen, K, base_is_d1, s);
  } else {
    using bf16 = __nv_bfloat16;
    launch<bf16>({(const bf16*)base1, idx1, rows1},
                 {(const bf16*)base2, idx2, rows2}, out, dst, src, len, sel,
                 alpha, N, C, Tlen, K, base_is_d1, s);
  }
  return (int)cudaGetLastError();
}

// One launch of K2 or K4 with V steps per thread.
template <typename T, int V>
void launch_warp(const void* d1_rows, const void* base2, const int* idx2,
                 int rows2, void* out, const int* dst, const int* src,
                 const int* len, const int* sel, const float* alpha,
                 const float* knots, const float* basis, int N, int C,
                 int Tlen, int K, int K2, cudaStream_t stream) {
  const int per_block = kWarpThreads * V;
  const dim3 grid((unsigned)((Tlen + per_block - 1) / per_block), (unsigned)N);
  mix_warp_kernel<T, V><<<grid, kWarpThreads, 0, stream>>>(
      (const T*)d1_rows, RowSource<T>{(const T*)base2, idx2, rows2}, (T*)out,
      dst, src, len, sel, alpha, knots, basis, C, Tlen, K, K2);
}

// K2/K4: V = vector_width steps per thread, 16 / sizeof(T) or 1; refused
// where the vector path's alignment does not hold.
int dispatch_warp(const void* d1_rows, const void* base2, const int* idx2,
                  int rows2, void* out, const int* dst, const int* src,
                  const int* len, const int* sel, const float* alpha,
                  const float* knots, const float* basis, int N, int C,
                  int Tlen, int K, int K2, int vector_width, int dtype_code,
                  void* stream) {
  const int v16 = dtype_code == 0 ? 4 : 8;
  const bool aligned =
      Tlen % v16 == 0 &&
      ((uintptr_t)d1_rows | (uintptr_t)base2 | (uintptr_t)out) % 16 == 0;
  if (rows2 <= 0 || N <= 0 || N > 65535 || C <= 0 || Tlen <= 0 || K < 0 ||
      K > kMaxPieces || K2 <= 0 || K2 * C > kMaxWarpTerms ||
      knots == nullptr || basis == nullptr || (uintptr_t)basis % 16 != 0 ||
      (dtype_code != 0 && dtype_code != 1) ||
      !(vector_width == 1 || (vector_width == v16 && aligned))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  auto* go = dtype_code == 0
                 ? (vector_width == 1 ? launch_warp<float, 1> : launch_warp<float, 4>)
                 : (vector_width == 1 ? launch_warp<bf16, 1> : launch_warp<bf16, 8>);
  go(d1_rows, base2, idx2, rows2, out, dst, src, len, sel, alpha, knots, basis,
     N, C, Tlen, K, K2, s);
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
                  alpha, N, C, Tlen, K, base_is_d1, dtype_code, stream);
}

// K2: data (B, C, T); knots (B, K2, C); basis (T, K2 rounded up to
// kBasisChunk), zero past column K2; vector_width 16 / sizeof(T) or 1.
int pcgmix_plus_fused(const void* data, void* out, const int* mix,
                      const int* dst, const int* src, const int* len,
                      const int* sel, const float* alpha, const float* knots,
                      const float* basis, int B, int C, int Tlen, int K,
                      int K2, int vector_width, int dtype_code, void* stream) {
  return dispatch_warp(data, data, mix, B, out, dst, src, len, sel, alpha,
                       knots, basis, B, C, Tlen, K, K2, vector_width,
                       dtype_code, stream);
}

// K3: d1_rows, d2_rows (N, C, T).
int pcgmix_piecewise_mix_prepaired(const void* d1_rows, const void* d2_rows,
                                   void* out, const int* dst, const int* src,
                                   const int* len, const int* sel,
                                   const float* alpha, int N, int C, int Tlen,
                                   int K, int base_is_d1, int dtype_code,
                                   void* stream) {
  return dispatch(d1_rows, nullptr, N, d2_rows, nullptr, N, out, dst, src,
                  len, sel, alpha, N, C, Tlen, K, base_is_d1, dtype_code,
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
  return dispatch_warp(d1_rows, d2_rows, nullptr, N, out, dst, src, len, sel,
                       alpha, knots, basis, N, C, Tlen, K, K2, vector_width,
                       dtype_code, stream);
}

int pcgmix_max_pieces(void) { return kMaxPieces; }
int pcgmix_max_warp_terms(void) { return kMaxWarpTerms; }
int pcgmix_warp_threads(void) { return kWarpThreads; }
int pcgmix_warp_basis_chunk(void) { return kBasisChunk; }

}  // extern "C"
