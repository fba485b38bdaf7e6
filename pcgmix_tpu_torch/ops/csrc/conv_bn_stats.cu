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
// Bound, on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): res2a
// 64×312×512→512 does 31.4 GFLOP over 42.5 MB, 739 FLOP/B, so it is bound
// by the tensor cores (31.8 µs); conv3 64×1250×128→256 does 15.7 GFLOP over
// 61.6 MB, 255 FLOP/B, under the ~295 ridge, so it is bound by bytes
// (18.4 µs).  For the first, the design keeps wgmma, the only route to the
// full bf16 rate, fed from a ring of stages that TMA fills while the
// tensor cores work; for the second, x and w cross device memory once (the
// three taps' boxes of a row come from L2), y is written once in bf16 by
// TMA, and the statistics never leave the chip until one partial per
// column and block.
//
// Design: an implicit GEMM, M = B·T rows of y, N = Cout, K = 3·Cin.
// - M is cut into chunks of kChunkRows = 64 rows that never cross a
//   sample: chunk q is sample b = q / ⌈T/64⌉, rows t0 = 64·(q mod ⌈T/64⌉)
//   to t0 + 63.  A block owns kChunksPerTile = 2 chunks, one per consumer
//   warpgroup, and BN = 128 or 256 columns of y.
// - x is a 3-D TMA tensor (Cin, T, B), innermost first.  Tap j's A tile of
//   a chunk is the box (64 channels, 64 rows) at (c0, t0 + j − 1, b); TMA
//   fills rows outside [0, T) with zeros, which is exactly the per-sample
//   padding, and every box starts on a 128-byte swizzle atom.  w is a 3-D
//   TMA tensor (Cout, Cin, 3); its boxes (64 columns, 64 channels) are the
//   B operand as w lies in memory, Cout contiguous: an MN-major operand
//   (wgmma's transpose-B flag), with no copy of w.  Channels past Cin and
//   columns past Cout are zero-filled too.
// - Warp specialisation: one producer thread issues the TMA loads of each
//   K step (tap, 64-channel block) into a ring of stages in dynamic shared
//   memory, with a full and an empty mbarrier per stage; two consumer
//   warpgroups run wgmma.m64nBNk16 (bf16 in, fp32 accumulate) on each
//   stage as it lands, keep one step's wgmma in flight and release the
//   stage before it.  setmaxnreg moves registers from the producer to the
//   consumers: a 64 × 256 fp32 accumulator takes 128 registers a thread.
// - Epilogue from the registers: y is rounded to bf16 once, staged in
//   shared memory in the 128-byte swizzle and written by 3-D TMA stores,
//   which drop rows t ≥ T (and the whole second chunk of the last block
//   when the chunk count is odd).  Those rows hold non-zero garbage in acc
//   (at t = T, tap 0 reads x[T−1]), so with stats each thread sums acc and
//   acc² over its valid rows only; the lanes of a warp combine by a
//   shuffle reduce-scatter, warps and warpgroups in shared memory in a
//   fixed order, and each block writes one partial per column to an fp32
//   scratch (tiles × 2 × Cout).  A
//   second small kernel adds the partials in a fixed order, 64 tiles in
//   flight per column: deterministic, unlike atomicAdd.  y takes the same
//   path with and without stats, so the two are bit-equal.
//
// TMA needs 16-byte-aligned bases and strides that are multiples of 16
// bytes: Cin and Cout must be multiples of 8 (the wrapper pads other
// shapes with zero channels).  The tensor maps are encoded on the host
// with cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (cudaGetDriverEntryPoint*), so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkRows = 64;     // rows of y per consumer warpgroup
constexpr int kChunksPerTile = 2;  // consumer warpgroups per block
constexpr int kBK = 64;            // input channels per K step: one 128-byte row
constexpr int kBox = 64 * 64 * 2;  // bytes of one 64 × 64 bf16 TMA box
constexpr int kConsumers = 128 * kChunksPerTile;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kRingBytes = 196608;          // 4 stages at BN = 256, 6 at 128

template <int BN>
struct Tiling {
  static constexpr int kPanels = BN / 64;  // 64-column boxes of w and of y
  static constexpr int kStageBytes = (kChunksPerTile + kPanels) * kBox;
  static constexpr int kStages = kRingBytes / kStageBytes;
  // the ring, its full and empty barriers, and room to align it to 1024
  static constexpr int kSmem = kStages * kStageBytes + 16 * kStages + 1024;
  // the epilogue reuses the ring: y of both chunks, then [g][warp][2][BN]
  static_assert(kChunksPerTile * kPanels * kBox + kConsumers / 32 * 2 * BN * 4 <=
                    kStages * kStageBytes,
                "the epilogue does not fit in the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B): start address, leading and stride byte
// offsets, each in 16-byte units.  A (K-major): rows of 128 bytes, 8-row
// groups 1024 bytes apart (stride), the leading offset unused.  B
// (MN-major): 8-row groups of K 1024 bytes apart (stride), 64-column
// panels kBox apart (leading).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A·B for one 64 × N × 16 step: A K-major, B MN-major (transpose-B),
// bf16 in, fp32 accumulate.  Thread l of warp w of the warpgroup holds
// d[4j + 2h + e] = D[16w + l/4 + 8h][8j + 2(l%4) + e].
template <int N>
__device__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// One step of a reduce-scatter between lanes l and l ^ o: each keeps one
// half of v[0, 2H) (the upper one where `upper`), adds the partner's copy
// of that half into v[0, H) and hands over the other half.
template <int H, int V>
__device__ __forceinline__ void fold_half(float (&v)[V], bool upper, int o) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

template <int BN, bool kStats>
__global__ void __launch_bounds__(kThreads, 1)
    conv3_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_y, float* __restrict__ partial,
                 int B, int T, int Cin, int Cout) {
  using Tile = Tiling<BN>;
  constexpr int kPanels = Tile::kPanels, kStages = Tile::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the 128-byte swizzle's atom
  unsigned char* smem = smem_raw + (ring - raw);
  // stage s: A of chunk 0, A of chunk 1, then kPanels boxes of w
  auto stage = [&](int s) { return ring + (uint32_t)(s * Tile::kStageBytes); };
  const uint32_t bars = ring + kStages * Tile::kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tid = threadIdx.x;
  const int cpt = (T + kChunkRows - 1) / kChunkRows;  // chunks per sample
  const int nchunks = B * cpt;
  const int n0 = blockIdx.y * BN;
  const int nc = (Cin + kBK - 1) / kBK;
  const int nk = 3 * nc;  // K steps: (tap, 64-channel block)

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);                 // the producer's expect_tx
      mbar_init(empty(s), kConsumers / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: one thread issues every load --------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == kConsumers) {
      int cb[kChunksPerTile], ct[kChunksPerTile];
      bool cv[kChunksPerTile];
      uint32_t bytes = 0;
      const int panels = min(kPanels, (Cout - n0 + 63) / 64);
      for (int g = 0; g < kChunksPerTile; ++g) {
        const int q = blockIdx.x * kChunksPerTile + g;
        cv[g] = q < nchunks;  // the last block's second chunk may not exist
        cb[g] = q / cpt;
        ct[g] = (q % cpt) * kChunkRows;
        bytes += cv[g] ? kBox : 0;
      }
      bytes += panels * kBox;
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const int tap = it / nc, c0 = (it % nc) * kBK;
        mbar_expect_tx(full(s), bytes);
        for (int g = 0; g < kChunksPerTile; ++g) {
          if (cv[g]) tma_load(stage(s) + g * kBox, &map_x, full(s), c0, ct[g] + tap - 1, cb[g]);
        }
        for (int i = 0; i < panels; ++i) {
          tma_load(stage(s) + (kChunksPerTile + i) * kBox, &map_w, full(s), n0 + 64 * i, c0,
                   tap);
        }
      }
    }
  } else {
    // ---- consumer warpgroup g: chunk q, 64 rows × BN columns ------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int g = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
    const int q = blockIdx.x * kChunksPerTile + g;
    const bool valid = q < nchunks;
    const int b = q / cpt, t0 = (q % cpt) * kChunkRows;

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t a = stage(s) + g * kBox;
      const uint32_t bw = stage(s) + kChunksPerTile * kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // 16 channels: 32 bytes along A's rows, 16 rows of 128 bytes of B
        wgmma_bf16<BN>(acc, desc_sw128(a + 32 * kk, 16, 1024),
                       desc_sw128(bw + 2048 * kk, kBox, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's wgmma is done: free its stage
      if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    bar_sync(1, kConsumers);  // both warpgroups are done with the ring
    // y: bf16 in the y map's 128-byte swizzle, one box per 64 columns;
    // rows r0 and r0 + 8 share r % 8 = lane / 4
    unsigned char* ys = smem + g * kPanels * kBox;
    const int r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int off = (j / 8) * kBox + (((j % 8) ^ (lane / 4)) << 4) + (lane % 4) * 4;
      *reinterpret_cast<__nv_bfloat162*>(ys + off + r0 * 128) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(ys + off + (r0 + 8) * 128) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(2 + g, 128);
    if (wt == 0 && valid) {
      for (int i = 0; i < kPanels && n0 + 64 * i < Cout; ++i) {
        tma_store(&map_y, smem_u32(ys) + i * kBox, n0 + 64 * i, t0, b);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }

    if constexpr (kStats) {
      // v[4j + k]: this thread's sums over its valid rows for column
      // 8j + 2(lane%4) + k%2, of acc for k < 2 and of acc² for k ≥ 2
      constexpr int V = BN / 2;
      const bool ok0 = valid && t0 + r0 < T, ok1 = valid && t0 + r0 + 8 < T;
      float v[V];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float m0 = ok0 ? acc[4 * j] : 0.f, m1 = ok0 ? acc[4 * j + 1] : 0.f;
        const float m2 = ok1 ? acc[4 * j + 2] : 0.f, m3 = ok1 ? acc[4 * j + 3] : 0.f;
        v[4 * j] = m0 + m2;
        v[4 * j + 1] = m1 + m3;
        v[4 * j + 2] = fmaf(m2, m2, m0 * m0);
        v[4 * j + 3] = fmaf(m3, m3, m1 * m1);
      }
      // the warp's 16 rows: a reduce-scatter over lane bits 4, 3 and 2
      // leaves lane the full sums v[(lane/4)·V/8 + i], i < V/8
      fold_half<V / 2>(v, lane & 16, 16);
      fold_half<V / 4>(v, lane & 8, 8);
      fold_half<V / 8>(v, lane & 4, 4);
      float* st = reinterpret_cast<float*>(smem + kChunksPerTile * kPanels * kBox);
      float* row = st + (g * 4 + warp) * 2 * BN + 2 * (lane % 4);  // [g][warp][2][BN]
#pragma unroll
      for (int i = 0; i < V / 8; ++i) {
        const int idx = lane / 4 * (V / 8) + i, j = idx / 4, k = idx % 4;
        row[(k / 2) * BN + 8 * j + k % 2] = v[i];
      }
      // then warps and warpgroups, in a fixed order
      bar_sync(1, kConsumers);
      if (tid < BN && n0 + tid < Cout) {
        float a1 = 0.f, a2 = 0.f;
        for (int k = 0; k < kConsumers / 32; ++k) {
          a1 += st[k * 2 * BN + tid];
          a2 += st[k * 2 * BN + BN + tid];
        }
        float* out = partial + (int64_t)blockIdx.x * 2 * Cout + n0 + tid;
        out[0] = a1;
        out[Cout] = a2;
      }
    }
    if (wt == 0 && valid) {
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // ys read out
    }
  }
}

// s1[n], s2[n]: the blocks' partial sums, added in a fixed order.  A block
// takes kReduceCols columns; its thread row r sums tiles r, r + kReduceRows,
// ... in turn, and the rows' sums are then added pairwise in shared
// memory.  The same order every call (deterministic, no atomics), with
// kReduceRows loads in flight per column where a single running sum over
// hundreds of tiles would wait on each load in turn.
constexpr int kReduceCols = 16, kReduceRows = 64;

__global__ void __launch_bounds__(kReduceCols * kReduceRows)
    stats_reduce_kernel(const float* __restrict__ partial, float* __restrict__ s1,
                        float* __restrict__ s2, int tiles, int Cout) {
  __shared__ float sum[2][kReduceRows][kReduceCols + 1];
  const int c = threadIdx.x, r = threadIdx.y;
  const int n = blockIdx.x * kReduceCols + c;
  float a = 0.f, b = 0.f;
  if (n < Cout) {
#pragma unroll 4
    for (int t = r; t < tiles; t += kReduceRows) {
      a += partial[(int64_t)t * 2 * Cout + n];
      b += partial[(int64_t)t * 2 * Cout + Cout + n];
    }
  }
  sum[0][r][c] = a;
  sum[1][r][c] = b;
  __syncthreads();
  for (int h = kReduceRows / 2; h > 0; h /= 2) {
    if (r < h) {
      sum[0][r][c] += sum[0][r + h][c];
      sum[1][r][c] += sum[1][r + h][c];
    }
    __syncthreads();
  }
  if (r == 0 && n < Cout) {
    s1[n] = sum[0][0][c];
    s2[n] = sum[1][0][c];
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), looked up once through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A contiguous bf16 tensor of dims (d0, d1, d2), innermost first, read and
// written in 64 × 64 × 1 boxes under the 128-byte swizzle; zero fill out of
// bounds.  Returns its CUresult (0 = encoded).
int encode(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                 strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN, bool kStats>
cudaError_t launch_conv(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my,
                        float* partial, int B, int T, int Cin, int Cout, unsigned tiles,
                        cudaStream_t s) {
  constexpr int smem = Tiling<BN>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      conv3_kernel<BN, kStats>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles, (unsigned)((Cout + BN - 1) / BN));
  conv3_kernel<BN, kStats><<<grid, kThreads, smem, s>>>(mx, mw, my, partial, B, T, Cin, Cout);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// x (B, T, Cin), w (3, Cin, Cout), y (B, T, Cout), all bf16, contiguous
// and 16-byte aligned, Cin and Cout multiples of 8; with_stats: partial
// (⌈B·⌈T/64⌉ / 2⌉, 2, Cout), s1, s2 (Cout,) fp32.  A block takes 256
// columns of y where Cout > 128, else 128 (256 was faster on the card at
// both of the harness's shapes).  Returns 0 once the kernels are launched,
// else the CUresult from encoding a tensor map or cudaGetLastError().
int pcgmix_conv3_bn_stats(const void* x, const void* w, void* y, void* partial, void* s1,
                          void* s2, int B, int T, int Cin, int Cout, int with_stats,
                          void* stream) {
  const int block_n = Cout > 128 ? 256 : 128;
  const int64_t chunks = (int64_t)B * ((T + kChunkRows - 1) / kChunkRows);
  const int64_t tiles = (chunks + kChunksPerTile - 1) / kChunksPerTile;
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || Cin % 8 != 0 || Cout % 8 != 0 ||
      chunks > 0x7fffffff || (Cout + block_n - 1) / block_n > 65535 || !aligned16(x) ||
      !aligned16(w) || !aligned16(y) || (with_stats && (partial == nullptr || s1 == nullptr || s2 == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap mx, mw, my;
  int r = encode(&mx, x, Cin, T, B);
  if (r == 0) r = encode(&mw, w, Cout, Cin, 3);
  if (r == 0) r = encode(&my, y, Cout, T, B);
  if (r != 0) return r;
  cudaStream_t s = (cudaStream_t)stream;
  float* pb = (float*)partial;
  cudaError_t e;
  if (block_n == 256) {
    e = with_stats ? launch_conv<256, true>(mx, mw, my, pb, B, T, Cin, Cout, tiles, s)
                   : launch_conv<256, false>(mx, mw, my, pb, B, T, Cin, Cout, tiles, s);
  } else {
    e = with_stats ? launch_conv<128, true>(mx, mw, my, pb, B, T, Cin, Cout, tiles, s)
                   : launch_conv<128, false>(mx, mw, my, pb, B, T, Cin, Cout, tiles, s);
  }
  if (e != cudaSuccess) return (int)e;
  if (with_stats) {
    stats_reduce_kernel<<<(Cout + kReduceCols - 1) / kReduceCols,
                          dim3(kReduceCols, kReduceRows), 0, s>>>(pb, (float*)s1, (float*)s2,
                                                                  (int)tiles, Cout);
  }
  return (int)cudaGetLastError();
}

int pcgmix_conv3_chunk_rows(void) { return kChunkRows; }

int pcgmix_conv3_chunks_per_tile(void) { return kChunksPerTile; }

}  // extern "C"
