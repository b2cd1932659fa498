// 3x3x3, stride-1, SAME convolution on channels-last volumes, for Hopper
// (sm_90a): two kernels, one per route (the wrapper's rule on dtype and
// widths picks the route; nothing here chooses at run time).
//
// Both replace: biapy_tpu/ops/pallas/conv3d.py::_kernel (launched by
// _conv3d_pallas, reached from biapy_tpu/ops/conv3d.py::conv3d_dispatch).
//
// Function:
//   y[n, z, y, x, co] = sum_{dz, dy, dx, ci} x[n, z+dz-1, y+dy-1, x+dx-1, ci]
//                                            * w[dz, dy, dx, ci, co]
// x is NDHWC, both operands contiguous and of one dtype; taps outside the
// volume read zero; the sum is kept in float32 and y is written in the input
// dtype. No bias.
//
// What bounds it on this card: operations. A voxel costs 54*Cin*Cout flops
// against (Cin + Cout) * itemsize bytes, which at the main path's widths
// (Cin 32..192, Cout 32..192) is far above the H100's ~295 flop/byte ridge;
// only the 1-channel stem (Cin = 1) is bound by bytes.
//
// 1. conv3d_k3_kernel, the CUDA-core route (float32, the Cin = 1 stem, widths
//    that 16 / 8 do not divide): an implicit GEMM with M = N*D*H*W output
//    voxels, N = Cout, K = 27*Cin, k = tap*Cin + ci, so the DHWIO weight
//    tensor already is the (K, Cout) row-major B matrix. Each block owns a
//    BM x BN output tile and walks K in chunks of BK: it stages the BK
//    reduction entries of its BM voxels (zero where a tap falls outside the
//    volume: the padding is a mask, never a padded copy) and the matching
//    BK x BN weight slice in shared memory as float32, then every thread
//    accumulates a TM x TN register tile with FMAs. Flattening K makes every
//    Cin work alike, ragged M, N and K edges are masked. Its ceiling is the
//    CUDA cores' 67 TFLOP/s; float32 stays here because the tensor cores
//    would round its products to TF32. For float32 inputs each chunk of BK
//    products is summed into its own register tile first and that tile
//    added to the total, two levels in place of one chain of 27*Cin
//    additions: the rounding grows with BK + K/BK, not K (a chain of K
//    left the instance template's float32 gradients 6.5e-5 of scale from
//    float64, against 5e-6 for the plain version's tap-by-tap sums).
//
// 2. conv3d_k3_wgmma_kernel, the tensor-core route (bf16, Cin % 16 == 0,
//    Cout % 8 == 0): bf16 operands staged in shared memory by TMA, products
//    by wgmma (m64nNk16, float32 accumulators in registers), a ring of stages
//    whose copies overlap the arithmetic. What bounds it in practice is the
//    traffic from the L2 into shared memory (every tap re-reads the
//    activation) and, for narrow Cout, the A reads of wgmma itself; the
//    design cuts the first by loading one y-slab for the three dy taps.
//      - A block owns a brick of 1 x 8 x 16 or 1 x 16 x 16 (z, y, x) output
//        voxels of one image (one 64-row wgmma tile, 4 rows of y, for each of
//        its two or four consumer warpgroups) and a tile of BN <= 256 output
//        channels (all of Cout up to 256, so A is staged once per tap, not
//        once per Cout tile).
//      - K is walked as (dz, dx, channel chunk of KC); one ring stage holds
//        the A slab of that step, a TMA box (KC, 16, 10 or 18, 1, 1) of x
//        starting at (c0, x0+dx-1, y0-1, z+dz-1, n), and the weights of its three dy
//        taps, a box (KC, BN, 1, 3, 1) of the packed weights
//        (27, Cout, Cin) seen as (Cin, Cout, 3, 3, 3). TMA coordinates are
//        signed and elements outside the tensor arrive as zeros: that is the
//        SAME padding, the channel tail of a Cin that KC does not divide
//        (zeros on both operands) and the rows of B past Cout, with no padded
//        copy and no mask arithmetic in any thread; n is its own coordinate,
//        so no tap crosses an image seam.
//      - The slab lands as 160 or 288 rows (y*16 + x) of KC channels, K-major and
//        swizzled over the row (KC = 32: 64-byte rows, SWIZZLE_64B; KC = 64:
//        128-byte rows, SWIZZLE_128B): the tile a wgmma descriptor reads. Tap dy of output row r reads slab row r + 16*dy, a
//        whole number of swizzle atoms further on, so the three taps are
//        three descriptors into one slab.
//      - One producer thread keeps the TMA loads in flight (full / empty
//        mbarrier pair per stage); the consumer warpgroups issue the wgmmas
//        of a stage as one group and release the stage before once the group
//        before has retired.
//      - Epilogue: float32 -> bf16 through (padded, conflict-free) shared
//        memory, then 16-byte stores; voxels of a brick that overhang the
//        volume and channels past Cout are not written.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;
constexpr int kBK = 16;

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
conv3d_k3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                 int n_img, int D, int H, int W, int Cin, int Cout) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one TM x TN tile per thread");
  __shared__ float As[kBK][BM + 4];
  __shared__ float Bs[kBK][BN];
  __shared__ int vn[BM], vz[BM], vy[BM], vx[BM];

  const long long M = (long long)n_img * D * H * W;
  const int K = 27 * Cin;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // decode the tile's output voxels once; vn = -1 marks rows past M
  for (int i = tid; i < BM; i += kThreads) {
    const long long m = m0 + i;
    if (m < M) {
      long long r = m;
      vx[i] = (int)(r % W); r /= W;
      vy[i] = (int)(r % H); r /= H;
      vz[i] = (int)(r % D);
      vn[i] = (int)(r / D);
    } else {
      vn[i] = -1; vz[i] = 0; vy[i] = 0; vx[i] = 0;
    }
  }
  __syncthreads();

  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A: BM voxels x BK (tap, ci) entries; consecutive threads take
    // consecutive k, i.e. consecutive input channels of one tap
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int kl = e % kBK, ml = e / kBK;
      const int k = k0 + kl;
      const int nn = vn[ml];
      float v = 0.f;
      if (k < K && nn >= 0) {
        const int tap = k / Cin;
        const int ci = k - tap * Cin;
        const int iz = vz[ml] + tap / 9 - 1;
        const int iy = vy[ml] + (tap / 3) % 3 - 1;
        const int ix = vx[ml] + tap % 3 - 1;
        if ((unsigned)iz < (unsigned)D && (unsigned)iy < (unsigned)H &&
            (unsigned)ix < (unsigned)W) {
          const long long off = ((((long long)nn * D + iz) * H + iy) * W + ix) * Cin + ci;
          v = to_f32(x[off]);
        }
      }
      As[kl][ml] = v;
    }
    // B: BK x BN slice of the (K, Cout) weight matrix
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int nl = e % BN, kl = e / BN;
      const int k = k0 + kl, co = n0 + nl;
      Bs[kl][nl] = (k < K && co < Cout) ? to_f32(w[(long long)k * Cout + co]) : 0.f;
    }
    __syncthreads();
    if constexpr (sizeof(T) == 4) {
      float part[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < Cout) y[m * Cout + co] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN>
void launch(const void* x, const void* w, void* y, int n_img, int D, int H, int W,
            int Cin, int Cout, cudaStream_t stream) {
  const long long M = (long long)n_img * D * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv3d_k3_kernel<T, BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      n_img, D, H, W, Cin, Cout);
}

template <typename T>
void dispatch(const void* x, const void* w, void* y, int n_img, int D, int H, int W,
              int Cin, int Cout, cudaStream_t stream) {
  // narrow outputs take a narrow tile so no thread idles on masked columns
  if (Cout <= 32)
    launch<T, 128, 32, 4, 4>(x, w, y, n_img, D, H, W, Cin, Cout, stream);
  else
    launch<T, 128, 64, 8, 4>(x, w, y, n_img, D, H, W, Cin, Cout, stream);
}

// ---------------------------------------------------------------------------
// The tensor-core route: TMA-staged bf16 tiles, wgmma, a ring of stages.
// ---------------------------------------------------------------------------

constexpr int kBrickX = 16;  // output voxels of a brick along x
constexpr int kWgY = 4;      // ... along y for each consumer warpgroup: one 64-row wgmma tile
constexpr int kMaxStages = 8;
// An SM has 228 KB of shared memory, a block at most 227 KB, and every
// resident block reserves 1 KB: what one of MINB resident blocks may ask for
constexpr int smem_budget(int minb) { return (minb >= 2 ? 112 : 226) * 1024; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// spins until the barrier's phase of the given parity has completed; a wait
// that outlasts any real one (seconds) traps, so a broken pipeline fails the
// launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are ROW_BYTES
// long and swizzled over that width (the layout TMA writes): start address,
// leading offset (unused within one swizzle width), the stride between 8-row
// groups, and the swizzle mode (1 = 128 B, 2 = 64 B, 3 = 32 B), all in 16-byte units.
template <int ROW_BYTES> __device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t mode = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>((8 * ROW_BYTES) >> 4) << 32) | (mode << 62);
}

#define BIAPY_P16_0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define BIAPY_P16_1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define BIAPY_P16_2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define BIAPY_P16_3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define BIAPY_P16_4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define BIAPY_P16_5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define BIAPY_P16_6 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define BIAPY_P16_7 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define BIAPY_COMMA ,
#define BIAPY_ACC8(d, i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define BIAPY_ACC16(d, i) BIAPY_ACC8(d, i), BIAPY_ACC8(d, i + 8)
#define BIAPY_ACC32(d, i) BIAPY_ACC16(d, i), BIAPY_ACC16(d, i + 16)
#define BIAPY_ACC64(d, i) BIAPY_ACC32(d, i), BIAPY_ACC32(d, i + 32)

// d (64 x N, float32, in the warpgroup's registers) += A (64 x 16, bf16,
// shared memory, K-major) * B (N x 16, bf16, shared memory, K-major)^T.
// The operand after the descriptors is scale-d (1: accumulate).
#define BIAPY_WGMMA(N, REGS, ACCS, A_OP, B_OP, S_OP)                                       \
  template <> struct Wgmma<N> {                                                            \
    __device__ __forceinline__ static void mma(float (&d)[N / 2], uint64_t a, uint64_t b) { \
      asm volatile(                                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " S_OP ", 0;\n"                               \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, " A_OP     \
          ", " B_OP ", p, 1, 1, 0, 0;\n}\n"                                                \
          : ACCS                                                                           \
          : "l"(a), "l"(b), "r"(1));                                                       \
    }                                                                                      \
  }

template <int N> struct Wgmma;
BIAPY_WGMMA(32, BIAPY_P16_0, BIAPY_ACC16(d, 0), "%16", "%17", "%18");
BIAPY_WGMMA(64, BIAPY_P16_0 ", " BIAPY_P16_1, BIAPY_ACC32(d, 0), "%32", "%33", "%34");
BIAPY_WGMMA(96, BIAPY_P16_0 ", " BIAPY_P16_1 ", " BIAPY_P16_2,
            BIAPY_ACC32(d, 0) BIAPY_COMMA BIAPY_ACC16(d, 32), "%48", "%49", "%50");
BIAPY_WGMMA(128, BIAPY_P16_0 ", " BIAPY_P16_1 ", " BIAPY_P16_2 ", " BIAPY_P16_3,
            BIAPY_ACC64(d, 0), "%64", "%65", "%66");
BIAPY_WGMMA(192,
            BIAPY_P16_0 ", " BIAPY_P16_1 ", " BIAPY_P16_2 ", " BIAPY_P16_3 ", " BIAPY_P16_4
                        ", " BIAPY_P16_5,
            BIAPY_ACC64(d, 0) BIAPY_COMMA BIAPY_ACC32(d, 64), "%96", "%97", "%98");
BIAPY_WGMMA(256,
            BIAPY_P16_0 ", " BIAPY_P16_1 ", " BIAPY_P16_2 ", " BIAPY_P16_3 ", " BIAPY_P16_4
                        ", " BIAPY_P16_5 ", " BIAPY_P16_6 ", " BIAPY_P16_7,
            BIAPY_ACC64(d, 0) BIAPY_COMMA BIAPY_ACC64(d, 64), "%128", "%129", "%130");

template <int BN, int KC, int MINB, int NWG> struct TcTile {
  static constexpr int kBrickY = kWgY * NWG;  // output voxels of a brick along y
  static constexpr int kSlabY = kBrickY + 2;  // rows of y in the A slab: the brick and its dy halo
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 32;  // the consumer warpgroups and one producer warp
  static constexpr int kRowBytes = KC * 2;
  static constexpr int kABytes = kSlabY * kBrickX * kRowBytes;  // the y-slab of one (dz, dx, chunk)
  static constexpr int kBTapBytes = BN * kRowBytes;      // one tap's (BN, KC) weights
  static constexpr int kStageBytes = kABytes + 3 * kBTapBytes;
  static constexpr int kOutPitch = BN + 8;  // bf16 per staged output row: no bank conflicts
  // the ring takes what the budget leaves after the slack that aligns it
  static constexpr int kFit = (smem_budget(MINB) - 1024 - 256) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
  static_assert(kABytes % 1024 == 0 && kBTapBytes % 1024 == 0, "tiles start on swizzle atoms");
  static_assert(kStages >= 2, "the consumers release a stage one step late");
  static_assert(kStages * kStageBytes >= 64 * NWG * kOutPitch * 2, "the epilogue reuses the ring");
};

template <int BN, int KC, int MINB, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, MINB)
conv3d_k3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w, __nv_bfloat16* __restrict__ y,
                       int D, int H, int W, int Cin, int Cout, int tiles_x, int tiles_y) {
  using T = TcTile<BN, KC, MINB, NWG>;
  constexpr int stages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_bar[stages], empty_bar[stages];
  // the ring starts on a 1024-byte boundary of the shared address space
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  int b = blockIdx.x;
  const int x0 = (b % tiles_x) * kBrickX; b /= tiles_x;
  const int y0 = (b % tiles_y) * T::kBrickY; b /= tiles_y;
  const int z = b % D;
  const int n = b / D;
  const int n0 = blockIdx.y * BN;
  const int chunks = (Cin + KC - 1) / KC;
  const int steps = 9 * chunks;  // (dz, dx, chunk); the three dy taps share a step

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);   // the producer's expect_tx arrival
      mbar_init(smem_u32(&empty_bar[s]), 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int it = 0; it < steps; ++it) {
        const int tap2 = it / chunks;  // dz * 3 + dx
        const int c0 = (it - tap2 * chunks) * KC;
        const int dz = tap2 / 3, dx = tap2 - dz * 3;
        const uint32_t full = smem_u32(&full_bar[s]);
        mbar_wait(smem_u32(&empty_bar[s]), phase ^ 1u);  // passes at once on the first round
        mbar_expect_tx(full, T::kStageBytes);
        const uint32_t a_dst = ring + s * T::kStageBytes;
        tma_load_5d(a_dst, &map_x, full, c0, x0 + dx - 1, y0 - 1, z + dz - 1, n);
        tma_load_5d(a_dst + T::kABytes, &map_w, full, c0, n0, dx, 0, dz);
        if (++s == stages) { s = 0; phase ^= 1u; }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64 * wg, 64 * wg + 64) of the brick
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < steps; ++it) {
    mbar_wait(smem_u32(&full_bar[s]), phase);
    const uint32_t a0 = ring + s * T::kStageBytes + wg * 64 * T::kRowBytes;
    const uint32_t b0 = ring + s * T::kStageBytes + T::kABytes;
    wgmma_fence();
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const uint64_t da = smem_desc<T::kRowBytes>(a0 + dy * kBrickX * T::kRowBytes);
      const uint64_t db = smem_desc<T::kRowBytes>(b0 + dy * T::kBTapBytes);
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)  // 16 channels = 32 bytes = 2 address units on
        Wgmma<BN>::mma(acc, da + 2 * k, db + 2 * k);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of the step before has retired: its stage is free
    if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
    prev = s;
    if (++s == stages) { s = 0; phase ^= 1u; }
  }
  wgmma_wait<0>();

  // epilogue: all warpgroups are done with the ring, which becomes the staging
  // area (every load issued has been waited for, so no copy is still in flight)
  asm volatile("bar.sync 1, %0;\n" ::"n"(T::kConsumers) : "memory");
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(ring_ptr) + wg * 64 * T::kOutPitch;
  {
    // accumulator layout of m64nN: thread (warp w, lane l) holds rows
    // 16w + l/4 and + 8, columns 8j + 2*(l%4) and + 1
    const int r0 = (warp & 3) * 16 + (lane >> 2);
    const int cbase = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      *reinterpret_cast<__nv_bfloat162*>(out + r0 * T::kOutPitch + 8 * j + cbase) = lo;
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * T::kOutPitch + 8 * j + cbase) = hi;
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  constexpr int kVecs = BN / 8;  // 16-byte vectors per output row
  const int t = tid & 127;
  const long long plane = ((long long)n * D + z) * H;
  for (int i = t; i < 64 * kVecs; i += 128) {
    const int row = i / kVecs, v = i - row * kVecs;
    const int r = wg * 64 + row;
    const int oy = y0 + r / kBrickX, ox = x0 + r % kBrickX;
    const int co = n0 + 8 * v;
    if (oy < H && ox < W && co < Cout)
      *reinterpret_cast<uint4*>(y + ((plane + oy) * W + ox) * Cout + co) =
          *reinterpret_cast<const uint4*>(out + row * T::kOutPitch + 8 * v);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process already runs on
// (the kernels are linked against the runtime only)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return h ? reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// error codes of the tensor-core launcher that are not cudaError values
constexpr int kErrNoEncoder = -1;   // cuTensorMapEncodeTiled not found
constexpr int kErrEncodeBase = -1000;   // minus the CUresult of a refused tensor map

template <int BN, int KC, int MINB, int NWG>
int launch_tc(const void* x, const void* wp, void* y, int n_img, int D, int H, int W, int Cin,
              int Cout, cudaStream_t stream) {
  using T = TcTile<BN, KC, MINB, NWG>;
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return kErrNoEncoder;
  const CUtensorMapSwizzle swizzle =
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const cuuint64_t e = 2;  // bytes per element

  // x, innermost first: (Cin, W, H, D, N); the box is the y-slab of one brick
  CUtensorMap map_x, map_w;
  const cuuint64_t xd[5] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                            (cuuint64_t)n_img};
  const cuuint64_t xs[4] = {e * Cin, e * Cin * W, e * Cin * W * H, e * Cin * W * H * D};
  const cuuint32_t xb[5] = {KC, kBrickX, T::kSlabY, 1, 1};
  CUresult rc = encode(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), xd, xs,
                       xb, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return kErrEncodeBase - (int)rc;
  // packed weights (27, Cout, Cin), innermost first: (Cin, Cout, dx, dy, dz);
  // the box is the three dy taps of one (dz, dx)
  const cuuint64_t wd[5] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 3, 3, 3};
  const cuuint64_t ws[4] = {e * Cin, e * Cin * Cout, 3 * e * Cin * Cout, 9 * e * Cin * Cout};
  const cuuint32_t wb[5] = {KC, BN, 1, 3, 1};
  rc = encode(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(wp), wd, ws, wb,
              ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return kErrEncodeBase - (int)rc;

  auto kernel = conv3d_k3_wgmma_kernel<BN, KC, MINB, NWG>;
  // per device, so set at every launch (dynamic shared memory above 48 KB)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kBrickX - 1) / kBrickX, tiles_y = (H + T::kBrickY - 1) / T::kBrickY;
  dim3 grid((unsigned)((long long)n_img * D * tiles_y * tiles_x), (unsigned)((Cout + BN - 1) / BN));
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      map_x, map_w, static_cast<__nv_bfloat16*>(y), D, H, W, Cin, Cout, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

}  // namespace

// The tensor-core route: x (N, D, H, W, Cin) bf16, wp the packed weights
// (27, Cout, Cin) bf16 (tap-major, then output channel, input channel
// contiguous), y (N, D, H, W, Cout) bf16; Cin % 16 == 0, Cout % 8 == 0, all
// three pointers 16-byte aligned. Returns 0, a cudaError, or a negative code
// (-1: no cuTensorMapEncodeTiled in libcuda, -1000 - r: libcuda refused a
// tensor map with CUresult r).
extern "C" int biapy_conv3d_k3_wgmma(const void* x, const void* wp, void* y, int n_img, int D,
                                     int H, int W, int Cin, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin <= 0 || Cin % 16 != 0 || Cout <= 0 || Cout % 8 != 0) return (int)cudaErrorInvalidValue;
  // BN: the narrowest tile that holds Cout (rows of B past Cout arrive as
  // zeros and are not written); above 256 the grid's second dimension walks
  // tiles. KC: 64 channels a step (128-byte rows) where 64 divides Cin and the
  // tile is narrow enough to leave the ring its depth, else 32 (64-byte rows).
  // MINB: two blocks an SM where registers and shared memory allow it.
  // NWG: four consumer warpgroups (a 16 x 16 brick: the weights of a step
  // feed twice the voxels and the dy halo is 2 rows in 18, not in 10) where
  // the accumulators leave room (BN <= 128), the taller brick overhangs the
  // volume no further and there are bricks for two waves of an H100's 132
  // SMs; else two (8 x 16). Measured on the main path's shapes, each choice
  // is the faster of its alternatives, by 9-23% where they differ.
#define BIAPY_TC(BN, KC, MINB, NWG) \
  return launch_tc<BN, KC, MINB, NWG>(x, wp, y, n_img, D, H, W, Cin, Cout, s)
  const long long tall_bricks = (long long)n_img * D * ((H + 15) / 16) * ((W + 15) / 16);
  if (Cout <= 128 && 2 * ((H + 15) / 16) == (H + 7) / 8 && tall_bricks >= 2 * 132) {
    if (Cout <= 64 && Cin % 64 == 0) {
      if (Cout <= 32) BIAPY_TC(32, 64, 2, 4);
      BIAPY_TC(64, 64, 1, 4);
    }
    if (Cout <= 32) BIAPY_TC(32, 32, 2, 4);
    if (Cout <= 64) BIAPY_TC(64, 32, 1, 4);
    if (Cout <= 96) BIAPY_TC(96, 32, 1, 4);
    BIAPY_TC(128, 32, 1, 4);
  }
  if (Cout <= 64 && Cin % 64 == 0) {
    if (Cout <= 32) BIAPY_TC(32, 64, 2, 2);
    BIAPY_TC(64, 64, 2, 2);
  }
  if (Cout <= 32) BIAPY_TC(32, 32, 2, 2);
  if (Cout <= 64) BIAPY_TC(64, 32, 2, 2);
  if (Cout <= 96) BIAPY_TC(96, 32, 2, 2);
  if (Cout <= 128) BIAPY_TC(128, 32, 2, 2);
  if (Cout <= 192) BIAPY_TC(192, 32, 1, 2);
  BIAPY_TC(256, 32, 1, 2);
#undef BIAPY_TC
}

// The CUDA-core route. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int biapy_conv3d_k3(const void* x, const void* w, void* y, int dtype, int n_img,
                               int D, int H, int W, int Cin, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float>(x, w, y, n_img, D, H, W, Cin, Cout, s);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(x, w, y, n_img, D, H, W, Cin, Cout, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
