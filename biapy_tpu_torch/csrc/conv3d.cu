// 3x3x3, stride-1, SAME convolution on channels-last volumes, for Hopper
// (sm_90a): three kernels, one per route (the wrapper's rule on dtype, Cin
// and Cout picks the route; nothing here chooses at run time).
//
// All three replace: biapy_tpu/ops/pallas/conv3d.py::_kernel (launched by
// _conv3d_pallas, reached from biapy_tpu/ops/conv3d.py::conv3d_dispatch).
//
// Function:
//   y[n, z, y, x, co] = sum_{dz, dy, dx, ci} x[n, z+dz-1, y+dy-1, x+dx-1, ci]
//                                            * w[dz, dy, dx, ci, co]
// x is NDHWC, both operands contiguous and of one dtype; taps outside the
// volume read zero; the sum is kept in float32 and y is written in the input
// dtype. No bias.
//
// What bounds it on this card: operations where Cin is a few channels or
// more. A voxel costs 54*Cin*Cout flops against (Cin + Cout) * itemsize
// bytes, far above the H100's ~295 flop/byte ridge from Cin ~ 16 on; the
// stems (Cin = 1..3) are bound by the bytes of their output.
//
// 1. conv3d_k3_wgmma_kernel, the tensor-core route (bf16, Cin >= the stem
//    cut, any Cout): bf16 operands staged in shared memory by TMA, products
//    by wgmma (m64nNk16, float32 accumulators in registers), a ring of
//    stages whose copies overlap the arithmetic. What bounds it in practice
//    is the traffic from the L2 into shared memory (every tap re-reads the
//    activation) and, for narrow Cout, the A reads of wgmma itself; the
//    design cuts the first by loading one y-slab for the three dy taps.
//      - Widths off the grid: x's channel count must be a multiple of 8
//        (TMA's 16-byte global strides); where it is not (Cin 28, 36, 84)
//        the wrapper hands over a channel-padded copy that
//        pad_channels_kernel (below) writes, one more read and write of x.
//        Gathering such rows with 8-byte cp.async copies in the producer
//        warp instead was measured slower at every template shape: one warp
//        cannot issue a stage's 2304 copies as fast as the tensor cores use
//        them. The packed weights are
//        (27, Cout_p, Cin_p), zero-padded to multiples of 8. Channels past
//        the tensor's arrive from TMA as zeros, so a Cin that the chunk does
//        not divide costs no mask arithmetic. The tile's N is the narrowest
//        instantiated width that holds Cout_p (8, 16, 32, 40, 48, 64, 96,
//        128, 192, 256), and the epilogue writes the real channels alone,
//        with the widest store the row's alignment allows.
//      - A block owns a brick of 1 x 8 x 16 or 1 x 16 x 16 (z, y, x) output
//        voxels of one image (one 64-row wgmma tile, 4 rows of y, for each of
//        its two or four consumer warpgroups) and a tile of BN <= 256 output
//        channels (all of Cout up to 256, so A is staged once per tap, not
//        once per Cout tile).
//      - K is walked as (dz, dx, channel chunk); one ring stage holds the A
//        slab of that step, a TMA box (KC, 16, 10 or 18, 1, 1) of x starting
//        at (c0, x0+dx-1, y0-1, z+dz-1, n), and the weights of its three dy
//        taps, a box (KC, BN, 1, 3, 1) of the packed weights seen as
//        (Cin_p, Cout_p, 3, 3, 3). Chunks are KC = 32 or 64 channels, and
//        where 32 leaves 16 over (Cin_p 16, 40, 48, 80) a tap's last 16
//        channels are a step of their own through a second pair of tensor
//        maps (32-byte rows), so no step walks a half-empty chunk; those
//        steps come after every tap's whole chunks, in a loop of their own
//        (ptxas serializes the wgmmas under a branch that picks a step's
//        kind: its warning C7520). TMA
//        coordinates are signed and elements outside the tensor arrive as
//        zeros: that is the SAME padding and the channel tail, with no
//        padded copy of the volume and no mask arithmetic in any thread; n
//        is its own coordinate, so no tap crosses an image seam.
//      - The slab lands as 160 or 288 rows (y*16 + x) of KC channels,
//        K-major and swizzled over the row (64-byte rows: SWIZZLE_64B;
//        128-byte: SWIZZLE_128B; the tail's 32-byte: SWIZZLE_32B): the tile
//        a wgmma descriptor reads. Tap dy of output row r reads slab row
//        r + 16*dy, a whole number of swizzle atoms further on, so the
//        three taps are three descriptors into one slab.
//      - One producer thread keeps the TMA loads in flight (full / empty
//        mbarrier pair per stage); the consumer warpgroups issue the wgmmas
//        of a stage as one group and release the stage before once the group
//        before has retired.
//      - Epilogue: float32 -> bf16 through (padded, conflict-free) shared
//        memory, then 16-, 8-, 4- or 2-byte stores by Cout's alignment;
//        voxels of a brick that overhang the volume and channels past Cout
//        are not written.
//
// 2. conv3d_k3_stem_kernel, the stem route (float32 or bf16, Cin below the
//    cut: the 1-channel input of every U-Net, 3-channel images): K = 27*Cin
//    is too short for the tensor cores' tiles to pay (a 16-deep wgmma step
//    would be mostly zeros) and the output, Cout values a voxel, is what the
//    card must move. A block (2 x 8 x 32 output voxels) stages a halo brick
//    of x (4 x 10 x 34 voxels) and the 27*Cin x 32 weights of an
//    output-channel chunk in shared memory as float32, once; each of its 256
//    threads computes the chunk's 32 channels at one (y, x) of both z planes
//    with float32 FMAs (27*Cin*32 a voxel; per tap and input channel 2 halo
//    reads and 8 broadcast 16-byte weight reads feed 64 FMAs) and writes
//    them with 16-byte stores (8-, 4- or 2-byte where Cout's alignment
//    allows no wider). On the card two planes a thread ran faster than one
//    (the weights' reads then feed twice the FMAs) and than four lanes a
//    voxel with stores coalesced across the warp.
//
// 3. conv3d_k3_tf32x3_kernel, the 3xTF32 route (float32 at Cin >= the stem
//    cut, any Cout): float32 on the tensor cores at float32's accuracy. One
//    TF32 product keeps 11 bits of each operand (about 1e-3 of relative
//    error), so each operand a is split into hi = tf32(a) and lo =
//    tf32(a - hi) (cvt.rna.tf32.f32: nearest, ties away from zero; a - hi
//    is exact), and each product is taken as a_hi*b_hi + a_lo*b_hi +
//    a_hi*b_lo (a_lo*b_lo, 2^-22 of it, is dropped): three m64nNk8 tf32
//    wgmmas where one bf16 wgmma does the same work, so its ceiling is a
//    third of the card's 495 TFLOP/s of TF32, 2.5x the CUDA cores' 67 of
//    float32. What bounds it besides is the L2 -> shared traffic: float32
//    rows twice bf16's bytes a channel, and each operand twice over.
//      - The layout is the bf16 kernel's: a brick of 1 x 8 x 16 voxels (two
//        consumer warpgroups), K walked as
//        (dz, dx, channel chunk), one y-slab a step serving the three dy
//        taps, TMA boxes whose zero fill is the SAME padding and the
//        channel tail, chunks of KC = 16 or 32 float32 channels (64- or
//        128-byte rows) and 8-channel tail steps (32-byte rows) in a loop
//        of their own, tiles of at most 96 output channels (three float32
//        sums of BN / 2 registers a thread, below).
//      - Both operands arrive split: tf32_split_kernel writes x_hi and x_lo
//        (channels padded to 4, TMA's 16-byte rows), the wrapper packs
//        w_hi and w_lo, each (27, Cout_p, Cin_p); a stage holds the slabs of
//        x_hi and x_lo and the taps of w_hi and w_lo, and every wgmma reads
//        both operands from shared memory. Splitting x in the consumers'
//        registers instead (one slab, A from registers) was measured slower
//        at nearly every shape, even against this kernel plus the split's
//        pass, and left no registers for the sums below (it spilled at a
//        tile of 128).
//      - Accumulation: the tensor cores align a wgmma's products to the
//        largest exponent among them and the accumulator and truncate, so a
//        long chain of wgmmas into one accumulator drifts. Each ring step's
//        a_hi*b_hi products go into a fresh accumulator (scale-d 0 on its
//        first wgmma), added once retired to a float32 total in registers;
//        the small terms go into an accumulator of their own over the
//        whole K, where the truncations are 2^-11 of the large terms'. One
//        accumulator for all three terms of a step (36 wgmmas at KC = 32)
//        left the instance template's float32 step 4.3e-5 from float64
//        (tools/torch_instance_step_witness.py), farther than the JAX
//        package's own 3.2e-5.
//      - Epilogue: the float32 totals through (padded) shared memory, then
//        16-, 8- or 4-byte stores by Cout's alignment, the real channels
//        and voxels only.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// the bits of one stored element
__device__ __forceinline__ uint32_t out_bits(float v, float*) { return __float_as_uint(v); }
__device__ __forceinline__ uint16_t out_bits(float v, __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int BYTES> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<2> { using type = uint16_t; };

// V float32 values rounded to T and written as one V * sizeof(T)-byte store
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* dst, const float* v) {
  using Bits = decltype(out_bits(0.f, static_cast<T*>(nullptr)));
  using Vec = typename VecOf<V * sizeof(T)>::type;
  union {
    Vec vec;
    Bits e[V];
  } u;
#pragma unroll
  for (int i = 0; i < V; ++i) u.e[i] = out_bits(v[i], static_cast<T*>(nullptr));
  *reinterpret_cast<Vec*>(dst) = u.vec;
}

// ---------------------------------------------------------------------------
// The stem route: a halo brick and the weights in shared memory, 32 output
// channels at one (y, x) of two z planes a thread.
// ---------------------------------------------------------------------------

constexpr int kStemX = 32;     // output voxels of a block along x
constexpr int kStemY = 8;      // ... along y: 256 threads, one (y, x) each
constexpr int kStemZ = 2;      // ... along z: each thread computes both planes
constexpr int kStemCo = 32;    // output channels a thread computes at a time
// the widest Cin the entry takes: above the wrapper's cut (Cin < 4), so
// that the cut can be measured on both sides of it
// (tools/torch_conv3d_f32_ab.py --cut calls the entries directly)
constexpr int kStemMaxCin = 8;
constexpr int kStemHX = kStemX + 2, kStemHY = kStemY + 2, kStemHZ = kStemZ + 2;

// a voxel's n (a multiple of V) output channels of a chunk, V a store
template <typename T, int V>
__device__ __forceinline__ void stem_store(T* dst, const float* acc, int n) {
#pragma unroll
  for (int c = 0; c < kStemCo; c += V)
    if (c < n) store_vec<T, V>(dst + c, acc + c);
}

template <typename T>
__global__ void __launch_bounds__(kStemX * kStemY)
conv3d_k3_stem_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int D,
                      int H, int W, int Cin, int Cout, int tiles_x, int tiles_y, int tiles_z) {
  extern __shared__ float4 stem_smem[];
  float* halo = reinterpret_cast<float*>(stem_smem);  // [kStemHZ][kStemHY][kStemHX][Cin]
  // [27 * Cin][kStemCo]; 4 * 10 * 34 floats a channel keep it 16-byte aligned
  float* ws = halo + kStemHZ * kStemHY * kStemHX * Cin;

  int b = blockIdx.x;
  const int x0 = (b % tiles_x) * kStemX; b /= tiles_x;
  const int y0 = (b % tiles_y) * kStemY; b /= tiles_y;
  const int z0 = (b % tiles_z) * kStemZ;
  const int n = b / tiles_z;
  const int tid = threadIdx.x;
  const int tx = tid % kStemX, ty = tid / kStemX;

  // the halo: rows of kStemHX voxels x Cin channels, contiguous in x
  const int row = kStemHX * Cin;
  for (int e = tid; e < kStemHZ * kStemHY * row; e += kStemX * kStemY) {
    const int r = e / row, c = e - r * row;
    const int hz = r / kStemHY, hy = r - hz * kStemHY;
    const int iz = z0 + hz - 1, iy = y0 + hy - 1, ix = x0 - 1 + c / Cin;
    float v = 0.f;
    if ((unsigned)iz < (unsigned)D && (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W)
      v = to_f32(x[((((long long)n * D + iz) * H + iy) * W + x0 - 1) * Cin + c]);
    halo[e] = v;
  }

  const int K = 27 * Cin;
  const int oy = y0 + ty, ox = x0 + tx;
  const float* hp = halo + (ty * kStemHX + tx) * Cin;
  constexpr int kPlane = kStemHY * kStemHX;  // halo voxels a z plane
  for (int co0 = 0; co0 < Cout; co0 += kStemCo) {
    __syncthreads();  // the halo is in; the chunk before is read
    for (int e = tid; e < K * kStemCo; e += kStemX * kStemY) {
      const int k = e / kStemCo, c = e - k * kStemCo;
      ws[e] = co0 + c < Cout ? to_f32(w[(long long)k * Cout + co0 + c]) : 0.f;
    }
    __syncthreads();
    float acc[kStemZ][kStemCo];
#pragma unroll
    for (int v = 0; v < kStemZ; ++v)
#pragma unroll
      for (int c = 0; c < kStemCo; ++c) acc[v][c] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
      const float* xp = hp + ((dz * kStemHY + dy) * kStemHX + dx) * Cin;
      const float4* wp = reinterpret_cast<const float4*>(ws + tap * Cin * kStemCo);
      for (int ci = 0; ci < Cin; ++ci) {
        float xv[kStemZ];
#pragma unroll
        for (int v = 0; v < kStemZ; ++v) xv[v] = xp[v * kPlane * Cin + ci];
#pragma unroll
        for (int q = 0; q < kStemCo / 4; ++q) {
          const float4 wv = wp[ci * (kStemCo / 4) + q];
#pragma unroll
          for (int v = 0; v < kStemZ; ++v) {
            acc[v][4 * q] = fmaf(xv[v], wv.x, acc[v][4 * q]);
            acc[v][4 * q + 1] = fmaf(xv[v], wv.y, acc[v][4 * q + 1]);
            acc[v][4 * q + 2] = fmaf(xv[v], wv.z, acc[v][4 * q + 2]);
            acc[v][4 * q + 3] = fmaf(xv[v], wv.w, acc[v][4 * q + 3]);
          }
        }
      }
    }
    if (oy < H && ox < W) {
      const int left = Cout - co0;
#pragma unroll
      for (int v = 0; v < kStemZ; ++v) {
        if (z0 + v >= D) continue;
        T* dst = y + ((((long long)n * D + z0 + v) * H + oy) * W + ox) * Cout + co0;
        // the widest store that every row start keeps aligned: co0 and Cout
        // are multiples of it
        constexpr int kMax = 16 / sizeof(T);
        if (Cout % kMax == 0) stem_store<T, kMax>(dst, acc[v], left);
        else if (Cout % 4 == 0) stem_store<T, 4>(dst, acc[v], left);
        else if (Cout % 2 == 0) stem_store<T, 2>(dst, acc[v], left);
        else stem_store<T, 1>(dst, acc[v], left);
      }
    }
  }
}

template <typename T>
int launch_stem(const void* x, const void* w, void* y, int n_img, int D, int H, int W, int Cin,
                int Cout, cudaStream_t stream) {
  auto kernel = conv3d_k3_stem_kernel<T>;
  const int smem =
      (kStemHZ * kStemHY * kStemHX * Cin + 27 * Cin * kStemCo) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kStemX - 1) / kStemX, tiles_y = (H + kStemY - 1) / kStemY;
  const int tiles_z = (D + kStemZ - 1) / kStemZ;
  kernel<<<(unsigned)((long long)n_img * tiles_z * tiles_y * tiles_x), kStemX * kStemY, smem,
           stream>>>(static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), D,
                     H, W, Cin, Cout, tiles_x, tiles_y, tiles_z);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core route: TMA-staged bf16 tiles, wgmma, a ring of stages.
// ---------------------------------------------------------------------------

constexpr int kBrickX = 16;  // output voxels of a brick along x
constexpr int kWgY = 4;      // ... along y for each consumer warpgroup: one 64-row wgmma tile
constexpr int kMaxStages = 8;
constexpr int kTailKC = 16;  // channels of a tail step: one wgmma deep, 32-byte rows
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

#define BIAPY_P4_0 "%0, %1, %2, %3"
#define BIAPY_P8_0 BIAPY_P4_0 ", %4, %5, %6, %7"
#define BIAPY_P16_0 BIAPY_P8_0 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define BIAPY_P16_1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define BIAPY_P16_2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define BIAPY_P16_3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define BIAPY_P16_4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define BIAPY_P16_5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define BIAPY_P16_6 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
#define BIAPY_P16_7 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define BIAPY_COMMA ,
#define BIAPY_ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define BIAPY_ACC8(d, i) BIAPY_ACC4(d, i), BIAPY_ACC4(d, i + 4)
#define BIAPY_ACC16(d, i) BIAPY_ACC8(d, i), BIAPY_ACC8(d, i + 8)
#define BIAPY_ACC32(d, i) BIAPY_ACC16(d, i), BIAPY_ACC16(d, i + 16)
#define BIAPY_ACC64(d, i) BIAPY_ACC32(d, i), BIAPY_ACC32(d, i + 32)

// d (64 x N, float32, in the warpgroup's registers) += A (64 x 16, bf16,
// shared memory, K-major) * B (N x 16, bf16, shared memory, K-major)^T.
// The operand after the descriptors is scale-d (1: accumulate). Tf32Ss<N>:
// the same from 64 x 8 and N x 8 tiles of TF32 values (32-byte rows, as
// bf16's 16); scale-d 0 starts a fresh sum.
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
  };                                                                                       \
  template <> struct Tf32Ss<N> {                                                           \
    __device__ __forceinline__ static void mma(float (&d)[N / 2], uint64_t a, uint64_t b,   \
                                               int scale_d) {                              \
      asm volatile(                                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, " S_OP ", 0;\n"                               \
          "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS "}, " A_OP      \
          ", " B_OP ", p, 1, 1;\n}\n"                                                      \
          : ACCS                                                                           \
          : "l"(a), "l"(b), "r"(scale_d));                                                 \
    }                                                                                      \
  }

template <int N> struct Wgmma;
template <int N> struct Tf32Ss;
BIAPY_WGMMA(8, BIAPY_P4_0, BIAPY_ACC4(d, 0), "%4", "%5", "%6");
BIAPY_WGMMA(16, BIAPY_P8_0, BIAPY_ACC8(d, 0), "%8", "%9", "%10");
BIAPY_WGMMA(32, BIAPY_P16_0, BIAPY_ACC16(d, 0), "%16", "%17", "%18");
BIAPY_WGMMA(40, BIAPY_P16_0 ", %16, %17, %18, %19", BIAPY_ACC16(d, 0) BIAPY_COMMA BIAPY_ACC4(d, 16),
            "%20", "%21", "%22");
BIAPY_WGMMA(48, BIAPY_P16_0 ", %16, %17, %18, %19, %20, %21, %22, %23",
            BIAPY_ACC16(d, 0) BIAPY_COMMA BIAPY_ACC8(d, 16), "%24", "%25", "%26");
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
  static constexpr int kTxBytes = kABytes + 3 * kBTapBytes;  // what a step's two loads bring
  // a tail step: the same boxes at 16 channels (32-byte rows); its B tile
  // sits where a full step's does
  static constexpr int kTailTxBytes = (kSlabY * kBrickX + 3 * BN) * kTailKC * 2;
  // stages start on 1024-byte boundaries, the period of every swizzle mode
  static constexpr int kStageBytes = (kTxBytes + 1023) / 1024 * 1024;
  static constexpr int kOutPitch = BN + 8;  // bf16 per staged output row: no bank conflicts
  // the ring takes what the budget leaves after the slack that aligns it
  static constexpr int kFit = (smem_budget(MINB) - 1024 - 256) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
  // every tile a descriptor or TMA box starts at is a whole number of
  // swizzle periods (8 rows) from the stage's start
  static_assert(kABytes % 1024 == 0 && BN % 8 == 0, "tiles start on swizzle atoms");
  static_assert(kStages >= 2, "the consumers release a stage one step late");
  static_assert(kStages * kStageBytes >= 64 * NWG * kOutPitch * 2, "the epilogue reuses the ring");
};

// the staged output rows of one warpgroup (64 x BN elements E at pitch PITCH)
// to y, V channels a store; rows past the volume and channels past Cout
// unwritten
template <typename E, int V, int BN, int PITCH>
__device__ __forceinline__ void tc_store(const E* out, E* y, int t, int wg, long long plane,
                                         int x0, int y0, int n0, int H, int W, int Cout) {
  using Vec = typename VecOf<V * sizeof(E)>::type;
  constexpr int kVecs = BN / V;  // stores per output row
  for (int i = t; i < 64 * kVecs; i += 128) {
    const int row = i / kVecs, v = i - row * kVecs;
    const int r = wg * 64 + row;
    const int oy = y0 + r / kBrickX, ox = x0 + r % kBrickX;
    const int co = n0 + V * v;
    if (oy < H && ox < W && co < Cout)
      *reinterpret_cast<Vec*>(y + ((plane + oy) * W + ox) * Cout + co) =
          *reinterpret_cast<const Vec*>(out + row * PITCH + V * v);
  }
}

template <int BN, int KC, int MINB, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, MINB)
conv3d_k3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_xt,
                       const __grid_constant__ CUtensorMap map_wt, __nv_bfloat16* __restrict__ y,
                       int D, int H, int W, int full, int tail, int Cout, int tiles_x,
                       int tiles_y) {
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
  // the steps: `full` chunks of KC channels for each (dz, dx), then a
  // 16-channel one for each if `tail`; the three dy taps share a step

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);   // the producer's expect_tx arrival
      mbar_init(smem_u32(&empty_bar[s]), 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // producer: one thread keeps the ring full, in the consumers' order of
    // steps: every (dz, dx)'s whole chunks, then every (dz, dx)'s tail
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      // one step's two loads into the next stage, from maps mx and mw
      auto load = [&](const CUtensorMap* mx, const CUtensorMap* mw, uint32_t bytes, int tap2,
                      int c0) {
        const int dz = tap2 / 3, dx = tap2 - dz * 3;
        const uint32_t full_b = smem_u32(&full_bar[s]);
        mbar_wait(smem_u32(&empty_bar[s]), phase ^ 1u);  // passes at once on the first round
        const uint32_t a_dst = ring + s * T::kStageBytes;
        mbar_expect_tx(full_b, bytes);
        tma_load_5d(a_dst, mx, full_b, c0, x0 + dx - 1, y0 - 1, z + dz - 1, n);
        tma_load_5d(a_dst + T::kABytes, mw, full_b, c0, n0, dx, 0, dz);
        if (++s == stages) { s = 0; phase ^= 1u; }
      };
      for (int tap2 = 0; tap2 < 9; ++tap2)  // dz * 3 + dx
        for (int ch = 0; ch < full; ++ch) load(&map_x, &map_w, T::kTxBytes, tap2, ch * KC);
      for (int tap2 = 0; tap2 < 9 * tail; ++tap2)
        load(&map_xt, &map_wt, T::kTailTxBytes, tap2, full * KC);
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64 * wg, 64 * wg + 64) of the brick
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  int s = 0, prev = 0, it = 0;
  uint32_t phase = 0;
  // a step's wgmmas are issued, as one group, by a loop of its own kind: a
  // wgmma under a branch is serialized by ptxas (C7520)
  auto wait_full = [&]() -> uint32_t {
    mbar_wait(smem_u32(&full_bar[s]), phase);
    wgmma_fence();
    return ring + s * T::kStageBytes;
  };
  auto retire = [&]() {
    wgmma_commit();
    wgmma_wait<1>();  // the group of the step before has retired: its stage is free
    if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
    prev = s;
    if (++s == stages) { s = 0; phase ^= 1u; }
    ++it;
  };
  for (int i = 0; i < 9 * full; ++i) {
    const uint32_t stage = wait_full();
    const uint32_t a0 = stage + wg * 64 * T::kRowBytes, b0 = stage + T::kABytes;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const uint64_t da = smem_desc<T::kRowBytes>(a0 + dy * kBrickX * T::kRowBytes);
      const uint64_t db = smem_desc<T::kRowBytes>(b0 + dy * T::kBTapBytes);
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)  // 16 channels = 32 bytes = 2 address units on
        Wgmma<BN>::mma(acc, da + 2 * k, db + 2 * k);
    }
    retire();
  }
  for (int i = 0; i < 9 * tail; ++i) {
    // a tail step: one 16-channel product a dy tap, 32-byte rows
    const uint32_t stage = wait_full();
    const uint32_t a0 = stage + wg * 64 * kTailKC * 2, b0 = stage + T::kABytes;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
      Wgmma<BN>::mma(acc, smem_desc<kTailKC * 2>(a0 + dy * kBrickX * kTailKC * 2),
                     smem_desc<kTailKC * 2>(b0 + dy * BN * kTailKC * 2));
    retire();
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
  const int t = tid & 127;
  const long long plane = ((long long)n * D + z) * H;
  // the widest store that keeps every row start aligned: Cout's largest
  // power-of-two factor, up to 8 channels (16 bytes)
  if (Cout % 8 == 0)
    tc_store<__nv_bfloat16, 8, BN, T::kOutPitch>(out, y, t, wg, plane, x0, y0, n0, H, W, Cout);
  else if (Cout % 4 == 0)
    tc_store<__nv_bfloat16, 4, BN, T::kOutPitch>(out, y, t, wg, plane, x0, y0, n0, H, W, Cout);
  else if (Cout % 2 == 0)
    tc_store<__nv_bfloat16, 2, BN, T::kOutPitch>(out, y, t, wg, plane, x0, y0, n0, H, W, Cout);
  else
    tc_store<__nv_bfloat16, 1, BN, T::kOutPitch>(out, y, t, wg, plane, x0, y0, n0, H, W, Cout);
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

CUtensorMapSwizzle swizzle_of(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// the element type and size of a tensor map: bf16 (2 bytes) or float32 (4)
struct MapElem {
  CUtensorMapDataType type;
  int bytes;
};
constexpr MapElem kBf16{CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2};
constexpr MapElem kF32{CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4};

// the map of x (N, D, H, W, Cin), Cin a whole number of 16-byte rows, for
// steps of kc channels: a box is the y-slab of one brick; returns 0 or the
// launcher's error code
int encode_x(EncodeTiledFn encode, CUtensorMap* map, MapElem el, const void* x, int n_img, int D,
             int H, int W, int Cin, int kc, int slab_y) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const cuuint64_t e = el.bytes;
  // innermost first: (Cin, W, H, D, N)
  const cuuint64_t xd[5] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D,
                            (cuuint64_t)n_img};
  const cuuint64_t xs[4] = {e * Cin, e * Cin * W, e * Cin * W * H, e * Cin * W * H * D};
  const cuuint32_t xb[5] = {(cuuint32_t)kc, kBrickX, (cuuint32_t)slab_y, 1, 1};
  const CUresult rc = encode(map, el.type, 5, const_cast<void*>(x), xd, xs, xb, ones,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(kc * el.bytes),
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrEncodeBase - (int)rc;
}

// the map of packed weights (27, Cout_p, Cin_p), Cin_p % 8 == 0, for steps
// of kc channels: a box is the three dy taps of one (dz, dx)
int encode_w(EncodeTiledFn encode, CUtensorMap* map, MapElem el, const void* wp, int Cin_p,
             int Cout_p, int kc, int bn) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const cuuint64_t e = el.bytes;
  // innermost first: (Cin_p, Cout_p, dx, dy, dz)
  const cuuint64_t wd[5] = {(cuuint64_t)Cin_p, (cuuint64_t)Cout_p, 3, 3, 3};
  const cuuint64_t ws[4] = {e * Cin_p, e * Cin_p * Cout_p, 3 * e * Cin_p * Cout_p,
                            9 * e * Cin_p * Cout_p};
  const cuuint32_t wb[5] = {(cuuint32_t)kc, (cuuint32_t)bn, 1, 3, 1};
  const CUresult rc = encode(map, el.type, 5, const_cast<void*>(wp), wd, ws, wb, ones,
                             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(kc * el.bytes),
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrEncodeBase - (int)rc;
}

template <int BN, int KC, int MINB, int NWG>
int launch_tc(const void* x, const void* wp, void* y, int n_img, int D, int H, int W, int Cin,
              int Cout, cudaStream_t stream) {
  using T = TcTile<BN, KC, MINB, NWG>;
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return kErrNoEncoder;
  const int cout_p = (Cout + 7) / 8 * 8;
  // the channel steps of a tap: whole chunks of KC over Cin rounded up to
  // wgmma's 16, and a 16-channel tail step for what KC leaves
  const int cin16 = (Cin + 15) / 16 * 16;
  const int full = cin16 / KC, tail = (cin16 % KC) / kTailKC;
  if (tail > 1) return (int)cudaErrorInvalidValue;  // KC = 64 takes Cin % 64 == 0 only
  CUtensorMap map_x, map_w, map_xt, map_wt;
  int rc = encode_x(encode, &map_x, kBf16, x, n_img, D, H, W, Cin, KC, T::kSlabY);
  if (!rc) rc = encode_w(encode, &map_w, kBf16, wp, Cin, cout_p, KC, BN);
  if (!rc && tail)
    rc = encode_x(encode, &map_xt, kBf16, x, n_img, D, H, W, Cin, kTailKC, T::kSlabY);
  if (!rc && tail) rc = encode_w(encode, &map_wt, kBf16, wp, Cin, cout_p, kTailKC, BN);
  if (rc) return rc;
  if (!tail) {  // never read: copies of the maps a launch does read
    map_xt = map_x;
    map_wt = map_w;
  }

  auto kernel = conv3d_k3_wgmma_kernel<BN, KC, MINB, NWG>;
  // per device, so set at every launch (dynamic shared memory above 48 KB)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kBrickX - 1) / kBrickX, tiles_y = (H + T::kBrickY - 1) / T::kBrickY;
  dim3 grid((unsigned)((long long)n_img * D * tiles_y * tiles_x), (unsigned)((Cout + BN - 1) / BN));
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(map_x, map_w, map_xt, map_wt,
                                                       static_cast<__nv_bfloat16*>(y), D, H, W,
                                                       full, tail, Cout, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The 3xTF32 route: float32 split into TF32 pairs, three products a k8 step
// on the tensor cores, the bf16 kernel's TMA ring and brick.
// ---------------------------------------------------------------------------

constexpr int kTf32TailKC = 8;  // channels of a tail step: one k8 wgmma deep, 32-byte rows

// a rounded to TF32 as bits: 10 mantissa bits, to nearest, ties away from
// zero (the wrapper's tf32_round reproduces it on the weights)
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// x (M, C) float32 to its TF32 pair, hi = tf32(x) and lo = tf32(x - hi)
// (x - hi is exact), each (M, Cp) with Cp = C rounded up to 4 (TMA's
// 16-byte rows) and zeros past C: a thread writes one 16-byte vector of
// each from one 16-byte load of x (V = 4, where 4 divides C and x is 16-byte
// aligned) or four 4-byte ones. Bound by bytes: x read once, 8 bytes
// written for each of its 4.
template <int V>
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ x, float4* __restrict__ hi, float4* __restrict__ lo,
                  long long M, int C, int Cp) {
  const int groups = Cp / 4;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= M * groups) return;
  const long long m = v / groups;
  const int c0 = (int)(v - m * groups) * 4;
  const float* src = x + m * C + c0;
  float a[4];
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    a[0] = q.x; a[1] = q.y; a[2] = q.z; a[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = c0 + c < C ? src[c] : 0.f;
  }
  uint32_t h[4], l[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    h[c] = tf32_rna(a[c]);
    l[c] = tf32_rna(a[c] - __uint_as_float(h[c]));
  }
  hi[v] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                      __uint_as_float(h[3]));
  lo[v] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                      __uint_as_float(l[3]));
}

template <int BN, int KC, int MINB, int NWG> struct Tf32Tile {
  static constexpr int kBrickY = kWgY * NWG;
  static constexpr int kSlabY = kBrickY + 2;
  static constexpr int kSlabRows = kSlabY * kBrickX;
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kRowBytes = KC * 4;
  static constexpr int kTailRowBytes = kTf32TailKC * 4;
  // a stage: x_hi's slab, x_lo's (from kABytes), w_hi's three dy taps of
  // (BN, KC) (from kBOff), w_lo's (kBLo after them)
  static constexpr int kABytes = kSlabRows * kRowBytes;
  static constexpr int kBOff = 2 * kABytes;
  static constexpr int kBTapBytes = BN * kRowBytes;
  static constexpr int kBLo = (3 * kBTapBytes + 1023) / 1024 * 1024;
  static constexpr int kTxBytes = 2 * kABytes + 6 * kBTapBytes;
  // a tail step: the same boxes at 8 channels (32-byte rows), at the same
  // offsets but w_lo's
  static constexpr int kTailBTapBytes = BN * kTailRowBytes;
  static constexpr int kTailBLo = (3 * kTailBTapBytes + 1023) / 1024 * 1024;
  static constexpr int kTailTxBytes = 2 * kSlabRows * kTailRowBytes + 6 * kTailBTapBytes;
  static constexpr int kStageBytes = (kBOff + kBLo + 3 * kBTapBytes + 1023) / 1024 * 1024;
  static constexpr int kOutPitch = BN + 8;  // floats per staged output row
  static constexpr int kFit = (smem_budget(MINB) - 1024 - 256) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024;
  static_assert(kABytes % 1024 == 0 && BN % 8 == 0, "tiles start on swizzle atoms");
  static_assert(kStages >= 2, "a ring of one stage would not overlap the copies");
  static_assert(kStages * kStageBytes >= 64 * NWG * kOutPitch * 4, "the epilogue reuses the ring");
};

// One ring step of one consumer warpgroup: the step's three dy taps and
// KCS / 8 k8 steps each, issued as one group and retired. a_hi b_hi goes
// into `big`, a fresh sum (scale-d 0 on its first wgmma), which the caller
// adds to a float32 total; a_lo b_hi and a_hi b_lo into `small`, which
// runs over every step (its terms are 2^-11 of big's, and so are the
// roundings of its additions). `a` is the ring offset of the warpgroup's
// first x_hi row at dy = 0 (x_lo's lies a_lo further on), `b` that of
// w_hi's tile (w_lo's lies b_lo further on).
template <int BN, int KCS>
__device__ __forceinline__ void tf32x3_step(float (&big)[BN / 2], float (&small)[BN / 2],
                                            uint32_t ring, uint32_t a, uint32_t a_lo, uint32_t b,
                                            uint32_t b_lo) {
  constexpr int kRow = KCS * 4;
  wgmma_fence();  // `big` and `small` are written before the wgmmas read them
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const uint64_t dah = smem_desc<kRow>(ring + a + dy * kBrickX * kRow);
    const uint64_t dal = smem_desc<kRow>(ring + a + a_lo + dy * kBrickX * kRow);
    const uint64_t dbh = smem_desc<kRow>(ring + b + dy * BN * kRow);
    const uint64_t dbl = smem_desc<kRow>(ring + b + b_lo + dy * BN * kRow);
#pragma unroll
    for (int kk = 0; kk < KCS / 8; ++kk) {  // 8 channels = 32 bytes = 2 address units
      Tf32Ss<BN>::mma(big, dah + 2 * kk, dbh + 2 * kk, dy + kk > 0);
      Tf32Ss<BN>::mma(small, dal + 2 * kk, dbh + 2 * kk, 1);
      Tf32Ss<BN>::mma(small, dah + 2 * kk, dbl + 2 * kk, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
}

template <int BN, int KC, int MINB, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, MINB)
conv3d_k3_tf32x3_kernel(const __grid_constant__ CUtensorMap map_xh,
                        const __grid_constant__ CUtensorMap map_xl,
                        const __grid_constant__ CUtensorMap map_wh,
                        const __grid_constant__ CUtensorMap map_wl,
                        const __grid_constant__ CUtensorMap map_xht,
                        const __grid_constant__ CUtensorMap map_xlt,
                        const __grid_constant__ CUtensorMap map_wht,
                        const __grid_constant__ CUtensorMap map_wlt, float* __restrict__ y,
                        int D, int H, int W, int full, int tail, int Cout, int tiles_x,
                        int tiles_y) {
  using T = Tf32Tile<BN, KC, MINB, NWG>;
  constexpr int stages = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full_bar[stages], empty_bar[stages];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  int blk = blockIdx.x;
  const int x0 = (blk % tiles_x) * kBrickX; blk /= tiles_x;
  const int y0 = (blk % tiles_y) * T::kBrickY; blk /= tiles_y;
  const int z = blk % D;
  const int n = blk / D;
  const int n0 = blockIdx.y * BN;
  // the steps: `full` chunks of KC channels for each (dz, dx), then `tail`
  // 8-channel ones for each; the three dy taps share a step

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(smem_u32(&full_bar[i]), 1);
      mbar_init(smem_u32(&empty_bar[i]), 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      // one step's four loads into the next stage: x_hi's and x_lo's
      // slabs, w_hi's and w_lo's taps
      auto load = [&](const CUtensorMap* mxh, const CUtensorMap* mxl, const CUtensorMap* mwh,
                      const CUtensorMap* mwl, uint32_t bytes, uint32_t lo, int tap2, int c0) {
        const int dz = tap2 / 3, dx = tap2 - dz * 3;
        const uint32_t full_b = smem_u32(&full_bar[s]);
        mbar_wait(smem_u32(&empty_bar[s]), phase ^ 1u);
        const uint32_t dst = ring + s * T::kStageBytes;
        mbar_expect_tx(full_b, bytes);
        tma_load_5d(dst, mxh, full_b, c0, x0 + dx - 1, y0 - 1, z + dz - 1, n);
        tma_load_5d(dst + T::kABytes, mxl, full_b, c0, x0 + dx - 1, y0 - 1, z + dz - 1, n);
        tma_load_5d(dst + T::kBOff, mwh, full_b, c0, n0, dx, 0, dz);
        tma_load_5d(dst + T::kBOff + lo, mwl, full_b, c0, n0, dx, 0, dz);
        if (++s == stages) { s = 0; phase ^= 1u; }
      };
      for (int tap2 = 0; tap2 < 9; ++tap2)  // dz * 3 + dx
        for (int ch = 0; ch < full; ++ch)
          load(&map_xh, &map_xl, &map_wh, &map_wl, T::kTxBytes, T::kBLo, tap2, ch * KC);
      for (int j = 0; j < tail; ++j)
        for (int tap2 = 0; tap2 < 9; ++tap2)
          load(&map_xht, &map_xlt, &map_wht, &map_wlt, T::kTailTxBytes, T::kTailBLo, tap2,
               full * KC + j * kTf32TailKC);
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [64 * wg, 64 * wg + 64) of the brick
  const int wg = warp >> 2;
  float total[BN / 2], big[BN / 2], small[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) total[i] = big[i] = small[i] = 0.f;
  int s = 0;
  uint32_t phase = 0;
  // once a step has retired its stage is free and its fresh sum joins the
  // total (a loop for each step kind: a wgmma under a branch is serialized
  // by ptxas, C7520)
  auto finish = [&]() {
    if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));
    if (++s == stages) { s = 0; phase ^= 1u; }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] += big[i];
  };
  for (int i = 0; i < 9 * full; ++i) {
    mbar_wait(smem_u32(&full_bar[s]), phase);
    const uint32_t so = s * T::kStageBytes;
    tf32x3_step<BN, KC>(big, small, ring, so + wg * 64 * T::kRowBytes, T::kABytes,
                        so + T::kBOff, T::kBLo);
    finish();
  }
  for (int i = 0; i < 9 * tail; ++i) {
    mbar_wait(smem_u32(&full_bar[s]), phase);
    const uint32_t so = s * T::kStageBytes;
    tf32x3_step<BN, kTf32TailKC>(big, small, ring, so + wg * 64 * T::kTailRowBytes, T::kABytes,
                                 so + T::kBOff, T::kTailBLo);
    finish();
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) total[i] += small[i];

  // epilogue: the ring, every load of which has been waited for, becomes
  // the staging area
  asm volatile("bar.sync 1, %0;\n" ::"n"(T::kConsumers) : "memory");
  float* out = reinterpret_cast<float*>(ring_ptr) + wg * 64 * T::kOutPitch;
  {
    // accumulator layout of m64nN: thread (warp w, lane l) holds rows
    // 16w + l/4 and + 8, columns 8j + 2*(l%4) and + 1
    const int r0 = (warp & 3) * 16 + (lane >> 2);
    const int cb = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(out + r0 * T::kOutPitch + 8 * j + cb) =
          make_float2(total[4 * j], total[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (r0 + 8) * T::kOutPitch + 8 * j + cb) =
          make_float2(total[4 * j + 2], total[4 * j + 3]);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  const int t = tid & 127;
  const long long plane = ((long long)n * D + z) * H;
  if (Cout % 4 == 0)
    tc_store<float, 4, BN, T::kOutPitch>(out, y, t, wg, plane, x0, y0, n0, H, W, Cout);
  else if (Cout % 2 == 0)
    tc_store<float, 2, BN, T::kOutPitch>(out, y, t, wg, plane, x0, y0, n0, H, W, Cout);
  else
    tc_store<float, 1, BN, T::kOutPitch>(out, y, t, wg, plane, x0, y0, n0, H, W, Cout);
}

// x_hi and x_lo (N, D, H, W, Cin) float32 with Cin % 4 == 0, w_hi and w_lo
// (27, Cout_p, Cin_p) float32 (Cin_p: Cin rounded up to 8), y (N, D, H, W,
// Cout)
template <int BN, int KC, int MINB, int NWG>
int launch_tf32x3(const void* xh, const void* xl, const void* wh, const void* wl, void* y,
                  int n_img, int D, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  using T = Tf32Tile<BN, KC, MINB, NWG>;
  EncodeTiledFn encode = encode_tiled();
  if (!encode) return kErrNoEncoder;
  const int cout_p = (Cout + 7) / 8 * 8, cin_p = (Cin + 7) / 8 * 8;
  // the channel steps of a tap: whole chunks of KC, then 8-channel tails
  const int full = cin_p / KC, tail = (cin_p % KC) / kTf32TailKC;
  // x_hi, x_lo, w_hi, w_lo; then the same four for the tail steps
  CUtensorMap m[8];
  int rc = 0;
  for (int t = 0; t < 1 + (tail > 0); ++t) {
    const int kc = t ? kTf32TailKC : KC;
    if (!rc) rc = encode_x(encode, &m[4 * t], kF32, xh, n_img, D, H, W, Cin, kc, T::kSlabY);
    if (!rc) rc = encode_x(encode, &m[4 * t + 1], kF32, xl, n_img, D, H, W, Cin, kc, T::kSlabY);
    if (!rc) rc = encode_w(encode, &m[4 * t + 2], kF32, wh, cin_p, cout_p, kc, BN);
    if (!rc) rc = encode_w(encode, &m[4 * t + 3], kF32, wl, cin_p, cout_p, kc, BN);
  }
  if (rc) return rc;
  if (!tail)  // never read: copies of the maps a launch does read
    for (int i = 0; i < 4; ++i) m[4 + i] = m[i];

  auto kernel = conv3d_k3_tf32x3_kernel<BN, KC, MINB, NWG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + kBrickX - 1) / kBrickX, tiles_y = (H + T::kBrickY - 1) / T::kBrickY;
  dim3 grid((unsigned)((long long)n_img * D * tiles_y * tiles_x), (unsigned)((Cout + BN - 1) / BN));
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6],
                                                       m[7], static_cast<float*>(y), D, H, W,
                                                       full, tail, Cout, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

// x (M, C) of 2-byte elements to y (M, Cp), Cp = C rounded up to 8, zeros
// past C: a thread writes one 16-byte vector of y from L-element loads of x
// (L = 4, 8 bytes, where 4 divides C and x is 8-byte aligned; else 1).
// Bound by bytes: it reads x once and writes y once, in order across a warp.
template <int L>
__global__ void __launch_bounds__(256)
pad_channels_kernel(const uint16_t* __restrict__ x, uint4* __restrict__ y, long long M, int C,
                    int Cp) {
  const int groups = Cp / 8;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= M * groups) return;
  const long long m = v / groups;
  const int c0 = (int)(v - m * groups) * 8;
  const uint16_t* src = x + m * C + c0;
  union {
    uint4 vec;
    uint2 part[2];
    uint16_t e[8];
  } u;
  if constexpr (L == 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      u.part[h] = c0 + 4 * h < C ? *reinterpret_cast<const uint2*>(src + 4 * h) : make_uint2(0, 0);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) u.e[c] = c0 + c < C ? src[c] : uint16_t(0);
  }
  y[v] = u.vec;
}

}  // namespace

// The channel-padded copy that the tensor-core route hands a bf16 x whose
// Cin 8 does not divide: x (M, C) 2-byte elements, y (M, Cp) with Cp = C
// rounded up to 8, 16-byte aligned. Returns 0 or a cudaError.
extern "C" int biapy_pad_channels(const void* x, void* y, long long M, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int cp = (C + 7) / 8 * 8;
  const long long vecs = M * (cp / 8);
  const unsigned blocks = (unsigned)((vecs + 255) / 256);
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0)
    pad_channels_kernel<4><<<blocks, 256, 0, s>>>(static_cast<const uint16_t*>(x),
                                                   static_cast<uint4*>(y), M, C, cp);
  else
    pad_channels_kernel<1><<<blocks, 256, 0, s>>>(static_cast<const uint16_t*>(x),
                                                   static_cast<uint4*>(y), M, C, cp);
  return (int)cudaGetLastError();
}

// The 3xTF32 route's split of x: x (M, C) float32, hi and lo (M, Cp) float32
// with Cp = C rounded up to 4, 16-byte aligned. Returns 0 or a cudaError.
extern "C" int biapy_tf32_split(const void* x, void* hi, void* lo, long long M, int C,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int cp = (C + 3) / 4 * 4;
  const unsigned blocks = (unsigned)((M * (cp / 4) + 255) / 256);
  const float* xf = static_cast<const float*>(x);
  float4 *h = static_cast<float4*>(hi), *l = static_cast<float4*>(lo);
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    tf32_split_kernel<4><<<blocks, 256, 0, s>>>(xf, h, l, M, C, cp);
  else
    tf32_split_kernel<1><<<blocks, 256, 0, s>>>(xf, h, l, M, C, cp);
  return (int)cudaGetLastError();
}

// The 3xTF32 route: xh and xl (N, D, H, W, Cin) the TF32 pair of a float32
// x (biapy_tf32_split: Cin % 4 == 0), wh and wl the packed weights split
// into TF32 pairs, each (27, Cout_p, Cin_p) float32 (Cin_p and Cout_p
// rounded up to 8, zeros past the real widths), y (N, D, H, W, Cout)
// float32 for any Cout >= 1; all five pointers 16-byte aligned. Returns 0,
// a cudaError, or the tensor-core launcher's negative codes (below).
extern "C" int biapy_conv3d_k3_tf32x3(const void* xh, const void* xl, const void* wh,
                                      const void* wl, void* y, int n_img, int D, int H, int W,
                                      int Cin, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin <= 0 || Cin % 4 != 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  // BN: the narrowest tile that holds Cout_p up to 64; past it 96 or 64,
  // whichever pads Cout_p less (the grid's second dimension walks the
  // tiles). A tile of 128 would want 192 accumulator registers a thread,
  // and ptxas gives a block of three warpgroups' worth 168: it spilled, and
  // ran slower than two tiles of 64. KC: 32 channels a step (128-byte rows)
  // up to a tile of 64, unless Cin_p leaves 16 over (48, 112: 16-channel
  // chunks then need no tail), else 16 (at 96 a 32-channel stage would not
  // fit twice); 8-channel tail steps for what KC leaves. Two consumer
  // warpgroups: four (a 16 x 16 brick) spilled the three sums at 64 and
  // lost everywhere. Measured at the main path's and the 3D templates'
  // shapes (tools/torch_conv3d_tiles.py --dtype float32), each choice the
  // faster of its alternatives at most of them.
#define BIAPY_TF(BN, KC) \
  return launch_tf32x3<BN, KC, 1, 2>(xh, xl, wh, wl, y, n_img, D, H, W, Cin, Cout, s)
  const int cout_p = (Cout + 7) / 8 * 8, cin_p = (Cin + 7) / 8 * 8;
  const bool kc32 = cin_p % 32 != 16;
  if (cout_p > 64 && (cout_p + 95) / 96 * 96 <= (cout_p + 63) / 64 * 64) BIAPY_TF(96, 16);
  if (kc32) {
    if (cout_p <= 8) BIAPY_TF(8, 32);
    if (cout_p <= 16) BIAPY_TF(16, 32);
    if (cout_p <= 32) BIAPY_TF(32, 32);
    if (cout_p <= 40) BIAPY_TF(40, 32);
    if (cout_p <= 48) BIAPY_TF(48, 32);
    BIAPY_TF(64, 32);
  }
  if (cout_p <= 8) BIAPY_TF(8, 16);
  if (cout_p <= 16) BIAPY_TF(16, 16);
  if (cout_p <= 32) BIAPY_TF(32, 16);
  if (cout_p <= 40) BIAPY_TF(40, 16);
  if (cout_p <= 48) BIAPY_TF(48, 16);
  BIAPY_TF(64, 16);
#undef BIAPY_TF
}

// The tensor-core route: x (N, D, H, W, Cin) bf16 with Cin % 8 == 0 (the
// wrapper pads the channels of any other Cin), wp the packed weights
// (27, Cout_p, Cin) bf16 (tap-major, then output channel, input channel
// contiguous; Cout_p = Cout rounded up to 8, zeros past Cout), y
// (N, D, H, W, Cout) bf16 for any Cout >= 1; all three pointers 16-byte
// aligned. Returns 0, a cudaError, or a negative code (-1: no
// cuTensorMapEncodeTiled in libcuda, -1000 - r: libcuda refused a tensor map
// with CUresult r).
extern "C" int biapy_conv3d_k3_wgmma(const void* x, const void* wp, void* y, int n_img, int D,
                                     int H, int W, int Cin, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin <= 0 || Cin % 8 != 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  // BN: the narrowest tile that holds Cout_p (rows of B past Cout_p arrive as
  // zeros, channels past Cout are not written); above 256 the grid's second
  // dimension walks tiles. KC: 64 channels a step (128-byte rows) where 64
  // divides Cin and the tile is narrow enough to leave the ring its depth,
  // else 32 (64-byte rows) with a 16-channel tail step where 32 leaves 16.
  // MINB: two blocks an SM where registers and shared memory allow it.
  // NWG: four consumer warpgroups (a 16 x 16 brick: the weights of a step
  // feed twice the voxels and the dy halo is 2 rows in 18, not in 10) where
  // the accumulators leave room (BN <= 128), the taller brick overhangs the
  // volume no further and either the tile is at most 64 wide or there are
  // bricks for two waves of an H100's 132 SMs; else two (8 x 16). Measured
  // on the main path's and the 3D templates' shapes, each choice is the
  // faster of its alternatives where they differ (the templates' 16^2 level
  // has 80 tall bricks, and four warpgroups still win there;
  // tools/torch_conv3d_tiles.py times every variant).
#define BIAPY_TC(BN, KC, MINB, NWG) \
  return launch_tc<BN, KC, MINB, NWG>(x, wp, y, n_img, D, H, W, Cin, Cout, s)
  const int cout_p = (Cout + 7) / 8 * 8;
  if (cout_p <= 8) BIAPY_TC(8, 32, 2, 2);
  if (cout_p <= 16) BIAPY_TC(16, 32, 2, 2);
  const long long tall_bricks = (long long)n_img * D * ((H + 15) / 16) * ((W + 15) / 16);
  if (cout_p <= 128 && 2 * ((H + 15) / 16) == (H + 7) / 8 &&
      (cout_p <= 64 || tall_bricks >= 2 * 132)) {
    if (cout_p <= 64 && Cin % 64 == 0) {
      if (cout_p <= 32) BIAPY_TC(32, 64, 2, 4);
      if (cout_p <= 48) BIAPY_TC(48, 64, 1, 4);
      BIAPY_TC(64, 64, 1, 4);
    }
    if (cout_p <= 32) BIAPY_TC(32, 32, 2, 4);
    if (cout_p <= 40) BIAPY_TC(40, 32, 2, 4);
    if (cout_p <= 48) BIAPY_TC(48, 32, 1, 4);
    if (cout_p <= 64) BIAPY_TC(64, 32, 1, 4);
    if (cout_p <= 96) BIAPY_TC(96, 32, 1, 4);
    BIAPY_TC(128, 32, 1, 4);
  }
  if (cout_p <= 64 && Cin % 64 == 0) {
    if (cout_p <= 32) BIAPY_TC(32, 64, 2, 2);
    BIAPY_TC(64, 64, 2, 2);
  }
  if (cout_p <= 32) BIAPY_TC(32, 32, 2, 2);
  if (cout_p <= 40) BIAPY_TC(40, 32, 2, 2);
  if (cout_p <= 48) BIAPY_TC(48, 32, 2, 2);
  if (cout_p <= 64) BIAPY_TC(64, 32, 2, 2);
  if (cout_p <= 96) BIAPY_TC(96, 32, 2, 2);
  if (cout_p <= 128) BIAPY_TC(128, 32, 2, 2);
  if (cout_p <= 192) BIAPY_TC(192, 32, 1, 2);
  BIAPY_TC(256, 32, 1, 2);
#undef BIAPY_TC
}

// The stem route: x (N, D, H, W, Cin) with 1 <= Cin <= 8, w the DHWIO
// weights (3, 3, 3, Cin, Cout) as they are, y (N, D, H, W, Cout), any
// Cout >= 1, all of one dtype (0 = float32, 1 = bfloat16). Returns 0 or a
// cudaError.
extern "C" int biapy_conv3d_k3_stem(const void* x, const void* w, void* y, int dtype, int n_img,
                                    int D, int H, int W, int Cin, int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin < 1 || Cin > kStemMaxCin || Cout < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_stem<float>(x, w, y, n_img, D, H, W, Cin, Cout, s);
  if (dtype == 1) return launch_stem<__nv_bfloat16>(x, w, y, n_img, D, H, W, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}
