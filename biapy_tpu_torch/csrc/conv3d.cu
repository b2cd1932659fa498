// 3x3x3, stride-1, SAME convolution on channels-last volumes, for Hopper
// (sm_90a), as an implicit GEMM on the CUDA cores.
//
// Replaces: biapy_tpu/ops/pallas/conv3d.py::_kernel (launched by
// _conv3d_pallas, reached from biapy_tpu/ops/conv3d.py::conv3d_dispatch).
//
// Function:
//   y[n, z, y, x, co] = sum_{dz, dy, dx, ci} x[n, z+dz-1, y+dy-1, x+dx-1, ci]
//                                            * w[dz, dy, dx, ci, co]
// x is NDHWC, w is DHWIO (3, 3, 3, Cin, Cout), both contiguous and of one
// dtype (float32 or bfloat16); taps outside the volume read zero; the sum is
// kept in float32 and y is written in the input dtype. No bias.
//
// What bounds it on this card: operations. A voxel costs 54*Cin*Cout flops
// against (Cin + Cout) * itemsize bytes, which at the main path's widths
// (Cin 32..192, Cout 32..128) is far above the H100's ~295 flop/byte ridge;
// only the 1-channel stem (Cin = 1) is bound by bytes.
//
// Design: M = N*D*H*W output voxels, N = Cout, K = 27*Cin with
// k = tap*Cin + ci, so the DHWIO weight tensor already is the (K, Cout)
// row-major B matrix. Each block owns a BM x BN output tile and walks K in
// chunks of BK: it stages the BK reduction entries of its BM voxels (the
// 3x3x3 neighbourhood, one flattened (tap, ci) entry at a time, zero where a
// tap falls outside the volume: the padding is a mask, never a padded copy)
// and the matching BK x BN weight slice in shared memory as float32, then
// every thread accumulates a TM x TN register tile with FMAs. Flattening K
// makes every Cin work alike, including the stem's Cin = 1 (K = 27) and the
// decoder's Cin = 96 / 192 concats; ragged M, N and K edges are masked, so
// any D/H/W and Cout are taken. The lane-quad packing, row padding and VMEM
// gates of the TPU kernel have no counterpart here.
//
// This first version stays on the CUDA cores (float32 FMA, 67 TFLOP/s peak)
// for both dtypes: right before fast. The tensor-core form (wgmma fed by
// TMA, bf16 operands) is the work of a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
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
