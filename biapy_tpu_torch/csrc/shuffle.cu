// Folded-layout shuffle kernels for Hopper (sm_90a): the encoder's
// non-overlapping max-pool and the decoder's z depth-to-space, forward only.
//
// Replaces:
//   pool: biapy_tpu/ops/pallas/shuffle.py::_pool_fwd_kernel
//         (op pool_max_folded, reached from models/blocks.py::max_pool)
//   zd2s: biapy_tpu/ops/pallas/shuffle.py::_zd2s_kernel
//         (op zd2s, reached from models/blocks.py::ConvTranspose)
//
// Both run on the z-folded (rows, h, w, c) layout, rows = batch * depth,
// which for a contiguous channels-last NDHWC tensor is a free view.
//
// What bounds them on this card: bytes. Neither does arithmetic worth the
// name: the pool reads its input once and writes an eighth of it (2x2x2),
// zd2s reads and writes every byte once. The TPU kernels staged row blocks
// in VMEM; here each thread owns one 16-byte vector of channels (pool: of
// one output position, zd2s: of one copy unit; narrower units when c does
// not allow 16 bytes) and reads straight from device memory, neighbouring
// threads on neighbouring channels, so every warp access is coalesced and
// nothing is staged or re-read.
//
// pool: y[r, i, j, ch] = max over the (wz, wy, wx) window of
//       x[r*wz + a, i*wy + b, j*wx + c, ch]; a NaN anywhere in the window
//       gives NaN, as jnp.max does (fmaxf would drop it).
// zd2s: y[r*sz + a, i, j, ch] = x[r, i, j, a*c + ch]. It is a pure copy, so
//       it moves raw bytes in the widest unit (16, 8, 4, 2 or 1 bytes) that
//       divides c * itemsize and both pointers' alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// V channels of one output position per thread: 16-byte loads and stores
// when c allows, one element otherwise
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
pool_max_kernel(const Vec<T, V>* __restrict__ x, Vec<T, V>* __restrict__ y, long long total,
                int h, int w, int cv, int wz, int wy, int wx) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const int ho = h / wy, wo = w / wx;
  long long r = o;
  const int ch = (int)(r % cv); r /= cv;
  const int ox = (int)(r % wo); r /= wo;
  const int oy = (int)(r % ho);
  const long long orow = r / ho;
  Vec<T, V> best = x[(((orow * wz) * h + (long long)oy * wy) * w + (long long)ox * wx) * cv + ch];
  float bf[V];
#pragma unroll
  for (int i = 0; i < V; ++i) bf[i] = to_f32(best.v[i]);
  for (int a = 0; a < wz; ++a)
    for (int b = 0; b < wy; ++b)
      for (int d = 0; d < wx; ++d) {
        const long long off =
            (((orow * wz + a) * h + (long long)oy * wy + b) * w + (long long)ox * wx + d) * cv + ch;
        const Vec<T, V> v = x[off];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float vf = to_f32(v.v[i]);
          // take v when it is larger or NaN; once best is NaN no compare wins
          if (vf > bf[i] || vf != vf) {
            best.v[i] = v.v[i];
            bf[i] = vf;
          }
        }
      }
  y[o] = best;
}

template <typename T>
void launch_pool(const void* x, void* y, int rows, int h, int w, int c, int wz, int wy, int wx,
                 cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  const long long outer = (long long)(rows / wz) * (h / wy) * (w / wx);
  if (c % V == 0 && align % 16 == 0) {
    const long long total = outer * (c / V);
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    pool_max_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
        static_cast<const Vec<T, V>*>(x), static_cast<Vec<T, V>*>(y), total, h, w, c / V, wz,
        wy, wx);
  } else {
    const long long total = outer * c;
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    pool_max_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<const Vec<T, 1>*>(x), static_cast<Vec<T, 1>*>(y), total, h, w, c, wz, wy,
        wx);
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
zd2s_kernel(const U* __restrict__ x, U* __restrict__ y, long long total, long long hw, int cu,
            int sz) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  long long r = o;
  const int j = (int)(r % cu); r /= cu;
  const long long p = r % hw; r /= hw;
  const int a = (int)(r % sz);
  const long long row = r / sz;
  y[o] = x[((row * hw + p) * sz + a) * cu + j];
}

template <typename U>
void launch_zd2s(const void* x, void* y, long long total, long long hw, int cu, int sz,
                 cudaStream_t stream) {
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  zd2s_kernel<U><<<blocks, kThreads, 0, stream>>>(static_cast<const U*>(x), static_cast<U*>(y),
                                                  total, hw, cu, sz);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x is (rows, h, w, c) with rows % wz,
// h % wy and w % wx all zero (checked by the caller). Returns
// cudaGetLastError() after the launch.
extern "C" int biapy_pool_max_folded(const void* x, void* y, int dtype, int rows, int h, int w,
                                     int c, int wz, int wy, int wx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)(rows / wz) * (h / wy) * (w / wx) * c;
  if (total == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    launch_pool<float>(x, y, rows, h, w, c, wz, wy, wx, s);
  else if (dtype == 1)
    launch_pool<__nv_bfloat16>(x, y, rows, h, w, c, wz, wy, wx, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x is (rows, h, w, sz*c) of any dtype of `itemsize` bytes; y is
// (rows*sz, h, w, c). Returns cudaGetLastError() after the launch.
extern "C" int biapy_zd2s(const void* x, void* y, int itemsize, int rows, int h, int w, int c,
                          int sz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cb = (long long)c * itemsize;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  int unit = 16;
  while (unit > 1 && (cb % unit != 0 || align % unit != 0)) unit /= 2;
  const int cu = (int)(cb / unit);
  const long long hw = (long long)h * w;
  const long long total = (long long)rows * sz * hw * cu;
  if (total == 0) return (int)cudaGetLastError();
  switch (unit) {
    case 16: launch_zd2s<uint4>(x, y, total, hw, cu, sz, s); break;
    case 8: launch_zd2s<uint2>(x, y, total, hw, cu, sz, s); break;
    case 4: launch_zd2s<uint32_t>(x, y, total, hw, cu, sz, s); break;
    case 2: launch_zd2s<uint16_t>(x, y, total, hw, cu, sz, s); break;
    default: launch_zd2s<uint8_t>(x, y, total, hw, cu, sz, s); break;
  }
  return (int)cudaGetLastError();
}
