// Folded-layout shuffle kernels for Hopper (sm_90a): the encoder's
// non-overlapping max-pool, the decoder's z depth-to-space and the z-window
// channel concatenation of the cat2d convs, each with its backward.
//
// Replaces (biapy_tpu/ops/pallas/shuffle.py):
//   pool:     _pool_fwd_kernel (op pool_max_folded, models/blocks.py::max_pool)
//   pool bwd: _pool_bwd_kernel (its custom VJP)
//   zd2s:     _zd2s_kernel     (op zd2s, models/blocks.py::ConvTranspose)
//   zs2d:     _zs2d_kernel     (zd2s's VJP)
//   zcat:     _zcat_kernel     (op zcat, ops/conv3d.py cat2d operand)
//   zcat bwd: _zcat_bwd_kernel (its custom VJP)
//
// All run on the z-folded (rows, h, w, c) layout, rows = batch * depth,
// which for a contiguous channels-last NDHWC tensor is a free view.
//
// What bounds them on this card: bytes. None does arithmetic worth the
// name: the pool reads its input once and writes an eighth of it (2x2x2),
// its backward reads x, y, g once and writes dx once, zd2s / zs2d read and
// write every byte once, zcat writes kz times what it reads and its backward
// reads kz times what it writes. The TPU kernels staged row blocks in VMEM
// behind clamped index maps; here each thread owns one 16-byte vector of
// channels (narrower units when c does not allow 16 bytes) and reads
// straight from device memory, neighbouring threads on neighbouring
// channels, so every warp access is coalesced and nothing is staged. The z
// taps that zcat and its backward read again come from the L2.
//
// pool: y[r, i, j, ch] = max over the (wz, wy, wx) window of
//       x[r*wz + a, i*wy + b, j*wx + c, ch]; a NaN anywhere in the window
//       gives NaN, as jnp.max does (fmaxf would drop it).
// pool bwd: dx[slot] = (x[slot] == y[window]) ? g[window] : 0 for every slot
//       of the window: every tied slot gets the full cotangent, NaN compares
//       false, -0 == +0. Every slot is written, so dx needs no memset.
// zd2s: y[r*sz + a, i, j, ch] = x[r, i, j, a*c + ch]; zs2d is its inverse,
//       dx[r, i, j, a*c + ch] = g[r*sz + a, i, j, ch].
// zcat: out[r, i, j, t*c + ch] = x[r + t - kz/2, i, j, ch], zero where the
//       source plane falls outside the image that row r belongs to (images
//       are `depth` rows each; depth == rows is the single-image case).
// zcat bwd: dx[r, i, j, ch] = sum over t of g[r - t + kz/2, i, j, t*c + ch]
//       where that row lies in r's image, summed in float32 in tap order and
//       rounded once.
// zd2s, zs2d and zcat are pure copies: they move raw bytes in the widest
// unit (16, 8, 4, 2 or 1 bytes) that divides c * itemsize and both
// pointers' alignment, so they take any dtype.

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

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// one thread per V channels of one POOLED position: reads y and g once, the
// window's slots of x once, writes every slot of dx
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
pool_bwd_kernel(const Vec<T, V>* __restrict__ x, const Vec<T, V>* __restrict__ y,
                const Vec<T, V>* __restrict__ g, Vec<T, V>* __restrict__ dx, long long total,
                int h, int w, int cv, int wz, int wy, int wx) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const int ho = h / wy, wo = w / wx;
  long long r = o;
  const int ch = (int)(r % cv); r /= cv;
  const int ox = (int)(r % wo); r /= wo;
  const int oy = (int)(r % ho);
  const long long orow = r / ho;
  const Vec<T, V> yv = y[o];
  const Vec<T, V> gv = g[o];
  float yf[V];
#pragma unroll
  for (int i = 0; i < V; ++i) yf[i] = to_f32(yv.v[i]);
  for (int a = 0; a < wz; ++a)
    for (int b = 0; b < wy; ++b)
      for (int d = 0; d < wx; ++d) {
        const long long off =
            (((orow * wz + a) * h + (long long)oy * wy + b) * w + (long long)ox * wx + d) * cv + ch;
        const Vec<T, V> xv = x[off];
        Vec<T, V> out;
#pragma unroll
        for (int i = 0; i < V; ++i)
          out.v[i] = (to_f32(xv.v[i]) == yf[i]) ? gv.v[i] : from_f32<T>(0.0f);
        dx[off] = out;
      }
}

template <typename T>
void launch_pool_bwd(const void* x, const void* y, const void* g, void* dx, int rows, int h,
                     int w, int c, int wz, int wy, int wx, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx);
  const long long outer = (long long)(rows / wz) * (h / wy) * (w / wx);
  if (c % V == 0 && align % 16 == 0) {
    const long long total = outer * (c / V);
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    pool_bwd_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
        static_cast<const Vec<T, V>*>(x), static_cast<const Vec<T, V>*>(y),
        static_cast<const Vec<T, V>*>(g), static_cast<Vec<T, V>*>(dx), total, h, w, c / V, wz,
        wy, wx);
  } else {
    const long long total = outer * c;
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    pool_bwd_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<const Vec<T, 1>*>(x), static_cast<const Vec<T, 1>*>(y),
        static_cast<const Vec<T, 1>*>(g), static_cast<Vec<T, 1>*>(dx), total, h, w, c, wz, wy,
        wx);
  }
}

// one copy unit of dx per thread; o runs over dx = (row, p, a, j)
template <typename U>
__global__ void __launch_bounds__(kThreads)
zs2d_kernel(const U* __restrict__ g, U* __restrict__ dx, long long total, long long hw, int cu,
            int sz) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  long long r = o;
  const int j = (int)(r % cu); r /= cu;
  const int a = (int)(r % sz); r /= sz;
  const long long p = r % hw;
  const long long row = r / hw;
  dx[o] = g[((row * sz + a) * hw + p) * cu + j];
}

template <typename U>
void launch_zs2d(const void* g, void* dx, long long total, long long hw, int cu, int sz,
                 cudaStream_t stream) {
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  zs2d_kernel<U><<<blocks, kThreads, 0, stream>>>(static_cast<const U*>(g), static_cast<U*>(dx),
                                                  total, hw, cu, sz);
}

template <typename U> __device__ __forceinline__ U zero_unit() { return U(0); }
template <> __device__ __forceinline__ uint4 zero_unit<uint4>() { return make_uint4(0, 0, 0, 0); }
template <> __device__ __forceinline__ uint2 zero_unit<uint2>() { return make_uint2(0, 0); }

// one copy unit of out per thread; o runs over out = (row, p, t, j)
template <typename U>
__global__ void __launch_bounds__(kThreads)
zcat_kernel(const U* __restrict__ x, U* __restrict__ out, long long total, long long hw, int cu,
            int kz, int depth) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  long long r = o;
  const int j = (int)(r % cu); r /= cu;
  const int t = (int)(r % kz); r /= kz;
  const long long p = r % hw;
  const long long row = r / hw;
  const long long z = row % depth + t - kz / 2;  // source plane within the image
  U v = zero_unit<U>();
  if (z >= 0 && z < depth) v = x[((row + t - kz / 2) * hw + p) * cu + j];
  out[o] = v;
}

template <typename U>
void launch_zcat(const void* x, void* out, long long total, long long hw, int cu, int kz,
                 int depth, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  zcat_kernel<U><<<blocks, kThreads, 0, stream>>>(static_cast<const U*>(x), static_cast<U*>(out),
                                                  total, hw, cu, kz, depth);
}

// one thread per V channels of one dx position; g rows are kz * cv vectors wide
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
zcat_bwd_kernel(const Vec<T, V>* __restrict__ g, Vec<T, V>* __restrict__ dx, long long total,
                long long hw, int cv, int kz, int depth) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  long long r = o;
  const int ch = (int)(r % cv); r /= cv;
  const long long p = r % hw;
  const long long row = r / hw;
  const int hz = kz / 2;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  for (int t = 0; t < kz; ++t) {
    const long long z = row % depth - t + hz;  // plane whose tap t read this row
    if (z < 0 || z >= depth) continue;
    const Vec<T, V> v = g[(((row - t + hz) * hw + p) * kz + t) * cv + ch];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += to_f32(v.v[i]);
  }
  Vec<T, V> out;
#pragma unroll
  for (int i = 0; i < V; ++i) out.v[i] = from_f32<T>(acc[i]);
  dx[o] = out;
}

template <typename T>
void launch_zcat_bwd(const void* g, void* dx, int rows, int h, int w, int c, int kz, int depth,
                     cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t align = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx);
  const long long hw = (long long)h * w;
  if (c % V == 0 && align % 16 == 0) {
    const long long total = (long long)rows * hw * (c / V);
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    zcat_bwd_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
        static_cast<const Vec<T, V>*>(g), static_cast<Vec<T, V>*>(dx), total, hw, c / V, kz,
        depth);
  } else {
    const long long total = (long long)rows * hw * c;
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    zcat_bwd_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<const Vec<T, 1>*>(g), static_cast<Vec<T, 1>*>(dx), total, hw, c, kz, depth);
  }
}

// widest copy unit (bytes) that divides cb and the pointers' alignment
inline int copy_unit(long long cb, uintptr_t align) {
  int unit = 16;
  while (unit > 1 && (cb % unit != 0 || align % unit != 0)) unit /= 2;
  return unit;
}


// calls f with a value of the unsigned type that is `unit` bytes wide
template <typename F>
void dispatch_unit(int unit, F&& f) {
  switch (unit) {
    case 16: f(uint4{}); break;
    case 8: f(uint2{}); break;
    case 4: f(uint32_t{}); break;
    case 2: f(uint16_t{}); break;
    default: f(uint8_t{}); break;
  }
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
  const int unit = copy_unit(cb, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y));
  const int cu = (int)(cb / unit);
  const long long hw = (long long)h * w;
  const long long total = (long long)rows * sz * hw * cu;
  if (total == 0) return (int)cudaGetLastError();
  dispatch_unit(unit, [&](auto u) { launch_zd2s<decltype(u)>(x, y, total, hw, cu, sz, s); });
  return (int)cudaGetLastError();
}

// x is (rows, h, w, c); y and g are (rows/wz, h/wy, w/wx, c); dx is x's
// shape; all of one dtype (0 = float32, 1 = bfloat16). Returns
// cudaGetLastError() after the launch.
extern "C" int biapy_pool_max_folded_bwd(const void* x, const void* y, const void* g, void* dx,
                                         int dtype, int rows, int h, int w, int c, int wz,
                                         int wy, int wx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)(rows / wz) * (h / wy) * (w / wx) * c;
  if (total == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    launch_pool_bwd<float>(x, y, g, dx, rows, h, w, c, wz, wy, wx, s);
  else if (dtype == 1)
    launch_pool_bwd<__nv_bfloat16>(x, y, g, dx, rows, h, w, c, wz, wy, wx, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// g is (rows*sz, h, w, c) of any dtype of `itemsize` bytes; dx is
// (rows, h, w, sz*c). Returns cudaGetLastError() after the launch.
extern "C" int biapy_zs2d(const void* g, void* dx, int itemsize, int rows, int h, int w, int c,
                          int sz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cb = (long long)c * itemsize;
  const int unit = copy_unit(cb, reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx));
  const int cu = (int)(cb / unit);
  const long long hw = (long long)h * w;
  const long long total = (long long)rows * sz * hw * cu;
  if (total == 0) return (int)cudaGetLastError();
  dispatch_unit(unit, [&](auto u) { launch_zs2d<decltype(u)>(g, dx, total, hw, cu, sz, s); });
  return (int)cudaGetLastError();
}

// x is (rows, h, w, c) of any dtype of `itemsize` bytes, rows a multiple of
// depth; out is (rows, h, w, kz*c), kz odd. Returns cudaGetLastError().
extern "C" int biapy_zcat(const void* x, void* out, int itemsize, int rows, int h, int w, int c,
                          int kz, int depth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cb = (long long)c * itemsize;
  const int unit = copy_unit(cb, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out));
  const int cu = (int)(cb / unit);
  const long long hw = (long long)h * w;
  const long long total = (long long)rows * hw * kz * cu;
  if (total == 0) return (int)cudaGetLastError();
  dispatch_unit(unit, [&](auto u) { launch_zcat<decltype(u)>(x, out, total, hw, cu, kz, depth, s); });
  return (int)cudaGetLastError();
}

// g is (rows, h, w, kz*c), dx is (rows, h, w, c), one dtype (0 = float32,
// 1 = bfloat16). Returns cudaGetLastError() after the launch.
extern "C" int biapy_zcat_bwd(const void* g, void* dx, int dtype, int rows, int h, int w, int c,
                              int kz, int depth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((long long)rows * h * w * c == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    launch_zcat_bwd<float>(g, dx, rows, h, w, c, kz, depth, s);
  else if (dtype == 1)
    launch_zcat_bwd<__nv_bfloat16>(g, dx, rows, h, w, c, kz, depth, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
