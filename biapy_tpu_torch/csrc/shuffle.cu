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
// behind clamped index maps.
//
// The pool, its backward and zcat make every global access a full,
// coalesced 16-byte vector at any channel count (2-byte accesses at the
// stem's c = 1 or at 56- and 72-byte positions would cut the bandwidth),
// and read each input byte from device memory about once. Each has three
// routes, picked by the caller from shape, itemsize and pointer alignment
// (ops/kernels/shuffle.py::pool_route, ::zcat_route) and refused here when
// the launch does not fit them:
// - channels16 (c * itemsize a multiple of 16): a thread per 16-byte vector
//   of channels, no staging and no barrier, so nothing serialises loads
//   against stores. pool: every slot of its window loaded into registers
//   before any is reduced (max.NaN); each input vector lies in exactly one
//   window. pool bwd: the same thread mapping; the pooled position's y and g
//   vectors and every x slot loaded before any is compared, then every dx
//   slot stored. zcat: while the input fits the L2 (kZcatScatterBytes) each
//   source vector is read once and stored to the kz output rows whose taps
//   read it (the image's edge planes also write the zero taps next to
//   them); a larger input is gathered in output order, so that the stores
//   run sequentially and the L2 serves a plane's kz reads.
// - rows16 (a position's channels off the 16-byte grid, every run on it):
//   16-byte vectors along contiguous runs. pool: a pooled row (orow, oy)
//   reads wz * wy input rows, each one run of w * c elements; a block reads
//   those runs with 16-byte vectors, reduces them elementwise in registers,
//   stages the result, reduces over x in shared memory by element index
//   (e against e + c, ..., e + (wx-1) * c) and writes the pooled run,
//   (w / wx) * c contiguous elements, with 16-byte stores. pool bwd: nothing
//   is staged; a thread takes one 16-byte vector offset of a pooled row's
//   wz * wy input runs (w * c contiguous elements each), reads the y and g
//   of its pooled elements (e / (wx * c)) * c + e % c once, in the widest
//   unit that divides c * itemsize (the wx threads of a window read the
//   same units from the L1), and streams its x vectors to dx through
//   registers, with no barrier: x and dx each cross device memory once
//   (staging y and g in shared memory behind a barrier measured slower on
//   the card). zcat: over a span
//   of P positions, output row r is one run of P * kz * c elements built
//   from kz source runs of P * c elements, in planes r - kz/2 ... r + kz/2;
//   a block takes R consecutive rows, stages their R + kz - 1 source runs
//   once (planes outside the image are not loaded and read as zero) and
//   writes the R output runs with 16-byte stores, each assembled from the
//   stage in the widest unit that divides c * itemsize; a source byte
//   leaves device memory about (R + kz - 1) / R times. The staging is
//   cp.async, not TMA: a tap's destination stride, kz * c * itemsize, is no
//   multiple of 16 bytes at the template's widths (168 bytes at c = 28,
//   kz = 3). At c = 1 (the stem) nothing is staged: a thread keeps its kz
//   planes' 16-byte vectors in registers, interleaves them into kz output
//   vectors and stores them through a per-warp transpose in shared memory,
//   so that every store instruction writes 512 contiguous bytes.
// - scalar (a run or a pointer off the 16-byte grid: odd shapes, a view at
//   an element offset): the rows16 kernels with one element per access.
// The other three (zd2s, zs2d, zcat bwd) give each thread one 16-byte
// vector of channels (narrower units when c does not allow 16 bytes) and
// read straight from device memory, neighbouring threads on neighbouring
// channels; the z taps that zcat's backward reads again come from the L2.
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
// zd2s, zs2d and zcat are pure copies: they move raw bytes, so they take
// any dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// V elements per access: a 16-byte vector (V = 16 / sizeof(T)) or one element
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// the routes of the pool, its backward and zcat (ops/kernels/shuffle.py::
// pool_route, ::zcat_route; ROUTE_CODES there)
constexpr int kRouteChannels16 = 0;
constexpr int kRouteRows16 = 1;
constexpr int kRouteScalar = 2;
// shared memory a pool block stages at most, pooled positions a thread
// reduces per pass; a zcat source run (at least kZcatMinRunBytes) and rows
// of the staged kernel, the input size up to which channels16 scatters, the
// stem's rows a thread; the blocks each SM should get at least
constexpr long long kPoolStageBytes = 24 * 1024;
constexpr int kPoolPass = 2;
constexpr long long kZcatRunBytes = 4 * 1024;
constexpr long long kZcatMinRunBytes = 512;
constexpr int kZcatRows = 8;
constexpr long long kZcatScatterBytes = 16LL << 20;
constexpr int kZcatStemRows = 4;
constexpr int kBlocksPerSm = 2;
constexpr long long kMaxSmem = 227 * 1024;
// x loads a thread of the pool backward's rows16 and scalar kernel keeps in
// flight
constexpr int kPoolBwdBatch = 4;

inline int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

inline long long gcd_ll(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
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

// the larger of a and b, NaN when either is NaN (PTX max.NaN), as jnp.max;
// -0 and +0 may come out either way
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ __nv_bfloat16 max_nan(__nv_bfloat16 a, __nv_bfloat16 b) {
  unsigned short r, ua = *reinterpret_cast<unsigned short*>(&a),
                    ub = *reinterpret_cast<unsigned short*>(&b);
  asm("max.NaN.bf16 %0, %1, %2;" : "=h"(r) : "h"(ua), "h"(ub));
  return *reinterpret_cast<__nv_bfloat16*>(&r);
}
// elementwise on a 16-byte vector: four f32 or four bf16x2 maxima
__device__ __forceinline__ void max_nan_word(uint32_t& a, uint32_t b, float) {
  a = __float_as_uint(max_nan(__uint_as_float(a), __uint_as_float(b)));
}
__device__ __forceinline__ void max_nan_word(uint32_t& a, uint32_t b, __nv_bfloat16) {
  asm("max.NaN.bf16x2 %0, %0, %1;" : "+r"(a) : "r"(b));
}
template <typename T, int V>
__device__ __forceinline__ void max_nan(Vec<T, V>& a, const Vec<T, V>& b) {
  if constexpr (sizeof(T) * V == 16) {
    uint32_t* aw = reinterpret_cast<uint32_t*>(&a);
    const uint32_t* bw = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) max_nan_word(aw[i], bw[i], T());
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) a.v[i] = max_nan(a.v[i], b.v[i]);
  }
}

// One block: `tr` consecutive pooled rows t = (orow, oy) over the input
// columns [x0, x0 + wc) (one chunk unless a row outgrows the stage).
// Phase 1: the wz * wy input runs of each pooled row, nw * c contiguous
// elements each, read with V-element vectors at the same offsets
// (kPoolPass offsets a pass, so that every thread keeps kPoolPass * wz * wy
// loads in flight)
// and reduced elementwise in registers into the stage. Phase 2: the x
// reduction by element index in the stage (a vector may straddle
// channels) and the pooled run, (nw / wx) * c contiguous elements, written
// with V-element stores.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
pool_max_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w, int c, int wz, int wy,
                int wx, long long n_rows, int tr, int wc, int n_chunks) {
  extern __shared__ __align__(16) unsigned char pool_smem[];
  T* stage = reinterpret_cast<T*>(pool_smem);
  const int chunk = (int)(blockIdx.x % n_chunks);
  const long long t0 = (long long)(blockIdx.x / n_chunks) * tr;
  const int nt = (int)min((long long)tr, n_rows - t0);
  const int x0 = chunk * wc;
  const int nw = min(wc, w - x0);
  const int ho = h / wy, wo = w / wx;
  const long long in_row = (long long)w * c;  // elements between input rows
  const long long in_plane = in_row * h;
  const int lmax = wc * c;                    // stage elements per pooled row
  const int lr = nw * c;                      // elements per input run
  constexpr int kStep = kThreads * V;

  for (int f0 = threadIdx.x * V; f0 < nt * lr; f0 += kPoolPass * kStep) {
    const T* src[kPoolPass];
    int dst[kPoolPass];
    Vec<T, V> best[kPoolPass];
#pragma unroll
    for (int u = 0; u < kPoolPass; ++u) {
      // an offset of the pass past the end repeats the first
      const int f = f0 + u * kStep < nt * lr ? f0 + u * kStep : f0;
      const int k = f / lr, e = f - k * lr;
      const long long t = t0 + k;
      const long long orow = t / ho;
      src[u] = x + orow * wz * in_plane + (t - orow * ho) * wy * in_row + (long long)x0 * c + e;
      dst[u] = k * lmax + e;
      best[u] = *reinterpret_cast<const Vec<T, V>*>(src[u]);
    }
    for (int a = 0; a < wz; ++a)
      for (int b = 0; b < wy; ++b) {
        if (a == 0 && b == 0) continue;
        const long long off = a * in_plane + b * in_row;
        Vec<T, V> v[kPoolPass];
#pragma unroll
        for (int u = 0; u < kPoolPass; ++u)
          v[u] = *reinterpret_cast<const Vec<T, V>*>(src[u] + off);
#pragma unroll
        for (int u = 0; u < kPoolPass; ++u) max_nan(best[u], v[u]);
      }
#pragma unroll
    for (int u = 0; u < kPoolPass; ++u) *reinterpret_cast<Vec<T, V>*>(stage + dst[u]) = best[u];
  }
  __syncthreads();

  const long long out_row = (long long)wo * c;
  const int lo = (nw / wx) * c;  // elements per pooled run
  T* dst0 = y + t0 * out_row + (long long)(x0 / wx) * c;
  for (int f = threadIdx.x * V; f < nt * lo; f += kStep) {
    const int k = f / lo, q0 = f - k * lo;
    const T* srow = stage + k * lmax;
    int j = q0 / c, ch = q0 - j * c;
    Vec<T, V> out;
    if (c % V == 0) {
      // the vector lies within one position's channels: vector reads
      const T* s0 = srow + j * wx * c + ch;
      out = *reinterpret_cast<const Vec<T, V>*>(s0);
      for (int d = 1; d < wx; ++d) max_nan(out, *reinterpret_cast<const Vec<T, V>*>(s0 + d * c));
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const T* s0 = srow + j * wx * c + ch;
        T best = s0[0];
        for (int d = 1; d < wx; ++d) best = max_nan(best, s0[d * c]);
        out.v[i] = best;
        if (++ch == c) {
          ch = 0;
          ++j;
        }
      }
    }
    *reinterpret_cast<Vec<T, V>*>(dst0 + k * out_row + q0) = out;
  }
}

// The offsets, in vectors of cv per position, of the NSLOT slots of a
// (wz, wy, wx) window from its first slot, in (a, b, d) order.
template <int NSLOT>
__device__ __forceinline__ void window_offsets(long long (&off)[NSLOT], int h, int w, int cv,
                                               int wy, int wx) {
  int a = 0, b = 0, d = 0;
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) {
    off[s] = (((long long)a * h + b) * w + d) * cv;
    if (++d == wx) {
      d = 0;
      if (++b == wy) {
        b = 0;
        ++a;
      }
    }
  }
}

// The channels16 grid of the pool and its backward: `upr` = (w / wx) * cv
// vectors a pooled row; a block takes `rpb` rows when a row is narrower
// than the block, else `bpr` blocks take one row; rows gridDim.y apart.
struct ChannelsGrid {
  dim3 grid;
  int upr, rpb, bpr;
};

inline bool channels_grid(long long n_rows, int wo, int cv, ChannelsGrid& cg) {
  const long long upr = (long long)wo * cv;
  if (upr > INT32_MAX) return false;
  cg.upr = (int)upr;
  cg.rpb = upr >= kThreads ? 1 : (int)(kThreads / upr);
  cg.bpr = (int)((upr + kThreads - 1) / kThreads);
  cg.grid = dim3((unsigned)cg.bpr,
                 (unsigned)std::min<long long>((n_rows + cg.rpb - 1) / cg.rpb, 65535));
  return true;
}

// One thread per 16-byte vector of channels of one pooled position (the
// channels16 route: c * itemsize a multiple of 16): every window slot's
// vector is loaded into registers before any is reduced, and each input
// vector belongs to exactly one output vector. A block takes `rpb` pooled
// rows (orow, oy) of `upr` = (w / wx) * (c / V) vectors each, or `bpr`
// blocks take one row; NSLOT = wz * wy * wx when it is 4 or 8, else 0 and
// the window is walked in a loop.
template <typename T, int V, int NSLOT>
__global__ void __launch_bounds__(kThreads)
pool_channels_kernel(const Vec<T, V>* __restrict__ x, Vec<T, V>* __restrict__ y,
                     long long n_rows, int h, int w, int cv, int wz, int wy, int wx, int upr,
                     int rpb, int bpr) {
  int lr = 0, u = blockIdx.x * kThreads + threadIdx.x;
  if (rpb > 1) {
    lr = threadIdx.x / upr;
    u = threadIdx.x - lr * upr;
    if (lr >= rpb) return;
  }
  if (u >= upr) return;
  const int ho = h / wy;
  const int ox = u / cv, ch = u - ox * cv;
  for (long long t = (long long)blockIdx.y * rpb + lr; t < n_rows; t += (long long)gridDim.y * rpb) {
    const long long orow = t / ho;
    const int oy = (int)(t - orow * ho);
    const Vec<T, V>* src =
        x + ((orow * wz * h + (long long)oy * wy) * w + (long long)ox * wx) * cv + ch;
    Vec<T, V> best;
    if constexpr (NSLOT > 0) {
      long long off[NSLOT];
      window_offsets(off, h, w, cv, wy, wx);
      Vec<T, V> v[NSLOT];
#pragma unroll
      for (int s = 0; s < NSLOT; ++s) v[s] = src[off[s]];
      best = v[0];
#pragma unroll
      for (int s = 1; s < NSLOT; ++s) max_nan(best, v[s]);
    } else {
      best = src[0];
      for (int a = 0; a < wz; ++a)
        for (int b = 0; b < wy; ++b)
          for (int d = 0; d < wx; ++d)
            if (a | b | d) max_nan(best, src[(((long long)a * h + b) * w + d) * cv]);
    }
    y[t * upr + u] = best;
  }
}

// Whether a pool or pool backward launch fits the route rows16 (every
// pointer, input row and pooled row on the 16-byte grid) or scalar (any).
inline bool pool_rows_fit(int route, uintptr_t align, long long w, long long wo, long long cb) {
  return route == kRouteScalar ||
         (route == kRouteRows16 && align % 16 == 0 && (w * cb) % 16 == 0 && (wo * cb) % 16 == 0);
}

template <typename T>
int launch_pool(const void* x, void* y, int rows, int h, int w, int c, int wz, int wy, int wx,
                int route, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long cb = (long long)c * sizeof(T);
  const int wo = w / wx;
  const long long n_rows = (long long)(rows / wz) * (h / wy);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (route == kRouteChannels16) {
    if (align % 16 || cb % 16) return (int)cudaErrorInvalidValue;
    const int cv = c / V;
    ChannelsGrid cg;
    if (!channels_grid(n_rows, wo, cv, cg)) return (int)cudaErrorInvalidValue;
    auto launch = [&](auto kernel) {
      kernel<<<cg.grid, kThreads, 0, stream>>>(static_cast<const Vec<T, V>*>(x),
                                               static_cast<Vec<T, V>*>(y), n_rows, h, w, cv, wz,
                                               wy, wx, cg.upr, cg.rpb, cg.bpr);
    };
    const int nslot = wz * wy * wx;
    if (nslot == 8)
      launch(pool_channels_kernel<T, V, 8>);
    else if (nslot == 4)
      launch(pool_channels_kernel<T, V, 4>);
    else
      launch(pool_channels_kernel<T, V, 0>);
    return (int)cudaGetLastError();
  }
  if (!pool_rows_fit(route, align, w, wo, cb)) return (int)cudaErrorInvalidValue;
  // columns per chunk are a multiple of the granule, so every chunk's input
  // and output runs start and end on whole vectors
  const long long granule = route == kRouteRows16 ? wx * (16 / gcd_ll(16, cb)) : wx;
  long long wc = w;
  if (w * cb > kPoolStageBytes) wc = std::max(granule, kPoolStageBytes / cb / granule * granule);
  const long long n_chunks = (w + wc - 1) / wc;
  const long long row_bytes = wc * cb;
  // pooled rows per block: at most what the stage holds and what leaves
  // every SM kBlocksPerSm blocks; of those, the fewest that keep the block's
  // phase-1 passes fullest (a ragged last pass idles threads)
  const long long tr_max = std::min(std::max(1LL, kPoolStageBytes / row_bytes),
                                    std::max(1LL, n_rows * n_chunks / (kBlocksPerSm * sm_count())));
  const long long per_pass = (long long)kPoolPass * kThreads * (route == kRouteRows16 ? V : 1);
  long long tr = 1;
  double best_fill = 0.0;
  for (long long cand = 1; cand <= tr_max; ++cand) {
    const long long work = cand * wc * c;
    const double fill = (double)work / ((work + per_pass - 1) / per_pass * per_pass);
    if (fill > best_fill + 0.01) {
      best_fill = fill;
      tr = cand;
    }
  }
  const long long smem = tr * row_bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rows + tr - 1) / tr * n_chunks;
  auto launch = [&](auto kernel) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), h, w, c, wz, wy, wx, n_rows, (int)tr,
        (int)wc, (int)n_chunks);
  };
  if (route == kRouteRows16)
    launch(pool_max_kernel<T, V>);
  else
    launch(pool_max_kernel<T, 1>);
  return (int)cudaGetLastError();
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

// dx = (x == y) ? g : 0 over one vector, compared in float32: every tied
// slot gets the full cotangent, NaN compares false, -0 == +0
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> pool_bwd_select(const Vec<T, V>& xv, const float (&yf)[V],
                                                    const Vec<T, V>& gv) {
  Vec<T, V> out;
#pragma unroll
  for (int i = 0; i < V; ++i) out.v[i] = to_f32(xv.v[i]) == yf[i] ? gv.v[i] : from_f32<T>(0.0f);
  return out;
}

// The pool backward's channels16 route: one thread per 16-byte vector of
// channels of one pooled position, on the forward's grid
// (pool_channels_kernel). It reads that vector of y and g, loads every slot
// of the window into registers before any is compared, and writes every
// slot of dx; NSLOT = wz * wy * wx when it is 4 or 8, else 0 and the window
// is walked in a loop.
template <typename T, int V, int NSLOT>
__global__ void __launch_bounds__(kThreads)
pool_bwd_channels_kernel(const Vec<T, V>* __restrict__ x, const Vec<T, V>* __restrict__ y,
                         const Vec<T, V>* __restrict__ g, Vec<T, V>* __restrict__ dx,
                         long long n_rows, int h, int w, int cv, int wz, int wy, int wx, int upr,
                         int rpb, int bpr) {
  int lr = 0, u = blockIdx.x * kThreads + threadIdx.x;
  if (rpb > 1) {
    lr = threadIdx.x / upr;
    u = threadIdx.x - lr * upr;
    if (lr >= rpb) return;
  }
  if (u >= upr) return;
  const int ho = h / wy;
  const int ox = u / cv, ch = u - ox * cv;
  long long off[NSLOT > 0 ? NSLOT : 1];
  if constexpr (NSLOT > 0) window_offsets(off, h, w, cv, wy, wx);
  for (long long t = (long long)blockIdx.y * rpb + lr; t < n_rows; t += (long long)gridDim.y * rpb) {
    const long long orow = t / ho;
    const int oy = (int)(t - orow * ho);
    const long long base =
        ((orow * wz * h + (long long)oy * wy) * w + (long long)ox * wx) * cv + ch;
    const Vec<T, V> yv = y[t * upr + u], gv = g[t * upr + u];
    float yf[V];
#pragma unroll
    for (int i = 0; i < V; ++i) yf[i] = to_f32(yv.v[i]);
    if constexpr (NSLOT > 0) {
      Vec<T, V> v[NSLOT];
#pragma unroll
      for (int s = 0; s < NSLOT; ++s) v[s] = x[base + off[s]];
#pragma unroll
      for (int s = 0; s < NSLOT; ++s) dx[base + off[s]] = pool_bwd_select(v[s], yf, gv);
    } else {
      for (int a = 0; a < wz; ++a)
        for (int b = 0; b < wy; ++b)
          for (int d = 0; d < wx; ++d) {
            const long long o = base + (((long long)a * h + b) * w + d) * cv;
            dx[o] = pool_bwd_select(x[o], yf, gv);
          }
    }
  }
}

// The pool backward's rows16 and scalar routes: one thread per (pooled row
// t = (orow, oy), vector offset vi of its input runs). Each of the wz * wy
// input runs of t is w * c contiguous elements, and element e of a run
// belongs to pooled element (e / (wx * c)) * c + e % c, the same in every
// run: the thread reads that part of t's y and g once, in units S (the
// widest that divides c * itemsize, at most V elements) that lie within one
// position's channels, loads the run's x vectors at offset vi (up to
// kPoolBwdBatch in flight), and stores dx there. Neighbouring threads take
// neighbouring vectors, so every x load and dx store is coalesced, and the
// wx threads of a window read the same y and g units, which the L1 serves:
// no shared memory, no barrier, and x, y, g and dx each cross device memory
// once.
template <typename T, int V, typename S>
__global__ void __launch_bounds__(kThreads)
pool_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ g,
                     T* __restrict__ dx, int h, int w, int c, int wz, int wy, int wx,
                     long long n_rows, int nvr) {
  constexpr int EPS = sizeof(S) / sizeof(T);  // elements per unit of y and g
  constexpr int G = V / EPS;                  // units per vector
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_rows * nvr) return;
  const long long t = idx / nvr;
  const int vi = (int)(idx - t * nvr);
  const int e0 = vi * V;
  const int ho = h / wy, wo = w / wx;
  const T* yr = y + t * wo * c;
  const T* gr = g + t * wo * c;
  float yf[V];
  Vec<T, V> gv;
  {
    int j = e0 / c, ch = e0 - j * c;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int q = (j / wx) * c + ch;
      const S yu = *reinterpret_cast<const S*>(yr + q);
      reinterpret_cast<S*>(&gv)[i] = *reinterpret_cast<const S*>(gr + q);
      const T* ye = reinterpret_cast<const T*>(&yu);
#pragma unroll
      for (int e = 0; e < EPS; ++e) yf[i * EPS + e] = to_f32(ye[e]);
      ch += EPS;
      if (ch == c) {
        ch = 0;
        ++j;
      }
    }
  }
  const long long in_row = (long long)w * c, in_plane = in_row * h;
  const long long orow = t / ho;
  const T* xb = x + orow * wz * in_plane + (t - orow * ho) * wy * in_row + e0;
  T* db = dx + (xb - x);
  const int nrun = wz * wy;
  int a = 0, b = 0;  // run (a, b): input row (orow * wz + a, oy * wy + b)
  for (int r0 = 0; r0 < nrun; r0 += kPoolBwdBatch) {
    long long off[kPoolBwdBatch];
    Vec<T, V> v[kPoolBwdBatch];
#pragma unroll
    for (int q = 0; q < kPoolBwdBatch; ++q) {
      if (r0 + q >= nrun) break;
      off[q] = a * in_plane + b * in_row;
      v[q] = *reinterpret_cast<const Vec<T, V>*>(xb + off[q]);
      if (++b == wy) {
        b = 0;
        ++a;
      }
    }
#pragma unroll
    for (int q = 0; q < kPoolBwdBatch; ++q) {
      if (r0 + q >= nrun) break;
      *reinterpret_cast<Vec<T, V>*>(db + off[q]) = pool_bwd_select(v[q], yf, gv);
    }
  }
}

template <typename T>
int launch_pool_bwd(const void* x, const void* y, const void* g, void* dx, int rows, int h,
                    int w, int c, int wz, int wy, int wx, int route, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long cb = (long long)c * sizeof(T);
  const int wo = w / wx;
  const long long n_rows = (long long)(rows / wz) * (h / wy);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx);
  if (route == kRouteChannels16) {
    ChannelsGrid cg;
    if (align % 16 || cb % 16 || !channels_grid(n_rows, wo, (int)(cb / 16), cg))
      return (int)cudaErrorInvalidValue;
    auto launch = [&](auto kernel) {
      kernel<<<cg.grid, kThreads, 0, stream>>>(
          static_cast<const Vec<T, V>*>(x), static_cast<const Vec<T, V>*>(y),
          static_cast<const Vec<T, V>*>(g), static_cast<Vec<T, V>*>(dx), n_rows, h, w,
          (int)(cb / 16), wz, wy, wx, cg.upr, cg.rpb, cg.bpr);
    };
    const int nslot = wz * wy * wx;
    if (nslot == 8)
      launch(pool_bwd_channels_kernel<T, V, 8>);
    else if (nslot == 4)
      launch(pool_bwd_channels_kernel<T, V, 4>);
    else
      launch(pool_bwd_channels_kernel<T, V, 0>);
    return (int)cudaGetLastError();
  }
  if (!pool_rows_fit(route, align, w, wo, cb)) return (int)cudaErrorInvalidValue;
  const long long nvr = (long long)w * c / (route == kRouteRows16 ? V : 1);  // vectors a run
  const long long blocks = (n_rows * nvr + kThreads - 1) / kThreads;
  if (nvr > INT32_MAX || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  auto launch = [&](auto kernel) {
    kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(g),
        static_cast<T*>(dx), h, w, c, wz, wy, wx, n_rows, (int)nvr);
  };
  int unit = (int)sizeof(T);  // the unit of y and g: one element on scalar
  if (route == kRouteRows16)
    for (unit = 16; cb % unit;) unit /= 2;
  dispatch_unit(unit, [&](auto s) {
    using S = decltype(s);
    if constexpr (sizeof(S) >= sizeof(T)) {
      if (route == kRouteRows16)
        launch(pool_bwd_rows_kernel<T, V, S>);
      else if constexpr (sizeof(S) == sizeof(T))
        launch(pool_bwd_rows_kernel<T, 1, S>);
    }
  });
  return (int)cudaGetLastError();
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

// 16 bytes from global to shared memory without passing through registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}


// The channels16 route (c * itemsize a multiple of 16): one thread per
// 16-byte vector of channels, straight from and to device memory, no
// staging and no barrier. While the input is small enough to stay in the L2
// (kZcatScatterBytes), each source vector is read once and stored to the kz
// output rows whose taps read it, out[s - t + kz/2, p, t] (the scatter;
// the source planes at an image's edges also write the zero taps of the
// rows next to them). A larger input is gathered in output order instead:
// each output vector reads its tap's source vector, the L2 serving the kz
// re-reads of a plane, and the stores run sequentially through memory.
// Blocks along x cover one plane's hw * cu (scatter) or hw * kz * cu
// (gather) vectors; planes are gridDim.y apart.
__global__ void __launch_bounds__(kThreads)
zcat_scatter_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int rows, int hw,
                    int cu, int kz, int depth) {
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= hw * cu) return;
  const int p = u / cu, j = u - p * cu;
  const int hz = kz / 2;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int s = blockIdx.y; s < rows; s += gridDim.y) {
    const int zs = s % depth;
    const uint4 v = x[((long long)s * hw + p) * cu + j];
    // out[r, p, t, j] for r = s - t + hz in s's image
    for (int t = 0; t < kz; ++t) {
      const int zr = zs - t + hz;
      if (zr >= 0 && zr < depth) out[(((long long)(s - t + hz) * hw + p) * kz + t) * cu + j] = v;
    }
    // the taps past the image's first plane of the hz rows from it, and past
    // its last plane of the hz rows up to it
    if (zs == 0)
      for (int dr = 0; dr < hz && dr < depth; ++dr)
        for (int t = 0; t < hz - dr; ++t)
          out[(((long long)(s + dr) * hw + p) * kz + t) * cu + j] = zero;
    if (zs == depth - 1)
      for (int dr = 0; dr < hz && dr < depth; ++dr)
        for (int t = hz + 1 + dr; t < kz; ++t)
          out[(((long long)(s - dr) * hw + p) * kz + t) * cu + j] = zero;
  }
}

__global__ void __launch_bounds__(kThreads)
zcat_gather_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, int rows, int hw,
                   int cu, int kz, int depth) {
  const int kcu = kz * cu;
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= hw * kcu) return;
  const int p = u / kcu, rem = u - p * kcu, t = rem / cu, j = rem - t * cu;
  const int hz = kz / 2;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int zs = r % depth + t - hz;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (zs >= 0 && zs < depth) v = x[((long long)(r + t - hz) * hw + p) * cu + j];
    out[(long long)r * hw * kcu + u] = v;
  }
}

// The rows16 route at c == 1 (the stem) and kz = KZ: a thread takes EPU
// consecutive positions of `rpt` consecutive output rows. It keeps a window
// of the KZ source planes of its current row in registers, one 16-byte
// vector each (a row loads one new plane, so a plane leaves memory about
// (rpt + KZ - 1) / rpt times), and interleaves them into KZ output vectors,
// element g * KZ + t from element g of tap t (zero where tap t's plane lies
// outside the row's image). A warp's 32 * KZ output vectors are contiguous;
// they pass through shared memory so that each store instruction writes 512
// contiguous bytes.
template <typename E, int KZ>
__global__ void __launch_bounds__(kThreads)
zcat_stem_kernel(const E* __restrict__ x, E* __restrict__ out, int rows, int hw, int depth,
                 int rpt) {
  constexpr int EPU = 16 / sizeof(E);
  constexpr int HZ = KZ / 2;
  __shared__ uint4 xpose[kThreads / 32][32 * KZ];
  const int lane = threadIdx.x % 32;
  uint4* mine = xpose[threadIdx.x / 32];
  const int groups = hw / EPU;
  const int gi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = gi < groups;
  union Pack {
    uint4 u;
    E e[EPU];
  };
  auto plane = [&](int s) {
    return active && s >= 0 && s < rows
               ? reinterpret_cast<const uint4*>(x + (long long)s * hw)[gi]
               : make_uint4(0, 0, 0, 0);
  };
  // the warp's first output vector and how many of its 32 * KZ exist
  const long long w0 = (long long)(gi - lane) * KZ;
  const int wn = (int)min((long long)32 * KZ, (long long)groups * KZ - w0);
  const int r0 = blockIdx.y * rpt, r1 = min(r0 + rpt, rows);
  Pack win[KZ];
#pragma unroll
  for (int t = 1; t < KZ; ++t) win[t].u = plane(r0 - HZ + t - 1);
  int zr = r0 % depth;
  for (int r = r0; r < r1; ++r) {
#pragma unroll
    for (int t = 0; t + 1 < KZ; ++t) win[t] = win[t + 1];
    win[KZ - 1].u = plane(r + HZ);
    Pack in[KZ], o[KZ];
#pragma unroll
    for (int t = 0; t < KZ; ++t)
      in[t].u = zr + t - HZ >= 0 && zr + t - HZ < depth ? win[t].u : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int m = 0; m < KZ * EPU; ++m) o[m / EPU].e[m % EPU] = in[m % KZ].e[m / KZ];
#pragma unroll
    for (int t = 0; t < KZ; ++t) mine[lane * KZ + t] = o[t].u;
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(out + (long long)r * hw * KZ) + w0;
#pragma unroll
    for (int t = 0; t < KZ; ++t)
      if (t * 32 + lane < wn) dst[t * 32 + lane] = mine[t * 32 + lane];
    __syncwarp();
    if (++zr == depth) zr = 0;
  }
}

// One block: output rows [r0, r0 + nr) over the positions [p0, p0 + np)
// (the rows16 and scalar routes). E is the element (itemsize bytes), U the
// unit of every global access (a 16-byte vector or one element), S the unit
// of a stage read (the widest that divides c * itemsize, at most U). The
// source runs of planes r0 - kz/2 + i, np * c elements each, are staged
// once (`stride` bytes apart; a plane that no row of the block reads,
// outside the array or across an image seam, is not loaded). Output row
// r's run, np * kz * c elements, is written unit by unit, each assembled
// from the stage: tap t of row r reads staged plane (r - r0) + t, or zero
// where that plane lies outside r's image.
template <typename E, typename U, typename S>
__global__ void __launch_bounds__(kThreads)
zcat_kernel(const E* __restrict__ x, E* __restrict__ out, int rows, long long hw, int c, int kz,
            int depth, int span, int n_spans, int rg, int stride) {
  extern __shared__ __align__(16) unsigned char zcat_smem[];
  constexpr int EPU = sizeof(U) / sizeof(E);  // elements per unit
  constexpr int EPS = sizeof(S) / sizeof(E);  // elements per stage read
  const int sp = (int)(blockIdx.x % n_spans);
  const int r0 = (int)(blockIdx.x / n_spans) * rg;
  const long long p0 = (long long)sp * span;
  const int np = (int)min((long long)span, hw - p0);
  const int nr = min(rg, rows - r0);
  const int hz = kz / 2;
  const int ns = nr + kz - 1;  // staged planes r0 - hz + i, at most 32

  // planes some row of the block reads (same image, at most hz away): lane
  // i of every warp decides plane i
  bool read = false;
  {
    const int i = threadIdx.x % 32, s = r0 - hz + i;
    if (i < ns && s >= 0 && s < rows) {
      const int img = s / depth;
      read = max(max(r0, img * depth), s - hz) < min(min(r0 + nr, (img + 1) * depth), s + hz + 1);
    }
  }
  const unsigned need = __ballot_sync(0xffffffffu, read);

  const int nu = np * c / EPU;  // units per source run
  for (int idx = threadIdx.x; idx < ns * nu; idx += kThreads) {
    const int i = idx / nu;
    if (!((need >> i) & 1u)) continue;
    const int u = idx - i * nu;
    const U* src = reinterpret_cast<const U*>(x + ((long long)(r0 - hz + i) * hw + p0) * c) + u;
    U* dst = reinterpret_cast<U*>(zcat_smem + (long long)i * stride) + u;
    if constexpr (sizeof(U) == 16)
      cp_async16(dst, src);
    else
      *dst = *src;
  }
  if constexpr (sizeof(U) == 16) cp_async_wait_all();
  __syncthreads();

  // units idx = k * nuo + uo, kThreads apart: (pos, t, ch) of the unit's
  // first element moves on by a fixed step within a row, and is worked out
  // anew only where a thread enters a new row
  const int kc = kz * c;
  const int nuo = np * kc / EPU;  // units per output run
  const int dq = kThreads * EPU;
  const int d_pos = dq / kc, d_t = (dq - d_pos * kc) / c, d_ch = dq - d_pos * kc - d_t * c;
  int k = threadIdx.x / nuo, uo = threadIdx.x - k * nuo;
  int pos = 0, t = 0, ch = 0, zr = 0;
  bool new_row = true;
  while (k < nr) {
    if (new_row) {
      const int q0 = uo * EPU;
      pos = q0 / kc;
      t = (q0 - pos * kc) / c;
      ch = q0 - pos * kc - t * c;
      zr = (r0 + k) % depth;
    }
    // a stage read lies within one tap's channels (c * itemsize is a
    // multiple of sizeof(S))
    union {
      U u;
      S s[sizeof(U) / sizeof(S)];
    } pack;
    int pp = pos, tt = t, cc = ch;
#pragma unroll
    for (int i = 0; i < (int)(sizeof(U) / sizeof(S)); ++i) {
      const int zs = zr + tt - hz;
      pack.s[i] = S{};
      if (zs >= 0 && zs < depth)
        pack.s[i] = *reinterpret_cast<const S*>(zcat_smem + (long long)(k + tt) * stride +
                                                ((long long)pp * c + cc) * sizeof(E));
      cc += EPS;
      if (cc == c) {
        cc = 0;
        if (++tt == kz) {
          tt = 0;
          ++pp;
        }
      }
    }
    reinterpret_cast<U*>(out + ((long long)(r0 + k) * hw + p0) * kc)[uo] = pack.u;
    uo += kThreads;
    new_row = uo >= nuo;
    if (new_row) {
      while (uo >= nuo) {
        uo -= nuo;
        ++k;
      }
    } else {
      ch += d_ch;
      if (ch >= c) {
        ch -= c;
        ++t;
      }
      t += d_t;
      if (t >= kz) {
        t -= kz;
        ++pos;
      }
      pos += d_pos;
    }
  }
}

template <typename E>
int launch_zcat(const void* x, void* out, int rows, long long hw, int c, int kz, int depth,
                int route, cudaStream_t stream) {
  const long long cb = (long long)c * sizeof(E);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  const unsigned grid_y = (unsigned)std::min(rows, 65535);
  if (route == kRouteChannels16) {
    if (align % 16 || cb % 16 || hw * kz * (cb / 16) > INT32_MAX) return (int)cudaErrorInvalidValue;
    const int cu = (int)(cb / 16);
    const long long units = hw * cu * (rows * hw * cb > kZcatScatterBytes ? kz : 1);
    const dim3 grid((unsigned)((units + kThreads - 1) / kThreads), grid_y);
    if (rows * hw * cb > kZcatScatterBytes)
      zcat_gather_kernel<<<grid, kThreads, 0, stream>>>(
          static_cast<const uint4*>(x), static_cast<uint4*>(out), rows, (int)hw, cu, kz, depth);
    else
      zcat_scatter_kernel<<<grid, kThreads, 0, stream>>>(
          static_cast<const uint4*>(x), static_cast<uint4*>(out), rows, (int)hw, cu, kz, depth);
    return (int)cudaGetLastError();
  }
  if (route == kRouteRows16 && c == 1 && (kz == 3 || kz == 5)) {
    constexpr int EPU = 16 / sizeof(E);
    if (align % 16 || hw % EPU || hw > INT32_MAX) return (int)cudaErrorInvalidValue;
    const long long groups = (hw / EPU + kThreads - 1) / kThreads;
    // rows a thread: up to kZcatStemRows while every SM keeps kBlocksPerSm
    int rpt = kZcatStemRows;
    while (rpt > 1 && groups * ((rows + rpt - 1) / rpt) < (long long)kBlocksPerSm * sm_count())
      rpt /= 2;
    const dim3 grid((unsigned)groups, (unsigned)((rows + rpt - 1) / rpt));
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    if (kz == 3)
      zcat_stem_kernel<E, 3><<<grid, kThreads, 0, stream>>>(
          static_cast<const E*>(x), static_cast<E*>(out), rows, (int)hw, depth, rpt);
    else
      zcat_stem_kernel<E, 5><<<grid, kThreads, 0, stream>>>(
          static_cast<const E*>(x), static_cast<E*>(out), rows, (int)hw, depth, rpt);
    return (int)cudaGetLastError();
  }
  // positions per span are a multiple of the granule, so every span's source
  // and output runs start and end on whole units
  long long granule = 1;
  if (route == kRouteRows16) {
    if (align % 16 || (hw * cb) % 16) return (int)cudaErrorInvalidValue;
    granule = 16 / gcd_ll(16, cb);
  } else if (route != kRouteScalar) {
    return (int)cudaErrorInvalidValue;
  }
  if (kz > 25) return (int)cudaErrorInvalidValue;  // the stage's planes fit one 32-bit mask
  long long span = std::min(hw, std::max(granule, kZcatRunBytes / cb / granule * granule));
  long long rg = std::min<long long>(kZcatRows, rows);
  const long long want = (long long)kBlocksPerSm * sm_count();
  auto blocks = [&] { return (rows + rg - 1) / rg * ((hw + span - 1) / span); };
  // blocks enough for every SM: shorter spans first (down to 512-byte
  // runs), then fewer rows per block
  while (blocks() < want && span > granule && span * cb > kZcatMinRunBytes)
    span = std::max(granule, span / 2 / granule * granule);
  while (blocks() < want && rg > 1) rg /= 2;
  const long long stride = (span * cb + 15) / 16 * 16;
  while ((rg + kz - 1) * stride > kMaxSmem && rg > 1) rg /= 2;
  const long long smem = (rg + kz - 1) * stride;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long n_spans = (hw + span - 1) / span;
  auto launch = [&](auto kernel) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kernel<<<(unsigned)blocks(), kThreads, (size_t)smem, stream>>>(
        static_cast<const E*>(x), static_cast<E*>(out), rows, hw, c, kz, depth, (int)span,
        (int)n_spans, (int)rg, (int)stride);
  };
  if (route == kRouteScalar) {
    launch(zcat_kernel<E, E, E>);
  } else {
    int unit = 16;
    while (cb % unit) unit /= 2;
    dispatch_unit(std::max<int>(unit, sizeof(E)), [&](auto s) {
      using S = decltype(s);
      if constexpr (sizeof(S) >= sizeof(E)) launch(zcat_kernel<E, uint4, S>);
    });
  }
  return (int)cudaGetLastError();
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


}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x is (rows, h, w, c) with rows % wz,
// h % wy and w % wx all zero (checked by the caller). route: 0 = channels16
// (x and y 16-byte aligned, c * itemsize a multiple of 16), 1 = rows16 (x
// and y 16-byte aligned, w * c and (w / wx) * c whole 16-byte vectors), 2 =
// scalar (any); a launch that does not fit its route is refused. Returns
// the launch's cudaGetLastError(), or cudaErrorInvalidValue when refused.
extern "C" int biapy_pool_max_folded(const void* x, void* y, int dtype, int rows, int h, int w,
                                     int c, int wz, int wy, int wx, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)(rows / wz) * (h / wy) * (w / wx) * c;
  if (total == 0) return (int)cudaGetLastError();
  if (dtype == 0) return launch_pool<float>(x, y, rows, h, w, c, wz, wy, wx, route, s);
  if (dtype == 1) return launch_pool<__nv_bfloat16>(x, y, rows, h, w, c, wz, wy, wx, route, s);
  return (int)cudaErrorInvalidValue;
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
// shape; all of one dtype (0 = float32, 1 = bfloat16). route: as the
// pool's, over all four pointers (0 = channels16, 1 = rows16, 2 = scalar);
// a launch that does not fit its route is refused. Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue when refused.
extern "C" int biapy_pool_max_folded_bwd(const void* x, const void* y, const void* g, void* dx,
                                         int dtype, int rows, int h, int w, int c, int wz,
                                         int wy, int wx, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)(rows / wz) * (h / wy) * (w / wx) * c;
  if (total == 0) return (int)cudaGetLastError();
  if (dtype == 0)
    return launch_pool_bwd<float>(x, y, g, dx, rows, h, w, c, wz, wy, wx, route, s);
  if (dtype == 1)
    return launch_pool_bwd<__nv_bfloat16>(x, y, g, dx, rows, h, w, c, wz, wy, wx, route, s);
  return (int)cudaErrorInvalidValue;
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

// x is (rows, h, w, c) of any dtype of `itemsize` bytes (1, 2, 4 or 8),
// rows a multiple of depth; out is (rows, h, w, kz*c), kz odd. route: 0 =
// channels16 (x and out 16-byte aligned, c * itemsize a multiple of 16), 1
// = rows16 (x and out 16-byte aligned, h * w * c whole 16-byte vectors), 2 =
// scalar (any); a launch that does not fit its route is refused. Returns
// the launch's cudaGetLastError(), or cudaErrorInvalidValue when refused.
extern "C" int biapy_zcat(const void* x, void* out, int itemsize, int rows, int h, int w, int c,
                          int kz, int depth, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hw = (long long)h * w;
  if ((long long)rows * hw * c == 0) return (int)cudaGetLastError();
  switch (itemsize) {
    case 1: return launch_zcat<uint8_t>(x, out, rows, hw, c, kz, depth, route, s);
    case 2: return launch_zcat<uint16_t>(x, out, rows, hw, c, kz, depth, route, s);
    case 4: return launch_zcat<uint32_t>(x, out, rows, hw, c, kz, depth, route, s);
    case 8: return launch_zcat<uint64_t>(x, out, rows, hw, c, kz, depth, route, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
