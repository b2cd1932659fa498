// Native host ops for post-processing: marker-controlled watershed,
// connected components, hole filling.
//
// Reference analog: the reference delegates these to scikit-image /
// fill-voids C extensions (SURVEY.md §2.9); here they are first-party C++.
// Exposed via a C ABI consumed with ctypes (biapy_tpu_torch/native/__init__.py).
//
// Conventions: row-major arrays; 2D shapes (h, w) and 3D shapes (d, h, w);
// labels are int32 (0 = background); connectivity is face-adjacent
// (4-neighbour in 2D, 6-neighbour in 3D).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct PQItem {
    float priority;
    int64_t order;  // FIFO tie-break for stability
    int64_t idx;
};
struct PQCompare {
    bool operator()(const PQItem& a, const PQItem& b) const {
        if (a.priority != b.priority) return a.priority > b.priority;  // min-heap
        return a.order > b.order;
    }
};

inline int n_neighbors(int ndim) { return 2 * ndim; }

// Compute the flat-index offsets and per-axis strides for face neighbours.
void neighbor_offsets(const int64_t* shape, int ndim, int64_t* strides) {
    strides[ndim - 1] = 1;
    for (int d = ndim - 2; d >= 0; --d) strides[d] = strides[d + 1] * shape[d + 1];
}

constexpr float kEdtInf = 1e30f;

// Exact 1-D squared-distance transform under a sampling step `w` (lower
// envelope of parabolas, Felzenszwalb & Huttenlocher 2012). `f` holds
// squared distances (kEdtInf where no feature reaches); parabolas with
// infinite height never enter the envelope.
void dt1d(const float* f, float* d, int n, float w, int* v, float* z) {
    const float w2 = w * w;
    int k = -1;
    for (int q = 0; q < n; ++q) {
        if (f[q] >= kEdtInf) continue;
        float s = 0.0f;
        while (k >= 0) {
            // intersection of parabola q with parabola v[k]
            s = ((f[q] + w2 * q * q) - (f[v[k]] + w2 * v[k] * v[k])) /
                (2.0f * w2 * (q - v[k]));
            if (s > z[k]) break;
            --k;
        }
        ++k;
        v[k] = q;
        z[k] = (k == 0) ? -kEdtInf : s;
        if (k + 1 < n + 1) z[k + 1] = kEdtInf;
    }
    if (k < 0) {  // no feature on this line
        for (int q = 0; q < n; ++q) d[q] = kEdtInf;
        return;
    }
    int j = 0;
    for (int q = 0; q < n; ++q) {
        while (j < k && z[j + 1] < q) ++j;
        const float dq = w * (q - v[j]);
        d[q] = dq * dq + f[v[j]];
    }
}

// Run fn(i) for i in [0, n) across up to `n_threads` host threads.
template <typename Fn>
void parallel_for(int64_t n, int n_threads, Fn fn) {
    if (n_threads <= 1 || n < 2) {
        for (int64_t i = 0; i < n; ++i) fn(i);
        return;
    }
    int t = static_cast<int>(n_threads < n ? n_threads : n);
    std::vector<std::thread> pool;
    pool.reserve(t);
    for (int ti = 0; ti < t; ++ti) {
        int64_t lo = n * ti / t, hi = n * (ti + 1) / t;
        pool.emplace_back([=]() { for (int64_t i = lo; i < hi; ++i) fn(i); });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Exact Euclidean distance transform (scipy.ndimage.distance_transform_edt
// semantics: distance from every nonzero voxel to the nearest ZERO voxel),
// separable FH passes threaded per line. `sampling` is the per-axis voxel
// size (pass 1.0s for isotropic). Output float32 distances.
void edt(const uint8_t* input, float* out, const int64_t* shape,
         const float* sampling, int ndim, int n_threads) {
    int64_t strides[8];
    neighbor_offsets(shape, ndim, strides);
    int64_t total = 1;
    for (int d = 0; d < ndim; ++d) total *= shape[d];
    if (total == 0) return;

    // pass 0 along the last (contiguous) axis: two linear scans give the
    // 1-D distance to the nearest zero; squared into `out`
    {
        const int n = static_cast<int>(shape[ndim - 1]);
        const float w = sampling[ndim - 1];
        const int64_t lines = total / n;
        parallel_for(lines, n_threads, [&](int64_t l) {
            const uint8_t* in = input + l * n;
            float* o = out + l * n;
            float dist = kEdtInf;
            for (int q = 0; q < n; ++q) {
                dist = in[q] ? ((dist >= kEdtInf) ? kEdtInf : dist + w) : 0.0f;
                o[q] = dist;
            }
            dist = o[n - 1];
            for (int q = n - 1; q >= 0; --q) {
                dist = in[q] ? ((dist >= kEdtInf) ? kEdtInf : dist + w) : 0.0f;
                if (dist < o[q]) o[q] = dist;
                dist = o[q];
                o[q] = (o[q] >= kEdtInf) ? kEdtInf : o[q] * o[q];
            }
        });
    }

    // remaining axes: parabola pass per line (gather/scatter by stride)
    for (int axis = ndim - 2; axis >= 0; --axis) {
        const int n = static_cast<int>(shape[axis]);
        const float w = sampling[axis];
        const int64_t st = strides[axis];
        int64_t outer = 1, inner = st;
        for (int d = 0; d < axis; ++d) outer *= shape[d];
        const int64_t lines = outer * inner;
        parallel_for(lines, n_threads, [&](int64_t l) {
            const int64_t o = l / inner, i = l % inner;
            float* base = out + o * n * inner + i;
            std::vector<float> f(n), d(n), z(n + 1);
            std::vector<int> v(n);
            for (int q = 0; q < n; ++q) f[q] = base[q * st];
            dt1d(f.data(), d.data(), n, w, v.data(), z.data());
            for (int q = 0; q < n; ++q) base[q * st] = d[q];
        });
    }

    parallel_for((total + (1 << 20) - 1) >> 20, n_threads, [&](int64_t c) {
        const int64_t lo = c << 20;
        const int64_t hi = (lo + (1 << 20) < total) ? lo + (1 << 20) : total;
        for (int64_t i = lo; i < hi; ++i)
            out[i] = (out[i] >= kEdtInf) ? kEdtInf : std::sqrt(out[i]);
    });
}

// Marker-controlled watershed: flood from seed labels in increasing order of
// `topography`, restricted to mask != 0. In-place on `labels`.
void watershed(const float* topography, int32_t* labels, const uint8_t* mask,
               const int64_t* shape, int ndim) {
    int64_t strides[8];
    neighbor_offsets(shape, ndim, strides);
    int64_t total = 1;
    for (int d = 0; d < ndim; ++d) total *= shape[d];

    std::priority_queue<PQItem, std::vector<PQItem>, PQCompare> pq;
    std::vector<uint8_t> queued(total, 0);
    int64_t order = 0;

    // seed the queue with the border of every labelled region
    for (int64_t i = 0; i < total; ++i) {
        if (labels[i] != 0) queued[i] = 1;
    }
    for (int64_t i = 0; i < total; ++i) {
        if (labels[i] == 0) continue;
        // push unlabelled neighbours
        int64_t rem = i;
        int64_t coord[8];
        for (int d = 0; d < ndim; ++d) {
            coord[d] = rem / strides[d];
            rem %= strides[d];
        }
        for (int d = 0; d < ndim; ++d) {
            for (int s = -1; s <= 1; s += 2) {
                int64_t c = coord[d] + s;
                if (c < 0 || c >= shape[d]) continue;
                int64_t j = i + s * strides[d];
                if (labels[j] == 0 && !queued[j] && (!mask || mask[j])) {
                    queued[j] = 1;
                    pq.push({topography[j], order++, j});
                }
            }
        }
    }

    int64_t coord[8];
    while (!pq.empty()) {
        PQItem item = pq.top();
        pq.pop();
        int64_t i = item.idx;
        if (labels[i] != 0) continue;
        // label from any labelled neighbour (first found)
        int64_t rem = i;
        for (int d = 0; d < ndim; ++d) {
            coord[d] = rem / strides[d];
            rem %= strides[d];
        }
        int32_t lab = 0;
        for (int d = 0; d < ndim && !lab; ++d) {
            for (int s = -1; s <= 1 && !lab; s += 2) {
                int64_t c = coord[d] + s;
                if (c < 0 || c >= shape[d]) continue;
                int64_t j = i + s * strides[d];
                if (labels[j] > 0) lab = labels[j];
            }
        }
        if (!lab) continue;
        labels[i] = lab;
        for (int d = 0; d < ndim; ++d) {
            for (int s = -1; s <= 1; s += 2) {
                int64_t c = coord[d] + s;
                if (c < 0 || c >= shape[d]) continue;
                int64_t j = i + s * strides[d];
                if (labels[j] == 0 && !queued[j] && (!mask || mask[j])) {
                    queued[j] = 1;
                    pq.push({topography[j], order++, j});
                }
            }
        }
    }
}

// Connected components over a binary mask (face connectivity); writes int32
// labels; returns the number of components.
int32_t connected_components(const uint8_t* mask, int32_t* labels,
                             const int64_t* shape, int ndim) {
    int64_t strides[8];
    neighbor_offsets(shape, ndim, strides);
    int64_t total = 1;
    for (int d = 0; d < ndim; ++d) total *= shape[d];
    std::memset(labels, 0, total * sizeof(int32_t));

    int32_t next = 0;
    std::vector<int64_t> stack;
    int64_t coord[8];
    for (int64_t start = 0; start < total; ++start) {
        if (!mask[start] || labels[start]) continue;
        ++next;
        labels[start] = next;
        stack.push_back(start);
        while (!stack.empty()) {
            int64_t i = stack.back();
            stack.pop_back();
            int64_t rem = i;
            for (int d = 0; d < ndim; ++d) {
                coord[d] = rem / strides[d];
                rem %= strides[d];
            }
            for (int d = 0; d < ndim; ++d) {
                for (int s = -1; s <= 1; s += 2) {
                    int64_t c = coord[d] + s;
                    if (c < 0 || c >= shape[d]) continue;
                    int64_t j = i + s * strides[d];
                    if (mask[j] && !labels[j]) {
                        labels[j] = next;
                        stack.push_back(j);
                    }
                }
            }
        }
    }
    return next;
}

// Fill holes: background components not connected to the array border become
// foreground. In-place on `mask`.
void fill_holes(uint8_t* mask, const int64_t* shape, int ndim) {
    int64_t strides[8];
    neighbor_offsets(shape, ndim, strides);
    int64_t total = 1;
    for (int d = 0; d < ndim; ++d) total *= shape[d];

    std::vector<uint8_t> outside(total, 0);
    std::vector<int64_t> stack;
    int64_t coord[8];

    // seed flood from all border background voxels
    for (int64_t i = 0; i < total; ++i) {
        if (mask[i]) continue;
        int64_t rem = i;
        bool border = false;
        for (int d = 0; d < ndim; ++d) {
            coord[d] = rem / strides[d];
            rem %= strides[d];
            if (coord[d] == 0 || coord[d] == shape[d] - 1) border = true;
        }
        if (border && !outside[i]) {
            outside[i] = 1;
            stack.push_back(i);
        }
    }
    while (!stack.empty()) {
        int64_t i = stack.back();
        stack.pop_back();
        int64_t rem = i;
        for (int d = 0; d < ndim; ++d) {
            coord[d] = rem / strides[d];
            rem %= strides[d];
        }
        for (int d = 0; d < ndim; ++d) {
            for (int s = -1; s <= 1; s += 2) {
                int64_t c = coord[d] + s;
                if (c < 0 || c >= shape[d]) continue;
                int64_t j = i + s * strides[d];
                if (!mask[j] && !outside[j]) {
                    outside[j] = 1;
                    stack.push_back(j);
                }
            }
        }
    }
    for (int64_t i = 0; i < total; ++i) {
        if (!mask[i] && !outside[i]) mask[i] = 1;
    }
}

// Union-find relabel: given `n_edges` pairs (a, b) of labels that must merge,
// rewrite `remap[label]` (size n_labels+1) with canonical smallest ids.
// Used by the cross-chunk instance merge (reference: instance_seg.py Pass D).
void union_find_merge(const int32_t* edges_a, const int32_t* edges_b, int64_t n_edges,
                      int32_t* remap, int64_t n_labels) {
    std::vector<int32_t> parent(n_labels + 1);
    for (int64_t i = 0; i <= n_labels; ++i) parent[i] = (int32_t)i;
    std::vector<int32_t>* pp = &parent;
    struct {
        std::vector<int32_t>* p;
        int32_t find(int32_t x) {
            while ((*p)[x] != x) {
                (*p)[x] = (*p)[(*p)[x]];
                x = (*p)[x];
            }
            return x;
        }
    } uf{pp};
    for (int64_t e = 0; e < n_edges; ++e) {
        int32_t ra = uf.find(edges_a[e]);
        int32_t rb = uf.find(edges_b[e]);
        if (ra != rb) {
            if (ra < rb) parent[rb] = ra; else parent[ra] = rb;
        }
    }
    for (int64_t i = 0; i <= n_labels; ++i) remap[i] = uf.find((int32_t)i);
}

}  // extern "C"
