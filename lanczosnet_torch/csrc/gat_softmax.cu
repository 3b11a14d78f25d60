// GAT's edge softmax over the CSR, and its gradient.
//
// Replaces no TPU kernel: the JAX package's softmax
// (lanczosnet_tpu/ops/sparse.py:segment_softmax_coo) is XLA's gathers,
// segment_max and segment_sum, which fuse on the TPU. The port ran it as
// ATen's ops over [E, H] tensors: the gathers s_dst[row] and s_src[col],
// the add and leaky_relu, the live mask, a bfloat16 scatter max with
// atomics, the gather m[row], the subtraction, exp and mask, a float32
// index_add for the denominator, and a cast and transpose of the weights
// into the head-major float32 [H, E] that the CSR product kernels read:
// more than ten passes through 1-2 GB tensors a layer, and as many again
// in the backward. The host wrapper is lanczosnet_torch/ops/gat_softmax_cuda.py;
// the plain version it is held to is ops/sparse.py:segment_softmax_coo and
// the autograd of gat_attention on the CPU.
//
// What bounds it on an H100. The forward reads each edge's col and val
// (8 bytes) and gathers the source's H scores (8 bytes at H=4 in
// bfloat16, from an [N, H] table of 19.6 MB at ogbn-products' 2.45M nodes,
// which the 50 MB L2 holds), and writes one float32 weight an edge and
// head: about 3 GB at 123.7M edges, 0.9 ms at 3.35 TB/s. The backward
// reads the same edges and scores, the weights' gradient (float32 [H, E])
// and writes the logits' gradient ([E, H] in the scores' dtype), then
// gathers that gradient again in source order: about 5 GB.
//
// What the design does about it. A group of kLanes threads owns one
// destination row of the CSR; lane j takes the row's edges j, j + kLanes,
// ..., loading col and val coalesced, and each edge's scores in one vector
// load (HB heads of T: 2 to 16 bytes). Pass 1 is the max of the row's live
// logits a head, joined by shuffle over the group (the max is exact in any
// order) and with the self-edge's logit, floored at -1e30. Pass 2 reads the
// row again (from L1/L2) and writes each edge's weight head-major; the
// group adds the weights to the denominator in edge order by broadcasting
// each lane's in turn (a shuffle an edge and head), so the sum is the
// plain version's. No [E, H] logits, mask or exponential tensor exists,
// and no atomic runs. Wider H, or float32 scores, loop over blocks of HB
// heads, each block one walk of the row. For an edge-sharded piece the
// kernel runs pass 1 alone (kMaxOnly), the host takes the max over the
// shards, then pass 2 alone (kExpOnly) with that max.
//
// A walk of a row is a chain of dependent loads (col, then the scores it
// points at), so its length sets the time. Measured at the cell's shapes
// on the H100: the forward took 12.6 / 6.3 / 3.9 / 4.1 ms with groups of
// 4 / 8 / 16 / 32 lanes (32 lanes pay a shuffle an edge and head for the
// ordered sum, where 16 share it between two rows), and 3.5 ms with pass 1
// loading two edges a lane before using either. Two edges in flight in
// every walk ran slower (the forward 4.2 ms, the gradient 4.9 against 3.6).
//
// The gradient. gat_softmax_grad_kernel walks the destination rows as the
// forward does, recomputes each live edge's logit and weight from the
// saved max, forms the logit's gradient from the weight's (the weighted
// sums' and the denominator's), writes it [E, H], and adds it to s_dst's
// gradient in edge order. gat_softmax_src_grad_kernel walks each source's
// edges in col_perm order (the order of the plain version's sorted
// scatter) over the source-major view (col_ptr, col_perm) and adds their
// logit gradients to s_src's. No atomics: two calls give the same bits.
//
// Order of arithmetic, as the plain version does it. Each ATen op on a
// 16-bit tensor computes in float32 and rounds its result once: the add
// of the two scores, leaky_relu, the difference from the max, exp, and in
// the backward each product and sum of two gradients. The kernel rounds at
// the same points (narrow<T>: round to nearest even, as ATen's cast);
// __fadd_rn/__fsub_rn/__fmul_rn keep nvcc from contracting an FMA the plain
// version lacks. Sums over edges are float32 from +0, in edge order (the
// denominator, s_dst's gradient) or col_perm order (s_src's), narrowed
// once. The one difference: expf on the card against the CPU's exp, which
// may differ by a float32 ulp, and so by one bfloat16 ulp in a weight.
//
// Build (lanczosnet_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 64;  // threads of a block
constexpr int kLanes = 16;    // threads of the group that owns a row

enum Dtype : int { kFloat32 = 0, kBFloat16 = 1 };
enum Mode : int { kBoth = 0, kMaxOnly = 1, kExpOnly = 2 };

// float -> T (round to nearest even, as ATen's cast) -> float
template <typename T>
__device__ __forceinline__ float narrow(float v) {
    if constexpr (std::is_same_v<T, float>) {
        return v;
    } else {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
}

// HB heads of T as they lie in one row of an [*, H] tensor, moved in one
// load or store of HB * sizeof(T) bytes (2, 4, 8 or 16), widened to float.
template <typename T, int HB>
struct Heads {
    static constexpr int kBytes = HB * static_cast<int>(sizeof(T));
    static_assert(kBytes == 2 || kBytes == 4 || kBytes == 8 || kBytes == 16, "2 to 16 bytes");
    static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;

    __device__ __forceinline__ static void load(const T* p, float (&out)[HB]) {
        unsigned w[kWords];
        if constexpr (kBytes == 2) {
            w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
        } else if constexpr (kBytes == 4) {
            w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
        } else if constexpr (kBytes == 8) {
            const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
            w[0] = r.x;
            w[1] = r.y;
        } else {
            const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
            w[0] = r.x;
            w[1] = r.y;
            w[2] = r.z;
            w[3] = r.w;
        }
        if constexpr (std::is_same_v<T, float>) {
#pragma unroll
            for (int i = 0; i < HB; ++i) out[i] = __uint_as_float(w[i]);
        } else if constexpr (kBytes == 2) {
            out[0] = __uint_as_float(w[0] << 16);
        } else {
#pragma unroll
            for (int i = 0; i < kWords; ++i) {
                out[2 * i] = __uint_as_float(w[i] << 16);
                out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
            }
        }
    }

    // in[] rounded to T and stored
    __device__ __forceinline__ static void store(T* p, const float (&in)[HB]) {
        unsigned w[kWords];
        if constexpr (std::is_same_v<T, float>) {
#pragma unroll
            for (int i = 0; i < HB; ++i) w[i] = __float_as_uint(in[i]);
        } else {
#pragma unroll
            for (int i = 0; i < HB; i += 2) {
                const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(in[i]));
                const unsigned hi =
                    i + 1 < HB ? __bfloat16_as_ushort(__float2bfloat16_rn(in[i + 1])) : 0u;
                w[i / 2] = lo | (hi << 16);
            }
        }
        if constexpr (kBytes == 2) {
            *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
        } else if constexpr (kBytes == 4) {
            *reinterpret_cast<unsigned*>(p) = w[0];
        } else if constexpr (kBytes == 8) {
            *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
        } else {
            *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
        }
    }
};

// The lanes of this thread's group within its warp.
__device__ __forceinline__ unsigned group_mask() {
    if constexpr (kLanes == 32) {
        return 0xffffffffu;
    } else {
        const int first = (threadIdx.x & 31) & ~(kLanes - 1);
        return ((1u << kLanes) - 1u) << first;
    }
}

// The add of the two scores, rounded to T: leaky_relu's input.
template <typename T>
__device__ __forceinline__ float score_sum(float dst, float src) {
    return narrow<T>(__fadd_rn(dst, src));
}

// leaky_relu of x (a T value), rounded to T.
template <typename T>
__device__ __forceinline__ float leaky(float x, float slope) {
    return x > 0.0f ? x : narrow<T>(__fmul_rn(x, slope));
}

// exp(narrow(logit - m)), rounded to T: an edge's weight, the self-edge's.
template <typename T>
__device__ __forceinline__ float weight(float logit, float m) {
    return narrow<T>(expf(narrow<T>(__fsub_rn(logit, m))));
}

// acc[i] += v[i] of each lane of the group in lane order, for the first
// cnt lanes: the group's edges added in edge order.
template <int HB>
__device__ __forceinline__ void add_in_lane_order(float (&acc)[HB], const float (&v)[HB],
                                                  int cnt, unsigned mask) {
    for (int j = 0; j < cnt; ++j) {
#pragma unroll
        for (int i = 0; i < HB; ++i) acc[i] = __fadd_rn(acc[i], __shfl_sync(mask, v[i], j, kLanes));
    }
}

// The logit of a live edge whose source is c, for HB heads from hb: the
// scores' sum, rounded, through leaky_relu, rounded.
template <typename T, int HB>
__device__ __forceinline__ void edge_logits(const T* __restrict__ s_src, int c, int heads, int hb,
                                            const float (&dst)[HB], float slope,
                                            float (&logit)[HB]) {
    float src[HB];
    Heads<T, HB>::load(s_src + static_cast<long long>(c) * heads + hb, src);
#pragma unroll
    for (int i = 0; i < HB; ++i) logit[i] = leaky<T>(score_sum<T>(dst[i], src[i]), slope);
}

// Per destination row r and head h, over the live edges e of r
// (val[e] != 0) and the self-edge: m = max(-1e30, logit_e, self) where
// logit_e = leaky_relu(s_dst[r] + s_src[col[e]]); p[h, e] =
// exp(logit_e - m) (0 on a dead edge); denom[r] = sum_e p[h, e];
// p_self[r] = exp(self[r] - m). kMaxOnly writes m alone; kExpOnly reads m.
template <typename T, int HB, int MODE>
__global__ void __launch_bounds__(kThreads)
gat_softmax_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                   const float* __restrict__ val, const T* __restrict__ s_dst,
                   const T* __restrict__ s_src, const T* __restrict__ self_logit, T* m,
                   float* __restrict__ p, T* __restrict__ denom, T* __restrict__ p_self,
                   int n_rows, int heads, long long n_edges, float slope) {
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long group = t / kLanes;
    const int lane = static_cast<int>(t & (kLanes - 1));
    if (group >= n_rows) return;  // whole groups leave
    const int r = static_cast<int>(group);
    const unsigned mask = group_mask();
    const int beg = __ldg(ptr + r), end = __ldg(ptr + r + 1);
    const float neg = narrow<T>(-1e30f);
    const long long node = static_cast<long long>(r) * heads;

    for (int hb = 0; hb < heads; hb += HB) {
        float dst[HB], self[HB], mx[HB];
        Heads<T, HB>::load(s_dst + node + hb, dst);
        Heads<T, HB>::load(self_logit + node + hb, self);
        if constexpr (MODE == kExpOnly) {
            Heads<T, HB>::load(m + node + hb, mx);
        } else {
#pragma unroll
            for (int i = 0; i < HB; ++i) mx[i] = neg;
            // two edges a lane at a time, both loaded before either is used
            for (int e = beg + lane; e < end; e += 2 * kLanes) {
                const int e2 = e + kLanes;
                const bool live = __ldg(val + e) != 0.0f;
                const bool live2 = e2 < end && __ldg(val + e2) != 0.0f;
                float lg[HB], lg2[HB];
                if (live) edge_logits<T, HB>(s_src, __ldg(col + e), heads, hb, dst, slope, lg);
                if (live2) edge_logits<T, HB>(s_src, __ldg(col + e2), heads, hb, dst, slope, lg2);
#pragma unroll
                for (int i = 0; i < HB; ++i) {
                    if (live) mx[i] = fmaxf(mx[i], lg[i]);
                    if (live2) mx[i] = fmaxf(mx[i], lg2[i]);
                }
            }
            for (int o = kLanes >> 1; o > 0; o >>= 1) {
#pragma unroll
                for (int i = 0; i < HB; ++i)
                    mx[i] = fmaxf(mx[i], __shfl_xor_sync(mask, mx[i], o, kLanes));
            }
#pragma unroll
            for (int i = 0; i < HB; ++i) mx[i] = fmaxf(mx[i], self[i]);
            if (lane == 0) Heads<T, HB>::store(m + node + hb, mx);
        }
        if constexpr (MODE != kMaxOnly) {
            float acc[HB];
#pragma unroll
            for (int i = 0; i < HB; ++i) acc[i] = 0.0f;
            for (int base = beg; base < end; base += kLanes) {
                const int cnt = min(kLanes, end - base);
                const int e = base + lane;
                float w[HB];
#pragma unroll
                for (int i = 0; i < HB; ++i) w[i] = 0.0f;
                if (lane < cnt) {
                    if (__ldg(val + e) != 0.0f) {
                        float lg[HB];
                        edge_logits<T, HB>(s_src, __ldg(col + e), heads, hb, dst, slope, lg);
#pragma unroll
                        for (int i = 0; i < HB; ++i) w[i] = weight<T>(lg[i], mx[i]);
                    }
#pragma unroll
                    for (int i = 0; i < HB; ++i) p[(hb + i) * n_edges + e] = w[i];
                }
                add_in_lane_order<HB>(acc, w, cnt, mask);
            }
            if (lane == 0) {
                float ps[HB];
#pragma unroll
                for (int i = 0; i < HB; ++i) ps[i] = weight<T>(self[i], mx[i]);
                Heads<T, HB>::store(denom + node + hb, acc);
                Heads<T, HB>::store(p_self + node + hb, ps);
            }
        }
    }
}

// Per destination row r, head h and edge e of r: the weight's gradient
// dw = narrow(dp[h, e] + dden[r, h]) (the weighted sums' and the
// denominator's); on a live edge, with the weight w recomputed from the
// saved max, the logit's gradient narrow(dw * w) through leaky_relu's
// (times the slope where the scores' sum is not positive, rounded), 0 on a
// dead edge, written to gl[e, h]; ds_dst[r] = sum_e gl[e, h] in edge order.
// A missing dp or dden adds -0, which leaves every value as it is.
template <typename T, int HB>
__global__ void __launch_bounds__(kThreads)
gat_softmax_grad_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                        const float* __restrict__ val, const T* __restrict__ s_dst,
                        const T* __restrict__ s_src, const T* __restrict__ m,
                        const float* __restrict__ dp, const T* __restrict__ dden,
                        T* __restrict__ gl, T* __restrict__ ds_dst, int n_rows, int heads,
                        long long n_edges, float slope) {
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long group = t / kLanes;
    const int lane = static_cast<int>(t & (kLanes - 1));
    if (group >= n_rows) return;
    const int r = static_cast<int>(group);
    const unsigned mask = group_mask();
    const int beg = __ldg(ptr + r), end = __ldg(ptr + r + 1);
    const long long node = static_cast<long long>(r) * heads;

    for (int hb = 0; hb < heads; hb += HB) {
        float dst[HB], mx[HB], dd[HB], acc[HB];
        Heads<T, HB>::load(s_dst + node + hb, dst);
        Heads<T, HB>::load(m + node + hb, mx);
        if (dden != nullptr) {
            Heads<T, HB>::load(dden + node + hb, dd);
        } else {
#pragma unroll
            for (int i = 0; i < HB; ++i) dd[i] = -0.0f;
        }
#pragma unroll
        for (int i = 0; i < HB; ++i) acc[i] = 0.0f;
        for (int base = beg; base < end; base += kLanes) {
            const int cnt = min(kLanes, end - base);
            const int e = base + lane;
            float g[HB];
#pragma unroll
            for (int i = 0; i < HB; ++i) g[i] = 0.0f;
            if (lane < cnt) {
                if (__ldg(val + e) != 0.0f) {
                    float src[HB];
                    Heads<T, HB>::load(s_src + static_cast<long long>(__ldg(col + e)) * heads + hb,
                                       src);
#pragma unroll
                    for (int i = 0; i < HB; ++i) {
                        const float x = score_sum<T>(dst[i], src[i]);
                        const float w = weight<T>(leaky<T>(x, slope), mx[i]);
                        const float d = dp != nullptr ? __ldg(dp + (hb + i) * n_edges + e) : -0.0f;
                        const float gz = narrow<T>(__fmul_rn(narrow<T>(__fadd_rn(d, dd[i])), w));
                        g[i] = x > 0.0f ? gz : narrow<T>(__fmul_rn(gz, slope));
                    }
                }
                Heads<T, HB>::store(gl + static_cast<long long>(e) * heads + hb, g);
            }
            add_in_lane_order<HB>(acc, g, cnt, mask);
        }
        if (lane == 0) Heads<T, HB>::store(ds_dst + node + hb, acc);
    }
}

// Per source c: ds_src[c] = sum of gl[e, :] over the edges e of c in
// col_perm order (cptr [n_src+1] over col_perm), in float32, narrowed once.
template <typename T, int HB>
__global__ void __launch_bounds__(kThreads)
gat_softmax_src_grad_kernel(const int* __restrict__ cptr, const int* __restrict__ perm,
                            const T* __restrict__ gl, T* __restrict__ ds_src, int n_src,
                            int heads) {
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long group = t / kLanes;
    const int lane = static_cast<int>(t & (kLanes - 1));
    if (group >= n_src) return;
    const int c = static_cast<int>(group);
    const unsigned mask = group_mask();
    const int beg = __ldg(cptr + c), end = __ldg(cptr + c + 1);
    const long long node = static_cast<long long>(c) * heads;

    for (int hb = 0; hb < heads; hb += HB) {
        float acc[HB];
#pragma unroll
        for (int i = 0; i < HB; ++i) acc[i] = 0.0f;
        for (int base = beg; base < end; base += kLanes) {
            const int cnt = min(kLanes, end - base);
            float g[HB];
            if (lane < cnt) {
                const long long e = __ldg(perm + base + lane);
                Heads<T, HB>::load(gl + e * heads + hb, g);
            } else {
#pragma unroll
                for (int i = 0; i < HB; ++i) g[i] = 0.0f;
            }
            add_in_lane_order<HB>(acc, g, cnt, mask);
        }
        if (lane == 0) Heads<T, HB>::store(ds_src + node + hb, acc);
    }
}

// HB heads a walk: what the wrapper's plan (ops/gat_softmax_cuda.py:
// head_block) chose, checked here.
bool valid_plan(int heads, int dtype, int hb) {
    if (dtype != kFloat32 && dtype != kBFloat16) return false;
    const int itemsize = dtype == kFloat32 ? 4 : 2;
    if (hb != 1 && hb != 2 && hb != 4 && hb != 8) return false;
    return heads >= 1 && heads % hb == 0 && hb * itemsize <= 16;
}

unsigned blocks_for(long long rows) {
    return static_cast<unsigned>((rows * kLanes + kThreads - 1) / kThreads);
}

template <typename T, int HB>
struct Forward {
    template <typename... A>
    static void run(int mode, A... a) {
        if (mode == kBoth) {
            launch<kBoth>(a...);
        } else if (mode == kMaxOnly) {
            launch<kMaxOnly>(a...);
        } else {
            launch<kExpOnly>(a...);
        }
    }
    template <int MODE>
    static void launch(const void* ptr, const void* col, const void* val, const void* s_dst,
                       const void* s_src, const void* self_logit, void* m, void* p, void* denom,
                       void* p_self, int n_rows, int heads, long long n_edges, float slope,
                       cudaStream_t stream) {
        gat_softmax_kernel<T, HB, MODE><<<blocks_for(n_rows), kThreads, 0, stream>>>(
            static_cast<const int*>(ptr), static_cast<const int*>(col),
            static_cast<const float*>(val), static_cast<const T*>(s_dst),
            static_cast<const T*>(s_src), static_cast<const T*>(self_logit), static_cast<T*>(m),
            static_cast<float*>(p), static_cast<T*>(denom), static_cast<T*>(p_self), n_rows,
            heads, n_edges, slope);
    }
};

template <typename T, int HB>
struct Grad {
    static void run(const void* ptr, const void* col, const void* val, const void* s_dst,
                    const void* s_src, const void* m, const void* dp, const void* dden, void* gl,
                    void* ds_dst, int n_rows, int heads, long long n_edges, float slope,
                    cudaStream_t stream) {
        gat_softmax_grad_kernel<T, HB><<<blocks_for(n_rows), kThreads, 0, stream>>>(
            static_cast<const int*>(ptr), static_cast<const int*>(col),
            static_cast<const float*>(val), static_cast<const T*>(s_dst),
            static_cast<const T*>(s_src), static_cast<const T*>(m),
            static_cast<const float*>(dp), static_cast<const T*>(dden), static_cast<T*>(gl),
            static_cast<T*>(ds_dst), n_rows, heads, n_edges, slope);
    }
};

template <typename T, int HB>
struct SrcGrad {
    static void run(const void* cptr, const void* perm, const void* gl, void* ds_src, int n_src,
                    int heads, cudaStream_t stream) {
        gat_softmax_src_grad_kernel<T, HB><<<blocks_for(n_src), kThreads, 0, stream>>>(
            static_cast<const int*>(cptr), static_cast<const int*>(perm),
            static_cast<const T*>(gl), static_cast<T*>(ds_src), n_src, heads);
    }
};

// One instantiation a (dtype, heads a walk); float32 takes at most 4.
template <template <typename, int> class L, typename... A>
cudaError_t dispatch(int dtype, int hb, A... a) {
    if (dtype == kFloat32) {
        if (hb == 1) {
            L<float, 1>::run(a...);
        } else if (hb == 2) {
            L<float, 2>::run(a...);
        } else {
            L<float, 4>::run(a...);
        }
    } else if (hb == 1) {
        L<__nv_bfloat16, 1>::run(a...);
    } else if (hb == 2) {
        L<__nv_bfloat16, 2>::run(a...);
    } else if (hb == 4) {
        L<__nv_bfloat16, 4>::run(a...);
    } else {
        L<__nv_bfloat16, 8>::run(a...);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int gat_softmax_threads() { return kThreads; }
int gat_softmax_lanes() { return kLanes; }

// The forward on `stream`: ptr [n_rows+1], col and val [n_edges] (int32,
// float32); s_dst, self_logit, m, denom, p_self [n_rows, heads] and s_src
// [*, heads] in `dtype` (0 float32, 1 bfloat16); p [heads, n_edges]
// float32. `mode` 0 writes m, p, denom and p_self; 1 writes m alone; 2
// reads m and writes the rest. All contiguous on `device`, the [*, heads]
// tensors aligned to hb elements. Returns the launch's cudaError_t.
int gat_softmax_launch(const void* ptr, const void* col, const void* val, const void* s_dst,
                       const void* s_src, const void* self_logit, void* m, void* p, void* denom,
                       void* p_self, int n_rows, int heads, long long n_edges, float slope,
                       int dtype, int hb, int mode, void* stream, int device) {
    if (n_rows < 0 || n_edges < 0 || mode < kBoth || mode > kExpOnly ||
        !valid_plan(heads, dtype, hb))
        return cudaErrorInvalidValue;
    if (n_rows == 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return dispatch<Forward>(dtype, hb, mode, ptr, col, val, s_dst, s_src, self_logit, m, p,
                             denom, p_self, n_rows, heads, n_edges, slope,
                             static_cast<cudaStream_t>(stream));
}

// The destination side of the gradient: gl [n_edges, heads] and ds_dst
// [n_rows, heads] in `dtype` from dp [heads, n_edges] float32 and dden
// [n_rows, heads] (either may be null: no gradient reached it).
int gat_softmax_grad_launch(const void* ptr, const void* col, const void* val,
                            const void* s_dst, const void* s_src, const void* m, const void* dp,
                            const void* dden, void* gl, void* ds_dst, int n_rows, int heads,
                            long long n_edges, float slope, int dtype, int hb, void* stream,
                            int device) {
    if (n_rows < 0 || n_edges < 0 || !valid_plan(heads, dtype, hb)) return cudaErrorInvalidValue;
    if (n_rows == 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return dispatch<Grad>(dtype, hb, ptr, col, val, s_dst, s_src, m, dp, dden, gl, ds_dst,
                          n_rows, heads, n_edges, slope, static_cast<cudaStream_t>(stream));
}

// The source side: ds_src [n_src, heads] from gl over cptr [n_src+1] and
// perm [n_edges] int32 (col_perm).
int gat_softmax_src_grad_launch(const void* cptr, const void* perm, const void* gl,
                                void* ds_src, int n_src, int heads, int dtype, int hb,
                                void* stream, int device) {
    if (n_src < 0 || !valid_plan(heads, dtype, hb)) return cudaErrorInvalidValue;
    if (n_src == 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return dispatch<SrcGrad>(dtype, hb, cptr, perm, gl, ds_src, n_src, heads,
                             static_cast<cudaStream_t>(stream));
}

const char* gat_softmax_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
