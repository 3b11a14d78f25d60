// The sparse product out = S x in CSR form, destination-major, with its
// transpose for the backward and the gradient of the edge weights.
//
// Replaces no TPU kernel: the JAX package's sparse product
// (lanczosnet_tpu/ops/sparse.py:spmv) is XLA's take and segment_sum, which
// fuse on the TPU. The port ran it as ATen's index_select, an elementwise
// scale, a widening cast, a zero fill and float32 index_add atomics, each
// through an [E, F] tensor in device memory. This file does the product in
// one pass; the host wrapper is lanczosnet_torch/ops/sparse_cuda.py, and
// the plain version it is held to is ops/sparse.py:_spmv_plain.
//
// What bounds it on an H100. The product reads each edge's source row once
// (at 10M nodes, 25M edges and F=32 bfloat16: 25M rows of 64 bytes, 1.6 GB,
// from random addresses in a 640 MB table that the 50 MB L2 cannot hold),
// the edges once (row_ptr, col and val: 0.24 GB) and writes the output
// once (0.64 GB): about 2.5 GB, 0.74 ms at 3.35 TB/s. Its arithmetic is
// one multiply and one add an element of a gathered row, far below the
// card's rate. It is bound by the gathered rows' bytes, and by keeping
// enough of those loads in flight. (The function's compulsory bytes, each
// source row once, are 1.5 GB, 0.45 ms: a table that L2 cannot hold, read
// at uniform random edges, reuses almost none of its rows from L2.)
//
// What the design does about it. A group of `lanes` threads owns one
// destination row (or one tile of a row too wide for a group): each lane
// holds one 16-byte vector of the row (4 lanes at 64 bytes, 32 at 512),
// so the group reads a gathered row with whole 16-byte loads and writes
// the output row once. The group loads the col and val of up to `lanes`
// edges in one coalesced load and hands them round by shuffle; the edge
// loop is unrolled kUnroll times, all loads first, so each lane has that
// many independent row loads in flight; a loaded row stays packed (a
// bfloat16 vector in 4 registers, not 8) until it is added, so more warps
// fit an SM. Groups are packed many to a warp (8 rows a warp at 64 bytes)
// and blocks are small, 64 threads: rows' degrees differ, and a small
// block retires as soon as its own rows are done, so the SMs stay full
// (32 blocks, 2048 threads an SM). Measured on the H100 at 10M nodes,
// 25M edges and F=32: 1.41 ms a product so, 1.94 ms with 256-thread
// blocks and rows widened on load; 32 threads leave half an SM's threads
// idle, and forcing full occupancy by __launch_bounds__ spills. The sums
// stay in float32 registers: there are no atomics, no zero fill, no
// [E, F] tensor and no float32 [N, F] tensor. A row whose width is not a
// multiple of 16 bytes ([N] vectors, odd widths) takes the same kernel
// one element a lane.
//
// Order of arithmetic, as the plain version does it. Each edge's message
// is the weight cast to x's dtype times x's element, taken in float32
// (exact for bfloat16 operands) and rounded to x's dtype, as ATen's
// 16-bit multiply rounds it; float32 rounds the product once. Messages are
// added to a float32 sum that starts at +0, in edge order, and the sum is
// rounded to x's dtype once. __fmul_rn/__fadd_rn keep nvcc from
// contracting a product and a sum into an FMA the plain version lacks. The
// plain version on the CPU adds in edge order too (index_add), so the two
// agree bit for bit; the card's atomics added in an order that changed
// from run to run.
//
// The backward to x is this kernel over the source-major view (col_ptr,
// row[col_perm], val[col_perm]): each source's edges in col_perm order,
// the order of the plain version's sorted scatter. The gradient of the
// weights, dval_e = sum_f g[row_e, f] * x[col_e, f], is spmm_sddmm_kernel:
// a group per destination row holds g's row (tile) in registers, reads
// each edge's source row, and reduces over its lanes by shuffle; the sum
// is rounded to x's dtype, as the gradient of the weights' cast is.
//
// Build (lanczosnet_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 64;   // threads of a block
constexpr int kUnroll = 4;     // gathered rows a lane has in flight
constexpr int kMaxLanes = 32;  // a group lies inside one warp

enum Dtype : int { kFloat32 = 0, kBFloat16 = 1 };

// How a value of the working dtype is read, rounded and written.
template <typename T>
struct Elt;

template <>
struct Elt<float> {
    static constexpr int kVec = 4;  // elements in 16 bytes
    __device__ __forceinline__ static float narrow(float v) { return v; }
    __device__ __forceinline__ static float load1(const float* p) { return __ldg(p); }
    __device__ __forceinline__ static void store1(float* p, float v) { *p = v; }
    __device__ __forceinline__ static void unpack(uint4 raw, float (&out)[4]) {
        out[0] = __uint_as_float(raw.x);
        out[1] = __uint_as_float(raw.y);
        out[2] = __uint_as_float(raw.z);
        out[3] = __uint_as_float(raw.w);
    }
    __device__ __forceinline__ static uint4 pack(const float (&v)[4]) {
        return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                          __float_as_uint(v[3]));
    }
};

template <>
struct Elt<__nv_bfloat16> {
    static constexpr int kVec = 8;
    // float -> bfloat16 (round to nearest even, as ATen's cast) -> float
    __device__ __forceinline__ static float narrow(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
    __device__ __forceinline__ static float load1(const __nv_bfloat16* p) {
        return __bfloat162float(__ldg(p));
    }
    __device__ __forceinline__ static void store1(__nv_bfloat16* p, float v) {
        *p = __float2bfloat16_rn(v);
    }
    __device__ __forceinline__ static void unpack(uint4 raw, float (&out)[8]) {
        const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            out[2 * i] = __uint_as_float(w[i] << 16);
            out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
    __device__ __forceinline__ static unsigned pack2(float a, float b) {
        return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
               (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
    }
    __device__ __forceinline__ static uint4 pack(const float (&v)[8]) {
        return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                          pack2(v[6], v[7]));
    }
};

// W elements of a row as loaded (W = 1: the element widened; else the
// 16-byte vector as it lies, widened only when used, so a bfloat16 row in
// flight takes 4 registers and not 8).
template <typename T, int W>
using Raw = std::conditional_t<W == 1, float, uint4>;

template <typename T, int W>
__device__ __forceinline__ Raw<T, W> load_raw(const T* p) {
    if constexpr (W == 1) {
        return Elt<T>::load1(p);
    } else {
        return __ldg(reinterpret_cast<const uint4*>(p));
    }
}

template <typename T, int W>
__device__ __forceinline__ void widen(const Raw<T, W>& raw, float (&out)[W]) {
    if constexpr (W == 1) {
        out[0] = raw;
    } else {
        Elt<T>::unpack(raw, out);
    }
}

template <typename T, int W>
__device__ __forceinline__ void load_chunk(const T* p, float (&out)[W]) {
    widen<T, W>(load_raw<T, W>(p), out);
}

template <typename T, int W>
__device__ __forceinline__ void store_chunk(T* p, const float (&v)[W]) {
    if constexpr (W == 1) {
        Elt<T>::store1(p, v[0]);
    } else {
        *reinterpret_cast<uint4*>(p) = Elt<T>::pack(v);
    }
}

// The lanes of this thread's group within its warp.
__device__ __forceinline__ unsigned group_mask(int lanes) {
    if (lanes == kMaxLanes) return 0xffffffffu;
    const int first = (threadIdx.x & 31) & ~(lanes - 1);
    return ((1u << lanes) - 1u) << first;
}

// acc += narrow(w * x) for the chunks this lane holds (first + v * stride),
// in the order the plain version rounds: the product in float32, rounded to
// T, added in float32.
template <typename T, int W, int VPL>
__device__ __forceinline__ void accumulate(float (&acc)[VPL][W], float w,
                                           const Raw<T, W> (&xv)[VPL], int first, int stride,
                                           int chunks) {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
        if (first + v * stride < chunks) {
            float xf[W];
            widen<T, W>(xv[v], xf);
#pragma unroll
            for (int i = 0; i < W; ++i)
                acc[v][i] = __fadd_rn(acc[v][i], Elt<T>::narrow(__fmul_rn(w, xf[i])));
        }
    }
}

// out[r, :] = sum over e in [ptr[r], ptr[r+1]) of narrow(narrow(val[e]) * x[idx[e], :]),
// in edge order. A group of `lanes` threads takes one (row, tile); a tile
// is lanes * VPL chunks of W elements; `tiles` tiles cover a row of f.
template <typename T, int W, int VPL>
__global__ void __launch_bounds__(kThreads)
spmm_csr_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
                const float* __restrict__ val, const T* __restrict__ x, T* __restrict__ out,
                int n_out, int f, int lanes, int tiles) {
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long group = t / lanes;
    const int lane = static_cast<int>(t & (lanes - 1));
    if (group >= static_cast<long long>(n_out) * tiles) return;  // whole groups leave
    const int r = static_cast<int>(group / tiles);
    const int tile = static_cast<int>(group - static_cast<long long>(r) * tiles);
    const int chunks = f / W;
    const int first = tile * lanes * VPL + lane;
    const unsigned mask = group_mask(lanes);

    float acc[VPL][W];
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
        for (int i = 0; i < W; ++i) acc[v][i] = 0.0f;

    const int beg = __ldg(ptr + r), end = __ldg(ptr + r + 1);
    if (lanes == 1) {
        // one lane a row: it reads its own edges, kUnroll rows in flight
        for (int e0 = beg; e0 < end; e0 += kUnroll) {
            Raw<T, W> xv[kUnroll][VPL];
            float w[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                if (e0 + u < end) {
                    const T* row = x + static_cast<long long>(__ldg(idx + e0 + u)) * f;
                    w[u] = Elt<T>::narrow(__ldg(val + e0 + u));
#pragma unroll
                    for (int v = 0; v < VPL; ++v) {
                        const int ch = first + v;
                        if (ch < chunks) xv[u][v] = load_raw<T, W>(row + ch * W);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                if (e0 + u < end) accumulate<T, W, VPL>(acc, w[u], xv[u], first, 1, chunks);
            }
        }
    } else {
        for (int base = beg; base < end; base += lanes) {
            const int cnt = min(lanes, end - base);
            int my_col = 0;
            float my_w = 0.0f;
            if (lane < cnt) {
                my_col = __ldg(idx + base + lane);
                my_w = Elt<T>::narrow(__ldg(val + base + lane));
            }
            for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
                Raw<T, W> xv[kUnroll][VPL];
                float w[kUnroll];
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const int c = __shfl_sync(mask, my_col, j0 + u, lanes);
                    w[u] = __shfl_sync(mask, my_w, j0 + u, lanes);
                    if (j0 + u < cnt) {
                        const T* row = x + static_cast<long long>(c) * f;
#pragma unroll
                        for (int v = 0; v < VPL; ++v) {
                            const int ch = first + v * lanes;
                            if (ch < chunks) xv[u][v] = load_raw<T, W>(row + ch * W);
                        }
                    }
                }
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    if (j0 + u < cnt) accumulate<T, W, VPL>(acc, w[u], xv[u], first, lanes, chunks);
                }
            }
        }
    }
    T* orow = out + static_cast<long long>(r) * f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
        const int ch = first + v * lanes;
        if (ch < chunks) store_chunk<T, W>(orow + ch * W, acc[v]);
    }
}

// dval[e] = narrow(sum_f g[r, f] * x[idx[e], f]) for every edge e of row r.
// A group of `lanes` threads takes one row and walks its tiles in turn,
// holding g's tile in registers; each edge's partial dot products are
// summed over the group by shuffle, and across tiles in dval itself.
template <typename T, int W, int VPL>
__global__ void __launch_bounds__(kThreads)
spmm_sddmm_kernel(const int* __restrict__ ptr, const int* __restrict__ idx,
                  const T* __restrict__ g, const T* __restrict__ x, float* __restrict__ dval,
                  int n_rows, int f, int lanes, int tiles) {
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long group = t / lanes;
    const int lane = static_cast<int>(t & (lanes - 1));
    if (group >= n_rows) return;
    const int r = static_cast<int>(group);
    const int chunks = f / W;
    const unsigned mask = group_mask(lanes);
    const int beg = __ldg(ptr + r), end = __ldg(ptr + r + 1);
    if (beg == end) return;
    const T* grow = g + static_cast<long long>(r) * f;

    for (int tile = 0; tile < tiles; ++tile) {
        const int first = tile * lanes * VPL + lane;
        float gv[VPL][W];
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
            const int ch = first + v * lanes;
            if (ch < chunks) {
                load_chunk<T, W>(grow + ch * W, gv[v]);
            } else {
#pragma unroll
                for (int i = 0; i < W; ++i) gv[v][i] = 0.0f;
            }
        }
        for (int base = beg; base < end; base += lanes) {
            const int cnt = min(lanes, end - base);
            const int my_col = lane < cnt ? __ldg(idx + base + lane) : 0;
            for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
                Raw<T, W> xv[kUnroll][VPL];
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const int c = __shfl_sync(mask, my_col, j0 + u, lanes);
                    const T* row = x + static_cast<long long>(c) * f;
#pragma unroll
                    for (int v = 0; v < VPL; ++v) {
                        const int ch = first + v * lanes;
                        if (j0 + u < cnt && ch < chunks) xv[u][v] = load_raw<T, W>(row + ch * W);
                    }
                }
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    float p = 0.0f;
#pragma unroll
                    for (int v = 0; v < VPL; ++v) {
                        if (j0 + u < cnt && first + v * lanes < chunks) {
                            float xf[W];
                            widen<T, W>(xv[u][v], xf);
#pragma unroll
                            for (int i = 0; i < W; ++i) p = __fmaf_rn(gv[v][i], xf[i], p);
                        }
                    }
                    for (int o = lanes >> 1; o > 0; o >>= 1)
                        p = __fadd_rn(p, __shfl_xor_sync(mask, p, o, lanes));
                    const int e = base + j0 + u;
                    if (lane == 0 && j0 + u < cnt) {
                        const float s = tile == 0 ? p : __fadd_rn(dval[e], p);
                        dval[e] = tile == tiles - 1 ? Elt<T>::narrow(s) : s;
                    }
                }
            }
        }
    }
}

// The shape of a launch: a group of `lanes` threads a row (tile), tiles of
// lanes * vpl chunks of `width` elements; the wrapper's plan (ops/sparse_cuda.py:
// spmm_plan) chose them, and this checks them.
bool valid_plan(int f, int dtype, int width, int lanes, int vpl, int tiles) {
    const int vec = dtype == kFloat32 ? Elt<float>::kVec : Elt<__nv_bfloat16>::kVec;
    if (dtype != kFloat32 && dtype != kBFloat16) return false;
    if (f < 1 || (width != 1 && width != vec) || f % width != 0) return false;
    if (lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1)) != 0) return false;
    if (vpl != 1 && vpl != 2 && vpl != 4) return false;
    const int chunks = f / width;
    const long long per_tile = static_cast<long long>(lanes) * vpl;
    return tiles == (chunks + per_tile - 1) / per_tile;
}

unsigned blocks_for(long long threads) {
    return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename T, int W, int VPL>
void launch_spmm(const void* ptr, const void* idx, const void* val, const void* x, void* out,
                 int n_out, int f, int lanes, int tiles, cudaStream_t stream) {
    const long long threads = static_cast<long long>(n_out) * tiles * lanes;
    spmm_csr_kernel<T, W, VPL><<<blocks_for(threads), kThreads, 0, stream>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(idx),
        static_cast<const float*>(val), static_cast<const T*>(x), static_cast<T*>(out), n_out,
        f, lanes, tiles);
}

template <typename T, int W, int VPL>
void launch_sddmm(const void* ptr, const void* idx, const void* g, const void* x, void* dval,
                  int n_rows, int f, int lanes, int tiles, cudaStream_t stream) {
    const long long threads = static_cast<long long>(n_rows) * lanes;
    spmm_sddmm_kernel<T, W, VPL><<<blocks_for(threads), kThreads, 0, stream>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(idx), static_cast<const T*>(g),
        static_cast<const T*>(x), static_cast<float*>(dval), n_rows, f, lanes, tiles);
}

template <typename T, int W, int VPL>
struct SpmmLaunch {
    template <typename... A>
    static void run(A... a) { launch_spmm<T, W, VPL>(a...); }
};

template <typename T, int W, int VPL>
struct SddmmLaunch {
    template <typename... A>
    static void run(A... a) { launch_sddmm<T, W, VPL>(a...); }
};

template <template <typename, int, int> class L, typename T, int W, typename... A>
void by_vpl(int vpl, A... a) {
    if (vpl == 1) {
        L<T, W, 1>::run(a...);
    } else if (vpl == 2) {
        L<T, W, 2>::run(a...);
    } else {
        L<T, W, 4>::run(a...);
    }
}

// One instantiation a (dtype, vector or scalar form, vpl).
template <template <typename, int, int> class L, typename... A>
cudaError_t dispatch(int dtype, int width, int vpl, A... a) {
    if (dtype == kFloat32) {
        if (width == 1) {
            by_vpl<L, float, 1>(vpl, a...);
        } else {
            by_vpl<L, float, Elt<float>::kVec>(vpl, a...);
        }
    } else if (width == 1) {
        by_vpl<L, __nv_bfloat16, 1>(vpl, a...);
    } else {
        by_vpl<L, __nv_bfloat16, Elt<__nv_bfloat16>::kVec>(vpl, a...);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int spmm_csr_threads() { return kThreads; }
int spmm_csr_unroll() { return kUnroll; }

// out [n_out, f] = S x on `stream`: ptr [n_out+1], idx [E] int32, val [E]
// float32, x [*, f] and out in `dtype` (0 float32, 1 bfloat16), all
// contiguous on `device`; x and out 16-byte aligned where width > 1.
// Returns the cudaError_t of the launch (0 on success).
int spmm_csr_launch(const void* ptr, const void* idx, const void* val, const void* x, void* out,
                    int n_out, int f, int dtype, int width, int lanes, int vpl, int tiles,
                    void* stream, int device) {
    if (n_out < 0 || !valid_plan(f, dtype, width, lanes, vpl, tiles)) return cudaErrorInvalidValue;
    if (n_out == 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return dispatch<SpmmLaunch>(dtype, width, vpl, ptr, idx, val, x, out, n_out, f, lanes, tiles,
                                static_cast<cudaStream_t>(stream));
}

// dval [E] float32: for each edge e of row r (ptr [n_rows+1], idx [E]),
// narrow(sum_f g[r, f] * x[idx[e], f]); g [n_rows, f] and x [*, f] in `dtype`.
int spmm_sddmm_launch(const void* ptr, const void* idx, const void* g, const void* x, void* dval,
                      int n_rows, int f, int dtype, int width, int lanes, int vpl, int tiles,
                      void* stream, int device) {
    if (n_rows < 0 || !valid_plan(f, dtype, width, lanes, vpl, tiles))
        return cudaErrorInvalidValue;
    if (n_rows == 0) return cudaSuccess;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    return dispatch<SddmmLaunch>(dtype, width, vpl, ptr, idx, g, x, dval, n_rows, f, lanes,
                                 tiles, static_cast<cudaStream_t>(stream));
}

const char* spmm_csr_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
