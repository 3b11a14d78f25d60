// K-step Lanczos tridiagonalization with CGS2 reorthogonalization and the
// adjoint residuals for graphs too large for one block's shared memory
// (N > 128): the operator S streams from device memory once per step.
//
// Replaces the TPU kernel
// lanczosnet_tpu/ops/lanczos_pallas.py:_lanczos_stream_kernel (called from
// _lanczos_stream_call). It computes what that kernel computes, the same
// six outputs; its plain version is
// lanczosnet_torch/ops/lanczos.py:lanczos_tridiag_resid_stream, and the
// host wrapper is lanczosnet_torch/ops/lanczos_cuda.py:launch_stream.
//
// What bounds it on an H100. At the citation shape (B=1, N=2708, K=20) the
// function reads S (29.3 MB) once and writes 0.44 MB: 0.009 ms at
// 3.35 TB/s; it does K*2N^2 = 293 MFLOP of float32 work: 0.004 ms at
// 67 TFLOP/s. So bytes bound it. But step j+1 needs q_{j+1}, which needs
// all of S*q_j, so S is read K times (587 MB, 0.175 ms from device memory)
// unless it stays in the 50 MB L2 cache between steps. And the recursion
// has a latency floor of its own: a step is a sequence of dependent sums
// (the matvec, alpha, two CGS passes, beta^2), each a chain of 64 adds
// inside a chunk and then ceil(N/64) adds across the chunks, and each sum
// across chunks needs every chunk's partial, that is, the whole grid.
//
// What the design does about it: one persistent cooperative launch per
// call (all blocks co-resident, one block of 1024 threads per SM), with a
// grid-wide barrier between the phases of a step where the TPU kernel had
// a sequential grid. The order of summation names the unit of parallelism,
// the chunk of 64 consecutive node indices:
//   - Block c owns chunk c of a graph for the whole call. It keeps
//     w[chunk c] and its 64 columns of the basis Q, all K rows, in shared
//     memory. Every chunk partial of alpha, of a CGS coefficient p[r] and of
//     beta^2 is computed from shared memory by the block that owns the
//     chunk, so the ceil(N/64) chains of a sum run on as many SMs at once.
//     Only the partials cross the grid, through a scratch tensor; after the
//     barrier every owner adds them in chunk order for itself, so all hold
//     the same alpha, p[r] and beta bit for bit.
//   - Inside a chain the operands are loaded and the products formed ahead
//     of the adds (unrolled, independent), so a link costs one dependent
//     add and not a load, a multiply and an add.
//   - The matvec uses every block, owners or not: a team of 128 threads
//     takes one (column tile, row chunk) unit, a thread one column i, and
//     writes part[g, c, i] = sum_{r in chunk c} q_j[r] * S[r, i]. A warp
//     reads 128 consecutive bytes of a row of S per load. This is q^T S: it
//     reads S along rows and equals S q only for a symmetric S, the
//     assumption the TPU kernel makes for the same reason. The owner of
//     column chunk c then adds the partials of its 64 columns in chunk
//     order.
//   Phases of step j, each ended by a grid barrier (6 a step, 6K-1 a call):
//     A  all blocks: matvec partials of q_j;
//     B  owner: w from the partials; its partial of alpha;
//     C  alpha; the three-term update; partials of the pass-1 coefficients;
//     D  p1; w -= Q^T p1; partials of the pass-2 coefficients;
//     E  p2; w -= Q^T p2; w4 written; its partial of beta^2;
//     F  beta, the breakdown gate, q_{j+1} into shared memory and out.
//   Where a launch has more (graph, chunk) pairs than blocks, a block owns
//   several ("slots"); where even that does not fit shared memory, the
//   graphs go in groups of one launch each. The host picks grid, slots and
//   groups from the shape and the device (lanczos_cuda.py:plan_stream).
//   Data that another block wrote during the launch is read past L1
//   (__ldcg); S is only ever read and may take any path.
//
// Order of summation, shared with the plain version so that both break
// down at the same step (where beta is rounding noise near eps, two orders
// of summation part by O(1) in Q). Every product and sum is rounded on its
// own (__fmul_rn/__fadd_rn, never an FMA); sqrt and division are the
// correctly rounded ones. A sum over the node index (the matvec, alpha,
// the CGS coefficients, beta^2) is taken in chunks: kChunk = 64
// consecutive indices in index order starting from zero, then the chunk
// partials in chunk order starting from zero; the last chunk is short
// where N is not a multiple of 64 (the plain version pads with zeros and
// so does the owner's shared memory: adding +0 changes no sum). kChunk is
// the same for every N. A sum over basis rows (at most kMaxK = 64 terms)
// is taken in index order. Who walks a sum never changes this order.
//
// Points where it must not drift from the TPU kernel:
// - the carry quirk: the q_prev entering step j is q_j itself (zero at
//   j = 0, where beta_prev is zero too); written as
//   (w - alpha*q_j) - beta_prev*q_j, as the plain version rounds it;
// - breakdown: beta = sqrt(max(sum w^2, eps^2)), valid = beta > eps; the
//   kernel writes beta*valid and q_{j+1} = valid*w/beta only if j+1 < K;
//   w4 is w before normalization;
// - the CGS passes project against rows 0..j of Q only (the later rows are
//   zero and are skipped); p1/p2 are written as zero there.
//
// Build (lanczosnet_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// No --use_fast_math: it would change sqrtf, the division and denormals.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;        // chunk length of the order of summation
constexpr int kChunkShift = 6;    // log2(kChunk)
constexpr int kMaxN = 16384;
constexpr int kMaxK = 64;
constexpr int kTile = 128;        // columns per matvec unit; threads per team
constexpr int kLd = kChunk + 1;   // row stride of a block's slice of Q: odd, so
                                  // threads walking different rows hit different banks
constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a Hopper block may opt in to

static_assert((1 << kChunkShift) == kChunk, "kChunkShift is log2(kChunk)");
static_assert(kMaxK <= kChunk, "one thread per basis row fits the owner's 64 threads");

struct StreamArgs {
    const float* s;     // [b, n, n]
    float* q;           // [b, k, n], row 0 given
    float* part;        // [b, nchunk, n] matvec partials
    float* scratch;     // [b, 2 + 2k, nchunk] chunk partials: alpha, beta^2, pass 1, pass 2
    float* alpha;       // [b, k]
    float* beta;        // [b, k]
    float* p1;          // [b, k, k]
    float* p2;          // [b, k, k]
    float* w4;          // [b, k, n]
    int b, n, k, nchunk, ntile, slots;
    float eps, eps_sq;
};

// Floats of dynamic shared memory of one block; lanczos_cuda.py mirrors it.
__host__ __device__ inline size_t smem_floats(int n, int k, int slots, int threads) {
    const int nchunk = (n + kChunk - 1) / kChunk;
    const size_t stage_t = static_cast<size_t>(k) * (nchunk | 1);
    const size_t stage_w = static_cast<size_t>(nchunk < kChunk ? nchunk : kChunk) * kChunk;
    return static_cast<size_t>(slots) * (static_cast<size_t>(k) * kLd + kChunk + 1) + k +
           static_cast<size_t>(threads / kTile) * kChunk + (stage_t > stage_w ? stage_t : stage_w);
}

// The grid-wide barrier between two phases: cooperative_groups' own, which
// needs no state of the caller's (so two calls at once share nothing) and
// orders every block's writes before every block's later reads. Measured
// against a hand-written arrival counter in device memory it was the
// faster one on every grid tried on an H100 (chip_smoke.py prints what one
// costs).
__device__ __forceinline__ void grid_sync() { cg::this_grid().sync(); }

// sum_{t<64} a[t]*b[t] in index order from shared memory: the products are
// formed ahead, 16 at a time, so the dependent path is the adds alone.
__device__ __forceinline__ float dot_chunk(const float* a, const float* b) {
    float acc = 0.f;
#pragma unroll
    for (int t0 = 0; t0 < kChunk; t0 += 16) {
        float pr[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) pr[u] = __fmul_rn(a[t0 + u], b[t0 + u]);
#pragma unroll
        for (int u = 0; u < 16; ++u) acc = __fadd_rn(acc, pr[u]);
    }
    return acc;
}

// sum_{c<count} x[c] in index order from shared memory.
__device__ __forceinline__ float chain_sum(const float* x, int count) {
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < count; ++c) acc = __fadd_rn(acc, x[c]);
    return acc;
}

// One (graph, chunk) pair a block owns, and where the block keeps it.
struct Owned {
    int g, c, lo;   // graph, chunk, first node index of the chunk
    float* Q;       // [k][kLd] the chunk's columns of the basis, in shared memory
    float* W;       // [kChunk] the chunk of the work vector, in shared memory
    float* sg;      // [2 + 2k][nchunk] the graph's chunk partials, in device memory
};

// Slot sl of this block: pair sl * gridDim.x + blockIdx.x.
__device__ __forceinline__ Owned owned_pair(const StreamArgs& a, float* QS, float* WS, int sl) {
    const int p = sl * static_cast<int>(gridDim.x) + static_cast<int>(blockIdx.x);
    Owned o;
    o.g = p / a.nchunk;
    o.c = p - o.g * a.nchunk;
    o.lo = o.c * kChunk;
    o.Q = QS + static_cast<size_t>(sl) * a.k * kLd;
    o.W = WS + sl * kChunk;
    o.sg = a.scratch + static_cast<size_t>(o.g) * (2 + 2 * a.k) * a.nchunk;
    return o;
}

// Phase A: every team of kTile threads takes (graph, row chunk, column
// tile) units in turn. QV holds each team's chunk of q_j.
__device__ __forceinline__ void matvec_phase(const StreamArgs& a, int j, float* QV) {
    const int n = a.n;
    const int team = threadIdx.x / kTile;
    const int lane = threadIdx.x - team * kTile;
    const int teams = blockDim.x / kTile;
    const long long units = static_cast<long long>(a.b) * a.nchunk * a.ntile;
    const long long stride = static_cast<long long>(gridDim.x) * teams;
    float* qv = QV + team * kChunk;
    for (long long base = static_cast<long long>(blockIdx.x) * teams; base < units; base += stride) {
        const long long u = base + team;
        const bool active = u < units;
        int g = 0, c = 0, tile = 0;
        if (active) {
            tile = static_cast<int>(u % a.ntile);
            const long long gc = u / a.ntile;
            c = static_cast<int>(gc % a.nchunk);
            g = static_cast<int>(gc / a.nchunk);
        }
        const int lo = c * kChunk;
        const int rows = min(kChunk, n - lo);
        __syncthreads();  // the previous unit's readers of qv are done
        if (active && lane < kChunk) {
            qv[lane] = lane < rows
                ? __ldcg(a.q + (static_cast<size_t>(g) * a.k + j) * n + lo + lane) : 0.f;
        }
        __syncthreads();
        const int i = tile * kTile + lane;
        if (active && i < n) {
            const float* col = a.s + (static_cast<size_t>(g) * n + lo) * n + i;
            float acc = 0.f;
            if (rows == kChunk) {
#pragma unroll 16
                for (int t = 0; t < kChunk; ++t) {
                    acc = __fadd_rn(acc, __fmul_rn(qv[t], __ldg(col + static_cast<size_t>(t) * n)));
                }
            } else {
                for (int t = 0; t < rows; ++t) {
                    acc = __fadd_rn(acc, __fmul_rn(qv[t], __ldg(col + static_cast<size_t>(t) * n)));
                }
            }
            __stcg(a.part + (static_cast<size_t>(g) * a.nchunk + c) * n + i, acc);
        }
    }
}

__global__ void __launch_bounds__(kMaxThreads) lanczos_stream_kernel(const StreamArgs a) {
    extern __shared__ float smem[];
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int n = a.n, k = a.k, nchunk = a.nchunk;
    float* QS = smem;                                         // [slots][k][kLd] columns of Q
    float* WS = QS + static_cast<size_t>(a.slots) * k * kLd;  // [slots][kChunk] the work vector
    float* BP = WS + a.slots * kChunk;                        // [slots] beta of the previous step
    float* P = BP + a.slots;                                  // [k] coefficients of a pass
    float* QV = P + k;                                        // [teams][kChunk] the matvec's q_j
    float* U = QV + (nt / kTile) * kChunk;                    // staging for what crosses the grid

    // (graph, chunk) pairs this block owns: pair sl * gridDim.x + blockIdx.x
    const int npairs = a.b * nchunk;
    const int bid = static_cast<int>(blockIdx.x);
    const int nown = npairs > bid
        ? min(a.slots, (npairs - bid - 1) / static_cast<int>(gridDim.x) + 1) : 0;

    for (int sl = 0; sl < nown; ++sl) {
        const Owned o = owned_pair(a, QS, WS, sl);
        if (tid < kChunk) {
            o.Q[tid] = o.lo + tid < n ? a.q[static_cast<size_t>(o.g) * k * n + o.lo + tid] : 0.f;
        }
        if (tid == 0) BP[sl] = 0.f;
    }
    __syncthreads();

    for (int j = 0; j < k; ++j) {
        const int rows = j + 1;  // rows of Q written so far; the rest are zero

        matvec_phase(a, j, QV);
        grid_sync();

        // B: w = q_j^T S from the matvec partials in chunk order; alpha's partial
        for (int sl = 0; sl < nown; ++sl) {
            const Owned o = owned_pair(a, QS, WS, sl);
            const float* pg = a.part + static_cast<size_t>(o.g) * nchunk * n + o.lo;
            float acc = 0.f;
            for (int r0 = 0; r0 < nchunk; r0 += kChunk) {
                const int rt = min(kChunk, nchunk - r0);
                __syncthreads();  // U is free
                for (int e = tid; e < rt * kChunk; e += nt) {
                    const int rr = e >> kChunkShift;
                    const int ii = e & (kChunk - 1);
                    U[e] = o.lo + ii < n ? __ldcg(pg + static_cast<size_t>(r0 + rr) * n + ii) : 0.f;
                }
                __syncthreads();
                if (tid < kChunk) {
#pragma unroll 8
                    for (int rr = 0; rr < rt; ++rr) acc = __fadd_rn(acc, U[rr * kChunk + tid]);
                }
            }
            if (tid < kChunk) o.W[tid] = acc;
            __syncthreads();
            if (tid == 0) __stcg(o.sg + o.c, dot_chunk(o.Q + j * kLd, o.W));
        }
        grid_sync();

        // C: alpha, the three-term update, partials of the pass-1 coefficients
        for (int sl = 0; sl < nown; ++sl) {
            const Owned o = owned_pair(a, QS, WS, sl);
            __syncthreads();
            for (int e = tid; e < nchunk; e += nt) U[e] = __ldcg(o.sg + e);
            __syncthreads();
            if (tid < kChunk) {
                const float alpha = chain_sum(U, nchunk);
                const float qi = o.Q[j * kLd + tid];
                const float q_prev = j == 0 ? 0.f : qi;  // carry quirk: q_prev is q_j
                o.W[tid] = __fsub_rn(__fsub_rn(o.W[tid], __fmul_rn(alpha, qi)),
                                     __fmul_rn(BP[sl], q_prev));
                if (tid == 0 && o.c == 0) a.alpha[static_cast<size_t>(o.g) * k + j] = alpha;
            }
            __syncthreads();
            if (tid < rows) {
                __stcg(o.sg + static_cast<size_t>(2 + tid) * nchunk + o.c,
                       dot_chunk(o.Q + tid * kLd, o.W));
            }
        }
        grid_sync();

        // D and E: the coefficients of a pass from their partials, the
        // subtraction, then the next sum's partials
        for (int pass = 0; pass < 2; ++pass) {
            float* p_out = pass == 0 ? a.p1 : a.p2;
            for (int sl = 0; sl < nown; ++sl) {
                const Owned o = owned_pair(a, QS, WS, sl);
                const float* T = o.sg + static_cast<size_t>(2 + pass * k) * nchunk;
                const int ldu = nchunk | 1;
                const size_t step = static_cast<size_t>(o.g) * k + j;
                __syncthreads();
                for (int e = tid; e < rows * nchunk; e += nt) {
                    const int r = e / nchunk;
                    U[r * ldu + (e - r * nchunk)] = __ldcg(T + e);
                }
                __syncthreads();
                if (tid < k) {
                    const float coef = tid < rows ? chain_sum(U + tid * ldu, nchunk) : 0.f;
                    P[tid] = coef;
                    if (o.c == 0) p_out[step * k + tid] = coef;
                }
                __syncthreads();
                if (tid < kChunk) {
                    float acc = 0.f;
#pragma unroll 4
                    for (int r = 0; r < rows; ++r) {
                        acc = __fadd_rn(acc, __fmul_rn(o.Q[r * kLd + tid], P[r]));
                    }
                    o.W[tid] = __fsub_rn(o.W[tid], acc);
                }
                __syncthreads();
                if (pass == 0) {
                    if (tid < rows) {
                        __stcg(o.sg + static_cast<size_t>(2 + k + tid) * nchunk + o.c,
                               dot_chunk(o.Q + tid * kLd, o.W));
                    }
                } else {
                    if (tid < kChunk && o.lo + tid < n) a.w4[step * n + o.lo + tid] = o.W[tid];
                    if (tid == 0) __stcg(o.sg + nchunk + o.c, dot_chunk(o.W, o.W));
                }
            }
            grid_sync();
        }

        // F: beta, the breakdown gate, q_{j+1}
        for (int sl = 0; sl < nown; ++sl) {
            const Owned o = owned_pair(a, QS, WS, sl);
            __syncthreads();
            for (int e = tid; e < nchunk; e += nt) U[e] = __ldcg(o.sg + nchunk + e);
            __syncthreads();
            if (tid < kChunk) {
                const float beta = __fsqrt_rn(fmaxf(chain_sum(U, nchunk), a.eps_sq));
                const bool valid = beta > a.eps;
                if (j + 1 < k) {
                    const float qn = valid ? __fdiv_rn(o.W[tid], beta) : 0.f;
                    o.Q[(j + 1) * kLd + tid] = qn;
                    if (o.lo + tid < n) {
                        __stcg(a.q + (static_cast<size_t>(o.g) * k + j + 1) * n + o.lo + tid, qn);
                    }
                }
                if (tid == 0) {
                    BP[sl] = valid ? beta : 0.f;
                    if (o.c == 0) a.beta[static_cast<size_t>(o.g) * k + j] = valid ? beta : 0.f;
                }
            }
        }
        if (j + 1 < k) grid_sync();
    }
}

// `count` barriers and nothing else: what a barrier costs on this grid.
__global__ void __launch_bounds__(kMaxThreads) barrier_probe_kernel(int count) {
    for (int i = 0; i < count; ++i) grid_sync();
}

}  // namespace

extern "C" {

int lanczos_stream_chunk() { return kChunk; }
int lanczos_stream_max_n() { return kMaxN; }
int lanczos_stream_max_k() { return kMaxK; }
int lanczos_stream_tile() { return kTile; }
int lanczos_stream_smem_limit() { return kSmemLimit; }

// Bytes of dynamic shared memory a block of `threads` needs to own `slots`
// (graph, chunk) pairs.
long long lanczos_stream_smem_bytes(int n, int k, int slots, int threads) {
    return static_cast<long long>(sizeof(float) * smem_floats(n, k, slots, threads));
}

// Prepare `device` for the kernel and describe it: its SM count and how
// many blocks of `threads` with `smem` bytes of dynamic shared memory one
// SM holds at once. The kernel's dynamic shared memory is opened to
// kSmemLimit here, the same value whatever the shape: the attribute
// belongs to the function, not to a launch, so calls of different shapes
// from different host threads cannot undo each other's. The host calls
// this once per shape and device before the first launch there
// (lanczos_cuda.py:stream_plan). Returns a cudaError_t.
int lanczos_stream_occupancy(int threads, long long smem, int device,
                             int* sm_count, int* blocks_per_sm) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(lanczos_stream_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, lanczos_stream_kernel, threads, static_cast<size_t>(smem));
}

// One cooperative launch on `stream` that runs all k steps for b graphs:
// s [b,n,n]; q [b,k,n] with row 0 of each graph holding the start vector
// (the other rows are written here); part [b, ceil(n/64), n] and scratch
// [b, 2+2k, ceil(n/64)] scratch; -> alpha, beta [b,k], p1, p2 [b,k,k],
// w4 [b,k,n]; all float32, contiguous, on `device`. eps_sq is eps*eps
// rounded to float as the plain version rounds it. `grid` blocks of
// `threads`, each owning up to `slots` (graph, chunk) pairs, as
// lanczos_cuda.py:plan_stream lays them out. Returns the cudaError_t of
// the launch (0 on success); the runtime refuses a grid that is not
// co-resident, and nothing here shrinks it.
int lanczos_stream_launch(const void* s, void* q, void* part, void* scratch,
                          void* alpha, void* beta, void* p1, void* p2, void* w4,
                          int b, int n, int k, float eps, float eps_sq,
                          int grid, int threads, int slots, void* stream, int device) {
    if (b < 1 || n < 1 || n > kMaxN || k < 1 || k > kMaxK || k > n ||
        threads < kTile || threads > kMaxThreads || threads % kTile != 0 ||
        grid < 1 || slots < 1) {
        return cudaErrorInvalidValue;
    }
    const int nchunk = (n + kChunk - 1) / kChunk;
    if (static_cast<long long>(grid) * slots < static_cast<long long>(b) * nchunk) {
        return cudaErrorInvalidValue;
    }
    const size_t smem = sizeof(float) * smem_floats(n, k, slots, threads);
    if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    StreamArgs a;
    a.s = static_cast<const float*>(s);
    a.q = static_cast<float*>(q);
    a.part = static_cast<float*>(part);
    a.scratch = static_cast<float*>(scratch);
    a.alpha = static_cast<float*>(alpha);
    a.beta = static_cast<float*>(beta);
    a.p1 = static_cast<float*>(p1);
    a.p2 = static_cast<float*>(p2);
    a.w4 = static_cast<float*>(w4);
    a.b = b;
    a.n = n;
    a.k = k;
    a.nchunk = nchunk;
    a.ntile = (n + kTile - 1) / kTile;
    a.slots = slots;
    a.eps = eps;
    a.eps_sq = eps_sq;
    void* args[] = {&a};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lanczos_stream_kernel),
                                       dim3(grid), dim3(threads), args, smem,
                                       static_cast<cudaStream_t>(stream));
}

// One cooperative launch of `grid` blocks of `threads` that does `count`
// grid barriers and nothing else. Returns a cudaError_t.
int lanczos_stream_barrier_probe(int grid, int threads, int count, void* stream, int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    void* args[] = {&count};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(barrier_probe_kernel),
                                       dim3(grid), dim3(threads), args, 0,
                                       static_cast<cudaStream_t>(stream));
}

const char* lanczos_stream_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
