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
// unless it stays in the 50 MB L2 cache between steps; and each step ends
// in a chain of dependent reductions (alpha, two CGS passes, beta) that
// one block per graph walks alone.
//
// What the design does about it. The TPU kernel walks a sequential grid
// (graph, step, row block) and carries the accumulator in scratch memory;
// here blocks run in parallel and nothing carries over, so a step is two
// launches on the caller's stream and the launch boundary is the
// grid-wide synchronization:
//   1. lanczos_stream_matvec, grid (column tiles, row chunks, graphs): a
//      thread owns one column i and one chunk of kChunk rows and writes
//      part[g, c, i] = sum_{r in chunk c} q_j[r] * S[r, i]. A warp reads
//      128 consecutive bytes of a row of S per load (coalesced), and with
//      N/128 * N/64 blocks every SM streams. This is q^T S: it reads S
//      along rows and equals S q only for a symmetric S, the assumption
//      the TPU kernel makes for the same reason.
//   2. lanczos_stream_finish, one block of 1024 threads per graph: adds
//      the partials in chunk order, then alpha, the three-term update, two
//      CGS passes against rows 0..j of Q (the later rows are zero and are
//      skipped; p1/p2 are written as zero there), beta, the breakdown
//      gate, and writes row j of the outputs and row j+1 of Q. w stays in
//      shared memory; Q (K*N*4 B = 217 KB) is read from L2.
// 2K launches a call; no cooperative launch, no grid-wide sync. S is only
// ever read, so whatever part of it fits stays in L2 between steps.
//
// Order of summation, shared with the plain version so that both break
// down at the same step (where beta is rounding noise near eps, two orders
// of summation part by O(1) in Q). Every product and sum is rounded on its
// own (__fmul_rn/__fadd_rn, never an FMA); sqrt and division are the
// correctly rounded ones. A sum over the node index (the matvec, alpha,
// the CGS coefficients, beta^2) is taken in chunks: kChunk = 64
// consecutive indices in index order starting from zero, then the chunk
// partials in chunk order starting from zero; the last chunk is short
// where N is not a multiple of 64 (the plain version pads with zeros,
// which adds nothing). kChunk is the same for every N. A sum over basis
// rows (at most kMaxK = 64 terms) is taken in index order.
//
// Points where it must not drift from the TPU kernel:
// - the carry quirk: the q_prev entering step j is q_j itself (zero at
//   j = 0, where beta_prev is zero too); written as
//   (w - alpha*q_j) - beta_prev*q_j, as the plain version rounds it;
// - breakdown: beta = sqrt(max(sum w^2, eps^2)), valid = beta > eps; the
//   kernel writes beta*valid and q_{j+1} = valid*w/beta only if j+1 < K;
//   w4 is w before normalization.
//
// Build (lanczosnet_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// No --use_fast_math: it would change sqrtf, the division and denormals.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChunk = 64;        // chunk length of the order of summation
constexpr int kChunkShift = 6;    // log2(kChunk)
constexpr int kMaxN = 16384;      // w and the chunk partials fit one block's shared memory
constexpr int kMaxK = 64;
constexpr int kTile = 128;        // columns per matvec block; >= kChunk
constexpr int kFinishThreads = 1024;

static_assert((1 << kChunkShift) == kChunk, "kChunkShift is log2(kChunk)");
static_assert(kTile >= kChunk, "the matvec block stages one chunk of q");

// Position of w[i] in shared memory: one float of padding after every
// chunk, so that threads walking different chunks in step hit different
// banks.
__device__ __forceinline__ int widx(int i) { return i + (i >> kChunkShift); }

__global__ void lanczos_stream_matvec(
    const float* __restrict__ s, const float* __restrict__ q,
    float* __restrict__ part, int n, int k, int j, int nchunk) {
    __shared__ float qs[kChunk];
    const int g = blockIdx.z;
    const int c = blockIdx.y;
    const int i = blockIdx.x * kTile + threadIdx.x;
    const int lo = c * kChunk;
    const int rows = min(kChunk, n - lo);
    if (threadIdx.x < rows) {
        qs[threadIdx.x] = q[(static_cast<size_t>(g) * k + j) * n + lo + threadIdx.x];
    }
    __syncthreads();
    if (i >= n) return;
    const float* col = s + (static_cast<size_t>(g) * n + lo) * n + i;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < rows; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(qs[t], col[static_cast<size_t>(t) * n]));
    }
    part[(static_cast<size_t>(g) * nchunk + c) * n + i] = acc;
}

// sum_i a[i] * W[widx(i)] in the chunked order, returned to every thread.
// `a` is a row of n floats in device memory, or nullptr for sum W^2.
// T holds nchunk floats of scratch.
__device__ float block_dot(const float* __restrict__ a, const float* W, float* T,
                           int n, int nchunk) {
    for (int c = threadIdx.x; c < nchunk; c += blockDim.x) {
        const int lo = c * kChunk;
        const int hi = min(lo + kChunk, n);
        float acc = 0.f;
        for (int i = lo; i < hi; ++i) {
            const float wi = W[widx(i)];
            acc = __fadd_rn(acc, __fmul_rn(a ? a[i] : wi, wi));
        }
        T[c] = acc;
    }
    __syncthreads();
    float total = 0.f;
    for (int c = 0; c < nchunk; ++c) total = __fadd_rn(total, T[c]);
    __syncthreads();  // T is rewritten by the next reduction
    return total;
}

__global__ void __launch_bounds__(kFinishThreads) lanczos_stream_finish(
    const float* __restrict__ part, float* q_out,
    float* __restrict__ alpha_out, float* beta_out,
    float* __restrict__ p1_out, float* __restrict__ p2_out,
    float* __restrict__ w4_out,
    int n, int k, int j, int nchunk, float eps, float eps_sq) {
    extern __shared__ float smem[];
    float* W = smem;                       // [widx(n)] the work vector
    float* T = W + widx(n) + 1;            // [k * nchunk] chunk partials
    float* P = T + k * nchunk;             // [k] CGS coefficients of a pass

    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const size_t step = static_cast<size_t>(g) * k + j;
    float* qg = q_out + static_cast<size_t>(g) * k * n;
    const float* qj = qg + static_cast<size_t>(j) * n;
    const int rows = j + 1;  // rows of Q written so far; the rest are zero

    // w = q_j^T S: the matvec partials in chunk order
    const float* pg = part + static_cast<size_t>(g) * nchunk * n;
    for (int i = tid; i < n; i += nt) {
        float acc = 0.f;
        for (int c = 0; c < nchunk; ++c) acc = __fadd_rn(acc, pg[static_cast<size_t>(c) * n + i]);
        W[widx(i)] = acc;
    }
    __syncthreads();

    const float alpha = block_dot(qj, W, T, n, nchunk);
    const float beta_prev = j == 0 ? 0.f : beta_out[step - 1];
    for (int i = tid; i < n; i += nt) {
        const float qi = qj[i];
        const float q_prev = j == 0 ? 0.f : qi;  // carry quirk: q_prev is q_j
        W[widx(i)] = __fsub_rn(__fsub_rn(W[widx(i)], __fmul_rn(alpha, qi)),
                               __fmul_rn(beta_prev, q_prev));
    }
    __syncthreads();

    float* const p_out[2] = {p1_out, p2_out};
    for (int pass = 0; pass < 2; ++pass) {
        // chunk partials of the coefficients p[r] = q_r . w, r < rows
        for (int t = tid; t < rows * nchunk; t += nt) {
            const int r = t / nchunk;
            const int c = t - r * nchunk;
            const int lo = c * kChunk;
            const int hi = min(lo + kChunk, n);
            const float* qr = qg + static_cast<size_t>(r) * n;
            float acc = 0.f;
            for (int i = lo; i < hi; ++i) acc = __fadd_rn(acc, __fmul_rn(qr[i], W[widx(i)]));
            T[t] = acc;
        }
        __syncthreads();
        for (int r = tid; r < k; r += nt) {
            float p = 0.f;
            if (r < rows) {
                for (int c = 0; c < nchunk; ++c) p = __fadd_rn(p, T[r * nchunk + c]);
            }
            P[r] = p;
            p_out[pass][step * k + r] = p;
        }
        __syncthreads();
        for (int i = tid; i < n; i += nt) {
            float acc = 0.f;
            for (int r = 0; r < rows; ++r) {
                acc = __fadd_rn(acc, __fmul_rn(qg[static_cast<size_t>(r) * n + i], P[r]));
            }
            W[widx(i)] = __fsub_rn(W[widx(i)], acc);
        }
        __syncthreads();
    }

    const float sq = block_dot(nullptr, W, T, n, nchunk);
    const float beta = __fsqrt_rn(fmaxf(sq, eps_sq));
    const bool valid = beta > eps;
    float* q_next = qg + static_cast<size_t>(j + 1) * n;
    for (int i = tid; i < n; i += nt) {
        const float w = W[widx(i)];
        w4_out[step * n + i] = w;
        if (j + 1 < k) q_next[i] = valid ? __fdiv_rn(w, beta) : 0.f;
    }
    if (tid == 0) {
        alpha_out[step] = alpha;
        beta_out[step] = valid ? beta : 0.f;
    }
}

size_t finish_smem_bytes(int n, int k) {
    const int nchunk = (n + kChunk - 1) / kChunk;
    return sizeof(float) * (static_cast<size_t>(n) + nchunk + 2 +
                            static_cast<size_t>(k) * nchunk + k);
}

}  // namespace

extern "C" {

int lanczos_stream_chunk() { return kChunk; }
int lanczos_stream_max_n() { return kMaxN; }
int lanczos_stream_max_k() { return kMaxK; }

// Run all k steps on `stream` for b graphs: s [b,n,n]; q [b,k,n] with row 0
// of each graph holding the start vector (the other rows are written here);
// part [b, ceil(n/64), n] scratch; -> alpha, beta [b,k], p1, p2 [b,k,k],
// w4 [b,k,n]; all float32, contiguous, on `device`. eps_sq is eps*eps
// rounded to float as the plain version rounds it. Returns the cudaError_t
// of the first launch that failed (0 on success).
int lanczos_stream_launch(const void* s, void* q, void* part, void* alpha, void* beta,
                          void* p1, void* p2, void* w4,
                          int b, int n, int k, float eps, float eps_sq,
                          void* stream, int device) {
    if (b < 1 || b > 65535 || n < 1 || n > kMaxN || k < 1 || k > kMaxK || k > n) {
        return cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int nchunk = (n + kChunk - 1) / kChunk;
    const size_t smem = finish_smem_bytes(n, k);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(lanczos_stream_finish,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((n + kTile - 1) / kTile, nchunk, b);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    for (int j = 0; j < k; ++j) {
        lanczos_stream_matvec<<<grid, kTile, 0, st>>>(
            static_cast<const float*>(s), static_cast<const float*>(q),
            static_cast<float*>(part), n, k, j, nchunk);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        lanczos_stream_finish<<<b, kFinishThreads, smem, st>>>(
            static_cast<const float*>(part), static_cast<float*>(q),
            static_cast<float*>(alpha), static_cast<float*>(beta),
            static_cast<float*>(p1), static_cast<float*>(p2), static_cast<float*>(w4),
            n, k, j, nchunk, eps, eps_sq);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

const char* lanczos_stream_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
