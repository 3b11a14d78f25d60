// Batched K-step Lanczos tridiagonalization with CGS2 reorthogonalization
// and the adjoint residuals, one thread block per graph.
//
// Replaces the TPU kernel lanczosnet_tpu/ops/lanczos_pallas.py:_lanczos_kernel
// (called from lanczos_tridiag_pallas_resid). It computes what that kernel
// computes; its plain version is
// lanczosnet_torch/ops/lanczos.py:lanczos_tridiag_resid, and the host
// wrapper is lanczosnet_torch/ops/lanczos_cuda.py:lanczos_tridiag_cuda_resid.
//
// What bounds it on an H100. At the serving shape (B=64 graphs, N=32, K=20)
// it reads S (64*32*32*4 B = 262 KB) and q0 (8 KB) once and writes about
// 0.55 MB of outputs: 0.24 us at 3.35 TB/s. It does about 9.5 MFLOP of
// float32 work: 0.14 us at 67 TFLOP/s. Both are far below one launch. The
// real limit is latency: K dependent steps inside each block, and inside
// each step chains of dependent adds (below).
//
// What the design does about it. The TPU kernel laid graphs on the 128
// lanes; here a graph is a block, so nothing is padded to a lane width and
// the 64 graphs run on 64 SMs at once. S is staged once into shared memory
// with a padded row stride (N+1 floats), and so is the basis Q, so that
// thread i walking row i (the matvec, the CGS projections) hits a distinct
// bank from its neighbours. Q, the work vector and the CGS coefficients
// stay in shared memory for all K steps; nothing returns to device memory
// between steps. All arithmetic is float32 on the FMA pipes, never the
// tensor cores (no TF32).
//
// Order of arithmetic. Every sum is taken term by term in index order, and
// every product and sum is rounded on its own (__fmul_rn/__fadd_rn, never
// contracted into an FMA), exactly as the plain version does it; sqrt and
// division are the correctly rounded ones. So kernel and plain version
// agree bit for bit on the card. On QM8-like graphs the Krylov space is
// often exhausted before step K, and there beta is rounding noise of the
// order of eps: the breakdown decision and the noise direction normalized
// into q_{j+1} depend on the order of summation, and two orders part by
// O(1) in Q from that step on. The price is latency: alpha, beta^2 and each
// CGS coefficient are sequential chains of N adds (each thread sums the
// scalars for itself, which saves a barrier and a broadcast). A faster
// kernel would need a plain version with the same tree order.
//
// Points where it must not drift from the TPU kernel:
// - the carry quirk: the q_prev entering step j is q_j itself (zero at
//   j = 0, where beta_prev is zero too);
// - S*q is taken row by row; S is not assumed symmetric;
// - breakdown: beta = sqrt(max(sum w^2, eps^2)), valid = beta > eps; the
//   kernel writes beta*valid and q_{j+1} = valid*w/beta only if j+1 < K;
//   w4 is w before normalization; p1/p2 are the CGS coefficients against
//   all K rows, the zero rows included.
//
// Build (lanczosnet_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// No --use_fast_math: it would change sqrtf, the division and denormals.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxN = 128;  // one graph's S and Q must fit in shared memory

__global__ void lanczos_tridiag_kernel(
    const float* __restrict__ s, const float* __restrict__ q0,
    float* __restrict__ alpha_out, float* __restrict__ beta_out,
    float* __restrict__ q_out, float* __restrict__ p1_out,
    float* __restrict__ p2_out, float* __restrict__ w4_out,
    int n, int k, float eps, float eps_sq) {
    extern __shared__ float smem[];
    const int ld = n + 1;          // padded row stride of S and Q
    float* S = smem;               // [n][ld]
    float* Q = S + n * ld;         // [k][ld] basis, rows past the current step zero
    float* W = Q + k * ld;         // [n] work vector, shared for the sums
    float* P = W + n;              // [k] CGS coefficients of the current pass

    const int g = blockIdx.x;
    const int i = threadIdx.x;     // the row this thread owns
    const bool row = i < n;

    const float* sg = s + static_cast<size_t>(g) * n * n;
    for (int e = i; e < n * n; e += blockDim.x) S[(e / n) * ld + e % n] = sg[e];
    const float* q0g = q0 + static_cast<size_t>(g) * n;
    for (int e = i; e < k * ld; e += blockDim.x) Q[e] = e < n ? q0g[e] : 0.f;
    __syncthreads();

    float* const p_out[2] = {p1_out, p2_out};
    float beta_prev = 0.f;
    for (int j = 0; j < k; ++j) {
        const size_t step = static_cast<size_t>(g) * k + j;
        const float* qj = Q + j * ld;
        float w = 0.f;
        if (row) {
            const float* srow = S + i * ld;
            for (int c = 0; c < n; ++c) w = __fadd_rn(w, __fmul_rn(srow[c], qj[c]));
            W[i] = w;
        }
        __syncthreads();
        float alpha = 0.f;
        for (int c = 0; c < n; ++c) alpha = __fadd_rn(alpha, __fmul_rn(qj[c], W[c]));
        if (row) {
            const float qi = qj[i];
            const float q_prev = j == 0 ? 0.f : qi;  // carry quirk: q_prev is q_j
            w = __fsub_rn(__fsub_rn(w, __fmul_rn(alpha, qi)), __fmul_rn(beta_prev, q_prev));
        }
        __syncthreads();  // everyone has read W

        for (int pass = 0; pass < 2; ++pass) {
            if (row) W[i] = w;
            __syncthreads();
            if (i < k) {
                const float* qr = Q + i * ld;
                float p = 0.f;
                for (int c = 0; c < n; ++c) p = __fadd_rn(p, __fmul_rn(qr[c], W[c]));
                P[i] = p;
                p_out[pass][step * k + i] = p;
            }
            __syncthreads();
            if (row) {
                float acc = 0.f;
                for (int r = 0; r < k; ++r) acc = __fadd_rn(acc, __fmul_rn(Q[r * ld + i], P[r]));
                w = __fsub_rn(w, acc);
            }
            __syncthreads();  // W and P are rewritten next
        }

        if (row) W[i] = w;
        __syncthreads();
        float sq = 0.f;
        for (int c = 0; c < n; ++c) sq = __fadd_rn(sq, __fmul_rn(W[c], W[c]));
        const float beta = __fsqrt_rn(fmaxf(sq, eps_sq));
        const bool valid = beta > eps;
        if (row) {
            w4_out[step * n + i] = w;
            if (j + 1 < k) Q[(j + 1) * ld + i] = valid ? __fdiv_rn(w, beta) : 0.f;
        }
        if (i == 0) {
            alpha_out[step] = alpha;
            beta_out[step] = valid ? beta : 0.f;
        }
        beta_prev = valid ? beta : 0.f;
        __syncthreads();
    }

    float* qg = q_out + static_cast<size_t>(g) * k * n;
    for (int e = i; e < k * n; e += blockDim.x) qg[e] = Q[(e / n) * ld + e % n];
}

}  // namespace

extern "C" {

int lanczos_tridiag_max_n() { return kMaxN; }

// Launch on `stream` for b graphs: s [b,n,n], q0 [b,n] -> alpha, beta [b,k],
// q [b,k,n], p1, p2 [b,k,k], w4 [b,k,n]; all float32, contiguous, on
// `device`. eps_sq is eps*eps rounded to float as the plain version rounds
// it. Returns the cudaError_t of the launch (0 on success).
int lanczos_tridiag_launch(const void* s, const void* q0, void* alpha, void* beta,
                           void* q, void* p1, void* p2, void* w4,
                           int b, int n, int k, float eps, float eps_sq,
                           void* stream, int device) {
    if (b < 1 || n < 1 || n > kMaxN || k < 1 || k > n) return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const int threads = ((n + 31) / 32) * 32;  // >= n >= k
    const size_t smem = sizeof(float) * (static_cast<size_t>(n + k) * (n + 1) + n + k);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(lanczos_tridiag_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    lanczos_tridiag_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(s), static_cast<const float*>(q0),
        static_cast<float*>(alpha), static_cast<float*>(beta), static_cast<float*>(q),
        static_cast<float*>(p1), static_cast<float*>(p2), static_cast<float*>(w4),
        n, k, eps, eps_sq);
    return cudaGetLastError();
}

const char* lanczos_tridiag_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
