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
// each step a sequence of sums that each depend on the one before (the
// matvec, alpha, p1, its combine, p2, its combine, beta^2), every sum a
// chain of dependent adds because the order of summation is fixed (below).
// With NP the padded N that is 5*NP + 2*(j+1) links a step, about 4 cycles
// each at best: about 8 us at NP=32, K=20, plus the launch.
//
// What the design does about it. The TPU kernel laid graphs on the 128
// lanes; here a graph is a block of NP threads (NP = 32, 64 or 128, the
// least that holds N; one warp at the serving shape, synchronized with
// __syncwarp), so the 64 graphs run on 64 SMs at once. S and the basis Q
// are staged once into shared memory, zero-padded to NP, with a row stride
// of NP+4 floats: rows stay 16-byte aligned, and thread i reading four
// floats of row i at a time hits banks apart from its neighbours'. They
// stay there for all K steps; nothing returns to device memory between
// steps. What a chain costs is taken off its dependent path: every sum has
// the compile-time length NP and is fully unrolled, its operands are
// loaded four at a time and its products formed eight at a time ahead of
// the adds, so a link is one __fadd_rn and not a load, a multiply and an
// add. The zero padding adds +0 to a sum that started from +0 and changes
// nothing. The combine sum_r Q[r,i]*p[r] of a CGS pass runs over rows 0..j
// only: rows beyond j are still zero and p[r] is +0 there, so the skipped
// terms add exactly nothing; p1/p2 are written as zero beyond j. Each
// thread adds alpha and beta^2 for itself, which saves a broadcast. All
// arithmetic is float32 on the FMA pipes, never the tensor cores (no TF32).
//
// Order of arithmetic. Every sum is taken term by term in index order, and
// every product and sum is rounded on its own (__fmul_rn/__fadd_rn, never
// contracted into an FMA), exactly as the plain version does it; sqrt and
// division are the correctly rounded ones. So kernel and plain version
// agree bit for bit on the card. On QM8-like graphs the Krylov space is
// often exhausted before step K, and there beta is rounding noise of the
// order of eps: the breakdown decision and the noise direction normalized
// into q_{j+1} depend on the order of summation, and two orders part by
// O(1) in Q from that step on. A warp-shuffle tree or an atomic add would
// change the order; a faster kernel would need a plain version with the
// same tree order.
//
// Points where it must not drift from the TPU kernel:
// - the carry quirk: the q_prev entering step j is q_j itself (zero at
//   j = 0, where beta_prev is zero too);
// - S*q is taken row by row; S is not assumed symmetric;
// - breakdown: beta = sqrt(max(sum w^2, eps^2)), valid = beta > eps; the
//   kernel writes beta*valid and q_{j+1} = valid*w/beta only if j+1 < K;
//   w4 is w before normalization; p1/p2 have K entries a step, zero beyond
//   row j (there the plain version multiplies zero rows and gets +0).
// - K may exceed N, as in the TPU kernel: once the basis spans the graph's
//   nodes, CGS2 leaves w at rounding level, beta <= eps, and every later
//   row of Q is zero. Nothing in a step reads N for K; only thread r writes
//   the CGS coefficient r, so K is limited to the block's NP threads (the
//   wrapper sends a larger K to the plain version by shape, kernel_limit).
//
// Build (lanczosnet_torch/ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// No --use_fast_math: it would change sqrtf, the division and denormals.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxN = 128;  // one graph's S and Q must fit in shared memory

template <int NP>
__device__ __forceinline__ void block_sync() {
    if constexpr (NP == 32) {
        __syncwarp();
    } else {
        __syncthreads();
    }
}

// sum_{t<NP} a[t]*b[t] in index order; a and b are 16-byte aligned rows in
// shared memory. Loads come four floats at a time and the products eight
// at a time ahead of the adds, so the dependent path is the adds alone.
template <int NP>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < NP / 4; t += 2) {
        const float4 x0 = a4[t], x1 = a4[t + 1];
        const float4 y0 = b4[t], y1 = b4[t + 1];
        const float p0 = __fmul_rn(x0.x, y0.x), p1 = __fmul_rn(x0.y, y0.y);
        const float p2 = __fmul_rn(x0.z, y0.z), p3 = __fmul_rn(x0.w, y0.w);
        const float p4 = __fmul_rn(x1.x, y1.x), p5 = __fmul_rn(x1.y, y1.y);
        const float p6 = __fmul_rn(x1.z, y1.z), p7 = __fmul_rn(x1.w, y1.w);
        acc = __fadd_rn(acc, p0);
        acc = __fadd_rn(acc, p1);
        acc = __fadd_rn(acc, p2);
        acc = __fadd_rn(acc, p3);
        acc = __fadd_rn(acc, p4);
        acc = __fadd_rn(acc, p5);
        acc = __fadd_rn(acc, p6);
        acc = __fadd_rn(acc, p7);
    }
    return acc;
}

template <int NP>
__host__ __device__ constexpr size_t smem_floats(int k) {
    return static_cast<size_t>(NP + k) * (NP + 4) + 2 * NP + ((k + 3) / 4) * 4;
}

template <int NP>
__global__ void __launch_bounds__(NP) lanczos_tridiag_kernel(
    const float* __restrict__ s, const float* __restrict__ q0,
    float* __restrict__ alpha_out, float* __restrict__ beta_out,
    float* __restrict__ q_out, float* __restrict__ p1_out,
    float* __restrict__ p2_out, float* __restrict__ w4_out,
    int n, int k, float eps, float eps_sq) {
    extern __shared__ __align__(16) float smem[];
    constexpr int ld = NP + 4;     // padded row stride of S and Q
    float* S = smem;               // [NP][ld], zero beyond n
    float* Q = S + NP * ld;        // [k][ld] basis, zero beyond n; row r is written at step r-1
    float* W0 = Q + k * ld;        // [NP] the work vector as the sums read it,
    float* W1 = W0 + NP;           // [NP] two copies written in turn
    float* P = W1 + NP;            // [k] CGS coefficients of the current pass

    const int g = blockIdx.x;
    const int i = threadIdx.x;     // the row this thread owns; rows n..NP-1 are zero
    const bool row = i < n;

    const float* sg = s + static_cast<size_t>(g) * n * n;
    for (int e = i; e < NP * NP; e += NP) {
        const int r = e / NP, c = e % NP;
        S[r * ld + c] = r < n && c < n ? sg[r * n + c] : 0.f;
    }
    Q[i] = row ? q0[static_cast<size_t>(g) * n + i] : 0.f;
    block_sync<NP>();

    float* const p_out[2] = {p1_out, p2_out};
    float beta_prev = 0.f;
    for (int j = 0; j < k; ++j) {
        const size_t step = static_cast<size_t>(g) * k + j;
        const int rows = j + 1;    // rows of Q written so far
        const float* qj = Q + j * ld;
        float w = dot_row<NP>(S + i * ld, qj);
        W0[i] = w;
        block_sync<NP>();
        const float alpha = dot_row<NP>(qj, W0);
        {
            const float qi = qj[i];
            const float q_prev = j == 0 ? 0.f : qi;  // carry quirk: q_prev is q_j
            w = __fsub_rn(__fsub_rn(w, __fmul_rn(alpha, qi)), __fmul_rn(beta_prev, q_prev));
        }

        // two CGS passes; the work vector goes to W1, then W0, then W1 again
        float* Wb = W1;
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
            Wb[i] = w;
            block_sync<NP>();
            if (i < k) {
                const float p = i < rows ? dot_row<NP>(Q + i * ld, Wb) : 0.f;
                P[i] = p;
                p_out[pass][step * k + i] = p;
            }
            block_sync<NP>();
            float acc = 0.f;
#pragma unroll 4
            for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, __fmul_rn(Q[r * ld + i], P[r]));
            w = __fsub_rn(w, acc);
            Wb = pass == 0 ? W0 : W1;
        }

        W1[i] = w;
        block_sync<NP>();
        const float sq = dot_row<NP>(W1, W1);
        const float beta = __fsqrt_rn(fmaxf(sq, eps_sq));
        const bool valid = beta > eps;
        if (row) w4_out[step * n + i] = w;
        if (j + 1 < k) Q[(j + 1) * ld + i] = valid ? __fdiv_rn(w, beta) : 0.f;
        if (i == 0) {
            alpha_out[step] = alpha;
            beta_out[step] = valid ? beta : 0.f;
        }
        beta_prev = valid ? beta : 0.f;
        block_sync<NP>();
    }

    float* qg = q_out + static_cast<size_t>(g) * k * n;
    for (int e = i; e < k * n; e += NP) qg[e] = Q[(e / n) * ld + e % n];
}

template <int NP>
cudaError_t launch(const float* s, const float* q0, float* alpha, float* beta, float* q,
                   float* p1, float* p2, float* w4, int b, int n, int k, float eps,
                   float eps_sq, cudaStream_t stream) {
    const size_t smem = sizeof(float) * smem_floats<NP>(k);
    if (smem > 48 * 1024) {
        // Opened to the most this instantiation can need (K = NP), the same
        // value in every call: the attribute belongs to the function, so
        // calls with different K from different host threads cannot undo
        // each other's.
        const cudaError_t err = cudaFuncSetAttribute(
            lanczos_tridiag_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(sizeof(float) * smem_floats<NP>(NP)));
        if (err != cudaSuccess) return err;
    }
    lanczos_tridiag_kernel<NP><<<b, NP, smem, stream>>>(
        s, q0, alpha, beta, q, p1, p2, w4, n, k, eps, eps_sq);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int lanczos_tridiag_max_n() { return kMaxN; }

// The padded N (threads of a block, length of every sum) the launcher
// picks for n: the least of 32, 64, 128 that holds it.
int lanczos_tridiag_padded_n(int n) { return n <= 32 ? 32 : n <= 64 ? 64 : 128; }

// Launch on `stream` for b graphs: s [b,n,n], q0 [b,n] -> alpha, beta [b,k],
// q [b,k,n], p1, p2 [b,k,k], w4 [b,k,n]; all float32, contiguous, on
// `device`. eps_sq is eps*eps rounded to float as the plain version rounds
// it. Returns the cudaError_t of the launch (0 on success).
int lanczos_tridiag_launch(const void* s, const void* q0, void* alpha, void* beta,
                           void* q, void* p1, void* p2, void* w4,
                           int b, int n, int k, float eps, float eps_sq,
                           void* stream, int device) {
    if (b < 1 || n < 1 || n > kMaxN || k < 1 || k > lanczos_tridiag_padded_n(n))
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const float* sf = static_cast<const float*>(s);
    const float* q0f = static_cast<const float*>(q0);
    float* af = static_cast<float*>(alpha);
    float* bf = static_cast<float*>(beta);
    float* qf = static_cast<float*>(q);
    float* p1f = static_cast<float*>(p1);
    float* p2f = static_cast<float*>(p2);
    float* w4f = static_cast<float*>(w4);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (lanczos_tridiag_padded_n(n)) {
        case 32:
            return launch<32>(sf, q0f, af, bf, qf, p1f, p2f, w4f, b, n, k, eps, eps_sq, st);
        case 64:
            return launch<64>(sf, q0f, af, bf, qf, p1f, p2f, w4f, b, n, k, eps, eps_sq, st);
        default:
            return launch<128>(sf, q0f, af, bf, qf, p1f, p2f, w4f, b, n, k, eps, eps_sq, st);
    }
}

const char* lanczos_tridiag_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
