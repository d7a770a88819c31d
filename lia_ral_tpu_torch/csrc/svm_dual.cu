// C-SVC dual solver (FISTA projected gradient) for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package the solver is one jax.jit
// executable of two nested lax.scan loops (lia_ral_tpu/backend/svm.py:61
// _dual_solve) that XLA keeps on the device.  Written as eager PyTorch it
// is some 400 tiny ops a FISTA step, 2e5 launches a trained target, so the
// port runs the whole loop in one kernel.
//
// What is computed, in f32, in the JAX order of operations (Q = K o y y^T,
// formed on the fly as k_ij * (y_i * y_j)):
//   v = 1/N; 16 times: v = Qv / max(|Qv|, 1e-12)
//   lr = 1 / max(|v . Qv|, 1e-8)
//   alpha = alpha_prev = 0, t = 1; n_iter times:
//     mom = alpha + ((t-1)/(t+2)) (alpha - alpha_prev)
//     alpha_prev = alpha; alpha = project(mom + lr (1 - Q mom)); t += 1
//   out = project(alpha)
// project(a): span = (max|a| + max C) + 1; lo = -span, hi = span; 50 times
//   mid = (lo+hi)/2, g = sum_i clip(a_i - mid y_i, 0, C_i) y_i,
//   (lo, hi) = g > 0 ? (mid, hi) : (lo, mid);
//   then clip(a - lam y, 0, C) at lam = (lo+hi)/2.
// Elementwise steps use explicit _rn intrinsics, so nvcc contracts none of
// them into an FMA and each rounds as the plain version's separate ops do.
// Sums are taken in another order than on the CPU (one warp per row of
// the matvec, a fixed tree in the block reductions), so alpha differs from
// the plain version at the f32 level; the order is fixed, so a rerun
// equals the last to the digit (no atomics).
//
// What bounds it on this card.  The bytes are Q once (N^2 4 bytes) and
// the flops ~2 N^2 a matvec, microseconds at the main path's N = 55 and a
// fraction of a millisecond at N = 1001.  What really limits it is the
// dependent chain: 517 matvecs and 501 x 51 block reductions, each ending
// in a __syncthreads.  One thread block per problem (B problems on the
// grid) keeps the chain inside one SM: alpha, alpha_prev, the momentum,
// the projection's input, y and C in shared memory (24 N bytes, N <= 8192);
// Q read from device memory, where it stays in L2 (4 MB at N = 1001); the
// matvec one warp per row, lanes along the row; each block reduction a
// warp shuffle tree then one __syncthreads, the warps' partials in one of
// two alternating shared buffers that every thread sums in the same order,
// so every thread holds the same total and the bisection's branch is
// uniform.  Making it faster (Q in shared memory for small N, fewer
// barriers a bisection step) is later work.
//
// Plain C interface, bound with ctypes.  The entry point launches on the
// given stream and returns cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_N = 8192;
constexpr int MAX_THREADS = 1024;
constexpr int POWER_STEPS = 16;
constexpr int BISECTION_STEPS = 50;

struct Block {
    int tid, lane, warp, nwarps, nthreads;
    float* red;            // [2][32] alternating partial-sum buffers
    int parity;
};

// the same block-wide sum in every thread: warp tree, then the warps'
// partials in order.  One __syncthreads; the alternating buffers make the
// next reduction's writes safe without a second one.
__device__ __forceinline__ float block_sum(float v, Block& b) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    float* buf = b.red + 32 * b.parity;
    b.parity ^= 1;
    if (b.lane == 0) buf[b.warp] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < b.nwarps; ++w) s += buf[w];
    return s;
}

__device__ __forceinline__ float block_max(float v, Block& b) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_down_sync(FULL, v, o));
    float* buf = b.red + 32 * b.parity;
    b.parity ^= 1;
    if (b.lane == 0) buf[b.warp] = v;
    __syncthreads();
    float s = buf[0];
    for (int w = 1; w < b.nwarps; ++w) s = fmaxf(s, buf[w]);
    return s;
}

// (Q vec)_r for r = warp, warp + nwarps, ...: lanes along the row, a warp
// tree; lane 0 hands (r, sum) to `store`.  Reads vec from shared memory.
template <class Store>
__device__ __forceinline__ void matvec(const float* __restrict__ k,
                                       const float* ys, const float* vec,
                                       int n, const Block& b, Store store) {
    for (int r = b.warp; r < n; r += b.nwarps) {
        const float* row = k + (long long)r * n;
        const float yr = ys[r];
        float s = 0.f;
        for (int j = b.lane; j < n; j += 32)
            s += (row[j] * (yr * ys[j])) * vec[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(FULL, s, o);
        if (b.lane == 0) store(r, s);
    }
}

__device__ __forceinline__ float clip(float v, float c) {
    return fminf(fmaxf(v, 0.f), c);
}

// lam of project(src); every thread returns the same value.
__device__ float bisect(const float* src, const float* ys, const float* cs,
                        int n, float c_max, Block& b) {
    float m = 0.f;
    for (int i = b.tid; i < n; i += b.nthreads) m = fmaxf(m, fabsf(src[i]));
    m = block_max(m, b);
    const float span = __fadd_rn(__fadd_rn(m, c_max), 1.f);
    float lo = -span, hi = span;
    for (int it = 0; it < BISECTION_STEPS; ++it) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
        float g = 0.f;
        for (int i = b.tid; i < n; i += b.nthreads)
            g += clip(__fsub_rn(src[i], __fmul_rn(mid, ys[i])), cs[i]) * ys[i];
        g = block_sum(g, b);
        if (g > 0.f) lo = mid; else hi = mid;
    }
    return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

__global__ void __launch_bounds__(MAX_THREADS)
svm_dual_kernel(const float* __restrict__ kmat, const float* __restrict__ y,
                const float* __restrict__ c, float* __restrict__ out, int n,
                int n_iter) {
    extern __shared__ float smem[];
    __shared__ float red[64];
    float* alpha = smem;           // [n] each
    float* prev = alpha + n;
    float* mom = prev + n;         // the momentum; v in the power steps
    float* a = mom + n;            // the projection's input; Qv
    float* ys = a + n;
    float* cs = ys + n;

    const long long p = blockIdx.x;
    const float* k = kmat + p * (long long)n * n;
    Block b{(int)threadIdx.x, (int)threadIdx.x & 31, (int)threadIdx.x >> 5,
            (int)(blockDim.x >> 5), (int)blockDim.x, red, 0};

    const float v0 = __fdiv_rn(1.f, (float)n);
    float cm = -CUDART_INF_F;
    for (int i = b.tid; i < n; i += b.nthreads) {
        ys[i] = y[p * n + i];
        cs[i] = c[p * n + i];
        cm = fmaxf(cm, cs[i]);
        alpha[i] = 0.f;
        prev[i] = 0.f;
        mom[i] = v0;
    }
    const float c_max = block_max(cm, b);      // its barrier publishes all

    // step size: 16 power steps, then |v . Qv|
    for (int it = 0; it < POWER_STEPS; ++it) {
        matvec(k, ys, mom, n, b, [&](int r, float s) { a[r] = s; });
        __syncthreads();
        float ss = 0.f;
        for (int i = b.tid; i < n; i += b.nthreads) ss += a[i] * a[i];
        const float nrm = fmaxf(sqrtf(block_sum(ss, b)), 1e-12f);
        for (int i = b.tid; i < n; i += b.nthreads)
            mom[i] = __fdiv_rn(a[i], nrm);
        __syncthreads();
    }
    matvec(k, ys, mom, n, b, [&](int r, float s) { a[r] = s; });
    __syncthreads();
    float vq = 0.f;
    for (int i = b.tid; i < n; i += b.nthreads) vq += mom[i] * a[i];
    const float lr = __fdiv_rn(1.f, fmaxf(fabsf(block_sum(vq, b)), 1e-8f));

    float t = 1.f;
    for (int it = 0; it < n_iter; ++it) {
        const float f = __fdiv_rn(__fsub_rn(t, 1.f), __fadd_rn(t, 2.f));
        for (int i = b.tid; i < n; i += b.nthreads)
            mom[i] = __fadd_rn(alpha[i],
                               __fmul_rn(f, __fsub_rn(alpha[i], prev[i])));
        __syncthreads();
        matvec(k, ys, mom, n, b, [&](int r, float s) {
            a[r] = __fadd_rn(mom[r], __fmul_rn(lr, __fsub_rn(1.f, s)));
        });
        __syncthreads();
        const float lam = bisect(a, ys, cs, n, c_max, b);
        for (int i = b.tid; i < n; i += b.nthreads) {
            prev[i] = alpha[i];
            alpha[i] = clip(__fsub_rn(a[i], __fmul_rn(lam, ys[i])), cs[i]);
        }
        t = __fadd_rn(t, 1.f);
    }
    __syncthreads();
    const float lam = bisect(alpha, ys, cs, n, c_max, b);
    for (int i = b.tid; i < n; i += b.nthreads)
        out[p * n + i] =
            clip(__fsub_rn(alpha[i], __fmul_rn(lam, ys[i])), cs[i]);
}

}  // namespace

extern "C" {

// k (B, N, N) f32 kernel matrices, y (B, N) labels, c (B, N) box bounds,
// alpha (B, N) f32 out.  1 <= N <= 8192, B >= 1, n_iter >= 0.
int lia_svm_dual(const void* k, const void* y, const void* c, void* alpha,
                 int B, int N, int n_iter, void* stream) {
    if (B < 1 || N < 1 || N > MAX_N || n_iter < 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)6 * N * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            svm_dual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    int threads = (N + 31) / 32 * 32;
    threads = threads > MAX_THREADS ? MAX_THREADS : threads;
    svm_dual_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        (const float*)k, (const float*)y, (const float*)c, (float*)alpha, N,
        n_iter);
    return (int)cudaGetLastError();
}

}  // extern "C"
