// GMM EM / Baum-Welch sufficient statistics for Hopper (sm_90a), SIMT.
//
// Replaces the two Pallas TPU kernels of lia_ral_tpu/gmm/pallas_kernels.py:
//   K1  em_stats_fused  (_em_stats_kernel, pallas_call at :314)
//   K2  bw_stats_fused  (_bw_stats_kernel, pallas_call at :476)
//
// Both compute, per frame t and component k, the logit ld = xa_t . B_k
// with the TPU kernel's augmented design
//   xa_t = [x_t^2 (D), x_t (D), 1, 0 ...]          (WP columns)
//   B_k  = [-1/2 ivar_k (D), mu_k ivar_k (D), cst_k, 0 ...]
// the posterior  gamma_tk = w_t * exp(ld_tk - llk_t),  llk_t = logsumexp_k,
// and the stats  S_k = sum_t gamma_tk * xa_t,  which are, column by column,
// [sum_xx (D), sum_x (D), n, 0]: the TPU kernel's (K+1, A) block, A = 2D+2,
// whose row K holds [sum_t w_t llk_t, sum_t w_t, 0 ...].
//
// What bounds it on this card.  Per (frame, component) pair the work is
// ~WP FMAs for the logit, one exp, and ~WP FMAs for the stats: 6*N*K*A
// flops in all with the recompute below, against only N*D*4 bytes of
// frames read.  So the kernels are bound by f32 FMA issue and the shared
// memory loads that feed it, never by HBM.  Both products are written as
// register-blocked SIMT micro-GEMMs: a thread owns a 2-frame x 4-component
// logit tile (8 FMAs per float4 + float2 shared load) and a 4-component x
// CPT-column stats tile (4*CPT FMAs per float4 + CPT scalar loads).
//
// The TPU kernel held a whole (block, K) logit tile in VMEM; at K=2048 a
// (64, K) f32 tile alone is 512 KB, and a CTA has at most 227 KB of
// shared memory.  So the design tiles over K in two passes:
//   (i)  frame_llk_kernel: a CTA takes TB frames and walks all K in KT
//        tiles, keeping a per-thread online max/sum-exp; the 16 partial
//        (max, sum) pairs of a frame are merged in a fixed order.
//   (ii) stats_kernel: grid (frame chunk, K tile).  A CTA keeps B for its
//        KT components in shared memory, streams its chunk in TB-frame
//        sub-blocks, recomputes the logits with the same device function
//        as (i) (each logit is the same FMA chain over the same columns,
//        so both passes see bit-identical values), forms gamma in shared
//        memory and adds gamma^T xa into register accumulators.
// The (N, K) posterior block never reaches device memory, as on the TPU.
//
// No ordered grid.  The TPU kernels carried a sum across sequential grid
// steps.  Here a K2 CTA owns one (utterance, K tile) and loops over all T
// frames itself; K1 writes per-chunk partials (n_chunks, K+1, A) that
// reduce_chunks_kernel adds in chunk order.  No float atomics: every sum
// is taken by one thread, or by a fixed tree, in a fixed order, so the
// results reproduce to every digit across reruns.
//
// Ragged edges are masked in the kernel (no host padding).  A frame with
// zero weight contributes exactly 0 to n, the sums and the llk row; an
// all-zero-weight utterance gives n = 0 and f = 0.
//
// Arithmetic tiers.  Each tier rounds where the TPU kernel rounds
// (pallas_kernels.py), so the port's plain versions in cuda_kernels.py can
// mirror it operation for operation:
//   default    (tier 0)  f32 logits ld = xa.B (the TPU's bf16x3 split is
//              f32-grade), gamma = w*exp(ld - llk), f32 stats.  The TPU
//              kernel computes this tier in base 2 (exp_mode="exp2"); its
//              p is never rounded, so the natural base here differs from
//              it only at the f32-ulp level.
//   The other tiers run base-2 logits as the TPU does (:110-133,
//   :289-293): the wrapper scales B and cst by log2(e), p = exp2(ld - m),
//   and llk = ln(sum_k p) + m ln 2.  So p is rounded from the same value.
//   fastStats  (tier 1, stats_pass="bf16nx", :75-98, :177-200)  f32
//              logits (B and cst scaled, not rounded; cst folded into
//              the constant-1 column as in the TPU's bf16x3 mode); the
//              llk pass also writes the per-frame max m and the scale
//              s = w / sum_k exp2(ld - m); the stats pass forms the
//              unnormalised p = exp2(ld - m), rounds p and xs = xa*s to
//              bf16 and accumulates their products in f32 (a product of
//              two bf16 values is exact in f32).  The occupancy column is
//              the exact f32 sum_t p*s instead (its own accumulator).
//   fastMath   (tier 2, compute_dtype=bf16, :165-176, :289-306)  logits
//              from bf16 operands: the wrapper rounds the scaled B to
//              bf16, the kernel rounds xa to bf16 as it feeds the logit
//              FMAs, and cst*log2(e) stays f32 and is added after the
//              products (the design's constant-1 column carries it last
//              in the FMA chain; it is not folded into a rounded B).
//              The TPU's stats
//              product in this mode is Precision.DEFAULT, one bf16 pass on
//              the chip but f32 in interpret mode; the documented contract
//              (lia_ral_tpu/gmm/em.py:71-73) is "sufficient stats stay
//              f32", so the stats here are f32: sum_t p * (xa*s).
//   tier 3     fastMath logits with fastStats stats (both config keys).
// All tiers share the logit routine between the two passes, so the llk
// pass and the stats pass see bit-identical logits in every tier.
//
// Plain C interface, bound with ctypes.  Each entry point launches on the
// given stream and returns cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 256;         // threads per CTA: 16 x 16
constexpr int KT = 64;          // components per tile (16 groups of 4)
constexpr int TB = 32;          // frames per sub-block (16 groups of 2)
constexpr int TBP = TB + 4;     // padded row of the transposed frame tile

// Shared-memory layout (floats), for WP = 16 * CPT design columns.  In
// the tiers W holds s and L holds m; PN (fastStats only) holds p*s.
template <int CPT, bool NX>
struct Smem {
    static constexpr int WP = 16 * CPT;
    static constexpr int B = 0;                       // [WP][KT]  B tile
    static constexpr int XA = B + WP * KT;            // [WP][TBP] xa^T
    static constexpr int G = XA + WP * TBP;           // [TB][KT]  gamma / p
    static constexpr int W = G + TB * KT;             // [TB]      w or s
    static constexpr int L = W + TB;                  // [TB]      llk or m
    static constexpr int RED = L + TB;                // [2][NT]   reductions
    static constexpr int PN = RED + 2 * NT;           // [TB][KT]  p*s
    static constexpr int SIZE = PN + (NX ? TB * KT : 0);
    static constexpr size_t BYTES = sizeof(float) * SIZE;
};

// Round to the nearest bf16 (ties to even) and back to f32.
__device__ __forceinline__ float bf16r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// B tile: sB[c][kk] = bt[c][k0 + kk] for c < 2D+1 and k0+kk < K, else 0.
// bt is the (2D+1, K) transposed parameter matrix built by the wrapper.
template <int CPT>
__device__ void load_b_tile(float* sB, const float* bt, int k0, int K,
                            int D) {
    constexpr int WP = 16 * CPT;
    const int rows = 2 * D + 1;
    for (int i = threadIdx.x; i < WP * KT; i += NT) {
        const int c = i / KT, kk = i % KT, k = k0 + kk;
        sB[i] = (c < rows && k < K) ? bt[(long long)c * K + k] : 0.f;
    }
}

// Frames [t0, t0+nb) into sXA[c][t] = xa_t[c], plus the per-frame values
// w and llk (default tier) or s and m (the other tiers) into sW / sL where
// those are given.  Rows beyond 2D+1 stay zero from the first call.
template <int CPT>
__device__ void load_frames(float* sXA, float* sW, float* sL,
                            const float* x, const float* w,
                            const float* llk, long long t0, int nb, int D,
                            bool first) {
    constexpr int WP = 16 * CPT;
    if (first) {
        for (int i = threadIdx.x; i < WP * TBP; i += NT) sXA[i] = 0.f;
        __syncthreads();
    }
    for (int i = threadIdx.x; i < TB * D; i += NT) {
        const int t = i / D, d = i % D;
        const float v = t < nb ? x[(t0 + t) * D + d] : 0.f;
        sXA[d * TBP + t] = v * v;
        sXA[(D + d) * TBP + t] = v;
    }
    for (int t = threadIdx.x; t < TB; t += NT) {
        const bool live = t < nb;
        sXA[2 * D * TBP + t] = live ? 1.f : 0.f;
        if (sW != nullptr) sW[t] = live ? w[t0 + t] : 0.f;
        if (sL != nullptr) sL[t] = live ? llk[t0 + t] : 0.f;
    }
}

// The one logit routine both passes use: acc[f][j] = logit of frame
// 2*tg+f and component 4*kg+j of the tile, as the FMA chain over the
// columns c = 0 .. WP-1 in order.  FM (fastMath): xa is rounded to bf16
// as it is read (B arrives rounded from the wrapper), so each FMA adds an
// exact bf16 x bf16 product to the f32 sum.
template <int CPT, bool FM>
__device__ __forceinline__ void logits(const float* sB, const float* sXA,
                                       int kg, int tg, float acc[2][4]) {
    constexpr int WP = 16 * CPT;
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[f][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < WP; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(sB + c * KT + 4 * kg);
        float2 xv = *reinterpret_cast<const float2*>(sXA + c * TBP + 2 * tg);
        if (FM) {
            xv.x = bf16r(xv.x);
            xv.y = bf16r(xv.y);
        }
        acc[0][0] = fmaf(xv.x, b.x, acc[0][0]);
        acc[0][1] = fmaf(xv.x, b.y, acc[0][1]);
        acc[0][2] = fmaf(xv.x, b.z, acc[0][2]);
        acc[0][3] = fmaf(xv.x, b.w, acc[0][3]);
        acc[1][0] = fmaf(xv.y, b.x, acc[1][0]);
        acc[1][1] = fmaf(xv.y, b.y, acc[1][1]);
        acc[1][2] = fmaf(xv.y, b.z, acc[1][2]);
        acc[1][3] = fmaf(xv.y, b.w, acc[1][3]);
    }
}

// llk_t = logsumexp_k ld_tk (natural log).  Tiers other than the default
// have base-2 logits (exp2) and also write m_t (the max logit, base 2)
// and s_t = w_t / sum_k exp2(ld_tk - m_t).
template <int CPT, bool FM, bool TIER>
__global__ void __launch_bounds__(NT)
frame_llk_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bt, long long n_frames, int K,
                 int D, float* __restrict__ llk, float* __restrict__ m_out,
                 float* __restrict__ s_out) {
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    using S = Smem<CPT, false>;
    float* sB = sm + S::B;
    float* sXA = sm + S::XA;
    float* sPm = sm + S::G;              // [TB][16] partial maxima
    float* sPs = sm + S::G + TB * 16;    // [TB][16] partial sums

    const int tid = threadIdx.x, kg = tid % 16, tg = tid / 16;
    const long long t0 = (long long)blockIdx.x * TB;
    const int nb = (int)min((long long)TB, n_frames - t0);
    load_frames<CPT>(sXA, nullptr, nullptr, x, nullptr, nullptr, t0, nb, D,
                     true);

    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, s[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += KT) {
        __syncthreads();
        load_b_tile<CPT>(sB, bt, k0, K, D);
        __syncthreads();
        float acc[2][4];
        logits<CPT, FM>(sB, sXA, kg, tg, acc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (k0 + 4 * kg + j >= K) continue;
#pragma unroll
            for (int f = 0; f < 2; ++f) {
                const float v = acc[f][j];
                if (v > m[f]) {
                    s[f] = s[f] * (TIER ? exp2f(m[f] - v) : expf(m[f] - v))
                           + 1.f;
                    m[f] = v;
                } else {
                    s[f] += TIER ? exp2f(v - m[f]) : expf(v - m[f]);
                }
            }
        }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f) {
        sPm[(2 * tg + f) * 16 + kg] = m[f];
        sPs[(2 * tg + f) * 16 + kg] = s[f];
    }
    __syncthreads();
    if (tid < nb) {
        float M = -CUDART_INF_F, Ssum = 0.f;
        for (int g = 0; g < 16; ++g) {           // fixed merge order
            const float mg = sPm[tid * 16 + g], sg = sPs[tid * 16 + g];
            if (mg == -CUDART_INF_F) continue;
            if (mg > M) {
                Ssum = Ssum * (TIER ? exp2f(M - mg) : expf(M - mg)) + sg;
                M = mg;
            } else {
                Ssum += sg * (TIER ? exp2f(mg - M) : expf(mg - M));
            }
        }
        const long long t = t0 + tid;
        // base-2 logits: ln sum exp = ln(sum 2^(ld-m)) + m ln 2
        llk[t] = TIER ? logf(Ssum) + M * 0.6931471805599453f
                      : M + logf(Ssum);
        if (TIER) {
            m_out[t] = M;
            s_out[t] = w[t] / Ssum;
        }
    }
}

// Frames of chunk c are [c*chunk_len, min((c+1)*chunk_len, n_frames)).
// out: (n_chunks, K+1, A).  CTA (c, j) writes rows [j*KT, j*KT+KT) of
// chunk c; the CTAs with j == 0 also write row K.  m and s are the llk
// pass's outputs in the tiers (null in the default tier).
template <int CPT, bool FM, bool NX>
__global__ void __launch_bounds__(NT)
stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ llk, const float* __restrict__ m,
             const float* __restrict__ s, const float* __restrict__ bt,
             long long n_frames, int chunk_len, int K, int D,
             float* __restrict__ out) {
    constexpr bool TIER = FM || NX;
    extern __shared__ float4 smem4[];
    float* sm = reinterpret_cast<float*>(smem4);
    using S = Smem<CPT, NX>;
    float* sB = sm + S::B;
    float* sXA = sm + S::XA;
    float* sG = sm + S::G;
    float* sW = sm + S::W;
    float* sL = sm + S::L;

    const int tid = threadIdx.x, kg = tid % 16, g2 = tid / 16;
    const int k0 = blockIdx.y * KT;
    const int A = 2 * D + 2;
    const long long f0 = (long long)blockIdx.x * chunk_len;
    const long long f1 = min(f0 + chunk_len, n_frames);

    load_b_tile<CPT>(sB, bt, k0, K, D);

    // stats tile of this thread: components 4*kg+i, columns CPT*g2+j
    float acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
    float nacc = 0.f;       // fastStats: exact sum_t p*s of component tid

    bool first = true;
    for (long long t0 = f0; t0 < f1; t0 += TB) {
        const int nb = (int)min((long long)TB, f1 - t0);
        __syncthreads();
        load_frames<CPT>(sXA, sW, sL, x, TIER ? s : w, TIER ? m : llk, t0,
                         nb, D, first);
        first = false;
        __syncthreads();
        {   // gamma (default) or p (tiers) for frames 2*g2+f,
            // components 4*kg+j
            float ld[2][4];
            logits<CPT, FM>(sB, sXA, kg, g2, ld);
#pragma unroll
            for (int f = 0; f < 2; ++f) {
                const int t = 2 * g2 + f;
                const float wt = sW[t], lt = sL[t];
                float4 g, pn;
                float* gp = &g.x;
                float* pp = &pn.x;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const bool live = wt != 0.f && k0 + 4 * kg + j < K;
                    if (!TIER) {
                        gp[j] = live ? expf(ld[f][j] - lt) * wt : 0.f;
                    } else {
                        const float p = live ? exp2f(ld[f][j] - lt) : 0.f;
                        gp[j] = NX ? bf16r(p) : p;
                        pp[j] = p * wt;
                    }
                }
                *reinterpret_cast<float4*>(sG + t * KT + 4 * kg) = g;
                if (NX)
                    *reinterpret_cast<float4*>(sm + S::PN + t * KT + 4 * kg) =
                        pn;
            }
        }
        __syncthreads();
        if (TIER) {
            // xs = xa * s in place (the logits of this sub-block are done);
            // fastStats rounds it to bf16.  Row 2D becomes s itself.
            for (int i = threadIdx.x; i < (2 * D + 1) * TB; i += NT) {
                const int c = i / TB, t = i % TB;
                const float v = sXA[c * TBP + t] * sW[t];
                sXA[c * TBP + t] = NX ? bf16r(v) : v;
            }
            __syncthreads();
            if (NX && tid < KT) {
                for (int t = 0; t < nb; ++t) nacc += sm[S::PN + t * KT + tid];
            }
        }
        for (int t = 0; t < nb; ++t) {
            const float4 g = *reinterpret_cast<const float4*>(sG + t * KT + 4 * kg);
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const float v = sXA[(CPT * g2 + j) * TBP + t];
                acc[0][j] = fmaf(g.x, v, acc[0][j]);
                acc[1][j] = fmaf(g.y, v, acc[1][j]);
                acc[2][j] = fmaf(g.z, v, acc[2][j]);
                acc[3][j] = fmaf(g.w, v, acc[3][j]);
            }
        }
    }

    // columns beyond A-1 of the xa design are zero and are not written;
    // column A-1 (the design's first zero column) gives the output's 0
    float* ob = out + (long long)blockIdx.x * (K + 1) * A;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int k = k0 + 4 * kg + i;
        if (k >= K) continue;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            const int c = CPT * g2 + j;
            if (c < A && !(NX && c == 2 * D))
                ob[(long long)k * A + c] = acc[i][j];
        }
    }
    if (NX && tid < KT && k0 + tid < K)       // the exact occupancy column
        ob[(long long)(k0 + tid) * A + 2 * D] = nacc;

    if (blockIdx.y == 0) {
        // row K: sum w*llk and sum w over the chunk, in a fixed order
        // (strided per-thread sums, then a fixed shared-memory tree)
        float* sred = sm + S::RED;
        float sl = 0.f, sw = 0.f;
        for (long long t = f0 + tid; t < f1; t += NT) {
            const float wt = w[t];
            if (wt != 0.f) {
                sl = fmaf(wt, llk[t], sl);
                sw += wt;
            }
        }
        __syncthreads();
        sred[tid] = sl;
        sred[NT + tid] = sw;
        __syncthreads();
        for (int h = NT / 2; h > 0; h >>= 1) {
            if (tid < h) {
                sred[tid] += sred[tid + h];
                sred[NT + tid] += sred[NT + tid + h];
            }
            __syncthreads();
        }
        float* row = ob + (long long)K * A;
        for (int c = tid; c < A; c += NT)
            row[c] = c == 0 ? sred[0] : (c == 1 ? sred[NT] : 0.f);
    }
}

// out[j] = sum_c partials[c, j], c = 0 .. n_chunks-1 in order.
__global__ void reduce_chunks_kernel(const float* __restrict__ partials,
                                     int n_chunks, long long m,
                                     float* __restrict__ out) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= m) return;
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += partials[(long long)c * m + j];
    out[j] = s;
}

template <int CPT, bool FM, bool NX>
cudaError_t launch_llk_and_stats(const float* x, const float* w,
                                 const float* bt, long long n_frames,
                                 int chunk_len, int n_chunks, int K, int D,
                                 float* llk, float* m, float* s, float* out,
                                 cudaStream_t st) {
    constexpr bool TIER = FM || NX;
    constexpr size_t llk_bytes = Smem<CPT, false>::BYTES;
    constexpr size_t stats_bytes = Smem<CPT, NX>::BYTES;
    cudaError_t e = cudaFuncSetAttribute(
        frame_llk_kernel<CPT, FM, TIER>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)llk_bytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(stats_kernel<CPT, FM, NX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)stats_bytes);
    if (e != cudaSuccess) return e;
    const unsigned llk_blocks = (unsigned)((n_frames + TB - 1) / TB);
    frame_llk_kernel<CPT, FM, TIER><<<llk_blocks, NT, llk_bytes, st>>>(
        x, w, bt, n_frames, K, D, llk, m, s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    dim3 grid((unsigned)n_chunks, (unsigned)((K + KT - 1) / KT));
    stats_kernel<CPT, FM, NX><<<grid, NT, stats_bytes, st>>>(
        x, w, llk, m, s, bt, n_frames, chunk_len, K, D, out);
    return cudaGetLastError();
}

// CPT = design columns per thread; 16*CPT >= A = 2D+2.
template <bool FM, bool NX>
cudaError_t dispatch_cpt(const float* x, const float* w, const float* bt,
                         long long n_frames, int chunk_len, int n_chunks,
                         int K, int D, float* llk, float* m, float* s,
                         float* out, cudaStream_t st) {
    const int A = 2 * D + 2;
    if (A <= 32)
        return launch_llk_and_stats<2, FM, NX>(x, w, bt, n_frames, chunk_len,
                                               n_chunks, K, D, llk, m, s, out,
                                               st);
    if (A <= 48)
        return launch_llk_and_stats<3, FM, NX>(x, w, bt, n_frames, chunk_len,
                                               n_chunks, K, D, llk, m, s, out,
                                               st);
    if (A <= 80)
        return launch_llk_and_stats<5, FM, NX>(x, w, bt, n_frames, chunk_len,
                                               n_chunks, K, D, llk, m, s, out,
                                               st);
    if (A <= 144)
        return launch_llk_and_stats<9, FM, NX>(x, w, bt, n_frames, chunk_len,
                                               n_chunks, K, D, llk, m, s, out,
                                               st);
    return cudaErrorInvalidValue;
}

// tier: 0 default, 1 fastStats, 2 fastMath, 3 fastMath + fastStats.
// m and s (n_frames each) are scratch for tiers 1-3 and unused by tier 0.
cudaError_t dispatch(const float* x, const float* w, const float* bt,
                     long long n_frames, int chunk_len, int n_chunks, int K,
                     int D, int tier, float* llk, float* m, float* s,
                     float* out, cudaStream_t st) {
    if (D <= 0 || K <= 0 || n_frames <= 0 || chunk_len <= 0)
        return cudaErrorInvalidValue;
    if (tier != 0 && (m == nullptr || s == nullptr))
        return cudaErrorInvalidValue;
    switch (tier) {
    case 0:
        return dispatch_cpt<false, false>(x, w, bt, n_frames, chunk_len,
                                          n_chunks, K, D, llk, m, s, out, st);
    case 1:
        return dispatch_cpt<false, true>(x, w, bt, n_frames, chunk_len,
                                         n_chunks, K, D, llk, m, s, out, st);
    case 2:
        return dispatch_cpt<true, false>(x, w, bt, n_frames, chunk_len,
                                         n_chunks, K, D, llk, m, s, out, st);
    case 3:
        return dispatch_cpt<true, true>(x, w, bt, n_frames, chunk_len,
                                        n_chunks, K, D, llk, m, s, out, st);
    default:
        return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// K1.  x (n_frames, D), w (n_frames,), bt (2D+1, K) = the rows
// [-1/2 ivar; mu ivar; cst] of B (fastStats: all three times log2e;
// fastMath: [bf16(log2e * (-1/2 ivar)); bf16(log2e * mu ivar);
// log2e * cst]).  Scratch: llk, m, s (n_frames,
// each; m and s only for tiers 1-3), partials (n_chunks, K+1, A) with
// n_chunks = ceil(n_frames / chunk_len).  out: (K+1, A).
int lia_em_stats(const void* x, const void* w, const void* bt,
                 long long n_frames, int D, int K, int chunk_len, int tier,
                 void* llk, void* m, void* s, void* partials, void* out,
                 void* stream) {
    if (chunk_len <= 0) return (int)cudaErrorInvalidValue;
    const int n_chunks = (int)((n_frames + chunk_len - 1) / chunk_len);
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = dispatch((const float*)x, (const float*)w,
                             (const float*)bt, n_frames, chunk_len,
                             n_chunks, K, D, tier, (float*)llk, (float*)m,
                             (float*)s, (float*)partials, st);
    if (e != cudaSuccess) return (int)e;
    const long long mm = (long long)(K + 1) * (2 * D + 2);
    reduce_chunks_kernel<<<(unsigned)((mm + NT - 1) / NT), NT, 0, st>>>(
        (const float*)partials, n_chunks, mm, (float*)out);
    return (int)cudaGetLastError();
}

// K2.  x (S, T, D), w (S, T), bt and tier as above.  Scratch: llk, m, s
// (S*T,).  out: (S, K+1, A); one chunk per utterance.
int lia_bw_stats(const void* x, const void* w, const void* bt, int S,
                 int T, int D, int K, int tier, void* llk, void* m, void* s,
                 void* out, void* stream) {
    return (int)dispatch((const float*)x, (const float*)w,
                         (const float*)bt, (long long)S * T, T, S, K, D,
                         tier, (float*)llk, (float*)m, (float*)s,
                         (float*)out, (cudaStream_t)stream);
}

}  // extern "C"
