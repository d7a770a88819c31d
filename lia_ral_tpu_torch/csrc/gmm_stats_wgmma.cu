// GMM EM / Baum-Welch sufficient statistics for Hopper (sm_90a) on the
// tensor cores (wgmma, bf16 operands, f32 accumulators).
//
// Replaces the two Pallas TPU kernels of lia_ral_tpu/gmm/pallas_kernels.py:
//   K1  em_stats_fused  (_em_stats_kernel, pallas_call at :314)
//   K2  bw_stats_fused  (_bw_stats_kernel, pallas_call at :476)
//
// What is computed, as the TPU kernels compute it in their default mode
// (mxu_precision="bf16x3", exp_mode="exp2", stats_pass="x3") and in the
// fastStats / fastMath tiers.  Per frame t and component k the base-2
// logit ld = xa_t . B_k with the augmented design
//   xa_t = [x_t^2 (D), x_t (D), 1, 0 ...]                 (WP columns)
//   B_k  = log2(e) [-1/2 ivar_k (D), mu_k ivar_k (D), cst_k, 0 ...]
// then p = 2^(ld - m_t) with m_t the frame's largest logit, the frame's
// scale s_t = w_t / sum_k p, llk_t = ln(sum_k p) + m_t ln 2, and the stats
//   S_k = sum_t p_tk (xa_t s_t)  =  [sum_xx (D), sum_x (D), n, 0 ...].
// Output block (K+1, A), A = 2D+2; row K holds [sum w llk, sum w, 0 ...].
// Tiers (tier id = 2 fastMath + 1 fastStats):
//   default    both products as three bf16 passes: each operand v is split
//              into hi = bf16(v), lo = bf16(v - hi), and the product is
//              hi.hi + hi.lo + lo.hi in f32 (pallas_kernels.py:152-163,
//              :172, :202).  cst rides the constant-1 column of B.
//   fastStats  logits as above; the stats product is one pass on bf16(p)
//              and bf16(xa s), and the occupancy column is the exact f32
//              sum_t p s_t instead (:89-98).
//   fastMath   logits in one pass on bf16(xa) and bf16(B), cst added in
//              f32 after the product (:165-176); the stats product is one
//              pass on bf16(p) and bf16(xa s) too, as the TPU's matrix unit
//              runs an f32 product at default precision (:300-301, :203-206),
//              and the occupancy is that product's column 2D.
//   both       fastMath logits with fastStats stats.
//
// What bounds it on this card.  4 N K A flops in two chained products
// against N D 4 bytes of frames: at K = 2048 that is ~8000 flops a byte,
// so the tensor cores bound it (three bf16 passes at 989 TFLOP/s), then
// the exponentials (one per pair and pass over the logits), never HBM
// (the operand tiles add 640 bytes a frame of scratch traffic, read from
// L2).
// An earlier SIMT f32 design of these kernels could not pass the CUDA
// cores' 67 TFLOP/s.  The design here is the forward pass of a Hopper
// attention kernel with components in the place of queries and frames in
// the place of keys; the softmax runs over the component axis, so the
// normaliser needs a pass of its own:
//   prep_kernel    once per call: B from (weights, means, cov_inv) as bf16
//                  hi and lo tiles of 64 components, stored in the order
//                  the shared-memory operand wants (8 x 8 core matrices,
//                  depth padded to a multiple of 16), plus the f32 vector
//                  that is added to the logits (the fastMath cst; -1e30 on
//                  the rows that pad K to a multiple of 64, so a padded
//                  component gives p = 0 exactly and needs no mask).
//   llk_kernel     a CTA of two warpgroups takes 2 TF frames, builds xa hi
//                  and lo once (square in f32, then split), and each
//                  warpgroup walks all K in 64-component tiles streamed
//                  through its own two-stage cp.async ring, meeting only
//                  its own barrier.  Per tile it issues the wgmma (64
//                  components as M) x (TF frames as N) and folds the tile
//                  into a per-thread online (max, sum 2^).  At the end the
//                  partials are merged in a fixed order: a shuffle tree
//                  over the 8 row lanes, then the 4 warps through shared
//                  memory.  Writes m, s, llk per frame.
//   tiles_kernel   builds the stats pass's operand tiles once per call,
//                  in the order its shared memory holds them: xa hi/lo
//                  (the same routine and bits as in llk_kernel) and
//                  xs = xa s hi/lo, frame-contiguous.  Built inside the
//                  stats pass, the same tile was rebuilt by each of the
//                  K/128 component blocks, and that, not the products,
//                  took two thirds of its time.
//   stats_kernel   one block per (frame chunk, 128-component block),
//                  component blocks fastest so that the blocks of a chunk
//                  read its tiles from L2 together.  Each warpgroup keeps
//                  its 64-component B tile in shared memory; the tiles of
//                  the chunk are streamed through a two-stage cp.async
//                  ring.  The logits are recomputed with the same wgmma
//                  sequence on the same operand bits as in llk_kernel,
//                  p = 2^(ld - m) is formed in registers, split into bf16
//                  hi/lo in registers and fed as the register A operand of
//                  the second wgmma (64 components x TF frames of depth x
//                  NS design columns) against xs.  The posterior never
//                  touches shared or device memory.
// In both passes the two warpgroups of a block take turns at the tensor
// cores (named barriers): left alone they run in step, and the products
// then wait for the exponentials and the packing instead of running
// under them.
// What was measured on the H100 (PERF.md has the numbers): the products
// run at about three quarters of the tensor cores' rate; a wgmma with
// both operands in shared memory reads 6 KB for 64 x 128 x 16, which at
// M = 64 puts shared-memory bandwidth close behind the tensor cores, and
// smaller frame tiles make it worse.
// No float atomics and no ordered grid: K2's CTA owns (utterance, component
// block); K1 writes per-chunk partials that reduce_chunks_kernel adds in
// chunk order (a single chunk writes the output directly).  Every sum has
// a fixed order, so reruns reproduce every digit.
// A frame with zero weight (or beyond the ragged edge) gets m = +inf and
// s = 0, so p = 0 and xs = 0: it adds exactly 0 to every statistic.
//
// Shapes: D <= 64, any K, any N / T.  The depth of the logit product and
// K are run-time loops; only the stats product's width NS (an instruction
// shape) and the frame tile are compiled in: (NS, TF) = (16, 128) for
// D <= 7, (80, 128) for D <= 39, (144, 64) for D <= 64.
//
// Plain C interface, bound with ctypes.  Each entry point launches on the
// given stream and returns cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "wgmma_ops.cuh"

namespace {

constexpr int NT = 256;             // two warpgroups
constexpr int KT = 64;              // components per wgmma tile (its M)
constexpr float PAD_LOGIT = -1e30f;
constexpr float LOG2E_F = 1.4426950408889634f;
constexpr double LOG2E_D = 1.4426950408889634;
constexpr float LN2_F = 0.6931471805599453f;

__host__ __device__ constexpr int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}
__host__ __device__ constexpr long long align256(long long v) {
    return (v + 255) / 256 * 256;
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack2(float a, float b) {
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);     // a in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16r(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void fence_async_proxy() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- prep: B tiles and the additive logit vector --------------------------
// bprep: (Kpad/64) tiles of [hi 64 x WP][lo 64 x WP] bf16.  Element (r, c)
// of a 64 x WP operand sits at core matrix (c/8, r/8) (row groups fastest)
// of 64 elements, row r%8, column c%8: LBO = 8 * 128 bytes, SBO = 128 bytes.
__global__ void prep_kernel(const float* __restrict__ weights,
                            const float* __restrict__ means,
                            const float* __restrict__ cov_inv, int K, int D,
                            int WP, int tier, bf16* __restrict__ bprep,
                            float* __restrict__ cstv) {
    const int tile = blockIdx.x;
    const bool fm = tier >= 2;
    __shared__ float s_cst[KT];
    if (threadIdx.x < KT) {
        const int k = tile * KT + threadIdx.x;
        float c2 = 0.f;
        if (k < K) {
            // cst_k = log w_k - 1/2 (D log 2pi - sum log ivar) - 1/2 sum mu^2 ivar
            double acc = 0.0;
            for (int d = 0; d < D; ++d) {
                const double iv = cov_inv[(long long)k * D + d];
                const double mu = means[(long long)k * D + d];
                acc += log(iv) - mu * mu * iv;
            }
            double cst = log((double)weights[k])
                         + 0.5 * (acc - D * 1.8378770664093453);
            cst *= LOG2E_D;
            c2 = (float)fmax(cst, (double)PAD_LOGIT);
        }
        s_cst[threadIdx.x] = c2;
        cstv[k] = k < K ? (fm ? c2 : 0.f) : PAD_LOGIT;
    }
    __syncthreads();
    bf16* hi = bprep + (long long)tile * 2 * KT * WP;
    bf16* lo = hi + KT * WP;
    for (int i = threadIdx.x; i < KT * WP; i += blockDim.x) {
        const int r = i % KT, c = i / KT, k = tile * KT + r;
        float v = 0.f;
        if (k < K) {
            if (c < D) {
                v = __fmul_rn(-0.5f * cov_inv[(long long)k * D + c], LOG2E_F);
            } else if (c < 2 * D) {
                const long long j = (long long)k * D + (c - D);
                v = __fmul_rn(__fmul_rn(means[j], cov_inv[j]), LOG2E_F);
            } else if (c == 2 * D && !fm) {
                v = s_cst[r];
            }
        }
        const bf16 h = __float2bfloat16_rn(v);
        const int off = ((c / 8) * 8 + r / 8) * 64 + (r % 8) * 8 + (c % 8);
        hi[off] = h;
        lo[off] = __float2bfloat16_rn(v - __bfloat162float(h));
    }
}

// ---- frame tiles ----------------------------------------------------------
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Asynchronous copy of frames [t0, t0 + tf) into sX[t * D + d] =
// x[t0 + t][d], zero beyond f_end: 16 bytes a thread where the tile starts
// on a 16-byte boundary (always in K1, whose chunks are multiples of the
// tile; an utterance of K2 may start anywhere), else 4.  All copies of a
// tile are in flight at once; the caller commits the group and waits.
__device__ __forceinline__ void issue_x_tile(const float* __restrict__ x,
                                             long long t0, long long f_end,
                                             int tf, int D, float* sX) {
    const int n = tf * D;
    const long long left = (f_end - t0) * D;
    const int avail = left < n ? (left > 0 ? (int)left : 0) : n;
    const float* src = x + t0 * D;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int i = 4 * threadIdx.x; i < n; i += 4 * NT) {
            if (i + 4 <= avail) {
                cp_async16(sX + i, src + i);
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (i + e < n) sX[i + e] = i + e < avail ? src[i + e] : 0.f;
            }
        }
    } else {
        for (int i = threadIdx.x; i < n; i += NT) {
            if (i < avail) cp_async4(sX + i, src + i);
            else sX[i] = 0.f;
        }
    }
}

// column c of the augmented design of one staged frame
__device__ __forceinline__ float xa_val(const float* row, int c, int D) {
    if (c < D) return __fmul_rn(row[c], row[c]);
    if (c < 2 * D) return row[c - D];
    return c == 2 * D ? 1.f : 0.f;
}

// One 16-byte core-matrix row: hi = bf16(v) and, where the tier reads it,
// lo = bf16(v - hi).
__device__ __forceinline__ void store_split(const float (&v)[8], bool with_lo,
                                            bf16* hi, bf16* lo) {
    uint4 h;
    h.x = pack2(v[0], v[1]); h.y = pack2(v[2], v[3]);
    h.z = pack2(v[4], v[5]); h.w = pack2(v[6], v[7]);
    *reinterpret_cast<uint4*>(hi) = h;
    if (with_lo) {
        uint4 l;
        l.x = pack2(v[0] - bf16r(v[0]), v[1] - bf16r(v[1]));
        l.y = pack2(v[2] - bf16r(v[2]), v[3] - bf16r(v[3]));
        l.z = pack2(v[4] - bf16r(v[4]), v[5] - bf16r(v[5]));
        l.w = pack2(v[6] - bf16r(v[6]), v[7] - bf16r(v[7]));
        *reinterpret_cast<uint4*>(lo) = l;
    }
}

// xa hi/lo for TF frames as the N operand of the logit product: element
// (t, c) at core matrix (c/8, t/8) (frame groups fastest), row t%8, column
// c%8: LBO = (TF/8) * 128 bytes, SBO = 128 bytes.  A thread writes one
// 16-byte core-matrix row; a warp writes 512 contiguous bytes.
template <int TF>
__device__ __forceinline__ void build_xa(const float* sX, int D, int WP,
                                         bool with_lo, bf16* xa_hi,
                                         bf16* xa_lo) {
    const int items = TF * (WP / 8);
    for (int it = threadIdx.x; it < items; it += NT) {
        const int t = it % TF, kc = it / TF;
        const float* row = sX + t * D;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = xa_val(row, kc * 8 + i, D);
        const int off = (kc * (TF / 8) + t / 8) * 64 + (t % 8) * 8;
        store_split(v, with_lo, xa_hi + off, xa_lo + off);
    }
}

// xs = xa * s hi/lo as the N operand of the stats product, NS design
// columns as rows and TF frames as depth: element (c, t) at core matrix
// (t/8, c/8) (column groups fastest), row c%8, column t%8:
// LBO = (NS/8) * 128 bytes, SBO = 128 bytes.
template <int NS, int TF>
__device__ __forceinline__ void build_xs(const float* sX, const float* sS,
                                         int D, bool with_lo, bf16* xs_hi,
                                         bf16* xs_lo) {
    const int items = NS * (TF / 8);
    for (int it = threadIdx.x; it < items; it += NT) {
        const int c = it % NS, fg = it / NS;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int t = fg * 8 + i;
            v[i] = __fmul_rn(xa_val(sX + t * D, c, D), sS[t]);
        }
        const int off = (fg * (NS / 8) + c / 8) * 64 + (c % 8) * 8;
        store_split(v, with_lo, xs_hi + off, xs_lo + off);
    }
}

template <int TF>
__device__ __forceinline__ void wgmma_logit_step(float (&d)[TF / 2],
                                                 uint64_t a, uint64_t b,
                                                 int scale_d) {
    if constexpr (TF == 128) wgmma_ss_n128(d, a, b, scale_d);
    else wgmma_ss_n64(d, a, b, scale_d);
}

template <int NS>
__device__ __forceinline__ void wgmma_stat_step(float (&d)[NS / 2],
                                                const uint32_t* a,
                                                uint64_t b) {
    if constexpr (NS == 16) wgmma_rs_n16(d, a[0], a[1], a[2], a[3], b, 1);
    else if constexpr (NS == 80) wgmma_rs_n80(d, a[0], a[1], a[2], a[3], b, 1);
    else wgmma_rs_n144(d, a[0], a[1], a[2], a[3], b, 1);
}

// The one logit routine both passes use: acc = B tile (64 x WP) . xa^T
// (WP x TF), as the passes hi.hi, hi.lo, lo.hi (or hi.hi alone) in this
// order, each over the depth steps in order.  Same instructions, same
// operand bits, so both passes see identical logits.  The products are
// issued and committed, not waited for (wgmma_done).
template <int TF>
__device__ __forceinline__ void logits_issue(float (&acc)[TF / 2],
                                       const bf16* b_hi, const bf16* b_lo,
                                       const bf16* xa_hi, const bf16* xa_lo,
                                       int WP, bool three) {
    constexpr uint32_t XA_LBO = (TF / 8) * 128;
    const uint32_t bh = smem_u32(b_hi), bl = smem_u32(b_lo);
    const uint32_t xh = smem_u32(xa_hi), xl = smem_u32(xa_lo);
    const int steps = WP / 16;
    wgmma_fence();
    for (int j = 0; j < steps; ++j)
        wgmma_logit_step<TF>(acc, smem_desc(bh + j * 2048, 1024, 128),
                             smem_desc(xh + j * 2 * XA_LBO, XA_LBO, 128),
                             j > 0);
    if (three) {
        for (int j = 0; j < steps; ++j)
            wgmma_logit_step<TF>(acc, smem_desc(bh + j * 2048, 1024, 128),
                                 smem_desc(xl + j * 2 * XA_LBO, XA_LBO, 128),
                                 1);
        for (int j = 0; j < steps; ++j)
            wgmma_logit_step<TF>(acc, smem_desc(bl + j * 2048, 1024, 128),
                                 smem_desc(xh + j * 2 * XA_LBO, XA_LBO, 128),
                                 1);
    }
    wgmma_commit();
}

// waits for the products issued so far; acc is then valid
template <int N>
__device__ __forceinline__ void wgmma_done(float (&acc)[N]) {
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < N; ++i) keep_reg(acc[i]);
}

// (m, s) <- merge of two (max, sum 2^(. - max)) partials
__device__ __forceinline__ void merge_ms(float& m, float& s, float m2,
                                         float s2) {
    const float mn = fmaxf(m, m2);
    s = s * exp2f(m - mn) + s2 * exp2f(m2 - mn);
    m = mn;
}

// ---- pass 1: per-frame m, s = w / sum 2^(ld - m), llk ---------------------
template <int TF>
struct LlkSmem {                    // byte offsets for a given WP
    int xa, b, cst, pm, ps, total;
    __host__ __device__ LlkSmem(int WP) {
        xa = 0;                                  // [2 wg][hi, lo][TF x WP]
        b = xa + 2 * 2 * TF * WP * 2;            // [2 wg][2 buf][hi, lo][64 x WP]
        cst = b + 2 * 2 * 2 * KT * WP * 2;       // [2 wg][2 buf][64] f32
        pm = cst + 2 * 2 * KT * 4;               // [2 wg][4 warps][TF] f32
        ps = pm + 2 * 4 * TF * 4;
        total = ps + 2 * 4 * TF * 4;
        // the staged frames [TF][D] f32 lie over the B ring, which is
        // filled only after xa is built
    }
};

// barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// The two warpgroups take turns at the tensor cores: one issues its
// products while the other works on its last results (exponentials,
// packing), instead of both doing the same thing at the same time.
// turn_wait blocks until the other warpgroup has passed the turn;
// warpgroup 1 passes once before the first round, so warpgroup 0 starts.
__device__ __forceinline__ void turn_wait(int wg) {
    asm volatile("bar.sync %0, 256;\n" ::"r"(wg + 3) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
}

template <int TF>
__global__ void __launch_bounds__(NT, 1)
llk_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const bf16* __restrict__ bprep, const float* __restrict__ cstv,
           long long n_frames, int n_ktiles, int D, int WP, int three,
           float* __restrict__ llk, float* __restrict__ m_out,
           float* __restrict__ s_out) {
    extern __shared__ uint4 smem_raw[];
    char* sm = reinterpret_cast<char*>(smem_raw);
    const LlkSmem<TF> L(WP);
    const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
    const int warp = wt / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
    const int op = TF * WP;                     // elements of one xa half
    bf16* sXA = reinterpret_cast<bf16*>(sm + L.xa);
    float* sX = reinterpret_cast<float*>(sm + L.b);
    const long long f0 = (long long)blockIdx.x * (2 * TF);

    for (int h = 0; h < 2; ++h) {               // xa of both warpgroups
        __syncthreads();
        issue_x_tile(x, f0 + h * TF, n_frames, TF, D, sX);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        build_xa<TF>(sX, D, WP, three, sXA + h * 2 * op,
                     sXA + h * 2 * op + op);
    }
    fence_async_proxy();
    __syncthreads();

    // From here the warpgroups run on their own: each streams the B tiles
    // through its own two-stage ring and meets only its own barrier, so
    // one's exponentials overlap the other's products.
    const int tile_elems = 2 * KT * WP;         // hi and lo of one B tile
    const int chunks = (three ? tile_elems : KT * WP) / 8;   // 16-byte pieces
    bf16* ring = reinterpret_cast<bf16*>(sm + L.b) + wg * 2 * tile_elems;
    float* cring = reinterpret_cast<float*>(sm + L.cst) + wg * 2 * KT;
    auto issue_b = [&](int j) {
        bf16* dst = ring + (j & 1) * tile_elems;
        const bf16* src = bprep + (long long)j * tile_elems;
        for (int i = wt; i < chunks; i += 128)
            cp_async16(dst + i * 8, src + i * 8);
        if (wt < KT / 4)
            cp_async16(cring + (j & 1) * KT + wt * 4,
                       cstv + (long long)j * KT + wt * 4);
        cp_async_commit();
    };
    issue_b(0);
    if (wg == 1) turn_pass(1);

    // this thread's frames: slot q = 2 (n8 block) + e is column
    // 8 (q/2) + 2c + q%2 of the warpgroup's tile; its rows: g and g + 8
    float mx[TF / 4], sx[TF / 4];
#pragma unroll
    for (int q = 0; q < TF / 4; ++q) {
        mx[q] = -CUDART_INF_F;
        sx[q] = 0.f;
    }
    const bf16* my_xa = sXA + wg * 2 * op;
    for (int j = 0; j < n_ktiles; ++j) {
        if (j + 1 < n_ktiles) {
            issue_b(j + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        fence_async_proxy();
        wg_sync(wg);
        const bf16* sB = ring + (j & 1) * tile_elems;
        const float* sC = cring + (j & 1) * KT;
        float acc[TF / 2];
        turn_wait(wg);
        logits_issue<TF>(acc, sB, sB + KT * WP, my_xa, my_xa + op, WP, three);
        turn_pass(wg);
        wgmma_done(acc);
        const float c0 = sC[16 * warp + g], c1 = sC[16 * warp + g + 8];
#pragma unroll
        for (int q = 0; q < TF / 4; ++q) {
            const int i = 4 * (q / 2) + (q % 2);
            const float v0 = acc[i] + c0, v1 = acc[i + 2] + c1;
            const float mn = fmaxf(mx[q], fmaxf(v0, v1));
            sx[q] = sx[q] * exp2f(mx[q] - mn) + exp2f(v0 - mn)
                    + exp2f(v1 - mn);
            mx[q] = mn;
        }
        wg_sync(wg);                // the tile's buffer may be refilled
    }

    // fixed-order merge: the 8 row lanes of a warp, then the 4 warps
    float* sPm = reinterpret_cast<float*>(sm + L.pm) + wg * 4 * TF;
    float* sPs = reinterpret_cast<float*>(sm + L.ps) + wg * 4 * TF;
#pragma unroll
    for (int q = 0; q < TF / 4; ++q) {
#pragma unroll
        for (int sh = 4; sh <= 16; sh <<= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, mx[q], sh);
            const float s2 = __shfl_xor_sync(0xffffffffu, sx[q], sh);
            merge_ms(mx[q], sx[q], m2, s2);
        }
        if (g == 0) {
            const int col = 8 * (q / 2) + 2 * c + (q % 2);
            sPm[warp * TF + col] = mx[q];
            sPs[warp * TF + col] = sx[q];
        }
    }
    __syncthreads();
    if (tid < 2 * TF) {
        const int h = tid / TF, col = tid % TF;
        const long long f = f0 + tid;
        if (f < n_frames) {
            const float* pm = reinterpret_cast<float*>(sm + L.pm) + h * 4 * TF;
            const float* ps = reinterpret_cast<float*>(sm + L.ps) + h * 4 * TF;
            float M = pm[col], S = ps[col];
            for (int wv = 1; wv < 4; ++wv)
                merge_ms(M, S, pm[wv * TF + col], ps[wv * TF + col]);
            llk[f] = logf(S) + M * LN2_F;
            // a zero-weight frame adds nothing: m = +inf makes its p = 0
            const float wf = w[f];
            m_out[f] = wf != 0.f ? M : CUDART_INF_F;
            s_out[f] = wf / S;
        }
    }
}

// ---- the operand tiles of the stats pass ----------------------------------
// Tile (chunk c, i) covers frames [c*chunk_len + i*TF, ... + TF) of chunk c
// (cut at the chunk's end).  Its operands, in the order the stats pass's
// shared memory holds them: [xa hi][xa lo] (TF x WP each) [xs hi][xs lo]
// (NS x TF each), bf16.
template <int NS, int TF>
__host__ __device__ constexpr int tile_elems(int WP) {
    return 2 * TF * WP + 2 * NS * TF;
}

// Builds every tile once (the stats grid reads each one from every
// component block).  Block c * tiles_per_chunk + i builds tile (c, i).
template <int NS, int TF>
__global__ void __launch_bounds__(NT)
tiles_kernel(const float* __restrict__ x, const float* __restrict__ s_in,
             long long n_frames, int chunk_len, int tiles_per_chunk, int D,
             int WP, int three_l, int three_s, bf16* __restrict__ tiles) {
    extern __shared__ uint4 smem_raw[];
    float* sX = reinterpret_cast<float*>(smem_raw);
    float* sS = sX + round_up(TF * D, 4);
    const long long f0 = (long long)(blockIdx.x / tiles_per_chunk) * chunk_len;
    const long long f1 = min(f0 + chunk_len, n_frames);
    const long long t0 = f0 + (long long)(blockIdx.x % tiles_per_chunk) * TF;
    if (t0 >= f1) return;
    issue_x_tile(x, t0, f1, TF, D, sX);
    cp_async_commit();
    for (int t = threadIdx.x; t < TF; t += NT)
        sS[t] = t0 + t < f1 ? s_in[t0 + t] : 0.f;
    cp_async_wait<0>();
    __syncthreads();
    bf16* dst = tiles + (long long)blockIdx.x * tile_elems<NS, TF>(WP);
    build_xa<TF>(sX, D, WP, three_l, dst, dst + TF * WP);
    dst += 2 * TF * WP;
    build_xs<NS, TF>(sX, sS, D, three_s, dst, dst + NS * TF);
}

// ---- pass 2: the statistics -----------------------------------------------
template <int NS, int TF>
struct StatsSmem {
    int b, cst, tile, s, m, red, total;
    __host__ __device__ StatsSmem(int WP) {
        b = 0;                                   // [2 wg][hi, lo][64 x WP]
        cst = b + 2 * 2 * KT * WP * 2;           // [2 wg][64] f32
        tile = cst + 2 * KT * 4;                 // [2 buf] operand tiles
        s = tile + 2 * tile_elems<NS, TF>(WP) * 2;   // [2 buf][TF] f32
        m = s + 2 * TF * 4;                      // [2 buf][TF] f32
        red = m + 2 * TF * 4;                    // [2][NT] f32
        total = red + 2 * NT * 4;
    }
};

// Frames of chunk c are [c*chunk_len, min((c+1)*chunk_len, n_frames)).
// out: (n_chunks, K+1, A).  Block c * k_blocks + j (component blocks
// fastest, so that the blocks of a chunk read its tiles together) writes
// rows [128 j, 128 j + 128) of chunk c (warpgroup h the rows 128 j + 64 h
// ...); the blocks with j == 0 also write row K.
template <int NS, int TF>
__global__ void __launch_bounds__(NT, 1)
stats_kernel(const float* __restrict__ w, const float* __restrict__ llk,
             const float* __restrict__ m_in, const float* __restrict__ s_in,
             const bf16* __restrict__ bprep, const float* __restrict__ cstv,
             const bf16* __restrict__ tiles, long long n_frames,
             int chunk_len, int tiles_per_chunk, int K, int n_ktiles,
             int k_blocks, int D, int WP, int three_l, int three_s, int nx,
             float* __restrict__ out) {
    extern __shared__ uint4 smem_raw[];
    char* sm = reinterpret_cast<char*>(smem_raw);
    const StatsSmem<NS, TF> L(WP);
    const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
    const int lane = tid % 32, g = lane / 4, c = lane % 4;
    const int A = 2 * D + 2;
    const int chunk = blockIdx.x / k_blocks, kblock = blockIdx.x % k_blocks;
    const long long f0 = (long long)chunk * chunk_len;
    const long long f1 = min(f0 + chunk_len, n_frames);
    const int ktile = kblock * 2 + wg;
    const bool has_tile = ktile < n_ktiles;      // uniform in the warpgroup
    const bool turns = kblock * 2 + 1 < n_ktiles;    // both have a tile

    bf16* sB = reinterpret_cast<bf16*>(sm + L.b) + wg * 2 * KT * WP;
    float* sC = reinterpret_cast<float*>(sm + L.cst) + wg * KT;
    bf16* sT = reinterpret_cast<bf16*>(sm + L.tile);
    float* sS = reinterpret_cast<float*>(sm + L.s);
    float* sM = reinterpret_cast<float*>(sm + L.m);
    const int te = tile_elems<NS, TF>(WP);

    if (has_tile) {
        const uint4* src = reinterpret_cast<const uint4*>(
            bprep + (long long)ktile * 2 * KT * WP);
        uint4* dst = reinterpret_cast<uint4*>(sB);
        for (int i = tid % 128; i < 2 * KT * WP / 8; i += 128) dst[i] = src[i];
        if (tid % 128 < KT) sC[tid % 128] = cstv[ktile * KT + tid % 128];
    }

    float acc[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
    float n0 = 0.f, n1 = 0.f;       // fastStats: exact sum_t p s, rows g, g+8

    // Tile i (operands, s, m) is copied into buffer i % 2 one tile ahead.
    const int n_tiles = (int)((f1 - f0 + TF - 1) / TF);
    const bf16* my_tiles = tiles + (long long)chunk * tiles_per_chunk * te;
    auto stage = [&](int i) {
        if (i < n_tiles) {
            const int b = i & 1;
            const bf16* src = my_tiles + (long long)i * te;
            bf16* dst = sT + b * te;
            // the halves a tier does not read were not written either
            const int xa_n = (three_l ? 2 : 1) * TF * WP;
            const int xs_n = (three_s ? 2 : 1) * NS * TF;
            for (int e = 8 * tid; e < xa_n; e += 8 * NT)
                cp_async16(dst + e, src + e);
            for (int e = 8 * tid; e < xs_n; e += 8 * NT)
                cp_async16(dst + 2 * TF * WP + e, src + 2 * TF * WP + e);
            const long long t0 = f0 + (long long)i * TF;
            for (int t = tid; t < TF; t += NT) {
                if (t0 + t < f1) {
                    cp_async4(sS + b * TF + t, s_in + t0 + t);
                    cp_async4(sM + b * TF + t, m_in + t0 + t);
                } else {
                    sS[b * TF + t] = 0.f;
                    sM[b * TF + t] = CUDART_INF_F;
                }
            }
        }
        cp_async_commit();
    };
    stage(0);
    if (turns && wg == 1) turn_pass(1);

    for (int i = 0; i < n_tiles; ++i) {
        const int b = i & 1;
        const bf16* xa = sT + b * te;
        const bf16* xs = xa + 2 * TF * WP;
        const float* sSb = sS + b * TF;
        const float* sMb = sM + b * TF;
        cp_async_wait<0>();
        fence_async_proxy();
        // tile i has landed; both warpgroups are done with tile i-1
        __syncthreads();
        stage(i + 1);
        if (!has_tile) continue;

        float ld[TF / 2];
        if (turns) turn_wait(wg);
        logits_issue<TF>(ld, sB, sB + KT * WP, xa, xa + TF * WP, WP, three_l);
        if (turns) turn_pass(wg);
        wgmma_done(ld);
        const float c0 = sC[16 * warp + g], c1 = sC[16 * warp + g + 8];
        // p = 2^(ld - m); fragment n of the A operand packs (p[2n],
        // p[2n+1]): depth step j uses fragments 4j .. 4j+3
        uint32_t ph[TF / 4], pl[TF / 4];
#pragma unroll
        for (int q = 0; q < TF / 8; ++q) {       // n8 block of frames
            const float2 mv = *reinterpret_cast<const float2*>(
                sMb + 8 * q + 2 * c);
            const float p00 = exp2f(ld[4 * q] + c0 - mv.x);
            const float p01 = exp2f(ld[4 * q + 1] + c0 - mv.y);
            const float p10 = exp2f(ld[4 * q + 2] + c1 - mv.x);
            const float p11 = exp2f(ld[4 * q + 3] + c1 - mv.y);
            if (nx) {
                const float2 sv = *reinterpret_cast<const float2*>(
                    sSb + 8 * q + 2 * c);
                n0 = fmaf(p01, sv.y, fmaf(p00, sv.x, n0));
                n1 = fmaf(p11, sv.y, fmaf(p10, sv.x, n1));
            }
            ph[2 * q] = pack2(p00, p01);
            ph[2 * q + 1] = pack2(p10, p11);
            if (three_s) {
                pl[2 * q] = pack2(p00 - bf16r(p00), p01 - bf16r(p01));
                pl[2 * q + 1] = pack2(p10 - bf16r(p10), p11 - bf16r(p11));
            }
        }
        constexpr uint32_t XS_LBO = (NS / 8) * 128;
        const uint32_t xh = smem_u32(xs), xl = smem_u32(xs + NS * TF);
        if (turns) turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < TF / 16; ++j)
            wgmma_stat_step<NS>(acc, ph + 4 * j,
                                smem_desc(xh + j * 2 * XS_LBO, XS_LBO, 128));
        if (three_s) {
#pragma unroll
            for (int j = 0; j < TF / 16; ++j)
                wgmma_stat_step<NS>(acc, ph + 4 * j,
                                    smem_desc(xl + j * 2 * XS_LBO, XS_LBO,
                                              128));
#pragma unroll
            for (int j = 0; j < TF / 16; ++j)
                wgmma_stat_step<NS>(acc, pl + 4 * j,
                                    smem_desc(xh + j * 2 * XS_LBO, XS_LBO,
                                              128));
        }
        wgmma_commit();
        if (turns) turn_pass(wg);
        wgmma_done(acc);
#pragma unroll
        for (int q = 0; q < TF / 4; ++q) {
            keep_reg(ph[q]);
            if (three_s) keep_reg(pl[q]);
        }
    }
    cp_async_wait<0>();

    float* ob = out + (long long)chunk * (K + 1) * A;
    if (has_tile) {
        // the exact occupancy: the 4 column lanes of a row, fixed tree
        n0 += __shfl_xor_sync(0xffffffffu, n0, 1);
        n0 += __shfl_xor_sync(0xffffffffu, n0, 2);
        n1 += __shfl_xor_sync(0xffffffffu, n1, 1);
        n1 += __shfl_xor_sync(0xffffffffu, n1, 2);
        // design columns beyond A-1 are zero and not written; column A-1
        // (the design's first zero column) gives the output's 0
#pragma unroll
        for (int i = 0; i < NS / 2; i += 2) {
            const int row = ktile * KT + 16 * warp + g + 8 * ((i / 2) % 2);
            const int col = 8 * (i / 4) + 2 * c;
            if (row < K && col < A) {
                float2 v = make_float2(acc[i], acc[i + 1]);
                if (nx && col == 2 * D) v.x = (i / 2) % 2 ? n1 : n0;
                *reinterpret_cast<float2*>(ob + (long long)row * A + col) = v;
            }
        }
    }

    if (kblock == 0) {
        // row K: sum w*llk and sum w over the chunk, in a fixed order
        // (strided per-thread sums, then a fixed shared-memory tree)
        float* sred = reinterpret_cast<float*>(sm + L.red);
        float sl = 0.f, sw = 0.f;
        for (long long t = f0 + tid; t < f1; t += NT) {
            const float wt = w[t];
            if (wt != 0.f) {
                sl = fmaf(wt, llk[t], sl);
                sw += wt;
            }
        }
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
        for (int cc = tid; cc < A; cc += NT)
            row[cc] = cc == 0 ? sred[0] : (cc == 1 ? sred[NT] : 0.f);
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

// ---- host side ------------------------------------------------------------
// (NS, TF) of a feature dim's kernels, chosen as run() does
struct Shape {
    int WP, NS, TF;
    explicit Shape(int D) {
        WP = round_up(2 * D + 1, 16);
        NS = WP <= 16 ? 16 : (WP <= 80 ? 80 : 144);
        TF = WP <= 80 ? 128 : 64;
    }
    int tile_elems() const { return 2 * TF * WP + 2 * NS * TF; }
};

struct Scratch {                    // byte offsets into the one scratch buffer
    long long bprep, cstv, llk, m, s, tiles, partials, total;
    int tiles_per_chunk;
    Scratch(long long n_frames, int D, int K, int chunk_len, int n_chunks,
            bool with_partials) {
        const Shape sh(D);
        const int Kpad = round_up(K, KT);
        tiles_per_chunk = (chunk_len + sh.TF - 1) / sh.TF;
        bprep = 0;
        cstv = bprep + align256((long long)Kpad * sh.WP * 2 * 2);
        llk = cstv + align256((long long)Kpad * 4);
        m = llk + align256(n_frames * 4);
        s = m + align256(n_frames * 4);
        tiles = s + align256(n_frames * 4);
        partials = tiles + align256((long long)n_chunks * tiles_per_chunk
                                    * sh.tile_elems() * 2);
        total = partials + (with_partials
            ? align256((long long)n_chunks * (K + 1) * (2 * D + 2) * 4) : 0);
    }
};

template <int TF>
cudaError_t launch_llk(const float* x, const float* w, const bf16* bprep,
                       const float* cstv, long long n_frames, int n_ktiles,
                       int D, int WP, int three, float* llk, float* m,
                       float* s, cudaStream_t st) {
    const LlkSmem<TF> L(WP);
    cudaError_t e = cudaFuncSetAttribute(
        llk_kernel<TF>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)((n_frames + 2 * TF - 1) / (2 * TF));
    llk_kernel<TF><<<blocks, NT, L.total, st>>>(x, w, bprep, cstv, n_frames,
                                                n_ktiles, D, WP, three, llk,
                                                m, s);
    return cudaGetLastError();
}

template <int NS, int TF>
cudaError_t launch_stats(const float* x, const float* w, const float* llk,
                         const float* m, const float* s, const bf16* bprep,
                         const float* cstv, bf16* tiles, long long n_frames,
                         int chunk_len, int n_chunks, int tiles_per_chunk,
                         int K, int n_ktiles, int D, int WP, int three_l,
                         int three_s, int nx, float* out, cudaStream_t st) {
    const int tiles_smem = (round_up(TF * D, 4) + TF) * 4;
    cudaError_t e = cudaFuncSetAttribute(
        tiles_kernel<NS, TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tiles_smem);
    if (e != cudaSuccess) return e;
    tiles_kernel<NS, TF><<<(unsigned)((long long)n_chunks * tiles_per_chunk),
                           NT, tiles_smem, st>>>(
        x, s, n_frames, chunk_len, tiles_per_chunk, D, WP, three_l, three_s,
        tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const StatsSmem<NS, TF> L(WP);
    e = cudaFuncSetAttribute(
        stats_kernel<NS, TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.total);
    if (e != cudaSuccess) return e;
    const int k_blocks = (n_ktiles + 1) / 2;
    stats_kernel<NS, TF><<<(unsigned)((long long)n_chunks * k_blocks), NT,
                           L.total, st>>>(
        w, llk, m, s, bprep, cstv, tiles, n_frames, chunk_len,
        tiles_per_chunk, K, n_ktiles, k_blocks, D, WP, three_l, three_s, nx,
        out);
    return cudaGetLastError();
}

// prep, llk pass, tiles and stats pass.  out: (n_chunks, K+1, A).
cudaError_t run(const float* x, const float* w, const float* weights,
                const float* means, const float* cov_inv, long long n_frames,
                int chunk_len, int n_chunks, int K, int D, int tier,
                char* scratch, const Scratch& sc, float* out,
                cudaStream_t st) {
    if (D <= 0 || D > 64 || K <= 0 || n_frames <= 0 || chunk_len <= 0
        || tier < 0 || tier > 3)
        return cudaErrorInvalidValue;
    const Shape sh(D);
    const int WP = sh.WP, n_ktiles = (K + KT - 1) / KT;
    const int three_l = tier < 2, three_s = tier == 0, nx = tier & 1;
    bf16* bprep = reinterpret_cast<bf16*>(scratch + sc.bprep);
    float* cstv = reinterpret_cast<float*>(scratch + sc.cstv);
    float* llk = reinterpret_cast<float*>(scratch + sc.llk);
    float* m = reinterpret_cast<float*>(scratch + sc.m);
    float* s = reinterpret_cast<float*>(scratch + sc.s);
    bf16* tiles = reinterpret_cast<bf16*>(scratch + sc.tiles);
    prep_kernel<<<n_ktiles, 256, 0, st>>>(weights, means, cov_inv, K, D, WP,
                                          tier, bprep, cstv);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = sh.TF == 128 ? launch_llk<128>(x, w, bprep, cstv, n_frames, n_ktiles,
                                       D, WP, three_l, llk, m, s, st)
                     : launch_llk<64>(x, w, bprep, cstv, n_frames, n_ktiles,
                                      D, WP, three_l, llk, m, s, st);
    if (e != cudaSuccess) return e;
    if (sh.NS == 16)
        return launch_stats<16, 128>(x, w, llk, m, s, bprep, cstv, tiles,
                                     n_frames, chunk_len, n_chunks,
                                     sc.tiles_per_chunk, K, n_ktiles, D, WP,
                                     three_l, three_s, nx, out, st);
    if (sh.NS == 80)
        return launch_stats<80, 128>(x, w, llk, m, s, bprep, cstv, tiles,
                                     n_frames, chunk_len, n_chunks,
                                     sc.tiles_per_chunk, K, n_ktiles, D, WP,
                                     three_l, three_s, nx, out, st);
    return launch_stats<144, 64>(x, w, llk, m, s, bprep, cstv, tiles,
                                 n_frames, chunk_len, n_chunks,
                                 sc.tiles_per_chunk, K, n_ktiles, D, WP,
                                 three_l, three_s, nx, out, st);
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer a call needs: the prepared B tiles, the
// per-frame llk, m and s, the operand tiles of the stats pass, and the
// per-chunk partials when there is more than one chunk.  K2 passes
// chunk_len = T and n_chunks = S.
long long lia_stats_scratch_bytes(long long n_frames, int D, int K,
                                  int chunk_len, int n_chunks,
                                  int with_partials) {
    return Scratch(n_frames, D, K, chunk_len, n_chunks,
                   with_partials != 0).total;
}

// K1.  x (n_frames, D), w (n_frames,), the GMM as weights (K,), means and
// cov_inv (K, D), all f32.  tier: 0 default, 1 fastStats, 2 fastMath,
// 3 both.  chunk_len frames go to each chunk of the stats grid; scratch as
// lia_stats_scratch_bytes says (with partials for more than one chunk).
// out: (K+1, A).
int lia_em_stats_wgmma(const void* x, const void* w, const void* weights,
                       const void* means, const void* cov_inv,
                       long long n_frames, int D, int K, int chunk_len,
                       int tier, void* scratch, void* out, void* stream) {
    if (chunk_len <= 0 || n_frames <= 0 || D <= 0 || D > 64)
        return (int)cudaErrorInvalidValue;
    const int n_chunks = (int)((n_frames + chunk_len - 1) / chunk_len);
    const Scratch sc(n_frames, D, K, chunk_len, n_chunks, n_chunks > 1);
    cudaStream_t st = (cudaStream_t)stream;
    float* partials = n_chunks > 1
        ? reinterpret_cast<float*>((char*)scratch + sc.partials)
        : (float*)out;
    cudaError_t e = run((const float*)x, (const float*)w,
                        (const float*)weights, (const float*)means,
                        (const float*)cov_inv, n_frames, chunk_len, n_chunks,
                        K, D, tier, (char*)scratch, sc, partials, st);
    if (e != cudaSuccess || n_chunks == 1) return (int)e;
    const long long mm = (long long)(K + 1) * (2 * D + 2);
    reduce_chunks_kernel<<<(unsigned)((mm + NT - 1) / NT), NT, 0, st>>>(
        partials, n_chunks, mm, (float*)out);
    return (int)cudaGetLastError();
}

// K2.  x (S, T, D), w (S, T); out: (S, K+1, A), one chunk per utterance.
int lia_bw_stats_wgmma(const void* x, const void* w, const void* weights,
                       const void* means, const void* cov_inv, int S, int T,
                       int D, int K, int tier, void* scratch, void* out,
                       void* stream) {
    if (S <= 0 || T <= 0 || D <= 0 || D > 64)
        return (int)cudaErrorInvalidValue;
    const long long n = (long long)S * T;
    const Scratch sc(n, D, K, T, S, false);
    return (int)run((const float*)x, (const float*)w, (const float*)weights,
                    (const float*)means, (const float*)cov_inv, n, T, S, K, D,
                    tier, (char*)scratch, sc, (float*)out,
                    (cudaStream_t)stream);
}

}  // extern "C"
