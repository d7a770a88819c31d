// GMM EM / Baum-Welch sufficient statistics for Hopper (sm_90a) on the
// tensor cores (wgmma, bf16 operands, f32 accumulators).
//
// Replaces the two Pallas TPU kernels of lia_ral_tpu/gmm/pallas_kernels.py:
//   K1  em_stats_fused  (_em_stats_kernel, pallas_call at :314)
//   K2  bw_stats_fused  (_bw_stats_kernel, pallas_call at :476)
//
// What is computed.  Per frame t and component k the logit
// ld = xa_t . B_k with the augmented design
//   xa_t = [x_t^2 (D), x_t (D), 1, 0 ...]                 (WP columns)
//   B_k  = c [-1/2 ivar_k (D), mu_k ivar_k (D), cst_k, 0 ...]
// (c = log2(e) in the base-2 modes, 1 in "exp"), then p = e(ld - m_t) with
// m_t the frame's largest logit and e the mode's exponential, the frame's
// scale s_t = w_t / sum_k p, llk_t = ln(sum_k p) + m_t (ln 2 in base 2),
// and the stats
//   S_k = sum_t p_tk (xa_t s_t)  =  [sum_xx (D), sum_x (D), n, 0 ...].
// Output block (K+1, A), A = 2D+2; row K holds [sum w llk, sum w, 0 ...].
//
// The arithmetic is the mode the JAX kernel's static arguments choose
// (gmm/cuda_kernels.py's check_mode; line numbers of pallas_kernels.py):
//   logit passes  3 (mxu_precision "bf16x3"/"high", :152-172): each operand
//                 v split into hi = bf16(v), lo = bf16(v - hi); hi.hi +
//                 hi.lo + lo.hi in f32; cst rides the constant-1 column of
//                 B (:307-312).
//                 6 ("highest", :173-176): three pieces hi, mid = bf16(v -
//                 hi), lo = bf16(v - hi - mid); hi.hi + hi.mid + mid.hi +
//                 hi.lo + mid.mid + lo.hi in f32, XLA's HIGHEST on the TPU;
//                 cst added in f32 after the product.
//                 1 ("default" or compute_dtype=bf16, :174-176, :300-301):
//                 bf16(xa) . bf16(B), cst added in f32 after the product.
//   exponential   exp2 (:125-127): exp2f.  exp (:122-124): expf, B and cst
//                 unscaled (prep rounds the unscaled B).  fast2 (:48-62,
//                 :128-130): _fast_exp2's clamp, floor, degree-4
//                 polynomial and exponent shift, one rounded operation at
//                 a time.  The llk pass rescales its running sums with
//                 exp2f (expf in "exp"); fast2's p are the polynomial's.
//   stats form    the products of p pieces (registers) with xa s pieces
//                 (the operand tiles): "1" bf16(p).bf16(xa s) (:89-90,
//                 :203-206 at one pass); "2p" hi(p).bf16 + lo(p).bf16
//                 (:99-102); "2x" bf16(p).hi + bf16(p).lo (:103-106); "3"
//                 the three passes above (:201-202); "6" the six passes;
//                 "sr" p and xa s rounded to bf16 stochastically, one pass
//                 (:188-198).  nx: the occupancy column is the exact f32
//                 sum_t p s_t instead (stats_pass "bf16nx", :91-97).
//   The four tiers are (3, exp2, "3"), fastStats (3, exp2, "1", nx),
//   fastMath (1, exp2, "1") and fastMath+fastStats (1, exp2, "1", nx).
// Stochastic rounding: the TPU's hardware PRNG cannot be reproduced, so the
// bits come from Philox4x32-10 (the low 16 bits of a word), key (seed mod
// 2^32, seed div 2^32), on the global frame index f (K2: utterance * T +
// t).  p (operand 0): the counter (f div 2 as two words, component k with
// bit 3 cleared, 0), word (f mod 2) + 2 (bit 3 of k): one counter gives
// the four elements a thread of the stats pass holds (frames f, f+1 of
// components k, k+8).  xa s (operand 1): the counter (f as two words,
// design column div 4, 1), word column mod 4.  The bits are added to the
// f32 bit pattern and the low 16 bits cut off, as pltpu.stochastic_round
// does; sm_90 has no cvt.rs for bf16, so this happens in registers (p)
// and in build_xs (xa s).
//
// What bounds it on this card.  2 N K A flops per pass of the two chained
// products against N D 4 bytes of frames: at K = 2048 that is ~8000 flops
// a byte in the default mode, so the tensor cores bound it (three bf16
// passes at 989 TFLOP/s), then the exponentials (one per pair and pass
// over the logits), never HBM (the operand tiles add 320-960 bytes a frame
// of scratch traffic, by mode, read from L2).
// An earlier SIMT f32 design of these kernels could not pass the CUDA
// cores' 67 TFLOP/s.  The design here is the forward pass of a Hopper
// attention kernel with components in the place of queries and frames in
// the place of keys; the softmax runs over the component axis, so the
// normaliser needs a pass of its own:
//   prep_kernel    once per call: B from (weights, means, cov_inv) as bf16
//                  pieces (1, 2 or 3 by the logit passes) of 64-component
//                  tiles, stored in the order the shared-memory operand
//                  wants (8 x 8 core matrices, depth padded to a multiple
//                  of 16), plus the f32 vector that is added to the logits
//                  (cst where it is not folded; -1e30 on the rows that pad
//                  K to a multiple of 64, so a padded component gives p = 0
//                  and needs no mask).
//   llk_kernel     a CTA of two warpgroups takes 2 TF frames, builds the xa
//                  pieces once (square in f32, then split), and each
//                  warpgroup walks all K in 64-component tiles streamed
//                  through its own cp.async ring (two stages, one where two
//                  would not fit shared memory), meeting only its own
//                  barrier.  Per tile it issues the wgmma (64 components as
//                  M) x (TF frames as N) and folds the tile into a
//                  per-thread online (max, sum e).  At the end the
//                  partials are merged in a fixed order: a shuffle tree
//                  over the 8 row lanes, then the 4 warps through shared
//                  memory.  Writes m, s, llk per frame.
//   tiles_kernel   builds the stats pass's operand tiles once per call,
//                  in the order its shared memory holds them: the xa pieces
//                  (the same routine and bits as in llk_kernel) and the
//                  xs = xa s pieces, frame-contiguous.  Built inside the
//                  stats pass, the same tile was rebuilt by each of the
//                  K/128 component blocks, and that, not the products,
//                  took two thirds of its time.
//   stats_kernel   one block per (frame chunk, 128-component block),
//                  component blocks fastest so that the blocks of a chunk
//                  read its tiles from L2 together.  Each warpgroup keeps
//                  its 64-component B tile in shared memory; the tiles of
//                  the chunk are streamed through a cp.async ring (two
//                  stages, or one).  The logits are recomputed with the
//                  same wgmma sequence on the same operand bits as in
//                  llk_kernel, p = e(ld - m) is formed in registers, split
//                  (or rounded stochastically) into bf16 pieces in
//                  registers and fed as the register A operand of the
//                  second wgmma (64 components x TF frames of depth x NS
//                  design columns) against xs.  The posterior never touches
//                  shared or device memory.  One instance per (shape,
//                  exponential, p pieces): 1, 2, 3 or stochastic; the
//                  extra xs-lo pass of "2x" and "3" is a uniform branch.
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
// Grouped K1 (lia_em_stats_grouped_wgmma, the default tier only): S GMMs,
// each with its own frames, in one launch of each pass.  The rows' frames
// lie one after another, each row from a multiple of GROUP_UNIT frames, and
// a table maps each chunk of the stats grid and each GROUP_UNIT of frames
// to its row.  prep writes the S models' B; the llk, tiles and stats
// passes are the kernels above, each block reading its row's B; a per-row
// reduce adds each row's chunk partials in chunk order.  The grouped
// kernels share the device code above and are instances of their own, so
// the two entries above compile as they did.
// A frame with zero weight (or beyond the ragged edge) gets m = +inf and
// s = 0, so p = 0 (2^-120 in fast2, as _fast_exp2 clamps) and xs = 0: it
// adds exactly 0 to every statistic.
//
// Shapes: D <= 64, any K, any N / T.  The depth of the logit product and
// K are run-time loops; only the stats product's width NS (an instruction
// shape) and the frame tile are compiled in: (NS, TF) = (16, 128) for
// D <= 7, (80, 128) for D <= 39, (144, 64) for D <= 64.
//
// Plain C interface, bound with ctypes.  Each entry point launches on the
// given stream and returns cudaGetLastError() (0 = success).  The source is
// built twice (lia_ral_tpu_torch/_build.py): with LIA_TIERS_ONLY defined it
// holds the four tiers' instances alone (the library that config keys and
// tools load; its entry points reject every other mode), and without it
// every mode's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "wgmma_ops.cuh"

namespace {

constexpr int NT = 256;             // two warpgroups
constexpr int KT = 64;              // components per wgmma tile (its M)
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use
constexpr float PAD_LOGIT = -1e30f;
// the grouped entry's rows start on multiples of this many frames
// (cuda_kernels.GROUP_UNIT): a multiple of every llk block's 2 TF
constexpr int GROUP_UNIT = 256;
constexpr float LOG2E_F = 1.4426950408889634f;
constexpr double LOG2E_D = 1.4426950408889634;
constexpr float LN2_F = 0.6931471805599453f;

// exponential modes, stats forms and p-piece instances (cuda_kernels.py's
// EXP_MODES, STATS_FORMS)
enum { EM_EXP2 = 0, EM_EXP = 1, EM_FAST2 = 2 };
enum { SF_1 = 0, SF_2P = 1, SF_2X = 2, SF_3 = 3, SF_6 = 4, SF_SR = 5 };
constexpr int PF_SR = 4;            // p pieces 1, 2, 3, or 1 rounded by SR

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

// ---- the mode's arithmetic -------------------------------------------------
// _fast_exp2 (pallas_kernels.py:48-62), each operation rounded on its own
__device__ __forceinline__ float fast_exp2(float v) {
    v = fmaxf(v, -120.f);
    const float i = floorf(v);
    const float f = __fsub_rn(v, i);
    float p = __fadd_rn(__fmul_rn(0.0135115532f, f), 0.0519895369f);
    p = __fadd_rn(__fmul_rn(p, f), 0.2415088773f);
    p = __fadd_rn(__fmul_rn(p, f), 0.6929742561f);
    p = __fadd_rn(__fmul_rn(p, f), 1.0000052588f);
    return __fmul_rn(p, __int_as_float(((int)i + 127) << 23));
}

// p of a max-shifted logit
template <int EM>
__device__ __forceinline__ float mode_exp(float v) {
    if constexpr (EM == EM_EXP) return expf(v);
    else if constexpr (EM == EM_FAST2) return fast_exp2(v);
    else return exp2f(v);
}
// the factor that moves a running sum to a new maximum
template <int EM>
__device__ __forceinline__ float rescale(float v) {
    if constexpr (EM == EM_EXP) return expf(v);
    else return exp2f(v);
}

// Philox4x32-10 (Salmon et al., SC'11): the four words of a counter
__device__ __forceinline__ uint4 philox4(uint32_t c0, uint32_t c1,
                                        uint32_t c2, uint32_t c3,
                                        unsigned long long seed) {
    uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r) {
            k0 += 0x9E3779B9u;
            k1 += 0xBB67AE85u;
        }
        const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
    }
    return make_uint4(c0, c1, c2, c3);
}
// the words of p's counter for frames 2 pair, 2 pair + 1 and components k,
// k + 8 (k with bit 3 clear), in that order: (2 pair, k), (2 pair + 1, k),
// (2 pair, k + 8), (2 pair + 1, k + 8)
__device__ __forceinline__ uint4 sr_words_p(unsigned long long seed,
                                           long long pair, uint32_t k) {
    return philox4((uint32_t)pair, (uint32_t)((unsigned long long)pair >> 32),
                   k & ~8u, 0u, seed);
}
// the 16 random bits of xa s at (global frame, design column)
__device__ __forceinline__ uint32_t sr_bits_xs(unsigned long long seed,
                                               long long frame, uint32_t col) {
    const uint4 r = philox4((uint32_t)frame,
                            (uint32_t)((unsigned long long)frame >> 32),
                            col >> 2, 1u, seed);
    const uint32_t w = col & 3;
    return (w & 2 ? (w & 1 ? r.w : r.z) : (w & 1 ? r.y : r.x)) & 0xFFFFu;
}
// bf16 bits of v rounded stochastically with 16 random bits
__device__ __forceinline__ uint32_t sr_bf16(float v, uint32_t bits) {
    return (__float_as_uint(v) + bits) >> 16;
}

// ---- prep: B tiles and the additive logit vector --------------------------
// bprep: (Kpad/64) tiles of la pieces of 64 x WP bf16.  Element (r, c) of a
// 64 x WP operand sits at core matrix (c/8, r/8) (row groups fastest) of 64
// elements, row r%8, column c%8: LBO = 8 * 128 bytes, SBO = 128 bytes.
// fold: cst on the constant-1 row (three logit passes), else in cstv.
// One block writes one 64-component tile.
__device__ __forceinline__ void prep_tile(const float* __restrict__ weights,
                                          const float* __restrict__ means,
                                          const float* __restrict__ cov_inv,
                                          int K, int D, int WP, int la,
                                          int fold, int base2, int tile,
                                          bf16* __restrict__ bprep,
                                          float* __restrict__ cstv) {
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
            if (base2) cst *= LOG2E_D;
            c2 = (float)fmax(cst, (double)PAD_LOGIT);
        }
        s_cst[threadIdx.x] = c2;
        cstv[k] = k < K ? (fold ? 0.f : c2) : PAD_LOGIT;
    }
    __syncthreads();
    bf16* dst = bprep + (long long)tile * la * KT * WP;
    for (int i = threadIdx.x; i < KT * WP; i += blockDim.x) {
        const int r = i % KT, c = i / KT, k = tile * KT + r;
        float v = 0.f;
        if (k < K) {
            if (c < D) {
                v = -0.5f * cov_inv[(long long)k * D + c];
                if (base2) v = __fmul_rn(v, LOG2E_F);
            } else if (c < 2 * D) {
                const long long j = (long long)k * D + (c - D);
                v = __fmul_rn(means[j], cov_inv[j]);
                if (base2) v = __fmul_rn(v, LOG2E_F);
            } else if (c == 2 * D && fold) {
                v = s_cst[r];
            }
        }
        const int off = ((c / 8) * 8 + r / 8) * 64 + (r % 8) * 8 + (c % 8);
        for (int piece = 0; piece < la; ++piece) {
            const bf16 h = __float2bfloat16_rn(v);
            dst[piece * KT * WP + off] = h;
            v -= __bfloat162float(h);
        }
    }
}

__global__ void prep_kernel(const float* __restrict__ weights,
                            const float* __restrict__ means,
                            const float* __restrict__ cov_inv, int K, int D,
                            int WP, int la, int fold, int base2,
                            bf16* __restrict__ bprep,
                            float* __restrict__ cstv) {
    prep_tile(weights, means, cov_inv, K, D, WP, la, fold, base2, blockIdx.x,
              bprep, cstv);
}

// The grouped call's S models (weights (S, K), means and cov_inv (S, K, D)):
// block (tile, model) writes that model's tile; model r's B at bprep + r *
// Kpad * WP * la, its vector at cstv + r * Kpad.
__global__ void prep_grouped_kernel(const float* __restrict__ weights,
                                    const float* __restrict__ means,
                                    const float* __restrict__ cov_inv, int K,
                                    int D, int WP, int la, int fold,
                                    int base2, bf16* __restrict__ bprep,
                                    float* __restrict__ cstv) {
    const long long r = blockIdx.y, kpad = (long long)gridDim.x * KT;
    prep_tile(weights + r * K, means + r * K * D, cov_inv + r * K * D, K, D,
              WP, la, fold, base2, blockIdx.x, bprep + r * kpad * WP * la,
              cstv + r * kpad);
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

// One 16-byte core-matrix row in `pieces` bf16 pieces, piece i at
// dst + i * stride: bf16(v), then bf16 of what is left, and so on.
__device__ __forceinline__ void store_pieces(float (&v)[8], int pieces,
                                             bf16* dst, int stride) {
    for (int piece = 0; piece < pieces; ++piece) {
        uint4 h;
        h.x = pack2(v[0], v[1]); h.y = pack2(v[2], v[3]);
        h.z = pack2(v[4], v[5]); h.w = pack2(v[6], v[7]);
        *reinterpret_cast<uint4*>(dst + piece * stride) = h;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] -= bf16r(v[i]);
    }
}

// the xa pieces for TF frames as the N operand of the logit product:
// element (t, c) at core matrix (c/8, t/8) (frame groups fastest), row t%8,
// column c%8: LBO = (TF/8) * 128 bytes, SBO = 128 bytes; piece i at
// xa + i * TF * WP.  A thread writes one 16-byte core-matrix row; a warp
// writes 512 contiguous bytes.
template <int TF>
__device__ __forceinline__ void build_xa(const float* sX, int D, int WP,
                                         int pieces, bf16* xa) {
    const int items = TF * (WP / 8);
    for (int it = threadIdx.x; it < items; it += NT) {
        const int t = it % TF, kc = it / TF;
        const float* row = sX + t * D;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = xa_val(row, kc * 8 + i, D);
        const int off = (kc * (TF / 8) + t / 8) * 64 + (t % 8) * 8;
        store_pieces(v, pieces, xa + off, TF * WP);
    }
}

// the xs = xa * s pieces as the N operand of the stats product, NS design
// columns as rows and TF frames as depth: element (c, t) at core matrix
// (t/8, c/8) (column groups fastest), row c%8, column t%8:
// LBO = (NS/8) * 128 bytes, SBO = 128 bytes; piece i at xs + i * NS * TF.
// sr: one piece, rounded stochastically; frame t of the tile is global
// frame t0 + t.
template <int NS, int TF>
__device__ __forceinline__ void build_xs(const float* sX, const float* sS,
                                         int D, int pieces, int sr,
                                         unsigned long long seed,
                                         long long t0, bf16* xs) {
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
        if (sr) {
            uint32_t h[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const long long f = t0 + fg * 8 + 2 * i;
                h[i] = sr_bf16(v[2 * i], sr_bits_xs(seed, f, c))
                       | (sr_bf16(v[2 * i + 1], sr_bits_xs(seed, f + 1, c))
                          << 16);
            }
            *reinterpret_cast<uint4*>(xs + off) =
                make_uint4(h[0], h[1], h[2], h[3]);
        } else {
            store_pieces(v, pieces, xs + off, NS * TF);
        }
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

// The (B piece, xa piece) of each logit pass, in the order they are issued:
// hi.hi, hi.lo(mid), lo(mid).hi, then for six passes hi.lo, mid.mid, lo.hi.
__device__ __forceinline__ int pass_b(int q) {
    return q == 5 ? 2 : (q == 2 || q == 4 ? 1 : 0);
}
__device__ __forceinline__ int pass_x(int q) {
    return q == 3 ? 2 : (q == 1 || q == 4 ? 1 : 0);
}

// The one logit routine both passes use: acc = B tile (64 x WP) . xa^T
// (WP x TF), as the first `passes` (1, 3 or 6) of the passes above, each
// over the depth steps in order.  Same instructions, same operand bits, so
// both passes see identical logits.  B piece i at b + i * KT * WP, xa piece
// i at xa + i * TF * WP.  The products are issued and committed, not waited
// for (wgmma_done).
template <int TF>
__device__ __forceinline__ void logits_issue(float (&acc)[TF / 2],
                                             const bf16* b, const bf16* xa,
                                             int WP, int passes) {
    constexpr uint32_t XA_LBO = (TF / 8) * 128;
    const uint32_t b0 = smem_u32(b), x0 = smem_u32(xa);
    const uint32_t b_piece = KT * WP * 2, x_piece = TF * WP * 2;
    const int steps = WP / 16;
    wgmma_fence();
    for (int q = 0; q < passes; ++q) {
        const uint32_t bq = b0 + pass_b(q) * b_piece;
        const uint32_t xq = x0 + pass_x(q) * x_piece;
        for (int j = 0; j < steps; ++j)
            wgmma_logit_step<TF>(acc, smem_desc(bq + j * 2048, 1024, 128),
                                 smem_desc(xq + j * 2 * XA_LBO, XA_LBO, 128),
                                 q > 0 || j > 0);
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

// (m, s) <- merge of two (max, sum e^(. - max)) partials
template <int EM>
__device__ __forceinline__ void merge_ms(float& m, float& s, float m2,
                                         float s2) {
    const float mn = fmaxf(m, m2);
    s = s * rescale<EM>(m - mn) + s2 * rescale<EM>(m2 - mn);
    m = mn;
}

// ---- pass 1: per-frame m, s = w / sum e^(ld - m), llk ---------------------
template <int TF>
struct LlkSmem {                    // byte offsets for a given WP
    int xa, b, cst, pm, ps, total;
    __host__ __device__ LlkSmem(int WP, int la, int nb) {
        xa = 0;                                  // [2 wg][la][TF x WP]
        b = xa + 2 * la * TF * WP * 2;           // [2 wg][nb][la][64 x WP]
        cst = b + 2 * nb * la * KT * WP * 2;     // [2 wg][nb][64] f32
        pm = cst + 2 * nb * KT * 4;              // [2 wg][4 warps][TF] f32
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

// Per call: the shape, the mode and the ring depths, passed by value.
struct Geo {
    long long n_frames;
    int chunk_len, tiles_per_chunk, K, n_ktiles, k_blocks, D, WP;
    int la, ls, passes, x2, nx, sr;     // pieces, logit passes, stats flags
    int nb_llk, nb_stats;               // ring stages (1 or 2)
    unsigned long long seed;
};

// The pass for one block: frames [f0, f0 + 2 TF), none at or past f_end,
// against the B tiles at bprep and the vector at cstv.
template <int TF, int EM>
__device__ __forceinline__ void llk_body(const float* __restrict__ x,
                                         const float* __restrict__ w,
                                         const bf16* __restrict__ bprep,
                                         const float* __restrict__ cstv,
                                         const Geo& G, long long f0,
                                         long long f_end,
                                         float* __restrict__ llk,
                                         float* __restrict__ m_out,
                                         float* __restrict__ s_out) {
    extern __shared__ uint4 smem_raw[];
    char* sm = reinterpret_cast<char*>(smem_raw);
    const int WP = G.WP, la = G.la, nb = G.nb_llk, n_ktiles = G.n_ktiles;
    const LlkSmem<TF> L(WP, la, nb);
    const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
    const int warp = wt / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
    const int op = la * TF * WP;                // elements of one xa set
    bf16* sXA = reinterpret_cast<bf16*>(sm + L.xa);
    float* sX = reinterpret_cast<float*>(sm + L.b);

    for (int h = 0; h < 2; ++h) {               // xa of both warpgroups
        __syncthreads();
        issue_x_tile(x, f0 + h * TF, f_end, TF, G.D, sX);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        build_xa<TF>(sX, G.D, WP, la, sXA + h * op);
    }
    fence_async_proxy();
    __syncthreads();

    // From here the warpgroups run on their own: each streams the B tiles
    // through its own ring and meets only its own barrier, so one's
    // exponentials overlap the other's products.
    const int tile_elems = la * KT * WP;        // the pieces of one B tile
    const int chunks = tile_elems / 8;          // 16-byte pieces
    bf16* ring = reinterpret_cast<bf16*>(sm + L.b) + wg * nb * tile_elems;
    float* cring = reinterpret_cast<float*>(sm + L.cst) + wg * nb * KT;
    auto issue_b = [&](int j) {
        const int buf = nb == 2 ? (j & 1) : 0;
        bf16* dst = ring + buf * tile_elems;
        const bf16* src = bprep + (long long)j * tile_elems;
        for (int i = wt; i < chunks; i += 128)
            cp_async16(dst + i * 8, src + i * 8);
        if (wt < KT / 4)
            cp_async16(cring + buf * KT + wt * 4,
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
    const bf16* my_xa = sXA + wg * op;
    for (int j = 0; j < n_ktiles; ++j) {
        if (nb == 2 && j + 1 < n_ktiles) {
            issue_b(j + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        fence_async_proxy();
        wg_sync(wg);
        const int buf = nb == 2 ? (j & 1) : 0;
        const bf16* sB = ring + buf * tile_elems;
        const float* sC = cring + buf * KT;
        float acc[TF / 2];
        turn_wait(wg);
        logits_issue<TF>(acc, sB, my_xa, WP, G.passes);
        turn_pass(wg);
        wgmma_done(acc);
        const float c0 = sC[16 * warp + g], c1 = sC[16 * warp + g + 8];
#pragma unroll
        for (int q = 0; q < TF / 4; ++q) {
            const int i = 4 * (q / 2) + (q % 2);
            const float v0 = acc[i] + c0, v1 = acc[i + 2] + c1;
            const float mn = fmaxf(mx[q], fmaxf(v0, v1));
            sx[q] = sx[q] * rescale<EM>(mx[q] - mn) + mode_exp<EM>(v0 - mn)
                    + mode_exp<EM>(v1 - mn);
            mx[q] = mn;
        }
        wg_sync(wg);                // the tile's buffer may be refilled
        if (nb == 1 && j + 1 < n_ktiles) issue_b(j + 1);
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
            merge_ms<EM>(mx[q], sx[q], m2, s2);
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
        if (f < f_end) {
            const float* pm = reinterpret_cast<float*>(sm + L.pm) + h * 4 * TF;
            const float* ps = reinterpret_cast<float*>(sm + L.ps) + h * 4 * TF;
            float M = pm[col], S = ps[col];
            for (int wv = 1; wv < 4; ++wv)
                merge_ms<EM>(M, S, pm[wv * TF + col], ps[wv * TF + col]);
            llk[f] = EM == EM_EXP ? logf(S) + M : logf(S) + M * LN2_F;
            // a zero-weight frame adds nothing: m = +inf makes its p = 0
            const float wf = w[f];
            m_out[f] = wf != 0.f ? M : CUDART_INF_F;
            s_out[f] = wf / S;
        }
    }
}

template <int TF, int EM>
__global__ void __launch_bounds__(NT, 1)
llk_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const bf16* __restrict__ bprep, const float* __restrict__ cstv,
           const Geo G, float* __restrict__ llk, float* __restrict__ m_out,
           float* __restrict__ s_out) {
    llk_body<TF, EM>(x, w, bprep, cstv, G, (long long)blockIdx.x * (2 * TF),
                     G.n_frames, llk, m_out, s_out);
}

// The grouped call (rows padded to GROUP_UNIT frames, so a block's frames
// are one row's): the block's row, unit_row[f0 / GROUP_UNIT], picks the
// model whose prepared B and vector it reads.
template <int TF>
__global__ void __launch_bounds__(NT, 1)
llk_grouped_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const bf16* __restrict__ bprep,
                   const float* __restrict__ cstv, const Geo G,
                   const int* __restrict__ unit_row, float* __restrict__ llk,
                   float* __restrict__ m_out, float* __restrict__ s_out) {
    const long long f0 = (long long)blockIdx.x * (2 * TF);
    const long long r = unit_row[f0 / GROUP_UNIT];
    llk_body<TF, EM_EXP2>(x, w, bprep + r * G.n_ktiles * G.la * KT * G.WP,
                          cstv + r * G.n_ktiles * KT, G, f0, G.n_frames, llk,
                          m_out, s_out);
}

// ---- the operand tiles of the stats pass ----------------------------------
// Tile (chunk c, i) covers frames [c*chunk_len + i*TF, ... + TF) of chunk c
// (cut at the chunk's end).  Its operands, in the order the stats pass's
// shared memory holds them: la xa pieces (TF x WP each), then ls xs pieces
// (NS x TF each), bf16.
template <int NS, int TF>
__host__ __device__ constexpr int tile_elems(int WP, int la, int ls) {
    return la * TF * WP + ls * NS * TF;
}

// The tile of frames [t0, t0 + TF) of a chunk that ends at f1 (nothing
// where t0 >= f1).
template <int NS, int TF>
__device__ __forceinline__ void tiles_body(const float* __restrict__ x,
                                           const float* __restrict__ s_in,
                                           const Geo& G, long long t0,
                                           long long f1,
                                           bf16* __restrict__ tiles) {
    extern __shared__ uint4 smem_raw[];
    float* sX = reinterpret_cast<float*>(smem_raw);
    float* sS = sX + round_up(TF * G.D, 4);
    if (t0 >= f1) return;
    issue_x_tile(x, t0, f1, TF, G.D, sX);
    cp_async_commit();
    for (int t = threadIdx.x; t < TF; t += NT)
        sS[t] = t0 + t < f1 ? s_in[t0 + t] : 0.f;
    cp_async_wait<0>();
    __syncthreads();
    bf16* dst = tiles
        + (long long)blockIdx.x * tile_elems<NS, TF>(G.WP, G.la, G.ls);
    build_xa<TF>(sX, G.D, G.WP, G.la, dst);
    build_xs<NS, TF>(sX, sS, G.D, G.ls, G.sr, G.seed, t0,
                     dst + G.la * TF * G.WP);
}

// Builds every tile once (the stats grid reads each one from every
// component block).  Block c * tiles_per_chunk + i builds tile (c, i).
template <int NS, int TF>
__global__ void __launch_bounds__(NT)
tiles_kernel(const float* __restrict__ x, const float* __restrict__ s_in,
             const Geo G, bf16* __restrict__ tiles) {
    const long long f0 =
        (long long)(blockIdx.x / G.tiles_per_chunk) * G.chunk_len;
    const long long f1 = min(f0 + G.chunk_len, G.n_frames);
    const long long t0 =
        f0 + (long long)(blockIdx.x % G.tiles_per_chunk) * TF;
    tiles_body<NS, TF>(x, s_in, G, t0, f1, tiles);
}

// The grouped call: chunk c covers [chunk_start[c], chunk_start[c + 1]).
template <int NS, int TF>
__global__ void __launch_bounds__(NT)
tiles_grouped_kernel(const float* __restrict__ x,
                     const float* __restrict__ s_in, const Geo G,
                     const int* __restrict__ chunk_start,
                     bf16* __restrict__ tiles) {
    const int c = blockIdx.x / G.tiles_per_chunk;
    const long long t0 = chunk_start[c]
        + (long long)(blockIdx.x % G.tiles_per_chunk) * TF;
    tiles_body<NS, TF>(x, s_in, G, t0, chunk_start[c + 1], tiles);
}

// ---- pass 2: the statistics -----------------------------------------------
template <int NS, int TF>
struct StatsSmem {
    int b, cst, tile, s, m, red, total;
    __host__ __device__ StatsSmem(int WP, int la, int ls, int nb) {
        b = 0;                                   // [2 wg][la][64 x WP]
        cst = b + 2 * la * KT * WP * 2;          // [2 wg][64] f32
        tile = cst + 2 * KT * 4;                 // [nb] operand tiles
        s = tile + nb * tile_elems<NS, TF>(WP, la, ls) * 2;  // [nb][TF] f32
        m = s + nb * TF * 4;                     // [nb][TF] f32
        red = m + nb * TF * 4;                   // [2][NT] f32
        total = red + 2 * NT * 4;
    }
};

// One pass of the stats product: acc += p piece pa (registers, TF frames of
// depth) . xs piece at shared address xb, over the depth steps in order.
template <int NS, int TF>
__device__ __forceinline__ void stat_pass(float (&acc)[NS / 2],
                                          const uint32_t (&pa)[TF / 4],
                                          uint32_t xb) {
    constexpr uint32_t XS_LBO = (NS / 8) * 128;
#pragma unroll
    for (int j = 0; j < TF / 16; ++j)
        wgmma_stat_step<NS>(acc, pa + 4 * j,
                            smem_desc(xb + j * 2 * XS_LBO, XS_LBO, 128));
}

// Frames of chunk c are [c*chunk_len, min((c+1)*chunk_len, n_frames)).
// out: (n_chunks, K+1, A).  Block c * k_blocks + j (component blocks
// fastest, so that the blocks of a chunk read its tiles together) writes
// rows [128 j, 128 j + 128) of chunk c (warpgroup h the rows 128 j + 64 h
// ...); the blocks with j == 0 also write row K.  PF: the p pieces in
// registers (1, 2, 3, or PF_SR: one, rounded stochastically).  The body
// of one block: chunk ``chunk`` holds frames [f0, f1), scored against the
// B tiles at bprep and the vector at cstv.
template <int NS, int TF, int EM, int PF>
__device__ __forceinline__ void stats_body(
    const float* __restrict__ w, const float* __restrict__ llk,
    const float* __restrict__ m_in, const float* __restrict__ s_in,
    const bf16* __restrict__ bprep, const float* __restrict__ cstv,
    const bf16* __restrict__ tiles, const Geo& G, int chunk, long long f0,
    long long f1, float* __restrict__ out) {
    constexpr int NP = PF == PF_SR ? 1 : PF;
    extern __shared__ uint4 smem_raw[];
    char* sm = reinterpret_cast<char*>(smem_raw);
    const int WP = G.WP, la = G.la, nb = G.nb_stats, K = G.K, D = G.D;
    const StatsSmem<NS, TF> L(WP, la, G.ls, nb);
    const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
    const int lane = tid % 32, g = lane / 4, c = lane % 4;
    const int A = 2 * D + 2;
    const int kblock = blockIdx.x % G.k_blocks;
    const int ktile = kblock * 2 + wg;
    const bool has_tile = ktile < G.n_ktiles;    // uniform in the warpgroup
    const bool turns = kblock * 2 + 1 < G.n_ktiles;  // both have a tile

    bf16* sB = reinterpret_cast<bf16*>(sm + L.b) + wg * la * KT * WP;
    float* sC = reinterpret_cast<float*>(sm + L.cst) + wg * KT;
    bf16* sT = reinterpret_cast<bf16*>(sm + L.tile);
    float* sS = reinterpret_cast<float*>(sm + L.s);
    float* sM = reinterpret_cast<float*>(sm + L.m);
    const int te = tile_elems<NS, TF>(WP, la, G.ls);

    if (has_tile) {
        const uint4* src = reinterpret_cast<const uint4*>(
            bprep + (long long)ktile * la * KT * WP);
        uint4* dst = reinterpret_cast<uint4*>(sB);
        for (int i = tid % 128; i < la * KT * WP / 8; i += 128) dst[i] = src[i];
        if (tid % 128 < KT) sC[tid % 128] = cstv[ktile * KT + tid % 128];
    }

    float acc[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
    float n0 = 0.f, n1 = 0.f;       // nx: exact sum_t p s, rows g, g+8

    // Tile i (operands, s, m) is copied into buffer i % nb, one tile ahead
    // with two buffers, after tile i-1 is done with one.
    const int n_tiles = (int)((f1 - f0 + TF - 1) / TF);
    const bf16* my_tiles = tiles + (long long)chunk * G.tiles_per_chunk * te;
    auto stage = [&](int i) {
        if (i < n_tiles) {
            const int b = nb == 2 ? (i & 1) : 0;
            const bf16* src = my_tiles + (long long)i * te;
            bf16* dst = sT + b * te;
            for (int e = 8 * tid; e < te; e += 8 * NT)
                cp_async16(dst + e, src + e);
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

    // global index of this thread's first frame and its components
    const int k0 = ktile * KT + 16 * warp + g, k1 = k0 + 8;
    for (int i = 0; i < n_tiles; ++i) {
        const int b = nb == 2 ? (i & 1) : 0;
        const bf16* xa = sT + b * te;
        const bf16* xs = xa + la * TF * WP;
        const float* sSb = sS + b * TF;
        const float* sMb = sM + b * TF;
        cp_async_wait<0>();
        fence_async_proxy();
        // tile i has landed; both warpgroups are done with tile i-1
        __syncthreads();
        if (nb == 2) stage(i + 1);
        if (has_tile) {
            float ld[TF / 2];
            if (turns) turn_wait(wg);
            logits_issue<TF>(ld, sB, xa, WP, G.passes);
            if (turns) turn_pass(wg);
            wgmma_done(ld);
            const float c0 = sC[16 * warp + g], c1 = sC[16 * warp + g + 8];
            const long long tf0 = f0 + (long long)i * TF + 2 * c;
            // p = e(ld - m); fragment n of the A operand packs (p[2n],
            // p[2n+1]): depth step j uses fragments 4j .. 4j+3
            uint32_t p0[TF / 4], p1[NP >= 2 ? TF / 4 : 1],
                p2[NP >= 3 ? TF / 4 : 1];
#pragma unroll
            for (int q = 0; q < TF / 8; ++q) {   // n8 block of frames
                const float2 mv = *reinterpret_cast<const float2*>(
                    sMb + 8 * q + 2 * c);
                float p00 = mode_exp<EM>(ld[4 * q] + c0 - mv.x);
                float p01 = mode_exp<EM>(ld[4 * q + 1] + c0 - mv.y);
                float p10 = mode_exp<EM>(ld[4 * q + 2] + c1 - mv.x);
                float p11 = mode_exp<EM>(ld[4 * q + 3] + c1 - mv.y);
                if (G.nx) {
                    const float2 sv = *reinterpret_cast<const float2*>(
                        sSb + 8 * q + 2 * c);
                    n0 = fmaf(p01, sv.y, fmaf(p00, sv.x, n0));
                    n1 = fmaf(p11, sv.y, fmaf(p10, sv.x, n1));
                }
                if constexpr (PF == PF_SR) {
                    // bits of (fa, k0), (fa+1, k0), (fa, k1), (fa+1, k1):
                    // one counter when fa is even; an odd fa (K2 with an
                    // odd T, uniform in the block) spans two
                    const long long fa = tf0 + 8 * q;
                    const uint4 r = sr_words_p(G.seed, fa >> 1, k0);
                    uint32_t b00 = r.x, b01 = r.y, b10 = r.z, b11 = r.w;
                    if (fa & 1) {
                        const uint4 r2 = sr_words_p(G.seed, (fa >> 1) + 1, k0);
                        b00 = r.y;
                        b10 = r.w;
                        b01 = r2.x;
                        b11 = r2.z;
                    }
                    p0[2 * q] = sr_bf16(p00, b00 & 0xFFFFu)
                                | (sr_bf16(p01, b01 & 0xFFFFu) << 16);
                    p0[2 * q + 1] = sr_bf16(p10, b10 & 0xFFFFu)
                                    | (sr_bf16(p11, b11 & 0xFFFFu) << 16);
                } else {
                    p0[2 * q] = pack2(p00, p01);
                    p0[2 * q + 1] = pack2(p10, p11);
                    if constexpr (NP >= 2) {
                        p00 -= bf16r(p00); p01 -= bf16r(p01);
                        p10 -= bf16r(p10); p11 -= bf16r(p11);
                        p1[2 * q] = pack2(p00, p01);
                        p1[2 * q + 1] = pack2(p10, p11);
                    }
                    if constexpr (NP >= 3) {
                        p00 -= bf16r(p00); p01 -= bf16r(p01);
                        p10 -= bf16r(p10); p11 -= bf16r(p11);
                        p2[2 * q] = pack2(p00, p01);
                        p2[2 * q + 1] = pack2(p10, p11);
                    }
                }
            }
            const uint32_t x0 = smem_u32(xs);
            const uint32_t xp = NS * TF * 2;    // bytes of one xs piece
            if (turns) turn_wait(wg);
            wgmma_fence();
            stat_pass<NS, TF>(acc, p0, x0);     // (hi, hi)
            if constexpr (NP == 1) {
                if (G.x2) stat_pass<NS, TF>(acc, p0, x0 + xp);      // "2x"
            } else if constexpr (NP == 2) {
                if (G.x2) stat_pass<NS, TF>(acc, p0, x0 + xp);      // "3"
                stat_pass<NS, TF>(acc, p1, x0);
            } else {                                                // "6"
                stat_pass<NS, TF>(acc, p0, x0 + xp);
                stat_pass<NS, TF>(acc, p1, x0);
                stat_pass<NS, TF>(acc, p0, x0 + 2 * xp);
                stat_pass<NS, TF>(acc, p1, x0 + xp);
                stat_pass<NS, TF>(acc, p2, x0);
            }
            wgmma_commit();
            if (turns) turn_pass(wg);
            wgmma_done(acc);
#pragma unroll
            for (int q = 0; q < TF / 4; ++q) {
                keep_reg(p0[q]);
                if constexpr (NP >= 2) keep_reg(p1[q]);
                if constexpr (NP >= 3) keep_reg(p2[q]);
            }
        }
        if (nb == 1) {
            __syncthreads();                    // the one buffer is free
            stage(i + 1);
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
                if (G.nx && col == 2 * D) v.x = (i / 2) % 2 ? n1 : n0;
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

template <int NS, int TF, int EM, int PF>
__global__ void __launch_bounds__(NT, 1)
stats_kernel(const float* __restrict__ w, const float* __restrict__ llk,
             const float* __restrict__ m_in, const float* __restrict__ s_in,
             const bf16* __restrict__ bprep, const float* __restrict__ cstv,
             const bf16* __restrict__ tiles, const Geo G,
             float* __restrict__ out) {
    const int chunk = blockIdx.x / G.k_blocks;
    const long long f0 = (long long)chunk * G.chunk_len;
    stats_body<NS, TF, EM, PF>(w, llk, m_in, s_in, bprep, cstv, tiles, G,
                               chunk, f0, min(f0 + G.chunk_len, G.n_frames),
                               out);
}

// The grouped call in the default arithmetic: chunk c covers
// [chunk_start[c], chunk_start[c + 1]) of row chunk_row[c], scored with
// that row's model; out holds one partial a chunk.
template <int NS, int TF>
__global__ void __launch_bounds__(NT, 1)
stats_grouped_kernel(const float* __restrict__ w,
                     const float* __restrict__ llk,
                     const float* __restrict__ m_in,
                     const float* __restrict__ s_in,
                     const bf16* __restrict__ bprep,
                     const float* __restrict__ cstv,
                     const bf16* __restrict__ tiles, const Geo G,
                     const int* __restrict__ chunk_start,
                     const int* __restrict__ chunk_row,
                     float* __restrict__ out) {
    const int chunk = blockIdx.x / G.k_blocks;
    const long long r = chunk_row[chunk];
    stats_body<NS, TF, EM_EXP2, 2>(
        w, llk, m_in, s_in, bprep + r * G.n_ktiles * G.la * KT * G.WP,
        cstv + r * G.n_ktiles * KT, tiles, G, chunk, chunk_start[chunk],
        chunk_start[chunk + 1], out);
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

// out[r, j] = sum_c partials[c, j] over the chunks c of row r,
// row_chunks[r] .. row_chunks[r + 1] - 1 in order; 0 for a row with none.
__global__ void reduce_rows_kernel(const float* __restrict__ partials,
                                   const int* __restrict__ row_chunks,
                                   long long m, float* __restrict__ out) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= m) return;
    const int r = blockIdx.y;
    float s = 0.f;
    for (int c = row_chunks[r]; c < row_chunks[r + 1]; ++c)
        s += partials[(long long)c * m + j];
    out[(long long)r * m + j] = s;
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
};

// The mode as the C entry points take it (cuda_kernels.Mode.kernel_args),
// and what follows from it: bf16 pieces of B / xa (la) and of xs (ls), p
// pieces (pf), the extra xs-lo pass (x2), cst folded into B (fold).
struct ModeArgs {
    int passes, em, form, nx;
    int la, ls, pf, x2, fold;
    bool valid;
    ModeArgs(int passes_, int em_, int form_, int nx_)
        : passes(passes_), em(em_), form(form_), nx(nx_) {
        valid = (passes == 1 || passes == 3 || passes == 6)
                && em >= EM_EXP2 && em <= EM_FAST2 && form >= SF_1
                && form <= SF_SR && (nx == 0 || (nx == 1 && form == SF_1));
#ifdef LIA_TIERS_ONLY
        // the four tiers only: (3, exp2, "3"), (3, exp2, "1", nx) and
        // (1, exp2, "1", either nx)
        valid = valid && em == EM_EXP2
                && ((passes == 3 && form == SF_3 && !nx)
                    || (passes == 3 && form == SF_1 && nx)
                    || (passes == 1 && form == SF_1));
#endif
        la = passes == 1 ? 1 : (passes == 3 ? 2 : 3);
        ls = form == SF_2X || form == SF_3 ? 2 : (form == SF_6 ? 3 : 1);
        pf = form == SF_2P || form == SF_3 ? 2
             : (form == SF_6 ? 3 : (form == SF_SR ? PF_SR : 1));
        x2 = form == SF_2X || form == SF_3;
        fold = passes == 3;
    }
};

struct Scratch {                    // byte offsets into the one scratch buffer
    long long bprep, cstv, llk, m, s, tiles, partials, total;
    int tiles_per_chunk;
    // models: the GMMs whose B is prepared (the grouped entry's S)
    Scratch(long long n_frames, int D, int K, int chunk_len, int n_chunks,
            bool with_partials, const ModeArgs& md, int models = 1) {
        const Shape sh(D);
        const int Kpad = round_up(K, KT);
        tiles_per_chunk = (chunk_len + sh.TF - 1) / sh.TF;
        const long long te =
            (long long)md.la * sh.TF * sh.WP + (long long)md.ls * sh.NS * sh.TF;
        bprep = 0;
        cstv = bprep
               + align256((long long)models * Kpad * sh.WP * md.la * 2);
        llk = cstv + align256((long long)models * Kpad * 4);
        m = llk + align256(n_frames * 4);
        s = m + align256(n_frames * 4);
        tiles = s + align256(n_frames * 4);
        partials = tiles + align256((long long)n_chunks * tiles_per_chunk
                                    * te * 2);
        total = partials + (with_partials
            ? align256((long long)n_chunks * (K + 1) * (2 * D + 2) * 4) : 0);
    }
};

template <int TF, int EM>
cudaError_t launch_llk(const float* x, const float* w, const bf16* bprep,
                       const float* cstv, Geo G, float* llk, float* m,
                       float* s, cudaStream_t st) {
    G.nb_llk = LlkSmem<TF>(G.WP, G.la, 2).total <= SMEM_MAX ? 2 : 1;
    const LlkSmem<TF> L(G.WP, G.la, G.nb_llk);
    if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        llk_kernel<TF, EM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.total);
    if (e != cudaSuccess) return e;
    const unsigned blocks = (unsigned)((G.n_frames + 2 * TF - 1) / (2 * TF));
    llk_kernel<TF, EM><<<blocks, NT, L.total, st>>>(x, w, bprep, cstv, G,
                                                    llk, m, s);
    return cudaGetLastError();
}

template <int NS, int TF, int EM, int PF>
cudaError_t launch_stats_kernel(const float* w, const float* llk,
                                const float* m, const float* s,
                                const bf16* bprep, const float* cstv,
                                const bf16* tiles, const Geo& G, int n_chunks,
                                float* out, cudaStream_t st) {
    const StatsSmem<NS, TF> L(G.WP, G.la, G.ls, G.nb_stats);
    cudaError_t e = cudaFuncSetAttribute(
        stats_kernel<NS, TF, EM, PF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return e;
    stats_kernel<NS, TF, EM, PF>
        <<<(unsigned)((long long)n_chunks * G.k_blocks), NT, L.total, st>>>(
            w, llk, m, s, bprep, cstv, tiles, G, out);
    return cudaGetLastError();
}

template <int NS, int TF>
cudaError_t launch_stats(const float* x, const float* w, const float* llk,
                         const float* m, const float* s, const bf16* bprep,
                         const float* cstv, bf16* tiles, Geo G, int n_chunks,
                         const ModeArgs& md, float* out, cudaStream_t st) {
    const int tiles_smem = (round_up(TF * G.D, 4) + TF) * 4;
    cudaError_t e = cudaFuncSetAttribute(
        tiles_kernel<NS, TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tiles_smem);
    if (e != cudaSuccess) return e;
    tiles_kernel<NS, TF><<<(unsigned)((long long)n_chunks
                                      * G.tiles_per_chunk),
                           NT, tiles_smem, st>>>(x, s, G, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    G.nb_stats =
        StatsSmem<NS, TF>(G.WP, G.la, G.ls, 2).total <= SMEM_MAX ? 2 : 1;
    if (StatsSmem<NS, TF>(G.WP, G.la, G.ls, G.nb_stats).total > SMEM_MAX)
        return cudaErrorInvalidValue;
#define LIA_STATS(EM_, PF_)                                                  \
    return launch_stats_kernel<NS, TF, EM_, PF_>(w, llk, m, s, bprep, cstv,  \
                                                 tiles, G, n_chunks, out, st)
#ifdef LIA_TIERS_ONLY
    if (md.pf == 1) LIA_STATS(EM_EXP2, 1);
    LIA_STATS(EM_EXP2, 2);
#else
#define LIA_STATS_PF(EM_)                    \
    switch (md.pf) {                         \
        case 1: LIA_STATS(EM_, 1);           \
        case 2: LIA_STATS(EM_, 2);           \
        case 3: LIA_STATS(EM_, 3);           \
        default: LIA_STATS(EM_, PF_SR);      \
    }
    switch (md.em) {
        case EM_EXP2: LIA_STATS_PF(EM_EXP2);
        case EM_EXP: LIA_STATS_PF(EM_EXP);
        default: LIA_STATS_PF(EM_FAST2);
    }
#undef LIA_STATS_PF
#endif
#undef LIA_STATS
}

// The shape and mode of a call as the kernels take them.
Geo geo_of(long long n_frames, int chunk_len, const Scratch& sc, int K, int D,
           const ModeArgs& md, unsigned long long seed) {
    Geo G;
    G.n_frames = n_frames;
    G.chunk_len = chunk_len;
    G.tiles_per_chunk = sc.tiles_per_chunk;
    G.K = K;
    G.n_ktiles = (K + KT - 1) / KT;
    G.k_blocks = (G.n_ktiles + 1) / 2;
    G.D = D;
    G.WP = Shape(D).WP;
    G.la = md.la;
    G.ls = md.ls;
    G.passes = md.passes;
    G.x2 = md.x2;
    G.nx = md.nx;
    G.sr = md.form == SF_SR;
    G.nb_llk = G.nb_stats = 2;
    G.seed = seed;
    return G;
}

// prep, llk pass, tiles and stats pass.  out: (n_chunks, K+1, A).
cudaError_t run(const float* x, const float* w, const float* weights,
                const float* means, const float* cov_inv, long long n_frames,
                int chunk_len, int n_chunks, int K, int D,
                const ModeArgs& md, unsigned long long seed, char* scratch,
                const Scratch& sc, float* out, cudaStream_t st) {
    if (D <= 0 || D > 64 || K <= 0 || n_frames <= 0 || chunk_len <= 0
        || !md.valid)
        return cudaErrorInvalidValue;
    const Shape sh(D);
    const Geo G = geo_of(n_frames, chunk_len, sc, K, D, md, seed);
    bf16* bprep = reinterpret_cast<bf16*>(scratch + sc.bprep);
    float* cstv = reinterpret_cast<float*>(scratch + sc.cstv);
    float* llk = reinterpret_cast<float*>(scratch + sc.llk);
    float* m = reinterpret_cast<float*>(scratch + sc.m);
    float* s = reinterpret_cast<float*>(scratch + sc.s);
    bf16* tiles = reinterpret_cast<bf16*>(scratch + sc.tiles);
    prep_kernel<<<G.n_ktiles, 256, 0, st>>>(weights, means, cov_inv, K, D,
                                            G.WP, md.la, md.fold,
                                            md.em != EM_EXP, bprep, cstv);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
#ifdef LIA_TIERS_ONLY
    e = sh.TF == 128
        ? launch_llk<128, EM_EXP2>(x, w, bprep, cstv, G, llk, m, s, st)
        : launch_llk<64, EM_EXP2>(x, w, bprep, cstv, G, llk, m, s, st);
#else
    if (sh.TF == 128) {
        e = md.em == EM_EXP2 ? launch_llk<128, EM_EXP2>(x, w, bprep, cstv, G,
                                                       llk, m, s, st)
            : md.em == EM_EXP ? launch_llk<128, EM_EXP>(x, w, bprep, cstv, G,
                                                        llk, m, s, st)
            : launch_llk<128, EM_FAST2>(x, w, bprep, cstv, G, llk, m, s, st);
    } else {
        e = md.em == EM_EXP2 ? launch_llk<64, EM_EXP2>(x, w, bprep, cstv, G,
                                                      llk, m, s, st)
            : md.em == EM_EXP ? launch_llk<64, EM_EXP>(x, w, bprep, cstv, G,
                                                       llk, m, s, st)
            : launch_llk<64, EM_FAST2>(x, w, bprep, cstv, G, llk, m, s, st);
    }
#endif
    if (e != cudaSuccess) return e;
    if (sh.NS == 16)
        return launch_stats<16, 128>(x, w, llk, m, s, bprep, cstv, tiles, G,
                                     n_chunks, md, out, st);
    if (sh.NS == 80)
        return launch_stats<80, 128>(x, w, llk, m, s, bprep, cstv, tiles, G,
                                     n_chunks, md, out, st);
    return launch_stats<144, 64>(x, w, llk, m, s, bprep, cstv, tiles, G,
                                 n_chunks, md, out, st);
}

// The grouped entry's arithmetic: the default tier, (3, exp2, "3").
ModeArgs grouped_mode() { return ModeArgs(3, EM_EXP2, SF_3, 0); }

template <int NS, int TF>
cudaError_t launch_grouped(const float* x, const float* w, float* llk,
                           float* m, float* s, const bf16* bprep,
                           const float* cstv, bf16* tiles, Geo G,
                           int n_chunks, const int* chunk_start,
                           const int* chunk_row, const int* unit_row,
                           float* partials, cudaStream_t st) {
    G.nb_llk = LlkSmem<TF>(G.WP, G.la, 2).total <= SMEM_MAX ? 2 : 1;
    const LlkSmem<TF> L(G.WP, G.la, G.nb_llk);
    G.nb_stats =
        StatsSmem<NS, TF>(G.WP, G.la, G.ls, 2).total <= SMEM_MAX ? 2 : 1;
    const StatsSmem<NS, TF> LS(G.WP, G.la, G.ls, G.nb_stats);
    if (L.total > SMEM_MAX || LS.total > SMEM_MAX)
        return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        llk_grouped_kernel<TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L.total);
    if (e != cudaSuccess) return e;
    llk_grouped_kernel<TF>
        <<<(unsigned)(G.n_frames / (2 * TF)), NT, L.total, st>>>(
            x, w, bprep, cstv, G, unit_row, llk, m, s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int tiles_smem = (round_up(TF * G.D, 4) + TF) * 4;
    e = cudaFuncSetAttribute(tiles_grouped_kernel<NS, TF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tiles_smem);
    if (e != cudaSuccess) return e;
    tiles_grouped_kernel<NS, TF>
        <<<(unsigned)((long long)n_chunks * G.tiles_per_chunk), NT,
           tiles_smem, st>>>(x, s, G, chunk_start, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(stats_grouped_kernel<NS, TF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             LS.total);
    if (e != cudaSuccess) return e;
    stats_grouped_kernel<NS, TF>
        <<<(unsigned)((long long)n_chunks * G.k_blocks), NT, LS.total, st>>>(
            w, llk, m, s, bprep, cstv, tiles, G, chunk_start, chunk_row,
            partials);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer a call needs: the prepared B tiles, the
// per-frame llk, m and s, the operand tiles of the stats pass, and the
// per-chunk partials when there is more than one chunk.  K2 passes
// chunk_len = T and n_chunks = S.  logit_passes and stats_form as for the
// entry points (the pieces of B and of the operand tiles follow from them).
long long lia_stats_scratch_bytes(long long n_frames, int D, int K,
                                  int chunk_len, int n_chunks,
                                  int with_partials, int logit_passes,
                                  int stats_form) {
    const ModeArgs md(logit_passes, EM_EXP2, stats_form, 0);
    return Scratch(n_frames, D, K, chunk_len, n_chunks, with_partials != 0,
                   md).total;
}

// K1.  x (n_frames, D), w (n_frames,), the GMM as weights (K,), means and
// cov_inv (K, D), all f32.  The mode: logit_passes 1, 3 or 6; exp_mode 0
// exp2, 1 exp, 2 fast2; stats_form 0 "1", 1 "2p", 2 "2x", 3 "3", 4 "6",
// 5 "sr"; nx 1 for the exact occupancy (form "1" only); seed of "sr".
// chunk_len frames go to each chunk of the stats grid; scratch as
// lia_stats_scratch_bytes says (with partials for more than one chunk).
// out: (K+1, A).
int lia_em_stats_wgmma(const void* x, const void* w, const void* weights,
                       const void* means, const void* cov_inv,
                       long long n_frames, int D, int K, int chunk_len,
                       int logit_passes, int exp_mode, int stats_form, int nx,
                       unsigned long long seed, void* scratch, void* out,
                       void* stream) {
    if (chunk_len <= 0 || n_frames <= 0 || D <= 0 || D > 64)
        return (int)cudaErrorInvalidValue;
    const ModeArgs md(logit_passes, exp_mode, stats_form, nx);
    const int n_chunks = (int)((n_frames + chunk_len - 1) / chunk_len);
    const Scratch sc(n_frames, D, K, chunk_len, n_chunks, n_chunks > 1, md);
    cudaStream_t st = (cudaStream_t)stream;
    float* partials = n_chunks > 1
        ? reinterpret_cast<float*>((char*)scratch + sc.partials)
        : (float*)out;
    cudaError_t e = run((const float*)x, (const float*)w,
                        (const float*)weights, (const float*)means,
                        (const float*)cov_inv, n_frames, chunk_len, n_chunks,
                        K, D, md, seed, (char*)scratch, sc, partials, st);
    if (e != cudaSuccess || n_chunks == 1) return (int)e;
    const long long mm = (long long)(K + 1) * (2 * D + 2);
    reduce_chunks_kernel<<<(unsigned)((mm + NT - 1) / NT), NT, 0, st>>>(
        partials, n_chunks, mm, (float*)out);
    return (int)cudaGetLastError();
}

// K2.  x (S, T, D), w (S, T); out: (S, K+1, A), one chunk per utterance.
// The mode as for K1.
int lia_bw_stats_wgmma(const void* x, const void* w, const void* weights,
                       const void* means, const void* cov_inv, int S, int T,
                       int D, int K, int logit_passes, int exp_mode,
                       int stats_form, int nx, unsigned long long seed,
                       void* scratch, void* out, void* stream) {
    if (S <= 0 || T <= 0 || D <= 0 || D > 64)
        return (int)cudaErrorInvalidValue;
    const ModeArgs md(logit_passes, exp_mode, stats_form, nx);
    const long long n = (long long)S * T;
    const Scratch sc(n, D, K, T, S, false, md);
    return (int)run((const float*)x, (const float*)w, (const float*)weights,
                    (const float*)means, (const float*)cov_inv, n, T, S, K, D,
                    md, seed, (char*)scratch, sc, (float*)out,
                    (cudaStream_t)stream);
}

// The grouped K1: S rows, each a GMM and its own frames.  x (n_frames, D)
// and w (n_frames,) hold the rows one after another, row r from a multiple
// of GROUP_UNIT frames (padded with weight 0 to the next row), so n_frames
// too is a multiple of it.  The S models: weights (S, K), means and cov_inv
// (S, K, D).  The default tier's arithmetic only.  table (int32):
// chunk_start (n_chunks + 1: chunk c covers [chunk_start[c],
// chunk_start[c + 1]), at most chunk_len frames, a multiple of GROUP_UNIT
// long but the last of its row), chunk_row (n_chunks), row_chunks (S + 1:
// row r's chunks are row_chunks[r] .. row_chunks[r + 1] - 1), unit_row
// (n_frames / GROUP_UNIT: the row of each unit).  out: (S, K+1, A), each
// row's chunk partials added in chunk order, zeros for a row with none.
long long lia_stats_grouped_scratch_bytes(long long n_frames, int D, int K,
                                          int S, int chunk_len,
                                          int n_chunks) {
    return Scratch(n_frames, D, K, chunk_len, n_chunks, true, grouped_mode(),
                   S).total;
}

int lia_em_stats_grouped_wgmma(const void* x, const void* w,
                               const void* weights, const void* means,
                               const void* cov_inv, long long n_frames, int D,
                               int K, int S, int chunk_len, int n_chunks,
                               const void* table, void* scratch, void* out,
                               void* stream) {
    if (n_frames <= 0 || n_frames % GROUP_UNIT || chunk_len <= 0
        || chunk_len % GROUP_UNIT || n_chunks <= 0 || S <= 0 || K <= 0
        || D <= 0 || D > 64)
        return (int)cudaErrorInvalidValue;
    const ModeArgs md = grouped_mode();
    const Scratch sc(n_frames, D, K, chunk_len, n_chunks, true, md, S);
    const Shape sh(D);
    const Geo G = geo_of(n_frames, chunk_len, sc, K, D, md, 0);
    char* sp = (char*)scratch;
    bf16* bprep = reinterpret_cast<bf16*>(sp + sc.bprep);
    float* cstv = reinterpret_cast<float*>(sp + sc.cstv);
    float* llk = reinterpret_cast<float*>(sp + sc.llk);
    float* m = reinterpret_cast<float*>(sp + sc.m);
    float* s = reinterpret_cast<float*>(sp + sc.s);
    bf16* tiles = reinterpret_cast<bf16*>(sp + sc.tiles);
    float* partials = reinterpret_cast<float*>(sp + sc.partials);
    const int* chunk_start = (const int*)table;
    const int* chunk_row = chunk_start + n_chunks + 1;
    const int* row_chunks = chunk_row + n_chunks;
    const int* unit_row = row_chunks + S + 1;
    cudaStream_t st = (cudaStream_t)stream;
    prep_grouped_kernel<<<dim3(G.n_ktiles, S), 256, 0, st>>>(
        (const float*)weights, (const float*)means, (const float*)cov_inv, K,
        D, G.WP, md.la, md.fold, 1, bprep, cstv);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const float* xf = (const float*)x;
    const float* wf = (const float*)w;
    if (sh.NS == 16)
        e = launch_grouped<16, 128>(xf, wf, llk, m, s, bprep, cstv, tiles, G,
                                    n_chunks, chunk_start, chunk_row,
                                    unit_row, partials, st);
    else if (sh.NS == 80)
        e = launch_grouped<80, 128>(xf, wf, llk, m, s, bprep, cstv, tiles, G,
                                    n_chunks, chunk_start, chunk_row,
                                    unit_row, partials, st);
    else
        e = launch_grouped<144, 64>(xf, wf, llk, m, s, bprep, cstv, tiles, G,
                                    n_chunks, chunk_start, chunk_row,
                                    unit_row, partials, st);
    if (e != cudaSuccess) return (int)e;
    const long long mm = (long long)(K + 1) * (2 * D + 2);
    reduce_rows_kernel<<<dim3((unsigned)((mm + NT - 1) / NT), S), NT, 0,
                         st>>>(partials, row_chunks, mm, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
