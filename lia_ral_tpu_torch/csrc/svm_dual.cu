// C-SVC dual solver (FISTA projected gradient) for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package the solver is one jax.jit
// executable of two nested lax.scan loops (lia_ral_tpu/backend/svm.py:61
// _dual_solve) that XLA keeps on the device.  Written as eager PyTorch it
// is some 400 tiny ops a FISTA step, 2e5 launches a trained target, so the
// port runs the whole loop in one kernel.
//
// What is computed, in f32, in the JAX order of operations (Q = K o y y^T,
// formed once, each element k_ij * (y_i * y_j)):
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
// Sums are taken in another order than on the CPU (FMA chains over blocks
// of 32 columns of a row, a fixed shuffle tree, then warps and blocks in
// rank order), so alpha
// differs from the plain version at the f32 level; the order is fixed and
// no atomics are used, so a rerun equals the last to the digit.
//
// What bounds it on this card.  The bytes (Q once, N^2 4 bytes) and the
// flops (~2 N^2 a matvec) are microseconds at the main path's N = 55.  The
// bound is the dependent chain: 517 matvecs and 501 projections of 50
// bisection steps, each step a sum over all N elements.  The design of
// PRs 7-9 ran each step as a block-wide reduction (a shuffle tree and a
// __syncthreads, operands reloaded from shared memory): 25,600 reductions
// a solve in one chain, 10.5 ms at N = 55.  This design:
//
// - Bisection as a tree of candidates.  A round evaluates g at the 31
//   midpoints of the next five levels of the bisection (a complete binary
//   tree from the current (lo, hi); each node's mid is 0.5*(lo+hi) of its
//   parent's half, exactly as the 50-step loop computes it), sums the 31
//   partials across the warp in one transpose-reduce (16+8+4+2+1
//   shuffles: lane c ends with candidate c's total), then across warps and
//   blocks in rank order, and walks the tree from the root with one
//   __ballot_sync(g > 0).  Every mid the walk visits is one the 50-step
//   loop visits, so lam is that loop's lam for the same g-sums: 10 rounds
//   a projection instead of 50 reductions, one barrier a round at most.
// - Per-element state in registers.  A thread owns two rows (tid and
//   tid + threads) and keeps their alpha, alpha_prev, the projection's
//   input, y and C in registers for the whole solve; rows past N are
//   y = C = 0 and add exact zeros to every sum.
// - Q on chip, formed once.  A lane reads its own rows of Q (row stride a
//   multiple of 4 floats whose quarter is odd, so eight lanes' 16-byte
//   reads fall in eight bank groups) against the vector as a broadcast:
//   no shuffle tree per row.
//
// Regimes (the wrapper's host-side plan, backend/svm.py:solve_plan):
// - resident, one block: N <= 232, Q whole in the block's shared memory;
//   N <= 64 runs in one warp, so every sum is a __shfl_xor_sync butterfly
//   or the transpose-reduce and the kernel has no barrier but __syncwarp.
// - resident, a cluster: each block of a thread-block cluster of 2-16
//   holds its slice of Q's rows; the vector (each block's rows written
//   into every block's copy through distributed shared memory) and every
//   round's partials are exchanged the same way, then cluster.sync(); all
//   blocks sum the blocks' partials in rank order, so all take the same
//   branch.
// - streaming, a cluster of the largest size the card co-schedules (16
//   on an H100): Q is formed once into a padded scratch in device memory
//   and each block streams its rows through a two-stage cp.async ring of
//   column tiles, the next matvec's first tiles loading during the
//   projection.  One SM's bandwidth to L2 / HBM becomes the cluster's.
// The chain of one round (N <= 64, one warp, SM cycles; latencies
// measured on the H100, PERF.md section 6): ~480 instructions
// issued in order (31 mids; 62 candidate terms of 4 FP instructions in
// the FMA form of +-1 labels, 6 otherwise; the transpose-reduce's 31
// shuffles, 62 selects, 31 adds; the ballot; the walk) and ~260 cycles of
// latency they cannot hide (five shuffle levels of 26, the ballot, the
// walk's five dependent steps, the mids' five levels): ~740.  Measured by
// clock64 at N = 55: 8,793 cycles a projection (~880 a round) and 1,238
// a matvec with its publication, 2.76 ms a solve against PR 9's 10.4.  A
// round of a cluster adds a cluster barrier (906 cycles for 16 blocks),
// and a streaming matvec waits on L2 / HBM: at N = 1,001 22,031 + 32,551
// cycles a FISTA step, 14.3 ms (73.1 in PR 9); at N = 4,096 220,806 +
// 32,948, 67.9 ms (1,225).
//
// Plain C interface, bound with ctypes.  The entry point launches on the
// given stream and returns cudaGetLastError() (0 = success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_N = 8192;
constexpr int MAX_THREADS = 256;
constexpr int MAX_CLUSTER = 16;
constexpr int SMEM_BYTES = 232448;
constexpr int POWER_STEPS = 16;
constexpr int ROUNDS = 10;              // x 5 levels = the 50 halvings
constexpr int RED_FLOATS = 2 * 32 * 32;           // [parity][warp][lane]
constexpr int XCH_FLOATS = 2 * MAX_CLUSTER * 32;  // [parity][rank][lane]

struct Params {
    const float* k;
    const float* y;
    const float* c;
    float* out;
    float* qbuf;      // streaming: (B, N, qstride) Q, zero-padded
    int n, n_iter, cs, rows, tc, resident;
};

__host__ __device__ inline int row_stride(int cols) {
    int s = (cols + 3) / 4 * 4;
    return (s / 4) % 2 == 0 ? s + 4 : s;
}

// the vector's length in shared memory: N padded to the tiles' width
__host__ __device__ inline int vec_len(const Params& p) {
    if (p.resident) return (p.n + 3) / 4 * 4;
    return (p.n + p.tc - 1) / p.tc * p.tc;
}

__host__ __device__ inline int tile_floats(const Params& p) {
    if (p.resident) return p.rows * row_stride(vec_len(p));
    return 2 * p.rows * (p.tc + 4);
}

__host__ __device__ inline long long smem_bytes(const Params& p) {
    return 4LL * (vec_len(p) + RED_FLOATS + XCH_FLOATS + tile_floats(p));
}

struct Ctx {
    int tid, lane, warp, nwarps, nthreads, cs, rank, par;
    float* red;
    float* xch;
};

__device__ __forceinline__ float clip(float v, float c) {
    return fminf(fmaxf(v, 0.f), c);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// Lane l holds a warp-level value v_l (a total, or candidate l's partial
// sum).  Returns, in every thread of every block of the problem, the sum
// (or max) of v_l over the warps and then the blocks, in rank order: one
// __syncthreads with several warps, one cluster barrier with several
// blocks.  Alternating buffers make the next call's writes safe.
template <bool MAX>
__device__ __forceinline__ float combine(float v, Ctx& x) {
    if (x.nwarps > 1) {
        float* b = x.red + x.par * 1024;
        b[x.warp * 32 + x.lane] = v;
        __syncthreads();
        v = b[x.lane];
        for (int w = 1; w < x.nwarps; ++w)
            v = MAX ? fmaxf(v, b[w * 32 + x.lane]) : v + b[w * 32 + x.lane];
    }
    if (x.cs > 1) {
        cg::cluster_group cl = cg::this_cluster();
        const int slot = x.par * MAX_CLUSTER * 32;
        if (x.warp == 0)
            for (int r = 0; r < x.cs; ++r)
                cl.map_shared_rank(x.xch, r)[slot + x.rank * 32 + x.lane] = v;
        cl.sync();
        const float* s = x.xch + slot;
        v = s[x.lane];
        for (int r = 1; r < x.cs; ++r)
            v = MAX ? fmaxf(v, s[r * 32 + x.lane]) : v + s[r * 32 + x.lane];
    }
    x.par ^= 1;
    return v;
}

// the shared vector is complete in every block of the problem
__device__ __forceinline__ void publish_barrier(const Ctx& x) {
    if (x.cs > 1) cg::this_cluster().sync();
    else if (x.nwarps > 1) __syncthreads();
    else __syncwarp();
}

// c ? a : b as a predicated select the compiler cannot turn into an
// indexed local-memory load of p[] (it did, 128 bytes of stack a thread)
__device__ __forceinline__ float pick(bool c, float a, float b) {
    float r;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
        "selp.f32 %0, %1, %2, q;\n\t}"
        : "=f"(r) : "f"(a), "f"(b), "r"((int)c));
    return r;
}

// one exchange of the transpose-reduce: the lanes at xor distance W
// swap halves of p[0, 2W), each keeping the half its bit W names
template <int W>
__device__ __forceinline__ void exchange(float (&p)[32], int lane) {
    const bool up = lane & W;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        const float send = pick(up, p[i], p[i + W]);
        const float keep = pick(up, p[i + W], p[i]);
        p[i] = keep + __shfl_xor_sync(FULL, send, W);
    }
}

// The sum of the 32 p[i] of the warp's lanes, candidate c in lane c.
__device__ __forceinline__ float transpose_reduce(float (&p)[32], int lane) {
    exchange<16>(p, lane);
    exchange<8>(p, lane);
    exchange<4>(p, lane);
    exchange<2>(p, lane);
    exchange<1>(p, lane);
    return p[0];
}

// This thread's share of g(mid): clip(a_e - mid y_e, 0, C_e) y_e summed
// over its two rows, each op rounded as the plain loop rounds it.  With
// UNIT (every y is +-1, or 0 past N) mid y and v y are exact, so one FMA
// rounds as the separate product and difference (or sum) do: 4
// instructions a term instead of 6.
template <bool UNIT>
__device__ __forceinline__ float g_share(const float (&a)[2],
                                         const float (&ys)[2],
                                         const float (&cs)[2], float mid) {
    float g;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const float v = UNIT ? clip(fmaf(-mid, ys[e], a[e]), cs[e])
                             : clip(__fsub_rn(a[e], __fmul_rn(mid, ys[e])),
                                    cs[e]);
        if (e == 0) g = __fmul_rn(v, ys[e]);
        else g = UNIT ? fmaf(v, ys[e], g) : __fadd_rn(g, __fmul_rn(v, ys[e]));
    }
    return g;
}

// lam of project(a) over the problem's rows; every thread returns it.
template <bool UNIT>
__device__ float bisect(const float (&a)[2], const float (&ys)[2],
                        const float (&cs)[2], float c_max, Ctx& x) {
    float m = fmaxf(fabsf(a[0]), fabsf(a[1]));
    m = combine<true>(warp_max(m), x);
    const float span = __fadd_rn(__fadd_rn(m, c_max), 1.f);
    float lo = -span, hi = span;
    for (int round = 0; round < ROUNDS; ++round) {
        // node h = 1..31 of the tree (children 2h, 2h+1): its interval
        // (L[h], H[h]), its mid, and this thread's partial g there
        float L[32], H[32], p[32];
        L[1] = lo;
        H[1] = hi;
#pragma unroll
        for (int h = 1; h < 32; ++h) {
            const float mid = __fmul_rn(0.5f, __fadd_rn(L[h], H[h]));
            if (h < 16) {
                L[2 * h] = L[h];
                H[2 * h] = mid;
                L[2 * h + 1] = mid;
                H[2 * h + 1] = H[h];
            }
            p[h - 1] = g_share<UNIT>(a, ys, cs, mid);
        }
        p[31] = 0.f;
        const float total = combine<false>(transpose_reduce(p, x.lane), x);
        const unsigned pos = __ballot_sync(FULL, total > 0.f);
        int h = 1;
#pragma unroll
        for (int level = 0; level < 5; ++level) {
            const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
            const unsigned up = (pos >> (h - 1)) & 1u;
            if (up) lo = mid; else hi = mid;
            h = 2 * h + (int)up;
        }
    }
    return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// cp.async of 16 bytes, global -> shared
__device__ __forceinline__ void copy16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

struct Stream {                 // the streaming regime's ring
    const float* q;             // this block's first row of Q (qstride)
    float* ring;                // 2 stages of rows x (tc + 4)
    int qstride, tc, ntiles, rows_here;
    long long next;             // tiles issued so far (tile = next % nt)

    __device__ void issue(const Ctx& x) {
        const int tile = (int)(next % ntiles);
        float* dst = ring + (int)(next & 1) * rows_here * (tc + 4);
        const float* src = q + tile * tc;
        const int per_row = tc / 4, shift = __ffs(per_row) - 1;
        const int chunks = rows_here * per_row;
        for (int i = x.tid; i < chunks; i += x.nthreads) {
            const int r = i >> shift, c4 = i & (per_row - 1);
            copy16(dst + r * (tc + 4) + 4 * c4,
                   src + (long long)r * qstride + 4 * c4);
        }
        copy_commit();
        ++next;
    }
};

// acc[e] += row lr[e] of a tile (stride ts) against vec[0 .. w), w a
// multiple of 4, for the rows ROWS (1 or 2) the warp needs: four FMA
// chains a row (one a float4 component) over blocks of 32 columns, each
// block's sum added to acc in order, so a rounding chain is ~N/32 + 8
// long rather than N/2
template <int ROWS>
__device__ __forceinline__ void dot_rows(const float* tile, int ts,
                                         const float* vec, int w,
                                         const int (&lr)[2],
                                         float (&acc)[2]) {
    const float4* v4 = reinterpret_cast<const float4*>(vec);
    const float4* r[2] = {reinterpret_cast<const float4*>(tile + lr[0] * ts),
                          reinterpret_cast<const float4*>(tile + lr[1] * ts)};
    for (int q0 = 0; q0 < w / 4; q0 += 8) {
        const int q1 = min(q0 + 8, w / 4);
        float4 sum[ROWS];
#pragma unroll
        for (int e = 0; e < ROWS; ++e) sum[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = q0; q < q1; ++q) {
            const float4 v = v4[q];
#pragma unroll
            for (int e = 0; e < ROWS; ++e) {
                const float4 a = r[e][q];
                sum[e].x = fmaf(a.x, v.x, sum[e].x);
                sum[e].y = fmaf(a.y, v.y, sum[e].y);
                sum[e].z = fmaf(a.z, v.z, sum[e].z);
                sum[e].w = fmaf(a.w, v.w, sum[e].w);
            }
        }
#pragma unroll
        for (int e = 0; e < ROWS; ++e)
            acc[e] += (sum[e].x + sum[e].y) + (sum[e].z + sum[e].w);
    }
}

// the rows of the tile that some lane of the warp owns: a warp with none
// reads no shared memory (idle warps' reads had taken the matvec's
// shared-memory bandwidth at N = 1,001)
__device__ __forceinline__ void dot_tile(const float* tile, int ts,
                                         const float* vec, int w,
                                         const int (&lr)[2], int rows,
                                         float (&acc)[2]) {
    if (rows == 2) dot_rows<2>(tile, ts, vec, w, lr, acc);
    else if (rows == 1) dot_rows<1>(tile, ts, vec, w, lr, acc);
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
svm_dual_kernel(const Params prm) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int vlen = vec_len(prm);
    float* vec = smem;                       // the full broadcast vector
    float* red = vec + vlen;
    float* xch = red + RED_FLOATS;
    float* tiles = xch + XCH_FLOATS;

    Ctx x;
    x.tid = threadIdx.x;
    x.lane = x.tid & 31;
    x.warp = x.tid >> 5;
    x.nwarps = blockDim.x >> 5;
    x.nthreads = blockDim.x;
    x.cs = prm.cs;
    x.rank = prm.cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
    x.par = 0;
    x.red = red;
    x.xch = xch;
    if (x.cs > 1) cg::this_cluster().sync();   // every block has started

    const int n = prm.n;
    const long long prob = blockIdx.x / prm.cs;
    const int row0 = x.rank * prm.rows;
    const int rows_here = max(0, min(prm.rows, n - row0));
    const float* kp = prm.k + prob * n * (long long)n;
    const float* yp = prm.y + prob * n;

    // this thread's rows and their y, C (rows past N: y = C = 0)
    int lr[2];
    bool own[2];
    float ys[2], cs[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int r = x.tid + e * x.nthreads;
        own[e] = r < rows_here;
        lr[e] = own[e] ? r : 0;
        ys[e] = own[e] ? yp[row0 + r] : 0.f;
        cs[e] = own[e] ? prm.c[prob * n + row0 + r] : 0.f;
    }

    // the rows any lane of this warp owns (1 or 2; 0: the warp has none)
    const int warp_rows = __any_sync(FULL, own[1]) ? 2
                          : __any_sync(FULL, own[0]) ? 1 : 0;

    // Q's rows of this block, formed once: in shared memory (resident) or
    // into the zero-padded scratch that the ring streams
    Stream st{};
    int ts = row_stride(vlen);
    if (prm.resident) {
        for (int r = x.warp; r < rows_here; r += x.nwarps) {
            const float yr = yp[row0 + r];
            const float* kr = kp + (long long)(row0 + r) * n;
            for (int j = x.lane; j < ts; j += 32)
                tiles[r * ts + j] =
                    j < n ? __fmul_rn(kr[j], __fmul_rn(yr, yp[j])) : 0.f;
        }
    } else {
        ts = prm.tc + 4;
        st.qstride = vlen;
        st.tc = prm.tc;
        st.ntiles = vlen / prm.tc;
        st.rows_here = rows_here;
        st.ring = tiles;
        float* qp = prm.qbuf + (prob * n + row0) * (long long)vlen;
        st.q = qp;
        for (int r = x.warp; r < rows_here; r += x.nwarps) {
            const float yr = yp[row0 + r];
            const float* kr = kp + (long long)(row0 + r) * n;
            for (int j = x.lane; j < vlen; j += 32)
                qp[(long long)r * vlen + j] =
                    j < n ? __fmul_rn(kr[j], __fmul_rn(yr, yp[j])) : 0.f;
        }
        __threadfence_block();
        __syncthreads();
        st.next = 0;
        st.issue(x);
        st.issue(x);
    }
    for (int j = n + x.tid; j < vlen; j += x.nthreads)
        vec[j] = 0.f;                        // the padding of the vector

    // (Q vec)[rows] for the thread's two rows; vec published first
    auto matvec = [&](float (&s)[2]) {
        float acc[2] = {0.f, 0.f};
        if (prm.resident) {
            dot_tile(tiles, ts, vec, vlen, lr, warp_rows, acc);
        } else {
            for (int t = 0; t < st.ntiles; ++t) {
                copy_wait<1>();
                __syncthreads();
                dot_tile(tiles + (int)((st.next - 2) & 1) * rows_here * ts,
                         ts, vec + t * prm.tc, prm.tc, lr, warp_rows, acc);
                __syncthreads();
                st.issue(x);       // wraps round: the next matvec's tiles
            }
        }
        s[0] = acc[0];
        s[1] = acc[1];
    };
    // write the thread's rows of a vector into every block's copy
    auto publish = [&](const float (&v)[2]) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            if (!own[e]) continue;
            const int g = row0 + lr[e];
            if (x.cs > 1) {
                cg::cluster_group cl = cg::this_cluster();
                for (int r = 0; r < x.cs; ++r)
                    cl.map_shared_rank(vec, r)[g] = v[e];
            } else {
                vec[g] = v[e];
            }
        }
        publish_barrier(x);
    };

    const float c_max = combine<true>(warp_max(fmaxf(cs[0], cs[1])), x);
    // every label +-1 (rows past N have y = 0): the bisection's terms
    // take the FMA form
    const bool unit = combine<true>(warp_max(
        (own[0] && fabsf(ys[0]) != 1.f) || (own[1] && fabsf(ys[1]) != 1.f)
            ? 1.f : 0.f), x) == 0.f;
    auto project_lam = [&](const float (&v)[2]) {
        return unit ? bisect<true>(v, ys, cs, c_max, x)
                    : bisect<false>(v, ys, cs, c_max, x);
    };

    // step size: 16 power steps, then |v . Qv|
    const float v0 = __fdiv_rn(1.f, (float)n);
    float v[2] = {own[0] ? v0 : 0.f, own[1] ? v0 : 0.f};
    float w[2];
    for (int it = 0; it < POWER_STEPS; ++it) {
        publish(v);
        matvec(w);
        w[0] = own[0] ? w[0] : 0.f;
        w[1] = own[1] ? w[1] : 0.f;
        const float ss = combine<false>(
            warp_sum(__fadd_rn(__fmul_rn(w[0], w[0]),
                               __fmul_rn(w[1], w[1]))), x);
        const float nrm = fmaxf(sqrtf(ss), 1e-12f);
        v[0] = __fdiv_rn(w[0], nrm);
        v[1] = __fdiv_rn(w[1], nrm);
    }
    publish(v);
    matvec(w);
    w[0] = own[0] ? w[0] : 0.f;
    w[1] = own[1] ? w[1] : 0.f;
    const float vq = combine<false>(
        warp_sum(__fadd_rn(__fmul_rn(v[0], w[0]), __fmul_rn(v[1], w[1]))), x);
    const float lr_ = __fdiv_rn(1.f, fmaxf(fabsf(vq), 1e-8f));

    float al[2] = {0.f, 0.f}, pr[2] = {0.f, 0.f}, a[2], mom[2], s[2];
    float t = 1.f;
    for (int it = 0; it < prm.n_iter; ++it) {
        const float f = __fdiv_rn(__fsub_rn(t, 1.f), __fadd_rn(t, 2.f));
#pragma unroll
        for (int e = 0; e < 2; ++e)
            mom[e] = __fadd_rn(al[e], __fmul_rn(f, __fsub_rn(al[e], pr[e])));
        publish(mom);
        matvec(s);
#pragma unroll
        for (int e = 0; e < 2; ++e)
            a[e] = own[e] ? __fadd_rn(mom[e],
                                      __fmul_rn(lr_, __fsub_rn(1.f, s[e])))
                          : 0.f;
        const float lam = project_lam(a);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            pr[e] = al[e];
            al[e] = clip(__fsub_rn(a[e], __fmul_rn(lam, ys[e])), cs[e]);
        }
        t = __fadd_rn(t, 1.f);
    }
    const float lam = project_lam(al);
#pragma unroll
    for (int e = 0; e < 2; ++e)
        if (own[e])
            prm.out[prob * n + row0 + lr[e]] =
                clip(__fsub_rn(al[e], __fmul_rn(lam, ys[e])), cs[e]);
    if (!prm.resident) copy_wait<0>();
    if (x.cs > 1) cg::this_cluster().sync();   // no block leaves early
}

}  // namespace

extern "C" {

// The largest cluster (<= 16 blocks of `threads` threads and the most
// shared memory a block may take) that the card co-schedules, 1 if none.
int lia_svm_max_cluster(int threads) {
    cudaFuncSetAttribute(svm_dual_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaFuncSetAttribute(svm_dual_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    for (int cs = MAX_CLUSTER; cs > 1; --cs) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(cs);
        cfg.blockDim = dim3(threads);
        cfg.dynamicSmemBytes = SMEM_BYTES;
        cudaLaunchAttribute attr;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = cs;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        int active = 0;
        if (cudaOccupancyMaxActiveClusters(&active, svm_dual_kernel, &cfg)
                == cudaSuccess && active > 0)
            return cs;
        cudaGetLastError();
    }
    return 1;
}

// The shared memory a block of the plan (N, rows a block, tile columns
// tc, resident) takes, and the most it may take: the layout the wrapper's
// solve_plan mirrors to plan without a card.
long long lia_svm_shared_bytes(int N, int rows, int tc, int resident) {
    Params p{};
    p.n = N;
    p.rows = rows;
    p.tc = tc;
    p.resident = resident;
    return smem_bytes(p);
}

int lia_svm_shared_limit() { return SMEM_BYTES; }

// k (B, N, N) f32 kernel matrices, y (B, N) labels, c (B, N) box bounds,
// alpha (B, N) f32 out; qbuf: (B, N, vec_len) f32 scratch in the
// streaming regime (resident == 0), else unused.  The plan (cluster size
// cs, threads, rows a block, tile columns tc, resident) comes from the
// wrapper's solve_plan; 1 <= N <= 8192, B >= 1, n_iter >= 0.
int lia_svm_dual(const void* k, const void* y, const void* c, void* alpha,
                 void* qbuf, int B, int N, int n_iter, int cs, int threads,
                 int rows, int tc, int resident, void* stream) {
    Params p{(const float*)k, (const float*)y, (const float*)c,
             (float*)alpha, (float*)qbuf, N, n_iter, cs, rows, tc,
             resident};
    if (B < 1 || N < 1 || N > MAX_N || n_iter < 0 || cs < 1
        || cs > MAX_CLUSTER || threads < 32 || threads > MAX_THREADS
        || threads % 32 || rows < 1 || (long long)rows * cs < N
        || 2 * threads < rows || (!resident && (qbuf == nullptr
        || tc < 32 || (tc & (tc - 1)))) || smem_bytes(p) > SMEM_BYTES)
        return (int)cudaErrorInvalidValue;
    const int smem = (int)smem_bytes(p);
    cudaError_t e = cudaFuncSetAttribute(
        svm_dual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)B * (unsigned)cs);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr;
    if (cs > 1) {
        e = cudaFuncSetAttribute(
            svm_dual_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
            1);
        if (e != cudaSuccess) return (int)e;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = cs;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
    }
    e = cudaLaunchKernelEx(&cfg, svm_dual_kernel, p);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // extern "C"
