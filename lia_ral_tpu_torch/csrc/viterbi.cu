// Log-domain Viterbi decoding of a small HMM for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package the recursion is two
// lax.scan loops (lia_ral_tpu/seg/hmm.py:71 _viterbi) that XLA compiles.
// In plain PyTorch it is a Python loop of three tiny ops a frame, and a
// diarization run decodes a recording some twenty times, so the port
// gives the recursion a kernel of its own.
//
// What is computed, all in f32 adds and maxima (no rounding freedom, so
// the path equals the plain loop's to the state):
//   delta_0[j] = em[0][j] - log S
//   delta_t[j] = max_i (delta_{t-1}[i] + lt[i][j]) + em[t][j],
//   back_t[j]  = the smallest i that reaches the maximum,
//   state_{N-1} = the smallest j with the largest delta_{N-1}[j],
//   state_{t-1} = back_t[state_t],
//   path[N-1] = state_{N-1} and path[t] = state_{t+1} for t < N-1: the
//   JAX package's reverse scan emits the state it holds before stepping
//   back, and the port labels every frame as that package does.
//
// What bounds it on this card.  The bytes are nothing (N S 4 of emissions
// in, N 8 of path out).  The bound is the dependent chain: step t needs
// every delta of step t-1.  States are speakers or acoustic events, so
// S <= 32 and one warp holds a step: lane j keeps delta[j] in a register,
// the lanes exchange their deltas, and lane j takes the maximum of the
// SP candidates delta[i] + lt[i][j] (SP = S up to 8, else S rounded up to
// 16 or 32; the padding candidates are -inf) by a fmaxf tree and adds its
// emission.  Latencies measured on the H100 (PERF.md, section 6):
// SHFL.IDX 26 SM cycles, LDS 29, a warp's STS + __syncwarp + LDS 28,
// FADD/FFMA and FMNMX 4.  So the chain of a step is one exchange, an
// add, ceil(log2 SP) levels of fmaxf and an add: ~49 cycles at S = 5.
//
// A compare-and-select tournament that carries value and index on the
// chain (FSETP then FSEL a level), with a branch round the back-pointer
// store (a reconvergence barrier), a 64-bit index and frame guard and a
// reload of S from the constant bank, took 258 cycles a step (clock64);
// this design takes 78 (PERF.md has the steps between); the ~29 cycles
// above the chain's estimate are not attributed yet.
//
// - Forward (warp 0): per step one store of delta[j] into one of two
//   32-float exchange buffers, a __syncwarp, SP / 4 broadcast loads of
//   the others (at least one), SP adds, the fmaxf tree, the emission's
//   add, and one store of delta[j] to the caller's device scratch (fire
//   and forget; L2 holds it: 611 KB at the diarization's 30,573 x 5).
//   No branch: an idle lane stores past the N rows.
//   Emissions come from a three-slot shared-memory ring that the warp
//   fills itself with cp.async a chunk (64 steps) ahead, so a step reads
//   shared memory and holds no prefetch registers; steps use 32-bit
//   indices (N S < 2^31).  The idle warps meanwhile stage lt by column.
// - Back pointers (the whole block, rows spread over its 256 threads):
//   for row r (step r + 1) and each state k, the smallest i with the
//   largest delta_r[i] + lt[i][k], the sums and the maximum rounded as
//   the forward rounded them, so each byte is the one the forward would
//   have chosen (on the forward, the index's compares and selects sat on
//   the chain: the warp issues in order).  Bytes, the first BP_SHARED of
//   them (N S up to ~198 KB:
//   every decode of the diarization, 30,572 x 5 = 152,860) in shared
//   memory, the rest in the caller's device scratch.
// - Backtrace by composing maps instead of walking N dependent reads in
//   one thread: each of the 256 threads owns a contiguous chunk of the
//   N-1 rows and walks it from each of the S possible states at its top
//   (S independent chains), giving its chunk's map; one thread composes
//   the 256 maps from the last state; then every thread writes its
//   chunk's path from its now-known top state.  The chain is N/256 + 256
//   + N/256 dependent reads instead of N, and the result is the
//   sequential backtrace's, index for index.
//
// One block of 256 threads.  The loops over the previous states are
// unrolled to SP = S for S <= 8 (no padding candidates on the
// diarization's chains), to 16 or 32 above (template SP).
//
// Plain C interface, bound with ctypes.  The entry point launches on the
// given stream and returns cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 256;          // threads of the one block
constexpr int CH = 64;           // steps of emissions a ring slot holds
constexpr int SLOTS = 3;
constexpr int SMEM_BYTES = 232448;
constexpr int DYN_BYTES = SMEM_BYTES - 1024;   // beside the static arrays
constexpr int RING_BYTES = SLOTS * CH * 32 * 4;      // for S = 32
constexpr int MAP_BYTES = NT * 32;                   // [thread][state]
constexpr int TOP_BYTES = NT;                        // [thread]
constexpr int BP_SHARED = DYN_BYTES - RING_BYTES - MAP_BYTES - TOP_BYTES;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void copy4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

// the emissions of steps [k CH, (k+1) CH) n [0, N) into ring slot k % 3;
// one commit group whether or not there are any
__device__ __forceinline__ void fill(float* ring, const float* em, int k,
                                     int N, int S, int lane) {
    const int t0 = k * CH;
    const int count = t0 < N ? (min(t0 + CH, N) - t0) * S : 0;
    float* dst = ring + (k % SLOTS) * CH * S;
    const float* src = em + t0 * S;
    for (int i = lane; i < count; i += 32) copy4(dst + i, src + i);
    asm volatile("cp.async.commit_group;\n" ::);
}

// For lane j, the candidates c[i] = delta of lane i + add[i] (add[i] =
// -inf for i >= S): lane j writes its delta into one of two 32-float
// buffers, and after a __syncwarp every lane reads the first SP as
// 16-byte broadcasts (SP / 4 loads, at least one).
// With five shuffles instead a step took 85 cycles, with these two loads
// 78 (S = 5).  The two buffers alternate, so one __syncwarp a step orders
// each write after the previous step's reads.
template <int SP>
__device__ __forceinline__ void exchanged(float* buf, float delta, int j,
                                          const float (&add)[SP],
                                          float (&c)[SP]) {
    buf[j] = delta;
    __syncwarp();
    const float4* b4 = reinterpret_cast<const float4*>(buf);
#pragma unroll
    for (int q = 0; q < (SP + 3) / 4; ++q) {
        const float4 v = b4[q];
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
            if (4 * q + r < SP) c[4 * q + r] = w[r] + add[4 * q + r];
    }
}

// the maximum of c by a fmaxf tree, and the smallest i whose candidate
// equals it (compares against the maximum)
template <int SP>
__device__ __forceinline__ float maximum(const float (&c)[SP]) {
    float m[SP];
#pragma unroll
    for (int i = 0; i < SP; ++i) m[i] = c[i];
#pragma unroll
    for (int w = 1; w < SP; w <<= 1)
#pragma unroll
        for (int i = 0; i + w < SP; i += 2 * w) m[i] = fmaxf(m[i], m[i + w]);
    return m[0];
}

template <int SP>
__device__ __forceinline__ unsigned char first_index(const float (&c)[SP],
                                                     float m) {
    int a = SP - 1;
#pragma unroll
    for (int i = SP - 2; i >= 0; --i) a = c[i] == m ? i : a;
    return (unsigned char)a;
}

// back pointer byte idx: shared memory below BP_SHARED, device above
__device__ __forceinline__ unsigned char* bp_at(unsigned char* sbp,
                                                unsigned char* gbp, int idx) {
    return idx < BP_SHARED ? sbp + idx : gbp + (idx - BP_SHARED);
}

template <int SP>
__global__ void __launch_bounds__(NT, 1)
viterbi_kernel(const float* __restrict__ em, const float* __restrict__ lt,
               int N, int S, float log_s, float* __restrict__ deltas,
               unsigned char* __restrict__ gbp,
               long long* __restrict__ path) {
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    unsigned char* maps = reinterpret_cast<unsigned char*>(smem4) +
                          RING_BYTES;
    unsigned char* tops = maps + MAP_BYTES;
    unsigned char* sbp = tops + TOP_BYTES;
    // lt by column for the back pointers, in the maps' region (the maps
    // are written after the back pointers)
    float* slt = reinterpret_cast<float*>(maps);
    __shared__ int s_last;
    __shared__ float4 xch4[16];               // the deltas' exchange
    float* xch = reinterpret_cast<float*>(xch4);
    const int tid = threadIdx.x;
    if (tid >= 32)                 // the idle warps, during the forward
        for (int x = tid - 32; x < 32 * 32; x += NT - 32) {
            const int k = x >> 5, i = x & 31;
            slt[x] = i < S && k < S ? lt[i * S + k] : -CUDART_INF_F;
        }

    if (tid < 32) {
        const int j = tid;
        const bool on = j < S;
        const int jc = on ? j : 0;             // idle lanes read column 0
        float ltc[SP];                         // column j of log_trans
#pragma unroll
        for (int i = 0; i < SP; ++i)
            ltc[i] = i < S ? lt[i * S + jc] : -CUDART_INF_F;

        fill(ring, em, 0, N, S, j);
        fill(ring, em, 1, N, S, j);
        float delta = em[jc] - log_s;
        // lane j's deltas at deltas[t S + j]; an idle lane's past the N
        // rows (the caller's scratch has 32 floats more), so the step has
        // no branch
        int off = on ? j : N * S + j;
        const int stride = on ? S : 0;
        deltas[off] = delta;
        off += stride;
        int par = 0;                           // the exchange's buffer
        const int chunks = (N + CH - 1) / CH;
        for (int k = 0; k < chunks; ++k) {
            asm volatile("cp.async.wait_group 1;\n" ::);
            __syncwarp();
            fill(ring, em, k + 2, N, S, j);
            const float* slot = ring + (k % SLOTS) * CH * S;
            const int tb = k == 0 ? 1 : 0;
            const int te = min(CH, N - k * CH);
#pragma unroll 4
            for (int u = tb; u < te; ++u) {
                const float e = slot[u * S + jc];
                float c[SP];
                exchanged<SP>(xch + par, delta, j, ltc, c);
                par ^= 32;
                delta = maximum<SP>(c) + e;
                deltas[off] = delta;
                off += stride;
            }
        }
        asm volatile("cp.async.wait_group 0;\n" ::);

        // the last state: the same maximum over delta alone (0 for a real
        // state, -inf for the padding)
#pragma unroll
        for (int i = 0; i < SP; ++i) ltc[i] = i < S ? 0.f : -CUDART_INF_F;
        float c[SP];
        exchanged<SP>(xch + par, delta, j, ltc, c);
        const int last = first_index<SP>(c, maximum<SP>(c));
        if (j == 0) {
            s_last = last;
            path[N - 1] = last;
        }
    }
    __syncthreads();               // the deltas and s_last are visible

    // back pointers from the deltas, rows spread over the block: row r
    // (step r + 1) holds, for each state k, the smallest i with the
    // largest delta_r[i] + lt[i][k], the sums and the maximum rounded as
    // the forward rounded them
    {
        // lt by column from shared memory (slt[k][i] = lt[i][k]); in
        // registers up to 8 states
        float ltm[SP <= 8 ? SP : 1][SP <= 8 ? SP : 1];
        if constexpr (SP <= 8) {
#pragma unroll
            for (int k = 0; k < SP; ++k)
#pragma unroll
                for (int i = 0; i < SP; ++i) ltm[k][i] = slt[k * 32 + i];
        }
        for (int r = tid; r < N - 1; r += NT) {
            float d[SP];
#pragma unroll
            for (int i = 0; i < SP; ++i)
                d[i] = i < S ? deltas[r * S + i] : 0.f;
#pragma unroll
            for (int k = 0; k < SP; ++k) {
                if (k >= S) break;
                float c[SP];
#pragma unroll
                for (int i = 0; i < SP; ++i) {
                    if constexpr (SP <= 8) c[i] = d[i] + ltm[k][i];
                    else c[i] = d[i] + slt[k * 32 + i];
                }
                *bp_at(sbp, gbp, r * S + k) =
                    first_index<SP>(c, maximum<SP>(c));
            }
        }
    }
    __syncthreads();               // the maps' region is free again

    // rows r = 0 .. N-2 of back pointers (row r: step r + 1); thread c
    // owns rows [lo, hi) and maps the state at hi to the state at lo
    const int rows = N - 1;
    const int len = (rows + NT - 1) / NT;
    const int lo = min(tid * len, rows), hi = min(lo + len, rows);
    {
        int cur[SP];
#pragma unroll
        for (int s = 0; s < SP; ++s) cur[s] = s < S ? s : 0;
        for (int r = hi - 1; r >= lo; --r)
#pragma unroll
            for (int s = 0; s < SP; ++s)
                if (s < S) cur[s] = *bp_at(sbp, gbp, r * S + cur[s]);
#pragma unroll
        for (int s = 0; s < SP; ++s)
            if (s < S) maps[tid * 32 + s] = (unsigned char)cur[s];
    }
    __syncthreads();
    if (tid == 0) {
        int state = s_last;
        for (int c = NT - 1; c >= 0; --c) {
            tops[c] = (unsigned char)state;
            state = maps[c * 32 + state];
        }
    }
    __syncthreads();
    int state = tops[tid];
    for (int r = hi - 1; r >= lo; --r) {
        path[r] = state;
        state = *bp_at(sbp, gbp, r * S + state);
    }
}

template <int SP>
cudaError_t launch(const float* em, const float* lt, int N, int S,
                   float log_s, float* deltas, unsigned char* bp,
                   long long* path, cudaStream_t st) {
    cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel<SP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DYN_BYTES);
    if (e != cudaSuccess) return e;
    viterbi_kernel<SP><<<1, NT, DYN_BYTES, st>>>(em, lt, N, S, log_s,
                                                 deltas, bp, path);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Back pointer bytes held in shared memory; the caller's scratch holds
// the rest, (N - 1) S - BP_SHARED bytes where that is positive.
int lia_viterbi_shared_bytes() { return BP_SHARED; }

// em (N, S) f32, lt (S, S) f32 log transitions (row: previous state),
// log_s = log S as the caller rounds it, deltas: (N S + 32) floats of
// scratch, bp: the back pointers' scratch beyond the shared memory's
// (above),
// path: (N,) int64.  1 <= S <= 32, N >= 1, (N + 128) S + 32 < 2^31: the
// kernel's indices are 32-bit, and the largest it forms is the ring's
// source em + t0 S for a chunk t0 up to N + 127 (idle lanes' deltas at
// N S + 31 and the back pointers' (N - 1) S lie below it).
int lia_viterbi(const void* em, const void* lt, long long N, int S,
                float log_s, void* deltas, void* bp, void* path,
                void* stream) {
    if (N < 1 || S < 1 || S > 32 || (N + 128) * S + 32 >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const float* e = (const float*)em;
    const float* l = (const float*)lt;
    float* d = (float*)deltas;
    unsigned char* b = (unsigned char*)bp;
    long long* p = (long long*)path;
    cudaStream_t st = (cudaStream_t)stream;
    const int n = (int)N;
    switch (S) {
        case 1: return (int)launch<1>(e, l, n, S, log_s, d, b, p, st);
        case 2: return (int)launch<2>(e, l, n, S, log_s, d, b, p, st);
        case 3: return (int)launch<3>(e, l, n, S, log_s, d, b, p, st);
        case 4: return (int)launch<4>(e, l, n, S, log_s, d, b, p, st);
        case 5: return (int)launch<5>(e, l, n, S, log_s, d, b, p, st);
        case 6: return (int)launch<6>(e, l, n, S, log_s, d, b, p, st);
        case 7: return (int)launch<7>(e, l, n, S, log_s, d, b, p, st);
        case 8: return (int)launch<8>(e, l, n, S, log_s, d, b, p, st);
        default: break;
    }
    if (S <= 16) return (int)launch<16>(e, l, n, S, log_s, d, b, p, st);
    return (int)launch<32>(e, l, n, S, log_s, d, b, p, st);
}

}  // extern "C"
