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
// in, N S of back pointers out and in again, N 8 of path).  The bound is
// the dependent chain: step t needs every delta of step t-1.  States are
// speakers or acoustic events, so S <= 32 and one warp holds a whole
// step: lane j keeps delta[j] in a register and reads the others with
// warp shuffles, so a step needs no shared memory and no barrier.  A
// step is straight-line code: SP independent shuffles and adds (SP = S
// rounded up to a power of two; the padding candidates are -inf and never
// win), a tournament of log2 SP compare-and-select levels in which the
// left entry wins a tie (so the smallest index does), and one add.  With
// a branch per previous state instead, the shuffles could not overlap
// and a decode took nearly twice as long (PERF.md has both times).
// Emissions are read 32 steps ahead into registers, so the chain never
// waits for device memory.  Back pointers go to device memory as bytes
// (stores do not stall the chain).  The backtrace is a second chain of N
// dependent one-byte reads: the whole block copies 1024 steps of back
// pointers at a time into shared memory and one thread walks them there.
//
// One block of 256 threads: warp 0 runs the recursion, all warps copy
// for the backtrace.  The loops over the previous states are unrolled to
// the next power of two of S (template SP).
//
// Plain C interface, bound with ctypes.  The entry point launches on the
// given stream and returns cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 256;        // threads of the one block
constexpr int CH = 32;         // steps of emissions held in registers
constexpr int TB = 1024;       // steps of back pointers per shared chunk
constexpr unsigned FULL = 0xffffffffu;

// max_i (delta of lane i + add[i]) and the smallest i that reaches it.
// Every lane of the warp calls it.  Entries i >= S carry add[i] = -inf.
template <int SP>
__device__ __forceinline__ float best_previous(float delta,
                                               const float (&add)[SP],
                                               int& arg) {
    float c[SP];
    int idx[SP];
#pragma unroll
    for (int i = 0; i < SP; ++i) {
        c[i] = __shfl_sync(FULL, delta, i) + add[i];
        idx[i] = i;
    }
#pragma unroll
    for (int w = 1; w < SP; w <<= 1) {
#pragma unroll
        for (int i = 0; i + w < SP; i += 2 * w) {
            const bool right = c[i + w] > c[i];   // strict: a tie stays left
            c[i] = right ? c[i + w] : c[i];
            idx[i] = right ? idx[i + w] : idx[i];
        }
    }
    arg = idx[0];
    return c[0];
}

template <int SP>
__global__ void __launch_bounds__(NT)
viterbi_kernel(const float* __restrict__ em, const float* __restrict__ lt,
               long long N, int S, float log_s,
               unsigned char* __restrict__ bp, long long* __restrict__ path) {
    __shared__ unsigned char sbp[TB * 32];
    __shared__ int s_last;
    const int j = threadIdx.x;

    if (j < 32) {
        const bool on = j < S;
        const int jc = on ? j : 0;             // idle lanes read column 0
        float ltc[SP];                         // column j of log_trans
#pragma unroll
        for (int i = 0; i < SP; ++i)
            ltc[i] = i < S ? lt[i * S + jc] : -CUDART_INF_F;

        float delta = em[jc] - log_s;
        float cur[CH], nxt[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u)
            cur[u] = 1 + u < N ? em[(long long)(1 + u) * S + jc] : 0.f;

        for (long long t0 = 1; t0 < N; t0 += CH) {
#pragma unroll
            for (int u = 0; u < CH; ++u) {
                const long long t = t0 + CH + u;
                nxt[u] = t < N ? em[t * S + jc] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < CH; ++u) {
                const long long t = t0 + u;
                if (t < N) {                   // uniform in the warp
                    int arg;
                    const float best = best_previous<SP>(delta, ltc, arg);
                    delta = best + cur[u];
                    if (on) bp[(t - 1) * S + j] = (unsigned char)arg;
                }
            }
#pragma unroll
            for (int u = 0; u < CH; ++u) cur[u] = nxt[u];
        }

        // the last state: the same tournament over delta alone (0 for a
        // real state, -inf for the padding)
#pragma unroll
        for (int i = 0; i < SP; ++i) ltc[i] = i < S ? 0.f : -CUDART_INF_F;
        int last;
        best_previous<SP>(delta, ltc, last);
        if (j == 0) {
            s_last = last;
            path[N - 1] = last;
        }
    }
    __syncthreads();               // back pointers and s_last are visible

    int state = s_last;
    // rows [lo, hi) of bp hold the back pointers of steps lo+1 .. hi
    for (long long hi = N - 1; hi > 0; hi -= TB) {
        const long long lo = hi > TB ? hi - TB : 0;
        const int nbytes = (int)(hi - lo) * S;
        const unsigned char* src = bp + lo * S;
        for (int b = j; b < nbytes; b += NT) sbp[b] = src[b];
        __syncthreads();
        if (j == 0) {
            for (long long r = hi - 1; r >= lo; --r) {
                path[r] = state;
                state = sbp[(int)(r - lo) * S + state];
            }
        }
        __syncthreads();
    }
}

template <int SP>
cudaError_t launch(const float* em, const float* lt, long long N, int S,
                   float log_s, unsigned char* bp, long long* path,
                   cudaStream_t st) {
    viterbi_kernel<SP><<<1, NT, 0, st>>>(em, lt, N, S, log_s, bp, path);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// em (N, S) f32, lt (S, S) f32 log transitions (row: previous state),
// log_s = log S as the caller rounds it, bp: N * S bytes of scratch,
// path: (N,) int64.  1 <= S <= 32, N >= 1.
int lia_viterbi(const void* em, const void* lt, long long N, int S,
                float log_s, void* bp, void* path, void* stream) {
    if (N < 1 || S < 1 || S > 32) return (int)cudaErrorInvalidValue;
    const float* e = (const float*)em;
    const float* l = (const float*)lt;
    unsigned char* b = (unsigned char*)bp;
    long long* p = (long long*)path;
    cudaStream_t st = (cudaStream_t)stream;
    if (S <= 1) return (int)launch<1>(e, l, N, S, log_s, b, p, st);
    if (S <= 2) return (int)launch<2>(e, l, N, S, log_s, b, p, st);
    if (S <= 4) return (int)launch<4>(e, l, N, S, log_s, b, p, st);
    if (S <= 8) return (int)launch<8>(e, l, N, S, log_s, b, p, st);
    if (S <= 16) return (int)launch<16>(e, l, N, S, log_s, b, p, st);
    return (int)launch<32>(e, l, N, S, log_s, b, p, st);
}

}  // extern "C"
