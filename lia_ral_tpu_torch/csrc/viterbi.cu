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
// a multiple of 4; the padding candidates are -inf) by a fmaxf tree and
// adds its emission.  Latencies measured on the H100 (PERF.md, section 6):
// SHFL.IDX 26 SM cycles, LDS 29, a warp's STS + __syncwarp + LDS 28,
// FADD/FFMA and FMNMX 4.  So the chain of a step is one exchange, an
// add, ceil(log2 SP) levels of fmaxf and an add: ~49 cycles at S = 5.
// Above it each candidate costs the one warp ~3 issue cycles (a FADD,
// and a FMNMX at half rate): a forward step took 78 cycles at S = 5, and
// at S = 24 149 in an SP = 24 instance against 174 in an SP = 32 one
// (PERF.md, section 6).
//
// Only the forward is on the chain, so the rest of the decode runs
// beside it: derived after the forward, the back pointers and backtrace
// maps took 32 % of a decode at 300,000 x 24 (PERF.md, section 6).
//
// - Forward (warp 0): per step one store of delta[j] into one of two
//   32-float exchange buffers, a __syncwarp, SP / 4 broadcast loads of
//   the others (at least one), SP adds, the fmaxf tree, the emission's
//   add, and one store of delta[j] to the caller's device scratch (fire
//   and forget).  No branch: an idle lane stores past the N rows.
//   Emissions come from a three-slot shared-memory ring that the warp
//   fills itself with cp.async a chunk (64 steps) ahead, so a step reads
//   shared memory and holds no prefetch registers; steps use 32-bit
//   indices (N S < 2^31).  After each chunk the warp fences its delta
//   stores and publishes how many rows of deltas are stored (a shared
//   counter: one fence a chunk).  When its last step is stored it writes
//   how many back pointer rows are not yet derived (the caller's tail
//   count).
// - Units (warps 1, 2, 3, 5, 6, 7: the warps that do not issue from
//   warp 0's scheduler, warp w issuing from scheduler w % 4; warp 4
//   shares warp 0's and stays idle).  Rows r = 0 .. N-2 of back pointers
//   (row r: step r + 1) fall into units of 64; consumer warp c takes
//   units c, c + 6, ...  For a unit it waits until the forward has
//   published the unit's deltas, stages them in shared memory (loads that
//   bypass L1), and, lane k for state k, derives each row's byte: the
//   smallest i with the largest delta_r[i] + lt[i][k], the sums and the
//   maximum rounded as the forward rounded them, so each byte is the one
//   the forward would have chosen.  The bytes stay in the warp's shared
//   memory: lane s then walks the unit down from top state s (64
//   dependent reads), giving the unit's path for each top state (S x 64
//   bytes, copied out to the caller's table scratch) and, at its end, the
//   unit's map from top state to bottom state (to the map scratch).
// - Tail, after the forward's last step (the whole block): the last
//   units; thread t composes the maps of its L = ceil(units / 256) units
//   (S independent walks of L lookups); thread 0 composes the 256 from
//   the last state; each thread walks its units' maps from its known top
//   state, giving each unit's top state; then the path is a gather,
//   path[r] = table[unit][top of unit][r % 64], a warp writing a unit's
//   64 rows in one store, 16 units in flight: no dependent chain.
//
// The loops over the previous states are unrolled to SP (template).
// The instance follows S: SP = S for S <= 8, else 12, 16, 20, 24, 28, 32.
//
// Plain C interface, bound with ctypes.  The entry point launches on the
// given stream and returns cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 256;          // threads of the one block
constexpr int CH = 64;           // steps of a ring slot, rows of a unit
constexpr int SLOTS = 3;
constexpr int NCW = 6;           // consumer warps: 1, 2, 3, 5, 6, 7
constexpr int UNIT_BP = CH * 32;               // a unit's bytes [row][state]
constexpr int UNIT_PATHS = 32 * CH;            // its paths [top state][row]
constexpr int MAP_BYTES = NT * 32;             // [thread][state]
constexpr int TOP_BYTES = NT;                  // [thread]
constexpr int UNIT_MAP = 32;                   // bytes of a unit's map
constexpr int GATHER = 16;                     // units a warp's gather step
constexpr int STAGED = 16;       // rows of deltas a consumer lane loads at once

// the dynamic shared memory of instance SP: the emission ring (64 steps
// of SP floats a slot), then for each consumer warp a unit's deltas (64
// rows of DS floats, DS = SP rounded up to 4 for 16-byte loads), its
// back pointers and its paths, then the threads' maps and top states
template <int SP>
struct Layout {
    static constexpr int DS = (SP + 3) / 4 * 4;
    static constexpr int RING = SLOTS * CH * SP * 4;
    static constexpr int STAGE = NCW * CH * DS * 4;
    static constexpr int BYTES = RING + STAGE + NCW * (UNIT_BP + UNIT_PATHS) +
                                 MAP_BYTES + TOP_BYTES;
};

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

// c[i] = row[i] + add[i] for the first SP of a 16-byte aligned row of
// shared memory, as 16-byte broadcasts (SP / 4 loads, at least one)
template <int SP>
__device__ __forceinline__ void candidates(const float* row,
                                           const float (&add)[SP],
                                           float (&c)[SP]) {
    const float4* b4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int q = 0; q < (SP + 3) / 4; ++q) {
        const float4 v = b4[q];
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
            if (4 * q + r < SP) c[4 * q + r] = w[r] + add[4 * q + r];
    }
}

// For lane j, the candidates c[i] = delta of lane i + add[i] (add[i] =
// -inf for i >= S): lane j writes its delta into one of two 32-float
// buffers, and after a __syncwarp every lane reads the first SP.
// With five shuffles instead a step took 85 cycles, with these two loads
// 78 (S = 5).  The two buffers alternate, so one __syncwarp a step orders
// each write after the previous step's reads.
template <int SP>
__device__ __forceinline__ void exchanged(float* buf, float delta, int j,
                                          const float (&add)[SP],
                                          float (&c)[SP]) {
    buf[j] = delta;
    __syncwarp();
    candidates<SP>(buf, add, c);
}

// the maximum of c by a fmaxf tree
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

// steps [tb, te) of a ring slot: per step the deltas' exchange, the
// maximum and the emission's add, and lane j's delta stored
template <int SP>
__device__ __forceinline__ void steps(const float* slot, int tb, int te,
                                      int S, int j, int jc, float* xch,
                                      int& par, float& delta,
                                      const float (&ltc)[SP],
                                      float* deltas, int& off, int stride) {
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

// the smallest i whose candidate equals m (compares against the maximum)
template <int SP>
__device__ __forceinline__ int first_index(const float (&c)[SP], float m) {
    int a = SP - 1;
#pragma unroll
    for (int i = SP - 2; i >= 0; --i) a = c[i] == m ? i : a;
    return a;
}

__device__ __forceinline__ int load_volatile(const int* p) {
    return *reinterpret_cast<const volatile int*>(p);
}

template <int SP>
__global__ void __launch_bounds__(NT, 1)
viterbi_kernel(const float* __restrict__ em, const float* __restrict__ lt,
               int N, int S, float log_s, float* __restrict__ deltas,
               unsigned char* __restrict__ table,
               unsigned char* __restrict__ umaps, int* __restrict__ tail,
               long long* __restrict__ path) {
    using L = Layout<SP>;
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    float* stages = ring + L::RING / 4;
    unsigned char* wbps = reinterpret_cast<unsigned char*>(stages) +
                          L::STAGE;
    unsigned char* wpaths = wbps + NCW * UNIT_BP;
    unsigned char* maps = wpaths + NCW * UNIT_PATHS;
    unsigned char* tops = maps + MAP_BYTES;
    __shared__ int s_last;
    __shared__ int s_published;    // rows of deltas stored, a chunk at a time
    __shared__ int s_derived;      // back pointer rows done
    __shared__ float4 xch4[16];    // the deltas' exchange
    float* xch = reinterpret_cast<float*>(xch4);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int rows = N - 1;
    const int units = (rows + CH - 1) / CH;
    unsigned char* utops = umaps + units * UNIT_MAP;   // a unit's top state
    if (tid == 0) {
        s_published = 0;
        s_derived = 0;
    }
    __syncthreads();

    if (warp == 0) {
        const int j = lane;
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
            steps<SP>(slot, tb, te, S, j, jc, xch, par, delta, ltc, deltas,
                      off, stride);
            // publish the chunk: every lane's stores before the counter
            __threadfence_block();
            __syncwarp();
            if (j == 0)
                *reinterpret_cast<volatile int*>(&s_published) =
                    min((k + 1) * CH, N);
        }
        asm volatile("cp.async.wait_group 0;\n" ::);
        if (j == 0) *tail = rows - load_volatile(&s_derived);

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
    } else if (warp & 3) {
        // a consumer: units cw, cw + 6, ...
        const int cw = warp - 1 - (warp > 4);
        float* stage = stages + cw * CH * L::DS;
        unsigned char* wbp = wbps + cw * UNIT_BP;        // [row][state]
        unsigned char* wpath = wpaths + cw * UNIT_PATHS;  // [top][row]
        const int k = lane;
        const bool on = k < S;
        const int kc = on ? k : 0;
        float ltc[SP];                         // column k of log_trans
#pragma unroll
        for (int i = 0; i < SP; ++i)
            ltc[i] = i < S ? lt[i * S + kc] : -CUDART_INF_F;
        for (int x = lane; x < CH * L::DS; x += 32) stage[x] = 0.f;
        for (int u = cw; u < units; u += NCW) {
            const int lo = u * CH, nr = min(CH, rows - lo);
            const int need = min(lo + CH, N);
            while (load_volatile(&s_published) < need) __nanosleep(128);
            __threadfence_block();
            __syncwarp();
            // the unit's deltas, rows lo .. lo + nr - 1 at a stride of DS:
            // 16 loads in flight a lane, then their stores
            for (int r0 = 0; r0 < nr; r0 += STAGED) {
                float v[STAGED];
#pragma unroll
                for (int q = 0; q < STAGED; ++q)
                    v[q] = on && r0 + q < nr
                        ? __ldcg(deltas + (lo + r0 + q) * S + k) : 0.f;
#pragma unroll
                for (int q = 0; q < STAGED; ++q)
                    if (on && r0 + q < nr) stage[(r0 + q) * L::DS + k] = v[q];
            }
            __syncwarp();
            for (int r = 0; r < nr; ++r) {
                float c[SP];
                candidates<SP>(stage + r * L::DS, ltc, c);
                const int b = first_index<SP>(c, maximum<SP>(c));
                if (on) wbp[r * 32 + k] = (unsigned char)b;
            }
            __syncwarp();
            // lane s walks the unit down from top state s: its path, and
            // at the bottom the unit's map
            int st = kc;
            for (int r = nr - 1; r >= 0; --r) {
                if (on) wpath[k * CH + r] = (unsigned char)st;
                st = wbp[r * 32 + st];
            }
            if (on) umaps[u * UNIT_MAP + k] = (unsigned char)st;
            __syncwarp();
            uint4* dst = reinterpret_cast<uint4*>(table + u * S * CH);
            const uint4* src = reinterpret_cast<const uint4*>(wpath);
            for (int x = lane; x < S * CH / 16; x += 32) dst[x] = src[x];
            __syncwarp();
            if (lane == 0) atomicAdd(&s_derived, nr);
        }
    }
    __syncthreads();        // every unit's paths and map, and s_last

    // thread t owns units [ulo, uhi) and maps the state at the top of
    // unit uhi - 1 to the state at the bottom of unit ulo
    const int per = (units + NT - 1) / NT;
    const int ulo = min(tid * per, units), uhi = min(ulo + per, units);
    {
        int cur[SP];
#pragma unroll
        for (int s = 0; s < SP; ++s) cur[s] = s < S ? s : 0;
        for (int u = uhi - 1; u >= ulo; --u)
#pragma unroll
            for (int s = 0; s < SP; ++s)
                if (s < S) cur[s] = umaps[u * UNIT_MAP + cur[s]];
#pragma unroll
        for (int s = 0; s < SP; ++s)
            if (s < S) maps[tid * 32 + s] = (unsigned char)cur[s];
    }
    __syncthreads();
    if (tid == 0) {
        const int owners = per ? (units + per - 1) / per : 0;
        int state = s_last;
        for (int t = owners - 1; t >= 0; --t) {
            tops[t] = (unsigned char)state;
            state = maps[t * 32 + state];
        }
    }
    __syncthreads();
    // each unit's top state, from the thread's top down its units' maps
    {
        int state = tops[tid];
        for (int u = uhi - 1; u >= ulo; --u) {
            utops[u] = (unsigned char)state;
            state = umaps[u * UNIT_MAP + state];
        }
    }
    __syncthreads();
    // the path, 16 units a warp at a time: their top states in one
    // 16-byte load, then for each unit lane i writes rows 2i and 2i + 1
    // from the table row of the unit's top state (512 contiguous bytes a
    // store)
    for (int u0 = warp * GATHER; u0 < units; u0 += NT / 32 * GATHER) {
        const uint4 t4 = *reinterpret_cast<const uint4*>(utops + u0);
        const unsigned tw[4] = {t4.x, t4.y, t4.z, t4.w};
        unsigned two[GATHER];
#pragma unroll
        for (int q = 0; q < GATHER; ++q) {
            const int top = (tw[q / 4] >> (8 * (q % 4))) & 255;
            two[q] = u0 + q < units
                ? *reinterpret_cast<const unsigned short*>(
                      table + ((u0 + q) * S + top) * CH + 2 * lane)
                : 0u;
        }
#pragma unroll
        for (int q = 0; q < GATHER; ++q) {
            const int r = (u0 + q) * CH + 2 * lane;
            if (r + 1 < rows)
                *reinterpret_cast<longlong2*>(path + r) =
                    make_longlong2(two[q] & 255, two[q] >> 8);
            else if (r < rows)
                path[r] = two[q] & 255;
        }
    }
}

template <int SP>
cudaError_t launch(const float* em, const float* lt, int N, int S,
                   float log_s, float* deltas, unsigned char* table,
                   unsigned char* umaps, int* tail, long long* path,
                   cudaStream_t st) {
    constexpr int bytes = Layout<SP>::BYTES;
    cudaError_t e = cudaFuncSetAttribute(
        viterbi_kernel<SP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    viterbi_kernel<SP><<<1, NT, bytes, st>>>(em, lt, N, S, log_s, deltas,
                                             table, umaps, tail, path);
    return cudaGetLastError();
}

// f applied to the instance of S (SP = S up to 8, else S rounded up to
// a multiple of 4), given as a tag whose type carries SP
template <int SP> struct Tag { static constexpr int value = SP; };

template <class F>
auto by_instance(int S, F f) {
    switch (S <= 8 ? S : (S + 3) / 4 * 4) {
        case 1: return f(Tag<1>{});
        case 2: return f(Tag<2>{});
        case 3: return f(Tag<3>{});
        case 4: return f(Tag<4>{});
        case 5: return f(Tag<5>{});
        case 6: return f(Tag<6>{});
        case 7: return f(Tag<7>{});
        case 8: return f(Tag<8>{});
        case 12: return f(Tag<12>{});
        case 16: return f(Tag<16>{});
        case 20: return f(Tag<20>{});
        case 24: return f(Tag<24>{});
        case 28: return f(Tag<28>{});
        default: return f(Tag<32>{});
    }
}

}  // namespace

extern "C" {

// The dynamic shared memory of S's instance, in bytes.
int lia_viterbi_shared_bytes(int S) {
    if (S < 1 || S > 32) return -1;
    return by_instance(S, [](auto tag) {
        return Layout<decltype(tag)::value>::BYTES;
    });
}

// em (N, S) f32, lt (S, S) f32 log transitions (row: previous state),
// log_s = log S as the caller rounds it, deltas: (N S + 32) floats of
// scratch; with U = ceil((N - 1) / 64) units of back pointer rows,
// table: U S 64 bytes of scratch (each unit's path from each top
// state), umaps: U 33 bytes (each unit's map, then its top state);
// tail: one int, the back pointer rows not yet derived when the
// forward's last step was stored; path: (N,) int64.  Each 16-byte
// aligned, and umaps 16 bytes longer (the gather reads the top states 16
// units at a time).  1 <= S <= 32, N >= 1, (N + 128) S + 32 < 2^31: the kernel's
// indices are 32-bit, and the largest it forms is the ring's source
// em + t0 S for a chunk t0 up to N + 127 (idle lanes' deltas at N S + 31
// and the table's U S 64 lie below it).
int lia_viterbi(const void* em, const void* lt, long long N, int S,
                float log_s, void* deltas, void* table, void* umaps,
                void* tail, void* path, void* stream) {
    if (N < 1 || S < 1 || S > 32 || (N + 128) * S + 32 >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const float* e = (const float*)em;
    const float* l = (const float*)lt;
    float* d = (float*)deltas;
    unsigned char* b = (unsigned char*)table;
    unsigned char* m = (unsigned char*)umaps;
    int* t = (int*)tail;
    long long* p = (long long*)path;
    cudaStream_t st = (cudaStream_t)stream;
    const int n = (int)N;
    return (int)by_instance(S, [&](auto tag) {
        return launch<decltype(tag)::value>(e, l, n, S, log_s, d, b, m, t, p,
                                            st);
    });
}

}  // extern "C"
