// One incremental greedy decode step through every decoder layer, in one
// cooperative launch.  For rows b of A audios in groups of G (b = a G + g)
// and each layer l, with s = 64^-0.5 and every product summed in f32 and
// rounded to the compute dtype T before its bias is added:
//
//   h  = LN1(x);  q = (h Wq^T + bq) s;  k = h Wk^T;  v = h Wv^T + bv
//   K[l, b, :, pos] = k;  V[l, b, :, pos] = v          (in place)
//   o  = sum_j e_j V_j / sum_j e_j,  e_j = exp(q.K_j - max), over the slots
//        key_start[b] <= j <= pos (f32 weights, divided after P V)
//   x += o Wo^T + bo
//   h  = LN2(x);  c = (h Wcq^T + bcq) s
//   o  = round_T(softmax(c K_a^T)) V_a   (audio a's cross K/V, no mask)
//   x += o Wco^T + bco
//   h  = LN3(x);  x += gelu(h W1^T + b1) W2^T + b2
//
// LayerNorm in f32; GELU exact (erf) in f32 and the tanh form in bf16,
// computed in f32 and rounded; the residual x held in T between sub-blocks.
//
// Replaces: whisper_rs_tpu/ops/decoder_layer_fused.py::decoder_step_fused
// (kernel body _decoder_step_kernel).  The TPU kernel ran a sequential grid
// (layer, phase, audio chunk) with the residual stream in VMEM scratch
// carried across grid steps, the weights packed into one [L, 2, n, 8n]
// stream so that each phase's plane arrived by one DMA, and the caches
// aliased through the call while the caller wrote the K/V columns after
// it.  None of that carries over: Hopper blocks run in parallel and in no
// order, so the step is a persistent grid of one block an SM (co-resident,
// by the cooperative launch) that walks the layers and meets at a grid-wide
// barrier between phases; the weights are read in place through a table of
// pointers into the model's parameters; the K/V column is written here.
//
// Bound on the H100: bytes.  One step must read every layer's weights once
// (14 D^2 elements a layer), the cross K/V of every layer (L A H 2 64 Tk
// elements) and the visible cache window.  At medium.en b8, W 256, pos 255,
// bf16, a layer's phases must move (H100 SXM data sheet, 3.35 TB/s, 700 W):
//   1 LN1 + q/k/v      3 D^2 weights      6.29 MB   1.88 us
//   2 self-attention   the window's K/V   8.39 MB   2.50 us
//   3 out-projection   D^2                2.10 MB   0.63 us
//   4 LN2 + cross q    D^2                2.10 MB   0.63 us
//   5 cross-attention  the cross K/V     49.15 MB  14.67 us
//   6 cross out        D^2                2.10 MB   0.63 us
//   7 LN3 + fc1        4 D^2              8.39 MB   2.50 us
//   8 fc2              4 D^2              8.39 MB   2.50 us
// 26 us a layer, 0.623 ms for 24.  The products, 2 B per weight element,
// are far below the bf16 tensor-core peak, but on the FMA pipes (the f32
// instance) B conversions and FMAs per weight set the rate, not the bytes.
//
// Both instances run eight phases a layer and take every sum in a fixed
// order, with no atomics on data, so two runs give the same bits.  Data
// written inside the launch (x, q, att, the MLP's hidden row, the cache
// column, the split-K partials) is read past the SM's L1 (ld.global.cg or
// cp.async.cg), never by the TMA engine.
//
// Design (bf16): the projections on the tensor cores, the weights streamed
// ahead of the barriers, the cross phase streamed like row 5's kernel.
//   * A block is 8 consumer warps and one producer warp, one block an SM.
//     The producer walks the block's share of every projection of every
//     layer in the consumers' order (its plan and the layer's matrix
//     pointers in registers, the next layer's read a layer ahead) and fills
//     a ring of weight stages in shared memory: 8 weight rows x 512 columns
//     a stage, one 1-d bulk copy a row into a row padded by 16 bytes, so
//     ldmatrix's 8 rows fall on distinct banks; a full and an empty
//     mbarrier a stage.  Weights are read-only, so it runs ahead into the
//     next phase and layer while its block waits or attends: the ring (what
//     the largest phase leaves: 12-14 stages, 100-116 KB, at the path's
//     shapes) is filled during the attention phases.  1-d copies and not tensor maps: a row's K-slice
//     is contiguous and 16-byte aligned, and the copies need no map a layer
//     (tensor maps were not measured).  The consumers meet on a named
//     barrier (bar.sync 1, 256), so the producer is never held.
//   * Products: mma.sync m16n8k16, bf16 in, f32 accumulate, the rows of x
//     on M (the 8 staged rows twice where B <= 8) and 8 weight rows (output
//     features) on N; a warp takes every eighth 16-deep step of a stage and
//     the warps' f32 tiles are summed in shared memory in warp order.  The
//     activations are staged once a phase, in bf16, and only the K-slice the
//     block's tiles read, by cp.async; the LayerNorm phases bring the whole
//     rows (for the statistics) and the slice's scale and offset the same
//     way.  A block's tiles run their products first, then one merge and
//     one epilogue for them all (bias, rounding, the residual, GELU, the q
//     scale, the K/V column), its inputs loaded under the products, so the
//     round trips are paid once a phase, not a tile.
//   * The static plan (ops/decoder_layer_fused.py::layer_launch_plan) cuts
//     each projection into tiles of 8 features and ks K-slices and gives
//     each block one slice and a run of tiles, balanced to a tile.  It
//     splits K only where the ring chunks the split saves outweigh a merge
//     (at 8 rows and D 1024: nowhere; at 12-16 rows, fc2's staged slice caps
//     it; large-v3's fc2: 5 slices).  The blocks of slices 1.. publish each
//     tile's f32 partial to a global scratch and raise the tile's flag (a
//     store of the phase's epoch after a release fence); the block of slice
//     0 sums the partials in slice order after acquiring the flags (a thread
//     a flag).  No block of slice > 0 waits within a phase, so the waits
//     cannot cycle.
//   * Six grid barriers a layer, not eight: self-attention item (b, h)
//     waits on the flags of the 24 q/k/v tiles of head h that their owners
//     raise after the epilogue, and cross item (a, h) on the 8 cross-q
//     tiles of head h.  A barrier arrival is a release reduction (no value
//     comes back) and its waits acquire polls.
//   * Cross-attention, one block per (audio, head) and its G rows: K^T and
//     then V^T stream through a second ring, 8 rows of the [64, Tk] plane a
//     stage (one contiguous bulk copy of 8 Tk elements: the plane's odd
//     pitch rules out tensor maps); a thread a quad of keys and up to 2
//     rows for the scores; f32 statistics over all Tk keys, the weights
//     rounded to T, then a warp a row of V^T; the V tiles are in flight
//     while the softmax runs.
//   * Self-attention, one block per (row, head): the V rows come into shared
//     memory by cp.async while the K rows of 8 passes (256 keys) are loaded
//     before any is used; then the softmax and P V from shared memory.
// With 9 warps a block, a scheduler partition holds 3 of them, which caps a
// thread at 168 registers; the phases' loops are kept short and rolled
// where they run once a phase.
//
// Design (f32, the parity instance): the FMA pipes, no TF32, eight grid
// barriers a layer (a counter that every block's first thread bumps and
// polls; the wrapper zeroes it before each launch).  Every block computes
// LN of all B rows into shared memory; one warp per output feature streams
// its weight row once with 16-byte loads and keeps the B row sums in
// registers; self-attention one block per (row, head); cross-attention one
// block per (audio, head); a [B, 4D] scratch between fc1 and fc2.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DH = 64;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ROWS = WARPS;  // LayerNorm takes one warp a row
constexpr int PF = 4;            // 16-byte weight loads in flight per lane
constexpr float EPS = 1e-5f;

// Columns of the weight table [L, NW]: device pointers of one layer.
enum {
    LN1_W, LN1_B, WQ, BQ, WK, WV, BV, WO, BO,
    LN2_W, LN2_B, WCQ, BCQ, WCO, BCO,
    LN3_W, LN3_B, W1, B1, W2, B2, NW
};

template <typename T>
struct Step {
    const long long* wtab;        // [L, NW] pointers to T
    const T* kv;                  // [L, A, H, 2, 64, Tk] cross K^T and V^T
    const long long* key_start;   // [B], or null for zeros
    const long long* pos;         // the step's slot, one int64 in device memory
    T* x;                         // [B, D] residual stream, in and out
    T* kc;                        // [L, B, H, n_ctx, 64]
    T* vc;
    T* q;                         // [B, D] scratch: the self q, then the cross q
    T* att;                       // [B, D] scratch: attention outputs
    T* hid;                       // [B, 4D] scratch: the MLP's hidden row
    unsigned int* bar;            // grid barrier counter, 0 at launch
    unsigned long long* clock;    // [8 L + 1] phase-end times in ns, or null
    int B, D, H, L, G, Tk, n_ctx, window;
    float scale;
};

// The step's slot, read from device memory (a captured launch reads the
// position of its replay), and whether it is outside [0, window): no step,
// for which the decode loop passes -1 when its termination test has turned
// the step off; every block then leaves before its first barrier, and the
// launch writes nothing (x stays as it came).
template <typename S>
__device__ __forceinline__ int slot_of(const S& p) {
    return static_cast<int>(__ldg(p.pos));
}
template <typename S>
__device__ __forceinline__ bool no_step(const S& p) {
    const long long at = __ldg(p.pos);
    return at < 0 || at >= p.window;
}

// Sixteen bytes as floats: 4 of f32, 8 of bf16.
__device__ __forceinline__ void unpack(const uint4 r, float (&x)[4]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4 r, float (&x)[8]) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
    }
}

// Loads of 16 bytes: read-only data (weights, cross K/V) through the
// read-only path; data written during the launch at L2 (past L1); shared.
template <typename T>
__device__ __forceinline__ uint4 ld_ro(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}
template <typename T>
__device__ __forceinline__ uint4 ld_cg(const T* p) {
    return __ldcg(reinterpret_cast<const uint4*>(p));
}
template <typename T>
__device__ __forceinline__ uint4 ld_sh(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
}

// Four consecutive read-only elements as f32.
__device__ __forceinline__ float4 ld_ro4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

template <typename T>
__device__ __forceinline__ float gelu(float x);
template <>
__device__ __forceinline__ float gelu<float>(float x) {
    return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}
template <>
__device__ __forceinline__ float gelu<bf16>(float x) {
    const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
}

// The GPU's nanosecond clock, into clock[i] from block 0 (when clock is
// not null): the kernel's start and the end of every phase.
__device__ __forceinline__ void stamp(unsigned long long* clock, int i) {
    if (clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        clock[i] = t;
    }
}

// Every block waits here until all blocks have arrived.  The launch is
// cooperative, so all blocks are resident and the spin cannot deadlock; a
// wait of some 2^26 polls (seconds, where a phase takes microseconds)
// means that guarantee broke, and the kernel traps instead of hanging.
__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned int& target) {
    __syncthreads();
    target += gridDim.x;
    if (threadIdx.x == 0) {
        __threadfence();  // this block's writes before its arrival
        atomicAdd(bar, 1u);
        unsigned int seen, polls = 0;
        do {
            asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(seen) : "l"(bar) : "memory");
            if (++polls == (1u << 26)) __trap();
        } while (seen < target);
        __threadfence();
    }
    __syncthreads();
}

template <typename T>
__device__ __forceinline__ const T* weight(const Step<T>& p, int l, int i) {
    return reinterpret_cast<const T*>(__ldg(p.wtab + (size_t)l * NW + i));
}

// LayerNorm of the B rows of x [B, D] in f32, rounded to T, into hs
// [B, D] in shared memory: warp b takes row b.
template <typename T>
__device__ void ln_rows(const T* x, const T* __restrict__ g, const T* __restrict__ beta, T* hs,
                        int B, int D) {
    constexpr int VEC = 16 / sizeof(T);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < B) {
        const T* xr = x + (size_t)warp * D;
        float s = 0.f;
        for (int k = lane * VEC; k < D; k += 32 * VEC) {
            float v[VEC];
            unpack(ld_cg(xr + k), v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) s += v[e];
        }
        const float mean = warp_sum(s) / D;
        float ss = 0.f;
        for (int k = lane * VEC; k < D; k += 32 * VEC) {
            float v[VEC];
            unpack(ld_cg(xr + k), v);
#pragma unroll
            for (int e = 0; e < VEC; ++e) ss += (v[e] - mean) * (v[e] - mean);
        }
        const float rstd = rsqrtf(warp_sum(ss) / D + EPS);
        for (int k = lane * VEC; k < D; k += 32 * VEC) {
            float v[VEC], gv[VEC], bv[VEC];
            unpack(ld_cg(xr + k), v);
            unpack(ld_ro(g + k), gv);
            unpack(ld_ro(beta + k), bv);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                hs[(size_t)warp * D + k + e] = from_float<T>((v[e] - mean) * rstd * gv[e] + bv[e]);
        }
    }
    __syncthreads();
}

// n elements of src (written during the launch) into shared memory.
template <typename T>
__device__ void stage(const T* src, T* dst, int n) {
    constexpr int VEC = 16 / sizeof(T);
    for (int i = threadIdx.x * VEC; i < n; i += THREADS * VEC)
        *reinterpret_cast<uint4*>(dst + i) = ld_cg(src + i);
    __syncthreads();
}

// The warp's f32 sums w . xs[b] over K for the B rows of xs [B, K] in
// shared memory; w is one weight row, read once with 16-byte loads, PF
// ahead.  Returns the sum of row `lane` (lanes b < B), the same in every
// run: each lane sums its own elements in order, then a butterfly.
template <typename T>
__device__ __forceinline__ float warp_project(const T* __restrict__ w, const T* xs, int K, int B,
                                              int lane) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int STEP = 32 * VEC;
    float acc[MAX_ROWS];
#pragma unroll
    for (int b = 0; b < MAX_ROWS; ++b) acc[b] = 0.f;
    for (int k0 = lane * VEC; k0 < K; k0 += PF * STEP) {
        uint4 wr[PF];
#pragma unroll
        for (int i = 0; i < PF; ++i)
            if (k0 + i * STEP < K) wr[i] = ld_ro(w + k0 + i * STEP);
#pragma unroll
        for (int i = 0; i < PF; ++i) {
            const int k = k0 + i * STEP;
            if (k < K) {
                float wv[VEC];
                unpack(wr[i], wv);
#pragma unroll
                for (int b = 0; b < MAX_ROWS; ++b) {
                    if (b < B) {
                        float xv[VEC];
                        unpack(ld_sh(xs + (size_t)b * K + k), xv);
#pragma unroll
                        for (int e = 0; e < VEC; ++e) acc[b] = fmaf(wv[e], xv[e], acc[b]);
                    }
                }
            }
        }
    }
    float mine = 0.f;
#pragma unroll
    for (int b = 0; b < MAX_ROWS; ++b) {
        if (b < B) {
            const float s = warp_sum(acc[b]);
            if (lane == b) mine = s;
        }
    }
    return mine;
}

// Phase 2: one block per (row, head); scores of slots lo..pos in ws.
template <typename T>
__device__ void self_attention(const Step<T>& p, int l, float* ws, float (*red)[DH],
                               float* stat) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int LPR = DH / VEC;  // lanes per key row: 8 (bf16) or 16 (f32)
    constexpr int KPW = 32 / LPR;  // key rows per warp pass
    constexpr int STRIDE = WARPS * KPW;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = lane / LPR, seg = lane % LPR;
    const int hi = slot_of(p);
    for (int it = blockIdx.x; it < p.B * p.H; it += gridDim.x) {
        const int b = it / p.H, h = it % p.H;
        const size_t head = (((size_t)l * p.B + b) * p.H + h) * p.n_ctx * DH;
        const T* kc = p.kc + head;
        const T* vc = p.vc + head;
        // the current token (slot pos) is always visible
        const long long ks = p.key_start ? p.key_start[b] : 0;
        const int lo = ks <= 0 ? 0 : (ks > hi ? hi : (int)ks);
        const int n = hi - lo + 1;

        float qx[VEC];
        unpack(ld_cg(p.q + (size_t)b * p.D + h * DH + seg * VEC), qx);
        float lmax = -INFINITY;
        for (int j0 = lo + warp * KPW; j0 <= hi; j0 += STRIDE) {
            const int j = j0 + grp;
            float part = 0.f;
            if (j <= hi) {
                float kx[VEC];
                unpack(ld_cg(kc + (size_t)j * DH + seg * VEC), kx);
#pragma unroll
                for (int e = 0; e < VEC; ++e) part = fmaf(qx[e], kx[e], part);
            }
#pragma unroll
            for (int o = LPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
            if (j <= hi) {
                if (seg == 0) ws[j - lo] = part;
                lmax = fmaxf(lmax, part);
            }
        }
        lmax = warp_max(lmax);
        if (lane == 0) stat[warp] = lmax;
        __syncthreads();
        float m = stat[0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) m = fmaxf(m, stat[w]);
        __syncthreads();
        float lsum = 0.f;
        for (int i = tid; i < n; i += THREADS) {
            const float e = expf(ws[i] - m);
            ws[i] = e;
            lsum += e;
        }
        lsum = warp_sum(lsum);
        if (lane == 0) stat[warp] = lsum;
        __syncthreads();
        float total = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) total += stat[w];

        // sum_j e_j V_j in f32, divided by the sum at the end
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        for (int j0 = lo + warp * KPW; j0 <= hi; j0 += STRIDE) {
            const int j = j0 + grp;
            if (j <= hi) {
                const float wj = ws[j - lo];
                float vx[VEC];
                unpack(ld_cg(vc + (size_t)j * DH + seg * VEC), vx);
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wj, vx[e], acc[e]);
            }
        }
#pragma unroll
        for (int o = 16; o >= LPR; o >>= 1) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
        }
        if (grp == 0) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) red[warp][seg * VEC + e] = acc[e];
        }
        __syncthreads();
        if (tid < DH) {
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) s += red[w][tid];
            p.att[(size_t)b * p.D + h * DH + tid] = from_float<T>(s / total);
        }
        __syncthreads();  // ws, red and stat serve the next item
    }
}

// Phase 5: one block per (audio, head), its G rows together; sc [G][Tk].
template <typename T, int GM>
__device__ void cross_attention(const Step<T>& p, int l, float* sc, float (*qs)[DH],
                                float (*red)[WARPS], float* stat) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int G = GM, Tk = p.Tk, T4 = Tk / 4;
    const int A = p.B / G;
    for (int it = blockIdx.x; it < A * p.H; it += gridDim.x) {
        const int a = it / p.H, h = it % p.H;
        const T* kt = p.kv + ((((size_t)l * A + a) * p.H + h) * 2) * DH * Tk;  // K^T [64, Tk]
        const T* vt = kt + (size_t)DH * Tk;                                     // V^T [64, Tk]
        for (int i = tid; i < G * DH; i += THREADS) {
            const int g = i / DH, d = i % DH;
            qs[g][d] = to_float(__ldcg(p.q + ((size_t)a * G + g) * p.D + h * DH + d));
        }
        __syncthreads();

        float lmax[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) lmax[g] = -INFINITY;
        for (int j4 = tid; j4 < T4; j4 += THREADS) {
            float acc[GM][4];
#pragma unroll
            for (int g = 0; g < GM; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
#pragma unroll 8
            for (int d = 0; d < DH; ++d) {
                const float4 k4 = ld_ro4(kt + (size_t)d * Tk + 4 * j4);
#pragma unroll
                for (int g = 0; g < GM; ++g) {
                    const float qv = qs[g][d];
                    acc[g][0] = fmaf(qv, k4.x, acc[g][0]);
                    acc[g][1] = fmaf(qv, k4.y, acc[g][1]);
                    acc[g][2] = fmaf(qv, k4.z, acc[g][2]);
                    acc[g][3] = fmaf(qv, k4.w, acc[g][3]);
                }
            }
#pragma unroll
            for (int g = 0; g < GM; ++g) {
                *reinterpret_cast<float4*>(&sc[(size_t)g * Tk + 4 * j4]) =
                    make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
                lmax[g] = fmaxf(lmax[g], fmaxf(fmaxf(acc[g][0], acc[g][1]),
                                               fmaxf(acc[g][2], acc[g][3])));
            }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            const float wm = warp_max(lmax[g]);
            if (lane == 0) red[g][warp] = wm;
        }
        __syncthreads();
        if (tid < GM) {
            float mx = -INFINITY;
            for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red[tid][w]);
            stat[tid] = mx;
        }
        __syncthreads();
        float lsum[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            lsum[g] = 0.f;
            const float mx = stat[g];
            for (int j = tid; j < Tk; j += THREADS) {
                const float e = expf(sc[(size_t)g * Tk + j] - mx);
                sc[(size_t)g * Tk + j] = e;
                lsum[g] += e;
            }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            const float ws = warp_sum(lsum[g]);
            if (lane == 0) red[g][warp] = ws;
        }
        __syncthreads();
        if (tid < GM) {
            float s = 0.f;
            for (int w = 0; w < WARPS; ++w) s += red[tid][w];
            stat[tid] = s;
        }
        __syncthreads();
        // weights e / sum rounded to T, as the TPU kernel rounds them
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            const float s = stat[g];
            for (int j = tid; j < Tk; j += THREADS)
                sc[(size_t)g * Tk + j] = round_to<T>(sc[(size_t)g * Tk + j] / s);
        }
        __syncthreads();
        // out[g, d] = sum_j w[g, j] V^T[d, j]; a warp per row d of V^T
        for (int d = warp; d < DH; d += WARPS) {
            float acc[GM];
#pragma unroll
            for (int g = 0; g < GM; ++g) acc[g] = 0.f;
#pragma unroll 4
            for (int j4 = lane; j4 < T4; j4 += 32) {
                const float4 v4 = ld_ro4(vt + (size_t)d * Tk + 4 * j4);
#pragma unroll
                for (int g = 0; g < GM; ++g) {
                    const float4 w = *reinterpret_cast<const float4*>(&sc[(size_t)g * Tk + 4 * j4]);
                    acc[g] = fmaf(w.x, v4.x, acc[g]);
                    acc[g] = fmaf(w.y, v4.y, acc[g]);
                    acc[g] = fmaf(w.z, v4.z, acc[g]);
                    acc[g] = fmaf(w.w, v4.w, acc[g]);
                }
            }
#pragma unroll
            for (int g = 0; g < GM; ++g) {
                const float s = warp_sum(acc[g]);
                if (lane == 0)
                    p.att[((size_t)a * G + g) * p.D + h * DH + d] = from_float<T>(s);
            }
        }
        __syncthreads();  // sc, qs, red and stat serve the next item
    }
}

// x[b, f] += round(round(acc) + bias[f]) for the warp's feature f, b < B.
template <typename T>
__device__ __forceinline__ void residual(T* x, int D, int f, int B, int lane, float acc,
                                         const T* __restrict__ bias) {
    if (lane < B) {
        const float y = round_to<T>(round_to<T>(acc) + to_float(bias[f]));
        T* xp = x + (size_t)lane * D + f;
        *xp = from_float<T>(to_float(__ldcg(xp)) + y);
    }
}

template <typename T, int GM>
__global__ void __launch_bounds__(THREADS, 1) decoder_step_kernel(const Step<T> p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red[WARPS][DH];
    __shared__ float cred[GM][WARPS];
    __shared__ float qs[GM][DH];
    __shared__ float stat[WARPS];
    T* hs = reinterpret_cast<T*>(smem);          // [B, K] rows every warp reads
    float* fs = reinterpret_cast<float*>(smem);  // attention scores

    const int B = p.B, D = p.D;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gwarp = blockIdx.x * WARPS + warp, nwarps = gridDim.x * WARPS;
    if (no_step(p)) return;
    unsigned int target = 0;
    stamp(p.clock, 0);

    for (int l = 0; l < p.L; ++l) {
        // 1. LN1; q, k, v; the K/V column into the cache
        ln_rows(p.x, weight(p, l, LN1_W), weight(p, l, LN1_B), hs, B, D);
        for (int f = gwarp; f < 3 * D; f += nwarps) {
            const int which = f / D, n = f - which * D;
            const T* w = weight(p, l, which == 0 ? WQ : which == 1 ? WK : WV) + (size_t)n * D;
            const float acc = warp_project(w, hs, D, B, lane);
            if (lane < B) {
                float y = round_to<T>(acc);
                if (which == 0) {
                    y = round_to<T>(y + to_float(weight(p, l, BQ)[n]));
                    p.q[(size_t)lane * D + n] = from_float<T>(y * p.scale);
                } else {
                    if (which == 2) y = round_to<T>(y + to_float(weight(p, l, BV)[n]));
                    const size_t row = ((size_t)l * B + lane) * p.H + n / DH;
                    const size_t at = (row * p.n_ctx + slot_of(p)) * DH + n % DH;
                    (which == 1 ? p.kc : p.vc)[at] = from_float<T>(y);
                }
            }
        }
        grid_sync(p.bar, target);
        stamp(p.clock, 8 * l + 1);

        // 2. self-attention over the cache, this step's column included
        self_attention(p, l, fs, red, stat);
        grid_sync(p.bar, target);
        stamp(p.clock, 8 * l + 2);

        // 3. out-projection and residual
        stage(p.att, hs, B * D);
        for (int f = gwarp; f < D; f += nwarps) {
            const float acc = warp_project(weight(p, l, WO) + (size_t)f * D, hs, D, B, lane);
            residual(p.x, D, f, B, lane, acc, weight(p, l, BO));
        }
        grid_sync(p.bar, target);
        stamp(p.clock, 8 * l + 3);

        // 4. LN2 and the cross q
        ln_rows(p.x, weight(p, l, LN2_W), weight(p, l, LN2_B), hs, B, D);
        for (int f = gwarp; f < D; f += nwarps) {
            const float acc = warp_project(weight(p, l, WCQ) + (size_t)f * D, hs, D, B, lane);
            if (lane < B) {
                const float y = round_to<T>(round_to<T>(acc) + to_float(weight(p, l, BCQ)[f]));
                p.q[(size_t)lane * D + f] = from_float<T>(y * p.scale);
            }
        }
        grid_sync(p.bar, target);
        stamp(p.clock, 8 * l + 4);

        // 5. cross-attention
        cross_attention<T, GM>(p, l, fs, qs, cred, stat);
        grid_sync(p.bar, target);
        stamp(p.clock, 8 * l + 5);

        // 6. cross out-projection and residual
        stage(p.att, hs, B * D);
        for (int f = gwarp; f < D; f += nwarps) {
            const float acc = warp_project(weight(p, l, WCO) + (size_t)f * D, hs, D, B, lane);
            residual(p.x, D, f, B, lane, acc, weight(p, l, BCO));
        }
        grid_sync(p.bar, target);
        stamp(p.clock, 8 * l + 6);

        // 7. LN3, fc1, bias, GELU
        ln_rows(p.x, weight(p, l, LN3_W), weight(p, l, LN3_B), hs, B, D);
        for (int f = gwarp; f < 4 * D; f += nwarps) {
            const float acc = warp_project(weight(p, l, W1) + (size_t)f * D, hs, D, B, lane);
            if (lane < B) {
                const float a = round_to<T>(round_to<T>(acc) + to_float(weight(p, l, B1)[f]));
                p.hid[(size_t)lane * 4 * D + f] = from_float<T>(gelu<T>(a));
            }
        }
        grid_sync(p.bar, target);
        stamp(p.clock, 8 * l + 7);

        // 8. fc2 and residual
        stage(p.hid, hs, B * 4 * D);
        for (int f = gwarp; f < D; f += nwarps) {
            const T* w = weight(p, l, W2) + (size_t)f * 4 * D;
            const float acc = warp_project(w, hs, 4 * D, B, lane);
            residual(p.x, D, f, B, lane, acc, weight(p, l, B2));
        }
        // the last phase of the last layer meets the others only when timed
        if (l + 1 < p.L || p.clock != nullptr) grid_sync(p.bar, target);
        stamp(p.clock, 8 * l + 8);
    }
}


// ---- bf16: tensor cores, weights streamed by a producer warp ----------------

constexpr int NCW = 8;                      // consumer warps
constexpr int NCT = NCW * 32;               // consumer threads
constexpr int TC_THREADS = NCT + 32;        // and one producer warp
constexpr int TM = 8;                       // output features a tile (the mma's N)
constexpr int CK = 512;                     // weight columns a ring stage
constexpr int WPITCH = CK * 2 + 16;         // bytes of a stage row, padded
constexpr int STAGE = TM * WPITCH;          // bytes of a ring stage
constexpr int MAX_NST = 16;                 // weight ring stages
constexpr int MAX_CST = 4;                  // cross ring stages
constexpr int CTR = 8;                      // rows of the [64, Tk] planes a cross stage
constexpr int NPH = 6;                      // projections a layer
constexpr int MAX_D = 2048;                 // LayerNorm rows held in registers
constexpr int SMEM_MAX = 227 * 1024;
static_assert(CTR == NCW, "P V: a warp a row of a V^T tile");

struct TcStep {
    const long long* wtab;        // [L, NW] pointers to bf16
    const bf16* kv;               // [L, A, H, 2, 64, Tk] cross K^T and V^T
    const long long* key_start;   // [B], or null for zeros
    const long long* pos;         // the step's slot, one int64 in device memory
    bf16* x;                      // [B, D] residual stream, in and out
    bf16* kc;                     // [L, B, H, n_ctx, 64]
    bf16* vc;
    bf16* q;                      // [B, D] scratch: the self q, then the cross q
    bf16* att;                    // [B, D] scratch: attention outputs
    bf16* hid;                    // [B, 4D] scratch: the MLP's hidden row
    float* part;                  // split-K partials of a phase, [ks][N][B]
    unsigned int* bar;            // grid barrier counter, 0 at launch
    unsigned int* flags;          // [ks][N / 16]: a partial tile's epoch, 0 at launch
    unsigned long long* clock;    // [8 L + 1] phase-end times in ns, or null
    const int* plan;              // [NPH][2] (ks, kw), then [NPH][grid][3] (slice, t0, t1)
    int B, D, H, L, G, Tk, n_ctx, window;
    float scale;
    int nst, cst, ap;             // ring stages, cross stages, staged row pitch (bytes)
};

// The consumers' own barrier: the producer warp never joins it.
__device__ __forceinline__ void cbar() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory");
}

// The grid barrier of grid_sync, met by the consumer warps alone: the
// arrival a release reduction (no value comes back, so no round trip is
// waited for), then acquire polls; the block's barriers on either side
// carry the ordering to its other threads.
__device__ __forceinline__ void grid_sync_tc(unsigned int* bar, unsigned int& target) {
    cbar();
    target += gridDim.x;
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar) : "memory");
        unsigned int seen, polls = 0;
        do {
            asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(seen) : "l"(bar) : "memory");
            if (++polls == (1u << 26)) __trap();
        } while (seen < target);
    }
    cbar();
}

// mbar_wait that traps, as grid_sync does, where a wait outlasts any phase
// by far (a ring whose producer and consumers disagree), instead of hanging.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, int parity) {
    uint32_t done, polls = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
        if (++polls == (1u << 24)) __trap();
    } while (!done);
}

// One bulk copy (the TMA engine) of `bytes` (a multiple of 16) from global
// to shared memory, both 16-byte aligned, counted on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// Projection ph of a layer (0 q/k/v, 1 Wo, 2 Wcq, 3 Wco, 4 fc1, 5 fc2):
// its N and this block's share, slice `slice` (columns slice kw .. slice kw
// + kw) of the tiles t0 .. t1 - 1 (features 8 t .. 8 t + 7).
struct Proj {
    int N, ks, kw, slice, t0, t1;
};

// The block's plan, 5 NPH ints: [ph][2] (ks, kw), then [ph][3] (slice, t0, t1).
constexpr int PLAN_INTS = 5 * NPH;
static_assert(PLAN_INTS <= 32, "the producer holds the plan, an entry a lane");
__device__ __forceinline__ int plan_entry(const TcStep& p, int i) {
    return i < 2 * NPH ? __ldg(p.plan + i)
                       : __ldg(p.plan + 2 * NPH +
                               (((i - 2 * NPH) / 3) * gridDim.x + blockIdx.x) * 3 + (i - 2 * NPH) % 3);
}

__device__ __forceinline__ Proj proj_of(const TcStep& p, const int* plan, int ph) {
    Proj r;
    r.ks = plan[2 * ph];
    r.kw = plan[2 * ph + 1];
    r.slice = plan[2 * NPH + 3 * ph];
    r.t0 = plan[2 * NPH + 3 * ph + 1];
    r.t1 = plan[2 * NPH + 3 * ph + 2];
    r.N = ph == 0 ? 3 * p.D : ph == 4 ? 4 * p.D : p.D;
    return r;
}

// The weight matrices of a layer, in the order the producer holds them
// (a lane each): q, k, v, out, cross q, cross out, fc1, fc2.
__device__ __forceinline__ int matrix_column(int j) {
    return j == 0 ? WQ : j == 1 ? WK : j == 2 ? WV : j == 3 ? WO : j == 4 ? WCQ : j == 5 ? WCO
         : j == 6 ? W1 : W2;
}

// The producer warp: every chunk (8 rows x up to CK columns) of the
// block's tiles, phase after phase and layer after layer, into ring stage
// it % nst once the consumers have released it; lane r copies row r.  The
// block's plan (lane i its entry i) and the layer's matrix pointers (lane j
// matrix j, the next layer's read a layer ahead) stay in registers, so the
// producer waits on no global load while it issues.
__device__ void produce(const TcStep& p, uint32_t ring, uint64_t* full, uint64_t* empty) {
    const int lane = threadIdx.x & 31;
    const int entry = lane < PLAN_INTS ? plan_entry(p, lane) : 0;
    long long cur = lane < 8 ? __ldg(p.wtab + matrix_column(lane)) : 0;
    int it = 0;
    for (int l = 0; l < p.L; ++l) {
        const long long next =
            lane < 8 && l + 1 < p.L ? __ldg(p.wtab + (size_t)(l + 1) * NW + matrix_column(lane)) : 0;
        for (int ph = 0; ph < NPH; ++ph) {
            const int kw = __shfl_sync(0xffffffffu, entry, 2 * ph + 1);
            const int slice = __shfl_sync(0xffffffffu, entry, 2 * NPH + 3 * ph);
            const int t0 = __shfl_sync(0xffffffffu, entry, 2 * NPH + 3 * ph + 1);
            const int t1 = __shfl_sync(0xffffffffu, entry, 2 * NPH + 3 * ph + 2);
            const int K = ph == 5 ? 4 * p.D : p.D;
            for (int t = t0; t < t1; ++t) {
                // row n of the phase's matrix (q/k/v: of the one it falls in)
                int n = t * TM + lane, j = ph + 2;
                if (ph == 0) {
                    j = (t * TM) / p.D;
                    n -= j * p.D;
                }
                const bf16* w = reinterpret_cast<const bf16*>(__shfl_sync(0xffffffffu, cur, j)) +
                                (size_t)n * K + slice * kw;
                for (int c0 = 0; c0 < kw; c0 += CK, ++it) {
                    const int st = it % p.nst;
                    const uint32_t bytes = min(CK, kw - c0) * 2;
                    const uint32_t fb = smem_addr(&full[st]);
                    if (lane == 0) {
                        mbar_wait_or_trap(smem_addr(&empty[st]), ((it / p.nst) & 1) ^ 1);  // round 0 passes
                        mbar_expect_tx(fb, TM * bytes);
                    }
                    __syncwarp();
                    if (lane < TM) bulk_load(ring + st * STAGE + lane * WPITCH, w + c0, bytes, fb);
                }
            }
        }
        cur = next;
    }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

// LayerNorm of the B rows of x [B, D] in f32 (every block takes the whole
// rows, for the statistics), rounded to bf16; columns k0 .. k0 + kw of each
// row into act (row pitch ap bytes).  The rows come into xs [B, D] and the
// slice's scale and offset into lnbuf [2][kw] by async copies, all in
// flight at once; then a warp a row, in short loops (this code runs once a
// phase, so it is kept small).
__device__ void stage_ln(const TcStep& p, const bf16* __restrict__ g,
                         const bf16* __restrict__ beta, unsigned char* act, bf16* lnbuf, bf16* xs,
                         int k0, int kw) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, D = p.D;
    const int row_chunks = D / 8, n = p.B * row_chunks;
    for (int i = threadIdx.x; i < n + kw / 4; i += NCT) {
        if (i < n) {
            cp_async16(xs + 8 * i, p.x + 8 * i);
        } else {
            const int j = i - n, c = j % (kw / 8);
            cp_async16(lnbuf + 8 * j, (j < kw / 8 ? g : beta) + k0 + 8 * c);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    cbar();
    for (int b = warp; b < p.B; b += NCW) {
        const bf16* xr = xs + (size_t)b * D;
        float s = 0.f;
#pragma unroll 1
        for (int c = lane; c < row_chunks; c += 32) {
            float v[8];
            unpack(ld_sh(xr + 8 * c), v);
#pragma unroll
            for (int e = 0; e < 8; ++e) s += v[e];
        }
        const float mean = warp_sum(s) / D;
        float ss = 0.f;
#pragma unroll 1
        for (int c = lane; c < row_chunks; c += 32) {
            float v[8];
            unpack(ld_sh(xr + 8 * c), v);
#pragma unroll
            for (int e = 0; e < 8; ++e) ss += (v[e] - mean) * (v[e] - mean);
        }
        const float rstd = rsqrtf(warp_sum(ss) / D + EPS);
#pragma unroll 1
        for (int c = lane; c < kw / 8; c += 32) {
            float v[8], gv[8], bv[8];
            unpack(ld_sh(xr + k0 + 8 * c), v);
            unpack(ld_sh(lnbuf + 8 * c), gv);
            unpack(ld_sh(lnbuf + kw + 8 * c), bv);
            uint4 out;
            bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
            for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16((v[e] - mean) * rstd * gv[e] + bv[e]);
            *reinterpret_cast<uint4*>(act + (size_t)b * p.ap + 16 * c) = out;
        }
    }
}

// Columns k0 .. k0 + kw of the B rows of src [B, ld] (written during the
// launch) into act, every 16-byte chunk by an async copy (past L1), all in
// flight at once.
__device__ void stage_rows(const bf16* src, int ld, int B, unsigned char* act, int ap, int k0,
                           int kw) {
    const int per_row = kw / 8, n = B * per_row;
    for (int i = threadIdx.x; i < n; i += NCT)
        cp_async16(act + (size_t)(i / per_row) * ap + (i % per_row) * 16,
                   src + (size_t)(i / per_row) * ld + k0 + (i % per_row) * 8);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The inputs of the epilogue of output feature n of projection ph for row
// b: its bias (0 for the key, which has none) and, for the residual
// phases, x[b, n].  wrow: the layer's row of the weight table.
__device__ __forceinline__ float2 epilogue_inputs(const TcStep& p, const long long* wrow, int ph,
                                                  int n, int b) {
    int col = ph == 1 ? BO : ph == 2 ? BCQ : ph == 3 ? BCO : ph == 4 ? B1 : B2, f = n;
    if (ph == 0) {
        const int which = n / p.D;
        col = which == 0 ? BQ : which == 2 ? BV : -1;
        f = n - which * p.D;
    }
    float2 in;
    in.x = col < 0 ? 0.f : to_float(reinterpret_cast<const bf16*>(wrow[col])[f]);
    in.y = ph == 1 || ph == 3 || ph == 5 ? to_float(__ldcg(p.x + (size_t)b * p.D + n)) : 0.f;
    return in;
}

// The epilogue of output feature n of projection ph for row b, from its f32
// sum over K and its inputs: round, bias, round; then the q scale, the K/V
// column, GELU or the residual, as the f32 instance does.
__device__ __forceinline__ void finish(const TcStep& p, int l, int ph, int n, int b, float acc,
                                       float2 in) {
    const int D = p.D;
    const float y = round_to<bf16>(acc);
    switch (ph) {
        case 0: {
            const int which = n / D, f = n - which * D;
            if (which == 0) {
                p.q[(size_t)b * D + f] = from_float<bf16>(round_to<bf16>(y + in.x) * p.scale);
            } else {
                const float v = which == 2 ? round_to<bf16>(y + in.x) : y;
                const size_t row = ((size_t)l * p.B + b) * p.H + f / DH;
                (which == 1 ? p.kc : p.vc)[(row * p.n_ctx + slot_of(p)) * DH + f % DH] =
                    from_float<bf16>(v);
            }
            break;
        }
        case 2:
            p.q[(size_t)b * D + n] = from_float<bf16>(round_to<bf16>(y + in.x) * p.scale);
            break;
        case 4:
            p.hid[(size_t)b * 4 * D + n] = from_float<bf16>(gelu<bf16>(round_to<bf16>(y + in.x)));
            break;
        default:  // 1, 3, 5: x += round(y + bias)
            p.x[(size_t)b * D + n] = from_float<bf16>(in.y + round_to<bf16>(y + in.x));
    }
}

// A flag store after the caller's fence (which releases the partials).
__device__ __forceinline__ void publish(unsigned int* flag, unsigned int epoch) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(flag), "r"(epoch) : "memory");
}

// Wait until the flag holds `epoch` or a later one; traps as grid_sync does.
__device__ __forceinline__ void await(const unsigned int* flag, unsigned int epoch) {
    unsigned int seen, polls = 0;
    do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(flag) : "memory");
        if (++polls == (1u << 26)) __trap();
    } while (seen < epoch);
}

constexpr int MAXT = 4;        // tiles whose epilogue inputs a thread loads at once
constexpr int PART_LOADS = 8;  // partials a thread loads at once
constexpr int TILE_OUT = 16 * TM;  // outputs of a tile: 16 rows x TM features

// The block's tiles of projection ph on the tensor cores: the activations'
// K-slice staged in act [8 or 16 rows, ap bytes a row] is the mma's A (rows
// of x on M; rows past B are never stored), the 8 weight rows of a ring stage
// its B (features on N); `it` counts the ring's chunks as the producer
// does.  red: two sets of the warps' f32 tiles [NCW][16][8], used in turns;
// res: the block's tile sums [tile][128].  Every tile's products
// first, then one merge and one epilogue for all of them, so the global
// round trips are paid once a phase and not a tile.  Thread tid < 128 takes
// output (row tid / 8, feature 8 t + tid % 8) of each tile t.
__device__ void project(const TcStep& p, int l, int ph, const Proj& pr, int& it, uint32_t ring,
                        uint64_t* full, uint64_t* empty, const unsigned char* act, float* red,
                        float* res, const long long* wrow) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const uint32_t act_s = smem_addr(act);
    const int T = pr.N / TM, nt = pr.t1 - pr.t0;
    const int b = tid >> 3, f = tid & 7;
    const bool mine = tid < TILE_OUT && b < p.B;
    // the owner's epilogue inputs of its first tiles, in flight under the products
    float2 in[MAXT];
    if (pr.slice == 0) {
#pragma unroll
        for (int i = 0; i < MAXT; ++i)
            if (i < nt && mine) in[i] = epilogue_inputs(p, wrow, ph, (pr.t0 + i) * TM + f, b);
    }
    // lanes' ldmatrix rows: A rows 0-15 (0-7 twice where B <= 8: only 8 rows
    // are staged) at k + 8 (lane / 16); B rows 0-7 at k + 8 (lane / 8 % 2)
    const uint32_t a_off = (lane & (p.B > 8 ? 15 : 7)) * p.ap + 16 * (lane >> 4);
    const uint32_t b_off = (lane & 7) * WPITCH + 16 * ((lane >> 3) & 1);
    for (int i = 0; i < nt; ++i) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c0 = 0; c0 < pr.kw; c0 += CK, ++it) {
            const int st = it % p.nst;
            const int steps = min(CK, pr.kw - c0) / 16;
            mbar_wait_or_trap(smem_addr(&full[st]), (it / p.nst) & 1);
            const uint32_t wb = ring + st * STAGE + b_off, ab = act_s + c0 * 2 + a_off;
            for (int s = warp; s < steps; s += NCW) {
                uint32_t a[4], b0, b1;
                ldsm_x4(a, ab + s * 32);
                ldsm_x2(b0, b1, wb + s * 32);
                mma_bf16(acc, a, b0, b1);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(smem_addr(&empty[st]));  // this warp is done
        }
        // red[w][row][feature]: accumulator (row g or g + 8, feature 2 (lane % 4) + {0, 1})
        float* rb = red + (i & 1) * NCW * TILE_OUT;
        float* out = rb + warp * TILE_OUT;
        const int g = lane >> 2, c = 2 * (lane & 3);
        out[g * TM + c] = acc[0];
        out[g * TM + c + 1] = acc[1];
        out[(g + 8) * TM + c] = acc[2];
        out[(g + 8) * TM + c + 1] = acc[3];
        cbar();  // the next tile writes the other set; the one after, after the next barrier
        if (mine) {
            float r = 0.f;
#pragma unroll
            for (int w = 0; w < NCW; ++w) r += rb[w * TILE_OUT + tid];
            if (pr.slice > 0)
                p.part[((size_t)pr.slice * pr.N + (pr.t0 + i) * TM + f) * p.B + b] = r;
            else
                res[i * TILE_OUT + tid] = r;
        }
    }
    if (pr.slice > 0) {
        // publish the partials: every tile's flag at once, after one fence
        cbar();
        if (tid == 0) {
            asm volatile("fence.acq_rel.gpu;\n" ::: "memory");  // releases the writes before
            for (int t = pr.t0; t < pr.t1; ++t) publish(p.flags + pr.slice * T + t, NPH * l + ph + 1);
        }
        return;
    }
    if (pr.ks > 1) {
        // slice 0 owns its tiles: its sums, then slices 1.. in order,
        // PART_LOADS loads in flight
        for (int q = tid; q < (pr.ks - 1) * nt; q += NCT)  // a thread a flag
            await(p.flags + (1 + q / nt) * T + pr.t0 + q % nt, NPH * l + ph + 1);
        cbar();
        const int nq = (pr.ks - 1) * nt;
        for (int q0 = 0; q0 < nq && mine; q0 += PART_LOADS) {
            float v[PART_LOADS];
#pragma unroll
            for (int q = 0; q < PART_LOADS; ++q) {
                const int s = 1 + (q0 + q) / nt, i = (q0 + q) % nt;
                if (q0 + q < nq)
                    v[q] = __ldcg(p.part + ((size_t)s * pr.N + (pr.t0 + i) * TM + f) * p.B + b);
            }
#pragma unroll
            for (int q = 0; q < PART_LOADS; ++q)
                if (q0 + q < nq) res[((q0 + q) % nt) * TILE_OUT + tid] += v[q];
        }
    }
    for (int i0 = 0; i0 < nt && mine; i0 += MAXT) {
        if (i0 > 0) {
#pragma unroll
            for (int i = 0; i < MAXT; ++i)
                if (i0 + i < nt) in[i] = epilogue_inputs(p, wrow, ph, (pr.t0 + i0 + i) * TM + f, b);
        }
#pragma unroll
        for (int i = 0; i < MAXT; ++i)
            if (i0 + i < nt)
                finish(p, l, ph, (pr.t0 + i0 + i) * TM + f, b, res[(i0 + i) * TILE_OUT + tid],
                       in[i]);
    }
    if (ph == 0 || ph == 2) {
        // q/k/v and the cross q: the attention that follows waits on these
        // tiles' flags (slot t of slice 0, which no partial takes), not on
        // a grid barrier
        cbar();
        if (tid == 0) {
            asm volatile("fence.acq_rel.gpu;\n" ::: "memory");  // releases the writes before
            for (int t = pr.t0; t < pr.t1; ++t) publish(p.flags + t, NPH * l + ph + 1);
        }
    }
}

// Phase 2 on the consumers: one block per (row, head), scores of slots
// lo..pos in ws; the V rows come into vs [n_ctx, 64] by async copies issued
// first, the K rows of U passes are loaded before any is used.
__device__ void self_attention_tc(const TcStep& p, int l, float* ws, bf16* vs, float (*red)[DH],
                                  float* stat) {
    constexpr int VEC = 8, LPR = DH / VEC, KPW = 32 / LPR, STRIDE = NCW * KPW, U = 8;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = lane / LPR, seg = lane % LPR;
    const int hi = slot_of(p);
    for (int it = blockIdx.x; it < p.B * p.H; it += gridDim.x) {
        const int b = it / p.H, h = it % p.H;
        const size_t head = (((size_t)l * p.B + b) * p.H + h) * p.n_ctx * DH;
        const bf16* kc = p.kc + head;
        const bf16* vc = p.vc + head;
        // the current token (slot pos) is always visible
        const long long ks = p.key_start ? p.key_start[b] : 0;
        const int lo = ks <= 0 ? 0 : (ks > hi ? hi : (int)ks);
        const int n = hi - lo + 1;

        // q, k and v of head h (8 tiles each of q/k/v's 3 D / 8) are in
        if (tid < 3 * DH / TM) {
            const int which = tid / (DH / TM);
            await(p.flags + (which * p.D + h * DH) / TM + tid % (DH / TM), NPH * l + 1);
        }
        cbar();
        for (int i = tid; i < n * LPR; i += NCT)
            cp_async16(vs + (size_t)i * VEC, vc + (size_t)lo * DH + (size_t)i * VEC);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        float qx[VEC];
        unpack(ld_cg(p.q + (size_t)b * p.D + h * DH + seg * VEC), qx);
        float lmax = -INFINITY;
        for (int j0 = lo + warp * KPW + grp; j0 - grp <= hi; j0 += STRIDE * U) {
            uint4 kr[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (j0 + u * STRIDE <= hi) kr[u] = ld_cg(kc + (size_t)(j0 + u * STRIDE) * DH + seg * VEC);
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int j = j0 + u * STRIDE;
                float part = 0.f;
                if (j <= hi) {
                    float kx[VEC];
                    unpack(kr[u], kx);
#pragma unroll
                    for (int e = 0; e < VEC; ++e) part = fmaf(qx[e], kx[e], part);
                }
#pragma unroll
                for (int o = LPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
                if (j <= hi) {
                    if (seg == 0) ws[j - lo] = part;
                    lmax = fmaxf(lmax, part);
                }
            }
        }
        lmax = warp_max(lmax);
        if (lane == 0) stat[warp] = lmax;
        cbar();
        float m = stat[0];
#pragma unroll
        for (int w = 1; w < NCW; ++w) m = fmaxf(m, stat[w]);
        cbar();
        float lsum = 0.f;
        for (int i = tid; i < n; i += NCT) {
            const float e = expf(ws[i] - m);
            ws[i] = e;
            lsum += e;
        }
        lsum = warp_sum(lsum);
        if (lane == 0) stat[warp] = lsum;
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        cbar();  // and the V rows are in
        float total = 0.f;
#pragma unroll
        for (int w = 0; w < NCW; ++w) total += stat[w];

        // sum_j e_j V_j in f32, divided by the sum at the end
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll 4
        for (int j = lo + warp * KPW + grp; j <= hi; j += STRIDE) {
            const float wj = ws[j - lo];
            float vx[VEC];
            unpack(ld_sh(vs + (size_t)(j - lo) * DH + seg * VEC), vx);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wj, vx[e], acc[e]);
        }
#pragma unroll
        for (int o = 16; o >= LPR; o >>= 1) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
        }
        if (grp == 0) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) red[warp][seg * VEC + e] = acc[e];
        }
        cbar();
        if (tid < DH) {
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < NCW; ++w) s += red[w][tid];
            p.att[(size_t)b * p.D + h * DH + tid] = from_float<bf16>(s / total);
        }
        cbar();  // ws, red and stat serve the next item
    }
}

// Phase 5 on the consumers: one block per (audio, head), its GM rows
// together.  Tile i of the item (i < 8: rows 8 i .. of K^T, else of V^T)
// streams through the cross ring (stage (ct + i) % cst); ct counts the
// block's tiles across items and layers.  sc [GM][Tk] f32 after the ring.
template <int GM>
__device__ void cross_attention_tc(const TcStep& p, int l, unsigned char* region,
                                   uint64_t* cfull, int& ct, float (*qs)[DH],
                                   float (*cred)[NCW], float (*cstat)[GM]) {
    constexpr int NT = DH / CTR;  // tiles a plane
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int Tk = p.Tk, T4 = Tk / 4, A = p.B / GM;
    const uint32_t tile_bytes = CTR * Tk * 2;
    float* sc = reinterpret_cast<float*>(region + p.cst * tile_bytes);
    for (int it = blockIdx.x; it < A * p.H; it += gridDim.x) {
        const int a = it / p.H, h = it % p.H;
        const bf16* kt = p.kv + ((((size_t)l * A + a) * p.H + h) * 2) * DH * Tk;  // K^T, then V^T
        auto issue = [&](int i) {
            if (tid == 0 && i < 2 * NT) {
                const int st = (ct + i) % p.cst;
                const uint32_t fb = smem_addr(&cfull[st]);
                mbar_expect_tx(fb, tile_bytes);
                bulk_load(smem_addr(region + st * tile_bytes), kt + (size_t)i * CTR * Tk, tile_bytes,
                          fb);
            }
        };
        if (tid < DH / TM)  // the cross q of head h is in
            await(p.flags + h * DH / TM + tid, NPH * l + 3);
        cbar();
        for (int i = tid; i < GM * DH; i += NCT)
            qs[i / DH][i % DH] =
                to_float(__ldcg(p.q + ((size_t)a * GM + i / DH) * p.D + h * DH + i % DH));
        // this region was written by the threads before: order those writes
        // before the TMA engine's
        if (tid == 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int i = 0; i < p.cst - 1; ++i) issue(i);
        for (int i = 0; i < 2 * NT; ++i) {
            cbar();  // tile i - 1 is consumed: its stage may be refilled (and qs is in)
            issue(i + p.cst - 1);
            const int st = (ct + i) % p.cst;
            mbar_wait_or_trap(smem_addr(&cfull[st]), ((ct + i) / p.cst) & 1);
            const bf16* tile = reinterpret_cast<const bf16*>(region + st * tile_bytes);
            if (i < NT) {
                // scores: a thread a quad of keys and up to GS rows, rows of
                // the tile in order, added to the sums of the tiles before
                // (kept in sc); two rows at most, as the q values of a
                // tile's rows stay in registers across the quads
                constexpr int GS = GM < 2 ? GM : 2;
                const int d0 = i * CTR;
                for (int q = tid; q < T4 * (GM / GS); q += NCT) {
                    const int jq = q % T4, g0 = q / T4 * GS;
                    float4 s[GS];
#pragma unroll
                    for (int g = 0; g < GS; ++g)
                        s[g] = i == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                      : *reinterpret_cast<const float4*>(&sc[(g0 + g) * Tk + 4 * jq]);
#pragma unroll
                    for (int r = 0; r < CTR; ++r) {
                        const float4 k4 = load4(tile + r * Tk + 4 * jq);
#pragma unroll
                        for (int g = 0; g < GS; ++g) {
                            const float qv = qs[g0 + g][d0 + r];
                            s[g].x = fmaf(qv, k4.x, s[g].x);
                            s[g].y = fmaf(qv, k4.y, s[g].y);
                            s[g].z = fmaf(qv, k4.z, s[g].z);
                            s[g].w = fmaf(qv, k4.w, s[g].w);
                        }
                    }
#pragma unroll
                    for (int g = 0; g < GS; ++g)
                        *reinterpret_cast<float4*>(&sc[(g0 + g) * Tk + 4 * jq]) = s[g];
                }
                if (i == NT - 1) {
                    // f32 statistics over all Tk keys, then the weights
                    // e / sum rounded to bf16, as the reference rounds them
                    cbar();
                    float mx[GM];
#pragma unroll
                    for (int g = 0; g < GM; ++g) {
                        mx[g] = -INFINITY;
                        for (int jq = tid; jq < T4; jq += NCT) {
                            const float4 v = *reinterpret_cast<const float4*>(&sc[g * Tk + 4 * jq]);
                            mx[g] = fmaxf(mx[g], fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
                        }
                        const float wm = warp_max(mx[g]);
                        if (lane == 0) cred[g][warp] = wm;
                    }
                    cbar();
                    if (tid < GM) {
                        float m = -INFINITY;
                        for (int w = 0; w < NCW; ++w) m = fmaxf(m, cred[tid][w]);
                        cstat[0][tid] = m;
                    }
                    cbar();
#pragma unroll
                    for (int g = 0; g < GM; ++g) {
                        const float m = cstat[0][g];
                        float t = 0.f;
                        for (int jq = tid; jq < T4; jq += NCT) {
                            float4* e4 = reinterpret_cast<float4*>(&sc[g * Tk + 4 * jq]);
                            float4 e = *e4;
                            e.x = expf(e.x - m);
                            e.y = expf(e.y - m);
                            e.z = expf(e.z - m);
                            e.w = expf(e.w - m);
                            *e4 = e;
                            t += e.x;
                            t += e.y;
                            t += e.z;
                            t += e.w;
                        }
                        const float ws = warp_sum(t);
                        if (lane == 0) cred[g][warp] = ws;
                    }
                    cbar();
                    if (tid < GM) {
                        float s = 0.f;
                        for (int w = 0; w < NCW; ++w) s += cred[tid][w];
                        cstat[1][tid] = s;
                    }
                    cbar();
#pragma unroll
                    for (int g = 0; g < GM; ++g) {
                        const float s = cstat[1][g];
                        for (int jq = tid; jq < T4; jq += NCT) {
                            float4* w4 = reinterpret_cast<float4*>(&sc[g * Tk + 4 * jq]);
                            float4 w = *w4;
                            w.x = round_to<bf16>(w.x / s);
                            w.y = round_to<bf16>(w.y / s);
                            w.z = round_to<bf16>(w.z / s);
                            w.w = round_to<bf16>(w.w / s);
                            *w4 = w;
                        }
                    }
                    // the next tile's barrier orders these before P V
                }
            } else {
                // P V: warp w takes row 8 (i - NT) + w of V^T, its lanes quads of
                // keys, up to 4 rows of the item at a time (the accumulators
                // of 8 would not fit the registers)
                const int d = (i - NT) * CTR + warp;
                const bf16* row = tile + warp * Tk;
                constexpr int GP = GM < 4 ? GM : 4;
#pragma unroll
                for (int g0 = 0; g0 < GM; g0 += GP) {
                    float acc[GP];
#pragma unroll
                    for (int g = 0; g < GP; ++g) acc[g] = 0.f;
                    // loads in flight a lane: 4 quads of keys for one or two
                    // rows, one above (its weight quads take the registers)
                    auto pv = [&](int jq) {
                        const float4 v4 = load4(row + 4 * jq);
#pragma unroll
                        for (int g = 0; g < GP; ++g) {
                            const float4 w =
                                *reinterpret_cast<const float4*>(&sc[(g0 + g) * Tk + 4 * jq]);
                            acc[g] = fmaf(w.x, v4.x, acc[g]);
                            acc[g] = fmaf(w.y, v4.y, acc[g]);
                            acc[g] = fmaf(w.z, v4.z, acc[g]);
                            acc[g] = fmaf(w.w, v4.w, acc[g]);
                        }
                    };
                    if (GM <= 2) {
#pragma unroll 4
                        for (int jq = lane; jq < T4; jq += 32) pv(jq);
                    } else {
#pragma unroll 1
                        for (int jq = lane; jq < T4; jq += 32) pv(jq);
                    }
#pragma unroll
                    for (int g = 0; g < GP; ++g) {
                        const float s = warp_sum(acc[g]);
                        if (lane == 0)
                            p.att[((size_t)a * GM + g0 + g) * p.D + h * DH + d] =
                                from_float<bf16>(s);
                    }
                }
            }
        }
        ct += 2 * NT;
        cbar();  // sc, qs and the ring serve the next item
    }
}

template <int GM>
__global__ void __launch_bounds__(TC_THREADS, 1) decoder_step_tc_kernel(const TcStep p) {
    extern __shared__ __align__(128) unsigned char smem_tc[];
    __shared__ __align__(8) uint64_t full[MAX_NST], empty[MAX_NST], cfull[MAX_CST];
    __shared__ float qs[GM][DH];
    __shared__ float sred[NCW][DH];
    __shared__ float cred[GM][NCW];
    __shared__ float cstat[2][GM];
    __shared__ float stat[NCW];
    __shared__ long long wrows[2][NW];  // the weight table's rows of this layer and the next
    __shared__ int splan[PLAN_INTS];     // the block's plan
    const uint32_t ring = smem_addr(smem_tc);
    // after the ring, one region per phase kind: the staged rows and the
    // warps' tiles (projections), the scores (self-attention), the cross
    // ring and scores (cross-attention)
    unsigned char* region = smem_tc + p.nst * STAGE;
    unsigned char* act = region;
    float* red = reinterpret_cast<float*>(region + (p.B > 8 ? 16 : 8) * p.ap);
    bf16* lnbuf = reinterpret_cast<bf16*>(red + 2 * NCW * TILE_OUT);
    bf16* xs = lnbuf + 2 * MAX_D;  // [B, D]: the rows a LayerNorm reads
    float* res = reinterpret_cast<float*>(xs + (size_t)p.B * p.D);

    if (no_step(p)) return;
    if (threadIdx.x == 0) {
        for (int s = 0; s < p.nst; ++s) {
            mbar_init(smem_addr(&full[s]), 1);
            mbar_init(smem_addr(&empty[s]), NCW);  // one arrival a consumer warp
        }
        for (int s = 0; s < p.cst; ++s) mbar_init(smem_addr(&cfull[s]), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (threadIdx.x < NW) wrows[0][threadIdx.x] = __ldg(p.wtab + threadIdx.x);
    if (threadIdx.x < PLAN_INTS) splan[threadIdx.x] = plan_entry(p, threadIdx.x);
    __syncthreads();  // the last barrier the producer joins
    if (threadIdx.x >= NCT) {
        produce(p, ring, full, empty);
        return;
    }

    const int D = p.D;
    unsigned int target = 0;
    int it = 0, ct = 0;
    stamp(p.clock, 0);
    // projection ph: stage the block's K-slice of its input, then its tiles
    auto projection = [&](int l, int ph) {
        const Proj pr = proj_of(p, splan, ph);
        if (pr.t1 <= pr.t0) return;
        const int k0 = pr.slice * pr.kw;
        const long long* wrow = wrows[l & 1];
        if (ph == 0 || ph == 2 || ph == 4) {
            const int g = ph == 0 ? LN1_W : ph == 2 ? LN2_W : LN3_W;
            stage_ln(p, reinterpret_cast<const bf16*>(wrow[g]),
                     reinterpret_cast<const bf16*>(wrow[g + 1]), act, lnbuf, xs, k0, pr.kw);
        } else if (ph == 5) {
            stage_rows(p.hid, 4 * D, p.B, act, p.ap, k0, pr.kw);
        } else {
            stage_rows(p.att, D, p.B, act, p.ap, k0, pr.kw);
        }
        cbar();
        project(p, l, ph, pr, it, ring, full, empty, act, red, res, wrow);
    };

    for (int l = 0; l < p.L; ++l) {
        projection(l, 0);  // 1. LN1; q, k, v; the K/V column into the cache
        stamp(p.clock, 8 * l + 1);  // (no barrier: phase 2 waits on tiles' flags)
        self_attention_tc(p, l, reinterpret_cast<float*>(region),  // 2.
                          reinterpret_cast<bf16*>(region + (4 * p.n_ctx + 15) / 16 * 16), sred,
                          stat);
        grid_sync_tc(p.bar, target);
        stamp(p.clock, 8 * l + 2);
        projection(l, 1);  // 3. out-projection and residual
        grid_sync_tc(p.bar, target);
        stamp(p.clock, 8 * l + 3);
        projection(l, 2);  // 4. LN2 and the cross q
        stamp(p.clock, 8 * l + 4);  // (no barrier: phase 5 waits on tiles' flags)
        // the next layer's table row, read by its first phase (after barriers)
        if (l + 1 < p.L && threadIdx.x < NW)
            wrows[(l + 1) & 1][threadIdx.x] = __ldg(p.wtab + (size_t)(l + 1) * NW + threadIdx.x);
        cross_attention_tc<GM>(p, l, region, cfull, ct, qs, cred, cstat);  // 5.
        grid_sync_tc(p.bar, target);
        stamp(p.clock, 8 * l + 5);
        projection(l, 3);  // 6. cross out-projection and residual
        grid_sync_tc(p.bar, target);
        stamp(p.clock, 8 * l + 6);
        projection(l, 4);  // 7. LN3, fc1, bias, GELU
        grid_sync_tc(p.bar, target);
        stamp(p.clock, 8 * l + 7);
        projection(l, 5);  // 8. fc2 and residual
        // the last phase of the last layer meets the others only when timed
        if (l + 1 < p.L || p.clock != nullptr) grid_sync_tc(p.bar, target);
        stamp(p.clock, 8 * l + 8);
    }
}

template <int GM>
int launch_tc(const TcStep& p, int blocks, int smem, cudaStream_t stream) {
    auto kernel = decoder_step_tc_kernel<GM>;
    cudaFuncAttributes fa = {};
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (smem + fa.sharedSizeBytes > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int device = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TC_THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1 || blocks > per_sm * sms)
        return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    TcStep arg = p;
    void* args[] = {&arg};
    e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(TC_THREADS), args, smem,
                                    stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int GM>
int launch(const Step<T>& p, size_t smem, cudaStream_t stream) {
    auto kernel = decoder_step_kernel<T, GM>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int device = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    Step<T> arg = p;
    void* args[] = {&arg};
    e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms),
                                    dim3(THREADS), args, smem, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int D, int H, int L, int G, int Tk, int n_ctx, const void* pos,
              int window) {
    return B >= 1 && B <= MAX_ROWS && G >= 1 && B % G == 0 && D == H * DH && Tk >= 4 &&
           Tk % 4 == 0 && window >= 1 && window <= n_ctx && pos != nullptr && L >= 1;
}

template <typename T>
int dispatch(const void* wtab, const void* kv, const void* key_start, void* x, void* kc, void* vc,
             void* q, void* att, void* hid, void* bar, void* clock, int B, int D, int H, int L,
             int G, int Tk, int n_ctx, const void* pos, int window, float scale,
             void* stream) {
    if (!shape_ok(B, D, H, L, G, Tk, n_ctx, pos, window))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t rows = (size_t)B * 4 * D * sizeof(T);
    const size_t cross = (size_t)G * Tk * sizeof(float);
    const size_t self = (size_t)n_ctx * sizeof(float);
    const size_t smem = rows > cross ? (rows > self ? rows : self) : (cross > self ? cross : self);
    const Step<T> p{static_cast<const long long*>(wtab), static_cast<const T*>(kv),
                    static_cast<const long long*>(key_start),
                    static_cast<const long long*>(pos), static_cast<T*>(x),
                    static_cast<T*>(kc), static_cast<T*>(vc), static_cast<T*>(q),
                    static_cast<T*>(att), static_cast<T*>(hid),
                    static_cast<unsigned int*>(bar), static_cast<unsigned long long*>(clock),
                    B, D, H, L, G, Tk, n_ctx, window, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (G == 1) return launch<T, 1>(p, smem, s);
    if (G == 2) return launch<T, 2>(p, smem, s);
    if (G == 4) return launch<T, 4>(p, smem, s);
    if (G == 8) return launch<T, 8>(p, smem, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// wtab: [L, 21] int64 device pointers (column order of the enum above);
// kv: [L, B / G, H, 2, 64, Tk]; key_start: [B] int64 or null; x: [B, D],
// updated in place to the step's output; kc, vc: [L, B, H, n_ctx, 64],
// written at slot pos; q, att: [B, D] and hid: [B, 4D] scratch; bar: one
// zeroed uint32, then (bf16) the zeroed flags, [ks][N / 16] of the widest
// phase; clock: [8 L + 1] uint64 or null (the start and the end of each
// phase, in ns of the GPU's clock, from block 0).  All of one dtype (but
// the table, key_start, bar and clock), contiguous, 16-byte aligned.
// B <= 16; G in {1, 2, 4, 8}; D = 64 H; Tk % 4 == 0; 1 <= window <= n_ctx;
// pos: one int64 in device memory, the step's slot, read by the kernel (a
// captured launch reads the position of its replay); outside [0, window)
// the launch is no step and writes nothing.
//
// bf16 also takes part, f32 [ks N B] of the widest phase, and the launch
// plan of ops/decoder_layer_fused.py::layer_launch_plan: plan, its int32
// table on the device ([6][2] (ks, kw), then [6][blocks][3] (slice, t0,
// t1)), and on the host the grid (blocks), the weight ring's stages (nst),
// the cross ring's (cst), the staged rows' pitch in bytes (ap, an odd
// multiple of 16) and the dynamic shared memory (smem) it lays out.
extern "C" int decoder_step_bf16(const void* wtab, const void* kv, const void* key_start,
                                 void* x, void* kc, void* vc, void* q, void* att, void* hid,
                                 void* bar, void* clock, void* part, const void* plan, int B,
                                 int D, int H, int L, int G, int Tk, int n_ctx,
                                 const void* pos, int window, float scale, int blocks, int nst,
                                 int cst, int ap, int smem, void* stream) {
    if (!shape_ok(B, D, H, L, G, Tk, n_ctx, pos, window) || D > MAX_D || blocks < 1 ||
        nst < 2 || nst > MAX_NST || cst < 2 || cst > MAX_CST || ap % 32 != 16 || smem < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    unsigned int* counter = static_cast<unsigned int*>(bar);
    const TcStep p{static_cast<const long long*>(wtab), static_cast<const bf16*>(kv),
                   static_cast<const long long*>(key_start), static_cast<const long long*>(pos),
                   static_cast<bf16*>(x), static_cast<bf16*>(kc), static_cast<bf16*>(vc),
                   static_cast<bf16*>(q),
                   static_cast<bf16*>(att), static_cast<bf16*>(hid), static_cast<float*>(part),
                   counter, counter + 1, static_cast<unsigned long long*>(clock),
                   static_cast<const int*>(plan), B, D, H, L, G, Tk, n_ctx, window, scale,
                   nst, cst, ap};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (G == 1) return launch_tc<1>(p, blocks, smem, s);
    if (G == 2) return launch_tc<2>(p, blocks, smem, s);
    if (G == 4) return launch_tc<4>(p, blocks, smem, s);
    if (G == 8) return launch_tc<8>(p, blocks, smem, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int decoder_step_f32(const void* wtab, const void* kv, const void* key_start, void* x,
                                void* kc, void* vc, void* q, void* att, void* hid, void* bar,
                                void* clock, int B, int D, int H, int L, int G, int Tk, int n_ctx,
                                const void* pos, int window, float scale, void* stream) {
    return dispatch<float>(wtab, kv, key_start, x, kc, vc, q, att, hid, bar, clock, B, D, H, L, G,
                           Tk, n_ctx, pos, window, scale, stream);
}
