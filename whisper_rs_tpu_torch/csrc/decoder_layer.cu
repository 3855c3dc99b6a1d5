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
// (14 D^2 elements a layer: 352 M at medium.en, 705 MB in bf16), the cross
// K/V of every layer (L A H 2 64 Tk elements: 1.18 GB at medium.en b8 in
// bf16) and the visible cache window (0.1 GB at W 256), about 2.0 GB: some
// 0.6 ms at the H100 SXM data-sheet 3.35 TB/s (700 W power limit).
// The products, 2 B per weight element, are far below the bf16 peak.
//
// Design: eight phases a layer, each ended by a grid barrier (a counter
// that every block's first thread bumps with a release and polls with an
// acquire; the wrapper zeroes it before each launch):
//   1. every block computes LN1 of all B rows into shared memory (the rows
//      are a few KB, so each block doing it saves a barrier), then one warp
//      per output feature of [Wq; Wk; Wv] streams its weight row once with
//      16-byte loads and keeps the B row sums in registers; K and V go
//      straight into the cache column;
//   2. self-attention, one block per (row, head): slots key_start..pos;
//   3. the out-projection and the residual, one warp per feature;
//   4. LN2 and the cross q;
//   5. cross-attention, one block per (audio, head), its G rows together;
//   6. the cross out-projection and the residual;
//   7. LN3, fc1, bias, GELU into a [B, 4D] scratch;
//   8. fc2 and the residual.
// Every sum is taken in a fixed order, with no atomics, so two runs give
// the same bits.  Data written inside the launch (x, the scratch, the cache
// column) is read with ld.global.cg, past the SM's L1, and staged in shared
// memory where every warp of a block reads it.  Simple first: the products
// run on the FMA pipes; no TMA, no split of the cross keys across blocks.
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
    T* x;                         // [B, D] residual stream, in and out
    T* kc;                        // [L, B, H, n_ctx, 64]
    T* vc;
    T* q;                         // [B, D] scratch: the self q, then the cross q
    T* att;                       // [B, D] scratch: attention outputs
    T* hid;                       // [B, 4D] scratch: the MLP's hidden row
    unsigned int* bar;            // grid barrier counter, 0 at launch
    unsigned long long* clock;    // [8 L + 1] phase-end times in ns, or null
    int B, D, H, L, G, Tk, n_ctx, pos;
    float scale;
};

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

// Four consecutive read-only elements as f32 (16 bytes in f32, 8 in bf16).
__device__ __forceinline__ float4 ld_ro4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld_ro4(const bf16* p) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
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
    const int hi = p.pos;
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
                    const size_t at = (row * p.n_ctx + p.pos) * DH + n % DH;
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

template <typename T>
int dispatch(const void* wtab, const void* kv, const void* key_start, void* x, void* kc, void* vc,
             void* q, void* att, void* hid, void* bar, void* clock, int B, int D, int H, int L,
             int G, int Tk, int n_ctx, int pos, int window, float scale, void* stream) {
    if (B < 1 || B > MAX_ROWS || G < 1 || B % G || D != H * DH || Tk < 4 || Tk % 4 ||
        window < 1 || window > n_ctx || pos < 0 || pos >= window || L < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t rows = (size_t)B * 4 * D * sizeof(T);
    const size_t cross = (size_t)G * Tk * sizeof(float);
    const size_t self = (size_t)n_ctx * sizeof(float);
    const size_t smem = rows > cross ? (rows > self ? rows : self) : (cross > self ? cross : self);
    const Step<T> p{static_cast<const long long*>(wtab), static_cast<const T*>(kv),
                    static_cast<const long long*>(key_start), static_cast<T*>(x),
                    static_cast<T*>(kc), static_cast<T*>(vc), static_cast<T*>(q),
                    static_cast<T*>(att), static_cast<T*>(hid),
                    static_cast<unsigned int*>(bar), static_cast<unsigned long long*>(clock),
                    B, D, H, L, G, Tk, n_ctx, pos, scale};
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
// zeroed uint32; clock: [8 L + 1] uint64 or null (the start and the end of
// each phase, in ns of the GPU's clock, from block 0).  All of one dtype
// (but the table, key_start, bar and clock),
// contiguous, 16-byte aligned.  B <= 16; G in {1, 2, 4, 8}; D = 64 H;
// Tk % 4 == 0; 0 <= pos < window <= n_ctx.
extern "C" int decoder_step_bf16(const void* wtab, const void* kv, const void* key_start,
                                 void* x, void* kc, void* vc, void* q, void* att, void* hid,
                                 void* bar, void* clock, int B, int D, int H, int L, int G,
                                 int Tk, int n_ctx, int pos, int window, float scale,
                                 void* stream) {
    return dispatch<bf16>(wtab, kv, key_start, x, kc, vc, q, att, hid, bar, clock, B, D, H, L, G,
                          Tk, n_ctx, pos, window, scale, stream);
}

extern "C" int decoder_step_f32(const void* wtab, const void* kv, const void* key_start, void* x,
                                void* kc, void* vc, void* q, void* att, void* hid, void* bar,
                                void* clock, int B, int D, int H, int L, int G, int Tk, int n_ctx,
                                int pos, int window, float scale, void* stream) {
    return dispatch<float>(wtab, kv, key_start, x, kc, vc, q, att, hid, bar, clock, B, D, H, L, G,
                           Tk, n_ctx, pos, window, scale, stream);
}
