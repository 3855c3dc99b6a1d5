// One decode step's self-attention for layer l, in five entry points over
// one body:
//
//   append (greedy):  K[l, b, h, pos] = k_new[b, h];  V[l, b, h, pos] = v_new[b, h];
//                     out[b, h] = softmax_j(q[b, h] . K[l, b, h, j]) V[l, b, h, j]
//                     over the slots key_start[b] <= j <= pos of the first W;
//   beam:             the same write, but slot j of row b = a G + g is read
//                     from row r(b, j) = a G + anc[b, j] (the beam-local
//                     ancestor that holds beam b's key at position j), and
//                     the visible slots are key_start[a G] <= j <= pos (the
//                     audio's first row);
//   fused (greedy):   the append step with the write compiled out: the caller
//                     has written slot pos already, and the kernel only reads;
//   step (greedy):    read only, like fused, over a cache in the query dtype
//                     or over an int8 cache with f32 per-position scales
//                     ks, vs [L, B, H, n_ctx]:  s_j = (q . K_j) * ks_j,
//                     w_j = e_j / sum(e) * vs_j (kept in f32), out = sum_j w_j V_j;
//                     over an int8 cache it may take this step's k_new,
//                     v_new (query dtype) and write slot pos itself first,
//                     quantised as quantize_kv does on the card:
//                     s = max(amax |x|, 1e-8) * (1/127) (torch's division by
//                     the constant, a multiply by its f32 reciprocal),
//                     K[l, b, h, pos] = clamp(rint(x / s), -127, 127), ks = s;
//   beam int8:        the beam read over an int8 cache, read only; the
//                     scales of slot j come from the same row r(b, j) as its
//                     K/V row, the ancestor's.
//
// Masked slots are left out, with f32 scores, f32 weights w = e / sum(e)
// (never rounded to the cache dtype) and an f32 sum, cast to the query dtype.
//
// Replaces: whisper_rs_tpu/ops/decode_attention.py::
// self_attention_append_step (kernel body _self_append_kernel),
// beam_self_attention_step (kernel body _beam_self_kernel, both branches),
// self_attention_fused_step (kernel body _self_fused_kernel, the TPU's
// read-only kernel over ctx-major planes, which are this port's layout) and
// self_attention_step (kernel body _self_attn_kernel, both branches; the TPU
// kernel read a transposed K and whole-H scale blocks, after XLA quantised
// and wrote the column around it).  The TPU append
// kernel kept both planes transposed and lane-padded to 512, spliced the
// column into a VMEM copy and wrote back the aligned 128-wide block, with
// DMAs double-buffered across programs.  The TPU beam kernel, which cannot
// gather rows, read all G source beams' blocks and built a G-fold
// all-pairs q.k, then picked each (beam, position)'s ancestor with a
// select; its int8 form picked the scale rows of each source beam by a
// masked reduce.  All of that served Mosaic.  Here the cache stays
// ctx-major [L, B, H, n_ctx, dh]: a key row is dh contiguous elements (128
// bytes in bf16 at dh 64, 64 in int8), so a row of any source beam is one coalesced
// read, and the beam kernels read exactly one K row and one V row (and,
// int8, one scale of each) per (row, head, slot): a gather at read time,
// with no G-fold compute and no copy of the cache.  The layer index is a
// pointer offset, so nothing is sliced per layer.
//
// Bound on the H100: bytes.  Each step must read the visible K and V rows,
// 2 * B * H * (pos - key_start + 1) * 64 elements (15.7 MB at large-v3 b12,
// W = 256, pos = 255, bf16: 4.7 us at the H100 SXM data-sheet 3.35 TB/s,
// 700 W power limit), for 4 FLOP per element pair; an int8 cache halves
// that and adds 8 bytes of scales a slot (35.7 MB at base.en b128, W 256,
// pos 255: 10.6 us); the beam kernels add the ancestor table's 4 bytes per
// visible slot, and the rows of one audio that share an ancestor at a slot
// share its K/V row, which the bound counts once.
//
// Design, one body for every step (attend_window), redesigned for Hopper:
// no chain of round trips and no barrier before the merge.  One block (2 to
// 8 warps, the host's plan: ops/decode_attention.py::step_launch_plan) per
// (head, row).  A lane group reads a key row, 16 bytes a lane (int8: 8, so
// that every lane holds 8 values but f32's 4); lane group g takes the
// visible slots lo + g, lo + g + groups, ..., in batches of UNROLL rows, and
// each batch's K and V reads (int8: and their scales, through the same
// ancestor) go out straight into registers two batches ahead of its scores,
// so a lane group has up to 2 UNROLL rows in flight and no warp waits for
// another.  The beam block first reads its row's ancestors over the window
// into shared memory, in one round beside key_start and q; it then issues
// every gather from there (the beam rows of one audio each read their
// ancestors' rows: an audio's rows in one block, reading each shared row
// once, measured slower on the H100, PERF.md).  The append and beam blocks
// take slot pos from k_new and v_new and write them to the cache; the int8
// step block that writes reads its column in the same round (warp 0 K,
// warp 1 V), quantises it (the amax by shuffles), writes it and the two
// scales to the cache and stages them in shared memory behind one
// barrier, and reads slot pos from the staged copy, dequantised like any
// slot; its first two batches' reads go out before that barrier where they
// do not hold slot pos (the lane group that reads slot pos quantising in
// registers, with no barrier, measured slower on the H100, PERF.md).  No
// writing block reads slot pos from the cache (at slot pos every row's
// ancestor is itself: the decode loop sets that column of the table to the
// identity before the step); the read-only blocks read it from the cache,
// where the caller wrote it.  Each lane group keeps a running f32 max and
// sum (an online softmax): a batch's scores, their max, the rescale of the
// sum and of acc, then e V (int8: e times the slot's V scale, in f32) added
// to acc; no slot is read twice.  The lane groups' parts (max, sum,
// acc[dh]) merge across the warp by shuffles, then across the warps in
// order: no atomics, so a call is bit-identical to the next.  The output is
// acc / sum.
//
// The head dim is a template parameter, instantiated at 64 (every registry
// model) and 16 (the golden test dims); the entry points take dh and refuse
// any other.
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WINDOW = 12 * 1024;  // W ints of the beam's ancestors in 48 KB

// Sixteen bytes of T as floats.
template <typename T> struct Vec16;
template <> struct Vec16<float> { static constexpr int N = 4; };
template <> struct Vec16<bf16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load16(const bf16* p, float (&x)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
    }
}

// A lane's bytes of a cache row, loaded raw, as floats: 16 bytes of f32 or
// bf16; 8 of int8, through the integer pipe (b + 128 as the low mantissa
// bits of 2^23, less 2^23 + 128), not the quarter-rate int-to-float
// conversion.
__device__ __forceinline__ void raw_to_float(const int4 raw, float (&x)[4]) {
    x[0] = __int_as_float(raw.x);
    x[1] = __int_as_float(raw.y);
    x[2] = __int_as_float(raw.z);
    x[3] = __int_as_float(raw.w);
}

__device__ __forceinline__ void raw_to_float(const int4 raw, float (&x)[8]) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void raw_to_float(const int2 raw, float (&x)[8]) {
    const uint32_t w[2] = {(uint32_t)raw.x, (uint32_t)raw.y};
    const float bias = 8388736.f;  // 2^23 + 128
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            x[4 * i + k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) - bias;
    }
}

// N elements of T as floats, in 16-byte loads.
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float (&x)[N]) {
    constexpr int V = Vec16<T>::N;
    static_assert(N % V == 0, "whole 16-byte loads");
#pragma unroll
    for (int i = 0; i < N / V; ++i) {
        float y[V];
        load16(p + i * V, y);
#pragma unroll
        for (int e = 0; e < V; ++e) x[i * V + e] = y[e];
    }
}

constexpr int UNROLL = 4;  // rows of a lane group's batch

// The bytes a lane reads of a cache row: 16, or 8 of int8, so that a lane
// holds 8 values (f32: 4) and a batch stays in registers.
template <typename C>
struct Lane {
    static constexpr int BYTES = std::is_same<C, int8_t>::value ? 8 : 16;
    static constexpr int N = BYTES / sizeof(C);
    using Raw = std::conditional_t<BYTES == 16, int4, int2>;
};

// A lane's batch: its bytes of K and of V of UNROLL rows, raw (int8: and
// the rows' scales).
template <typename C>
struct Batch {
    static constexpr bool INT8 = std::is_same<C, int8_t>::value;
    typename Lane<C>::Raw k[UNROLL], v[UNROLL];
    float ks[INT8 ? UNROLL : 1], vs[INT8 ? UNROLL : 1];
};

// exp(m - mx) for a part whose max is m, 0 for a part with no rows (m -inf).
__device__ __forceinline__ float rescale(float m, float mx) {
    return m == -INFINITY ? 0.f : __expf(m - mx);
}

// The five steps for (head blockIdx.x, row blockIdx.y) at head dim DH (16 or
// 64: a key row is then 1 to 16 lanes' loads).  T: the query, output and
// fresh-column dtype; C: the cache's (T, or int8 with the f32 scales ksc,
// vsc [L, B, H, n_ctx]).  WRITE: this step's column comes in knew and vnew
// and is written here (an int8 cache takes it quantised); without it, knew
// and vnew are unused and slot pos is read from the cache like any other.
// BEAM: anc is the [B, n_ctx] beam-local ancestor table of groups of G rows
// (else every slot from row b, key_start of row b).  Lane group grp of the
// block's ng takes the visible slots lo + grp + t ng, t = 0, 1, ..., in
// batches of UNROLL; each batch's reads go out two batches ahead of its
// scores, straight into registers, so no barrier holds a warp.  A beam
// block first reads its row's ancestors over the window into (dynamic)
// shared memory.  The lane groups' parts merge over the warp by shuffles,
// then over the warps in order.
template <int DH, typename T, typename C, bool WRITE, bool BEAM>
__device__ __forceinline__ void attend_window(
    const T* __restrict__ q, const T* __restrict__ knew, const T* __restrict__ vnew,
    C* __restrict__ kc, C* __restrict__ vc, float* __restrict__ ksc, float* __restrict__ vsc,
    const long long* __restrict__ key_start, const int* __restrict__ anc, int G,
    T* __restrict__ out, int B, int H, int n_ctx, int layer, const long long* __restrict__ pos_at,
    int W) {
    constexpr bool INT8 = std::is_same<C, int8_t>::value;
    constexpr bool QUANT = WRITE && INT8;  // the column quantised here
    static_assert(INT8 || std::is_same<C, T>::value, "a cache in the query dtype, or int8");
    static_assert(!(QUANT && BEAM), "the beam's int8 column is written by the caller");
    constexpr int VEC = Lane<C>::N;   // cache elements a lane reads of a row
    constexpr int LPR = DH / VEC;     // lanes a row
    constexpr int KPW = 32 / LPR;     // lane groups a warp
    using Raw = typename Lane<C>::Raw;
    static_assert(DH % VEC == 0 && 32 % LPR == 0, "whole loads, whole rows a warp");
    extern __shared__ int ancs[];  // [W] (beam)
    __shared__ float wacc[WARPS][DH];
    __shared__ float wm[WARPS], wl[WARPS];
    __shared__ __align__(16) int8_t staged[2][DH];  // the quantised K, V column
    __shared__ float staged_scale[2];

    const int h = blockIdx.x, b = blockIdx.y;
    const int nt = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int ng = nt / LPR;  // lane groups of the block
    const int grp = warp * KPW + lane / LPR, seg = lane % LPR;
    const size_t row = (size_t)b * H + h;
    // the step's slot, read from device memory (a captured step reads the
    // decode loop's own position); one outside [0, W) is no step: the block
    // writes nothing to the cache and zeros to out (the decode loop passes
    // -1 for a step that its termination test has turned off)
    const long long at = __ldg(pos_at);
    if (at < 0 || at >= W) {
        if (tid < DH) out[row * DH + tid] = from_float<T>(0.f);
        return;
    }
    const int pos = static_cast<int>(at);
    const size_t row_stride = (size_t)H * n_ctx * DH;  // between batch rows
    const size_t head = (size_t)layer * B * row_stride + (size_t)h * n_ctx * DH;
    const size_t scale_head = ((size_t)layer * B * H + h) * n_ctx;
    const size_t own = head + (size_t)b * row_stride + (size_t)pos * DH;  // this block's column
    const int first = BEAM ? b / G * G : b;  // the audio's first row (beam)
    // the fresh column as cache elements: knew, vnew (C is T) or the staged
    // int8 column
    const C* kn = QUANT ? reinterpret_cast<const C*>(staged[0])
                        : WRITE ? reinterpret_cast<const C*>(knew) + row * DH : nullptr;
    const C* vn = QUANT ? reinterpret_cast<const C*>(staged[1])
                        : WRITE ? reinterpret_cast<const C*>(vnew) + row * DH : nullptr;

    // one round: key_start, q, the ancestors (beam) or this step's column
    // (int8 write: warp 0 reads K, warp 1 V, each lane DH / 32 values; at
    // DH 16, lanes 0..15 one)
    constexpr int PER = (DH + 31) / 32;
    const long long ks = key_start ? key_start[first] : 0;
    float qx[VEC], xq[PER];
    load_n(q + row * DH + seg * VEC, qx);
    if constexpr (QUANT) {
        if (warp < 2) {
            const T* x = (warp ? vnew : knew) + row * DH;
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const int e = lane + 32 * i;
                xq[i] = e < DH ? to_float(x[e]) : 0.f;
            }
        }
    }
    if (BEAM) {
        for (int j = tid; j < W; j += nt) ancs[j] = anc[(size_t)b * n_ctx + j];
        __syncthreads();
    }

    int lo = ks > 0 ? (ks > pos ? pos + 1 : (int)ks) : 0;
    int hi = pos;
    // every slot masked (key_start past pos): all scores are NEG, so the
    // softmax is uniform over the W slots, as in the plain version; no K is read
    const bool empty = lo > hi;
    if (empty) {
        lo = 0;
        hi = W - 1;
    }
    const int n = hi - lo + 1;

    // this block's own column, read by no block of this launch
    if (WRITE && !QUANT && tid < DH) {
        kc[own + tid] = kn[tid];
        vc[own + tid] = vn[tid];
    }

    // the batch of rows t0, .. of this lane group (slot pos from the fresh
    // column: knew, vnew in device memory or the int8 one staged in shared
    // memory; a row past the window reads its last, weighted 0)
    auto load = [&](int t0, Batch<C>& bt) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int j = lo + min(grp + (t0 + u) * ng, n - 1);
            const size_t r = BEAM ? first + ancs[j] : b;
            const size_t at = head + r * row_stride + (size_t)j * DH + seg * VEC;
            const bool fresh = WRITE && j == pos;
            const Raw* kp = reinterpret_cast<const Raw*>(fresh ? kn + seg * VEC : kc + at);
            const Raw* vp = reinterpret_cast<const Raw*>(fresh ? vn + seg * VEC : vc + at);
            bt.k[u] = empty ? Raw{} : QUANT && fresh ? *kp : __ldcg(kp);
            bt.v[u] = QUANT && fresh ? *vp : __ldcg(vp);
            if (INT8) {
                const size_t sat = scale_head + r * H * n_ctx + j;
                bt.ks[u] = empty ? 0.f : QUANT && fresh ? staged_scale[0] : __ldcg(ksc + sat);
                bt.vs[u] = QUANT && fresh ? staged_scale[1] : __ldcg(vsc + sat);
            }
        }
    };

    // rows a lane group, the same for every lane (the shuffles need them all)
    const int rows = (n + ng - 1) / ng;
    Batch<C> b0, b1;
    // an int8 write reads slot pos from the staged column, behind the
    // barrier; the first two batches go out before it where they do not hold
    // slot pos (its index among the slots read is pos - lo; the same for
    // every thread, so all or none wait)
    const bool early = !QUANT || (pos - lo) / ng >= 2 * UNROLL;
    if (early) {
        load(0, b0);
        if (rows > UNROLL) load(UNROLL, b1);
    }
    if constexpr (QUANT) {
        // warp 0 quantises K, warp 1 V, the amax by shuffles; written to the
        // cache and staged for the reads of slot pos
        if (warp < 2) {
            float amax = 0.f;
#pragma unroll
            for (int i = 0; i < PER; ++i) amax = fmaxf(amax, fabsf(xq[i]));
            amax = warp_max(amax);
            // quantize_kv's scale as torch computes it on the card
            const float s = fmaxf(amax, 1e-8f) * (1.f / 127.f);
            C* cache = warp ? vc : kc;
#pragma unroll
            for (int i = 0; i < PER; ++i) {
                const int e = lane + 32 * i;
                if (e < DH) {
                    const float r = fminf(fmaxf(rintf(__fdiv_rn(xq[i], s)), -127.f), 127.f);
                    const C v = static_cast<C>(static_cast<int>(r));
                    staged[warp][e] = v;
                    cache[own + e] = v;
                }
            }
            if (lane == 0) {
                staged_scale[warp] = s;
                (warp ? vsc : ksc)[scale_head + (size_t)b * H * n_ctx + pos] = s;
            }
        }
        __syncthreads();
        if (!early) {
            load(0, b0);
            if (rows > UNROLL) load(UNROLL, b1);
        }
    }

    // this lane group's running max, sum and f32 sum of e V
    float m = -INFINITY, l = 0.f, acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    // the scores of a batch and its rows' e V, with the rescale
    auto consume = [&](int t0, const Batch<C>& bt) {
        float s[UNROLL];
        bool valid[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            valid[u] = grp + (t0 + u) * ng < n;
            float kx[VEC];
            raw_to_float(bt.k[u], kx);
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < VEC; ++e) part = fmaf(qx[e], kx[e], part);
            s[u] = part;
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
        }
        float mn = m;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            s[u] = !valid[u] ? -INFINITY : empty ? 0.f : INT8 ? s[u] * bt.ks[u] : s[u];
            mn = fmaxf(mn, s[u]);
        }
        const float a = m == mn ? 1.f : __expf(m - mn);  // the rescale
        l *= a;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] *= a;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const float ex = valid[u] ? __expf(s[u] - mn) : 0.f;
            l += ex;
            const float w = INT8 ? ex * bt.vs[u] : ex;
            float vx[VEC];
            raw_to_float(bt.v[u], vx);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = fmaf(w, vx[e], acc[e]);
        }
        m = mn;
    };
    for (int t0 = 0; t0 < rows; t0 += 2 * UNROLL) {
        consume(t0, b0);
        if (t0 + 2 * UNROLL < rows) load(t0 + 2 * UNROLL, b0);
        if (t0 + UNROLL < rows) {
            consume(t0 + UNROLL, b1);
            if (t0 + 3 * UNROLL < rows) load(t0 + 3 * UNROLL, b1);
        }
    }

    // the lane groups of the warp: their max, then each part rescaled to it
    // and summed
    float mx = m;
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float f = rescale(m, mx);
    l *= f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= f;
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
        l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (lane < LPR) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) wacc[warp][seg * VEC + e] = acc[e];
        if (lane == 0) {
            wm[warp] = mx;
            wl[warp] = l;
        }
    }
    __syncthreads();
    // the warps in order
    if (tid < DH) {
        float bm = -INFINITY, bl = 0.f, ba = 0.f;
        for (int w = 0; w < nt / 32; ++w) bm = fmaxf(bm, wm[w]);
        for (int w = 0; w < nt / 32; ++w) {
            const float fw = rescale(wm[w], bm);
            bl += wl[w] * fw;
            ba += wacc[w][tid] * fw;
        }
        out[row * DH + tid] = from_float<T>(ba / bl);
    }
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
self_append_kernel(const T* __restrict__ q, const T* __restrict__ knew,
                   const T* __restrict__ vnew, T* __restrict__ kc, T* __restrict__ vc,
                   const long long* __restrict__ key_start, T* __restrict__ out,
                   int B, int H, int n_ctx, int layer, const long long* __restrict__ pos,
                   int W) {
    attend_window<DH, T, T, true, false>(q, knew, vnew, kc, vc, nullptr, nullptr, key_start,
                                         nullptr, 1, out, B, H, n_ctx, layer, pos, W);
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
beam_self_kernel(const T* __restrict__ q, const T* __restrict__ knew,
                 const T* __restrict__ vnew, T* __restrict__ kc, T* __restrict__ vc,
                 const long long* __restrict__ key_start, const int* __restrict__ anc, int G,
                 T* __restrict__ out, int B, int H, int n_ctx, int layer,
                 const long long* __restrict__ pos, int W) {
    attend_window<DH, T, T, true, true>(q, knew, vnew, kc, vc, nullptr, nullptr, key_start, anc,
                                        G, out, B, H, n_ctx, layer, pos, W);
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
beam_self_int8_kernel(const T* __restrict__ q, int8_t* __restrict__ kc,
                      int8_t* __restrict__ vc, float* __restrict__ ksc,
                      float* __restrict__ vsc, const long long* __restrict__ key_start,
                      const int* __restrict__ anc, int G, T* __restrict__ out, int B, int H,
                      int n_ctx, int layer, const long long* __restrict__ pos, int W) {
    attend_window<DH, T, int8_t, false, true>(q, nullptr, nullptr, kc, vc, ksc, vsc, key_start,
                                              anc, G, out, B, H, n_ctx, layer, pos, W);
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
self_fused_kernel(const T* __restrict__ q, T* __restrict__ kc, T* __restrict__ vc,
                  const long long* __restrict__ key_start, T* __restrict__ out, int B, int H,
                  int n_ctx, int layer, const long long* __restrict__ pos, int W) {
    attend_window<DH, T, T, false, false>(q, nullptr, nullptr, kc, vc, nullptr, nullptr,
                                          key_start, nullptr, 1, out, B, H, n_ctx, layer, pos, W);
}

// C: T (read only) or int8 (WRITE: the column quantised and written first)
template <int DH, typename T, typename C, bool WRITE>
__global__ void __launch_bounds__(THREADS)
self_step_kernel(const T* __restrict__ q, const T* __restrict__ knew,
                 const T* __restrict__ vnew, C* __restrict__ kc, C* __restrict__ vc,
                 float* __restrict__ ksc, float* __restrict__ vsc,
                 const long long* __restrict__ key_start, T* __restrict__ out, int B, int H,
                 int n_ctx, int layer, const long long* __restrict__ pos, int W) {
    attend_window<DH, T, C, WRITE, false>(q, knew, vnew, kc, vc, ksc, vsc, key_start, nullptr, 1,
                                          out, B, H, n_ctx, layer, pos, W);
}

// Call f with the head dim as a compile-time constant: the instances are
// 16 and 64, and any other dh is refused.
template <typename F>
int by_head_dim(int dh, F&& f) {
    if (dh == 64) return f(std::integral_constant<int, 64>{});
    if (dh == 16) return f(std::integral_constant<int, 16>{});
    return static_cast<int>(cudaErrorInvalidValue);
}

// Launch a step kernel on the grid (H, B) with `threads` a block (the plan
// of ops/decode_attention.py::step_launch_plan: 64..THREADS, whole warps)
// and, for the beam, W ints of dynamic shared memory, after checking
// 1 <= W <= min(n_ctx, MAX_WINDOW), that pos is given and that B is whole
// groups of G (the kernel checks the value of pos: 0 <= pos < W).
template <typename... Params, typename... Args>
int launch_window(void (*kernel)(Params...), bool beam, int B, int H, int n_ctx, const void* pos,
                  int window, int G, int threads, void* stream, Args... args) {
    if (window < 1 || window > MAX_WINDOW || window > n_ctx || pos == nullptr ||
        G < 1 || B % G || threads < 64 || threads > THREADS || threads % 32)
        return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<dim3(H, B), threads, beam ? (size_t)window * sizeof(int) : 0,
             static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int append(const void* q, const void* knew, const void* vnew, void* kc, void* vc,
           const void* key_start, void* out, int B, int H, int n_ctx, int layer, const void* pos,
           int window, int dh, int threads, void* stream) {
    return by_head_dim(dh, [&](auto D) {
        return launch_window(self_append_kernel<decltype(D)::value, T>, false, B, H, n_ctx, pos,
                             window, 1, threads, stream, static_cast<const T*>(q),
                             static_cast<const T*>(knew), static_cast<const T*>(vnew),
                             static_cast<T*>(kc), static_cast<T*>(vc),
                             static_cast<const long long*>(key_start), static_cast<T*>(out), B,
                             H, n_ctx, layer, static_cast<const long long*>(pos), window);
    });
}

template <typename T>
int beam(const void* q, const void* knew, const void* vnew, void* kc, void* vc,
         const void* key_start, const void* anc, int G, void* out, int B, int H, int n_ctx,
         int layer, const void* pos, int window, int dh, int threads, void* stream) {
    return by_head_dim(dh, [&](auto D) {
        return launch_window(beam_self_kernel<decltype(D)::value, T>, true, B, H, n_ctx, pos,
                             window, G, threads, stream, static_cast<const T*>(q),
                             static_cast<const T*>(knew), static_cast<const T*>(vnew),
                             static_cast<T*>(kc), static_cast<T*>(vc),
                             static_cast<const long long*>(key_start),
                             static_cast<const int*>(anc), G, static_cast<T*>(out), B, H, n_ctx,
                             layer, static_cast<const long long*>(pos), window);
    });
}

template <typename T>
int fused(const void* q, void* kc, void* vc, const void* key_start, void* out, int B, int H,
          int n_ctx, int layer, const void* pos, int window, int dh, int threads, void* stream) {
    return by_head_dim(dh, [&](auto D) {
        return launch_window(self_fused_kernel<decltype(D)::value, T>, false, B, H, n_ctx, pos,
                             window, 1, threads, stream, static_cast<const T*>(q),
                             static_cast<T*>(kc), static_cast<T*>(vc),
                             static_cast<const long long*>(key_start), static_cast<T*>(out), B,
                             H, n_ctx, layer, static_cast<const long long*>(pos), window);
    });
}

template <typename T>
int step(const void* q, const void* knew, const void* vnew, void* kc, void* vc, void* ksc,
         void* vsc, const void* key_start, void* out, int B, int H, int n_ctx, int layer,
         const void* pos, int window, int dh, int threads, void* stream) {
    // scales go with an int8 cache, and a fresh column (both halves) only there
    if (!ksc != !vsc || !knew != !vnew || (knew && !ksc))
        return static_cast<int>(cudaErrorInvalidValue);
    return by_head_dim(dh, [&](auto D) {
        constexpr int DH = decltype(D)::value;
        const T* qt = static_cast<const T*>(q);
        const T* kn = static_cast<const T*>(knew);
        const T* vn = static_cast<const T*>(vnew);
        float* kst = static_cast<float*>(ksc);
        float* vst = static_cast<float*>(vsc);
        const long long* start = static_cast<const long long*>(key_start);
        T* o = static_cast<T*>(out);
        if (!ksc)
            return launch_window(self_step_kernel<DH, T, T, false>, false, B, H, n_ctx, pos,
                                 window, 1, threads, stream, qt, kn, vn, static_cast<T*>(kc),
                                 static_cast<T*>(vc), kst, vst, start, o, B, H, n_ctx, layer,
                                 static_cast<const long long*>(pos), window);
        return launch_window(knew ? &self_step_kernel<DH, T, int8_t, true>
                                  : &self_step_kernel<DH, T, int8_t, false>,
                             false, B, H, n_ctx, pos, window, 1, threads, stream, qt, kn, vn,
                             static_cast<int8_t*>(kc), static_cast<int8_t*>(vc), kst, vst, start,
                             o, B, H, n_ctx, layer, static_cast<const long long*>(pos), window);
    });
}

template <typename T>
int beam_int8(const void* q, void* kc, void* vc, void* ksc, void* vsc, const void* key_start,
              const void* anc, int G, void* out, int B, int H, int n_ctx, int layer,
              const void* pos, int window, int dh, int threads, void* stream) {
    return by_head_dim(dh, [&](auto D) {
        return launch_window(beam_self_int8_kernel<decltype(D)::value, T>, true, B, H, n_ctx,
                             pos, window, G, threads, stream, static_cast<const T*>(q),
                             static_cast<int8_t*>(kc), static_cast<int8_t*>(vc),
                             static_cast<float*>(ksc), static_cast<float*>(vsc),
                             static_cast<const long long*>(key_start),
                             static_cast<const int*>(anc), G, static_cast<T*>(out), B, H, n_ctx,
                             layer, static_cast<const long long*>(pos), window);
    });
}

}  // namespace

// q, knew, vnew, out: [B, H, dh]; kc, vc: [L, B, H, n_ctx, dh]; dh 16 or 64;
// key_start: [B] int64 or null (zeros); all contiguous and 16-byte aligned;
// the caches are written at slot pos of layer in place.  pos: one int64 in
// device memory, read by the kernel (so that a captured launch reads the
// position of its replay); 1 <= window <= n_ctx, and a pos outside
// [0, window) makes the launch write only zeros to out.  threads: a block's, the launch plan of
// ops/decode_attention.py::step_launch_plan (64..256, whole warps; any other
// is refused).
extern "C" int self_attention_append_bf16(const void* q, const void* knew, const void* vnew,
                                          void* kc, void* vc, const void* key_start, void* out,
                                          int B, int H, int n_ctx, int layer, const void* pos,
                                          int window, int dh, int threads, void* stream) {
    return append<bf16>(q, knew, vnew, kc, vc, key_start, out, B, H, n_ctx, layer, pos, window,
                        dh, threads, stream);
}

extern "C" int self_attention_append_f32(const void* q, const void* knew, const void* vnew,
                                         void* kc, void* vc, const void* key_start, void* out,
                                         int B, int H, int n_ctx, int layer, const void* pos,
                                         int window, int dh, int threads, void* stream) {
    return append<float>(q, knew, vnew, kc, vc, key_start, out, B, H, n_ctx, layer, pos, window,
                         dh, threads, stream);
}

// As the append entry points, plus anc: [B, n_ctx] int32, beam-local
// ancestors in [0, G) with anc[b, pos] == b % G; B a multiple of G.
extern "C" int beam_self_attention_bf16(const void* q, const void* knew, const void* vnew,
                                        void* kc, void* vc, const void* key_start,
                                        const void* anc, int G, void* out, int B, int H,
                                        int n_ctx, int layer, const void* pos, int window,
                                        int dh, int threads, void* stream) {
    return beam<bf16>(q, knew, vnew, kc, vc, key_start, anc, G, out, B, H, n_ctx, layer, pos,
                      window, dh, threads, stream);
}

extern "C" int beam_self_attention_f32(const void* q, const void* knew, const void* vnew,
                                       void* kc, void* vc, const void* key_start,
                                       const void* anc, int G, void* out, int B, int H,
                                       int n_ctx, int layer, const void* pos, int window,
                                       int dh, int threads, void* stream) {
    return beam<float>(q, knew, vnew, kc, vc, key_start, anc, G, out, B, H, n_ctx, layer, pos,
                       window, dh, threads, stream);
}

// The append entry points without k_new/v_new: slot pos of both caches was
// written by the caller; the kernel reads slots key_start[b] <= j <= pos
// and writes nothing but out.
extern "C" int self_attention_fused_bf16(const void* q, void* kc, void* vc,
                                         const void* key_start, void* out, int B, int H,
                                         int n_ctx, int layer, const void* pos, int window,
                                         int dh, int threads, void* stream) {
    return fused<bf16>(q, kc, vc, key_start, out, B, H, n_ctx, layer, pos, window, dh, threads,
                       stream);
}

extern "C" int self_attention_fused_f32(const void* q, void* kc, void* vc, const void* key_start,
                                        void* out, int B, int H, int n_ctx, int layer,
                                        const void* pos, int window, int dh, int threads,
                                        void* stream) {
    return fused<float>(q, kc, vc, key_start, out, B, H, n_ctx, layer, pos, window, dh, threads,
                        stream);
}

// As the fused entry points, over a cache in q's dtype (ksc, vsc, knew,
// vnew null) or an int8 cache with f32 scales ksc, vsc [L, B, H, n_ctx]
// (contiguous).  Over the int8 cache, knew and vnew [B, H, dh] in q's dtype
// (both or neither) are quantised and written with their scales at slot
// pos, then read; null, the caller has written slot pos and its scales.
extern "C" int self_attention_step_bf16(const void* q, const void* knew, const void* vnew,
                                        void* kc, void* vc, void* ksc, void* vsc,
                                        const void* key_start, void* out, int B, int H,
                                        int n_ctx, int layer, const void* pos, int window,
                                        int dh, int threads, void* stream) {
    return step<bf16>(q, knew, vnew, kc, vc, ksc, vsc, key_start, out, B, H, n_ctx, layer, pos,
                      window, dh, threads, stream);
}

extern "C" int self_attention_step_f32(const void* q, const void* knew, const void* vnew,
                                       void* kc, void* vc, void* ksc, void* vsc,
                                       const void* key_start, void* out, int B, int H,
                                       int n_ctx, int layer, const void* pos, int window,
                                       int dh, int threads, void* stream) {
    return step<float>(q, knew, vnew, kc, vc, ksc, vsc, key_start, out, B, H, n_ctx, layer, pos,
                       window, dh, threads, stream);
}

// The beam entry points over an int8 cache with f32 scales ksc, vsc
// [L, B, H, n_ctx], read only: the caller wrote slot pos and its scales.
extern "C" int beam_self_attention_int8_bf16(const void* q, void* kc, void* vc, void* ksc,
                                             void* vsc, const void* key_start, const void* anc,
                                             int G, void* out, int B, int H, int n_ctx,
                                             int layer, const void* pos, int window, int dh,
                                             int threads, void* stream) {
    return beam_int8<bf16>(q, kc, vc, ksc, vsc, key_start, anc, G, out, B, H, n_ctx, layer, pos,
                           window, dh, threads, stream);
}

extern "C" int beam_self_attention_int8_f32(const void* q, void* kc, void* vc, void* ksc,
                                            void* vsc, const void* key_start, const void* anc,
                                            int G, void* out, int B, int H, int n_ctx, int layer,
                                            const void* pos, int window, int dh, int threads,
                                            void* stream) {
    return beam_int8<float>(q, kc, vc, ksc, vsc, key_start, anc, G, out, B, H, n_ctx, layer, pos,
                            window, dh, threads, stream);
}
