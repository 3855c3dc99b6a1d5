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
// kernel read a transposed K and whole-H scale blocks).  The TPU append
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
// Design of the read-only greedy steps (fused, step: attend_step): one
// block of 8 warps per (head, row), which reads slots lo..pos of the cache.
// Only slots lo..pos are read: masked slots have weight exactly 0 in f32
// (exp of NEG - max underflows), so skipping them changes nothing.  A group
// of lanes reads one key row with 16-byte loads (at dh 64: 4 lanes in int8,
// 8 in bf16, 16 in f32; at dh 16 a quarter of that, so a warp takes 4 times
// the rows); the scores go to shared memory, the block takes max and sum,
// and the same lane groups then walk V with the weights, reduced across
// groups and warps in a fixed order (deterministic, no atomics).  Two
// passes over the rows, each a chain of dependent round trips.
//
// Design of the append and beam steps (attend_window), redesigned for
// Hopper: no chain of round trips and no barrier before the merge.  One
// block (2 to 8 warps, the host's plan: ops/decode_attention.py::
// step_launch_plan) per (head, row).  A lane group reads a key row, 16
// bytes a lane (int8: 8, so that every lane holds 8 values but f32's 4);
// lane group g takes the visible slots lo + g, lo + g + groups, ..., in
// batches of UNROLL rows, and each batch's K and V reads (int8: and their
// scales, through the same ancestor) go out straight into registers two
// batches ahead of its scores, so a lane group has up to 2 UNROLL rows in
// flight and no warp waits for another.  The beam block first reads its
// row's ancestors over the window into shared memory, in one round beside
// key_start and q; it then issues every gather from there (the beam rows of
// one audio each read their ancestors' rows: an audio's rows in one block,
// reading each shared row once, measured slower on the H100, PERF.md).  The
// append and beam blocks take slot pos from k_new and v_new and write them
// to the cache; no block reads slot pos from the cache (at slot pos every
// row's ancestor is itself: the decode loop sets that column of the table
// to the identity before the step).  Each lane group keeps a running f32
// max and sum (an online softmax): a batch's scores, their max, the
// rescale of the sum and of acc, then e V (int8: e times the slot's V
// scale, in f32) added to acc; no slot is read twice.  The lane groups'
// parts (max, sum, acc[dh]) merge across the warp by shuffles, then across
// the warps in order: no atomics, so a call is bit-identical to the next.
// The output is acc / sum.
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
constexpr int MAX_WINDOW = 12 * 1024;  // W floats of scores in 48 KB

// Sixteen bytes of T as floats.
template <typename T> struct Vec16;
template <> struct Vec16<float> { static constexpr int N = 4; };
template <> struct Vec16<bf16> { static constexpr int N = 8; };
template <> struct Vec16<int8_t> { static constexpr int N = 16; };

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

__device__ __forceinline__ void load16(const int8_t* p, float (&x)[16]) {
    const int4 raw = *reinterpret_cast<const int4*>(p);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = static_cast<float>(v[i]);
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

// The body of the five kernels for block (h, b), at head dim DH (16 or 64:
// a key row is then 1 to 16 lanes' 16-byte loads).  T: the query, output and
// fresh-column dtype; C: the cache's (T, or int8 with the f32 scales ksc,
// vsc [L, B, H, n_ctx]).  anc: null for the greedy kernels (every slot from
// row b, key_start of row b); else the [B, n_ctx] beam-local ancestor table
// of groups of G rows.  WRITE (C == T): this step's column comes in knew
// and vnew and is written here; without it, knew and vnew are unused and
// slot pos is read from the cache like any other.
template <int DH, typename T, typename C, bool WRITE>
__device__ __forceinline__ void attend_step(
    const T* __restrict__ q, const T* __restrict__ knew, const T* __restrict__ vnew,
    C* __restrict__ kc, C* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const long long* __restrict__ key_start,
    const int* __restrict__ anc, int G, T* __restrict__ out, int B, int H, int n_ctx,
    int layer, int pos, int W, float* ws) {
    constexpr bool INT8 = std::is_same<C, int8_t>::value;
    static_assert(!WRITE || std::is_same<C, T>::value, "the column is written in the cache dtype");
    constexpr int VEC = Vec16<C>::N;  // cache elements per 16-byte load
    constexpr int LPR = DH / VEC;     // lanes per key row, at DH 64: 4 (int8), 8 (bf16) or 16 (f32)
    constexpr int KPW = 32 / LPR;     // key rows per warp pass, at DH 64: 8, 4 or 2
    static_assert(DH % VEC == 0 && 32 % LPR == 0, "whole 16-byte loads, whole rows a warp");
    constexpr int STRIDE = WARPS * KPW;
    __shared__ float red[WARPS][DH];
    __shared__ float stat[WARPS];

    const int h = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = lane / LPR, seg = lane % LPR;
    const size_t row = (size_t)b * H + h;
    const size_t row_stride = (size_t)H * n_ctx * DH;  // between batch rows
    const size_t head = (size_t)layer * B * row_stride + (size_t)h * n_ctx * DH;
    const size_t scale_head = ((size_t)layer * B * H + h) * n_ctx;  // the same, over scales
    const int first = anc ? (b / G) * G : b;  // the audio's first row (beam)
    // with WRITE, C is T: the fresh column as cache elements
    const C* kn = WRITE ? reinterpret_cast<const C*>(knew) + row * DH : nullptr;
    const C* vn = WRITE ? reinterpret_cast<const C*>(vnew) + row * DH : nullptr;

    // the cache row that holds slot j of this block's row, its K/V and scales
    auto src = [&](int j) -> size_t { return anc ? first + anc[(size_t)b * n_ctx + j] : b; };
    auto slot = [&](const C* c, int j) -> const C* {
        return c + head + src(j) * row_stride + (size_t)j * DH;
    };
    auto scale = [&](const float* s, int j) -> float {
        return s[scale_head + src(j) * H * n_ctx + j];
    };

    // this block's own column, read by no other block
    if (WRITE && tid < DH) {
        kc[head + (size_t)b * row_stride + (size_t)pos * DH + tid] = kn[tid];
        vc[head + (size_t)b * row_stride + (size_t)pos * DH + tid] = vn[tid];
    }

    const long long ks = key_start ? key_start[first] : 0;
    int lo = ks > 0 ? (ks > pos ? pos + 1 : (int)ks) : 0;
    int hi = pos;
    // every slot masked (key_start past pos): all scores are NEG, so the
    // softmax is uniform over the W slots, as in the plain version
    const bool empty = lo > hi;
    if (empty) {
        lo = 0;
        hi = W - 1;
    }
    const int n = hi - lo + 1;

    float qx[VEC];
    load_n(q + row * DH + seg * VEC, qx);

    // scores of slots lo..hi; lane group grp takes row j, lane seg its
    // VEC elements
    float lmax = -INFINITY;
    for (int j0 = lo + warp * KPW; j0 <= hi; j0 += STRIDE) {
        const int j = j0 + grp;
        float part = 0.f;
        if (j <= hi && !empty) {
            float kx[VEC];
            load16((WRITE && j == pos ? kn : slot(kc, j)) + seg * VEC, kx);
#pragma unroll
            for (int e = 0; e < VEC; ++e) part = fmaf(qx[e], kx[e], part);
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        if (j <= hi) {
            if (INT8 && !empty) part *= scale(ksc, j);
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
    for (int i = tid; i < n; i += THREADS) ws[i] = ws[i] / total;
    __syncthreads();

    // out = sum_j w_j V_j in f32 (int8: w_j times the slot's V scale, kept
    // in f32), same row walk as the scores
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int j0 = lo + warp * KPW; j0 <= hi; j0 += STRIDE) {
        const int j = j0 + grp;
        if (j <= hi) {
            float wj = ws[j - lo];
            if (INT8) wj *= scale(vsc, j);
            float vx[VEC];
            load16((WRITE && j == pos ? vn : slot(vc, j)) + seg * VEC, vx);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wj, vx[e], acc[e]);
        }
    }
    // across the KPW row groups of the warp, then across warps
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
        out[row * DH + tid] = from_float<T>(s);
    }
}

// ---- the append and beam steps: attend_window -----------------------------

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

// The append and beam steps for (head blockIdx.x, row blockIdx.y) at head
// dim DH.  T, C, anc, G, WRITE as for attend_step (int8 C only read-only).
// Lane group grp of the block's ng takes the visible slots lo + grp + t ng,
// t = 0, 1, ..., in batches of UNROLL; each batch's reads go out two
// batches ahead of its scores, straight into registers, so no barrier
// holds a warp.  A beam block first reads its row's ancestors over the
// window into (dynamic) shared memory.  The lane groups' parts merge over
// the warp by shuffles, then over the warps in order.
template <int DH, typename T, typename C, bool WRITE, bool BEAM>
__device__ __forceinline__ void attend_window(
    const T* __restrict__ q, const T* __restrict__ knew, const T* __restrict__ vnew,
    C* __restrict__ kc, C* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const long long* __restrict__ key_start,
    const int* __restrict__ anc, int G, T* __restrict__ out, int B, int H, int n_ctx,
    int layer, int pos, int W) {
    constexpr bool INT8 = std::is_same<C, int8_t>::value;
    static_assert(!WRITE || std::is_same<C, T>::value, "the column is written in the cache dtype");
    constexpr int VEC = Lane<C>::N;   // cache elements a lane reads of a row
    constexpr int LPR = DH / VEC;     // lanes a row
    constexpr int KPW = 32 / LPR;     // lane groups a warp
    using Raw = typename Lane<C>::Raw;
    static_assert(DH % VEC == 0 && 32 % LPR == 0, "whole loads, whole rows a warp");
    extern __shared__ int ancs[];  // [W] (beam)
    __shared__ float wacc[WARPS][DH];
    __shared__ float wm[WARPS], wl[WARPS];

    const int h = blockIdx.x, b = blockIdx.y;
    const int nt = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int ng = nt / LPR;  // lane groups of the block
    const int grp = warp * KPW + lane / LPR, seg = lane % LPR;
    const size_t row = (size_t)b * H + h;
    const size_t row_stride = (size_t)H * n_ctx * DH;  // between batch rows
    const size_t head = (size_t)layer * B * row_stride + (size_t)h * n_ctx * DH;
    const size_t scale_head = ((size_t)layer * B * H + h) * n_ctx;
    const int first = BEAM ? b / G * G : b;  // the audio's first row (beam)
    const C* kn = WRITE ? reinterpret_cast<const C*>(knew) + row * DH : nullptr;
    const C* vn = WRITE ? reinterpret_cast<const C*>(vnew) + row * DH : nullptr;

    // one round: key_start, q, the ancestors
    const long long ks = key_start ? key_start[first] : 0;
    float qx[VEC];
    load_n(q + row * DH + seg * VEC, qx);
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
    if (WRITE && tid < DH) {
        kc[head + (size_t)b * row_stride + (size_t)pos * DH + tid] = kn[tid];
        vc[head + (size_t)b * row_stride + (size_t)pos * DH + tid] = vn[tid];
    }

    // the batch of rows t0, .. of this lane group (slot pos from the fresh
    // column; a row past the window reads its last, weighted 0)
    auto load = [&](int t0, Batch<C>& bt) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int j = lo + min(grp + (t0 + u) * ng, n - 1);
            const size_t r = BEAM ? first + ancs[j] : b;
            const size_t at = head + r * row_stride + (size_t)j * DH + seg * VEC;
            const bool fresh = WRITE && j == pos;
            bt.k[u] = empty ? Raw{} : __ldcg(reinterpret_cast<const Raw*>(fresh ? kn + seg * VEC
                                                                             : kc + at));
            bt.v[u] = __ldcg(reinterpret_cast<const Raw*>(fresh ? vn + seg * VEC : vc + at));
            if (INT8) {
                const size_t sat = scale_head + r * H * n_ctx + j;
                bt.ks[u] = empty ? 0.f : __ldcg(ksc + sat);
                bt.vs[u] = __ldcg(vsc + sat);
            }
        }
    };

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
    // rows a lane group, the same for every lane (the shuffles need them all)
    const int rows = (n + ng - 1) / ng;
    Batch<C> b0, b1;
    load(0, b0);
    if (rows > UNROLL) load(UNROLL, b1);
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
                   int B, int H, int n_ctx, int layer, int pos, int W) {
    attend_window<DH, T, T, true, false>(q, knew, vnew, kc, vc, nullptr, nullptr, key_start,
                                         nullptr, 1, out, B, H, n_ctx, layer, pos, W);
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
beam_self_kernel(const T* __restrict__ q, const T* __restrict__ knew,
                 const T* __restrict__ vnew, T* __restrict__ kc, T* __restrict__ vc,
                 const long long* __restrict__ key_start, const int* __restrict__ anc, int G,
                 T* __restrict__ out, int B, int H, int n_ctx, int layer, int pos, int W) {
    attend_window<DH, T, T, true, true>(q, knew, vnew, kc, vc, nullptr, nullptr, key_start, anc,
                                        G, out, B, H, n_ctx, layer, pos, W);
}

template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
beam_self_int8_kernel(const T* __restrict__ q, int8_t* __restrict__ kc,
                      int8_t* __restrict__ vc, const float* __restrict__ ksc,
                      const float* __restrict__ vsc, const long long* __restrict__ key_start,
                      const int* __restrict__ anc, int G, T* __restrict__ out, int B, int H,
                      int n_ctx, int layer, int pos, int W) {
    attend_window<DH, T, int8_t, false, true>(q, nullptr, nullptr, kc, vc, ksc, vsc, key_start,
                                              anc, G, out, B, H, n_ctx, layer, pos, W);
}

// ---- the read-only greedy steps: attend_step --------------------------------

// ws: [n] scores, then weights, of slots lo..hi, in dynamic shared memory
template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
self_fused_kernel(const T* __restrict__ q, T* __restrict__ kc, T* __restrict__ vc,
                  const long long* __restrict__ key_start, T* __restrict__ out, int B, int H,
                  int n_ctx, int layer, int pos, int W) {
    extern __shared__ float ws[];
    attend_step<DH, T, T, false>(q, nullptr, nullptr, kc, vc, nullptr, nullptr, key_start, nullptr,
                             1, out, B, H, n_ctx, layer, pos, W, ws);
}

template <int DH, typename T, typename C>
__global__ void __launch_bounds__(THREADS)
self_step_kernel(const T* __restrict__ q, C* __restrict__ kc, C* __restrict__ vc,
                 const float* __restrict__ ksc, const float* __restrict__ vsc,
                 const long long* __restrict__ key_start, T* __restrict__ out, int B, int H,
                 int n_ctx, int layer, int pos, int W) {
    extern __shared__ float ws[];
    attend_step<DH, T, C, false>(q, nullptr, nullptr, kc, vc, ksc, vsc, key_start, nullptr, 1, out,
                             B, H, n_ctx, layer, pos, W, ws);
}

// Launch ``kernel`` on the grid (H, B) with W floats of dynamic shared
// memory, after checking 0 <= pos < W <= min(n_ctx, MAX_WINDOW) (and, for a
// beam kernel, that B is whole groups of G).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int B, int H, int n_ctx, int pos, int window, int G,
           void* stream, Args... args) {
    if (window < 1 || window > MAX_WINDOW || window > n_ctx || pos < 0 || pos >= window ||
        G < 1 || B % G)
        return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<dim3(H, B), THREADS, (size_t)window * sizeof(float),
             static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

// Call f with the head dim as a compile-time constant: the instances are
// 16 and 64, and any other dh is refused.
template <typename F>
int by_head_dim(int dh, F&& f) {
    if (dh == 64) return f(std::integral_constant<int, 64>{});
    if (dh == 16) return f(std::integral_constant<int, 16>{});
    return static_cast<int>(cudaErrorInvalidValue);
}

// Launch a window kernel on the grid (H, B) with `threads` a block (the
// plan of ops/decode_attention.py::step_launch_plan: 64..THREADS, whole
// warps) and, for the beam, W ints of dynamic shared memory, after checking
// 0 <= pos < W <= min(n_ctx, MAX_WINDOW) and that B is whole groups of G.
template <typename... Params, typename... Args>
int launch_window(void (*kernel)(Params...), bool beam, int B, int H, int n_ctx, int pos,
                  int window, int G, int threads, void* stream, Args... args) {
    if (window < 1 || window > MAX_WINDOW || window > n_ctx || pos < 0 || pos >= window ||
        G < 1 || B % G || threads < 64 || threads > THREADS || threads % 32)
        return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<dim3(H, B), threads, beam ? (size_t)window * sizeof(int) : 0,
             static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int append(const void* q, const void* knew, const void* vnew, void* kc, void* vc,
           const void* key_start, void* out, int B, int H, int n_ctx, int layer, int pos,
           int window, int dh, int threads, void* stream) {
    return by_head_dim(dh, [&](auto D) {
        return launch_window(self_append_kernel<decltype(D)::value, T>, false, B, H, n_ctx, pos,
                             window, 1, threads, stream, static_cast<const T*>(q),
                             static_cast<const T*>(knew), static_cast<const T*>(vnew),
                             static_cast<T*>(kc), static_cast<T*>(vc),
                             static_cast<const long long*>(key_start), static_cast<T*>(out), B,
                             H, n_ctx, layer, pos, window);
    });
}

template <typename T>
int beam(const void* q, const void* knew, const void* vnew, void* kc, void* vc,
         const void* key_start, const void* anc, int G, void* out, int B, int H, int n_ctx,
         int layer, int pos, int window, int dh, int threads, void* stream) {
    return by_head_dim(dh, [&](auto D) {
        return launch_window(beam_self_kernel<decltype(D)::value, T>, true, B, H, n_ctx, pos,
                             window, G, threads, stream, static_cast<const T*>(q),
                             static_cast<const T*>(knew), static_cast<const T*>(vnew),
                             static_cast<T*>(kc), static_cast<T*>(vc),
                             static_cast<const long long*>(key_start),
                             static_cast<const int*>(anc), G, static_cast<T*>(out), B, H, n_ctx,
                             layer, pos, window);
    });
}

template <typename T>
int fused(const void* q, void* kc, void* vc, const void* key_start, void* out, int B, int H,
          int n_ctx, int layer, int pos, int window, int dh, void* stream) {
    return by_head_dim(dh, [&](auto D) {
        return launch(self_fused_kernel<decltype(D)::value, T>, B, H, n_ctx, pos, window, 1,
                      stream, static_cast<const T*>(q), static_cast<T*>(kc),
                      static_cast<T*>(vc), static_cast<const long long*>(key_start),
                      static_cast<T*>(out), B, H, n_ctx, layer, pos, window);
    });
}

template <typename T, typename C>
int step(const void* q, void* kc, void* vc, const void* ksc, const void* vsc,
         const void* key_start, void* out, int B, int H, int n_ctx, int layer, int pos,
         int window, int dh, void* stream) {
    return by_head_dim(dh, [&](auto D) {
        return launch(self_step_kernel<decltype(D)::value, T, C>, B, H, n_ctx, pos, window, 1,
                      stream, static_cast<const T*>(q), static_cast<C*>(kc), static_cast<C*>(vc),
                      static_cast<const float*>(ksc), static_cast<const float*>(vsc),
                      static_cast<const long long*>(key_start), static_cast<T*>(out), B, H,
                      n_ctx, layer, pos, window);
    });
}

template <typename T>
int beam_int8(const void* q, void* kc, void* vc, const void* ksc, const void* vsc,
              const void* key_start, const void* anc, int G, void* out, int B, int H, int n_ctx,
              int layer, int pos, int window, int dh, int threads, void* stream) {
    return by_head_dim(dh, [&](auto D) {
        return launch_window(beam_self_int8_kernel<decltype(D)::value, T>, true, B, H, n_ctx,
                             pos, window, G, threads, stream, static_cast<const T*>(q),
                             static_cast<int8_t*>(kc), static_cast<int8_t*>(vc),
                             static_cast<const float*>(ksc), static_cast<const float*>(vsc),
                             static_cast<const long long*>(key_start),
                             static_cast<const int*>(anc), G, static_cast<T*>(out), B, H, n_ctx,
                             layer, pos, window);
    });
}

}  // namespace

// q, knew, vnew, out: [B, H, dh]; kc, vc: [L, B, H, n_ctx, dh]; dh 16 or 64;
// key_start: [B] int64 or null (zeros); all contiguous and 16-byte aligned;
// the caches are written at slot pos of layer in place.
// 0 <= pos < window <= n_ctx.  threads: a block's, the launch plan of
// ops/decode_attention.py::step_launch_plan (64..256, whole warps; any other
// is refused).
extern "C" int self_attention_append_bf16(const void* q, const void* knew, const void* vnew,
                                          void* kc, void* vc, const void* key_start, void* out,
                                          int B, int H, int n_ctx, int layer, int pos,
                                          int window, int dh, int threads, void* stream) {
    return append<bf16>(q, knew, vnew, kc, vc, key_start, out, B, H, n_ctx, layer, pos, window,
                        dh, threads, stream);
}

extern "C" int self_attention_append_f32(const void* q, const void* knew, const void* vnew,
                                         void* kc, void* vc, const void* key_start, void* out,
                                         int B, int H, int n_ctx, int layer, int pos,
                                         int window, int dh, int threads, void* stream) {
    return append<float>(q, knew, vnew, kc, vc, key_start, out, B, H, n_ctx, layer, pos, window,
                         dh, threads, stream);
}

// As the append entry points, plus anc: [B, n_ctx] int32, beam-local
// ancestors in [0, G) with anc[b, pos] == b % G; B a multiple of G.
extern "C" int beam_self_attention_bf16(const void* q, const void* knew, const void* vnew,
                                        void* kc, void* vc, const void* key_start,
                                        const void* anc, int G, void* out, int B, int H,
                                        int n_ctx, int layer, int pos, int window, int dh,
                                        int threads, void* stream) {
    return beam<bf16>(q, knew, vnew, kc, vc, key_start, anc, G, out, B, H, n_ctx, layer, pos,
                      window, dh, threads, stream);
}

extern "C" int beam_self_attention_f32(const void* q, const void* knew, const void* vnew,
                                       void* kc, void* vc, const void* key_start,
                                       const void* anc, int G, void* out, int B, int H,
                                       int n_ctx, int layer, int pos, int window, int dh,
                                       int threads, void* stream) {
    return beam<float>(q, knew, vnew, kc, vc, key_start, anc, G, out, B, H, n_ctx, layer, pos,
                       window, dh, threads, stream);
}

// The append entry points without k_new/v_new: slot pos of both caches was
// written by the caller; the kernel reads slots key_start[b] <= j <= pos
// and writes nothing but out.
extern "C" int self_attention_fused_bf16(const void* q, void* kc, void* vc,
                                         const void* key_start, void* out, int B, int H,
                                         int n_ctx, int layer, int pos, int window, int dh,
                                         void* stream) {
    return fused<bf16>(q, kc, vc, key_start, out, B, H, n_ctx, layer, pos, window, dh, stream);
}

extern "C" int self_attention_fused_f32(const void* q, void* kc, void* vc, const void* key_start,
                                        void* out, int B, int H, int n_ctx, int layer, int pos,
                                        int window, int dh, void* stream) {
    return fused<float>(q, kc, vc, key_start, out, B, H, n_ctx, layer, pos, window, dh, stream);
}

// As the fused entry points, over a cache in q's dtype (ksc, vsc null) or
// an int8 cache with f32 scales ksc, vsc [L, B, H, n_ctx] (contiguous).
extern "C" int self_attention_step_bf16(const void* q, void* kc, void* vc, const void* ksc,
                                        const void* vsc, const void* key_start, void* out,
                                        int B, int H, int n_ctx, int layer, int pos, int window,
                                        int dh, void* stream) {
    return ksc ? step<bf16, int8_t>(q, kc, vc, ksc, vsc, key_start, out, B, H, n_ctx, layer,
                                    pos, window, dh, stream)
               : step<bf16, bf16>(q, kc, vc, nullptr, nullptr, key_start, out, B, H, n_ctx,
                                  layer, pos, window, dh, stream);
}

extern "C" int self_attention_step_f32(const void* q, void* kc, void* vc, const void* ksc,
                                       const void* vsc, const void* key_start, void* out, int B,
                                       int H, int n_ctx, int layer, int pos, int window, int dh,
                                       void* stream) {
    return ksc ? step<float, int8_t>(q, kc, vc, ksc, vsc, key_start, out, B, H, n_ctx, layer,
                                     pos, window, dh, stream)
               : step<float, float>(q, kc, vc, nullptr, nullptr, key_start, out, B, H, n_ctx,
                                    layer, pos, window, dh, stream);
}

// The beam entry points over an int8 cache with f32 scales ksc, vsc
// [L, B, H, n_ctx], read only: the caller wrote slot pos and its scales.
extern "C" int beam_self_attention_int8_bf16(const void* q, void* kc, void* vc, const void* ksc,
                                             const void* vsc, const void* key_start,
                                             const void* anc, int G, void* out, int B, int H,
                                             int n_ctx, int layer, int pos, int window, int dh,
                                             int threads, void* stream) {
    return beam_int8<bf16>(q, kc, vc, ksc, vsc, key_start, anc, G, out, B, H, n_ctx, layer, pos,
                           window, dh, threads, stream);
}

extern "C" int beam_self_attention_int8_f32(const void* q, void* kc, void* vc, const void* ksc,
                                            const void* vsc, const void* key_start,
                                            const void* anc, int G, void* out, int B, int H,
                                            int n_ctx, int layer, int pos, int window, int dh,
                                            int threads, void* stream) {
    return beam_int8<float>(q, kc, vc, ksc, vsc, key_start, anc, G, out, B, H, n_ctx, layer, pos,
                            window, dh, threads, stream);
}
