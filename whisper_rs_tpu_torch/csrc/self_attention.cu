// One greedy decode step's self-attention for layer l, with this step's K/V
// column appended to the cache inside the kernel:
//   K[l, b, h, pos] = k_new[b, h];  V[l, b, h, pos] = v_new[b, h];
//   out[b, h] = softmax_j(q[b, h] . K[l, b, h, j]) V[l, b, h, j]
// over the slots key_start[b] <= j <= pos of the first W (the rest masked),
// with f32 scores, f32 weights w = e / sum(e) (never rounded to the cache
// dtype) and an f32 sum, cast to the query dtype.
//
// Replaces: whisper_rs_tpu/ops/decode_attention.py::
// self_attention_append_step (kernel body _self_append_kernel).  The TPU
// kernel kept both planes transposed and lane-padded to 512, spliced the
// column into a VMEM copy and wrote back the aligned 128-wide block, with
// DMAs double-buffered across programs; all of that served Mosaic's tiling
// and the sequential grid.  Here the cache stays ctx-major
// [L, B, H, n_ctx, 64]: a key row is 64 contiguous elements (128 bytes in
// bf16), so 16-byte loads are coalesced, and the column write is one row.
// The layer index is a pointer offset, so nothing is sliced per layer.
//
// Bound on the H100: bytes.  Each step must read the visible K and V rows,
// 2 * B * H * (pos - key_start + 1) * 64 elements (15.7 MB at large-v3 b12,
// W = 256, pos = 255, bf16: 4.7 us at the H100 SXM data-sheet 3.35 TB/s,
// 700 W power limit), for 4 FLOP per element pair.
//
// Design: one block of 8 warps per (head, row), 240 blocks at large-v3 b12
// and 1024 at base.en b128.  The block first writes its own (b, h) column,
// which no other block reads, and uses the fresh k and v from the inputs
// for slot pos rather than re-reading it.  Only slots key_start..pos are
// read: masked slots have weight exactly 0 in f32 (exp of NEG - max
// underflows), so skipping them changes nothing.  A group of 8 lanes (16
// in f32) reads one key row with 16-byte loads; the scores go to shared
// memory, the block takes max and sum, and the same lane groups then walk
// V with the weights, reduced across groups and warps in a fixed order
// (deterministic, no atomics).  Simple first: two passes over the rows, no
// cp.async prefetch of V under the softmax.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DH = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WINDOW = 12 * 1024;  // W floats of scores in 48 KB

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
self_append_kernel(const T* __restrict__ q, const T* __restrict__ knew,
                   const T* __restrict__ vnew, T* __restrict__ kc, T* __restrict__ vc,
                   const long long* __restrict__ key_start, T* __restrict__ out,
                   int B, int H, int n_ctx, int layer, int pos, int W) {
    constexpr int VEC = Vec16<T>::N;  // elements per 16-byte load
    constexpr int LPR = DH / VEC;     // lanes per key row: 8 (bf16) or 16 (f32)
    constexpr int KPW = 32 / LPR;     // key rows per warp pass: 4 or 2
    constexpr int STRIDE = WARPS * KPW;
    extern __shared__ float ws[];     // [n] scores, then weights, of slots lo..hi
    __shared__ float red[WARPS][DH];
    __shared__ float stat[WARPS];

    const int h = blockIdx.x, b = blockIdx.y;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int grp = lane / LPR, seg = lane % LPR;
    const size_t row = (size_t)b * H + h;
    const size_t plane = (((size_t)layer * B + b) * H + h) * (size_t)n_ctx * DH;
    T* kp = kc + plane;
    T* vp = vc + plane;
    const T* kn = knew + row * DH;
    const T* vn = vnew + row * DH;

    // append: this block's own column, read by no other block
    if (tid < DH) {
        kp[(size_t)pos * DH + tid] = kn[tid];
        vp[(size_t)pos * DH + tid] = vn[tid];
    }

    const long long ks = key_start ? key_start[b] : 0;
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
    load16(q + row * DH + seg * VEC, qx);

    // scores of slots lo..hi; lane group grp takes row j, lane seg its
    // VEC elements
    float lmax = -INFINITY;
    for (int j0 = lo + warp * KPW; j0 <= hi; j0 += STRIDE) {
        const int j = j0 + grp;
        float part = 0.f;
        if (j <= hi && !empty) {
            float kx[VEC];
            load16((j == pos ? kn : kp + (size_t)j * DH) + seg * VEC, kx);
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
    for (int i = tid; i < n; i += THREADS) ws[i] = ws[i] / total;
    __syncthreads();

    // out = sum_j w_j V_j in f32, same row walk as the scores
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int j0 = lo + warp * KPW; j0 <= hi; j0 += STRIDE) {
        const int j = j0 + grp;
        if (j <= hi) {
            const float wj = ws[j - lo];
            float vx[VEC];
            load16((j == pos ? vn : vp + (size_t)j * DH) + seg * VEC, vx);
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

template <typename T>
int launch(const void* q, const void* knew, const void* vnew, void* kc, void* vc,
           const void* key_start, void* out, int B, int H, int n_ctx, int layer, int pos,
           int window, void* stream) {
    if (window < 1 || window > MAX_WINDOW || window > n_ctx || pos < 0 || pos >= window)
        return static_cast<int>(cudaErrorInvalidValue);
    self_append_kernel<T><<<dim3(H, B), THREADS, (size_t)window * sizeof(float),
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(knew), static_cast<const T*>(vnew),
        static_cast<T*>(kc), static_cast<T*>(vc), static_cast<const long long*>(key_start),
        static_cast<T*>(out), B, H, n_ctx, layer, pos, window);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, knew, vnew, out: [B, H, 64]; kc, vc: [L, B, H, n_ctx, 64]; key_start:
// [B] int64 or null (zeros); all contiguous and 16-byte aligned; the caches
// are written at slot pos of layer in place.  0 <= pos < window <= n_ctx.
extern "C" int self_attention_append_bf16(const void* q, const void* knew, const void* vnew,
                                          void* kc, void* vc, const void* key_start, void* out,
                                          int B, int H, int n_ctx, int layer, int pos,
                                          int window, void* stream) {
    return launch<bf16>(q, knew, vnew, kc, vc, key_start, out, B, H, n_ctx, layer, pos,
                        window, stream);
}

extern "C" int self_attention_append_f32(const void* q, const void* knew, const void* vnew,
                                         void* kc, void* vc, const void* key_start, void* out,
                                         int B, int H, int n_ctx, int layer, int pos,
                                         int window, void* stream) {
    return launch<float>(q, knew, vnew, kc, vc, key_start, out, B, H, n_ctx, layer, pos,
                         window, stream);
}
