// One decode step's cross-attention for layer l: G query rows per audio
// share one encoder K/V; out = softmax(q K^T) V, no mask, f32 softmax.
// With int8 K/V and f32 per-position scales ks, vs [L, A, H, Tk]: the
// scores times ks, and the weights times vs, kept in f32.
//
// Replaces: whisper_rs_tpu/ops/decode_attention.py::cross_attention_step
// (kernel body _cross_attn_kernel), both branches.  It reads the same
// fused layout kv [L, A, H, 2, dh, Tk] (K^T and V^T planes), and the
// layer index is a pointer offset, so the cross K/V is never sliced or
// copied per layer.  The TPU's int8 branch took whole-H scale blocks and
// picked each head's row by a masked reduce, for Mosaic; here a block
// reads its own head's scales, one 16-byte load per 4 keys.
//
// Bound on the H100: bytes.  Each step reads the layer's whole K/V,
// A * H * 2 * dh * Tk elements (393 MB at base.en b128 bf16, about 117 us
// at the H100 SXM data-sheet 3.35 TB/s, 700 W power limit; in int8 197 MB
// plus 12 MB of scales, about 62 us), for only 4 * G FLOP per element read.
//
// Design: one block per (head, audio, chunk of up to 8 of the audio's rows),
// 1024 blocks at base.en b128; an audio of more than 8 rows (beam 10) takes
// ceil(G / 8) chunks, which read its K/V each, so any G runs in one launch.
// Threads run along Tk, so every read of a [dh, Tk] plane row is coalesced
// and vectorised (4 elements a thread: 4 bytes in int8, 8 in bf16, 16 in
// f32).  The G rows' scores (Tk x G f32) stay in shared memory; block
// reductions give the max and the sum; the weights are normalised and, as
// on the TPU, rounded to the K/V dtype (int8: multiplied by the V scales
// and kept in f32); then each warp takes a share of the dh rows of V^T and
// reduces P V^T across its lanes.  Simple first: no cp.async prefetch of
// V^T under the softmax yet.  The head dim is a template parameter,
// instantiated at 64 (every registry model) and 16 (the golden test dims);
// the entry points take dh and refuse any other.
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// T: the query and output dtype; C: the K/V's (T, or int8 with the scales
// ksc, vsc).
template <int DH, typename T, typename C, int GM>
__global__ void __launch_bounds__(THREADS)
cross_attn_kernel(const T* __restrict__ q, const C* __restrict__ kv,
                  const float* __restrict__ ksc, const float* __restrict__ vsc,
                  T* __restrict__ out, int A, int G_all, int H, int Tk, int layer) {
    constexpr bool INT8 = std::is_same<C, int8_t>::value;
    extern __shared__ __align__(16) float sc[];  // [G][Tk] scores, then weights
    __shared__ float qs[GM][DH];
    __shared__ float red[GM][WARPS];
    __shared__ float stat[GM];

    const int h = blockIdx.x, a = blockIdx.y;
    // this block's rows of the audio: g0 .. g0 + G - 1 of its G_all
    const int g0 = blockIdx.z * GM, G = min(GM, G_all - g0);
    const size_t row0 = (size_t)a * G_all + g0;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const C* kt = kv + ((((size_t)layer * A + a) * H + h) * 2) * DH * Tk;  // K^T [dh, Tk]
    const C* vt = kt + (size_t)DH * Tk;                                      // V^T [dh, Tk]
    const size_t srow = (((size_t)layer * A + a) * H + h) * Tk;  // this head's scales

    for (int i = threadIdx.x; i < G * DH; i += THREADS) {
        const int g = i / DH, d = i % DH;
        qs[g][d] = to_float(q[((row0 + g) * H + h) * DH + d]);
    }
    __syncthreads();

    // Scores: thread takes 4 consecutive keys at a time.
    const int T4 = Tk / 4;
    float lmax[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) lmax[g] = -INFINITY;
    for (int j4 = threadIdx.x; j4 < T4; j4 += THREADS) {
        float acc[GM][4];
#pragma unroll
        for (int g = 0; g < GM; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
            const float4 k4 = load4(kt + (size_t)d * Tk + 4 * j4);
#pragma unroll
            for (int g = 0; g < GM; ++g) {
                if (g < G) {
                    const float qv = qs[g][d];
                    acc[g][0] = fmaf(qv, k4.x, acc[g][0]);
                    acc[g][1] = fmaf(qv, k4.y, acc[g][1]);
                    acc[g][2] = fmaf(qv, k4.z, acc[g][2]);
                    acc[g][3] = fmaf(qv, k4.w, acc[g][3]);
                }
            }
        }
        if (INT8) {
            const float4 s4 = *reinterpret_cast<const float4*>(ksc + srow + 4 * j4);
#pragma unroll
            for (int g = 0; g < GM; ++g) {
                acc[g][0] *= s4.x;
                acc[g][1] *= s4.y;
                acc[g][2] *= s4.z;
                acc[g][3] *= s4.w;
            }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            if (g < G) {
                *reinterpret_cast<float4*>(&sc[(size_t)g * Tk + 4 * j4]) =
                    make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
                lmax[g] = fmaxf(lmax[g], fmaxf(fmaxf(acc[g][0], acc[g][1]),
                                               fmaxf(acc[g][2], acc[g][3])));
            }
        }
    }

    // Block max per row.
#pragma unroll
    for (int g = 0; g < GM; ++g) {
        const float wm = warp_max(lmax[g]);
        if (lane == 0) red[g][warp] = wm;
    }
    __syncthreads();
    if (threadIdx.x < GM) {
        float mx = -INFINITY;
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, red[threadIdx.x][w]);
        stat[threadIdx.x] = mx;
    }
    __syncthreads();

    // exp and block sum per row.
    float lsum[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
        lsum[g] = 0.f;
        if (g < G) {
            const float mx = stat[g];
            for (int j = threadIdx.x; j < Tk; j += THREADS) {
                const float e = expf(sc[(size_t)g * Tk + j] - mx);
                sc[(size_t)g * Tk + j] = e;
                lsum[g] += e;
            }
        }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
        const float ws = warp_sum(lsum[g]);
        if (lane == 0) red[g][warp] = ws;
    }
    __syncthreads();
    if (threadIdx.x < GM) {
        float s = 0.f;
        for (int w = 0; w < WARPS; ++w) s += red[threadIdx.x][w];
        stat[threadIdx.x] = 1.f / s;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g) {
        if (g < G) {
            const float inv = stat[g];
            for (int j = threadIdx.x; j < Tk; j += THREADS) {
                const float w = sc[(size_t)g * Tk + j] * inv;
                sc[(size_t)g * Tk + j] = INT8 ? w * vsc[srow + j] : round_to<T>(w);
            }
        }
    }
    __syncthreads();

    // out[g, d] = sum_j w[g, j] V^T[d, j]; warp per row d of V^T.
    for (int d = warp; d < DH; d += WARPS) {
        float acc[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) acc[g] = 0.f;
        for (int j4 = lane; j4 < T4; j4 += 32) {
            const float4 v4 = load4(vt + (size_t)d * Tk + 4 * j4);
#pragma unroll
            for (int g = 0; g < GM; ++g) {
                if (g < G) {
                    const float4 w = *reinterpret_cast<const float4*>(&sc[(size_t)g * Tk + 4 * j4]);
                    acc[g] = fmaf(w.x, v4.x, acc[g]);
                    acc[g] = fmaf(w.y, v4.y, acc[g]);
                    acc[g] = fmaf(w.z, v4.z, acc[g]);
                    acc[g] = fmaf(w.w, v4.w, acc[g]);
                }
            }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
            const float s = warp_sum(acc[g]);
            if (lane == 0 && g < G)
                out[((row0 + g) * H + h) * DH + d] = from_float<T>(s);
        }
    }
}

template <int DH, typename T, typename C, int GM>
int launch(const void* q, const void* kv, const void* ksc, const void* vsc, void* out, int A,
           int G, int H, int Tk, int layer, cudaStream_t stream) {
    const size_t smem = (size_t)(G < GM ? G : GM) * Tk * sizeof(float);
    auto kernel = cross_attn_kernel<DH, T, C, GM>;
    if (smem > 32 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<dim3(H, A, (G + GM - 1) / GM), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const C*>(kv), static_cast<const float*>(ksc),
        static_cast<const float*>(vsc), static_cast<T*>(out), A, G, H, Tk, layer);
    return static_cast<int>(cudaGetLastError());
}

template <int DH, typename T, typename C>
int by_rows(const void* q, const void* kv, const void* ksc, const void* vsc, void* out, int A,
            int G, int H, int Tk, int layer, cudaStream_t s) {
    if (G == 1) return launch<DH, T, C, 1>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, s);
    if (G <= 2) return launch<DH, T, C, 2>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, s);
    if (G <= 4) return launch<DH, T, C, 4>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, s);
    return launch<DH, T, C, 8>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, s);
}

// The instantiated head dims, 16 and 64; any other dh is refused.
template <typename T, typename C>
int dispatch(const void* q, const void* kv, const void* ksc, const void* vsc, void* out, int A,
             int G, int H, int Tk, int layer, int dh, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dh == 64) return by_rows<64, T, C>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, s);
    if (dh == 16) return by_rows<16, T, C>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: [A, G, H, dh] pre-scaled; kv: [L, A, H, 2, dh, Tk] with Tk % 4 == 0;
// out: [A, G, H, dh]; dh 16 or 64; all contiguous, 16-byte aligned; G >= 1.
extern "C" int cross_attention_bf16(const void* q, const void* kv, void* out, int A, int G,
                                    int H, int Tk, int layer, int dh, void* stream) {
    return dispatch<bf16, bf16>(q, kv, nullptr, nullptr, out, A, G, H, Tk, layer, dh, stream);
}

extern "C" int cross_attention_f32(const void* q, const void* kv, void* out, int A, int G,
                                   int H, int Tk, int layer, int dh, void* stream) {
    return dispatch<float, float>(q, kv, nullptr, nullptr, out, A, G, H, Tk, layer, dh, stream);
}

// As above with kv int8 and its f32 scales ksc, vsc [L, A, H, Tk]
// (contiguous, 16-byte aligned).
extern "C" int cross_attention_int8_bf16(const void* q, const void* kv, const void* ksc,
                                         const void* vsc, void* out, int A, int G, int H, int Tk,
                                         int layer, int dh, void* stream) {
    return dispatch<bf16, int8_t>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, dh, stream);
}

extern "C" int cross_attention_int8_f32(const void* q, const void* kv, const void* ksc,
                                        const void* vsc, void* out, int A, int G, int H, int Tk,
                                        int layer, int dh, void* stream) {
    return dispatch<float, int8_t>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, dh, stream);
}
