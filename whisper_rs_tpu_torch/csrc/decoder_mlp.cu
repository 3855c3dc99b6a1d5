// One decode step's MLP for one decoder layer, without the fc2 bias:
//   a   = h W1^T + b1          (f32 sum, then rounded to T)
//   g   = gelu(a)              (exact erf in f32, the tanh form in bf16,
//                               computed in f32 and rounded to T)
//   out = g W2^T               (f32 sum, cast to T)
// with h [B, D], W1 = mlp.0.weight [4D, D], b1 [4D], W2 = mlp.2.weight
// [D, 4D], all of the compute dtype T.
//
// Replaces: whisper_rs_tpu/ops/decoder_mlp_fused.py::decoder_mlp_step
// (kernel body _mlp_kernel).  The TPU kernel streamed both weights as one
// packed [L, 4D, 2D] array over a sequential grid of hidden chunks, with one
// VMEM accumulator for fc2.  Packing was a v5e stream-structure finding and
// is not carried over: both weights are read in place, since every row of
// W1 and of W2 is contiguous.  Blocks run in parallel and in no order on
// Hopper, so fc2 is not summed across hidden chunks: the first launch
// writes g [B, 4D] (123 KB at large-v3 b12, against 26 MB of weights), and
// the second computes each output element whole, in one warp, in a fixed
// order.  No atomics: the result is the same from run to run.
//
// Bound on the H100: bytes of the two weight matrices, 2 * 4D * D elements
// (26.2 MB at large-v3 in bf16: 7.8 us at the H100 SXM data-sheet
// 3.35 TB/s, 700 W power limit); the products, 4 * B * 4D * D FLOP, take
// 0.3 us at 989 TFLOP/s.  At base.en b128 the bytes (4.5 MB, 1.3 us) and
// the operations (0.54 us on the tensor cores) are closer.
//
// Design: both launches are one "rows dot batch" kernel.  A warp owns two
// weight rows and walks them in chunks of 128 elements (4 a lane: 8-byte
// loads in bf16, 16 in f32), loading 4 chunks of both rows ahead, so some
// 2 KB a warp are in flight; for each of up to 16 batch rows it reads the
// matching activation chunk (L1-resident, shared by the block's 4 warps) and
// accumulates f32 FMAs; a butterfly sum per output ends it.  grid.y covers
// the batch in tiles of 16, re-reading the weights from L2.  The products
// run on the FMA pipes: simple first, no mma.sync, split-K or TMA yet.  At
// large-v3 b12 fc2 has only 640 warps, each streaming 20 KB in turn with
// 2 KB in flight, so it likely waits on memory latency rather than
// bandwidth; at large batch the FMA issue rate bounds it.  A K that is not
// a multiple of 128 (fc1 at D 64, the golden test dims) takes the TAIL
// instance, whose lanes past K load zeros; every registry model's D is a
// multiple of 128 and takes the instance without the check.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 2;   // weight rows per warp
constexpr int MB = 16;    // batch rows per block
constexpr int PF = 4;     // 128-wide chunks loaded ahead per row
constexpr int CHUNK = 128;
static_assert(ROWS * MB == 32, "one output per lane in the epilogue");

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

// Each lane's f32 partial of x[bb] . w[r] over K, for r < ROWS and bb < nb,
// summed across the warp; then lane r * MB + bb returns output (r, bb).
// K % 4 == 0; without TAIL, K % CHUNK == 0.
template <bool TAIL, typename T>
__device__ __forceinline__ float rows_dot(const T* __restrict__ w, const T* __restrict__ x,
                                          int K, int nb, int lane) {
    float acc[ROWS][MB];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int bb = 0; bb < MB; ++bb) acc[r][bb] = 0.f;

    const int nc = (K + CHUNK - 1) / CHUNK;
    // whether this lane's 4 columns of chunk c lie inside K
    auto inside = [&](int c) { return c < nc && (!TAIL || c * CHUNK + 4 * lane < K); };
    for (int c0 = 0; c0 < nc; c0 += PF) {
        float4 wv[PF][ROWS];
#pragma unroll
        for (int p = 0; p < PF; ++p)
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
                wv[p][r] = inside(c0 + p)
                               ? load4(w + (size_t)r * K + (c0 + p) * CHUNK + 4 * lane)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int bb = 0; bb < MB; ++bb) {
#pragma unroll
            for (int p = 0; p < PF; ++p) {
                if (bb < nb && inside(c0 + p)) {
                    const float4 xv = load4(x + (size_t)bb * K + (c0 + p) * CHUNK + 4 * lane);
#pragma unroll
                    for (int r = 0; r < ROWS; ++r) {
                        acc[r][bb] = fmaf(xv.x, wv[p][r].x, acc[r][bb]);
                        acc[r][bb] = fmaf(xv.y, wv[p][r].y, acc[r][bb]);
                        acc[r][bb] = fmaf(xv.z, wv[p][r].z, acc[r][bb]);
                        acc[r][bb] = fmaf(xv.w, wv[p][r].w, acc[r][bb]);
                    }
                }
            }
        }
    }
    float mine = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int bb = 0; bb < MB; ++bb) {
            const float s = warp_sum(acc[r][bb]);
            if (lane == r * MB + bb) mine = s;
        }
    return mine;
}

// g[b, j] = gelu(round(h[b] . W1[j] + b1[j])) for the warp's rows j.
template <bool TAIL, typename T>
__global__ void __launch_bounds__(THREADS)
mlp_fc1_gelu_kernel(const T* __restrict__ h, const T* __restrict__ w1,
                    const T* __restrict__ b1, T* __restrict__ g, int B, int D, int H4) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int j0 = (blockIdx.x * WARPS + warp) * ROWS;
    const int b0 = blockIdx.y * MB;
    const int nb = min(MB, B - b0);
    const float s = rows_dot<TAIL>(w1 + (size_t)j0 * D, h + (size_t)b0 * D, D, nb, lane);
    const int r = lane / MB, bb = lane % MB;
    if (bb < nb) {
        const float a = round_to<T>(s + to_float(b1[j0 + r]));
        g[(size_t)(b0 + bb) * H4 + j0 + r] = from_float<T>(gelu<T>(a));
    }
}

// out[b, n] = g[b] . W2[n] for the warp's rows n.
template <bool TAIL, typename T>
__global__ void __launch_bounds__(THREADS)
mlp_fc2_kernel(const T* __restrict__ g, const T* __restrict__ w2, T* __restrict__ out,
               int B, int D, int H4) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * WARPS + warp) * ROWS;
    const int b0 = blockIdx.y * MB;
    const int nb = min(MB, B - b0);
    const float s = rows_dot<TAIL>(w2 + (size_t)n0 * H4, g + (size_t)b0 * H4, H4, nb, lane);
    const int r = lane / MB, bb = lane % MB;
    if (bb < nb) out[(size_t)(b0 + bb) * D + n0 + r] = from_float<T>(s);
}

template <typename T>
int launch(const void* h, const void* w1, const void* b1, const void* w2, void* g, void* out,
           int B, int D, void* stream) {
    // whole 4-element loads, and whole warps of ROWS rows over D and 4D
    if (B < 1 || D < WARPS * ROWS || D % (WARPS * ROWS))
        return static_cast<int>(cudaErrorInvalidValue);
    const int H4 = 4 * D;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int btiles = (B + MB - 1) / MB;
    const dim3 fc1_grid(H4 / (WARPS * ROWS), btiles), fc2_grid(D / (WARPS * ROWS), btiles);
    const auto h_ = static_cast<const T*>(h), w1_ = static_cast<const T*>(w1),
               b1_ = static_cast<const T*>(b1), w2_ = static_cast<const T*>(w2);
    if (D % CHUNK)
        mlp_fc1_gelu_kernel<true, T><<<fc1_grid, THREADS, 0, s>>>(h_, w1_, b1_,
                                                                   static_cast<T*>(g), B, D, H4);
    else
        mlp_fc1_gelu_kernel<false, T><<<fc1_grid, THREADS, 0, s>>>(h_, w1_, b1_,
                                                                    static_cast<T*>(g), B, D, H4);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (H4 % CHUNK)
        mlp_fc2_kernel<true, T><<<fc2_grid, THREADS, 0, s>>>(static_cast<const T*>(g), w2_,
                                                              static_cast<T*>(out), B, D, H4);
    else
        mlp_fc2_kernel<false, T><<<fc2_grid, THREADS, 0, s>>>(static_cast<const T*>(g), w2_,
                                                               static_cast<T*>(out), B, D, H4);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
// h, out: [B, D]; w1: [4D, D]; b1: [4D]; w2: [D, 4D]; g: [B, 4D] scratch;
// all contiguous, 16-byte aligned; D % 8 == 0.
extern "C" int decoder_mlp_bf16(const void* h, const void* w1, const void* b1, const void* w2,
                                void* g, void* out, int B, int D, void* stream) {
    return launch<bf16>(h, w1, b1, w2, g, out, B, D, stream);
}

extern "C" int decoder_mlp_f32(const void* h, const void* w1, const void* b1, const void* w2,
                               void* g, void* out, int B, int D, void* stream) {
    return launch<float>(h, w1, b1, w2, g, out, B, D, stream);
}
