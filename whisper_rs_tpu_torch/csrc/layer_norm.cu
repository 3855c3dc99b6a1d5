// Row LayerNorm, with an optional residual add before it, over a [rows, D]
// view: ln = LN(x), or y = x + delta and ln = LN(y).
//
// Replaces: whisper_rs_tpu/ops/encoder_fused.py::residual_ln (kernel body
// _residual_ln_kernel) and ::ln_fused (_ln_kernel).  One source serves
// both: RES selects the residual variant.  The math is f32: the mean, then
// the variance of the centred values, eps from the caller (1e-5); y is
// stored rounded to the input dtype and LN is taken from the f32 sum, as the
// plain versions (ops/encoder_fused.py) take it.  Scale and bias are in the
// input dtype.  The normalise is ((y - mean) * rstd) * scale + bias, each
// operation rounded on its own (no contraction into an FMA), as the plain
// chain rounds it.
//
// Bound on the H100: bytes.  Each row is read once (twice with the
// residual) and written once (twice), with about 8 operations an element.
// At the encoder's shapes (1500 rows an audio) the kernel should stream at
// the card's memory rate; at the decoder step's shapes (5-128 rows, D
// 384-1280: 5-330 KB) it sits at the launch floor, where the plain chain
// it replaces took 14 launches.
//
// Design (plan from ops/encoder_fused.py::ln_launch_plan):
//  * "warp": one warp a row, rows_per_block rows a block.  A lane loads
//    ITER vectors of VEC elements (16 bytes: 8 bf16 or 4 f32; VEC 1 where D
//    or a pointer is not aligned to 16 bytes), vector c = i * 32 + lane of
//    the row, all of them before any arithmetic (scale and bias with them
//    where a lane holds few 16-byte vectors, EARLY), and holds the row's
//    part in registers (ITER * VEC <= 64 floats).  Both sums are
//    xor-shuffle trees across the warp: no shared memory, no block
//    barrier.  A warp whose row lies past the end returns as a whole.
//  * "block": one block a row, where a warp's registers cannot hold it
//    (D > 64 * 32 elements, or D > 512 at VEC 1): the f32 row is staged in
//    dynamic shared memory, each thread walks vectors c = threadIdx.x + k *
//    blockDim.x, and each sum is a warp tree, one partial a warp in shared
//    memory, and every thread adding the partials in warp order.
// Every sum is taken in a fixed order, so two calls on the same inputs are
// bit-identical, and a captured decode loop equals its eager one.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_HELD = 64;      // f32 values a lane of the warp variant holds
constexpr int BLOCK_THREADS = 256;

// VEC consecutive elements of T as one load or store: 16 bytes, or one
// element; the pointer must be aligned to it.
template <typename T, int VEC>
struct Raw;
template <>
struct Raw<float, 4> { using type = float4; };
template <>
struct Raw<float, 1> { using type = float; };
template <>
struct Raw<bf16, 8> { using type = uint4; };
template <>
struct Raw<bf16, 1> { using type = bf16; };
template <typename T, int VEC>
using raw_t = typename Raw<T, VEC>::type;

template <typename T, int VEC>
__device__ __forceinline__ raw_t<T, VEC> load_raw(const T* p) {
    return *reinterpret_cast<const raw_t<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_raw(T* p, const raw_t<T, VEC>& r) {
    *reinterpret_cast<raw_t<T, VEC>*>(p) = r;
}

__device__ __forceinline__ void unpack(const float4& r, float (&v)[4]) {
    v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
}
__device__ __forceinline__ void unpack(const float& r, float (&v)[1]) { v[0] = r; }
// A bf16 value is the top half of the f32 with the same bits: exact.
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[2 * k] = __uint_as_float(w[k] << 16);
        v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
}
__device__ __forceinline__ void unpack(const bf16& r, float (&v)[1]) { v[0] = __bfloat162float(r); }

// VEC f32 values rounded to T.
template <typename T, int VEC>
__device__ __forceinline__ raw_t<T, VEC> pack(const float (&v)[VEC]);
template <>
__device__ __forceinline__ float4 pack<float, 4>(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ float pack<float, 1>(const float (&v)[1]) { return v[0]; }
template <>
__device__ __forceinline__ uint4 pack<bf16, 8>(const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        w[k] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]))) |
               static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])))
                   << 16;
    return make_uint4(w[0], w[1], w[2], w[3]);
}
template <>
__device__ __forceinline__ bf16 pack<bf16, 1>(const float (&v)[1]) { return __float2bfloat16(v[0]); }

struct Args {
    const void* x;
    const void* delta;
    const void* scale;
    const void* bias;
    void* y;
    void* ln;
    int rows;
    int D;
    float eps;
};

// The row's pointers, typed.
template <typename T>
struct Row {
    const T* x;
    const T* delta;
    const T* scale;
    const T* bias;
    T* y;
    T* ln;

    __device__ __forceinline__ Row(const Args& a, size_t row) {
        const size_t base = row * static_cast<size_t>(a.D);
        x = static_cast<const T*>(a.x) + base;
        delta = static_cast<const T*>(a.delta) + base;
        scale = static_cast<const T*>(a.scale);
        bias = static_cast<const T*>(a.bias);
        y = static_cast<T*>(a.y) + base;
        ln = static_cast<T*>(a.ln) + base;
    }
};

// (d * rstd) * scale + bias of VEC centred values, each operation rounded.
template <typename T, int VEC>
__device__ __forceinline__ raw_t<T, VEC> normalised(const float (&d)[VEC], float rstd,
                                                   const raw_t<T, VEC>& sr,
                                                   const raw_t<T, VEC>& br) {
    float s[VEC], b[VEC], out[VEC];
    unpack(sr, s);
    unpack(br, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = __fadd_rn(__fmul_rn(__fmul_rn(d[j], rstd), s[j]), b[j]);
    return pack<T, VEC>(out);
}

// Every load of x (and delta) is issued before any arithmetic, and y is
// stored after them.  At 16-byte vectors and ITER <= EARLY_ITERS (every
// registry width in bf16) scale and bias are loaded with x (EARLY), so
// their latency hides under it (at the decoder step's few rows a warp's
// latency is the call's time), at 2 x ITER more vectors of registers.
// Else (more vectors a lane, where those registers would cost the
// occupancy that hides latency) each vector's scale and bias are loaded
// where it is normalised.
constexpr int EARLY_ITERS = 5;

template <typename T, int VEC, int ITER, bool RES>
__global__ void __launch_bounds__(BLOCK_THREADS) layer_norm_rows_warp(const Args a) {
    constexpr bool EARLY = VEC > 1 && ITER <= EARLY_ITERS;
    using R = raw_t<T, VEC>;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= a.rows) return;  // the whole warp: no shuffle waits on it
    const Row<T> r(a, row);
    R xr[ITER], dr[ITER], sr[ITER], br[ITER];
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
        const int c = (i * 32 + lane) * VEC;
        if (c < a.D) {
            xr[i] = load_raw<T, VEC>(r.x + c);
            if constexpr (RES) dr[i] = load_raw<T, VEC>(r.delta + c);
            if constexpr (EARLY) {
                sr[i] = load_raw<T, VEC>(r.scale + c);
                br[i] = load_raw<T, VEC>(r.bias + c);
            }
        }
    }
    float v[ITER][VEC];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
        const int c = (i * 32 + lane) * VEC;
        if (c < a.D) {
            unpack(xr[i], v[i]);
            if constexpr (RES) {
                float d[VEC];
                unpack(dr[i], d);
#pragma unroll
                for (int j = 0; j < VEC; ++j) v[i][j] = __fadd_rn(v[i][j], d[j]);
                store_raw<T, VEC>(r.y + c, pack<T, VEC>(v[i]));
            }
        } else {
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[i][j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) sum += v[i][j];
    }
    const float mean = warp_sum(sum) / static_cast<float>(a.D);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
        if ((i * 32 + lane) * VEC < a.D) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                v[i][j] = __fsub_rn(v[i][j], mean);
                sq = __fmaf_rn(v[i][j], v[i][j], sq);
            }
        }
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(a.D) + a.eps);
#pragma unroll
    for (int i = 0; i < ITER; ++i) {
        const int c = (i * 32 + lane) * VEC;
        if (c < a.D) {
            if constexpr (!EARLY) {
                sr[i] = load_raw<T, VEC>(r.scale + c);
                br[i] = load_raw<T, VEC>(r.bias + c);
            }
            store_raw<T, VEC>(r.ln + c, normalised<T, VEC>(v[i], rstd, sr[i], br[i]));
        }
    }
}

// The block's sum of v: a warp tree, one partial a warp in part[], every
// thread adding the partials in warp order (the same value in every thread).
__device__ __forceinline__ float block_sum(float v, float* part) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += part[w];
    return s;
}

template <typename T, int VEC, bool RES>
__global__ void __launch_bounds__(BLOCK_THREADS) layer_norm_rows_block(const Args a) {
    extern __shared__ float stage[];  // the row's D f32 values, then 2 x 32 partials
    float* part = stage + a.D;
    const Row<T> r(a, blockIdx.x);
    float sum = 0.f;
    for (int c = threadIdx.x * VEC; c < a.D; c += blockDim.x * VEC) {
        float v[VEC];
        unpack(load_raw<T, VEC>(r.x + c), v);
        if constexpr (RES) {
            float d[VEC];
            unpack(load_raw<T, VEC>(r.delta + c), d);
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[j] = __fadd_rn(v[j], d[j]);
            store_raw<T, VEC>(r.y + c, pack<T, VEC>(v));
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            stage[c + j] = v[j];
            sum += v[j];
        }
    }
    const float mean = block_sum(sum, part) / static_cast<float>(a.D);
    float sq = 0.f;
    for (int c = threadIdx.x * VEC; c < a.D; c += blockDim.x * VEC) {  // a thread's own values
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const float d = __fsub_rn(stage[c + j], mean);
            sq = __fmaf_rn(d, d, sq);
        }
    }
    const float rstd = rsqrtf(block_sum(sq, part + 32) / static_cast<float>(a.D) + a.eps);
    for (int c = threadIdx.x * VEC; c < a.D; c += blockDim.x * VEC) {
        float d[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) d[j] = __fsub_rn(stage[c + j], mean);
        store_raw<T, VEC>(r.ln + c, normalised<T, VEC>(d, rstd, load_raw<T, VEC>(r.scale + c),
                                                         load_raw<T, VEC>(r.bias + c)));
    }
}

template <typename T, int VEC, int ITER, bool RES>
cudaError_t launch_warp(const Args& a, int rows_per_block, cudaStream_t s) {
    if constexpr (ITER * VEC > MAX_HELD) {
        return cudaErrorInvalidValue;
    } else {
        if (a.D > ITER * 32 * VEC) return cudaErrorInvalidValue;
        const int grid = (a.rows + rows_per_block - 1) / rows_per_block;
        layer_norm_rows_warp<T, VEC, ITER, RES><<<grid, 32 * rows_per_block, 0, s>>>(a);
        return cudaSuccess;
    }
}

template <typename T, int VEC, bool RES>
cudaError_t launch_vec(const Args& a, int iters, int rows_per_block, int block_variant,
                       cudaStream_t s) {
    if (block_variant) {
        const size_t smem = (static_cast<size_t>(a.D) + 64) * sizeof(float);
        auto kernel = layer_norm_rows_block<T, VEC, RES>;
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
            if (e != cudaSuccess) return e;
        }
        kernel<<<a.rows, BLOCK_THREADS, smem, s>>>(a);
        return cudaSuccess;
    }
    switch (iters) {
        case 1: return launch_warp<T, VEC, 1, RES>(a, rows_per_block, s);
        case 2: return launch_warp<T, VEC, 2, RES>(a, rows_per_block, s);
        case 3: return launch_warp<T, VEC, 3, RES>(a, rows_per_block, s);
        case 4: return launch_warp<T, VEC, 4, RES>(a, rows_per_block, s);
        case 5: return launch_warp<T, VEC, 5, RES>(a, rows_per_block, s);
        case 6: return launch_warp<T, VEC, 6, RES>(a, rows_per_block, s);
        case 8: return launch_warp<T, VEC, 8, RES>(a, rows_per_block, s);
        case 10: return launch_warp<T, VEC, 10, RES>(a, rows_per_block, s);
        case 12: return launch_warp<T, VEC, 12, RES>(a, rows_per_block, s);
        case 16: return launch_warp<T, VEC, 16, RES>(a, rows_per_block, s);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T, bool RES>
cudaError_t launch(const Args& a, int vec, int iters, int rows_per_block, int block_variant,
                   cudaStream_t s) {
    constexpr int FULL = 16 / sizeof(T);
    if (vec == FULL) return launch_vec<T, FULL, RES>(a, iters, rows_per_block, block_variant, s);
    if (vec == 1) return launch_vec<T, 1, RES>(a, iters, rows_per_block, block_variant, s);
    return cudaErrorInvalidValue;
}

}  // namespace

// ln = LN(x) (residual 0) or y = x + delta, ln = LN(y) (residual 1) over
// [rows, D] contiguous rows of f32 (bf16 0) or bf16 (bf16 1); scale and
// bias [D] of the same dtype.  The plan (vec, iters, rows_per_block,
// block_variant) is ops/encoder_fused.py::ln_launch_plan's.
extern "C" int layer_norm_rows(const void* x, const void* delta, const void* scale,
                               const void* bias, void* y, void* ln, int rows, int D, float eps,
                               int is_bf16, int residual, int vec, int iters, int rows_per_block,
                               int block_variant, void* stream) {
    if (rows < 1 || D < 1 || vec < 1 || D % vec || (!block_variant && (rows_per_block < 1 ||
                                                              32 * rows_per_block > BLOCK_THREADS)))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{x, delta, scale, bias, y, ln, rows, D, eps};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (is_bf16)
        err = residual ? launch<bf16, true>(a, vec, iters, rows_per_block, block_variant, s)
                       : launch<bf16, false>(a, vec, iters, rows_per_block, block_variant, s);
    else
        err = residual ? launch<float, true>(a, vec, iters, rows_per_block, block_variant, s)
                       : launch<float, false>(a, vec, iters, rows_per_block, block_variant, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
