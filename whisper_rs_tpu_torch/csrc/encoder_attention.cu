// Encoder self-attention, non-causal:
// out = softmax(q k^T * scale, keys j >= n_valid masked) v, per head.
//
// Replaces two TPU kernels of whisper_rs_tpu/ops/encoder_attention_pallas.py
// with one device body:
//   * encoder_attention_merged (body _attn_kernel_merged): the merged
//     [B, T, D] layout, head dim 64, head h the column block h*64 of every
//     row, so no head split or merge copies exist (entry points
//     encoder_attention_bf16 / _f32);
//   * encoder_attention_pallas (body _attn_kernel): the split [B, H, T, dh]
//     layout, at the head dims the port instantiates, 16 (the golden test
//     dims) and 64 (every registry model), passed as strides, so the split
//     heads may be a view of the merged [B, T, D] projections with no copy
//     (entry points encoder_attention_split_bf16 / _f32).
// The body takes the layout as strides (batch, head, row pitch) and the head
// dim as a template parameter.  Keys past n_valid and the ragged tail past T
// are masked inside the kernel, so T = 1500 needs no padding to 1536.
//
// Bound on the H100: operations in bf16.  4 * B * H * T^2 * dh FLOP (5.9e11
// a layer at base.en b128) against 4 * B * H * T * dh * 2 bytes of q, k, v
// and out (0.79 GB): about 0.60 ms at 989 TFLOP/s against 0.23 ms at 3.35
// TB/s (the H100 SXM data-sheet peaks, at its 700 W power limit).  At head
// dim 16 a score costs as much softmax work (exp, max, sum) as at 64 for a
// quarter of the products, so the exponentials, not the tensor cores, bound
// the small head dims in practice.
//
// Design (bf16): flash-style, one block of 4 warps per (64-query tile, head,
// batch row); each warp owns 16 queries, keeps its Q fragments in registers
// and walks the keys in tiles of 64 staged through shared memory (K as is,
// V transposed).  Q K^T and P V run on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate): DH / 16 k-steps a score tile (one at
// dh 16), DH / 8 output tiles of 8 (two at dh 16).  The softmax is online in
// f32 on the accumulator registers, whose layout is the A-operand layout of
// the next product, so P never leaves registers.  As on the TPU, P is
// rounded to bf16 before P V while the row sum stays f32.  The shared-memory
// row pitches (DH + 8 and 64 + 8 bf16) put the 8 rows a fragment read
// touches on 8 distinct groups of 4 banks at every instantiated DH.  Simple
// first: no cp.async or TMA pipelining and no wgmma yet.
//
// Design (f32, the parity variant): one thread per query with q and the
// output row in registers, K/V tiles of 32 keys in shared memory read as
// broadcasts, f32 FMA only (no TF32), online softmax per tile.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;          // queries per block, 16 per warp
constexpr int BK = 64;          // keys per shared-memory tile
constexpr int THREADS = 128;
constexpr int VPAD = BK + 8;    // row pitch of V^T in shared memory

// Where one (batch row, head) of q, k, v and out starts, and the distance
// between two of its rows, in elements.
struct Layout {
    long long batch, head;
    int row;
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int T, Layout lay,
                 float scale_log2, int n_valid) {
    constexpr int KPAD = DH + 8;  // row pitch of K in shared memory
    constexpr int KS = DH / 16;   // k-steps of Q K^T
    constexpr int NO = DH / 8;    // n8 tiles of the output
    constexpr int VEC = DH / 8;   // 16-byte vectors a K/V row
    __shared__ __align__(16) bf16 Ks[BK][KPAD];
    __shared__ __align__(16) bf16 Vt[DH][VPAD];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const size_t base = (size_t)b * lay.batch + (size_t)h * lay.head;
    const size_t pitch = lay.row;
    const bf16* qb = q + base;
    const bf16* kb = k + base;
    const bf16* vb = v + base;

    // A fragments of this warp's 16 queries, KS steps of 16 along dh.
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    uint32_t qa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
        const int c = kk * 16 + t * 2;
        qa[kk][0] = r0 < T ? ld32(qb + r0 * pitch + c) : 0u;
        qa[kk][1] = r1 < T ? ld32(qb + r1 * pitch + c) : 0u;
        qa[kk][2] = r0 < T ? ld32(qb + r0 * pitch + c + 8) : 0u;
        qa[kk][3] = r1 < T ? ld32(qb + r1 * pitch + c + 8) : 0u;
    }

    float oacc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) oacc[n][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max (log2 units), rows g, g+8
    float l[2] = {0.f, 0.f};              // running sum, this thread's columns

    for (int k0 = 0; k0 < n_valid; k0 += BK) {
        __syncthreads();  // the previous tile has been consumed
        for (int i = threadIdx.x; i < BK * VEC; i += THREADS) {
            const int kr = i / VEC, c = (i % VEC) * 8;
            uint4 kvec = make_uint4(0u, 0u, 0u, 0u), vvec = kvec;
            if (k0 + kr < T) {
                kvec = *reinterpret_cast<const uint4*>(kb + (k0 + kr) * pitch + c);
                vvec = *reinterpret_cast<const uint4*>(vb + (k0 + kr) * pitch + c);
            }
            *reinterpret_cast<uint4*>(&Ks[kr][c]) = kvec;
            const bf16* ve = reinterpret_cast<const bf16*>(&vvec);
#pragma unroll
            for (int e = 0; e < 8; ++e) Vt[c + e][kr] = ve[e];
        }
        __syncthreads();

        // S = Q K^T for 16 queries x 64 keys (8 tiles of 8 keys).
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
                const uint32_t b0 = ld32(&Ks[n * 8 + g][kk * 16 + t * 2]);
                const uint32_t b1 = ld32(&Ks[n * 8 + g][kk * 16 + 8 + t * 2]);
                mma_bf16(s[n], qa[kk], b0, b1);
            }
        }

        // Scale, mask, and the online softmax update.
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int j = k0 + n * 8 + t * 2 + (i & 1);
                const float val = j < n_valid ? s[n][i] * scale_log2 : -INFINITY;
                s[n][i] = val;
                mx[i >> 1] = fmaxf(mx[i >> 1], val);
            }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            alpha[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (m = -inf)
            m[r] = mx[r];
            l[r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) oacc[n][i] *= alpha[i >> 1];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float p = exp2f(s[n][i] - mx[i >> 1]);
                s[n][i] = p;
                l[i >> 1] += p;
            }

        // O += P V: the S accumulators are P's A fragments.
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t b0 = ld32(&Vt[n * 8 + g][kk * 16 + t * 2]);
                const uint32_t b1 = ld32(&Vt[n * 8 + g][kk * 16 + 8 + t * 2]);
                mma_bf16(oacc[n], pa[kk], b0, b1);
            }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.f / l[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        const int c = n * 8 + t * 2;
        if (r0 < T)
            *reinterpret_cast<uint32_t*>(o + base + r0 * pitch + c) =
                pack_bf16(oacc[n][0] * l[0], oacc[n][1] * l[0]);
        if (r1 < T)
            *reinterpret_cast<uint32_t*>(o + base + r1 * pitch + c) =
                pack_bf16(oacc[n][2] * l[1], oacc[n][3] * l[1]);
    }
}

constexpr int F_BQ = 128;  // queries per block, one per thread
constexpr int F_BK = 32;   // keys per shared-memory tile

template <int DH>
__global__ void __launch_bounds__(F_BQ)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int T, Layout lay,
                float scale, int n_valid) {
    __shared__ __align__(16) float Ks[F_BK][DH];
    __shared__ __align__(16) float Vs[F_BK][DH];

    const int b = blockIdx.z, h = blockIdx.y;
    const int row = blockIdx.x * F_BQ + threadIdx.x;
    const bool live = row < T;
    const size_t base = (size_t)b * lay.batch + (size_t)h * lay.head;
    const size_t pitch = lay.row;

    float qr[DH], acc[DH];
#pragma unroll
    for (int d = 0; d < DH; d += 4) {
        const float4 x = live ? load4(q + base + row * pitch + d) : make_float4(0.f, 0.f, 0.f, 0.f);
        qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
        acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
    }
    float m = -INFINITY, l = 0.f;

    for (int k0 = 0; k0 < n_valid; k0 += F_BK) {
        __syncthreads();
        for (int i = threadIdx.x; i < F_BK * DH / 4; i += F_BQ) {
            const int kr = i / (DH / 4), c = (i % (DH / 4)) * 4;
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
            if (k0 + kr < T) {
                kv = load4(k + base + (k0 + kr) * pitch + c);
                vv = load4(v + base + (k0 + kr) * pitch + c);
            }
            *reinterpret_cast<float4*>(&Ks[kr][c]) = kv;
            *reinterpret_cast<float4*>(&Vs[kr][c]) = vv;
        }
        __syncthreads();

        float s[F_BK];
        float mx = m;
#pragma unroll
        for (int j = 0; j < F_BK; ++j) {
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < DH; d += 4) {
                const float4 kv = *reinterpret_cast<const float4*>(&Ks[j][d]);
                dot = fmaf(qr[d], kv.x, dot);
                dot = fmaf(qr[d + 1], kv.y, dot);
                dot = fmaf(qr[d + 2], kv.z, dot);
                dot = fmaf(qr[d + 3], kv.w, dot);
            }
            s[j] = k0 + j < n_valid ? dot * scale : -INFINITY;
            mx = fmaxf(mx, s[j]);
        }
        const float alpha = expf(m - mx);
        m = mx;
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
        for (int j = 0; j < F_BK; ++j) {
            const float p = expf(s[j] - mx);
            l += p;
#pragma unroll
            for (int d = 0; d < DH; d += 4) {
                const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][d]);
                acc[d] = fmaf(p, vv.x, acc[d]);
                acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
                acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
                acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
            }
        }
    }

    if (live) {
        const float inv = 1.f / l;
#pragma unroll
        for (int d = 0; d < DH; d += 4)
            *reinterpret_cast<float4*>(o + base + row * pitch + d) =
                make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
    }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int T,
                Layout lay, float sm_scale, int n_valid, void* stream) {
    dim3 grid((T + BQ - 1) / BQ, H, B);
    attn_bf16_kernel<DH><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), T, lay,
        sm_scale * 1.4426950408889634f, n_valid);
    return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int T,
               Layout lay, float sm_scale, int n_valid, void* stream) {
    dim3 grid((T + F_BQ - 1) / F_BQ, H, B);
    attn_f32_kernel<DH><<<grid, F_BQ, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), T, lay, sm_scale, n_valid);
    return static_cast<int>(cudaGetLastError());
}

// The split layout [B, H, T, dh] at the strides of lay: the instantiated
// head dims, any other one refused (as the Python predicate refuses it).
template <bool BF16>
int split(const void* q, const void* k, const void* v, void* o, int B, int H, int T, int dh,
          Layout lay, float sm_scale, int n_valid, void* stream) {
    switch (dh) {
#define CASE(D)                                                                          \
    case D:                                                                              \
        return BF16 ? launch_bf16<D>(q, k, v, o, B, H, T, lay, sm_scale, n_valid, stream) \
                    : launch_f32<D>(q, k, v, o, B, H, T, lay, sm_scale, n_valid, stream);
        CASE(16)
        CASE(64)
#undef CASE
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Merged layout.  q, k, v, o: [B, T, D] contiguous, D = H * 64; keys j >=
// n_valid (1 <= n_valid <= T) are masked; sm_scale multiplies q.k.
extern "C" int encoder_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                      int B, int T, int D, int H, float sm_scale,
                                      int n_valid, void* stream) {
    const Layout lay{(long long)T * D, 64, D};
    return launch_bf16<64>(q, k, v, o, B, H, T, lay, sm_scale, n_valid, stream);
}

extern "C" int encoder_attention_f32(const void* q, const void* k, const void* v, void* o,
                                     int B, int T, int D, int H, float sm_scale,
                                     int n_valid, void* stream) {
    const Layout lay{(long long)T * D, 64, D};
    return launch_f32<64>(q, k, v, o, B, H, T, lay, sm_scale, n_valid, stream);
}

// Split layout.  q, k, v, o: [B, H, T, dh], dh 16 or 64, each row of dh
// contiguous, all four at the same strides in elements: batch sb, head sh,
// row sr (a contiguous [B, H, T, dh] has H T dh, T dh, dh; the heads of a
// contiguous [B, T, D] have T D, dh, D); rows 16-byte aligned; n_valid and
// sm_scale as above.
extern "C" int encoder_attention_split_bf16(const void* q, const void* k, const void* v,
                                            void* o, int B, int H, int T, int dh,
                                            long long sb, long long sh, int sr, float sm_scale,
                                            int n_valid, void* stream) {
    return split<true>(q, k, v, o, B, H, T, dh, Layout{sb, sh, sr}, sm_scale, n_valid, stream);
}

extern "C" int encoder_attention_split_f32(const void* q, const void* k, const void* v,
                                           void* o, int B, int H, int T, int dh,
                                           long long sb, long long sh, int sr, float sm_scale,
                                           int n_valid, void* stream) {
    return split<false>(q, k, v, o, B, H, T, dh, Layout{sb, sh, sr}, sm_scale, n_valid, stream);
}
