// One decode step's cross-attention for layer l: G query rows per audio
// share one encoder K/V; out = softmax(q K^T) V, no mask, f32 softmax.
// With int8 K/V and f32 per-position scales ks, vs [L, A, H, Tk]: the
// scores times ks, and the weights times vs, kept in f32.
//
// Replaces: whisper_rs_tpu/ops/decode_attention.py::cross_attention_step
// (kernel body _cross_attn_kernel), both branches.  It reads the same
// fused layout kv [L, A, H, 2, dh, Tk] (K^T and V^T planes), and the
// layer index is a pointer offset, so the cross K/V is never sliced or
// copied per layer.  The rounding points are the reference's: f32 scores
// (int8: times the K scales), max and sum over all Tk keys, weights e / sum
// rounded to the K/V dtype (int8: times the V scales, kept f32), P V summed
// in f32.
//
// Bound on the H100: bytes.  Each step reads the layer's whole K/V,
// A * H * 2 * dh * Tk elements (393 MB at base.en b128 bf16, about 117 us
// at the H100 SXM data-sheet 3.35 TB/s, 700 W power limit; in int8 197 MB
// plus 12 MB of scales, about 62 us), for only 4 * G FLOP per element read,
// so the products stay on the FMA pipes.  At batch 1 (transcription: A 1,
// 8 heads, G 5) one block a head leaves 124 of 132 SMs idle, each block
// streaming 384 KB alone.
//
// Design: the keys of a (head, audio, chunk of up to 8 rows) are split over
// the S blocks of one thread-block cluster: grid (S, H, A ceil(G / 8)),
// cluster (S, 1, 1) (no cluster at S = 1).  The host's plan (ops/
// decode_attention.py::cross_launch_plan) sets S (1 where the heads alone
// fill the card or a head's K/V is small, 8 at batch 1), the rows of a
// tile and the depth of the ring.  A block streams its split's rows of
// K^T, then of V^T, a tile at a time, through a ring in shared memory
// filled by the TMA engine.  A [dh, Tk] plane's row pitch (3000 bytes in
// bf16, 1500 in int8) is no multiple of 16, so no tensor map fits.  At S =
// 1 a tile's rows are one contiguous span of the plane and go in one bulk
// copy; else one bulk copy a row takes the 16-byte aligned superset of
// the split's keys, and the reads start (address & 15) bytes into the row
// (the plane size is a multiple of 16, so the superset stays inside the
// plane).  The engine takes about as long for a short copy as for a long
// one, so the fewer the better (at the golden dims, one split and one copy
// a tile beat eight splits: `chip_study.py plans`).  The first V tiles are in flight while the block computes its
// last scores and while the cluster agrees on the softmax statistics:
// each block's per-row max (taken as the last tile's scores are summed),
// then its per-row sum of e = exp(s - max), are read by every block of the
// cluster over distributed shared memory and combined in rank order, so
// every block normalises with the same global max and sum and rounds
// where the reference does (no flash-decoding rescale).  Scores: a thread
// takes a quad of keys and as few subsets of the rows as keep the block
// busy, so each K value is read once for all its rows (int8: turned into
// f32 once, by the integer pipe, and the K scales read under the FMAs);
// P V: a warp a row of V^T, its lanes quads of keys.  Each block's
// partial [G, dh] is summed over the cluster in rank order, each block
// writing one slice of the output.  No atomics and one launch: the output
// is bit-identical call to call.  The head dim is a template parameter,
// instantiated at 64 (every registry model) and 16 (the golden test
// dims); the entry points refuse any other.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STAGES = 8;    // stages of the ring (the host plans how many)
constexpr int MAX_SPLITS = 8;    // the portable cluster size
constexpr int MAX_GM = 8;        // rows a block
constexpr int SMEM_MAX = 227 * 1024;

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(bf16 x) { return __bfloat162float(x); }

// A tile row in shared memory: the split's keys and room for the 16-byte
// aligned superset of their bytes that is copied.
__host__ __device__ constexpr int row_pitch(int chunk, int esize) {
    return (chunk * esize + 15) / 16 * 16 + 16;
}

// One bulk copy (the TMA engine) of `bytes` (a multiple of 16) from global
// to shared memory, both 16-byte aligned, counted on the barrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar)
        : "memory");
}

// Four consecutive K/V values as f32.  int8 takes the bytes through the
// integer pipe (b + 128 as the low mantissa bits of 2^23) and one add each,
// not the quarter-rate int-to-float conversion.
template <typename C>
__device__ __forceinline__ float4 kv4(const C* p) { return load4(p); }
template <>
__device__ __forceinline__ float4 kv4<int8_t>(const int8_t* p) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
    const float bias = 8388736.f;  // 2^23 + 128
    return make_float4(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650)) - bias,
                       __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7651)) - bias,
                       __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7652)) - bias,
                       __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7653)) - bias);
}

// T: the query and output dtype; C: the K/V's (T, or int8 with the scales
// ksc, vsc).  GM: rows a block.  The f32 instances may take every register
// they need (ptxas spilled them at its default target); the bf16 ones keep
// two blocks a SM.
template <int DH, typename T, typename C, int GM>
__global__ void __launch_bounds__(THREADS, std::is_same<T, float>::value ? 1 : 2)
cross_attn_kernel(const T* __restrict__ q, const C* __restrict__ kv,
                  const float* __restrict__ ksc, const float* __restrict__ vsc,
                  T* __restrict__ out, int A, int G_all, int H, int Tk, int layer, int chunk,
                  int tr, int stages) {
    constexpr bool INT8 = std::is_same<C, int8_t>::value;
    extern __shared__ __align__(16) unsigned char smem[];
    const int rp = row_pitch(chunk, sizeof(C)), stage_bytes = tr * rp;
    const int nt = DH / tr;  // tiles a plane
    float* sc = reinterpret_cast<float*>(smem + stages * stage_bytes);  // [G][chunk]
    __shared__ float qs[GM][DH];
    __shared__ float red[GM][WARPS];
    __shared__ float xmax[GM], xsum[GM];  // this block's statistics, read by the cluster
    __shared__ float gmax[GM], gsum[GM];  // the cluster's
    __shared__ float part[GM][DH];        // this block's partial output
    __shared__ __align__(8) uint64_t full[MAX_STAGES];

    cg::cluster_group cluster = cg::this_cluster();
    const int S = gridDim.x, rank = blockIdx.x;  // the cluster spans x: rank = split
    const int h = blockIdx.y;
    const int n_chunks = (G_all + GM - 1) / GM;
    const int a = blockIdx.z / n_chunks, g0 = (blockIdx.z % n_chunks) * GM;
    const int G = min(GM, G_all - g0);
    const size_t row0 = (size_t)a * G_all + g0;
    const int k0 = rank * chunk, nk = min(chunk, Tk - k0);  // nk > 0, a multiple of 4
    const int nq = nk / 4;                                   // quads of keys
    const C* kt = kv + ((((size_t)layer * A + a) * H + h) * 2) * DH * Tk + k0;  // K^T [dh, Tk]
    const C* vt = kt + (size_t)DH * Tk;                                          // V^T [dh, Tk]
    const size_t srow = (((size_t)layer * A + a) * H + h) * Tk + k0;  // this split's scales
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int st = 0; st < stages; ++st) mbar_init(smem_addr(&full[st]), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // Tile i holds rows tr (i % nt) .. of K^T (i < nt) or V^T.  With one
    // split the tile is one contiguous span of the plane (tr rows of Tk
    // keys, a multiple of 16 bytes from a 16-byte boundary), copied whole and
    // kept at the plane's pitch.  Else row r's keys are copied from the
    // 16-byte boundary at or below the first, so they lie (address & 15)
    // bytes into the row in shared memory; the plane size is a multiple of
    // 16, so K^T and V^T rows share their offsets.  Each bulk copy costs the
    // TMA engine about the same whatever its size, so fewer are faster.
    const bool whole = S == 1;
    const uint32_t kt_lo = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(kt));
    const uint32_t row_bytes = static_cast<uint32_t>(Tk * sizeof(C));
    const uint32_t seg_bytes = static_cast<uint32_t>(nk * sizeof(C));
    auto shift = [&](int d) { return (kt_lo + (uint32_t)d * row_bytes) & 15; };
    // Warp 0 issues tile i into stage i % stages: one bulk copy, or one a
    // row (of the 16-byte aligned superset of its bytes).
    auto issue = [&](int i) {
        if (warp != 0 || i >= 2 * nt) return;
        const int d0 = tr * (i % nt);
        const unsigned char* plane = reinterpret_cast<const unsigned char*>(i < nt ? kt : vt);
        const uint32_t dst = smem_addr(smem + (i % stages) * stage_bytes);
        const uint32_t bar = smem_addr(&full[i % stages]);
        if (whole) {
            if (lane == 0) {
                mbar_expect_tx(bar, tr * row_bytes);
                bulk_copy(dst, plane + (size_t)d0 * row_bytes, tr * row_bytes, bar);
            }
            return;
        }
        uint32_t bytes = 0;
        for (int r = lane; r < tr; r += 32) bytes += (shift(d0 + r) + seg_bytes + 15) & ~15u;
        bytes = __reduce_add_sync(0xffffffffu, bytes);
        if (lane == 0) mbar_expect_tx(bar, bytes);
        __syncwarp();
        for (int r = lane; r < tr; r += 32) {
            const uint32_t sh = shift(d0 + r);
            bulk_copy(dst + r * rp, plane + (size_t)(d0 + r) * row_bytes - sh,
                      (sh + seg_bytes + 15) & ~15u, bar);
        }
    };
    for (int i = 0; i < stages - 1; ++i) issue(i);

    for (int i = threadIdx.x; i < G * DH; i += THREADS) {
        const int g = i / DH, d = i % DH;
        qs[g][d] = as_float(q[((row0 + g) * H + h) * DH + d]);
    }

    for (int i = 0; i < 2 * nt; ++i) {
        __syncthreads();  // tile i - 1 is consumed: its stage may be refilled
        issue(i + stages - 1);
        mbar_wait(smem_addr(&full[i % stages]), (i / stages) & 1);
        const int d0 = tr * (i % nt);
        // row r of this tile in shared memory
        const unsigned char* tile = smem + (i % stages) * stage_bytes;
        const uint32_t sh0 = shift(d0), step = row_bytes & 15;
        auto row_of = [&](int r) {
            return reinterpret_cast<const C*>(whole ? tile + r * row_bytes
                                                    : tile + r * rp + ((sh0 + r * step) & 15));
        };

        if (i < nt) {
            // Scores, added to the sums of the tiles before (kept in sc);
            // after the last tile's, each thread's max of each row
            // (int8: of the scores times the K scales).
            const bool last = i == nt - 1;
            float mx[GM];
#pragma unroll
            for (int g = 0; g < GM; ++g) mx[g] = -INFINITY;
            // A thread takes a quad of keys and the rows g = gs, gs + n_gs,
            // ... (as few subsets of the rows as keep the block busy), so
            // each K value is read (int8: converted) once for all its rows;
            // NJ bounds the rows a thread takes (1 where n_gs = G).
            const int n_gs = max(1, min(G, THREADS / nq));
            auto quad = [&](auto nj, int gs, int jq) {
                constexpr int NJ = decltype(nj)::value;
                float4 k4s = make_float4(1.f, 1.f, 1.f, 1.f);  // int8: in flight under the FMAs
                if (INT8 && last) k4s = *reinterpret_cast<const float4*>(ksc + srow + 4 * jq);
                float4 s[NJ];
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const int g = gs + j * n_gs;
                    s[j] = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (g < G && i > 0)
                        s[j] = *reinterpret_cast<const float4*>(&sc[g * chunk + 4 * jq]);
                }
#pragma unroll 8
                for (int r = 0; r < tr; ++r) {
                    const float4 k4 = kv4(row_of(r) + 4 * jq);
#pragma unroll
                    for (int j = 0; j < NJ; ++j) {
                        const int g = gs + j * n_gs;
                        if (g < G) {
                            const float qv = qs[g][d0 + r];
                            s[j].x = fmaf(qv, k4.x, s[j].x);
                            s[j].y = fmaf(qv, k4.y, s[j].y);
                            s[j].z = fmaf(qv, k4.z, s[j].z);
                            s[j].w = fmaf(qv, k4.w, s[j].w);
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const int g = gs + j * n_gs;
                    if (g < G) {
                        if (last) {
                            if (INT8) {
                                s[j].x *= k4s.x;
                                s[j].y *= k4s.y;
                                s[j].z *= k4s.z;
                                s[j].w *= k4s.w;
                            }
                            const float m4 = fmaxf(fmaxf(s[j].x, s[j].y), fmaxf(s[j].z, s[j].w));
#pragma unroll
                            for (int gg = 0; gg < GM; ++gg)
                                if (gg == g) mx[gg] = fmaxf(mx[gg], m4);
                        }
                        *reinterpret_cast<float4*>(&sc[g * chunk + 4 * jq]) = s[j];
                    }
                }
            };
            if (n_gs >= G) {
                for (int idx = threadIdx.x; idx < G * nq; idx += THREADS)
                    quad(std::integral_constant<int, 1>{}, idx / nq, idx % nq);
            } else {
                for (int idx = threadIdx.x; idx < n_gs * nq; idx += THREADS)
                    quad(std::integral_constant<int, GM>{}, idx / nq, idx % nq);
            }
            if (last) {
                // The scores are whole (int8: times the K scales).  The
                // cluster's max of each row: this block's, then every
                // block's over distributed shared memory.
#pragma unroll
                for (int g = 0; g < GM; ++g) {
                    const float m = warp_max(mx[g]);
                    if (lane == 0) red[g][warp] = m;
                }
                __syncthreads();
                if (threadIdx.x < GM) {
                    float m = -INFINITY;
                    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red[threadIdx.x][w]);
                    xmax[threadIdx.x] = m;
                }
                if (S > 1) cluster.sync(); else __syncthreads();
                if (threadIdx.x < GM) {
                    float m = -INFINITY;
                    for (int r = 0; r < S; ++r)
                        m = fmaxf(m, S > 1 ? cluster.map_shared_rank(xmax, r)[threadIdx.x]
                                           : xmax[threadIdx.x]);
                    gmax[threadIdx.x] = m;
                }
                __syncthreads();
                // e = exp(s - max) and this block's sums, then the cluster's,
                // summed in rank order so every block has the same sum.
#pragma unroll
                for (int g = 0; g < GM; ++g) {
                    float t = 0.f;
                    if (g < G) {
                        const float m = gmax[g];
                        for (int jq = threadIdx.x; jq < nq; jq += THREADS) {
                            float4* p = reinterpret_cast<float4*>(&sc[g * chunk + 4 * jq]);
                            float4 e = *p;
                            e.x = expf(e.x - m);
                            e.y = expf(e.y - m);
                            e.z = expf(e.z - m);
                            e.w = expf(e.w - m);
                            *p = e;
                            t += e.x;
                            t += e.y;
                            t += e.z;
                            t += e.w;
                        }
                    }
                    t = warp_sum(t);
                    if (lane == 0) red[g][warp] = t;
                }
                __syncthreads();
                if (threadIdx.x < GM) {
                    float t = 0.f;
                    for (int w = 0; w < WARPS; ++w) t += red[threadIdx.x][w];
                    xsum[threadIdx.x] = t;
                }
                if (S > 1) cluster.sync(); else __syncthreads();
                if (threadIdx.x < GM) {
                    float t = 0.f;
                    for (int r = 0; r < S; ++r)
                        t += S > 1 ? cluster.map_shared_rank(xsum, r)[threadIdx.x]
                                   : xsum[threadIdx.x];
                    gsum[threadIdx.x] = t;
                }
                __syncthreads();
                // The weights e / sum, rounded as the reference rounds them
                // (int8: times the V scales, a quad of them read once for
                // every row).
#pragma unroll 2
                for (int jq = threadIdx.x; jq < nq; jq += THREADS) {
                    float4 v4 = make_float4(1.f, 1.f, 1.f, 1.f);
                    if (INT8) v4 = *reinterpret_cast<const float4*>(vsc + srow + 4 * jq);
#pragma unroll
                    for (int g = 0; g < GM; ++g) {
                        if (g < G) {
                            const float t = gsum[g];
                            float4* p = reinterpret_cast<float4*>(&sc[g * chunk + 4 * jq]);
                            float4 w = *p;
                            w.x /= t;
                            w.y /= t;
                            w.z /= t;
                            w.w /= t;
                            if (INT8) {
                                w.x *= v4.x;
                                w.y *= v4.y;
                                w.z *= v4.z;
                                w.w *= v4.w;
                            } else {
                                w.x = round_to<T>(w.x);
                                w.y = round_to<T>(w.y);
                                w.z = round_to<T>(w.z);
                                w.w = round_to<T>(w.w);
                            }
                            *p = w;
                        }
                    }
                }
                // the next tile's barrier orders these writes before P V
            }
        } else {
            // P V: warp w takes rows d0 + w, d0 + w + WARPS, ... of V^T, its
            // lanes quads of keys; the lanes' sums are added in a fixed
            // order, and each row's partial is sent to the block that
            // writes it (rank d % S).
            for (int r = warp; r < tr; r += WARPS) {
                const C* row = row_of(r);
                float acc[GM];
#pragma unroll
                for (int g = 0; g < GM; ++g) acc[g] = 0.f;
                for (int jq = lane; jq < nq; jq += 32) {
                    const float4 v = kv4(row + 4 * jq);
#pragma unroll
                    for (int g = 0; g < GM; ++g) {
                        if (g < G) {
                            const float4 w =
                                *reinterpret_cast<const float4*>(&sc[g * chunk + 4 * jq]);
                            float t = acc[g];
                            t = fmaf(w.x, v.x, t);
                            t = fmaf(w.y, v.y, t);
                            t = fmaf(w.z, v.z, t);
                            t = fmaf(w.w, v.w, t);
                            acc[g] = t;
                        }
                    }
                }
#pragma unroll
                for (int g = 0; g < GM; ++g) {
                    const float t = warp_sum(acc[g]);
                    if (lane == 0) part[g][d0 + r] = t;
                }
            }
        }
    }

    // This block's partial [G, dh] is in part; the cluster's sum in rank
    // order, each block one slice of the output.
    if (S > 1) cluster.sync(); else __syncthreads();
    for (int idx = rank * THREADS + threadIdx.x; idx < G * DH; idx += S * THREADS) {
        const int g = idx / DH, d = idx % DH;
        float t = 0.f;
        for (int r = 0; r < S; ++r)
            t += S > 1 ? cluster.map_shared_rank(&part[0][0], r)[g * DH + d] : part[g][d];
        out[((row0 + g) * H + h) * DH + d] = from_float<T>(t);
    }
    if (S > 1) cluster.sync();  // no block leaves while another reads its partial
}

// A block's dynamic shared memory: the ring and the scores of its rows.
template <typename C, int GM>
size_t dynamic_smem(int G, int chunk, int tr, int stages) {
    return (size_t)stages * tr * row_pitch(chunk, sizeof(C)) + (size_t)(G < GM ? G : GM) * chunk * 4;
}

template <int DH, typename T, typename C, int GM>
int launch(const void* q, const void* kv, const void* ksc, const void* vsc, void* out, int A,
           int G, int H, int Tk, int layer, int splits, int chunk, int tr, int stages,
           cudaStream_t stream) {
    if (tr < 8 || tr % 8 || DH % tr) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = cross_attn_kernel<DH, T, C, GM>;
    static cudaFuncAttributes fa = {};
    static size_t sized = 0;  // raised once per size, outside any graph capture
    if (!sized) {
        cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const size_t smem = dynamic_smem<C, GM>(G, chunk, tr, stages);
    if (smem + fa.sharedSizeBytes > (size_t)SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > sized) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        sized = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, H, A * ((G + GM - 1) / GM));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = splits > 1;  // one split: no cluster to schedule
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                                       static_cast<const C*>(kv), static_cast<const float*>(ksc),
                                       static_cast<const float*>(vsc), static_cast<T*>(out), A, G,
                                       H, Tk, layer, chunk, tr, stages);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

template <int DH, typename T, typename C>
int by_rows(const void* q, const void* kv, const void* ksc, const void* vsc, void* out, int A,
            int G, int H, int Tk, int layer, int splits, int chunk, int tr,
            int stages, cudaStream_t s) {
#define LAUNCH(GM) \
    launch<DH, T, C, GM>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, splits, chunk, tr, stages, s)
    if (G == 1) return LAUNCH(1);
    if (G <= 2) return LAUNCH(2);
    if (G <= 4) return LAUNCH(4);
    return LAUNCH(MAX_GM);
#undef LAUNCH
}

// The instantiated head dims, 16 and 64; any other dh is refused, and so is
// a plan that does not cover [0, Tk) in splits of a multiple of 4 keys with
// none empty, or whose ring does not fit.
template <typename T, typename C>
int dispatch(const void* q, const void* kv, const void* ksc, const void* vsc, void* out, int A,
             int G, int H, int Tk, int layer, int dh, int splits, int chunk, int tr,
             int stages, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (G < 1 || Tk % 4 || splits < 1 || splits > MAX_SPLITS || chunk < 4 || chunk % 4 ||
        (long long)splits * chunk < Tk || (long long)(splits - 1) * chunk >= Tk ||
        stages < 2 || stages > MAX_STAGES)
        return static_cast<int>(cudaErrorInvalidValue);
    if (dh == 64)
        return by_rows<64, T, C>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, splits, chunk, tr, stages, s);
    if (dh == 16)
        return by_rows<16, T, C>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, splits, chunk, tr, stages, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The shared memory of one block of the instance (dh, esize, GM for G):
// dynamic and static, or -1.
template <int DH, typename C>
int smem_of(int G, int chunk, int tr, int stages) {
    using T = std::conditional_t<std::is_same<C, float>::value, float, bf16>;  // a built pair
    cudaFuncAttributes fa = {};
#define SMEM(GM)                                                                 \
    (cudaFuncGetAttributes(&fa, cross_attn_kernel<DH, T, C, GM>) != cudaSuccess   \
         ? -1                                                                    \
         : static_cast<int>(dynamic_smem<C, GM>(G, chunk, tr, stages) + fa.sharedSizeBytes))
    if (G == 1) return SMEM(1);
    if (G <= 2) return SMEM(2);
    if (G <= 4) return SMEM(4);
    return SMEM(MAX_GM);
#undef SMEM
}

}  // namespace

// Shared memory a block takes at a plan (G rows an audio, keys `chunk` a
// split, tiles of tr rows, `stages` deep) for head dim dh and K/V of esize
// bytes (1: int8, 2: bf16, 4: f32), static arrays included; -1 for an
// instance that is not built.  The host's plan is held to it.
extern "C" int cross_smem_bytes(int dh, int esize, int G, int chunk, int tr, int stages) {
    if (G < 1 || (dh != 16 && dh != 64)) return -1;
    if (esize == 1) return dh == 64 ? smem_of<64, int8_t>(G, chunk, tr, stages)
                                    : smem_of<16, int8_t>(G, chunk, tr, stages);
    if (esize == 2) return dh == 64 ? smem_of<64, bf16>(G, chunk, tr, stages)
                                    : smem_of<16, bf16>(G, chunk, tr, stages);
    if (esize == 4) return dh == 64 ? smem_of<64, float>(G, chunk, tr, stages)
                                    : smem_of<16, float>(G, chunk, tr, stages);
    return -1;
}

// q: [A, G, H, dh] pre-scaled; kv: [L, A, H, 2, dh, Tk] with Tk % 4 == 0;
// out: [A, G, H, dh]; dh 16 or 64; all contiguous, 16-byte aligned; G >= 1.
// splits, chunk, tr, stages: the launch plan (ops/decode_attention.py::
// cross_launch_plan): split s takes keys [s chunk, min(Tk, (s + 1) chunk)),
// through a ring of `stages` tiles of tr rows (a multiple of 8 dividing dh).
extern "C" int cross_attention_bf16(const void* q, const void* kv, void* out, int A, int G,
                                    int H, int Tk, int layer, int dh, int splits, int chunk,
                                    int tr, int stages, void* stream) {
    return dispatch<bf16, bf16>(q, kv, nullptr, nullptr, out, A, G, H, Tk, layer, dh, splits,
                                chunk, tr, stages, stream);
}

extern "C" int cross_attention_f32(const void* q, const void* kv, void* out, int A, int G,
                                   int H, int Tk, int layer, int dh, int splits, int chunk,
                                   int tr, int stages, void* stream) {
    return dispatch<float, float>(q, kv, nullptr, nullptr, out, A, G, H, Tk, layer, dh, splits,
                                  chunk, tr, stages, stream);
}

// As above with kv int8 and its f32 scales ksc, vsc [L, A, H, Tk]
// (contiguous, 16-byte aligned).
extern "C" int cross_attention_int8_bf16(const void* q, const void* kv, const void* ksc,
                                         const void* vsc, void* out, int A, int G, int H, int Tk,
                                         int layer, int dh, int splits, int chunk, int tr,
                                         int stages, void* stream) {
    return dispatch<bf16, int8_t>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, dh, splits, chunk,
                                  tr, stages, stream);
}

extern "C" int cross_attention_int8_f32(const void* q, const void* kv, const void* ksc,
                                        const void* vsc, void* out, int A, int G, int H, int Tk,
                                        int layer, int dh, int splits, int chunk, int tr,
                                        int stages, void* stream) {
    return dispatch<float, int8_t>(q, kv, ksc, vsc, out, A, G, H, Tk, layer, dh, splits, chunk,
                                   tr, stages, stream);
}
