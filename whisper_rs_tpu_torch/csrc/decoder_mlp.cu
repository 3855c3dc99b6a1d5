// One decode step's MLP for one decoder layer, without the fc2 bias:
//   a   = h W1^T + b1          (f32 sum, then rounded to T)
//   g   = gelu(a)              (exact erf in f32, the tanh form in bf16,
//                               computed in f32 and rounded to T)
//   out = g W2^T               (f32 sum, cast to T)
// with h [B, D], W1 = mlp.0.weight [4D, D], b1 [4D], W2 = mlp.2.weight
// [D, 4D], all of the compute dtype T, read in place.
//
// Replaces: whisper_rs_tpu/ops/decoder_mlp_fused.py::decoder_mlp_step
// (kernel body _mlp_kernel).  The TPU kernel streamed both weights as one
// packed [L, 4D, 2D] array over a sequential grid of hidden chunks with one
// VMEM accumulator for fc2.  Packing was a v5e stream-structure finding and
// is not carried over.  Blocks run in parallel and in no order on Hopper,
// so the two products are two launches: fc1 + bias + GELU writes g [B, 4D]
// (123 KB at large-v3 b12, against 26 MB of weights), fc2 reads it.
//
// Bound on the H100 (SXM data sheet, 700 W): the bytes of the two weight
// matrices, 8 D^2 elements (26.2 MB at large-v3 in bf16: 7.8 us at 3.35
// TB/s; 16.8 MB, 5.0 us, at medium.en; 4.2 MB, 1.3 us, at base.en).  The
// products, 16 B D^2 FLOP, take 0.54 us at base.en b128 on the tensor
// cores (989 TFLOP/s) but about 8 us on the f32 FMA pipes, so bf16 must
// run on the tensor cores to approach the byte bound.
//
// Design (bf16): each product is one GEMM C[M, B] = W[M, K] X[B, K]^T with
// the weights on the M side and the batch on the N side ("swap A and B"),
// so a batch of 1-128 rows rounds up to 8 columns, never to 64:
//   * a block has 8 consumer warps over 64 weight rows and 8 NT batch
//     columns (NT in 1..6): warp w takes the 16 rows 16 (w % 4) and half of every
//     stage's depth, so a warp's chain of dependent products is 2 k-steps
//     a stage, not 4; the products are mma.sync m16n8k16, bf16 in, f32
//     accumulate, every fragment of a stage loaded by ldmatrix first;
//   * weight and activation tiles of 64 deep (128-byte rows) arrive
//     through a ring of STAGES shared-memory stages, each filled by two TMA
//     loads (tensor maps over W and x, zeros past M, B and K) that a
//     producer warp issues as soon as the 8 consumer warps have released
//     the stage (a full and an empty mbarrier a stage), so up to 6 stages
//     of the weight stream are in flight while the tensor cores run and no
//     consumer waits for another; TMA's 128-byte swizzle puts ldmatrix's 8
//     rows on distinct banks;
//   * K is split over the blocks of a thread-block cluster (up to 8, grid.x)
//     where the tiles alone are few (fc2 at base.en has 8 tiles of 64
//     rows): about 96 blocks then, each split 4 stages deep or more.  Each
//     block parks its f32 partial tile (its two halves summed) in its
//     shared memory; after a cluster barrier each block sums one slice of
//     the tile over the cluster's partials, read through distributed shared
//     memory in rank order, and runs the epilogue (fc1: bias, read into
//     shared memory before the main loop, round, GELU, round; fc2: cast)
//     there, four rows to one 8-byte store.  No atomics and no extra
//     launch: the sums have a fixed order and a result is the same from run
//     to run.  The cluster's barriers and exchange cost about 1-2 us a
//     launch on the H100, so a shape whose tiles give 32 blocks or more is
//     not split, and more blocks than about 96 (up to the 132 SMs) measured
//     slower at the path shapes (PERF.md);
//   * the launch plan (NT, batch tiles, splits) is worked out on the host
//     by ops/decoder_mlp_fused.py::mlp_launch_plan and passed in; batches
//     above 48 columns take grid.y tiles (48 columns measured faster than
//     64 at base.en b128), weight tiles grid.z.
// Two launches a call, as before: a third (a reduction pass) is not needed
// since the cluster sums the split-K partials on chip.  mma.sync runs at
// about half of wgmma's rate; only base.en b128 (16 B D^2 = 5.4e8 FLOP a
// call) has enough products for that to show.
//
// Design (f32, the parity variant): the FMA pipes, no TF32.  A warp owns
// two weight rows and walks them in chunks of 128 elements, loading 4
// chunks of both rows ahead; for each of up to 16 batch rows it reads the
// matching activation chunk and accumulates f32 FMAs; a butterfly sum per
// output ends it.  grid.y covers the batch in tiles of 16.  A K that is not
// a multiple of 128 takes the TAIL instance, whose lanes past K load zeros.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

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

// ---- bf16: tensor cores, swapped operands, split K over a cluster ----------

constexpr int TC_WARPS = 8;  // consumers: 4 strips of 16 weight rows x 2 halves of a stage
constexpr int TC_THREADS = TC_WARPS * 32 + 32;  // and one producer warp
constexpr int BM = 64;           // weight rows a block
constexpr int BKC = 64;          // depth of a stage: 128-byte rows
constexpr int STAGES = 6;
constexpr int MAX_NT = 6;        // n8 batch tiles a block: 48 columns
constexpr int MAX_SPLITS = 8;    // blocks of a cluster (the portable limit)
constexpr int PART_PITCH = BM + 4;  // f32 row pitch of a parked partial tile

// Byte offset of 16-byte chunk c (0..7) of row r in a tile of 128-byte rows
// on a 1024-byte boundary, as TMA's 128-byte swizzle stores it: the chunk
// XOR the row's low 3 bits, so ldmatrix's 8 rows fall on distinct banks.
__device__ __forceinline__ uint32_t swz(int r, int c) {
    return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// One GEMM of the MLP: out[b, j] = epilogue(sum_k x[b, k] w[j, k]) for the
// block's 64 rows j, 8 NT columns b, and its cluster's split of K.  FC1:
// out = round(gelu(round(sum + bias[j]))) ([B, M] = g); else out = sum.
// tm_w and tm_x are tensor maps over w [M, K] and x [B, K] with boxes of
// 64 x 64 and 64 x 8 NT, 128-byte swizzle, zeros outside.  Warp w takes the
// 16 rows 16 (w % 4) and the half w / 4 of every stage's depth (2 of its 4
// k-steps), so the two halves are summed in the epilogue, first half first.
// grid (splits, batch tiles, row tiles); cluster (splits, 1, 1).
template <int NT, bool FC1>
__global__ void __launch_bounds__(TC_THREADS)
mlp_tc_kernel(const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_x,
              const bf16* __restrict__ bias, bf16* __restrict__ out, int B, int M, int K) {
    constexpr int BN = 8 * NT;
    constexpr int STAGE = (BM + BN) * 128;  // bytes: the weight tile, then the activations'
    extern __shared__ unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
    __shared__ float bias_s[BM];
    const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // tiles 1024-aligned

    const int split = blockIdx.x, splits = gridDim.x;
    const int n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int strip = warp & 3, half = warp >> 2;
    const int nc = (K + BKC - 1) / BKC;
    const int c_begin = split * nc / splits, n_chunks = (split + 1) * nc / splits - c_begin;

    if (threadIdx.x == 0) {
        for (int st = 0; st < STAGES; ++st) {
            mbar_init(smem_addr(&full[st]), 1);
            mbar_init(smem_addr(&empty[st]), TC_WARPS);  // one arrival a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (FC1 && threadIdx.x < BM)  // read now, used by the epilogue
        bias_s[threadIdx.x] = m0 + threadIdx.x < M ? to_float(bias[m0 + threadIdx.x]) : 0.f;
    __syncthreads();  // the barriers are initialised

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

    if (warp == TC_WARPS) {
        // The producer: one thread puts chunk i of this split into stage
        // i % STAGES as soon as the consumers have released it.
        if (lane == 0) {
            for (int i = 0; i < n_chunks; ++i) {
                const int st = i % STAGES, k0 = (c_begin + i) * BKC;
                const uint32_t bar = smem_addr(&full[st]);
                mbar_wait(smem_addr(&empty[st]), ((i / STAGES) & 1) ^ 1);  // round 0 passes
                mbar_expect_tx(bar, STAGE);
                tma_load_2d(base + st * STAGE, &tm_w, bar, k0, m0);
                tma_load_2d(base + st * STAGE + BM * 128, &tm_x, bar, k0, n0);
            }
        }
        __syncwarp();
    } else {
        for (int i = 0; i < n_chunks; ++i) {
            mbar_wait(smem_addr(&full[i % STAGES]), (i / STAGES) & 1);
            const uint32_t sb = base + (i % STAGES) * STAGE;
            // every fragment of this warp's two k-steps first, then the products
            uint32_t a[2][4], bf[2][NT][2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int kk = 2 * half + h;
                ldsm_x4(a[h], sb + swz(strip * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
                for (int j = 0; j < NT; j += 2) {
                    // lanes 0-15: tile j, k halves 0 / 1; lanes 16-31: tile j + 1
                    const int bc = 2 * kk + ((lane >> 3) & 1);
                    if (j + 1 < NT) {
                        uint32_t b4[4];
                        ldsm_x4(b4, sb + swz(BM + 8 * (j + (lane >> 4)) + (lane & 7), bc));
                        bf[h][j][0] = b4[0];
                        bf[h][j][1] = b4[1];
                        bf[h][j + 1][0] = b4[2];
                        bf[h][j + 1][1] = b4[3];
                    } else {
                        ldsm_x2(bf[h][j][0], bf[h][j][1],
                                sb + swz(BM + 8 * j + (lane & 7), bc));
                    }
                }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int j = 0; j < NT; ++j)
                    if (n0 + 8 * j < B)  // columns past the batch are skipped
                        mma_bf16(acc[j], a[h], bf[h][j][0], bf[h][j][1]);
            __syncwarp();
            if (lane == 0) mbar_arrive(smem_addr(&empty[i % STAGES]));  // this warp is done
        }
    }
    __syncthreads();  // every chunk is in and consumed: the stages are free

    // The second half's warps park their partial tile in the stages,
    // part[n][m]; the first half's add theirs to it, first half first.
    float* part = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)));
    {
        const int g = lane >> 2, t = lane & 3, m = strip * 16 + g;
        auto park = [&](auto&& put) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int n = 8 * j + 2 * t;
                put(part[n * PART_PITCH + m], acc[j][0]);
                put(part[(n + 1) * PART_PITCH + m], acc[j][1]);
                put(part[n * PART_PITCH + m + 8], acc[j][2]);
                put(part[(n + 1) * PART_PITCH + m + 8], acc[j][3]);
            }
        };
        if (half == 1) park([](float& dst, float v) { dst = v; });
        __syncthreads();
        if (half == 0) park([](float& dst, float v) { dst = v + dst; });
    }
    cg::cluster_group cluster = cg::this_cluster();
    if (splits > 1)
        cluster.sync();  // every partial of the cluster is parked
    else
        __syncthreads();

    // This block's slice of the tile, four rows j at a time, summed over
    // the splits in rank order (every load issued before the sum).
    const int rank = splits > 1 ? static_cast<int>(cluster.block_rank()) : 0;
    for (int idx = rank * TC_THREADS + threadIdx.x; idx < BN * BM / 4;
         idx += splits * TC_THREADS) {  // the producer warp's threads take a share too
        const int n = idx / (BM / 4), m = (idx % (BM / 4)) * 4;
        const int b = n0 + n;
        if (b >= B || m0 + m >= M) continue;
        float4 pq[MAX_SPLITS];
#pragma unroll
        for (int q = 0; q < MAX_SPLITS; ++q)
            if (q < splits)
                pq[q] = *reinterpret_cast<const float4*>(
                    (splits > 1 ? cluster.map_shared_rank(part, q) : part) + n * PART_PITCH + m);
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < MAX_SPLITS; ++q)
            if (q < splits) {
                sum[0] += pq[q].x;
                sum[1] += pq[q].y;
                sum[2] += pq[q].z;
                sum[3] += pq[q].w;
            }
        // M % 4 == 0: the four rows lie inside M together
        uint2 packed;
        bf16* e = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
            if constexpr (FC1) {
                const float a = round_to<bf16>(sum[k4] + bias_s[m + k4]);
                e[k4] = from_float<bf16>(gelu<bf16>(a));
            } else {
                e[k4] = from_float<bf16>(sum[k4]);
            }
        }
        *reinterpret_cast<uint2*>(out + (size_t)b * M + m0 + m) = packed;
    }
    if (splits > 1) cluster.sync();  // no block leaves while another reads its partial
}

// A tensor map over a row-major [rows, K] bf16 matrix, boxes of box_rows x
// 64, 128-byte swizzle, zeros outside.
bool rows_map(CUtensorMap* map, const bf16* ptr, int rows, int K, int box_rows) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {BKC, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(ptr), dims,
                  strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT, bool FC1>
cudaError_t launch_tc_nt(const bf16* x, const bf16* w, const bf16* bias, bf16* out, int B, int M,
                         int K, int ntiles, int splits, cudaStream_t s) {
    auto kernel = mlp_tc_kernel<NT, FC1>;
    constexpr int smem = STAGES * (BM + 8 * NT) * 128 + 1024;  // + room to align to 1024
    static_assert(smem - 1024 >= 8 * NT * PART_PITCH * 4, "the partial fits in the stages");
    static bool sized = false;  // set once, outside any graph capture
    if (!sized) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        sized = true;
    }
    CUtensorMap tm_w, tm_x;
    if (!rows_map(&tm_w, w, M, K, BM) || !rows_map(&tm_x, x, B, K, 8 * NT))
        return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, ntiles, (M + BM - 1) / BM);
    cfg.blockDim = dim3(TC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, tm_w, tm_x, bias, out, B, M, K);
}

// One GEMM at the host's plan: nt n8 tiles a block, ntiles batch tiles,
// splits of K (the cluster size).
template <bool FC1>
cudaError_t launch_tc(const bf16* x, const bf16* w, const bf16* bias, bf16* out, int B, int M,
                      int K, int nt, int ntiles, int splits, cudaStream_t s) {
    const int nc = (K + BKC - 1) / BKC;
    if (nt < 1 || nt > MAX_NT || ntiles < 1 || (long long)ntiles * 8 * nt < B ||
        (ntiles - 1) * 8 * nt >= B || splits < 1 || splits > MAX_SPLITS || splits > nc ||
        K % 8 || M % 4)
        return cudaErrorInvalidValue;
    switch (nt) {
#define CASE(N) \
    case N:     \
        return launch_tc_nt<N, FC1>(x, w, bias, out, B, M, K, ntiles, splits, s);
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6)
#undef CASE
    }
    return cudaErrorInvalidValue;
}

// ---- f32: the FMA pipes ----------------------------------------------------

template <typename T>
int launch(const void* h, const void* w1, const void* b1, const void* w2, void* g, void* out,
           int B, int D, int H4, void* stream) {
    // whole 4-element loads, and whole warps of ROWS rows over D and the hidden width
    if (B < 1 || D < WARPS * ROWS || D % (WARPS * ROWS) || H4 < WARPS * ROWS ||
        H4 % (WARPS * ROWS))
        return static_cast<int>(cudaErrorInvalidValue);
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

// h, out: [B, D]; w1: [F, D]; b1: [F]; w2: [D, F]; g: [B, F] scratch, F the
// hidden width (4D, or a tensor-parallel shard's 4D / tp); all contiguous,
// 16-byte aligned; D % 8 == 0 and F % 8 == 0.  (nt1, ntiles1, splits1) and
// (nt2, ntiles2, splits2) are fc1's and fc2's launch plans
// (ops/decoder_mlp_fused.py::mlp_launch_plan).
extern "C" int decoder_mlp_bf16(const void* h, const void* w1, const void* b1, const void* w2,
                                void* g, void* out, int B, int D, int H4, int nt1, int ntiles1,
                                int splits1, int nt2, int ntiles2, int splits2, void* stream) {
    if (B < 1 || D < 8 || D % 8 || H4 < 8 || H4 % 8)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = launch_tc<true>(static_cast<const bf16*>(h), static_cast<const bf16*>(w1),
                                      static_cast<const bf16*>(b1), static_cast<bf16*>(g), B, H4,
                                      D, nt1, ntiles1, splits1, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_tc<false>(static_cast<const bf16*>(g), static_cast<const bf16*>(w2), nullptr,
                           static_cast<bf16*>(out), B, D, H4, nt2, ntiles2, splits2, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// The same at f32 on the FMA pipes (no plan: its grid is fixed by shape).
extern "C" int decoder_mlp_f32(const void* h, const void* w1, const void* b1, const void* w2,
                               void* g, void* out, int B, int D, int H4, void* stream) {
    return launch<float>(h, w1, b1, w2, g, out, B, D, H4, stream);
}
