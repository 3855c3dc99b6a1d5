// Encoder self-attention, non-causal:
// out = softmax(q k^T * scale, keys j >= n_valid masked) v, per head.
//
// Replaces two TPU kernels of whisper_rs_tpu/ops/encoder_attention_pallas.py:
//   * encoder_attention_merged (body _attn_kernel_merged): the merged
//     [B, T, D] layout, head dim 64, head h the column block h*64 of every
//     row, so no head split or merge copies exist (entry points
//     encoder_attention_bf16 / _f32);
//   * encoder_attention_pallas (body _attn_kernel): the split [B, H, T, dh]
//     layout, at the head dims the port instantiates, 16 (the golden test
//     dims) and 64 (every registry model), passed as strides, so the split
//     heads may be a view of the merged [B, T, D] projections with no copy
//     (entry points encoder_attention_split_bf16 / _f32).
// Every body takes the layout as strides (batch, head, row pitch).  Keys
// past n_valid and the ragged tail past T are masked inside the kernel, so
// T = 1500 needs no padding to 1536.  As on the TPU, P is rounded to bf16
// before P V while the row sum stays f32.
//
// Bounds on the H100 (SXM data sheet, 700 W), base.en b128, one layer:
//   * tensor cores: 4 B H T^2 dh = 5.9e11 FLOP, 0.60 ms at 989 TFLOP/s;
//   * exponentials: one a score, B H T^2 = 2.3e9; the special-function
//     units do 16 a clock on each of 132 SMs, about 0.6 ms at 1.755 GHz:
//     as long as the products, so the softmax has to overlap them;
//   * bytes: q, k, v and out once, 0.79 GB, 0.23 ms at 3.35 TB/s.
// At head dim 16 a score costs the same softmax work for a quarter of the
// products: the exponentials bound it.
//
// Design (bf16, head dim 64: attn_wgmma_kernel): flash attention for
// Hopper.  A block of three warpgroups takes 128 queries of one (batch
// row, head): warpgroup 0 is the producer, whose one thread keeps a ring of
// 4 shared-memory stages of K and V tiles (128 keys each) full by TMA,
// through tensor maps over the layout's strides (so merged heads and views
// need no copy; rows past T arrive as zeros), with a full and an empty
// mbarrier a stage; warpgroups 1 and 2 are the consumers, 64 queries each,
// with the registers the producer gives up (setmaxnreg).  TMA writes the
// tiles in the 128-byte-swizzled layout of wgmma's descriptors: K as
// stored is the K-major B operand of S = Q K^T (wgmma m64n128k16, Q's A
// fragments in registers), V as stored the transposed (MN-major) B operand
// of O += P V (wgmma m64n64k16, P in registers straight from S's
// accumulators), so nothing is transposed.  The softmax overlaps the
// products two ways: each consumer issues S for tile j + 1 and P V for tile
// j back to back and waits for S alone, so its exponentials of tile j + 1
// run while its P V of tile j is on the tensor cores; and the consumers
// take turns at the tensor cores (ping-pong through two named barriers),
// so one's softmax runs while the other's products do.  On the H100 the
// ping-pong gained 4% and the wait for S alone 3% at [128, 8, 1500, 64]
// (PERF.md); ptxas reports that it injects one wait of its own (C7517).
// The bound the kernel cannot pass is the larger of the two above, plus
// what stays unhidden.
//
// Design (bf16, head dim 16: attn_mma_kernel): the tensor cores' k-depth
// is 16, so Q K^T is one k-step and wgmma's 128-byte rows do not suit
// 32-byte K rows: mma.sync m16n8k16.  A block of 4 warps takes 64 queries
// (16 a warp); K/V tiles of 64 keys arrive in a ring of 3 stages by
// cp.async; K's B fragments come by ldmatrix, V's by ldmatrix.trans from V
// as stored (no transpose pass), rows padded to DH + 8 so the 8 rows of a
// fragment fall on distinct banks.  The online softmax runs on the
// accumulator registers, whose layout is the A operand of P V.
//
// Design (f32, the parity variant): one thread per query with q and the
// output row in registers, K/V tiles of 32 keys in shared memory read as
// broadcasts, f32 FMA only (no TF32), online softmax per tile.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Where one (batch row, head) of q, k, v and out starts, and the distance
// between two of its rows, in elements.
struct Layout {
    long long batch, head;
    int row;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared, zero-filled where !valid (src is not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The A fragments (mma.sync m16n8k16 layout, which is also wgmma's layout
// of a warp's 16 rows) of 16 query rows from r0 on, DH / 16 k-steps;
// rows at or past T are zeros.
template <int DH>
__device__ __forceinline__ void load_q(uint32_t (&qa)[DH / 16][4], const bf16* qb, size_t pitch,
                                       int r0, int T, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const int ra = r0 + g, rb = ra + 8;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk * 16 + t * 2;
        qa[kk][0] = ra < T ? ld32(qb + ra * pitch + c) : 0u;
        qa[kk][1] = rb < T ? ld32(qb + rb * pitch + c) : 0u;
        qa[kk][2] = ra < T ? ld32(qb + ra * pitch + c + 8) : 0u;
        qa[kk][3] = rb < T ? ld32(qb + rb * pitch + c + 8) : 0u;
    }
}

// ---- head dim 64: wgmma ---------------------------------------------------

constexpr int WG_BQ = 128;       // queries a block: 2 consumer warpgroups of 64
constexpr int WG_THREADS = 384;  // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int WG_BK = 128;       // keys a stage
constexpr int WG_STAGES = 4;
constexpr int WG_TILE = WG_BK * 128;           // bytes of one K or V tile (64 bf16 a row)
constexpr int WG_SMEM = WG_STAGES * 2 * WG_TILE + 1024;  // + room to align to 1024

// Named barriers 1 and 2 (0 is __syncthreads): consumer w waits on w for
// its turn at the tensor cores and hands the turn to the other.
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// A shared-memory matrix descriptor of a 128-byte-swizzled operand: groups
// of 8 rows of 128 bytes, 1024 bytes apart.  That is the K-major stride
// (SBO) of K and the K-direction stride of V read MN-major; LBO, the
// stride between 64-element MN blocks, is unused at 64 columns and is set
// to the same.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wait (as CUTLASS's fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] (registers) B[16 x 128] (shared memory, descriptor).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate),
          "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] (registers) B[16 x 64] (shared memory, descriptor).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate),
          "n"(TRANS_B));
}

// K and V come as tensor maps over [B, H, T, 64] at the layout's strides
// (dims innermost first: 64, T, H, B), boxes of 64 x WG_BK, 128-byte
// swizzle; rows past T arrive as zeros.
__global__ void __launch_bounds__(WG_THREADS, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ q,
                  bf16* __restrict__ o, int T, Layout lay, float scale_log2, int n_valid) {
    constexpr int DH = 64;
    extern __shared__ unsigned char smem_raw[];
    __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
    const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // tiles 1024-aligned
    auto k_tile = [&](int stage) { return base + stage * 2 * WG_TILE; };
    auto v_tile = [&](int stage) { return base + stage * 2 * WG_TILE + WG_TILE; };
    auto full_bar = [&](int stage) { return smem_addr(&full[stage]); };
    auto empty_bar = [&](int stage) { return smem_addr(&empty[stage]); };

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * WG_BQ;
    const int wg = threadIdx.x >> 7;
    const int n_tiles = (n_valid + WG_BK - 1) / WG_BK;

    if (threadIdx.x == 0) {
        for (int st = 0; st < WG_STAGES; ++st) {
            mbar_init(full_bar(st), 1);
            mbar_init(empty_bar(st), 2 * 128);  // every consumer thread, once a tile
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {  // the producer: one thread keeps the ring full by TMA
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 0) {
            for (int j = 0; j < n_tiles; ++j) {
                const int st = j % WG_STAGES;
                mbar_wait(empty_bar(st), ((j / WG_STAGES) & 1) ^ 1);  // round 0 passes
                mbar_expect_tx(full_bar(st), 2 * WG_TILE);
                tma_load_4d(k_tile(st), &tm_k, full_bar(st), 0, j * WG_BK, h, b);
                tma_load_4d(v_tile(st), &tm_v, full_bar(st), 0, j * WG_BK, h, b);
            }
        }
        return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const size_t hbase = (size_t)b * lay.batch + (size_t)h * lay.head;
    const size_t pitch = lay.row;

    // this warp's 16 query rows: 64 a consumer warpgroup
    const int r0 = q0 + (wg - 1) * 64 + warp * 16;
    uint32_t qa[DH / 16][4];
    load_q<DH>(qa, q + hbase, pitch, r0, T, lane);

    float s[WG_BK / 2];  // S of this thread: n8 chunk c at s[4c .. 4c + 3]
    float oacc[DH / 2];  // O, the same layout over 64 columns
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) oacc[i] = 0.f;
    uint32_t pa[WG_BK / 16][4];  // P's A fragments, one k-step of 16 keys each
    float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores, rows g, g + 8
    float l[2] = {0.f, 0.f};              // running sum, this thread's columns

    auto issue_s = [&](int j) {  // wait for tile j, then S = Q K^T on it
        const int st = j % WG_STAGES;
        mbar_wait(full_bar(st), (j / WG_STAGES) & 1);
        wgmma_fence();
        fence_regs(s);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
            wgmma_m64n128<0>(s, qa[kk], desc_sw128(k_tile(st) + kk * 32), kk > 0);
        wgmma_commit();
    };

    // The online softmax on S of tile j, in place: s becomes P (f32); the
    // scale of the old O and sum is returned in alpha.
    auto softmax = [&](int j, float (&alpha)[2]) {
        const int k0 = j * WG_BK;
        if (k0 + WG_BK > n_valid) {
#pragma unroll
            for (int i = 0; i < WG_BK / 2; ++i) {
                const int key = k0 + (i >> 2) * 8 + t * 2 + (i & 1);
                if (key >= n_valid) s[i] = -INFINITY;
            }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < WG_BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float ms[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            ms[r] = mx[r] * scale_log2;
            alpha[r] = exp2f(m[r] * scale_log2 - ms[r]);  // 0 on the first tile (m = -inf)
            m[r] = mx[r];
            l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < WG_BK / 2; ++i) {
            const int r = (i >> 1) & 1;
            const float p = exp2f(fmaf(s[i], scale_log2, -ms[r]));
            s[i] = p;
            l[r] += p;
        }
    };
    auto issue_pv = [&](int j) {  // O += P V on tile j's stage
        const int st = j % WG_STAGES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
            wgmma_m64n64<1>(oacc, pa[kk], desc_sw128(v_tile(st) + kk * 16 * 128), 1);
        wgmma_commit();
    };

    issue_s(0);
    wgmma_wait<0>();
    fence_regs(s);
    if (wg == 2) named_arrive(1);  // consumer 1 takes the first turn
    for (int j = 0; j < n_tiles; ++j) {
        float alpha[2];
        softmax(j, alpha);  // beside P V of tile j - 1 and the other consumer's products
        wgmma_wait<0>();  // P V of tile j - 1 is done: O, P and its stage are free
        fence_regs(oacc);
        fence_regs(pa);
        if (j > 0) mbar_arrive(empty_bar((j - 1) % WG_STAGES));
        // rescale O and round P into the A fragments of P V
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
            pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
            pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
        // O and P are written, and s read, before the wgmmas below
        fence_regs(oacc);
        fence_regs(pa);
        fence_regs(s);
        named_sync(wg);  // this consumer's turn at the tensor cores
        if (j + 1 < n_tiles) issue_s(j + 1);  // S of tile j + 1 beside P V of tile j
        issue_pv(j);
        if (wg == 1 || j + 1 < n_tiles) named_arrive(3 - wg);  // the other's turn
        if (j + 1 < n_tiles) wgmma_wait<1>(); else wgmma_wait<0>();  // S of tile j + 1 is in
        fence_regs(s);
    }
    fence_regs(oacc);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.f / l[r];
    }
    const int ra = r0 + g, rb = ra + 8;
    bf16* ob = o + hbase;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
        const int c = n * 8 + t * 2;
        if (ra < T)
            *reinterpret_cast<uint32_t*>(ob + ra * pitch + c) =
                pack_bf16(oacc[4 * n] * l[0], oacc[4 * n + 1] * l[0]);
        if (rb < T)
            *reinterpret_cast<uint32_t*>(ob + rb * pitch + c) =
                pack_bf16(oacc[4 * n + 2] * l[1], oacc[4 * n + 3] * l[1]);
    }
}

// ---- head dim 16: mma.sync --------------------------------------------------

constexpr int MS_BQ = 64;  // queries a block, 16 a warp
constexpr int MS_BK = 64;  // keys a stage
constexpr int MS_THREADS = 128;
constexpr int MS_STAGES = 3;

template <int DH>
__global__ void __launch_bounds__(MS_THREADS)
attn_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int T, Layout lay,
                float scale_log2, int n_valid) {
    constexpr int PITCH = DH + 8;  // row pitch in shared memory: 8 rows on distinct banks
    constexpr int KS = DH / 16;    // k-steps of Q K^T
    constexpr int NO = DH / 8;     // n8 tiles of the output
    constexpr int VEC = DH / 8;    // 16-byte vectors a K/V row
    static_assert(NO % 2 == 0, "ldmatrix.x4 takes two output tiles at once");
    __shared__ __align__(16) bf16 Ks[MS_STAGES][MS_BK][PITCH];
    __shared__ __align__(16) bf16 Vs[MS_STAGES][MS_BK][PITCH];

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * MS_BQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const size_t hbase = (size_t)b * lay.batch + (size_t)h * lay.head;
    const size_t pitch = lay.row;
    const bf16* kb = k + hbase;
    const bf16* vb = v + hbase;
    const int n_tiles = (n_valid + MS_BK - 1) / MS_BK;

    auto load = [&](int stage, int tile) {
        const int k0 = tile * MS_BK;
        for (int i = threadIdx.x; i < MS_BK * VEC; i += MS_THREADS) {
            const int r = i / VEC, c = (i % VEC) * 8;
            const bool valid = k0 + r < T;
            const size_t off = valid ? (size_t)(k0 + r) * pitch + c : 0;
            cp_async16(smem_addr(&Ks[stage][r][c]), kb + off, valid);
            cp_async16(smem_addr(&Vs[stage][r][c]), vb + off, valid);
        }
    };

#pragma unroll
    for (int s = 0; s < MS_STAGES - 1; ++s) {
        if (s < n_tiles) load(s, s);
        cp_async_commit();
    }

    const int r0 = q0 + warp * 16;
    uint32_t qa[KS][4];
    load_q<DH>(qa, q + hbase, pitch, r0, T, lane);

    float oacc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) oacc[n][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores, rows g, g + 8
    float l[2] = {0.f, 0.f};              // running sum, this thread's columns

    const int lhalf = (lane >> 3) & 1;  // the 8x8 matrix half this lane addresses

    for (int j = 0; j < n_tiles; ++j) {
        cp_async_wait<MS_STAGES - 2>();
        __syncthreads();  // tile j is in; every warp is done with tile j - 1
        if (j + MS_STAGES - 1 < n_tiles) load((j + MS_STAGES - 1) % MS_STAGES, j + MS_STAGES - 1);
        cp_async_commit();
        const int st = j % MS_STAGES, k0 = j * MS_BK;

        // S = Q K^T for 16 queries x 64 keys (8 tiles of 8 keys, two a load).
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
        for (int n = 0; n < 8; n += 2)
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
                // matrices: keys n*8.. (d halves 0, 1), keys n*8+8.. (halves 0, 1)
                uint32_t bk[4];
                const int key = n * 8 + (lane & 7) + ((lane >> 4) << 3);
                ldsm_x4(bk, smem_addr(&Ks[st][key][kk * 16 + lhalf * 8]));
                mma_bf16(s[n], qa[kk], bk[0], bk[1]);
                mma_bf16(s[n + 1], qa[kk], bk[2], bk[3]);
            }

        // Mask, and the online softmax update.
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (k0 + n * 8 + t * 2 + (i & 1) >= n_valid) s[n][i] = -INFINITY;
                mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
            }
        float alpha[2], ms[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            ms[r] = mx[r] * scale_log2;
            alpha[r] = exp2f(m[r] * scale_log2 - ms[r]);  // 0 on the first tile (m = -inf)
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
                const float p = exp2f(fmaf(s[n][i], scale_log2, -ms[i >> 1]));
                s[n][i] = p;
                l[i >> 1] += p;
            }

        // O += P V: the S accumulators are P's A fragments; V's B fragments
        // by ldmatrix.trans from V as stored.
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int n = 0; n < NO; n += 2) {
                // matrices: keys kk*16.. and kk*16+8.. at columns n*8, then n*8+8
                uint32_t bv[4];
                ldsm_x4_trans(bv, smem_addr(&Vs[st][kk * 16 + (lane & 7) + lhalf * 8]
                                            [n * 8 + (lane >> 4) * 8]));
                mma_bf16(oacc[n], pa, bv[0], bv[1]);
                mma_bf16(oacc[n + 1], pa, bv[2], bv[3]);
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.f / l[r];
    }
    const int ra = r0 + g, rb = ra + 8;
    bf16* ob = o + hbase;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        const int c = n * 8 + t * 2;
        if (ra < T)
            *reinterpret_cast<uint32_t*>(ob + ra * pitch + c) =
                pack_bf16(oacc[n][0] * l[0], oacc[n][1] * l[0]);
        if (rb < T)
            *reinterpret_cast<uint32_t*>(ob + rb * pitch + c) =
                pack_bf16(oacc[n][2] * l[1], oacc[n][3] * l[1]);
    }
}

// ---- f32 -------------------------------------------------------------------

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

// ---- launches ----------------------------------------------------------------

// A tensor map over one of q, k, v at the layout's strides: dims (64, T, H,
// B), boxes of 64 x WG_BK, 128-byte swizzle, zeros past T.
bool head_map(CUtensorMap* map, const void* ptr, int B, int H, int T, Layout lay) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return false;
    const cuuint64_t dims[4] = {64, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)lay.row * 2, (cuuint64_t)lay.head * 2,
                                   (cuuint64_t)lay.batch * 2};
    const cuuint32_t box[4] = {64, WG_BK, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                  strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int T,
                Layout lay, float sm_scale, int n_valid, void* stream) {
    const auto q_ = static_cast<const bf16*>(q);
    const auto o_ = static_cast<bf16*>(o);
    const float scale_log2 = sm_scale * 1.4426950408889634f;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if constexpr (DH == 64) {
        static bool sized = false;  // set once, outside any graph capture
        if (!sized) {
            cudaError_t e = cudaFuncSetAttribute(
                attn_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
            if (e != cudaSuccess) return static_cast<int>(e);
            sized = true;
        }
        CUtensorMap tm_k, tm_v;
        if (!head_map(&tm_k, k, B, H, T, lay) || !head_map(&tm_v, v, B, H, T, lay))
            return static_cast<int>(cudaErrorInvalidValue);
        dim3 grid((T + WG_BQ - 1) / WG_BQ, H, B);
        attn_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, s>>>(tm_k, tm_v, q_, o_, T, lay,
                                                             scale_log2, n_valid);
    } else {
        dim3 grid((T + MS_BQ - 1) / MS_BQ, H, B);
        attn_mma_kernel<DH><<<grid, MS_THREADS, 0, s>>>(q_, static_cast<const bf16*>(k),
                                                        static_cast<const bf16*>(v), o_, T, lay,
                                                        scale_log2, n_valid);
    }
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
