// Log10-mel of 30 s windows: framing, Hann window, 400-point real FFT,
// power, mel projection and log10, in one kernel, in f32.
//
// Replaces: whisper_rs_tpu/ops/mel_pallas.py::_raw_log10_mel (kernel body
// _mel_kernel), which ran the DFT as three shifted MXU matmuls over hop rows.
// The reflect padding before it and the per-utterance max - 8 floor after it
// stay plain PyTorch (ops/mel.py), as they were XLA around the Pallas call.
//
// Bound on the H100: bytes.  A window is 1.92 MB of samples in and 0.96 MB
// (80 bins) of log-mel out; the FFT and the sparse projection take about
// 10.6k f32 operations a frame (ops/mel.py::kernel_flops_per_frame), 32
// MFLOP a window, so at base.en b128 the 369 MB take 0.110 ms at 3.35 TB/s
// and the 4.1 GFLOP 0.061 ms at 67 TFLOP/s f32 (H100 SXM data sheet, 700 W
// power limit).  The reference holds 1e-4 on log10 values in f32, so no
// tensor cores (TF32) and no reduced-precision exponent tricks.
//
// Design: one block per (window, tile of FT frames), so two chunks give 376
// blocks and a batch of 128 gives 24,064.  The tile's span of samples
// (frames overlap: 400 samples every 160) is copied once into shared memory
// by cp.async in 16-byte pieces (a tile starts 640 f0 bytes into its row,
// and the row pitch is a multiple of 16 bytes).  Each frame's 400 windowed
// samples are packed as 200 complex ones and transformed by a Stockham FFT
// of radices 8, 5, 5 in shared memory, a thread a butterfly; the radix-8
// stage reads the samples straight from the span.  The real-split post-pass
// turns the 200 complex bins into the 201 powers of the real DFT.  The mel
// projection is sparse: each filter is one run of contiguous bins (at most
// 14, 391 weights in all at 80 bins, against 16,080 of the dense product),
// summed in ascending bin order; log10 follows, and each mel row of the
// tile is written as one coalesced segment of the [B, n_mels, 3000] output.
// Every constant (window, butterfly constants, twiddles; the runs) comes
// from the host (ops/mel.py::fft_table, mel_runs), computed in float64 and
// rounded to f32 once, so the CPU tests run the same plan.
#include "common.cuh"

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int M = N_FFT / 2;                   // complex points of the FFT
constexpr int N_FRAMES = 3000;
constexpr int FT = 16;                         // frames per block
constexpr int THREADS = 256;
constexpr int SPAN = (FT - 1) * HOP + N_FFT;   // samples a tile reads
constexpr int N_POW = M + 1;                   // bins of the real DFT
// fft_table's layout (ops/mel.py): window, W8, radix-5 constants, the
// twiddles of stages 2 (Ns 8) and 3 (Ns 40), the post-pass's W400^k.
constexpr int T_WIN = 0, T_W8 = N_FFT, T_C5 = T_W8 + 2, T_TW2 = T_C5 + 4;
constexpr int T_TW3 = T_TW2 + 2 * 8 * 4, T_POST = T_TW3 + 2 * 40 * 4;
constexpr int T_LEN = T_POST + 2 * (M / 2 + 1);
constexpr int MAX_MELS = 128, MAX_WEIGHTS = 512;
constexpr int BUF = SPAN > FT * N_POW ? SPAN : FT * N_POW;  // samples, then powers

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

// y[s] = sum_r v[r] exp(-2 pi i r s / 8): two radix-2 layers around the W8
// twiddles (w8 = exp(-2 pi i / 8) = (c, -c)).
__device__ __forceinline__ void dft8(float2 (&v)[8], float c) {
    float2 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        a[r] = cadd(v[r], v[r + 4]);
        b[r] = csub(v[r], v[r + 4]);
    }
    b[1] = make_float2(c * (b[1].x + b[1].y), c * (b[1].y - b[1].x));   // * (c - ic)
    b[2] = mul_neg_i(b[2]);                                              // * -i
    b[3] = make_float2(c * (b[3].y - b[3].x), -c * (b[3].x + b[3].y));  // * (-c - ic)
    float2 c0 = cadd(a[0], a[2]), c1 = csub(a[0], a[2]), c2 = cadd(a[1], a[3]),
           c3 = mul_neg_i(csub(a[1], a[3]));
    v[0] = cadd(c0, c2);
    v[4] = csub(c0, c2);
    v[2] = cadd(c1, c3);
    v[6] = csub(c1, c3);
    c0 = cadd(b[0], b[2]);
    c1 = csub(b[0], b[2]);
    c2 = cadd(b[1], b[3]);
    c3 = mul_neg_i(csub(b[1], b[3]));
    v[1] = cadd(c0, c2);
    v[5] = csub(c0, c2);
    v[3] = cadd(c1, c3);
    v[7] = csub(c1, c3);
}

// y[s] = sum_r v[r] exp(-2 pi i r s / 5); k5 = cos(2pi/5), cos(4pi/5),
// sin(2pi/5), sin(4pi/5).
__device__ __forceinline__ void dft5(float2 (&v)[5], const float* k5) {
    const float c1 = k5[0], c2 = k5[1], s1 = k5[2], s2 = k5[3];
    const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
    const float2 t3 = csub(v[1], v[4]), t4 = csub(v[2], v[3]);
    const float2 a1 = make_float2(fmaf(c2, t2.x, fmaf(c1, t1.x, v[0].x)),
                                  fmaf(c2, t2.y, fmaf(c1, t1.y, v[0].y)));
    const float2 a2 = make_float2(fmaf(c1, t2.x, fmaf(c2, t1.x, v[0].x)),
                                  fmaf(c1, t2.y, fmaf(c2, t1.y, v[0].y)));
    const float2 b1 = make_float2(fmaf(s2, t4.x, s1 * t3.x), fmaf(s2, t4.y, s1 * t3.y));
    const float2 b2 = make_float2(fmaf(-s1, t4.x, s2 * t3.x), fmaf(-s1, t4.y, s2 * t3.y));
    v[0] = cadd(v[0], cadd(t1, t2));
    v[1] = make_float2(a1.x + b1.y, a1.y - b1.x);  // a1 - i b1
    v[4] = make_float2(a1.x - b1.y, a1.y + b1.x);  // a1 + i b1
    v[2] = make_float2(a2.x + b2.y, a2.y - b2.x);
    v[3] = make_float2(a2.x - b2.y, a2.y + b2.x);
}

// One radix-5 Stockham stage over the FT frames of z, in place: every
// thread reads its butterflies' inputs into registers, the block waits,
// then every thread writes.  NS is the stride before the stage; tw the
// stage's twiddles [NS][4] complex.
template <int NS>
__device__ __forceinline__ void radix5_stage(float2* z, const float2* tw, const float* k5) {
    constexpr int J = M / 5, ITEMS = FT * J, PER = (ITEMS + THREADS - 1) / THREADS;
    float2 v[PER][5];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int item = threadIdx.x + i * THREADS;
        if (item < ITEMS) {
            const int f = item / J, j = item % J, k = j % NS;
            const float2* in = z + f * M;
            v[i][0] = in[j];
#pragma unroll
            for (int r = 1; r < 5; ++r) v[i][r] = cmul(in[j + r * J], tw[k * 4 + r - 1]);
            dft5(v[i], k5);
        }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
        const int item = threadIdx.x + i * THREADS;
        if (item < ITEMS) {
            const int f = item / J, j = item % J, k = j % NS;
            float2* out = z + f * M + (j / NS) * NS * 5 + k;
#pragma unroll
            for (int r = 0; r < 5; ++r) out[r * NS] = v[i][r];
        }
    }
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ padded, const float* __restrict__ table,
               const int* __restrict__ runs, const float* __restrict__ weights,
               float* __restrict__ out, int n_mels, int row_stride) {
    __shared__ __align__(16) float buf[BUF];       // the tile's samples, then its powers
    __shared__ __align__(16) float2 z[FT * M];     // the frames' complex FFTs
    __shared__ __align__(16) float tab[T_LEN];
    __shared__ int run_s[MAX_MELS * 3];
    __shared__ float w_s[MAX_WEIGHTS];

    const int b = blockIdx.y;
    const int f0 = blockIdx.x * FT;
    const int nf = min(FT, N_FRAMES - f0);
    const int span = (nf - 1) * HOP + N_FFT;       // a multiple of 4
    const float* src = padded + (size_t)b * row_stride + (size_t)f0 * HOP;
    for (int i = threadIdx.x; i < span / 4; i += THREADS) cp_async16(buf + 4 * i, src + 4 * i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = threadIdx.x; i < T_LEN; i += THREADS) tab[i] = table[i];
    for (int i = threadIdx.x; i < n_mels * 3; i += THREADS) run_s[i] = runs[i];
    const int n_w = runs[3 * (n_mels - 1) + 1] + runs[3 * (n_mels - 1) + 2];
    for (int i = threadIdx.x; i < n_w; i += THREADS) w_s[i] = weights[i];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // Stage 1, radix 8 (Ns 1, no twiddles), straight from the samples:
    // z[m] = w[2m] x[2m] + i w[2m+1] x[2m+1], inputs m = j + 25 r.
    {
        constexpr int J = M / 8;
        const float* win = tab + T_WIN;
        const float c8 = tab[T_W8];
        for (int item = threadIdx.x; item < nf * J; item += THREADS) {
            const int f = item / J, j = item % J;
            const float* x = buf + f * HOP;
            float2 v[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
                const int n = 2 * (j + r * J);
                const float2 s = *reinterpret_cast<const float2*>(x + n);
                v[r] = make_float2(s.x * win[n], s.y * win[n + 1]);
            }
            dft8(v, c8);
            float2* o = z + f * M + j * 8;
#pragma unroll
            for (int r = 0; r < 8; ++r) o[r] = v[r];
        }
    }
    __syncthreads();
    radix5_stage<8>(z, reinterpret_cast<const float2*>(tab + T_TW2), tab + T_C5);
    radix5_stage<40>(z, reinterpret_cast<const float2*>(tab + T_TW3), tab + T_C5);

    // Real split: X[k] = E + W400^k O and X[M - k] = conj(E - W400^k O),
    // with 2E = Z[k] + conj Z[M - k], 2O = -i (Z[k] - conj Z[M - k]); the
    // powers go to buf (the samples are spent), [f][201].
    {
        constexpr int K = M / 2 + 1;  // pairs k = 0..100
        const float2* post = reinterpret_cast<const float2*>(tab + T_POST);
        for (int item = threadIdx.x; item < nf * K; item += THREADS) {
            const int f = item / K, k = item % K;
            const float2 za = z[f * M + k], zb = z[f * M + (M - k) % M];
            const float2 e = make_float2(za.x + zb.x, za.y - zb.y);
            const float2 t = cmul(make_float2(za.y + zb.y, zb.x - za.x), post[k]);
            const float2 xp = cadd(e, t), xm = csub(e, t);
            float* p = buf + f * N_POW;
            p[k] = 0.25f * fmaf(xp.x, xp.x, xp.y * xp.y);
            if (k != M - k) p[M - k] = 0.25f * fmaf(xm.x, xm.x, xm.y * xm.y);
        }
    }
    __syncthreads();

    // Sparse mel projection and log10; consecutive threads take consecutive
    // frames of one mel row.
    for (int idx = threadIdx.x; idx < n_mels * FT; idx += THREADS) {
        const int m = idx / FT, f = idx % FT;
        if (f >= nf) continue;
        const int first = run_s[3 * m], len = run_s[3 * m + 1], off = run_s[3 * m + 2];
        const float* p = buf + f * N_POW + first;
        const float* w = w_s + off;
        float acc = 0.f;
        for (int j = 0; j < len; ++j) acc = fmaf(p[j], w[j], acc);
        out[((size_t)b * n_mels + m) * N_FRAMES + f0 + f] = log10f(fmaxf(acc, 1e-10f));
    }
}

}  // namespace

// padded: B rows of reflect-padded f32 audio, row b at padded + b * row_stride,
// each read for its first 480240 samples (rows may overlap: the chunks of
// one padded file have row_stride 480000); 16-byte aligned, row_stride % 4
// == 0.  table: [T_LEN] f32 (ops/mel.py::fft_table); runs: [n_mels, 3]
// int32 (first bin, length, offset) and weights: the filters' nonzero
// weights (ops/mel.py::mel_runs), n_mels <= 128, at most 512 weights;
// out: [B, n_mels, 3000] f32.
extern "C" int log_mel_f32(const float* padded, const float* table, const int* runs,
                           const float* weights, float* out, int batch, int n_mels,
                           int row_stride, void* stream) {
    if (batch < 1 || n_mels < 1 || n_mels > MAX_MELS || row_stride % 4 ||
        reinterpret_cast<uintptr_t>(padded) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((N_FRAMES + FT - 1) / FT, batch);
    log_mel_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        padded, table, runs, weights, out, n_mels, row_stride);
    return static_cast<int>(cudaGetLastError());
}
