// Log10-mel of 30 s windows: framing, Hann window, 400-point real DFT,
// power, mel projection and log10, in one kernel, in f32.
//
// Replaces: whisper_rs_tpu/ops/mel_pallas.py::_raw_log10_mel (kernel body
// _mel_kernel), which ran the DFT as three shifted MXU matmuls over hop rows.
// The reflect padding before it and the per-utterance max - 8 floor after it
// stay plain PyTorch (ops/mel.py), as they were XLA around the Pallas call.
//
// Bound on the H100: operations.  A window is 3000 frames x 201 bins x 400
// samples x 2 (re, im) FMAs plus the 201 x n_mels mel projection, about
// 1.06 GFLOP, against 1.9 MB of samples in and 0.96 MB out, and the
// reference holds 1e-4 in f32, so tensor cores (TF32) are out and the
// kernel runs on the f32 FMA pipes.
//
// Design: one block per (window, tile of FT frames).  The block stages the
// tile's samples once in shared memory (frames overlap: 400 samples every
// 160), and thread k owns DFT bin k for all FT frames, so each Hann-folded
// basis value it reads (coalesced across k, from L2) feeds 2 x FT FMAs and
// each 16-byte sample read from shared memory feeds 8.  Power goes to shared
// memory; the mel projection and log10 follow in the same block, and the
// result is written straight in the [B, n_mels, 3000] layout the encoder
// reads.
#include "common.cuh"

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_FREQ = 201;
constexpr int N_FRAMES = 3000;
constexpr int FT = 32;                         // frames per block
constexpr int THREADS = 224;                   // >= N_FREQ, whole warps
constexpr int SPAN = (FT - 1) * HOP + N_FFT;   // samples a tile reads

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ padded, const float* __restrict__ wcos,
               const float* __restrict__ wsin, const float* __restrict__ fb,
               float* __restrict__ out, int n_mels, int row_stride) {
    __shared__ __align__(16) float xs[SPAN];
    __shared__ float pw[FT * N_FREQ];

    const int b = blockIdx.y;
    const int f0 = blockIdx.x * FT;
    const int nf = min(FT, N_FRAMES - f0);
    const int span = (nf - 1) * HOP + N_FFT;
    const float* src = padded + (size_t)b * row_stride + (size_t)f0 * HOP;
    for (int i = threadIdx.x; i < SPAN; i += THREADS) xs[i] = i < span ? src[i] : 0.f;
    __syncthreads();

    const int k = threadIdx.x;
    if (k < N_FREQ) {
        float re[FT], im[FT];
#pragma unroll
        for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.f;
        for (int n = 0; n < N_FFT; n += 4) {
            float c[4], s[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                c[i] = wcos[(n + i) * N_FREQ + k];
                s[i] = wsin[(n + i) * N_FREQ + k];
            }
#pragma unroll
            for (int f = 0; f < FT; ++f) {
                const float4 x = *reinterpret_cast<const float4*>(&xs[f * HOP + n]);
                re[f] = fmaf(x.x, c[0], re[f]);
                im[f] = fmaf(x.x, s[0], im[f]);
                re[f] = fmaf(x.y, c[1], re[f]);
                im[f] = fmaf(x.y, s[1], im[f]);
                re[f] = fmaf(x.z, c[2], re[f]);
                im[f] = fmaf(x.z, s[2], im[f]);
                re[f] = fmaf(x.w, c[3], re[f]);
                im[f] = fmaf(x.w, s[3], im[f]);
            }
        }
#pragma unroll
        for (int f = 0; f < FT; ++f) pw[f * N_FREQ + k] = re[f] * re[f] + im[f] * im[f];
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < n_mels * FT; idx += THREADS) {
        const int m = idx / FT;
        const int f = idx % FT;
        if (f >= nf) continue;
        const float* w = fb + m * N_FREQ;
        const float* p = pw + f * N_FREQ;
        float acc = 0.f;
        for (int j = 0; j < N_FREQ; ++j) acc = fmaf(p[j], w[j], acc);
        out[((size_t)b * n_mels + m) * N_FRAMES + f0 + f] = log10f(fmaxf(acc, 1e-10f));
    }
}

}  // namespace

// padded: B rows of reflect-padded f32 audio, row b at padded + b * row_stride,
// each read for its first 480240 samples (rows may overlap: the chunks of
// one padded file have row_stride 480000);
// wcos, wsin: [400, 201] Hann-folded DFT basis; fb: [n_mels, 201];
// out: [B, n_mels, 3000] f32.
extern "C" int log_mel_f32(const float* padded, const float* wcos, const float* wsin,
                           const float* fb, float* out, int batch, int n_mels,
                           int row_stride, void* stream) {
    dim3 grid((N_FRAMES + FT - 1) / FT, batch);
    log_mel_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        padded, wcos, wsin, fb, out, n_mels, row_stride);
    return static_cast<int>(cudaGetLastError());
}
