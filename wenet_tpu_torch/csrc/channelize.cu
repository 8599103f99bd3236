// Polyphase DFT filterbank channelizer, hand-written for Hopper (sm_90a).
//
// Replaces the XLA code of wenet_tpu/ops/channelizer.py::channelize (a
// commutator reshape, a 12-tap FIR per phase as shifted slices and an
// einsum, an N-point DFT as one matmul, and the (-k) mod N bin order).
// Its plain PyTorch version is
// wenet_tpu_torch/ops/channelizer.py::channelize_reference.
//
// What it computes.  x (n,) complex64 as float32 pairs, N channels,
// T taps a phase, hp[s][p] = h[s N + p] of the prototype lowpass, F = n / N
// output frames.  Phase p of frame m reads xf[m][p] = x[m N - p] (zero
// before the stream: the column-reversed commutator with a one-frame delay
// for p >= 1), filters it along frames,
//     y[m][p] = sum_{s < T} hp[s][p] xf[m - s][p],
// and channel k is sum_p y[m][p] e^{+2 pi i k p / N}, i.e. the DFT bin
// b = (-k) mod N, with the float32 cos/sin values of the float64-built DFT
// matrix (utils/compat._dft_matrix) that the wrapper hands in for the
// selected channels only.
//
// What bounds it on this card: bytes.  Every input sample is read once (8
// bytes) and every selected output sample written once (8 Nsel / N bytes
// a sample); the T + Nsel complex multiply-adds a sample are far below
// the float32 rate (times beside the bound: PERF.md, chip_smoke.py's
// channelize_vs_plain).
//
// Design.  A block takes a tile of frames [m0, m0 + tile): it stages the
// (tile + T) N samples the tile's FIR reaches into shared memory with
// coalesced float2 loads, forms y for the tile's tile x N (frame, phase)
// pairs there (phase-major, each phase's row padded by one entry: the
// FIR's and the DFT's shared-memory reads then fall in distinct banks),
// and then each thread forms selected channels' outputs of
// the tile's frames (N multiply-adds each, the phases in order; the
// twiddles are read through the cache), written
// channel after channel as one contiguous (Nsel F, 2) float32 buffer,
// which the demod kernel reads in place as c64 lanes.  float32 throughout
// (no tensor cores: TF32 stays off).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

struct ChanArgs {
    const float2* x;     // (F N,) samples (the first F N of the capture)
    const float* hp;     // (T, N) taps
    const float* tw;     // (Nsel, N, 2) cos, sin of each channel's bin
    float2* out;         // (Nsel F,)
    long long F;         // frames
    int N, T, nsel, tile;
};

__host__ __device__ static inline size_t align16(size_t b) {
    return (b + 15) / 16 * 16;
}

extern "C" long long channelize_smem_bytes(int N, int T, int tile) {
    return (long long)(align16((size_t)(tile + T) * N * 8) +
                       align16((size_t)N * (tile + 1) * 8) +
                       align16((size_t)T * N * 4));
}

__global__ void __launch_bounds__(THREADS)
channelize_kernel(const ChanArgs g) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int N = g.N, T = g.T, tile = g.tile;
    float2* xs = reinterpret_cast<float2*>(smem);
    float2* ys = reinterpret_cast<float2*>(
        smem + align16((size_t)(tile + T) * N * 8));
    float* hps = reinterpret_cast<float*>(
        reinterpret_cast<unsigned char*>(ys) +
        align16((size_t)N * (tile + 1) * 8));

    const long long m0 = (long long)blockIdx.x * tile;
    const long long base = (m0 - T) * N;
    const long long total = g.F * N;
    const int nx = (tile + T) * N;
    for (int i = threadIdx.x; i < nx; i += THREADS) {
        const long long j = base + i;
        xs[i] = (j >= 0 && j < total) ? g.x[j] : make_float2(0.f, 0.f);
    }
    for (int i = threadIdx.x; i < T * N; i += THREADS) hps[i] = g.hp[i];
    __syncthreads();

    // FIR per phase: y[m][p] = sum_s hp[s][p] x[(m - s) N - p], s = T-1..0;
    // neighbouring threads take neighbouring phases (distinct banks), and
    // y is kept phase-major with a padded row, so that the DFT's reads of
    // neighbouring frames are conflict-free too
    const int row = tile + 1;
    #pragma unroll 1
    for (int i = threadIdx.x; i < tile * N; i += THREADS) {
        const int ml = i / N, p = i - ml * N;
        float re = 0.f, im = 0.f;
        #pragma unroll 1
        for (int s = T - 1; s >= 0; --s) {
            const float h = hps[s * N + p];
            const float2 v = xs[(ml + T - s) * N - p];
            re += h * v.x;
            im += h * v.y;
        }
        ys[p * row + ml] = make_float2(re, im);
    }
    __syncthreads();

    // the selected channels: [yr | yi] . [[C], [-S]] and [[S], [C]]
    const int frames = (int)min((long long)tile, g.F - m0);
    #pragma unroll 1
    for (int i = threadIdx.x; i < g.nsel * tile; i += THREADS) {
        const int ci = i / tile, ml = i - ci * tile;
        if (ml >= frames) continue;
        const float2* y = ys + ml;
        const float* __restrict__ w = g.tw + 2 * ci * N;   // cached
        float re = 0.f, im = 0.f;
        #pragma unroll 1
        for (int p = 0; p < N; ++p) {
            re += y[p * row].x * w[2 * p];
            im += y[p * row].x * w[2 * p + 1];
        }
        #pragma unroll 1
        for (int p = 0; p < N; ++p) {
            re += y[p * row].y * -w[2 * p + 1];
            im += y[p * row].y * w[2 * p];
        }
        g.out[(long long)ci * g.F + m0 + ml] = make_float2(re, im);
    }
}

extern "C" int channelize_launch(const ChanArgs* a, void* stream) {
    if (a->N < 1 || a->T < 1 || a->nsel < 0 || a->tile < 1 || a->F < 0 ||
        ((uintptr_t)a->x & 7) != 0 || ((uintptr_t)a->out & 7) != 0)
        return (int)cudaErrorInvalidValue;
    const long long smem = channelize_smem_bytes(a->N, a->T, a->tile);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        channelize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (a->F == 0 || a->nsel == 0) return 0;
    const long long grid = (a->F + a->tile - 1) / a->tile;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    channelize_kernel<<<(unsigned)grid, THREADS, (size_t)smem,
                        (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}
