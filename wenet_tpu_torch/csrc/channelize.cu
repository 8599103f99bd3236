// Polyphase DFT filterbank channelizer, hand-written for Hopper (sm_90a).
//
// Replaces the XLA code of wenet_tpu/ops/channelizer.py::channelize (a
// commutator reshape, a 12-tap FIR per phase as shifted slices and an
// einsum, an N-point DFT as one matmul, and the (-k) mod N bin order).
// Its plain PyTorch version is
// wenet_tpu_torch/ops/channelizer.py::channelize_reference.
//
// What it computes.  x: n samples, as float32 (re, im) pairs or as raw
// cu8 bytes (converted in registers to b - 127, the 1/128 of
// ops/fsk.iq_from_cu8 folded into the taps, which gives the float-pair
// route's bits); N channels; T taps a phase; hp[s][p] = h[s N + p] of the
// prototype lowpass; F = n / N output frames.  Phase p of frame m reads
// xf[m][p] = x[m N - p] (zero before the stream: the column-reversed
// commutator with a one-frame delay for p >= 1), filters it along frames,
//     y[m][p] = sum_{s < T} hp[s][p] xf[m - s][p]   (s = T-1 .. 0),
// and channel k is sum_p y[m][p] e^{+2 pi i k p / N} (p = 0 .. N-1), i.e.
// the DFT bin b = (-k) mod N, with the float32 cos/sin values of the
// float64-built DFT matrix (utils/compat._dft_matrix) that the wrapper
// hands in for the selected channels only.  The output is the selected
// channels one after the other, (Nsel F, 2) float32: the c64 lanes the
// demod kernel reads.
//
// What bounds it on this card: bytes.  Every input sample is read once
// (8 bytes as pairs, 2 as cu8) and every selected output sample written
// once (8 Nsel / N bytes a sample); the T + Nsel complex multiply-adds a
// sample are far below the float32 rate (times beside the bound:
// PERF.md, chip_smoke.py's channelize_vs_plain).
//
// Design, point by point against the first version of this kernel:
//  1. N and T as template constants.  T = 12 with N = 4, 8, 16 are
//     instantiated with every FIR and DFT loop unrolled and no integer
//     division in an inner loop.  Any other N, or any other T, runs the
//     same kernel with N, T and the tile read at run time.  A FIR thread
//     owns one phase p and KF = 9 consecutive frames (a FIR group): its T
//     taps sit in registers, and a register window of KF + T - 1 samples
//     serves all KF outputs (2.2 shared-memory loads an output instead of
//     12); KF is odd so that the window loads of a warp's groups fall in
//     distinct banks.  With N above FIR_THREADS / 2 a thread takes several
//     (group, phase) units in turn.  Where T is not 12, or N is so large
//     that a tile of whole FIR groups does not fit shared memory, the tile
//     shrinks to any even number of frames and each thread forms single
//     outputs, the taps read through the cache.
//  2. Input through a ring of asynchronous copies.  Persistent blocks
//     (two a SM) each walk a contiguous run of tiles.  Tiles are copied
//     with cp.async 16-byte chunks into a ring two tiles ahead of the one
//     being filtered.  The ring maps global byte b to ring byte b mod R (R
//     a multiple of 16), so a chunk and its ring slot share their
//     alignment whatever the capture's address.  R holds the filtered
//     tile, its T frames of history and the two tiles in flight, plus 16
//     bytes: a tile's first and last chunks may reach up to 15 bytes past
//     its samples, and those bytes either repeat what the neighbouring
//     tile holds or land where nothing live is kept.  Loads are in flight
//     while the current tile's FIR and DFT run: there is no
//     load-then-store staging loop.
//  3. Twiddles loaded once per block into shared memory (where the
//     selected channels' fit beside the ring; else read through the
//     cache), two phases' cos and sin as one float4 where N is a
//     template constant.  A DFT item is two frames by SG = 4 channels:
//     the frames' N phases are read once (a float4 a phase) for four
//     channels, 16 independent sums; for N = 4, 8, 16 with every channel
//     a tile is 252 items, one round of the block's 256 threads.
//  4. The FIR history is carried: a tile's T frames of history are the
//     end of the previous tiles, still in the ring.  A block reads the T
//     frames before its first tile once; where they reach before the
//     stream, it writes zeros (cu8: byte 127) for those samples.
//  5. The shared-memory attribute and the carveout are set once a device
//     (channelize_init), not at each launch.
//  6. Reach at few taps.  Where not even a 2-frame tile fits beside two
//     tiles in flight (large N), the run-time instantiation keeps one
//     tile in flight, then none (the tile's copy waited for at once), and
//     last takes 1-frame tiles (the DFT item's second frame computed and
//     not stored): every N the first version of this kernel took still
//     fits, at every T.  The templated geometries keep IN_FLIGHT.  At run
//     time a tile with fewer DFT items than threads (a large N, few
//     channels) gives each item S lanes of a warp, each summing every
//     S-th phase, joined by shuffles: the N-phase chain of one thread
//     becomes N / S steps and a log2 S butterfly.
// Each channel's two frames are written as one 16-byte store where the
// address allows.  float32 throughout (no tensor cores: TF32 stays off);
// the multiply-adds are explicit fmaf.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define TAPS 12           // the taps a phase every caller passes
#define KF 9              // frames a FIR thread filters
#define FIR_THREADS 224   // FIR threads a tile where N allows
#define SG 4              // channels a DFT item
#define IN_FLIGHT 2       // tiles copied ahead of the one filtered
#define SMEM_LIMIT 232448

enum { FMT_PAIRS = 0, FMT_CU8 = 1 };

struct ChanArgs {
    const void* x;       // samples: (n, 2) float32 pairs or (2 n,) cu8
    const float* hp;     // (T, N) taps
    const float* tw;     // (nsel rounded up to SG, N, 2) cos, sin of
                         // each selected channel's bin (padding rows: 0)
    float2* out;         // (Nsel F,)
    long long F;         // frames
    int N, T, nsel, fmt;
    int tile;            // frames a tile: even
    int tw_smem;         // 1: the twiddles are copied to shared memory
    int blocks, tiles_per_block;
    int in_flight;       // tiles copied ahead: IN_FLIGHT, or fewer where
                         // the block does not fit otherwise (run time)
};

#ifdef CHANNELIZE_PHASES
// per block (the first 1024), by thread 0: copy, wait, fir, dft_store
// cycles summed over its tiles, tiles, the loop's span, the prologue's
// cycles, and the global timer (ns) at entry and at the end
__device__ long long channelize_phases[1024 * 10];
__device__ __forceinline__ long long global_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
extern "C" int channelize_read_phases(long long* host) {
    return (int)cudaMemcpyFromSymbol(host, channelize_phases,
                                     sizeof(channelize_phases));
}
#define CLOCK(v) const long long v = clock64()
#else
#define CLOCK(v)
#endif

// FIR groups of N phases a tile of whole groups: even, 224 FIR threads
// where N allows
__host__ __device__ static inline int fir_groups(int N) {
    const int g = (FIR_THREADS / N) & ~1;
    return g < 2 ? 2 : g;
}
// row stride of the FIR outputs, in samples: even (two frames are one
// float4); for a tile of whole FIR groups also padded and not a multiple
// of 8, so that a half-warp's stores of neighbouring phases spread over
// the banks (a tile shrunk below two groups keeps every byte for the ring)
__host__ __device__ static inline int y_stride(int tile) {
    if (tile < 2 * KF) return tile + (tile & 1);
    const int ys = tile + 2;
    return ys % 8 ? ys : ys + 2;
}
__host__ __device__ static inline int sample_bytes(int fmt) {
    return fmt == FMT_CU8 ? 2 : 8;
}
// samples the ring holds: the tile filtered, d tiles in flight, T frames
// of history, rounded up to whole 16-byte chunks, and one chunk more
__host__ __device__ static inline long long ring_samples(int N, int T,
                                                         int tile, int fmt,
                                                         int d) {
    const long long u = 16 / sample_bytes(fmt);
    const long long s = ((long long)(d + 1) * tile + T) * N;
    return (s + u - 1) / u * u + u;
}
// lanes of a warp that share a DFT item at run time: the largest power
// of two up to 32 with items x S <= THREADS
__host__ __device__ static inline int dft_split(int items) {
    int S = 1;
    while (S < 32 && items * 2 * S <= THREADS) S *= 2;
    return S;
}
// the kernel instantiated with N a template constant for this call
static inline bool templated(int N, int T, int tile, int tw_smem, int d) {
    return (N == 4 || N == 8 || N == 16) && T == TAPS &&
           tile == fir_groups(N) * KF && tw_smem && d == IN_FLIGHT;
}

extern "C" long long channelize_smem_bytes(int N, int T, int tile, int nsel,
                                           int fmt, int tw_smem,
                                           int in_flight) {
    return ring_samples(N, T, tile, fmt, in_flight) * sample_bytes(fmt)
           + (long long)N * y_stride(tile) * 8
           + (tw_smem ? (long long)(nsel + SG - 1) / SG * SG * N * 8 : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// ring sample r as (re, im); cu8: b - 127 exactly, as
// float(2^23 + b) - (2^23 + 127) (the 1/128 is in the taps)
template <int FMT>
__device__ __forceinline__ float2 sample(const unsigned char* ring, int r) {
    if constexpr (FMT == FMT_CU8) {
        const unsigned u =
            *reinterpret_cast<const unsigned short*>(ring + 2 * r);
        const float re = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440));
        const float im = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7441));
        return make_float2(__fsub_rn(re, 8388735.0f),
                           __fsub_rn(im, 8388735.0f));
    } else {
        return *reinterpret_cast<const float2*>(ring + 8 * r);
    }
}

// one phase's term of two frames' channel sums: re += yr c - yi s,
// im += yr s + yi c
__device__ __forceinline__ void dft_term(const float4 y, const float2 w,
                                         float a[4]) {
    a[0] = __fmaf_rn(y.x, w.x, a[0]);
    a[0] = __fmaf_rn(-y.y, w.y, a[0]);
    a[1] = __fmaf_rn(y.x, w.y, a[1]);
    a[1] = __fmaf_rn(y.y, w.x, a[1]);
    a[2] = __fmaf_rn(y.z, w.x, a[2]);
    a[2] = __fmaf_rn(-y.w, w.y, a[2]);
    a[3] = __fmaf_rn(y.z, w.y, a[3]);
    a[3] = __fmaf_rn(y.w, w.x, a[3]);
}

// channel c's frames m and m + 1 (v: re, im of each), one 16-byte store
// where the address allows; m + 1 = F, or not two (a 1-frame tile): frame
// m alone
__device__ __forceinline__ void store_pair(float2* out, int c, long long F,
                                           long long m, const float v[4],
                                           bool two) {
    float2* dst = out + (long long)c * F + m;
    if (m + 1 >= F || !two) {
        dst[0] = make_float2(v[0], v[1]);
    } else if ((((long long)c * F + m) & 1) == 0) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
        dst[0] = make_float2(v[0], v[1]);
        dst[1] = make_float2(v[2], v[3]);
    }
}

// NT: the channel count as a template constant (T = 12, whole FIR
// groups a tile, the twiddles in shared memory, IN_FLIGHT tiles in
// flight), 0 to read N, T, the tile, the tiles in flight and where the
// twiddles are from g
template <int NT, int FMT>
__global__ void __launch_bounds__(THREADS, 2)
channelize_kernel(const ChanArgs g) {
    constexpr int SB = FMT == FMT_CU8 ? 2 : 8;     // bytes a sample
    const int D = NT ? IN_FLIGHT : g.in_flight;
    constexpr int W = KF + TAPS - 1;               // a FIR thread's window
    constexpr float SCALE = FMT == FMT_CU8 ? 0.0078125f : 1.f;
    const int N = NT ? NT : g.N;
    const int T = NT ? TAPS : g.T;
    const int TILE = NT ? fir_groups(NT) * KF : g.tile;
    // whole FIR groups of KF frames and T = 12: the register window
    const bool windowed = NT || (T == TAPS && TILE % KF == 0);
    const int G = TILE / KF;
    const int YS = y_stride(TILE), TN = TILE * N;
    const int RS = (int)ring_samples(N, T, TILE, FMT, D);
    const int R = RS * SB, R16 = R / 16;
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* ring = smem;
    float2* ys = reinterpret_cast<float2*>(smem + R);  // [p][frame], YS
    const int npad = (g.nsel + SG - 1) / SG * SG;      // twiddle rows
    float2* tws = ys + N * YS;                         // [channel][p]
    const bool tw_smem = NT || g.tw_smem;
    const float2* tw =
        tw_smem ? tws : reinterpret_cast<const float2*>(g.tw);

#ifdef CHANNELIZE_PHASES
    const long long t_entry = clock64(), ns_entry = global_ns();
#endif
    const int tid = threadIdx.x;
    const long long F = g.F, total = F * N;
    const long long ntiles = (F + TILE - 1) / TILE;
    const long long q0 = (long long)blockIdx.x * g.tiles_per_block;
    const long long q1 = min(q0 + (long long)g.tiles_per_block, ntiles);
    if (q0 >= q1) return;
    const uintptr_t xa = reinterpret_cast<uintptr_t>(g.x) & ~(uintptr_t)15;
    const int o = (int)(reinterpret_cast<uintptr_t>(g.x) - xa);
    const unsigned char* gx = reinterpret_cast<const unsigned char*>(xa);
    const int os = o / SB;        // ring index of sample j: (os + j) mod RS
    auto ring_of = [&](long long j) { return (int)((os + j) % RS); };

    // samples [js, je) of the stream (js >= 0, cut at its end) as whole
    // 16-byte chunks
    auto fetch = [&](long long js, long long je) {
        if (je > total) je = total;
        if (js >= je) return;
        const long long c1 = (o + je * SB + 15) >> 4;
        int rc = (((ring_of(js) * SB) >> 4) + tid) % R16;
        for (long long c = ((o + js * SB) >> 4) + tid; c < c1;
             c += THREADS) {
            cp_async16(ring + rc * 16, gx + c * 16);
            rc += THREADS;
            if (rc >= R16) rc -= R16;
        }
    };

    // the first tile's T frames of history (those within the stream),
    // then D tiles in flight
    const long long h0 = q0 * TN - (long long)T * N;
    if (q0 > 0) fetch(h0 > 0 ? h0 : 0, q0 * TN);
    #pragma unroll 1
    for (int d = 0; d < D; ++d) {
        if (q0 + d < q1) fetch((q0 + d) * TN, (q0 + d + 1) * TN);
        cp_async_commit();
    }

    // cu8: h / 128 times b - 127 is exactly h times (b - 127) / 128, so
    // each fmaf rounds the same value as on float pairs: the same bits
    float h[TAPS];
    auto load_taps = [&](int p) {
        #pragma unroll
        for (int s = 0; s < TAPS; ++s)
            h[s] = __fmul_rn(__ldg(g.hp + s * N + p), SCALE);
    };
    // one (group, phase) unit a thread (always so for N a template
    // constant): its taps once; else each unit loads its own
    const bool one_unit = windowed && G * N <= THREADS;
    if (one_unit && tid < G * N) load_taps(tid % N);
    if (tw_smem)
        for (int i = tid; i < npad * N; i += THREADS)
            tws[i] = i < g.nsel * N ? reinterpret_cast<const float2*>(g.tw)[i]
                                    : make_float2(0.f, 0.f);

    const int FP = (TILE + 1) / 2;                 // frame pairs a tile
    const int items = FP * (npad / SG);
    const int S = NT ? 1 : dft_split(items);       // lanes an item
    const int logS = __ffs(S) - 1;
#ifdef CHANNELIZE_PHASES
    long long t_copy = 0, t_wait = 0, t_fir = 0, t_dft = 0;
    CLOCK(t_start);
#endif
    #pragma unroll 1
    for (long long q = q0; q < q1; ++q) {
        CLOCK(ta);
        // the ring positions of tile q + D last held samples before tile
        // q's history: every FIR that read them is past its barrier
        if (q + D < q1) fetch((q + D) * TN, (q + D + 1) * TN);
        cp_async_commit();
        CLOCK(tb);
        if (NT || D == 2) {
            cp_async_wait<2>();
        } else if (D == 1) {
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (q == q0 && h0 < 0) {      // zeros before the stream: [h0, 0)
            const unsigned char zero = FMT == FMT_CU8 ? 127 : 0;
            for (int i = tid; i < (int)(-h0) * SB; i += THREADS) {
                int b = (int)(os + h0) * SB + i;
                if (b < 0) b += R;
                ring[b] = zero;
            }
            __syncthreads();
        }
        CLOCK(tc);

        const int rq = ring_of(q * TN);
        if (windowed) {
            // y[m][p] for KF frames m = m0 + gi KF + k, s = T-1 .. 0
            #pragma unroll 1
            for (int u = tid; u < G * N; u += THREADS) {
                const int gi = u / N, p = u - gi * N;
                if (!one_unit) load_taps(p);
                const int b = rq + (gi * KF - (TAPS - 1)) * N - p;
                float2 xw[W];
                if (b >= 0 && b + (W - 1) * N < RS) {
                    #pragma unroll
                    for (int w = 0; w < W; ++w)
                        xw[w] = sample<FMT>(ring, b + w * N);
                } else {                    // the window wraps the ring
                    #pragma unroll
                    for (int w = 0; w < W; ++w) {
                        int r = b + w * N;
                        if (r < 0) r += RS;
                        else if (r >= RS) r -= RS;
                        xw[w] = sample<FMT>(ring, r);
                    }
                }
                float2* yrow = ys + p * YS + gi * KF;
                #pragma unroll
                for (int k = 0; k < KF; ++k) {
                    float re = 0.f, im = 0.f;
                    #pragma unroll
                    for (int s = TAPS - 1; s >= 0; --s) {
                        const float2 v = xw[k + TAPS - 1 - s];
                        re = __fmaf_rn(h[s], v.x, re);
                        im = __fmaf_rn(h[s], v.y, im);
                    }
                    yrow[k] = make_float2(re, im);
                }
            }
        } else {
            // one output y[m0 + k][p] a step, s = T-1 .. 0, (k, p) moved
            // on by THREADS outputs without a division
            const int dk = THREADS / N, dp = THREADS - dk * N;
            int k = tid / N, p = tid - k * N;
            #pragma unroll 1
            while (k < TILE) {
                int r = rq + (k - (T - 1)) * N - p;
                if (r < 0) r += RS;
                else if (r >= RS) r -= RS;
                float re = 0.f, im = 0.f;
                #pragma unroll 4
                for (int s = T - 1; s >= 0; --s) {
                    const float hs = __fmul_rn(__ldg(g.hp + s * N + p),
                                               SCALE);
                    const float2 v = sample<FMT>(ring, r);
                    re = __fmaf_rn(hs, v.x, re);
                    im = __fmaf_rn(hs, v.y, im);
                    r += N;
                    if (r >= RS) r -= RS;
                }
                ys[p * YS + k] = make_float2(re, im);
                k += dk;
                p += dp;
                if (p >= N) {
                    p -= N;
                    ++k;
                }
            }
        }
        __syncthreads();
        CLOCK(td);

        // DFT: channels SG cg .. SG cg + SG-1 of frames m, m + 1 (m = m0
        // + 2 fp), the phases in order; at run time S lanes of a warp share
        // an item where the tile has few (S = dft_split(items)): lane s sums
        // the phases s, s + S, s + 2 S, ... and a butterfly of shuffles adds
        // the S partial sums (a large N with few channels is no longer one
        // thread's N-phase chain)
        const long long m0 = q * TILE;
        const float4* yv = reinterpret_cast<const float4*>(ys);
        if constexpr (NT > 0) {
            for (int i = tid; i < items; i += THREADS) {
                const int cg = i / FP, fp = i - cg * FP;
                const long long m = m0 + 2 * fp;
                if (m >= F) continue;
                float acc[SG][4];
                #pragma unroll
                for (int c = 0; c < SG; ++c)
                    #pragma unroll
                    for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
                const float2* w = tw + cg * SG * NT;
                // two phases' twiddles a float4
                #pragma unroll
                for (int pp = 0; pp < NT; pp += 2) {
                    const float4 y0 = yv[pp * (YS / 2) + fp];
                    const float4 y1 = yv[(pp + 1) * (YS / 2) + fp];
                    #pragma unroll
                    for (int c = 0; c < SG; ++c) {
                        const float4 ww = *reinterpret_cast<const float4*>(
                            w + c * NT + pp);
                        dft_term(y0, make_float2(ww.x, ww.y), acc[c]);
                        dft_term(y1, make_float2(ww.z, ww.w), acc[c]);
                    }
                }
                #pragma unroll
                for (int c = 0; c < SG; ++c)
                    if (cg * SG + c < g.nsel)
                        store_pair(g.out, cg * SG + c, F, m, acc[c], true);
            }
        } else {
            const int sub = tid & (S - 1);
            #pragma unroll 1
            for (int i0 = 0; i0 < items; i0 += THREADS / S) {   // uniform
                const int i = i0 + (tid >> logS);
                const int cg = i / FP, fp = i - cg * FP;
                const long long m = m0 + 2 * fp;
                const bool live = i < items && m < F;
                float acc[SG][4];
                #pragma unroll
                for (int c = 0; c < SG; ++c)
                    #pragma unroll
                    for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
                if (live) {
                    const float2* w = tw + cg * SG * N;
                    #pragma unroll 4
                    for (int pp = sub; pp < N; pp += S) {
                        const float4 y = yv[pp * (YS / 2) + fp];
                        #pragma unroll
                        for (int c = 0; c < SG; ++c)
                            dft_term(y, w[c * N + pp], acc[c]);
                    }
                }
                #pragma unroll 1
                for (int off = S >> 1; off > 0; off >>= 1)
                    #pragma unroll
                    for (int c = 0; c < SG; ++c)
                        #pragma unroll
                        for (int j = 0; j < 4; ++j)
                            acc[c][j] = __fadd_rn(
                                acc[c][j], __shfl_xor_sync(0xffffffffu,
                                                           acc[c][j], off));
                if (live && sub == 0) {
                    const bool two = 2 * fp + 1 < TILE;
                    #pragma unroll
                    for (int c = 0; c < SG; ++c)
                        if (cg * SG + c < g.nsel)
                            store_pair(g.out, cg * SG + c, F, m, acc[c],
                                       two);
                }
            }
        }
#ifdef CHANNELIZE_PHASES
        CLOCK(te);
        t_copy += tb - ta;
        t_wait += tc - tb;
        t_fir += td - tc;
        t_dft += te - td;
#endif
    }
    cp_async_wait<0>();
#ifdef CHANNELIZE_PHASES
    if (tid == 0 && blockIdx.x < 1024) {
        long long* out = channelize_phases + blockIdx.x * 10;
        out[0] = t_copy;
        out[1] = t_wait;
        out[2] = t_fir;
        out[3] = t_dft;
        out[4] = q1 - q0;
        out[5] = clock64() - t_start;
        out[6] = t_start - t_entry;
        out[7] = ns_entry;
        out[8] = global_ns();
    }
#endif
}

template <int FMT>
static const void* kernel_for(int N) {
    switch (N) {
    case 4: return (const void*)channelize_kernel<4, FMT>;
    case 8: return (const void*)channelize_kernel<8, FMT>;
    case 16: return (const void*)channelize_kernel<16, FMT>;
    default: return (const void*)channelize_kernel<0, FMT>;
    }
}

// once a device, before the first launch: every instantiation may take
// the block's whole shared memory, and prefers shared memory to L1
extern "C" int channelize_init() {
    const int ns[] = {4, 8, 16, 0};
    for (int n : ns) {
        for (int fmt = 0; fmt < 2; ++fmt) {
            const void* k = fmt ? kernel_for<FMT_CU8>(n)
                                : kernel_for<FMT_PAIRS>(n);
            cudaError_t err = cudaFuncSetAttribute(
                k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
            if (err == cudaSuccess)
                err = cudaFuncSetAttribute(
                    k, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
            if (err != cudaSuccess) return (int)err;
        }
    }
    return 0;
}

extern "C" int channelize_launch(const ChanArgs* a, void* stream) {
    if (a->N < 1 || a->T < 1 || a->nsel < 0 || a->F < 0 ||
        (a->fmt != FMT_PAIRS && a->fmt != FMT_CU8) || a->tile < 1 ||
        (a->tile > 1 && (a->tile & 1)) || a->in_flight < 0 ||
        a->in_flight > IN_FLIGHT ||
        (long long)a->tile * a->N * sample_bytes(a->fmt) < 16 ||
        ((uintptr_t)a->x % sample_bytes(a->fmt)) != 0 ||
        ((uintptr_t)a->out & 15) != 0)
        return (int)cudaErrorInvalidValue;
    const long long smem = channelize_smem_bytes(
        a->N, a->T, a->tile, a->nsel, a->fmt, a->tw_smem, a->in_flight);
    if (smem > SMEM_LIMIT ||
        ring_samples(a->N, a->T, a->tile, a->fmt, a->in_flight) *
                sample_bytes(a->fmt) < 16 * THREADS)
        return (int)cudaErrorInvalidValue;
    if (a->F == 0 || a->nsel == 0) return 0;
    const long long ntiles = (a->F + a->tile - 1) / a->tile;
    if (a->blocks < 1 || a->tiles_per_block < 1 ||
        (long long)a->blocks * a->tiles_per_block < ntiles ||
        (long long)(a->tile / 2) * ((a->nsel + SG - 1) / SG) > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const int n =
        templated(a->N, a->T, a->tile, a->tw_smem, a->in_flight) ? a->N : 0;
    const void* k = a->fmt == FMT_CU8 ? kernel_for<FMT_CU8>(n)
                                      : kernel_for<FMT_PAIRS>(n);
    void* params[] = {(void*)a};
    return (int)cudaLaunchKernel(k, dim3((unsigned)a->blocks), dim3(THREADS),
                                 params, (size_t)smem, (cudaStream_t)stream);
}
