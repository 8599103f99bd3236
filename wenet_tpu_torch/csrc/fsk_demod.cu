// Persistent 2/4-FSK demodulator frame loop for Hopper (sm_90a).
//
// Replaces the per-frame scan body of wenet_tpu/ops/fsk.py::demod_stream
// (:505, with _demod_frame :344 and _freq_est_step :297), which the JAX
// package ran as an XLA lax.scan rather than a Pallas kernel, and the port's
// Python frame loop (ops/fsk.demod_stream_reference, one launch-heavy step a
// frame).  Its plain version is that loop; the wrapper is
// kernels/fsk_demod.py.
//
// Design: one block of 512 threads per lane (a capture, a chunk of a fused
// slab, a trial of a sweep, an offset of the acquisition search).  The block
// walks its lane's frames in order with the whole DemodState in shared
// memory.  A lane's frames are serial, so at small L the frame loop is
// latency-bound; the design shortens each frame's dependency chain:
//
// 1. Twiddles and window on chip, exact.  The tone DFT needs cos/sin of
//    (-2 pi / n) i k for i < fs <= Ndft samples and k < Ndft/2 bins, which
//    utils/compat._dft_matrix builds in float64 and rounds to float32 (229 KB
//    at Ndft = 256, more than a block's shared memory).  Every entry equals
//    base[(i k) mod n], except where (i k) mod (n/4) == 0: those come from
//    exc[(i k) / (n/4)] (the only entries whose float64 angle rounds to
//    another float32 value than the reduced angle's).  The base table is
//    kept in log2(n) - 3 copies, copy a bit-rotated right by a: at a step
//    where the warp's sample i has c trailing zero bits, the 16 bins of a
//    half-warp read copy a = min(c, log2(n) - 4), whose slot bits 0..3 are
//    bits a..a+3 of (i k) mod n: 16 distinct banks for the distinct slots.
//    The wrapper builds, once per geometry, the table (copies, then the
//    exceptions: 14 KB at Ndft = 256) and the uint16 index of every
//    (sample, bin) into it (66 KB), so the DFT's inner loop is an index
//    load, a table load and four fmaf a product; the block stages both,
//    the Hann window and the timing spin into shared memory once per
//    launch (a larger Ndft's index table is read from global memory).
// 2. A sample ring filled ahead of the frame loop.  The last warp keeps the
//    lane's raw samples (cu8, cs16 or float32 pairs, in their raw width) two
//    frames ahead in a shared-memory ring with cp.async (16-byte chunks of
//    the 16-byte aligned buffer; the chunk that straddles the buffer's end
//    zero-fills its tail, chunks wholly outside it are not fetched), and
//    waits for them before the frame's last barrier.  The frame reads its
//    window from the ring and converts it there; li < 0, li >= n_valid and
//    a global index outside the buffer read as 0.0.
// 3. No serial thread-0 sections: warps 0..3 combine the DFT partials, a
//    bin a lane; warp 0 peak-picks from registers with warp reductions
//    (__reduce_max_sync / __reduce_min_sync); lanes m < M form the carrier
//    phases; the integrate-and-dump threads also form the timing line's
//    float64 terms, reduced by warp shuffles; warp 0 takes the symbol
//    decisions and the Eb/N0 sums with shuffles.  Five block barriers a
//    frame (two more per extra estimator block).
// 4. The next frame's DFT under this frame's serial tail.  The next frame's
//    estimator block starts at pos + nin, known before this frame's timing,
//    and the samples it windows, fs, take one of three values, one per nin
//    choice.  While warp 0 takes the timing, decisions and Eb/N0, warps
//    1..12 window the block's samples and sum the DFT of its common head
//    (up to fs_common, a multiple of 4 at or below the smallest fs) in 3
//    sample groups (at Ndft = 256), and warps 13..15 that of each of the
//    three tails (from fs_common to each fs) in one group.  The next frame
//    has no DFT of its own to run: warps 0..3 add the head's groups and its
//    nin's tail, in that order, while the window is read.
// 5. Small code.  A frame runs most of the code once, so the code's size,
//    not its instruction count, sets much of a frame's time: loops with a
//    run-time trip count are not unrolled, powers of two are shifted, the
//    kernel is a template on M (its tone loops unroll, its arrays stay in
//    registers), and one copy of the DFT loop serves every caller.
// 6. Per-frame probe traces (the PROBE template flag; the instantiation
//    without it is the flight path's code).  wenet_tpu/utils/probe.py
//    traces each frame's integrators, EMA, timing and high sample.  The
//    integrators and the EMA live in shared memory that the next frame
//    overwrites (the next frame's DFT runs under this frame's tail, 4.),
//    so each is stored where its value is final and before the barrier
//    that lets the next frame rewrite it: the integrators by the threads
//    that sum them, as they form them (5. in the loop), the EMA during the
//    downconvert (after the peak picks' barrier, before the next frame's
//    update), the timing and high sample by warp 0's lane 0 where it forms
//    them.  The stores are fire-and-forget: nothing waits on them.

// Bound: per frame a lane reads about N samples and writes Nbits soft bits,
// Nbits hard bits and a few stats, a few kB; the work is about 8 fs Ndft/2
// float32 operations for the DFT plus a few tens of thousands for the rest,
// which one SM does in under a microsecond; a frame is a chain of dependent
// steps, each a shared-memory or shuffle latency, so the loop is bound by
// latency, not by bytes or operations.
//
// Numerics follow the plain version.  The build passes -fmad=false, so
// every a*b + c below rounds twice, as torch's eager ops do; the places where
// the plain version rounds a*b + c once (ops/fsk._fma) use fma1, which forms
// it in float64.  The DFT is a matmul in the plain version and accumulates
// with fmaf here.  cosf/sinf (not the __cosf
// intrinsics) take angles up to ~1500 rad.  Every argmax keeps the first
// maximum.  The timing line sums in float64.  Sums run in another order than
// torch's (DFT, window sums, means, the timing line), so soft bits agree to
// a few float32 ulps, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512
#define NWARPS (THREADS / 32)
#define PRODUCER (NWARPS - 1)   // the warp that fills the sample ring
#define MAX_BINS 16             // bins a lane holds in the peak picks
#define DFT_THREADS 384         // warps 1..12: the next frame's DFT head
#define TAIL_THREADS 96         // warps 13..15: its three tails

struct DemodGeom {
    long long n_total;           // samples in the raw buffer
    int lanes, num_frames, fmt;  // fmt: 0 float32 pairs, 1 cu8, 2 cs16
    int Ts, P, S, M, Nsym, Nmem, N, Ndft, half, NP, Nbits;
    int f_min_bin, f_max_bin, f_zero_bins;
    float tc, one_m_tc, bin_hz, inv_fs, two_pi, two_pi_fs, cs16_scale;
    float half_pi, pi;
    float atan_c[9];
    int ring;                    // ring samples, a power of two
    int ahead;                   // samples the ring runs past a frame's end
    int max_blocks;              // estimator blocks a frame can use
    int n_tab;                   // entries of tw_tab
    int idx_smem;                // 1: tw_idx is staged in shared memory
    int fs_common;               // samples of block 0 every nin windows
    int span_common;             // samples of a group of that common part
    int tail_len;                // the longest tail, a multiple of 4
};

struct DemodPtrs {
    const void* data;       // (n_total, 2) raw pairs, 16-byte aligned
    const long long* starts;
    const long long* n_valid;
    const float* hann;      // (Ndft,)
    const float2* tw_tab;   // (n_tab,): the twiddle copies, the exceptions
    const uint2* tw_idx;    // (Ndft/4 + 1, half): 4 uint16 entries of tw_tab
    const float* spin_re;   // (NP,)
    const float* spin_im;
    const int* pos_in;
    const int* nin_in;
    const float* fft_in;    // (lanes, half)
    const float* fest_in;   // (lanes, M)
    const float* phi_in;    // (lanes, M)
    const float* norm_in;
    const float* ppm_in;
    const float* ebno_in;
    const float* snr_in;
    int* pos_out;
    int* nin_out;
    float* fft_out;
    float* fest_out;
    float* phi_out;
    float* norm_out;
    float* ppm_out;
    float* ebno_out;
    float* snr_out;
    float* soft;            // (lanes, frames, Nbits)
    uint8_t* bits;          // (lanes, frames, Nbits)
    uint8_t* valid;         // (lanes, frames)
    float* o_fest;          // (lanes, frames, M)
    float* o_ebno;          // (lanes, frames)
    float* o_norm;
    float* o_ppm;
    int* o_nin;
    float* eye_re;          // (lanes, M, NP) or null: the eye probe
    float* eye_im;
    int* eye_high;          // (lanes,)
    uint8_t* eye_ok;        // (lanes,)
    float2* tr_fint;        // (lanes, frames, M, NP) or null: the PROBE
    float* tr_fft;          // (lanes, frames, half)      variant's traces
    float* tr_rx;           // (lanes, frames): norm_rx_timing * P
    int* tr_high;           // (lanes, frames)
};

#ifdef FSK_DEMOD_PHASES
// clock64 at the phase ends of frame f < 64 of lane 0 (0..8; 9: block 0's
// combine, inside the window phase), read by chip_profile.py (a build with
// -DFSK_DEMOD_PHASES); no-ops otherwise
__device__ long long fsk_demod_phases[64 * 16];
extern "C" int fsk_demod_read_phases(long long* host) {
    return (int)cudaMemcpyFromSymbol(host, fsk_demod_phases,
                                     sizeof(fsk_demod_phases));
}
#define PHASE(k)                                                       \
    if (threadIdx.x == 0 && blockIdx.x == 0 && f < 64)                 \
    fsk_demod_phases[f * 16 + (k)] = clock64()
#else
#define PHASE(k)
#endif

// threads that share one DFT bin (each sums a slice of the samples): in
// the frame, and in the next frame's common part
__host__ __device__ static inline int dft_groups(int half) {
    return half >= THREADS ? 1 : THREADS / half;
}

__host__ __device__ static inline int common_groups(int half) {
    return half >= DFT_THREADS ? 1 : DFT_THREADS / half;
}

__host__ __device__ static inline int sample_bytes(int fmt) {
    return fmt == 0 ? 8 : (fmt == 1 ? 2 : 4);
}

// shared-memory layout, in bytes, each region 16-byte aligned
struct Layout {
    size_t red, ring, tab, idx, hann, spin, win, wb, wbn, wbt, d, fi, fft;
    size_t part, part_c, part_t;
    size_t total;
};

__host__ __device__ static inline size_t take(size_t& at, size_t bytes) {
    const size_t here = at;
    at = (at + bytes + 15) & ~(size_t)15;
    return here;
}

__host__ __device__ static inline Layout layout(const DemodGeom& g) {
    Layout L;
    size_t at = 0;
    L.red = take(at, 2 * NWARPS * sizeof(double));
    L.ring = take(at, (size_t)g.ring * sample_bytes(g.fmt));
    L.tab = take(at, (size_t)g.n_tab * sizeof(float2));
    L.idx = take(at, g.idx_smem ? (size_t)(g.Ndft / 4 + 1) * g.half * 8 : 0);
    L.hann = take(at, (size_t)g.Ndft * sizeof(float));
    L.spin = take(at, 2 * (size_t)g.NP * sizeof(float));
    L.win = take(at, (size_t)g.Nmem * sizeof(float2));
    L.wb = take(at, (size_t)g.max_blocks * (g.Ndft + 4) * sizeof(float2));
    L.wbn = take(at, (size_t)g.Ndft * sizeof(float2));
    L.wbt = take(at, 3 * (size_t)g.tail_len * sizeof(float2));
    L.d = take(at, (size_t)g.M * g.Nmem * sizeof(float2));
    L.fi = take(at, (size_t)g.M * g.NP * sizeof(float2));
    L.fft = take(at, (size_t)g.half * sizeof(float));
    L.part = take(at, 2 * (size_t)dft_groups(g.half) * g.half * sizeof(float));
    L.part_c =
        take(at, 2 * (size_t)common_groups(g.half) * g.half * sizeof(float));
    L.part_t = take(at, 3 * 2 * (size_t)g.half * sizeof(float));
    L.total = at;
    return L;
}

// a*b + c rounded once to float32 (ops/fsk._fma: the float64 product is
// exact, the float64 sum is rounded, then the float32 result)
__device__ __forceinline__ float fma1(float a, float b, float c) {
    return __double2float_rn(
        __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// ---------------------------------------------------------------- the ring

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// log2 of the samples in a 16-byte chunk: 2 float32 pairs, 8 cu8, 4 cs16
__device__ __forceinline__ int chunk_shift(int fmt) {
    return fmt == 0 ? 1 : (fmt == 1 ? 3 : 2);
}

// the producer warp: request the 16-byte chunks of global samples
// [next_chunk * spc, upto) that lie in the buffer into the ring;
// next_chunk moves forward only
__device__ void ring_fill(const DemodGeom& g, const void* data, char* ring,
                          long long& next_chunk, long long upto) {
    const int bps = sample_bytes(g.fmt), sh = chunk_shift(g.fmt);
    const long long hi = (upto + (1 << sh) - 1) >> sh;   // floor division
    const int lane = threadIdx.x & 31;
#pragma unroll 1
    for (long long c = next_chunk + lane; c < hi; c += 32) {
        const long long g0 = c << sh;
        if (g0 < 0 || g0 >= g.n_total) continue;   // read as 0.0
        const long long avail = (g.n_total - g0) * bps;
        cp_async16(ring + (size_t)(g0 & (g.ring - 1)) * bps,
                   (const char*)data + g0 * bps,
                   avail >= 16 ? 16 : (int)avail);
    }
    cp_async_commit();
    if (hi > next_chunk) next_chunk = hi;
}

__device__ __forceinline__ float2 ring_sample(const DemodGeom& g,
                                              const char* ring, long long gi) {
    const int slot = (int)(gi & (g.ring - 1));
    if (g.fmt == 1) {
        const uint8_t* d = (const uint8_t*)ring + 2 * slot;
        return make_float2(((float)d[0] - 127.0f) * 0.0078125f,
                           ((float)d[1] - 127.0f) * 0.0078125f);
    }
    if (g.fmt == 2) {
        const int16_t* d = (const int16_t*)ring + 2 * slot;
        return make_float2((float)d[0] * g.cs16_scale,
                           (float)d[1] * g.cs16_scale);
    }
    return ((const float2*)ring)[slot];
}

// ------------------------------------------------------------- small pieces

// utils/compat.atan2: the odd polynomial atan, float32 throughout
__device__ float atan2_poly(const DemodGeom& g, float y, float x) {
    const float ax = fabsf(x), ay = fabsf(y);
    const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
    const float t = lo / (hi > 0.0f ? hi : 1.0f);
    const float s = t * t;
    float p = g.atan_c[8];
    for (int k = 7; k >= 0; --k) p = p * s + g.atan_c[k];
    float r = t * p;
    if (ay > ax) r = g.half_pi - r;
    if (x < 0.0f) r = g.pi - r;
    if (y < 0.0f) r = -r;
    return hi > 0.0f ? r : 0.0f;
}

// first maximum over one warp of the bins k = 32 r + lane held in v[r]
// (the EMA is >= 0; -1 past the last bin): its index, lowest on ties, in
// every lane.  A non-negative float's bits order as its value, so two
// warp reductions find it.
__device__ __forceinline__ int warp_argmax(const float (&v)[MAX_BINS]) {
    const int lane = threadIdx.x & 31;
    float b = -1.0f;
    int a = 0x7fffffff;
#pragma unroll
    for (int r = 0; r < MAX_BINS; ++r)
        if (v[r] > b) { b = v[r]; a = 32 * r + lane; }
    const unsigned key = b < 0.0f ? 0u : __float_as_uint(b);
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    const int arg = (int)__reduce_min_sync(
        0xffffffffu, key == top ? (unsigned)a : 0x7fffffffu);
    return arg == 0x7fffffff ? 0 : arg;
}

// DFT partials of the windowed samples xb[lo..hi) for every bin, in
// `groups` sample groups of `span` samples (lo and span multiples of 4; xb
// is 0 from hi to the next multiple of 4), over threads t of nthreads:
// item e is bin e mod half of group e / half.  Per item four samples a
// step, even and odd samples in two sums, accumulated with fmaf as the
// plain version's matmul accumulates; idx4 holds the four samples' entries
// of tab (see 1. above).  One copy of the loop serves both callers.
__device__ __noinline__ void dft_partials(const float2* xb, const float2* tab,
                                          const uint2* idx4, int half,
                                          int logh, int lo, int hi,
                                          int groups, int span, int t,
                                          int nthreads, float* out) {
#pragma unroll 1
    for (int e = t; e < groups * half; e += nthreads) {
        const int k = e & (half - 1), grp = e >> logh;
        const int i0 = min(lo + grp * span, hi), i1 = min(hi, i0 + span);
        float re0 = 0.0f, im0 = 0.0f, re1 = 0.0f, im1 = 0.0f;
#pragma unroll 1
        for (int i = i0; i < i1; i += 4) {
            const float4 x01 = *(const float4*)(xb + i);
            const float4 x23 = *(const float4*)(xb + i + 2);
            const uint2 q = idx4[(i >> 2) * half + k];
            const float2 w0 = tab[q.x & 0xffffu], w1 = tab[q.x >> 16];
            const float2 w2 = tab[q.y & 0xffffu], w3 = tab[q.y >> 16];
            re0 = fmaf(x01.x, w0.x, re0);
            re0 = fmaf(-x01.y, w0.y, re0);
            im0 = fmaf(x01.x, w0.y, im0);
            im0 = fmaf(x01.y, w0.x, im0);
            re1 = fmaf(x01.z, w1.x, re1);
            re1 = fmaf(-x01.w, w1.y, re1);
            im1 = fmaf(x01.z, w1.y, im1);
            im1 = fmaf(x01.w, w1.x, im1);
            re0 = fmaf(x23.x, w2.x, re0);
            re0 = fmaf(-x23.y, w2.y, re0);
            im0 = fmaf(x23.x, w2.y, im0);
            im0 = fmaf(x23.y, w2.x, im0);
            re1 = fmaf(x23.z, w3.x, re1);
            re1 = fmaf(-x23.w, w3.y, re1);
            im1 = fmaf(x23.z, w3.y, im1);
            im1 = fmaf(x23.w, w3.x, im1);
        }
        out[grp * half + k] = re0 + re1;
        out[(groups + grp) * half + k] = im0 + im1;
    }
}

// samples block 0 windows for nin choice x (N - Ts/2, N, N + Ts/2)
__device__ __forceinline__ int tail_fs(const DemodGeom& g, int x) {
    return min(max(g.N + (x - 1) * (g.Ts / 2) - g.Ndft, 0), g.Ndft);
}

// warps 1..15, for the estimator block that starts at lane sample pos (the
// next frame's), Hann-windowed from the ring: warps 1..12 sum the DFT of
// samples [0, fs_common) in common_groups(half) sample groups into part_c;
// warps 13..15 that of samples [fs_common, fs) for each nin choice's fs in
// one group into part_t
__device__ void dft_common(const DemodGeom& g, const char* ring, float2* wbn,
                           float2* wbt, const float* hann, const float2* tab,
                           const uint2* idx4, float* part_c, float* part_t,
                           long long start, long long nvalid, long long pos,
                           int logh) {
    const int fsc = g.fs_common, TL = g.tail_len, half = g.half;
    const bool head = threadIdx.x < 32 + DFT_THREADS;
    const int t = threadIdx.x - (head ? 32 : 32 + DFT_THREADS);
    const int nt = head ? DFT_THREADS : TAIL_THREADS;
    const int lo = head ? 0 : fsc, hi = head ? fsc : fsc + TL;
#pragma unroll 1
    for (int i = lo + t; i < hi; i += nt) {
        const long long li = pos + i, gi = start + li;
        float2 x = make_float2(0.0f, 0.0f);
        if (i < tail_fs(g, 2) && li >= 0 && li < nvalid && gi >= 0 &&
            gi < g.n_total)
            x = ring_sample(g, ring, gi);
        const float2 w = make_float2(x.x * hann[min(i, g.Ndft - 1)],
                                     x.y * hann[min(i, g.Ndft - 1)]);
        if (head) {
            wbn[i] = w;
        } else {                          // each tail zero past its fs
#pragma unroll
            for (int c = 0; c < 3; ++c)
                wbt[c * TL + i - fsc] =
                    i < tail_fs(g, c) ? w : make_float2(0.0f, 0.0f);
        }
    }
    if (head) {
        asm volatile("bar.sync 1, %0;\n" :: "n"(DFT_THREADS) : "memory");
        dft_partials(wbn, tab, idx4, half, logh, 0, fsc, common_groups(half),
                     g.span_common, t, DFT_THREADS, part_c);
        return;
    }
    asm volatile("bar.sync 3, %0;\n" :: "n"(TAIL_THREADS) : "memory");
#pragma unroll 1
    for (int e = t; e < 3 * half; e += TAIL_THREADS) {
        const int c = e >> logh, fs = tail_fs(g, c);
        dft_partials(wbt + c * TL - fsc, tab, idx4, half, logh, fsc, fs, 1,
                     (fs - fsc + 3) & ~3, e & (half - 1), half,
                     part_t + 2 * c * half);
    }
}

// ----------------------------------------------------------------- kernel

template <int M, bool PROBE>
__global__ void __launch_bounds__(THREADS, 1)
fsk_demod_kernel(const DemodGeom g, const DemodPtrs p) {
    extern __shared__ __align__(16) char smem[];
    const Layout Lo = layout(g);
    double* red = (double*)(smem + Lo.red);       // 2 x NWARPS timing sums
    char* ring = smem + Lo.ring;
    float2* tab = (float2*)(smem + Lo.tab);       // twiddles (see 1.)
    const uint2* idx4 =                           // their (sample, bin) index
        g.idx_smem ? (const uint2*)(smem + Lo.idx) : p.tw_idx;
    float* hann = (float*)(smem + Lo.hann);
    float* spin_re = (float*)(smem + Lo.spin);
    float* spin_im = spin_re + g.NP;
    float2* win = (float2*)(smem + Lo.win);       // Nmem: the frame's window
    float2* wb = (float2*)(smem + Lo.wb);         // blocks x (Ndft + 4)
    float2* d = (float2*)(smem + Lo.d);           // M x Nmem: downconverted
    float2* fi = (float2*)(smem + Lo.fi);         // M x NP: integrators
    float* fft = (float*)(smem + Lo.fft);         // half: EMA of the spectrum
    float* part = (float*)(smem + Lo.part);       // 2 x G x half partials
    float2* wbn = (float2*)(smem + Lo.wbn);       // the next block's head
    float2* wbt = (float2*)(smem + Lo.wbt);       // and its three tails
    float* part_c = (float*)(smem + Lo.part_c);   // 2 x Gc x half: the DFTs
    float* part_t = (float*)(smem + Lo.part_t);   // 3 x 2 x half

    __shared__ float st_fest[M], st_phi[M];
    __shared__ float f_new[M], latched[M], theta0[M], phi_next[M];
    __shared__ float st_norm, st_ppm, st_ebno, st_snr, sh_high;
    __shared__ int st_pos, st_nin;

    const int lane = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, wl = tid & 31;
    const int Nmem = g.Nmem, half = g.half, Ndft = g.Ndft, NP = g.NP;
    const int logh = __ffs(half) - 1, G = dft_groups(half);
    const int logG = __ffs(G) - 1, Gc = common_groups(half);
    const int WBS = Ndft + 4, n_comb = min(half, THREADS);
    const long long start = p.starts[lane], nvalid = p.n_valid[lane];

    // stage the tables and the state
#pragma unroll 1
    for (int e = tid; e < g.n_tab; e += THREADS) tab[e] = p.tw_tab[e];
    if (g.idx_smem) {
#pragma unroll 1
        for (int e = tid; e < (Ndft / 4 + 1) * half; e += THREADS)
            ((uint2*)(smem + Lo.idx))[e] = p.tw_idx[e];
    }
#pragma unroll 1
    for (int e = tid; e < Ndft; e += THREADS) hann[e] = p.hann[e];
#pragma unroll 1
    for (int q = tid; q < NP; q += THREADS) {
        spin_re[q] = p.spin_re[q];
        spin_im[q] = p.spin_im[q];
    }
#pragma unroll 1
    for (int k = tid; k < half; k += THREADS)
        fft[k] = p.fft_in[lane * half + k];
    if (tid < M) {
        st_fest[tid] = p.fest_in[lane * M + tid];
        st_phi[tid] = p.phi_in[lane * M + tid];
    }
    if (tid == 0) {
        st_pos = p.pos_in[lane];
        st_nin = p.nin_in[lane];
        st_norm = p.norm_in[lane];
        st_ppm = p.ppm_in[lane];
        st_ebno = p.ebno_in[lane];
        st_snr = p.snr_in[lane];
        sh_high = 0.0f;
    }
    // the ring's first fill: the first frame's window and the lookahead
    long long next_chunk = 0;
    if (warp == PRODUCER) {
        const long long end = start + p.pos_in[lane] + p.nin_in[lane];
        next_chunk = (end - Nmem) >> chunk_shift(g.fmt);
        ring_fill(g, p.data, ring, next_chunk, end + g.ahead);
        cp_async_wait_all();
    }
    __syncthreads();
    if (warp >= 1)                                  // the first frame's
        dft_common(g, ring, wbn, wbt, hann, tab, idx4, part_c, part_t, start,
                   nvalid, p.pos_in[lane], logh);

    int f = 0;
#pragma unroll 1
    for (; f < g.num_frames; ++f) {
        __syncthreads();                           // the state; the ring
        const int pos = st_pos, nin = st_nin;
        if ((long long)pos + nin > nvalid) break;     // block-uniform
        PHASE(0);
        const int nold = Nmem - nin;
        const long long frame = (long long)lane * g.num_frames + f;
        const int n_blocks = nin / Ndft;

        // 2a. tone estimator, block 0: its DFT was summed during the frame
        // before (4.); warps 0..3 add the head's groups and this nin's tail,
        // take the band-masked magnitude and the EMA, while the window is
        // read
        if (n_blocks > 0 && tid < n_comb) {
            const int c = nin < g.N ? 0 : (nin == g.N ? 1 : 2);
            const float* pt = part_t + 2 * c * half;
#pragma unroll 1
            for (int k = tid; k < half; k += n_comb) {
                float re = part_c[k], im = part_c[Gc * half + k];
#pragma unroll 1
                for (int grp = 1; grp < Gc; ++grp) {
                    re = re + part_c[grp * half + k];
                    im = im + part_c[(Gc + grp) * half + k];
                }
                re = re + pt[k];
                im = im + pt[half + k];
                const bool band = k >= g.f_min_bin && k < g.f_max_bin - 1;
                const float mag = sqrtf(band ? re * re + im * im : 0.0f);
                fft[k] = fft[k] * g.one_m_tc + mag * g.tc;
            }
            PHASE(9);
        }

        // 1. the window from the ring: lane samples pos + nin - Nmem ..
        // pos + nin - 1, and the Hann-windowed estimator blocks after the
        // first (over the first nin - (j+1) Ndft samples of block j: fsk.c's
        // quirk)
        if (warp == PRODUCER)
            ring_fill(g, p.data, ring, next_chunk,
                      start + pos + nin + g.ahead);
        const long long base = (long long)pos + nin - Nmem;
#pragma unroll 1
        for (int t = tid; t < Nmem; t += THREADS) {
            const long long li = base + t, gi = start + li;
            float2 x = make_float2(0.0f, 0.0f);
            if (li >= 0 && li < nvalid && gi >= 0 && gi < g.n_total)
                x = ring_sample(g, ring, gi);
            win[t] = x;
#pragma unroll 1
            for (int j = 1; j < n_blocks; ++j) {
                const int fs = min(max(nin - (j + 1) * Ndft, 0), Ndft);
                const int i = t - nold - j * Ndft;
                if (i >= 0 && i < fs)
                    wb[j * WBS + i] = make_float2(x.x * hann[i], x.y * hann[i]);
            }
        }
        if (tid >= 4 && tid < 4 * n_blocks) {   // zeros up to a multiple of 4
            const int j = tid >> 2;
            wb[j * WBS + min(max(nin - (j + 1) * Ndft, 0), Ndft) + (tid & 3)] =
                make_float2(0.0f, 0.0f);
        }
        __syncthreads();
        PHASE(1);

        // 2b. the blocks after the first (geometries whose nin reaches 2
        // Ndft): the DFT of the windowed samples in G sample groups
        // (unwindowed samples add exact zeros and are skipped), combined in
        // group order, band-masked magnitude, EMA
#pragma unroll 1
        for (int j = 1; j < n_blocks; ++j) {
            const int fs = min(max(nin - (j + 1) * Ndft, 0), Ndft);
            const int span = (((fs + G - 1) >> logG) + 3) & ~3;
            dft_partials(wb + j * WBS, tab, idx4, half, logh, 0, fs, G, span,
                         tid, THREADS, part);
            __syncthreads();
            if (tid < n_comb) {
#pragma unroll 1
                for (int k = tid; k < half; k += n_comb) {
                    float re = part[k], im = part[G * half + k];
#pragma unroll 1
                    for (int grp = 1; grp < G; ++grp) {
                        re = re + part[grp * half + k];
                        im = im + part[(G + grp) * half + k];
                    }
                    const bool band = k >= g.f_min_bin && k < g.f_max_bin - 1;
                    const float mag = sqrtf(band ? re * re + im * im : 0.0f);
                    fft[k] = fft[k] * g.one_m_tc + mag * g.tc;
                }
            }
            __syncthreads();                  // fft for warp 0; part reused
        }

        // 3. M first-max peak picks with +/- f_zero_bins blanking on a copy
        // of the EMA in registers, sorted ascending; latch; carrier phases
        // (warp 0; lane m forms tone m's)
        if (warp == 0) {
            float v[MAX_BINS];
#pragma unroll
            for (int r = 0; r < MAX_BINS; ++r)
                v[r] = 32 * r + wl < half ? fft[32 * r + wl] : -1.0f;
            PHASE(2);
            int peaks[M] = {};
#pragma unroll 1
            for (int pk = 0; pk < M; ++pk) {
                const int imax = warp_argmax(v);
                if (wl == pk) peaks[0] = imax;    // lane pk keeps pick pk
#pragma unroll
                for (int r = 0; r < MAX_BINS; ++r) {
                    const int k = 32 * r + wl;
                    if (k < half && k >= imax - g.f_zero_bins &&
                        k < imax + g.f_zero_bins)
                        v[r] = 0.0f;
                }
            }
#pragma unroll
            for (int r = 1; r < M; ++r)           // every lane, every pick
                peaks[r] = __shfl_sync(0xffffffffu, peaks[0], r);
            peaks[0] = __shfl_sync(0xffffffffu, peaks[0], 0);
#pragma unroll
            for (int a = 1; a < M; ++a)          // insertion sort
#pragma unroll
                for (int b = a; b > 0; --b)
                    if (peaks[b - 1] > peaks[b]) {
                        const int t = peaks[b];
                        peaks[b] = peaks[b - 1];
                        peaks[b - 1] = t;
                    }
            if (wl < M) {
                const int m = wl;
                int pk = peaks[0];
#pragma unroll
                for (int r = 1; r < M; ++r) pk = r == m ? peaks[r] : pk;
                const bool first = st_fest[0] < 1.0f;
                const float noldf = (float)nold;
                const float ninf = (float)nin;
                const float Sf = (float)g.S;
                const float fn = (float)pk * g.bin_hz;
                const float la = first ? fn : st_fest[m];
                const float a = -((g.two_pi * (noldf - Sf)) * la);
                const float th = fma1(a, g.inv_fs, st_phi[m]);
                const float x = fma1(
                    g.two_pi_fs, fma1(la, noldf, fn * (ninf - Sf)), th);
                float r = fmodf(x, g.two_pi);        // floor-mod (jnp.mod)
                if (r != 0.0f && ((r < 0.0f) != (g.two_pi < 0.0f)))
                    r = r + g.two_pi;
                f_new[m] = fn;
                latched[m] = la;
                theta0[m] = th;
                phi_next[m] = r;
            }
        }
        __syncthreads();
        PHASE(3);

        // 4. downconvert: old samples at the latched tones, new ones at this
        // frame's, phase-continuous: stream * e^{-j ang}; PROBE: the EMA
        // after this frame's update
        if constexpr (PROBE) {
#pragma unroll 1
            for (int k = tid; k < half; k += THREADS)
                p.tr_fft[frame * half + k] = fft[k];
        }
        {
            const float noldf = (float)nold;
#pragma unroll
            for (int m = 0; m < M; ++m) {
#pragma unroll 1
                for (int t = tid; t < Nmem; t += THREADS) {
                    const float tf = (float)t;
                    const float inner =
                        fma1(f_new[m], fmaxf(tf - noldf, 0.0f),
                             latched[m] * fminf(tf, noldf));
                    const float ang = fma1(g.two_pi_fs, inner, theta0[m]);
                    const float c = cosf(ang), s = sinf(ang);
                    const float2 x = win[t];
                    d[m * Nmem + t] =
                        make_float2(x.x * c + x.y * s, x.y * c - x.x * s);
                }
            }
        }
        __syncthreads();
        PHASE(4);

        // 5. integrate-and-dump (window sums of Ts samples at stride S) and
        // the timing line's terms, summed in float64
        {
            double are = 0.0, aim = 0.0;
#pragma unroll 1
            for (int q = tid; q < NP; q += THREADS) {
                float ft = 0.0f;
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    const float2* x = d + m * Nmem + q * g.S;
                    float re = x[0].x, im = x[0].y;
#pragma unroll 1
                    for (int u = 1; u < g.Ts; ++u) {
                        re = re + x[u].x;
                        im = im + x[u].y;
                    }
                    fi[m * NP + q] = make_float2(re, im);
                    if constexpr (PROBE)
                        p.tr_fint[(frame * M + m) * NP + q] =
                            make_float2(re, im);
                    const float v = fma1(re, re, im * im);
                    ft = m == 0 ? v : ft + v;
                }
                are += (double)ft * (double)spin_re[q];
                aim += (double)ft * (double)spin_im[q];
            }
            for (int off = 16; off > 0; off >>= 1) {
                are += __shfl_down_sync(0xffffffffu, are, off);
                aim += __shfl_down_sync(0xffffffffu, aim, off);
            }
            if (wl == 0) {
                red[warp] = are;
                red[NWARPS + warp] = aim;
            }
        }
        if (warp == PRODUCER) cp_async_wait_all();   // the next windows
        __syncthreads();
        PHASE(5);

        // the next frame's common DFT (4.), beside warp 0's serial tail
        if (warp >= 1)
            dft_common(g, ring, wbn, wbt, hann, tab, idx4, part_c, part_t,
                       start, nvalid, (long long)pos + nin, logh);

        // 6-8. timing, symbol decisions, Eb/N0 and the new state (warp 0)
        if (warp == 0) {
            double are = wl < NWARPS ? red[wl] : 0.0;
            double aim = wl < NWARPS ? red[NWARPS + wl] : 0.0;
            for (int off = NWARPS / 2; off > 0; off >>= 1) {
                are += __shfl_down_sync(0xffffffffu, are, off);
                aim += __shfl_down_sync(0xffffffffu, aim, off);
            }
            float norm = 0.0f, ppm = 0.0f, low = 0.0f, fract = 0.0f,
                  high = 0.0f;
            int nin_next = 0;
            if (wl == 0) {
                norm = atan2_poly(g, (float)aim, (float)are) / g.two_pi;
                const float rx = norm * (float)g.P;
                const float d_norm = norm - st_norm;
                const float appm = 1e6f * d_norm / (float)g.Nsym;
                ppm = fabsf(d_norm) < 0.2f ? 0.9f * st_ppm + 0.1f * appm
                                           : st_ppm;
                nin_next = norm > 0.25f ? g.N + g.Ts / 2
                           : (norm < -0.25f ? g.N - g.Ts / 2 : g.N);
                low = floorf(rx);
                fract = rx - low;
                high = low + (fract > 0.0f ? 1.0f : 0.0f);
                if constexpr (PROBE) {
                    p.tr_rx[frame] = rx;
                    p.tr_high[frame] = (int)high;
                }
            }
            low = __shfl_sync(0xffffffffu, low, 0);
            fract = __shfl_sync(0xffffffffu, fract, 0);
            high = __shfl_sync(0xffffffffu, high, 0);
            PHASE(6);

            // symbol decisions with linear interpolation between the floor
            // and ceil integrator phases
            float sm = 0.0f, sw = 0.0f;
            float* so = p.soft + frame * g.Nbits;
            uint8_t* bo = p.bits + frame * g.Nbits;
            const float w_lo = 1.0f - fract;
#pragma unroll 1
            for (int k = wl; k < g.Nsym; k += 32) {
                const int st = (k + 1) * g.P;
                // rx timing lies in [-P/2, P/2], so both phases are in
                // range; the clamp only keeps a NaN timing inside shared
                // memory
                const int ilo = min(max(st + (int)low, 0), NP - 1);
                const int ihi = min(max(st + (int)high, 0), NP - 1);
                float tmax[M];
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    const float2 a = fi[m * NP + ilo], b = fi[m * NP + ihi];
                    const float tr = a.x * w_lo + b.x * fract;
                    const float ti = a.y * w_lo + b.y * fract;
                    tmax[m] = tr * tr + ti * ti;
                }
                float wv = tmax[0];
                int sym = 0;
#pragma unroll
                for (int m = 1; m < M; ++m)
                    if (tmax[m] > wv) { wv = tmax[m]; sym = m; }
                if (M == 2) {
                    bo[k] = tmax[1] > tmax[0] ? 1 : 0;
                    so[k] = sqrtf(tmax[0]) - sqrtf(tmax[1 % M]);
                } else {
                    const float m0 = sqrtf(tmax[0]), m1 = sqrtf(tmax[1 % M]);
                    const float m2 = sqrtf(tmax[2 % M]),
                                m3 = sqrtf(tmax[3 % M]);
                    bo[2 * k] = (sym >> 1) & 1;
                    bo[2 * k + 1] = sym & 1;
                    so[2 * k] = ((-m0 - m1) + m2) + m3;
                    so[2 * k + 1] = ((-m0 + m1) - m2) + m3;
                }
                sm = sm + sqrtf(wv);
                sw = sw + wv;
            }
            PHASE(7);
            for (int off = 16; off > 0; off >>= 1) {
                sm = sm + __shfl_down_sync(0xffffffffu, sm, off);
                sw = sw + __shfl_down_sync(0xffffffffu, sw, off);
            }
            if (wl == 0) {
                const float meane = sm / (float)g.Nsym;
                float stde = sw / (float)g.Nsym - meane * meane;
                stde = sqrtf(fmaxf(stde, 0.0f));
                const float ebno =
                    -6.0f + 20.0f * log10f((1e-6f + meane) / (1e-6f + stde));
                st_snr = 0.5f * st_snr + 0.5f * ebno;
                p.valid[frame] = 1;
                p.o_ebno[frame] = ebno;
                p.o_norm[frame] = norm;
                p.o_ppm[frame] = ppm;
                p.o_nin[frame] = nin;
                st_pos = pos + nin;
                st_nin = nin_next;
                st_norm = norm;
                st_ppm = ppm;
                st_ebno = ebno;
                sh_high = high;
            }
            if (wl < M) {
                p.o_fest[frame * M + wl] = f_new[wl];
                st_fest[wl] = f_new[wl];
                st_phi[wl] = phi_next[wl];
            }
            PHASE(8);
        }
    }
    if (warp == PRODUCER) cp_async_wait_all();
    __syncthreads();

    // frames past the lane's end: invalid, fields zeroed
#pragma unroll 1
    for (int r = f; r < g.num_frames; ++r) {
        const long long frame = (long long)lane * g.num_frames + r;
#pragma unroll 1
        for (int k = tid; k < g.Nbits; k += THREADS) {
            p.soft[frame * g.Nbits + k] = 0.0f;
            p.bits[frame * g.Nbits + k] = 0;
        }
        if (tid < M) p.o_fest[frame * M + tid] = 0.0f;
        if (tid == 0) {
            p.valid[frame] = 0;
            p.o_ebno[frame] = 0.0f;
            p.o_norm[frame] = 0.0f;
            p.o_ppm[frame] = 0.0f;
            p.o_nin[frame] = st_nin;
        }
        if constexpr (PROBE) {
#pragma unroll 1
            for (int e = tid; e < M * NP; e += THREADS)
                p.tr_fint[frame * M * NP + e] = make_float2(0.0f, 0.0f);
#pragma unroll 1
            for (int k = tid; k < half; k += THREADS)
                p.tr_fft[frame * half + k] = fft[k];
            if (tid == 0) {
                p.tr_rx[frame] = 0.0f;
                p.tr_high[frame] = 0;
            }
        }
    }

    // the eye probe: the last valid frame's integrators, on chip still
    if (p.eye_re != nullptr) {
        const bool ok = f > 0;
#pragma unroll 1
        for (int e = tid; e < M * NP; e += THREADS) {
            const float2 v = ok ? fi[e] : make_float2(0.0f, 0.0f);
            p.eye_re[(size_t)lane * M * NP + e] = v.x;
            p.eye_im[(size_t)lane * M * NP + e] = v.y;
        }
        if (tid == 0) {
            p.eye_high[lane] = ok ? (int)sh_high : 0;
            p.eye_ok[lane] = ok ? 1 : 0;
        }
    }

#pragma unroll 1
    for (int k = tid; k < half; k += THREADS)
        p.fft_out[lane * half + k] = fft[k];
    if (tid < M) {
        p.fest_out[lane * M + tid] = st_fest[tid];
        p.phi_out[lane * M + tid] = st_phi[tid];
    }
    if (tid == 0) {
        p.pos_out[lane] = st_pos;
        p.nin_out[lane] = st_nin;
        p.norm_out[lane] = st_norm;
        p.ppm_out[lane] = st_ppm;
        p.ebno_out[lane] = st_ebno;
        p.snr_out[lane] = st_snr;
    }
}

extern "C" int fsk_demod_smem_bytes(const DemodGeom* g) {
    return (int)layout(*g).total;
}

template <int M, bool PROBE>
static int launch(const DemodGeom* g, const DemodPtrs* p, void* stream) {
    const size_t smem = layout(*g).total;
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fsk_demod_kernel<M, PROBE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (g->lanes == 0) return 0;
    fsk_demod_kernel<M, PROBE>
        <<<g->lanes, THREADS, smem, (cudaStream_t)stream>>>(*g, *p);
    return (int)cudaGetLastError();
}

extern "C" int fsk_demod_launch(const DemodGeom* g, const DemodPtrs* p,
                                void* stream) {
    if (g->Ndft < 64 || (g->Ndft & (g->Ndft - 1)) != 0 ||
        g->half > 32 * MAX_BINS || (g->ring & (g->ring - 1)) != 0 ||
        ((uintptr_t)p->data & 15) != 0 || (g->fs_common & 3) != 0 ||
        (g->span_common & 3) != 0 || (g->tail_len & 3) != 0)
        return (int)cudaErrorInvalidValue;
    // PROBE: every trace buffer given, or none
    const int traces = (p->tr_fint != nullptr) + (p->tr_fft != nullptr) +
                       (p->tr_rx != nullptr) + (p->tr_high != nullptr);
    if (traces != 0 && traces != 4) return (int)cudaErrorInvalidValue;
    const bool probe = traces == 4;
    if (g->M == 2)
        return probe ? launch<2, true>(g, p, stream)
                     : launch<2, false>(g, p, stream);
    if (g->M == 4)
        return probe ? launch<4, true>(g, p, stream)
                     : launch<4, false>(g, p, stream);
    return (int)cudaErrorInvalidValue;
}
