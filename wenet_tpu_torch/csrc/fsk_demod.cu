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
//    waits for them before the next frame's hand-off.  Every reader takes
//    its samples from the ring and converts them there; li < 0, li >=
//    n_valid and a global index outside the buffer read as 0.0.
// 3. Warp specialisation: only the timing line is serial.  Frame f's
//    timing sets nin of frame f+1, which has one of three values; every
//    other input of frame f+1's tone estimate is known when frame f starts:
//    its first estimator block starts at pos + nin, its EMA follows frame
//    f's, its latched tones and phase are frame f's f_new and phi_next.  So
//    the block's warps split in three groups, joined by named barriers (no
//    __syncthreads in the frame loop):
//    - the estimator warps (EST_WARP0..15) work one frame ahead: while frame
//      f demodulates they window and sum the DFT of frame f+1's first block
//      (its common head in common_groups(half) sample groups and its three
//      nin-dependent tails in one group each: the summation groups of the
//      single-chain design), form the three candidate EMAs from frame f's
//      chosen one (and sum the blocks after the first of each candidate's
//      window, where nin reaches them), pick M first-max peaks in each
//      (one warp a candidate, warp reductions) and form each candidate's
//      f_new, latched, theta0 and phi_next;
//    - the demod warps (1..DEMOD_WARPS) take frame f's candidate for its
//      nin, downconvert the window straight from the ring, integrate and
//      dump (the timing line's float64 terms summed per 32-thread slot of
//      the 512 and by shuffle trees, in the single-chain design's order; a
//      warp SLOTS slots at once) and hand the sums to warp 0;
//    - warp 0 reduces them, takes the timing, publishes frame f+1's pos and
//      nin, and then, off the chain, while the other warps start frame f+1,
//      finishes the timing line, takes frame f's symbol decisions and Eb/N0
//      and stores its outputs (the integrators are double-buffered by frame
//      parity).
//    A frame's hand-off (BAR_GO) waits for its nin and its three candidates;
//    the candidates, the pos/nin pair and the integrators live in two copies
//    by frame parity, so no group overwrites what another still reads.  The
//    split (DEMOD_WARPS, DFT_BINS) is the shortest of chip_profile.py's
//    phase clocks at the flight geometries.
// 4. Latency, not operations.  Each group's chain is short loads and
//    shuffles: the DFT's thread sums DFT_BINS bins at once, issuing all
//    their twiddle loads before their fmaf and loading the next step's
//    indices ahead; a window sum loads its samples at once; the downconvert
//    keeps two samples in flight.  Everything that touches shared memory is
//    inlined into the kernel, so that it is reached as shared memory (a
//    function of its own reaches it through generic loads, and spills
//    around its calls); sqrtf is not called on the band mask's zeros (its
//    slow path).  Loops with a run-time trip count are otherwise not
//    unrolled, powers of two are shifted, and the kernel is a template on M
//    (its tone loops unroll, its arrays stay in registers).
// 5. Per-frame probe traces (the PROBE template flag; the instantiation
//    without it is the flight path's code).  wenet_tpu/utils/probe.py
//    traces each frame's integrators, EMA, timing and high sample.  Each is
//    stored by the group that forms it: the integrators as they are summed,
//    the chosen candidate's EMA during the downconvert, the timing and high
//    sample by warp 0's lane 0.  The stores are fire-and-forget: nothing
//    waits on them.

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
#define DEMOD_WARPS 6                        // warps 1..6 (warp 0: timing)
#define EST_WARP0 (1 + DEMOD_WARPS)          // warps 7..15: the estimator
#define DEMOD_THREADS (32 * DEMOD_WARPS)
#define EST_THREADS (THREADS - 32 * EST_WARP0)
#define PRODUCER (NWARPS - 1)   // the estimator warp that fills the ring
#define MAX_BINS 16             // bins a lane holds in the peak picks
#define DFT_THREADS 384         // sets the head's sample groups (numerics)
#define DFT_BINS 4              // bins a thread sums at once in the DFT
#define TS_MAX 10               // window sums of up to TS_MAX samples load
//                                 their samples at once
// 32-thread slots of the timing sums a demod warp takes at once: all 16 in
// one pass
#define SLOTS ((NWARPS + DEMOD_WARPS - 1) / DEMOD_WARPS)
// named barriers; 0 is __syncthreads, outside the frame loop
#define BAR_GO 1                // frame f's nin and candidates: every thread
#define BAR_RED 2               // the timing sums: demod warps and warp 0
#define BAR_DEMOD 3             // the demod warps
#define BAR_EST 4               // the estimator warps

static_assert(DEMOD_WARPS >= 1 && NWARPS - EST_WARP0 >= 3,
              "a demod warp, and an estimator warp for each nin choice");

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
// clock64 at the stamps of frame f < 64 of lane 0, taken by lane 0 of warp
// w (the SM's clock, one for every warp), read by chip_profile.py (a build
// with -DFSK_DEMOD_PHASES); no-ops otherwise.  A stamp right after a
// barrier may mark the warp's arrival there, not the barrier's release: the
// card defers the wait to the first instruction that needs the barrier
// (BAR.SYNC.DEFER_BLOCKING).  The stamps, by group:
// stamp 0: go             (demod warps: frame f's hand-off passed)
// stamp 1: downconvert    (demod warps: barrier after the downconvert)
// stamp 2: integrate      (demod warps: timing sums handed to warp 0)
// stamp 3: sums_in        (warp 0: the sums received)
// stamp 4: timing         (warp 0: frame f+1's nin handed off)
// stamp 5: decisions      (warp 0: frame f's symbol decisions)
// stamp 6: ebno_state     (warp 0: Eb/N0 and the stores)
// stamp 7: est_go         (estimator: frame f's hand-off passed)
// stamp 8: est_window     (estimator: frame f+1's first block windowed)
// stamp 9: est_dft        (estimator: its head and tails summed)
// stamp 10: est_ema       (estimator: the three candidate EMAs)
// stamp 11: est_peaks     (estimator: candidate 0's peaks and phases)
// stamp 12: sums_wait     (warp 0: waits for frame f's sums)
// stamp 13: demod_wait    (demod warps: wait for frame f's hand-off)
// stamp 14: est_wait      (estimator: frame f's candidates done, waits)
__device__ long long fsk_demod_phases[64 * 16];
extern "C" int fsk_demod_read_phases(long long* host) {
    return (int)cudaMemcpyFromSymbol(host, fsk_demod_phases,
                                     sizeof(fsk_demod_phases));
}
__device__ __forceinline__ long long phase_clock() {
    long long t;        // volatile, as the barriers: kept in their order
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t) :: "memory");
    return t;
}
#define PHASE(k, w)                                                    \
    if (threadIdx.x == 32 * (w) && blockIdx.x == 0 && (unsigned)f < 64) \
    fsk_demod_phases[f * 16 + (k)] = phase_clock()
#else
#define PHASE(k, w)
#endif

__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// threads that share one DFT bin (each sums a slice of the samples): in
// the blocks after the first, and in the first block's common part
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
    size_t red, ring, tab, idx, hann, spin, wb, wbn, wbt, d, fi, fft, ema;
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
    const bool later = g.max_blocks > 1;     // blocks after the first
    L.red = take(at, 2 * NWARPS * sizeof(double));
    L.ring = take(at, (size_t)g.ring * sample_bytes(g.fmt));
    L.tab = take(at, (size_t)g.n_tab * sizeof(float2));
    L.idx = take(at, g.idx_smem ? (size_t)(g.Ndft / 4 + 1) * g.half * 8 : 0);
    L.hann = take(at, (size_t)g.Ndft * sizeof(float));
    L.spin = take(at, 2 * (size_t)g.NP * sizeof(float));
    L.wb = take(at, later ? (size_t)(g.Ndft + 4) * sizeof(float2) : 0);
    L.wbn = take(at, (size_t)g.Ndft * sizeof(float2));
    L.wbt = take(at, 3 * (size_t)g.tail_len * sizeof(float2));
    L.d = take(at, (size_t)g.M * g.Nmem * sizeof(float2));
    L.fi = take(at, 2 * (size_t)g.M * g.NP * sizeof(float2));
    L.fft = take(at, (size_t)g.half * sizeof(float));
    L.ema = take(at, 2 * 3 * (size_t)g.half * sizeof(float));
    L.part = take(
        at, later ? 2 * (size_t)dft_groups(g.half) * g.half * sizeof(float)
                  : 0);
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

// lane sample li of the lane that starts at global sample `start`, from the
// ring: 0.0 outside [0, nvalid) and outside the buffer
__device__ __forceinline__ float2 lane_sample(const DemodGeom& g,
                                              const char* ring,
                                              long long start,
                                              long long nvalid,
                                              long long li) {
    const long long gi = start + li;
    if (li >= 0 && li < nvalid && gi >= 0 && gi < g.n_total)
        return ring_sample(g, ring, gi);
    return make_float2(0.0f, 0.0f);
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

// first maximum over one warp of the bins k = 32 r + lane < half held in
// v[r] (the EMA is >= 0; -1 past the last bin): its index, lowest on ties, in
// every lane.  A non-negative float's bits order as its value, so two
// warp reductions find it.
__device__ __forceinline__ int warp_argmax(const float (&v)[MAX_BINS],
                                           int half) {
    const int lane = threadIdx.x & 31;
    float b = -1.0f;
    int a = 0x7fffffff;
#pragma unroll
    for (int r = 0; r < MAX_BINS; ++r) {
        if (32 * r >= half) break;           // warp-uniform
        if (v[r] > b) { b = v[r]; a = 32 * r + lane; }
    }
    const unsigned key = b < 0.0f ? 0u : __float_as_uint(b);
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    const int arg = (int)__reduce_min_sync(
        0xffffffffu, key == top ? (unsigned)a : 0x7fffffffu);
    return arg == 0x7fffffff ? 0 : arg;
}

// DFT partials of the windowed samples xb[i0..i1) at the DFT_BINS bins k,
// k + kstep, ... (i0 a multiple of 4; xb is 0 from i1 to the next multiple
// of 4), stored at re[bin], im[bin]: four samples a step, even and odd
// samples in two sums a bin, accumulated with fmaf as the plain version's
// matmul accumulates; the bins share each step's sample loads and their
// twiddle loads overlap; idx4 holds the four samples' entries of tab (see
// 1. above).
__device__ __forceinline__ void dft_bins(const float2* xb, const float2* tab,
                                         const uint2* idx4, int half, int k,
                                         int kstep, int i0, int i1,
                                         float* re, float* im) {
    float re0[DFT_BINS], im0[DFT_BINS], re1[DFT_BINS], im1[DFT_BINS];
    uint2 q[DFT_BINS];                   // the step's indices, loaded ahead
#pragma unroll
    for (int j = 0; j < DFT_BINS; ++j) {
        re0[j] = im0[j] = re1[j] = im1[j] = 0.0f;
        q[j] = idx4[(i0 >> 2) * half + k + j * kstep];
    }
#pragma unroll 1
    for (int i = i0; i < i1; i += 4) {
        const float4 x01 = *(const float4*)(xb + i);
        const float4 x23 = *(const float4*)(xb + i + 2);
        float2 w[DFT_BINS][4];
#pragma unroll
        for (int j = 0; j < DFT_BINS; ++j) {
            w[j][0] = tab[q[j].x & 0xffffu];
            w[j][1] = tab[q[j].x >> 16];
            w[j][2] = tab[q[j].y & 0xffffu];
            w[j][3] = tab[q[j].y >> 16];
        }
        // the next step's indices (the table has a row past the last step)
#pragma unroll
        for (int j = 0; j < DFT_BINS; ++j)
            q[j] = idx4[((i >> 2) + 1) * half + k + j * kstep];
#pragma unroll
        for (int j = 0; j < DFT_BINS; ++j) {
            re0[j] = fmaf(x01.x, w[j][0].x, re0[j]);
            re0[j] = fmaf(-x01.y, w[j][0].y, re0[j]);
            im0[j] = fmaf(x01.x, w[j][0].y, im0[j]);
            im0[j] = fmaf(x01.y, w[j][0].x, im0[j]);
            re1[j] = fmaf(x01.z, w[j][1].x, re1[j]);
            re1[j] = fmaf(-x01.w, w[j][1].y, re1[j]);
            im1[j] = fmaf(x01.z, w[j][1].y, im1[j]);
            im1[j] = fmaf(x01.w, w[j][1].x, im1[j]);
            re0[j] = fmaf(x23.x, w[j][2].x, re0[j]);
            re0[j] = fmaf(-x23.y, w[j][2].y, re0[j]);
            im0[j] = fmaf(x23.x, w[j][2].y, im0[j]);
            im0[j] = fmaf(x23.y, w[j][2].x, im0[j]);
            re1[j] = fmaf(x23.z, w[j][3].x, re1[j]);
            re1[j] = fmaf(-x23.w, w[j][3].y, re1[j]);
            im1[j] = fmaf(x23.z, w[j][3].y, im1[j]);
            im1[j] = fmaf(x23.w, w[j][3].x, im1[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < DFT_BINS; ++j) {
        re[k + j * kstep] = re0[j] + re1[j];
        im[k + j * kstep] = im0[j] + im1[j];
    }
}

// samples block 0 windows for nin choice x (N - Ts/2, N, N + Ts/2)
__device__ __forceinline__ int tail_fs(const DemodGeom& g, int x) {
    return min(max(g.N + (x - 1) * (g.Ts / 2) - g.Ndft, 0), g.Ndft);
}

// the nin choice x of a nin (0: N - Ts/2, 1: N, 2: N + Ts/2)
__device__ __forceinline__ int nin_choice(const DemodGeom& g, int nin) {
    return nin < g.N ? 0 : (nin == g.N ? 1 : 2);
}

// candidate x's nin: choice x, or `given` where that is of choice x (a
// launch's first frame takes its nin as the state gives it)
__device__ __forceinline__ int cand_nin(const DemodGeom& g, int x,
                                        int given) {
    return x == nin_choice(g, given) ? given : g.N + (x - 1) * (g.Ts / 2);
}

// the EMA after one estimator block: the DFT's band-masked magnitude
__device__ __forceinline__ float ema_step(const DemodGeom& g, int k,
                                          float ema, float re, float im) {
    const bool band = k >= g.f_min_bin && k < g.f_max_bin - 1;
    // sqrtf(0) outside the band, as the plain version's, without the call
    // that sqrtf takes for a zero
    const float mag = band ? sqrtf(re * re + im * im) : 0.0f;
    return ema * g.one_m_tc + mag * g.tc;
}

struct EstBufs {                 // the estimator's shared memory
    const char* ring;
    const float2* tab;
    const uint2* idx_s;          // the twiddle index in shared memory
    const uint2* idx_g;          // and in global memory (read where
    bool idx_smem;               // the geometry leaves it out of shared)
    const float* hann;
    float2 *wb, *wbn, *wbt;
    float *part, *part_c, *part_t;
};

// The estimator warps: the three candidates of the frame whose first
// estimator block starts at lane sample pos, one for each nin choice
// (cand_nin), from the frame before's chosen EMA, f_new and phi_next
// (prev_*): ema_out (3 x half) and est_out (3 x f_new, latched, theta0,
// phi_next).  The frame f of the stamps is the one demodulating.  Inlined
// at its one call, so that every access to shared memory is one (a
// function of its own would reach it through generic pointers).
template <int M>
__device__ __forceinline__ void estimate(
    const DemodGeom& g, const EstBufs& b, long long start, long long nvalid,
    long long pos, int nin_given, const float* prev_ema,
    const float* prev_fnew, const float* prev_phi, float* ema_out,
    float (*est_out)[4][M], int f) {
    const int t = threadIdx.x - 32 * EST_WARP0;
    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
    const int half = g.half, Ndft = g.Ndft;
    const int fsc = g.fs_common, TL = g.tail_len, Gc = common_groups(half);
    const int kb = half / DFT_BINS, logkb = __ffs(kb) - 1;

    // 1. window the first block from the ring: the common head to wbn, each
    // tail to wbt (zero past its fs)
#pragma unroll 1
    for (int i = t; i < fsc + TL; i += EST_THREADS) {
        float2 x = make_float2(0.0f, 0.0f);
        if (i < tail_fs(g, 2))
            x = lane_sample(g, b.ring, start, nvalid, pos + i);
        const float w = b.hann[min(i, Ndft - 1)];
        const float2 y = make_float2(x.x * w, x.y * w);
        if (i < fsc) {
            b.wbn[i] = y;
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                b.wbt[c * TL + i - fsc] =
                    i < tail_fs(g, c) ? y : make_float2(0.0f, 0.0f);
        }
    }
    bar_sync(BAR_EST, EST_THREADS);
    PHASE(8, EST_WARP0);

    // 2. its DFT: the head in Gc sample groups, each tail in one, a thread
    // DFT_BINS bins of one of them
#pragma unroll 1
    for (int u = t; u < (Gc + 3) * kb; u += EST_THREADS) {
        const int s = u >> logkb, k = u & (kb - 1), c = s - Gc;
        const bool head = s < Gc;
        const int i0 = head ? min(s * g.span_common, fsc) : fsc;
        const int i1 = head ? min(fsc, i0 + g.span_common) : tail_fs(g, c);
        const float2* xb = head ? b.wbn : b.wbt + c * TL - fsc;
        float* ore = head ? b.part_c + s * half : b.part_t + 2 * c * half;
        float* oim = head ? b.part_c + (Gc + s) * half
                          : b.part_t + (2 * c + 1) * half;
        if (b.idx_smem)      // two copies: the first loads from shared
            dft_bins(xb, b.tab, b.idx_s, half, k, kb, i0, i1, ore, oim);
        else
            dft_bins(xb, b.tab, b.idx_g, half, k, kb, i0, i1, ore, oim);
    }
    bar_sync(BAR_EST, EST_THREADS);
    PHASE(9, EST_WARP0);

    // 3. the candidate EMAs, a bin a thread: the head's groups added in
    // order, then each candidate's tail (a nin short of a block leaves the
    // EMA as it was)
#pragma unroll 1
    for (int k = t; k < half; k += EST_THREADS) {
        float re = b.part_c[k], im = b.part_c[Gc * half + k];
#pragma unroll 1
        for (int grp = 1; grp < Gc; ++grp) {
            re = re + b.part_c[grp * half + k];
            im = im + b.part_c[(Gc + grp) * half + k];
        }
        const float prev = prev_ema[k];
        float tr[3], ti[3];
#pragma unroll
        for (int x = 0; x < 3; ++x) {
            tr[x] = b.part_t[2 * x * half + k];
            ti[x] = b.part_t[(2 * x + 1) * half + k];
        }
#pragma unroll
        for (int x = 0; x < 3; ++x)
            ema_out[x * half + k] =
                cand_nin(g, x, nin_given) >= Ndft
                    ? ema_step(g, k, prev, re + tr[x], im + ti[x])
                    : prev;
    }
    bar_sync(BAR_EST, EST_THREADS);

    // 3b. the blocks after the first (geometries whose nin reaches 2 Ndft),
    // each candidate's in turn: the Hann-windowed samples (over the first
    // nin - (j+1) Ndft samples of block j: fsk.c's quirk) in G sample
    // groups (unwindowed samples add exact zeros and are skipped), combined
    // in group order, band-masked magnitude, EMA
    if (g.max_blocks > 1) {
        const int G = dft_groups(half), logG = __ffs(G) - 1;
#pragma unroll 1
        for (int x = 0; x < 3; ++x) {
            const int nin = cand_nin(g, x, nin_given);
#pragma unroll 1
            for (int j = 1; j < nin / Ndft; ++j) {
                const int fs = min(max(nin - (j + 1) * Ndft, 0), Ndft);
#pragma unroll 1
                for (int i = t; i < ((fs + 3) & ~3); i += EST_THREADS) {
                    float2 y = make_float2(0.0f, 0.0f);
                    if (i < fs) {
                        const float2 s = lane_sample(g, b.ring, start, nvalid,
                                                     pos + j * Ndft + i);
                        y = make_float2(s.x * b.hann[i], s.y * b.hann[i]);
                    }
                    b.wb[i] = y;
                }
                bar_sync(BAR_EST, EST_THREADS);
                const int span = (((fs + G - 1) >> logG) + 3) & ~3;
#pragma unroll 1
                for (int u = t; u < G * kb; u += EST_THREADS) {
                    const int grp = u >> logkb, k = u & (kb - 1);
                    const int i0 = min(grp * span, fs);
                    dft_bins(b.wb, b.tab, b.idx_smem ? b.idx_s : b.idx_g,
                             half, k, kb, i0, min(fs, i0 + span),
                             b.part + grp * half, b.part + (G + grp) * half);
                }
                bar_sync(BAR_EST, EST_THREADS);
#pragma unroll 1
                for (int k = t; k < half; k += EST_THREADS) {
                    float re = b.part[k], im = b.part[G * half + k];
#pragma unroll 1
                    for (int grp = 1; grp < G; ++grp) {
                        re = re + b.part[grp * half + k];
                        im = im + b.part[(G + grp) * half + k];
                    }
                    ema_out[x * half + k] =
                        ema_step(g, k, ema_out[x * half + k], re, im);
                }
                bar_sync(BAR_EST, EST_THREADS);      // part; ema_out of x
            }
        }
    }
    PHASE(10, EST_WARP0);

    // 4. M first-max peak picks with +/- f_zero_bins blanking on a copy of
    // the candidate's EMA in registers, sorted ascending; latch; carrier
    // phases (warp EST_WARP0 + c takes candidate c; lane m forms tone m's)
    const int c = warp - EST_WARP0;
    if (c < 3) {
        float v[MAX_BINS];
#pragma unroll
        for (int r = 0; r < MAX_BINS; ++r)
            v[r] = 32 * r + wl < half ? ema_out[c * half + 32 * r + wl]
                                      : -1.0f;
        int peaks[M] = {};
#pragma unroll 1
        for (int pk = 0; pk < M; ++pk) {
            const int imax = warp_argmax(v, half);
            if (wl == pk) peaks[0] = imax;    // lane pk keeps pick pk
#pragma unroll
            for (int r = 0; r < MAX_BINS; ++r) {
                if (32 * r >= half) break;       // warp-uniform
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
            for (int bb = a; bb > 0; --bb)
                if (peaks[bb - 1] > peaks[bb]) {
                    const int tmp = peaks[bb];
                    peaks[bb] = peaks[bb - 1];
                    peaks[bb - 1] = tmp;
                }
        if (wl < M) {
            const int m = wl, nin = cand_nin(g, c, nin_given);
            int pk = peaks[0];
#pragma unroll
            for (int r = 1; r < M; ++r) pk = r == m ? peaks[r] : pk;
            const bool first = prev_fnew[0] < 1.0f;
            const float noldf = (float)(g.Nmem - nin);
            const float ninf = (float)nin;
            const float Sf = (float)g.S;
            const float fn = (float)pk * g.bin_hz;
            const float la = first ? fn : prev_fnew[m];
            const float a = -((g.two_pi * (noldf - Sf)) * la);
            const float th = fma1(a, g.inv_fs, prev_phi[m]);
            const float x = fma1(
                g.two_pi_fs, fma1(la, noldf, fn * (ninf - Sf)), th);
            float r = fmodf(x, g.two_pi);        // floor-mod (jnp.mod)
            if (r != 0.0f && ((r < 0.0f) != (g.two_pi < 0.0f)))
                r = r + g.two_pi;
            est_out[c][0][m] = fn;
            est_out[c][1][m] = la;
            est_out[c][2][m] = th;
            est_out[c][3][m] = r;
        }
        PHASE(11, EST_WARP0);
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
    float* hann = (float*)(smem + Lo.hann);
    float* spin_re = (float*)(smem + Lo.spin);
    float* spin_im = spin_re + g.NP;
    float2* d = (float2*)(smem + Lo.d);           // M x Nmem: downconverted
    float2* fi = (float2*)(smem + Lo.fi);         // 2 x M x NP: integrators
    float* fft = (float*)(smem + Lo.fft);         // half: the EMA in
    float* ema = (float*)(smem + Lo.ema);         // 2 x 3 x half: candidates
    const EstBufs eb = {ring, tab, (const uint2*)(smem + Lo.idx), p.tw_idx,
                        g.idx_smem != 0, hann,
                        (float2*)(smem + Lo.wb), (float2*)(smem + Lo.wbn),
                        (float2*)(smem + Lo.wbt), (float*)(smem + Lo.part),
                        (float*)(smem + Lo.part_c), (float*)(smem + Lo.part_t)};

    __shared__ float st_fest[M], st_phi[M];       // the state in, then out
    __shared__ float est[2][3][4][M];   // by frame parity and nin choice:
    //                                     f_new, latched, theta0, phi_next
    __shared__ float sh_high;
    __shared__ int st_pos[2], st_nin[2];          // by frame parity
    __shared__ int st_frames, st_last, st_nin_end;

    const int lane = blockIdx.x, tid = threadIdx.x;
    const int warp = tid >> 5, wl = tid & 31;
    const int Nmem = g.Nmem, half = g.half, Ndft = g.Ndft, NP = g.NP;
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
        st_pos[0] = p.pos_in[lane];
        st_nin[0] = p.nin_in[lane];
        sh_high = 0.0f;
        st_frames = 0;
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

    if (warp >= EST_WARP0) {
        // ---- the estimator warps: frame f+1's candidates during frame f,
        // and first (f = -1) frame 0's from the state, its nin as given
#pragma unroll 1
        for (int f = -1; f < g.num_frames; ++f) {
            long long pos1;
            int given, nxt;
            const float *pe, *pf, *pp;
            if (f < 0) {
                pos1 = st_pos[0];
                given = st_nin[0];
                pe = fft;
                pf = st_fest;
                pp = st_phi;
                nxt = 0;
            } else {
                if (warp == PRODUCER) cp_async_wait_all();   // the ring's fill
                PHASE(14, EST_WARP0);
                bar_sync(BAR_GO, THREADS);
                const int pos = st_pos[f & 1], nin = st_nin[f & 1];
                if ((long long)pos + nin > nvalid) break;     // block-uniform
                PHASE(7, EST_WARP0);
                if (warp == PRODUCER)
                    ring_fill(g, p.data, ring, next_chunk,
                              start + pos + nin + g.ahead);
                if (f + 1 == g.num_frames) break;   // no frame to estimate
                const int cur = f & 1, x = nin_choice(g, nin);
                pos1 = (long long)pos + nin;
                given = g.N;
                pe = ema + (3 * cur + x) * half;
                pf = est[cur][x][0];
                pp = est[cur][x][3];
                nxt = cur ^ 1;
            }
            estimate<M>(g, eb, start, nvalid, pos1, given, pe, pf, pp,
                        ema + 3 * nxt * half, est[nxt], f);
        }
        if (warp == PRODUCER) cp_async_wait_all();
    } else if (warp >= 1) {
        // ---- the demod warps: downconvert and integrate frame f
        const int dt = tid - 32, dw = warp - 1;
#pragma unroll 1
        for (int f = 0; f < g.num_frames; ++f) {
            PHASE(13, 1);
            bar_sync(BAR_GO, THREADS);            // frame f's estimate; ring
            const int pos = st_pos[f & 1], nin = st_nin[f & 1];
            if ((long long)pos + nin > nvalid) break;     // block-uniform
            PHASE(0, 1);
            const int nold = Nmem - nin, x = nin_choice(g, nin);
            const long long frame = (long long)lane * g.num_frames + f;
            float fn[M], la[M], th[M];
#pragma unroll
            for (int m = 0; m < M; ++m) {
                fn[m] = est[f & 1][x][0][m];
                la[m] = est[f & 1][x][1][m];
                th[m] = est[f & 1][x][2][m];
            }
            // 4. downconvert: old samples at the latched tones, new ones at
            // this frame's, phase-continuous: stream * e^{-j ang}, the
            // window (lane samples pos + nin - Nmem .. pos + nin - 1) read
            // from the ring; PROBE: the chosen candidate's EMA
            if constexpr (PROBE) {
                const float* em = ema + ((f & 1) * 3 + x) * half;
#pragma unroll 1
                for (int k = dt; k < half; k += DEMOD_THREADS)
                    p.tr_fft[frame * half + k] = em[k];
            }
            {
                const long long base = (long long)pos + nin - Nmem;
                const float noldf = (float)nold;
#pragma unroll 2
                for (int t = dt; t < Nmem; t += DEMOD_THREADS) {
                    const float2 s =
                        lane_sample(g, ring, start, nvalid, base + t);
                    const float tf = (float)t;
#pragma unroll
                    for (int m = 0; m < M; ++m) {
                        const float inner =
                            fma1(fn[m], fmaxf(tf - noldf, 0.0f),
                                 la[m] * fminf(tf, noldf));
                        const float ang = fma1(g.two_pi_fs, inner, th[m]);
                        const float cs = cosf(ang), sn = sinf(ang);
                        d[m * Nmem + t] = make_float2(s.x * cs + s.y * sn,
                                                      s.y * cs - s.x * sn);
                    }
                }
            }
            bar_sync(BAR_DEMOD, DEMOD_THREADS);
            PHASE(1, 1);

            // 5. integrate-and-dump (window sums of Ts samples at stride S)
            // and the timing line's terms, summed in float64: slot t of 512
            // sums q = t, t + 512, ..., each 32 slots by a shuffle tree; a
            // warp takes SLOTS slots of 32 at once (chains in flight)
            float2* fo = fi + (f & 1) * M * NP;
#pragma unroll 1
            for (int v0 = dw; v0 < NWARPS; v0 += SLOTS * DEMOD_WARPS) {
                double are[SLOTS], aim[SLOTS];
#pragma unroll
                for (int h = 0; h < SLOTS; ++h) are[h] = aim[h] = 0.0;
#pragma unroll 1
                for (int q0 = wl; q0 < NP; q0 += THREADS) {
                    int q[SLOTS];
                    bool on[SLOTS];
                    float ft[SLOTS];
#pragma unroll
                    for (int h = 0; h < SLOTS; ++h) {
                        const int vw = v0 + h * DEMOD_WARPS;
                        q[h] = q0 + 32 * vw;
                        on[h] = vw < NWARPS && q[h] < NP;
                        ft[h] = 0.0f;
                    }
#pragma unroll
                    for (int m = 0; m < M; ++m) {
                        const float2* xs[SLOTS];
                        float re[SLOTS], im[SLOTS];
#pragma unroll
                        for (int h = 0; h < SLOTS; ++h) {
                            xs[h] = d + m * Nmem + (on[h] ? q[h] : 0) * g.S;
                            re[h] = xs[h][0].x;
                            im[h] = xs[h][0].y;
                        }
                        if (g.Ts <= TS_MAX) {
                            // every load issued at once: the samples past
                            // Ts (inside shared memory) are read, not added
#pragma unroll
                            for (int u = 1; u < TS_MAX; ++u)
#pragma unroll
                                for (int h = 0; h < SLOTS; ++h) {
                                    const float2 x = xs[h][u];
                                    if (u < g.Ts) {
                                        re[h] = re[h] + x.x;
                                        im[h] = im[h] + x.y;
                                    }
                                }
                        } else {
#pragma unroll 1
                            for (int u = 1; u < g.Ts; ++u)
#pragma unroll
                                for (int h = 0; h < SLOTS; ++h) {
                                    re[h] = re[h] + xs[h][u].x;
                                    im[h] = im[h] + xs[h][u].y;
                                }
                        }
#pragma unroll
                        for (int h = 0; h < SLOTS; ++h) {
                            if (on[h]) {
                                fo[m * NP + q[h]] = make_float2(re[h], im[h]);
                                if constexpr (PROBE)
                                    p.tr_fint[(frame * M + m) * NP + q[h]] =
                                        make_float2(re[h], im[h]);
                            }
                            const float v = fma1(re[h], re[h], im[h] * im[h]);
                            ft[h] = m == 0 ? v : ft[h] + v;
                        }
                    }
#pragma unroll
                    for (int h = 0; h < SLOTS; ++h)
                        if (on[h]) {
                            are[h] += (double)ft[h] * (double)spin_re[q[h]];
                            aim[h] += (double)ft[h] * (double)spin_im[q[h]];
                        }
                }
                for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
                    for (int h = 0; h < SLOTS; ++h) {
                        are[h] += __shfl_down_sync(0xffffffffu, are[h], off);
                        aim[h] += __shfl_down_sync(0xffffffffu, aim[h], off);
                    }
                }
                if (wl == 0) {
#pragma unroll
                    for (int h = 0; h < SLOTS; ++h) {
                        const int vw = v0 + h * DEMOD_WARPS;
                        if (vw < NWARPS) {
                            red[vw] = are[h];
                            red[NWARPS + vw] = aim[h];
                        }
                    }
                }
            }
            PHASE(2, 1);
            __syncwarp();
            bar_arrive(BAR_RED, DEMOD_THREADS + 32);
        }
    } else {
        // ---- warp 0: frame f's timing, then (off the chain) its decisions
        int pos = st_pos[0], nin = st_nin[0];
        float st_norm = p.norm_in[lane], st_ppm = p.ppm_in[lane];
        float st_ebno = p.ebno_in[lane], st_snr = p.snr_in[lane];
        float last_high = 0.0f;
        int f = 0;
        if (g.num_frames > 0) bar_arrive(BAR_GO, THREADS);
#pragma unroll 1
        for (; f < g.num_frames; ++f) {
            if ((long long)pos + nin > nvalid) break;     // block-uniform
            const long long frame = (long long)lane * g.num_frames + f;
            PHASE(12, 0);
            bar_sync(BAR_RED, DEMOD_THREADS + 32);
            PHASE(3, 0);
            // frame f's candidate: its f_new and phi_next, the state
            const int x = nin_choice(g, nin);
            const float fnew = wl < M ? est[f & 1][x][0][wl] : 0.0f;
            const float phin = wl < M ? est[f & 1][x][3][wl] : 0.0f;
            double are = wl < NWARPS ? red[wl] : 0.0;
            double aim = wl < NWARPS ? red[NWARPS + wl] : 0.0;
            for (int off = NWARPS / 2; off > 0; off >>= 1) {
                are += __shfl_down_sync(0xffffffffu, are, off);
                aim += __shfl_down_sync(0xffffffffu, aim, off);
            }
            // the chain: the timing, frame f+1's nin, the hand-off
            float norm = 0.0f;
            int nin_next = 0;
            if (wl == 0) {
                norm = atan2_poly(g, (float)aim, (float)are) / g.two_pi;
                nin_next = norm > 0.25f ? g.N + g.Ts / 2
                           : (norm < -0.25f ? g.N - g.Ts / 2 : g.N);
                st_pos[(f + 1) & 1] = pos + nin;
                st_nin[(f + 1) & 1] = nin_next;
            }
            PHASE(4, 0);
            __syncwarp();
            if (f + 1 < g.num_frames) bar_arrive(BAR_GO, THREADS);
            // off the chain: the rest of the timing line
            float ppm = 0.0f, low = 0.0f, fract = 0.0f, high = 0.0f;
            if (wl == 0) {
                const float rx = norm * (float)g.P;
                const float d_norm = norm - st_norm;
                const float appm = 1e6f * d_norm / (float)g.Nsym;
                ppm = fabsf(d_norm) < 0.2f ? 0.9f * st_ppm + 0.1f * appm
                                           : st_ppm;
                low = floorf(rx);
                fract = rx - low;
                high = low + (fract > 0.0f ? 1.0f : 0.0f);
                if constexpr (PROBE) {
                    p.tr_rx[frame] = rx;
                    p.tr_high[frame] = (int)high;
                }
            }
            nin_next = __shfl_sync(0xffffffffu, nin_next, 0);
            low = __shfl_sync(0xffffffffu, low, 0);
            fract = __shfl_sync(0xffffffffu, fract, 0);
            high = __shfl_sync(0xffffffffu, high, 0);

            // symbol decisions with linear interpolation between the floor
            // and ceil integrator phases
            const float2* fo = fi + (f & 1) * M * NP;
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
                    const float2 a = fo[m * NP + ilo], b = fo[m * NP + ihi];
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
            PHASE(5, 0);
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
                st_norm = norm;
                st_ppm = ppm;
                st_ebno = ebno;
                last_high = high;
                st_last = (f & 1) * 3 + x;
            }
            if (wl < M) {
                p.o_fest[frame * M + wl] = fnew;
                st_fest[wl] = fnew;
                st_phi[wl] = phin;
            }
            PHASE(6, 0);
            pos += nin;
            nin = nin_next;
        }
        if (wl == 0) {
            st_frames = f;
            st_nin_end = nin;
            sh_high = last_high;
            p.pos_out[lane] = pos;
            p.nin_out[lane] = nin;
            p.norm_out[lane] = st_norm;
            p.ppm_out[lane] = st_ppm;
            p.ebno_out[lane] = st_ebno;
            p.snr_out[lane] = st_snr;
        }
    }
    __syncthreads();
    const int f = st_frames;
    // the last valid frame's EMA, else the state's
    const float* ema_end = f > 0 ? ema + st_last * half : fft;

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
            p.o_nin[frame] = st_nin_end;
        }
        if constexpr (PROBE) {
#pragma unroll 1
            for (int e = tid; e < M * NP; e += THREADS)
                p.tr_fint[frame * M * NP + e] = make_float2(0.0f, 0.0f);
#pragma unroll 1
            for (int k = tid; k < half; k += THREADS)
                p.tr_fft[frame * half + k] = ema_end[k];
            if (tid == 0) {
                p.tr_rx[frame] = 0.0f;
                p.tr_high[frame] = 0;
            }
        }
    }

    // the eye probe: the last valid frame's integrators, on chip still
    if (p.eye_re != nullptr) {
        const bool ok = f > 0;
        const float2* fl = fi + ((f - 1) & 1) * M * NP;
#pragma unroll 1
        for (int e = tid; e < M * NP; e += THREADS) {
            const float2 v = ok ? fl[e] : make_float2(0.0f, 0.0f);
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
        p.fft_out[lane * half + k] = ema_end[k];
    if (tid < M) {
        p.fest_out[lane * M + tid] = st_fest[tid];
        p.phi_out[lane * M + tid] = st_phi[tid];
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
