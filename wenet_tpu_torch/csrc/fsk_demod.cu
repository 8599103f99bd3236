// Persistent 2/4-FSK demodulator frame loop for Hopper (sm_90a).
//
// Replaces the per-frame scan body of wenet_tpu/ops/fsk.py::demod_stream
// (:505, with _demod_frame :344 and _freq_est_step :297), which the JAX
// package ran as an XLA lax.scan rather than a Pallas kernel, and the port's
// Python frame loop (ops/fsk.demod_stream_reference, one launch-heavy step a
// frame).  Its plain version is that loop; the wrapper is
// kernels/fsk_demod.py.
//
// Design: two paths with the same per-frame arithmetic, bit for bit.  The
// lane path: one block of 512 threads per lane (a capture, a chunk of a
// fused slab, a trial of a sweep, an offset of the acquisition search)
// walks its lane's frames in order with the whole DemodState in shared
// memory (1.-5.).  The frame-parallel path (6.) spreads a lane's frames over
// the card; the lane path then takes over from the frame it reached.  A
// lane's frames are serial, so at small L the lane path is latency-bound;
// its design shortens each frame's dependency chain:
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
// 6. The frame-parallel path: speculate the elastic nin, verify, re-run.
//    The only nonlinear dependence between frames is nin (frame f's timing
//    sets frame f+1's, one of three values); given the nin of every frame,
//    the rest splits into functions of one frame (its position, estimator
//    DFT, peak picks, downconvert, sums, timing and decisions) and cheap
//    serial recurrences (the EMA, 128 bins wide; the phase of each tone;
//    the ppm IIR and the SNR average).  So one cooperative launch, its
//    blocks resident and joined by grid barriers (grid.sync), runs
//    rounds: each lane takes a window of frames from a frame whose state is
//    known, guesses nin = N for every frame after the first, and runs
//    (a) the estimator blocks' band-masked magnitudes, SPEC_FPB frames a
//        block at once in the estimator warps' sample groups and orders;
//    (b) the EMA, serial over the window, a thread a bin;
//    (c) each frame's peak picks (a warp a frame), and the phase chain's
//        terms off the chain, which need the frame before's picks too;
//    (d) the phase chain, serial, a thread a tone (tone_chain; its fmod an
//        exact fmaf remainder instead of fmodf's loop, mod_two_pi);
//    (e) each frame's demod, a block a frame, in the lane path's sums;
//        the first frame whose timing chose another nin than the guess;
//    (f) the ppm and SNR chains over the frames up to that one, which are
//        kept (their outputs are final); the next window starts at the
//        first frame not kept with its nin exact.
//    The serial passes run on one block a lane; the other threads of the
//    block stream their inputs through shared memory with cp.async
//    (stage_rows) and the chains run straight-line over whole chunks.  A
//    window that kept every frame doubles; one that missed restarts at
//    twice the frames it kept (SPEC_MIN_WINDOW at least).  A lane whose
//    rounds miss before keeping SPEC_MIN_WINDOW frames SPEC_MAX_POOR times
//    in a row (noise: nin moves about every other frame) is left to the
//    lane path, which always runs after this launch from each lane's
//    first frame not kept (DemodPtrs.first, the state in the outputs'
//    place) and returns at once where nothing is left.  The eye probe of a
//    lane that the lane path leaves alone is its last kept frame's
//    integrators, formed again at the end.  Both launches are
//    fsk_demod_kernel (a template flag): the profiler's name of the demod.

// Bound: per frame a lane reads about N samples and writes Nbits soft bits,
// Nbits hard bits and a few stats, a few kB; the work is about 8 fs Ndft/2
// float32 operations for the DFT plus a few tens of thousands for the rest,
// which one SM does in under a microsecond; a frame is a chain of dependent
// steps, each a shared-memory or shuffle latency, so the lane path is bound
// by latency, not by bytes or operations, and the frame-parallel path by
// its serial chains (the phase chain's float64 adds and conversions, some
// 90 ns a frame).
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

#include <cooperative_groups.h>
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

// the frame-parallel path (see 6.)
#define SPEC_MIN_WINDOW 32      // the smallest window after a miss,
#define SPEC_FIRST_WINDOW 2048  // the first of a launch (it doubles on)
#define SPEC_MAX_POOR 16        // a lane whose rounds miss before keeping
//                                 SPEC_MIN_WINDOW frames this many times in
//                                 a row is left to the lane path
#define SPEC_FRAMES_PER_BLOCK 8 // grid: a block for this many frames
// counters (DemodPtrs.counters)
#define CNT_SPEC_FRAMES 0       // frames kept by the frame-parallel path
#define CNT_ROUNDS 1            // its rounds, one a window of a lane
#define CNT_LANE_FRAMES 2       // frames the lane path took after it
#define CNT_FALLBACKS 3         // lanes it left to the lane path

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
    int spec_cap;                // frames of a lane's frame-parallel window
    //                              scratch (0: the lane path alone)
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
    const int* first;       // (lanes,) or null: the lane path's first frame
    float* spec_f;          // the frame-parallel path's scratch
    int* spec_i;            //   (spec_scratch), its first int the lanes'
    //                           first frames for the lane path
    unsigned long long* counters;   // or null: work counts (CNT_*)
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
// stamp 5: decisions      (warp 0: frame f's symbol decisions and Eb/N0)
// stamp 6: ebno_state     (warp 0: the stores)
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

// the band-masked magnitude of DFT bin k: sqrtf(0) outside the band, as
// the plain version's, without the call that sqrtf takes for a zero
__device__ __forceinline__ float band_mag(const DemodGeom& g, int k, float re,
                                          float im) {
    const bool band = k >= g.f_min_bin && k < g.f_max_bin - 1;
    return band ? sqrtf(re * re + im * im) : 0.0f;
}

__device__ __forceinline__ float ema_update(const DemodGeom& g, float ema,
                                            float mag) {
    return ema * g.one_m_tc + mag * g.tc;
}

// the EMA after one estimator block: the DFT's band-masked magnitude
__device__ __forceinline__ float ema_step(const DemodGeom& g, int k,
                                          float ema, float re, float im) {
    return ema_update(g, ema, band_mag(g, k, re, im));
}

// M first-max peak picks with +/- f_zero_bins blanking on one warp's copy
// of an EMA row in registers (v[r]: bin 32 r + lane, -1 past the last),
// sorted ascending; every lane gets every pick
template <int M>
__device__ __forceinline__ void pick_peaks(const DemodGeom& g,
                                           float (&v)[MAX_BINS],
                                           int (&peaks)[M]) {
    const int wl = threadIdx.x & 31, half = g.half;
#pragma unroll
    for (int r = 0; r < M; ++r) peaks[r] = 0;
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
}

// floor-mod of x by g.two_pi (jnp.mod): fmod, then + two_pi where the signs
// differ.  fmod is exact, so it is formed exactly here without fmodf's
// loop: q, the truncated quotient of |x| by two_pi, is off by at most one
// from |x| * (1 / two_pi) (|x| < 2^20), and |x| - q two_pi in one fmaf is
// exact for the right q (it is the fmod); a wrong q shows as a remainder
// below 0 or at least two_pi.  NaN and larger |x| take fmodf.
__device__ __forceinline__ float mod_two_pi(const DemodGeom& g, float x) {
    const float y = g.two_pi, ax = fabsf(x);
    float r;
    if (ax < 1048576.0f) {
        const float q = truncf(ax * (1.0f / y));
        const float r0 = fmaf(-q, y, ax);
        const float rl = fmaf(-(q - 1.0f), y, ax);
        const float rh = fmaf(-(q + 1.0f), y, ax);
        r = copysignf(r0 < 0.0f ? rl : (r0 >= y ? rh : r0), x);
    } else {
        r = fmodf(x, y);
    }
    if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = r + y;
    return r;
}

// mod_two_pi's short path alone, for |x| < 2^20; ok turns false where x
// is not in that range (the caller forms those frames again with
// mod_two_pi), so that a chain of them has no branch
__device__ __forceinline__ float mod_two_pi_short(const DemodGeom& g, float x,
                                                  bool& ok) {
    const float y = g.two_pi, ax = fabsf(x);
    ok = ok && ax < 1048576.0f;
    const float q = truncf(ax * (1.0f / y));
    const float r0 = fmaf(-q, y, ax);
    const float rl = fmaf(-(q - 1.0f), y, ax);
    const float rh = fmaf(-(q + 1.0f), y, ax);
    float r = copysignf(r0 < 0.0f ? rl : (r0 >= y ? rh : r0), x);
    if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r = r + y;
    return r;
}

// one tone of a frame of nin samples whose new estimate is fn, after a
// frame whose estimates were prev0 (tone 0) and prevm (this tone): its
// latched tone la and the float64 products that the phase chain adds
// (theta0 = p1 + phi, phi_next = p2 + theta0, each rounded to float32)
__device__ __forceinline__ void tone_terms(const DemodGeom& g, int nin,
                                           float fn, float prev0, float prevm,
                                           float& la, double& p1,
                                           double& p2) {
    const float noldf = (float)(g.Nmem - nin);
    const float ninf = (float)nin;
    const float Sf = (float)g.S;
    la = prev0 < 1.0f ? fn : prevm;
    const float a = -((g.two_pi * (noldf - Sf)) * la);
    p1 = __dmul_rn((double)a, (double)g.inv_fs);
    p2 = __dmul_rn((double)g.two_pi_fs,
                   (double)fma1(la, noldf, fn * (ninf - Sf)));
}

// the phase chain of one tone and frame: theta0 from the phase phi the
// frame before ended at, and the next phase (fma1's roundings)
__device__ __forceinline__ void tone_chain(const DemodGeom& g, double p1,
                                           double p2, float phi, float& th,
                                           float& phin) {
    th = __double2float_rn(__dadd_rn(p1, (double)phi));
    phin = mod_two_pi(g, __double2float_rn(__dadd_rn(p2, (double)th)));
}

// tone_chain with mod_two_pi_short
__device__ __forceinline__ void tone_chain_short(const DemodGeom& g, double p1,
                                                 double p2, float phi,
                                                 float& th, float& phin,
                                                 bool& ok) {
    th = __double2float_rn(__dadd_rn(p1, (double)phi));
    phin = mod_two_pi_short(
        g, __double2float_rn(__dadd_rn(p2, (double)th)), ok);
}

// both: a tone's latched frequency la, start phase th and next phase
__device__ __forceinline__ void tone_phase(const DemodGeom& g, int nin,
                                           float fn, float prev0, float prevm,
                                           float phi, float& la, float& th,
                                           float& phin) {
    double p1, p2;
    tone_terms(g, nin, fn, prev0, prevm, la, p1, p2);
    tone_chain(g, p1, p2, phi, th, phin);
}

// window sample t of a frame (nold samples at the latched tones, the rest
// at this frame's, phase-continuous): s * e^{-j ang} for each tone
template <int M>
__device__ __forceinline__ void downconvert(const DemodGeom& g, float2 s,
                                           int t, float noldf,
                                           const float (&fn)[M],
                                           const float (&la)[M],
                                           const float (&th)[M], float2* d) {
    const float tf = (float)t;
#pragma unroll
    for (int m = 0; m < M; ++m) {
        const float inner = fma1(fn[m], fmaxf(tf - noldf, 0.0f),
                                 la[m] * fminf(tf, noldf));
        const float ang = fma1(g.two_pi_fs, inner, th[m]);
        const float cs = cosf(ang), sn = sinf(ang);
        d[m * g.Nmem + t] =
            make_float2(s.x * cs + s.y * sn, s.y * cs - s.x * sn);
    }
}

// integrate-and-dump (window sums of Ts samples at stride S) and the timing
// line's terms, summed in float64: slot t of 512 sums q = t, t + 512, ...,
// each 32 slots by a shuffle tree, into red[slot / 32].  The warp takes the
// NS slots of 32 v0, v0 + vstep, ... at once (chains in flight); PROBE
// traces the integrators of frame `frame`.
template <int M, int NS, bool PROBE>
__device__ __forceinline__ void slot_sums(const DemodGeom& g, const float2* d,
                                          float2* fo, const float* spin_re,
                                          const float* spin_im, int v0,
                                          int vstep, double* red,
                                          float2* tr_fint, long long frame) {
    const int wl = threadIdx.x & 31, NP = g.NP, Nmem = g.Nmem;
    double are[NS], aim[NS];
#pragma unroll
    for (int h = 0; h < NS; ++h) are[h] = aim[h] = 0.0;
#pragma unroll 1
    for (int q0 = wl; q0 < NP; q0 += THREADS) {
        int q[NS];
        bool on[NS];
        float ft[NS];
#pragma unroll
        for (int h = 0; h < NS; ++h) {
            const int vw = v0 + h * vstep;
            q[h] = q0 + 32 * vw;
            on[h] = vw < NWARPS && q[h] < NP;
            ft[h] = 0.0f;
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
            const float2* xs[NS];
            float re[NS], im[NS];
#pragma unroll
            for (int h = 0; h < NS; ++h) {
                xs[h] = d + m * Nmem + (on[h] ? q[h] : 0) * g.S;
                re[h] = xs[h][0].x;
                im[h] = xs[h][0].y;
            }
            if (g.Ts <= TS_MAX) {
                // every load issued at once: the samples past Ts (inside
                // shared memory) are read, not added
#pragma unroll
                for (int u = 1; u < TS_MAX; ++u)
#pragma unroll
                    for (int h = 0; h < NS; ++h) {
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
                    for (int h = 0; h < NS; ++h) {
                        re[h] = re[h] + xs[h][u].x;
                        im[h] = im[h] + xs[h][u].y;
                    }
            }
#pragma unroll
            for (int h = 0; h < NS; ++h) {
                if (on[h]) {
                    fo[m * NP + q[h]] = make_float2(re[h], im[h]);
                    if constexpr (PROBE)
                        tr_fint[(frame * M + m) * NP + q[h]] =
                            make_float2(re[h], im[h]);
                }
                const float v = fma1(re[h], re[h], im[h] * im[h]);
                ft[h] = m == 0 ? v : ft[h] + v;
            }
        }
#pragma unroll
        for (int h = 0; h < NS; ++h)
            if (on[h]) {
                are[h] += (double)ft[h] * (double)spin_re[q[h]];
                aim[h] += (double)ft[h] * (double)spin_im[q[h]];
            }
    }
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int h = 0; h < NS; ++h) {
            are[h] += __shfl_down_sync(0xffffffffu, are[h], off);
            aim[h] += __shfl_down_sync(0xffffffffu, aim[h], off);
        }
    }
    if (wl == 0) {
#pragma unroll
        for (int h = 0; h < NS; ++h) {
            const int vw = v0 + h * vstep;
            if (vw < NWARPS) {
                red[vw] = are[h];
                red[NWARPS + vw] = aim[h];
            }
        }
    }
}

// warp 0's sum of the NWARPS slot groups' timing sums (every lane reads
// red), then norm_rx_timing in lane 0
__device__ __forceinline__ float timing_norm(const DemodGeom& g,
                                             const double* red) {
    const int wl = threadIdx.x & 31;
    double are = wl < NWARPS ? red[wl] : 0.0;
    double aim = wl < NWARPS ? red[NWARPS + wl] : 0.0;
    for (int off = NWARPS / 2; off > 0; off >>= 1) {
        are += __shfl_down_sync(0xffffffffu, are, off);
        aim += __shfl_down_sync(0xffffffffu, aim, off);
    }
    return atan2_poly(g, (float)aim, (float)are) / g.two_pi;
}

// the elastic nin of the frame after one whose timing is norm
__device__ __forceinline__ int next_nin(const DemodGeom& g, float norm) {
    return norm > 0.25f ? g.N + g.Ts / 2
                        : (norm < -0.25f ? g.N - g.Ts / 2 : g.N);
}

// the clock-offset ppm IIR, gated on jumps of the timing
__device__ __forceinline__ float ppm_step(const DemodGeom& g, float norm,
                                          float prev_norm, float ppm) {
    const float d_norm = norm - prev_norm;
    const float appm = 1e6f * d_norm / (float)g.Nsym;
    return fabsf(d_norm) < 0.2f ? 0.9f * ppm + 0.1f * appm : ppm;
}

// the interpolation between the floor and ceil integrator phases at the
// timing rx = norm * P
__device__ __forceinline__ void timing_phases(float rx, float& low,
                                              float& fract, float& high) {
    low = floorf(rx);
    fract = rx - low;
    high = low + (fract > 0.0f ? 1.0f : 0.0f);
}

// one warp: the frame's symbol decisions from its integrators fo, soft and
// hard bits stored, and lane 0 returns its Eb/N0
template <int M>
__device__ __forceinline__ float decide(const DemodGeom& g, const float2* fo,
                                        float low, float fract, float high,
                                        float* so, uint8_t* bo) {
    const int wl = threadIdx.x & 31, NP = g.NP;
    float sm = 0.0f, sw = 0.0f;
    const float w_lo = 1.0f - fract;
#pragma unroll 1
    for (int k = wl; k < g.Nsym; k += 32) {
        const int st = (k + 1) * g.P;
        // rx timing lies in [-P/2, P/2], so both phases are in range; the
        // clamp only keeps a NaN timing inside shared memory
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
            const float m2 = sqrtf(tmax[2 % M]), m3 = sqrtf(tmax[3 % M]);
            bo[2 * k] = (sym >> 1) & 1;
            bo[2 * k + 1] = sym & 1;
            so[2 * k] = ((-m0 - m1) + m2) + m3;
            so[2 * k + 1] = ((-m0 + m1) - m2) + m3;
        }
        sm = sm + sqrtf(wv);
        sw = sw + wv;
    }
    for (int off = 16; off > 0; off >>= 1) {
        sm = sm + __shfl_down_sync(0xffffffffu, sm, off);
        sw = sw + __shfl_down_sync(0xffffffffu, sw, off);
    }
    const float meane = sm / (float)g.Nsym;
    float stde = sw / (float)g.Nsym - meane * meane;
    stde = sqrtf(fmaxf(stde, 0.0f));
    return -6.0f + 20.0f * log10f((1e-6f + meane) / (1e-6f + stde));
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
        int peaks[M];
        pick_peaks<M>(g, v, peaks);
        if (wl < M) {
            const int m = wl;
            int pk = peaks[0];
#pragma unroll
            for (int r = 1; r < M; ++r) pk = r == m ? peaks[r] : pk;
            const float fn = (float)pk * g.bin_hz;
            float la, th, r;
            tone_phase(g, cand_nin(g, c, nin_given), fn, prev_fnew[0],
                       prev_fnew[m], prev_phi[m], la, th, r);
            est_out[c][0][m] = fn;
            est_out[c][1][m] = la;
            est_out[c][2][m] = th;
            est_out[c][3][m] = r;
        }
        PHASE(11, EST_WARP0);
    }
}

// ------------------------------------------------------------ the lane path

// The lane path (the warp-specialised frame loop of 3. above): one block a
// lane walks the lane's frames from frame first[lane] (0 without `first`)
// with the state of *_in, which the frame-parallel path leaves there for
// it.  A lane with no valid frame left only closes: it zeroes the frames
// past its end and stores the state.
template <int M, bool PROBE>
__device__ __forceinline__ void lane_body(const DemodGeom& g,
                                          const DemodPtrs& p) {
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
    // the lane's first frame; f below counts the frames from it
    const int f0 = p.first != nullptr ? p.first[lane] : 0;
    const int nf = g.num_frames - f0;
    const long long frame0 = (long long)lane * g.num_frames + f0;
    const bool idle = nf <= 0 || (long long)p.pos_in[lane] + p.nin_in[lane]
                                     > nvalid;

    if (!idle) {
        // stage the tables
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
    }
    // and the state
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
    if (warp == PRODUCER && !idle) {
        const long long end = start + p.pos_in[lane] + p.nin_in[lane];
        next_chunk = (end - Nmem) >> chunk_shift(g.fmt);
        ring_fill(g, p.data, ring, next_chunk, end + g.ahead);
        cp_async_wait_all();
    }
    __syncthreads();

    if (idle) {
        if (warp == 0 && wl == 0) {
            st_nin_end = p.nin_in[lane];
            p.pos_out[lane] = p.pos_in[lane];
            p.nin_out[lane] = p.nin_in[lane];
            p.norm_out[lane] = p.norm_in[lane];
            p.ppm_out[lane] = p.ppm_in[lane];
            p.ebno_out[lane] = p.ebno_in[lane];
            p.snr_out[lane] = p.snr_in[lane];
        }
    } else if (warp >= EST_WARP0) {
        // ---- the estimator warps: frame f+1's candidates during frame f,
        // and first (f = -1) frame 0's from the state, its nin as given
#pragma unroll 1
        for (int f = -1; f < nf; ++f) {
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
                if (f + 1 == nf) break;             // no frame to estimate
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
        for (int f = 0; f < nf; ++f) {
            PHASE(13, 1);
            bar_sync(BAR_GO, THREADS);            // frame f's estimate; ring
            const int pos = st_pos[f & 1], nin = st_nin[f & 1];
            if ((long long)pos + nin > nvalid) break;     // block-uniform
            PHASE(0, 1);
            const int x = nin_choice(g, nin);
            const long long frame = frame0 + f;
            float fn[M], la[M], th[M];
#pragma unroll
            for (int m = 0; m < M; ++m) {
                fn[m] = est[f & 1][x][0][m];
                la[m] = est[f & 1][x][1][m];
                th[m] = est[f & 1][x][2][m];
            }
            // 4. downconvert the window (lane samples pos + nin - Nmem ..
            // pos + nin - 1) from the ring; PROBE: the chosen candidate's
            // EMA
            if constexpr (PROBE) {
                const float* em = ema + ((f & 1) * 3 + x) * half;
#pragma unroll 1
                for (int k = dt; k < half; k += DEMOD_THREADS)
                    p.tr_fft[frame * half + k] = em[k];
            }
            {
                const long long base = (long long)pos + nin - Nmem;
                const float noldf = (float)(Nmem - nin);
#pragma unroll 2
                for (int t = dt; t < Nmem; t += DEMOD_THREADS)
                    downconvert<M>(
                        g, lane_sample(g, ring, start, nvalid, base + t), t,
                        noldf, fn, la, th, d);
            }
            bar_sync(BAR_DEMOD, DEMOD_THREADS);
            PHASE(1, 1);

            // 5. integrate-and-dump and the timing sums (slot_sums), a warp
            // SLOTS slots of 32 at once
            float2* fo = fi + (f & 1) * M * NP;
#pragma unroll 1
            for (int v0 = dw; v0 < NWARPS; v0 += SLOTS * DEMOD_WARPS)
                slot_sums<M, SLOTS, PROBE>(g, d, fo, spin_re, spin_im, v0,
                                           DEMOD_WARPS, red, p.tr_fint,
                                           frame);
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
        if (nf > 0) bar_arrive(BAR_GO, THREADS);
#pragma unroll 1
        for (; f < nf; ++f) {
            if ((long long)pos + nin > nvalid) break;     // block-uniform
            const long long frame = frame0 + f;
            PHASE(12, 0);
            bar_sync(BAR_RED, DEMOD_THREADS + 32);
            PHASE(3, 0);
            // frame f's candidate: its f_new and phi_next, the state
            const int x = nin_choice(g, nin);
            const float fnew = wl < M ? est[f & 1][x][0][wl] : 0.0f;
            const float phin = wl < M ? est[f & 1][x][3][wl] : 0.0f;
            // the chain: the timing, frame f+1's nin, the hand-off
            const float norm = timing_norm(g, red);
            int nin_next = 0;
            if (wl == 0) {
                nin_next = next_nin(g, norm);
                st_pos[(f + 1) & 1] = pos + nin;
                st_nin[(f + 1) & 1] = nin_next;
            }
            PHASE(4, 0);
            __syncwarp();
            if (f + 1 < nf) bar_arrive(BAR_GO, THREADS);
            // off the chain: the rest of the timing line
            float ppm = 0.0f, low = 0.0f, fract = 0.0f, high = 0.0f;
            if (wl == 0) {
                const float rx = norm * (float)g.P;
                ppm = ppm_step(g, norm, st_norm, st_ppm);
                timing_phases(rx, low, fract, high);
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
            // and ceil integrator phases, and Eb/N0
            const float ebno = decide<M>(g, fi + (f & 1) * M * NP, low, fract,
                                         high, p.soft + frame * g.Nbits,
                                         p.bits + frame * g.Nbits);
            PHASE(5, 0);
            if (wl == 0) {
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
            if (p.counters != nullptr && f > 0)      // after the other path
                atomicAdd(p.counters + CNT_LANE_FRAMES,
                          (unsigned long long)f);
        }
    }
    __syncthreads();
    const int f = st_frames;
    // the last valid frame's EMA, else the state's
    const float* ema_end = f > 0 ? ema + st_last * half : fft;

    // frames past the lane's end: invalid, fields zeroed
#pragma unroll 1
    for (int r = f; r < nf; ++r) {
        const long long frame = frame0 + r;
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

    // the eye probe: the last valid frame's integrators, on chip still (a
    // lane that starts past frame 0 and demodulates none keeps the eye the
    // frame-parallel path stored)
    if (p.eye_re != nullptr && (f > 0 || f0 == 0)) {
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

// ------------------------------------------------- the frame-parallel path

// The frame-parallel path (6. above), one cooperative launch.  Its scratch
// in global memory, per lane: `spec_cap` frame rows of floats (the
// estimator blocks' magnitudes, the EMA after the frame, the phase terms,
// f_new, latched, theta0, phi_next, norm_rx_timing, Eb/N0, the high
// sample) and of ints (the timing's next nin); the carried state and the
// last kept frame's tones (floats); the window and its verdict (ints).
#define SPEC_GROUP 128          // threads of one frame in the estimator pass
#define SPEC_FPB (THREADS / SPEC_GROUP)
#define SPEC_CHUNK 32           // frames a serial chain stages at once,
#define SPEC_STAGES 4           // in this many buffers (cp.async)
enum {                          // a lane's ints
    LI_F0,                      // the window's first frame
    LI_WLEN,                    // its frames (0: the lane is not running)
    LI_POS, LI_NIN,             // pos and nin of frame LI_F0, exact
    LI_W,                       // the frames the next window may take
    LI_POOR,                    // poor rounds in a row
    LI_BAD,                     // the first frame whose next nin missed
    LI_LPOS, LI_LNIN,           // pos and nin of the last kept frame
    LI_N
};

struct SpecScratch {
    long long row, rows, lane, lanes, first, ints, nxt, n_int;
    int mag, ema, terms, fnew, la, th, phin, norm, ebno, high, pterms;
    int l_ema, l_fest, l_phi, l_norm, l_ppm, l_ebno, l_snr, l_fn, l_la,
        l_th, l_high;                                       // in a lane's
};

__host__ __device__ static inline SpecScratch spec_scratch(const DemodGeom& g) {
    SpecScratch s;
    const int half = g.half, M = g.M;
    s.mag = 0;                         // every field 16-byte aligned
    s.ema = g.max_blocks * half;
    s.terms = s.ema + half;            // M p1, then M p2 (float64)
    s.fnew = s.terms + 4 * M;
    s.la = s.fnew + M;
    s.th = s.la + M;
    s.phin = s.th + M;
    s.norm = s.phin + M;               // norm, Eb/N0, high sample, unused
    s.ebno = s.norm + 1;
    s.high = s.ebno + 1;
    s.pterms = s.norm + 4;             // the ppm gate, 0.1 appm, 0.5 Eb/N0
    s.row = s.pterms + 4;
    s.rows = (long long)g.lanes * g.spec_cap * s.row;
    s.l_ema = 0;
    s.l_fest = half;
    s.l_phi = s.l_fest + M;
    s.l_norm = s.l_phi + M;
    s.l_ppm = s.l_norm + 1;
    s.l_ebno = s.l_ppm + 1;
    s.l_snr = s.l_ebno + 1;
    s.l_fn = s.l_snr + 1;
    s.l_la = s.l_fn + M;
    s.l_th = s.l_la + M;
    s.l_high = s.l_th + M;
    s.lane = s.l_high + 1;
    s.lanes = s.rows + (long long)g.lanes * s.lane;          // floats
    s.first = 0;                                             // ints: first,
    s.ints = g.lanes;                                        // lane ints,
    s.nxt = s.ints + (long long)g.lanes * LI_N;              // next nins
    s.n_int = s.nxt + (long long)g.lanes * g.spec_cap;
    return s;
}

// shared memory of a block of the frame-parallel path, in bytes: the
// tables, the lanes' windows, then the passes' buffers, which share one
// region (the estimator's SPEC_FPB frames, one frame's downconvert, or a
// serial chain's SPEC_STAGES chunks)
struct SpecSmem {
    size_t tab, idx, hann, spin, win, work, total;
    size_t group, wbn, wbt, wb, part_c, part_t, part;        // estimator
    size_t red, d, fi;                                       // demod
};

__host__ __device__ static inline SpecSmem spec_smem(const DemodGeom& g) {
    SpecSmem S;
    size_t at = 0;
    const bool later = g.max_blocks > 1;
    S.tab = take(at, (size_t)g.n_tab * sizeof(float2));
    S.idx = take(at, g.idx_smem ? (size_t)(g.Ndft / 4 + 1) * g.half * 8 : 0);
    S.hann = take(at, (size_t)g.Ndft * sizeof(float));
    S.spin = take(at, 2 * (size_t)g.NP * sizeof(float));
    S.win = take(at, 5 * (size_t)(g.lanes + 1) * sizeof(int));
    S.work = at;
    size_t a = 0;                                  // one estimator frame
    S.wbn = take(a, (size_t)g.fs_common * sizeof(float2));
    S.wbt = take(a, (size_t)g.tail_len * sizeof(float2));
    S.wb = take(a, later ? (size_t)(g.Ndft + 4) * sizeof(float2) : 0);
    S.part_c =
        take(a, 2 * (size_t)common_groups(g.half) * g.half * sizeof(float));
    S.part_t = take(a, 2 * (size_t)g.half * sizeof(float));
    S.part = take(
        a, later ? 2 * (size_t)dft_groups(g.half) * g.half * sizeof(float)
                 : 0);
    S.group = a;
    size_t e = 0;                                  // one demod frame
    S.red = take(e, 2 * NWARPS * sizeof(double));
    S.d = take(e, (size_t)g.M * g.Nmem * sizeof(float2));
    S.fi = take(e, (size_t)g.M * g.NP * sizeof(float2));
    // the serial chains' SPEC_STAGES chunks of staged inputs
    const size_t mags = (size_t)g.max_blocks * g.half * sizeof(float);
    const size_t terms = 2 * (size_t)g.M * sizeof(double);
    const size_t chain =
        SPEC_STAGES * SPEC_CHUNK * (mags > terms ? mags : terms);
    size_t work = SPEC_FPB * S.group > e ? SPEC_FPB * S.group : e;
    S.total = S.work + (chain > work ? chain : work);
    return S;
}

// lane sample li of the lane that starts at global sample `start`, from
// global memory, converted as ring_sample converts: 0.0 outside [0, nvalid)
// and outside the buffer
__device__ __forceinline__ float2 global_sample(const DemodGeom& g,
                                                const void* data,
                                                long long start,
                                                long long nvalid,
                                                long long li) {
    const long long gi = start + li;
    if (!(li >= 0 && li < nvalid && gi >= 0 && gi < g.n_total))
        return make_float2(0.0f, 0.0f);
    if (g.fmt == 1) {
        const uchar2 v = __ldg((const uchar2*)data + gi);
        return make_float2(((float)v.x - 127.0f) * 0.0078125f,
                           ((float)v.y - 127.0f) * 0.0078125f);
    }
    if (g.fmt == 2) {
        const short2 v = __ldg((const short2*)data + gi);
        return make_float2((float)v.x * g.cs16_scale,
                           (float)v.y * g.cs16_scale);
    }
    return __ldg((const float2*)data + gi);
}

// frames the window at frame f0 (pos0, nin0) may take: at most W, up to the
// lane's last frame and while pos + nin <= nvalid under the guess nin = N
// after f0; 0 where frame f0 is past the lane's end
__device__ __forceinline__ int spec_window(const DemodGeom& g, int f0,
                                           long long pos0, int nin0,
                                           long long nvalid, int W) {
    if (f0 >= g.num_frames || pos0 + nin0 > nvalid) return 0;
    const long long fit = (nvalid - pos0 - nin0) / g.N + 1;
    const long long n = min((long long)min(W, g.num_frames - f0), fit);
    return (int)n;
}

// the serial passes' stream: the loader threads (t0 of nt) stage rows
// [c SPEC_CHUNK, (c + 1) SPEC_CHUNK) of a window of n frames (the last row
// again past n), of each `pieces` 16-byte pieces from float `at`, into
// buffer c % SPEC_STAGES of dst with cp.async: one group a chunk (empty
// past the last chunk), so that SPEC_STAGES - 1 chunks are in flight
__device__ __forceinline__ void stage_rows(const float* r0, int row, int at,
                                           int pieces, int c, int n,
                                           int chunks, float4* dst, int t0,
                                           int nt) {
    if (c < chunks) {
        float4* b = dst + (c % SPEC_STAGES) * SPEC_CHUNK * pieces;
#pragma unroll 1
        for (int i = t0; i < SPEC_CHUNK * pieces; i += nt) {
            const int u = i / pieces, v = i - u * pieces;
            const int j = min(c * SPEC_CHUNK + u, n - 1);
            cp_async16(b + i, r0 + (long long)j * row + at + 4 * v, 16);
        }
    }
    cp_async_commit();
}

__device__ __forceinline__ void cp_async_wait_stages() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(SPEC_STAGES - 2)
                 : "memory");
}

// the lane of work item `it` of the round: the last lane whose first item
// is at most it (off: the lanes' first items, then the total)
__device__ __forceinline__ int lane_of(const int* off, int lanes, int it) {
    int lo = 0, hi = lanes - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (off[mid] <= it) lo = mid; else hi = mid - 1;
    }
    return lo;
}

template <int M>
__device__ __forceinline__ void spec_body(const DemodGeom& g,
                                          const DemodPtrs& p) {
    extern __shared__ __align__(16) char smem[];
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    const SpecSmem S = spec_smem(g);
    const SpecScratch Q = spec_scratch(g);
    float2* tab = (float2*)(smem + S.tab);
    const uint2* idx = g.idx_smem ? (const uint2*)(smem + S.idx) : p.tw_idx;
    float* hann = (float*)(smem + S.hann);
    float* spin_re = (float*)(smem + S.spin);
    float* spin_im = spin_re + g.NP;
    const int L = g.lanes;
    int* off = (int*)(smem + S.win);           // the lanes' first items,
    int* w_f0 = off + (L + 1);                 // and their windows
    int* w_pos = w_f0 + (L + 1);
    int* w_nin = w_pos + (L + 1);
    int* w_len = w_nin + (L + 1);
    char* work = smem + S.work;

    const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
    const int half = g.half, Ndft = g.Ndft, Nmem = g.Nmem, cap = g.spec_cap;
    float* rows = p.spec_f;
    float* lf = p.spec_f + Q.rows;
    int* first = p.spec_i + Q.first;
    int* li = p.spec_i + Q.ints;
    int* nxt = p.spec_i + Q.nxt;

#pragma unroll 1
    for (int e = tid; e < g.n_tab; e += THREADS) tab[e] = p.tw_tab[e];
    if (g.idx_smem) {
#pragma unroll 1
        for (int e = tid; e < (Ndft / 4 + 1) * half; e += THREADS)
            ((uint2*)(smem + S.idx))[e] = p.tw_idx[e];
    }
#pragma unroll 1
    for (int e = tid; e < Ndft; e += THREADS) hann[e] = p.hann[e];
#pragma unroll 1
    for (int q = tid; q < g.NP; q += THREADS) {
        spin_re[q] = p.spin_re[q];
        spin_im[q] = p.spin_im[q];
    }
    // each lane's state into its scratch (block l takes lane l)
#pragma unroll 1
    for (int l = blockIdx.x; l < L; l += gridDim.x) {
        float* s = lf + l * Q.lane;
#pragma unroll 1
        for (int k = tid; k < half; k += THREADS)
            s[Q.l_ema + k] = p.fft_in[l * half + k];
        if (tid < M) {
            s[Q.l_fest + tid] = p.fest_in[l * M + tid];
            s[Q.l_phi + tid] = p.phi_in[l * M + tid];
        }
        if (tid == 0) {
            s[Q.l_norm] = p.norm_in[l];
            s[Q.l_ppm] = p.ppm_in[l];
            s[Q.l_ebno] = p.ebno_in[l];
            s[Q.l_snr] = p.snr_in[l];
            int* q = li + l * LI_N;
            q[LI_F0] = 0;
            q[LI_POS] = p.pos_in[l];
            q[LI_NIN] = p.nin_in[l];
            q[LI_W] = min(SPEC_FIRST_WINDOW, cap);
            q[LI_POOR] = 0;
            q[LI_BAD] = 0x7fffffff;
            q[LI_WLEN] = spec_window(g, 0, p.pos_in[l], p.nin_in[l],
                                     p.n_valid[l], q[LI_W]);
        }
    }

#pragma unroll 1
    for (;;) {
        grid.sync();
        // ---- the round's windows: every block reads them all
#pragma unroll 1
        for (int l = tid; l < L; l += THREADS) {
            const int* q = li + l * LI_N;
            w_f0[l] = __ldcg(q + LI_F0);
            w_pos[l] = __ldcg(q + LI_POS);
            w_nin[l] = __ldcg(q + LI_NIN);
            w_len[l] = __ldcg(q + LI_WLEN);
        }
        __syncthreads();
        if (tid == 0) {
            int total = 0;
            for (int l = 0; l < L; ++l) {
                off[l] = total;
                total += w_len[l];
            }
            off[L] = total;
        }
        __syncthreads();
        const int total = off[L];
        if (total == 0) break;                        // grid-uniform

        // ---- (a) each frame's estimator blocks: band-masked magnitudes,
        // SPEC_FPB frames at once, SPEC_GROUP threads each, in the
        // estimator warps' sample groups and orders
        {
            const int grp = tid / SPEC_GROUP, t = tid % SPEC_GROUP;
            char* gw = work + grp * S.group;
            float2* wbn = (float2*)(gw + S.wbn);
            float2* wbt = (float2*)(gw + S.wbt);
            float2* wb = (float2*)(gw + S.wb);
            float* part_c = (float*)(gw + S.part_c);
            float* part_t = (float*)(gw + S.part_t);
            float* part = (float*)(gw + S.part);
            const int fsc = g.fs_common, TL = g.tail_len;
            const int Gc = common_groups(half);
            const int kb = half / DFT_BINS, logkb = __ffs(kb) - 1;
#pragma unroll 1
            for (int b0 = blockIdx.x * SPEC_FPB; b0 < total;
                 b0 += gridDim.x * SPEC_FPB) {
                const int it = b0 + grp;
                const bool on = it < total;
                const int l = on ? lane_of(off, L, it) : 0;
                const int j = on ? it - off[l] : 0;
                const int nin = j > 0 ? g.N : w_nin[l];
                const long long pos =
                    j > 0 ? (long long)w_pos[l] + w_nin[l] +
                                (long long)(j - 1) * g.N
                          : w_pos[l];
                const long long start = p.starts[l], nvalid = p.n_valid[l];
                const int fsx = tail_fs(g, nin_choice(g, nin));
                float* row = rows + ((long long)l * cap + j) * Q.row;
#pragma unroll 1
                for (int i = t; i < fsc + TL; i += SPEC_GROUP) {
                    float2 x = make_float2(0.0f, 0.0f);
                    if (on && i < fsx)
                        x = global_sample(g, p.data, start, nvalid, pos + i);
                    const float w = hann[min(i, Ndft - 1)];
                    const float2 y = make_float2(x.x * w, x.y * w);
                    if (i < fsc)
                        wbn[i] = y;
                    else
                        wbt[i - fsc] = i < fsx ? y : make_float2(0.0f, 0.0f);
                }
                __syncthreads();
#pragma unroll 1
                for (int u = t; u < (Gc + 1) * kb; u += SPEC_GROUP) {
                    const int s = u >> logkb, k = u & (kb - 1);
                    const bool head = s < Gc;
                    const int i0 = head ? min(s * g.span_common, fsc) : fsc;
                    const int i1 = head ? min(fsc, i0 + g.span_common) : fsx;
                    const float2* xb = head ? wbn : wbt - fsc;
                    float* ore = head ? part_c + s * half : part_t;
                    float* oim = head ? part_c + (Gc + s) * half
                                      : part_t + half;
                    dft_bins(xb, tab, idx, half, k, kb, i0, i1, ore, oim);
                }
                __syncthreads();
#pragma unroll 1
                for (int k = t; k < half; k += SPEC_GROUP) {
                    float re = part_c[k], im = part_c[Gc * half + k];
#pragma unroll 1
                    for (int s = 1; s < Gc; ++s) {
                        re = re + part_c[s * half + k];
                        im = im + part_c[(Gc + s) * half + k];
                    }
                    if (on)
                        row[Q.mag + k] = band_mag(g, k, re + part_t[k],
                                                  im + part_t[half + k]);
                }
                if (g.max_blocks > 1) {
                    // the blocks after the first (3b. of the estimator)
                    const int G = dft_groups(half), logG = __ffs(G) - 1;
#pragma unroll 1
                    for (int jb = 1; jb < g.max_blocks; ++jb) {
                        const bool used = on && jb < nin / Ndft;
                        const int fs =
                            used ? min(max(nin - (jb + 1) * Ndft, 0), Ndft)
                                 : 0;
                        __syncthreads();
#pragma unroll 1
                        for (int i = t; i < ((fs + 3) & ~3); i += SPEC_GROUP) {
                            float2 y = make_float2(0.0f, 0.0f);
                            if (i < fs) {
                                const float2 s = global_sample(
                                    g, p.data, start, nvalid,
                                    pos + jb * Ndft + i);
                                y = make_float2(s.x * hann[i], s.y * hann[i]);
                            }
                            wb[i] = y;
                        }
                        __syncthreads();
                        const int span = (((fs + G - 1) >> logG) + 3) & ~3;
#pragma unroll 1
                        for (int u = t; u < G * kb; u += SPEC_GROUP) {
                            const int s = u >> logkb, k = u & (kb - 1);
                            const int i0 = min(s * span, fs);
                            dft_bins(wb, tab, idx, half, k, kb, i0,
                                     min(fs, i0 + span), part + s * half,
                                     part + (G + s) * half);
                        }
                        __syncthreads();
#pragma unroll 1
                        for (int k = t; k < half; k += SPEC_GROUP) {
                            float re = part[k], im = part[G * half + k];
#pragma unroll 1
                            for (int s = 1; s < G; ++s) {
                                re = re + part[s * half + k];
                                im = im + part[(G + s) * half + k];
                            }
                            if (used)
                                row[Q.mag + jb * half + k] =
                                    band_mag(g, k, re, im);
                        }
                    }
                }
                __syncthreads();            // the buffers, for the next
            }
        }
        grid.sync();

        // ---- (b) the EMA, serial over a lane's frames: a thread a bin
        // (tid < half) runs the chain over the frames' magnitudes, which
        // the other threads stream into shared memory (stage_rows)
#pragma unroll 1
        for (int l = blockIdx.x; l < L; l += gridDim.x) {
            const int n = w_len[l];
            if (n == 0) continue;
            const int logn = __ffs(Ndft) - 1;
            const int nb0 = w_nin[l] >> logn, nbn = g.N >> logn;
            const int per = g.max_blocks * half;     // a frame's magnitudes
            float* r0 = rows + (long long)l * cap * Q.row;
            float e = tid < half ? __ldcg(lf + l * Q.lane + Q.l_ema + tid)
                                 : 0.0f;
            const int chunks = (n + SPEC_CHUNK - 1) / SPEC_CHUNK;
            const bool loader = tid >= half;
            if (loader)
                for (int c = 0; c < SPEC_STAGES - 1; ++c)
                    stage_rows(r0, Q.row, Q.mag, per / 4, c, n, chunks,
                               (float4*)work, tid - half, THREADS - half);
#pragma unroll 1
            for (int c = 0; c < chunks; ++c) {
                if (loader) cp_async_wait_stages();
                __syncthreads();
                if (tid < half) {
                    const float* b = (const float*)work +
                                     (c % SPEC_STAGES) * SPEC_CHUNK * per;
                    float* dst = r0 + (long long)c * SPEC_CHUNK * Q.row +
                                 Q.ema + tid;
                    if (g.max_blocks == 1 && n - c * SPEC_CHUNK >= SPEC_CHUNK) {
                        // a whole chunk, one block a frame: straight-line,
                        // eight frames' magnitudes loaded at once
                        const bool use0 = (c == 0 ? nb0 : nbn) > 0;
                        const bool usen = nbn > 0;
#pragma unroll
                        for (int u0 = 0; u0 < SPEC_CHUNK; u0 += 8) {
                            float mg[8];
#pragma unroll
                            for (int v = 0; v < 8; ++v)
                                mg[v] = b[(u0 + v) * per + tid];
#pragma unroll
                            for (int v = 0; v < 8; ++v) {
                                if (u0 + v == 0 ? use0 : usen)
                                    e = ema_update(g, e, mg[v]);
                                dst[(long long)(u0 + v) * Q.row] = e;
                            }
                        }
                    } else {
#pragma unroll 1
                        for (int u = 0; u < SPEC_CHUNK; ++u) {
                            const int j = c * SPEC_CHUNK + u;
                            if (j >= n) break;
                            const int nb = j > 0 ? nbn : nb0;
#pragma unroll 1
                            for (int q = 0; q < nb; ++q)
                                e = ema_update(g, e,
                                               b[u * per + q * half + tid]);
                            dst[(long long)u * Q.row] = e;
                        }
                    }
                } else {
                    stage_rows(r0, Q.row, Q.mag, per / 4,
                               c + SPEC_STAGES - 1, n, chunks, (float4*)work,
                               tid - half, THREADS - half);
                }
            }
            if (loader) cp_async_wait_all();
            __syncthreads();
        }
        grid.sync();

        // ---- (c) each frame's M peak picks from its EMA, and the phase
        // chain's terms (tone_terms), which need the frame before's picks
        // too: a warp a frame picks both
#pragma unroll 1
        for (int it = blockIdx.x * NWARPS + warp; it < total;
             it += gridDim.x * NWARPS) {
            const int l = lane_of(off, L, it), j = it - off[l];
            float* row = rows + ((long long)l * cap + j) * Q.row;
            float v[MAX_BINS];
            int peaks[M], prev[M];
#pragma unroll
            for (int r = 0; r < MAX_BINS; ++r)
                v[r] = 32 * r + wl < half ? __ldcg(row + Q.ema + 32 * r + wl)
                                          : -1.0f;
            pick_peaks<M>(g, v, peaks);
            float prev0, prevm;
            if (j > 0) {
#pragma unroll
                for (int r = 0; r < MAX_BINS; ++r)
                    v[r] = 32 * r + wl < half
                               ? __ldcg(row - Q.row + Q.ema + 32 * r + wl)
                               : -1.0f;
                pick_peaks<M>(g, v, prev);
                int pm = prev[0];
#pragma unroll
                for (int r = 1; r < M; ++r) pm = r == wl ? prev[r] : pm;
                prev0 = (float)prev[0] * g.bin_hz;
                prevm = (float)pm * g.bin_hz;
            } else {
                const float* s = lf + l * Q.lane;
                prev0 = __ldcg(s + Q.l_fest);
                prevm = __ldcg(s + Q.l_fest + min(wl, M - 1));
            }
            int pk = peaks[0];
#pragma unroll
            for (int r = 1; r < M; ++r) pk = r == wl ? peaks[r] : pk;
            if (wl < M) {
                const float fn = (float)pk * g.bin_hz;
                float la;
                double* terms = (double*)(row + Q.terms);
                tone_terms(g, j > 0 ? g.N : w_nin[l], fn, prev0, prevm, la,
                           terms[wl], terms[M + wl]);
                row[Q.fnew + wl] = fn;
                row[Q.la + wl] = la;
            }
        }
        grid.sync();

        // ---- (d) the phase chain, serial: lanes m < M of warp 0 over the
        // frames' terms, which the other warps stream
#pragma unroll 1
        for (int l = blockIdx.x; l < L; l += gridDim.x) {
            const int n = w_len[l];
            if (n == 0) continue;
            float* r0 = rows + (long long)l * cap * Q.row;
            float phi = tid < M ? __ldcg(lf + l * Q.lane + Q.l_phi + tid)
                                : 0.0f;
            const int chunks = (n + SPEC_CHUNK - 1) / SPEC_CHUNK;
            const bool loader = tid >= 32;
            if (loader)
                for (int c = 0; c < SPEC_STAGES - 1; ++c)
                    stage_rows(r0, Q.row, Q.terms, M, c, n, chunks,
                               (float4*)work, tid - 32, THREADS - 32);
#pragma unroll 1
            for (int c = 0; c < chunks; ++c) {
                if (loader) cp_async_wait_stages();
                __syncthreads();
                if (tid < M) {
                    const double* b = (const double*)work +
                                      (c % SPEC_STAGES) * SPEC_CHUNK * 2 * M;
                    float* dst = r0 + (long long)c * SPEC_CHUNK * Q.row + tid;
                    bool ok = n - c * SPEC_CHUNK >= SPEC_CHUNK;
                    const float phi0 = phi;
                    if (ok) {
                        // a whole chunk: straight-line, four frames' terms
                        // loaded at once, mod_two_pi's short path
#pragma unroll
                        for (int u0 = 0; u0 < SPEC_CHUNK; u0 += 4) {
                            double p1[4], p2[4];
#pragma unroll
                            for (int v = 0; v < 4; ++v) {
                                p1[v] = b[2 * M * (u0 + v) + tid];
                                p2[v] = b[2 * M * (u0 + v) + M + tid];
                            }
#pragma unroll
                            for (int v = 0; v < 4; ++v) {
                                float th, phin;
                                tone_chain_short(g, p1[v], p2[v], phi, th,
                                                 phin, ok);
                                float* r = dst + (long long)(u0 + v) * Q.row;
                                r[Q.th] = th;
                                r[Q.phin] = phin;
                                phi = phin;
                            }
                        }
                    }
                    if (!ok) {
                        // the last chunk, or a phase out of the short
                        // path's range: frame by frame with mod_two_pi
                        phi = phi0;
#pragma unroll 1
                        for (int u = 0; u < SPEC_CHUNK; ++u) {
                            if (c * SPEC_CHUNK + u >= n) break;
                            float th, phin;
                            tone_chain(g, b[2 * M * u + tid],
                                       b[2 * M * u + M + tid], phi, th, phin);
                            float* r = dst + (long long)u * Q.row;
                            r[Q.th] = th;
                            r[Q.phin] = phin;
                            phi = phin;
                        }
                    }
                } else if (loader) {
                    stage_rows(r0, Q.row, Q.terms, M, c + SPEC_STAGES - 1, n,
                               chunks, (float4*)work, tid - 32, THREADS - 32);
                }
            }
            if (loader) cp_async_wait_all();
            __syncthreads();
        }
        grid.sync();

        // ---- (e) each frame's demod: a block a frame, the lane path's
        // downconvert, sums and decisions; the first frame whose timing
        // misses the next frame's guess
        {
            double* red = (double*)(work + S.red);
            float2* d = (float2*)(work + S.d);
            float2* fi = (float2*)(work + S.fi);
#pragma unroll 1
            for (int it = blockIdx.x; it < total; it += gridDim.x) {
                const int l = lane_of(off, L, it), j = it - off[l];
                const int nin = j > 0 ? g.N : w_nin[l];
                const long long pos =
                    j > 0 ? (long long)w_pos[l] + w_nin[l] +
                                (long long)(j - 1) * g.N
                          : w_pos[l];
                const long long frame =
                    (long long)l * g.num_frames + w_f0[l] + j;
                const float* row = rows + ((long long)l * cap + j) * Q.row;
                float fn[M], la[M], th[M];
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    fn[m] = __ldcg(row + Q.fnew + m);
                    la[m] = __ldcg(row + Q.la + m);
                    th[m] = __ldcg(row + Q.th + m);
                }
                const long long start = p.starts[l], nvalid = p.n_valid[l];
                const long long base = pos + nin - Nmem;
                const float noldf = (float)(Nmem - nin);
#pragma unroll 2
                for (int t = tid; t < Nmem; t += THREADS)
                    downconvert<M>(
                        g, global_sample(g, p.data, start, nvalid, base + t),
                        t, noldf, fn, la, th, d);
                __syncthreads();
                slot_sums<M, 1, false>(g, d, fi, spin_re, spin_im, warp, 0,
                                       red, nullptr, 0);
                __syncthreads();
                if (warp == 0) {
                    const float norm = timing_norm(g, red);
                    float low = 0.0f, fract = 0.0f, high = 0.0f;
                    if (wl == 0) timing_phases(norm * (float)g.P, low, fract,
                                               high);
                    low = __shfl_sync(0xffffffffu, low, 0);
                    fract = __shfl_sync(0xffffffffu, fract, 0);
                    high = __shfl_sync(0xffffffffu, high, 0);
                    const float ebno = decide<M>(g, fi, low, fract, high,
                                                 p.soft + frame * g.Nbits,
                                                 p.bits + frame * g.Nbits);
                    if (wl == 0) {
                        const int nn = next_nin(g, norm);
                        float* r = (float*)row;
                        p.valid[frame] = 1;
                        p.o_ebno[frame] = ebno;
                        p.o_norm[frame] = norm;
                        p.o_nin[frame] = nin;
                        r[Q.norm] = norm;
                        r[Q.ebno] = ebno;
                        r[Q.high] = high;
                        nxt[(long long)l * cap + j] = nn;
                        if (j + 1 < w_len[l] && nn != g.N)
                            atomicMin(li + l * LI_N + LI_BAD, j);
                    }
                    if (wl < M) {
                        float f = fn[0];
#pragma unroll
                        for (int m = 1; m < M; ++m) f = m == wl ? fn[m] : f;
                        p.o_fest[frame * M + wl] = f;
                    }
                }
                __syncthreads();           // d, fi and red, for the next
            }
        }
        grid.sync();

        // ---- (f) keep the frames up to the first miss: the ppm and SNR
        // chains over them (thread 0 over their terms, formed first by the
        // whole block and streamed as in (b)), their last state carried,
        // the next window
#pragma unroll 1
        for (int l = blockIdx.x; l < L; l += gridDim.x) {
            const int wlen = w_len[l];
            if (wlen == 0) continue;
            float* r0 = rows + (long long)l * cap * Q.row;
            float* s = lf + l * Q.lane;
            int* q = li + l * LI_N;
            const int bad = __ldcg(q + LI_BAD);
            const bool miss = bad != 0x7fffffff;
            const int n = miss ? bad + 1 : wlen;
            const long long frame0 = (long long)l * g.num_frames + w_f0[l];
            float ppm = __ldcg(s + Q.l_ppm), snr = __ldcg(s + Q.l_snr);
            const float norm_in = __ldcg(s + Q.l_norm);
            // the chains' terms, every frame at once: ppm_step's gate and
            // 0.1 appm, and half the Eb/N0
#pragma unroll 1
            for (int j = tid; j < n; j += THREADS) {
                float* r = r0 + (long long)j * Q.row;
                const float norm = __ldcg(r + Q.norm);
                const float d_norm =
                    norm - (j > 0 ? __ldcg(r - Q.row + Q.norm) : norm_in);
                const float appm = 1e6f * d_norm / (float)g.Nsym;
                *(float4*)(r + Q.pterms) =
                    make_float4(fabsf(d_norm) < 0.2f ? 1.0f : 0.0f,
                                0.1f * appm, 0.5f * __ldcg(r + Q.ebno), 0.0f);
            }
            __threadfence();         // for the stream's cp.async reads
            __syncthreads();
            const int chunks = (n + SPEC_CHUNK - 1) / SPEC_CHUNK;
            const bool loader = tid >= 32;
            if (loader)
                for (int c = 0; c < SPEC_STAGES - 1; ++c)
                    stage_rows(r0, Q.row, Q.pterms, 1, c, n, chunks,
                               (float4*)work, tid - 32, THREADS - 32);
#pragma unroll 1
            for (int c = 0; c < chunks; ++c) {
                if (loader) cp_async_wait_stages();
                __syncthreads();
                if (tid == 0) {
                    const float4* b =
                        (const float4*)work + (c % SPEC_STAGES) * SPEC_CHUNK;
                    float* dst = p.o_ppm + frame0 + c * SPEC_CHUNK;
                    // ppm_step and the SNR average from their terms (gate,
                    // 0.1 appm, Eb/N0 / 2): a whole chunk straight-line,
                    // eight frames' terms loaded at once
                    if (n - c * SPEC_CHUNK >= SPEC_CHUNK) {
#pragma unroll
                        for (int u0 = 0; u0 < SPEC_CHUNK; u0 += 8) {
                            float4 x[8];
#pragma unroll
                            for (int v = 0; v < 8; ++v) x[v] = b[u0 + v];
#pragma unroll
                            for (int v = 0; v < 8; ++v) {
                                ppm = x[v].x != 0.0f ? 0.9f * ppm + x[v].y
                                                     : ppm;
                                snr = 0.5f * snr + x[v].z;
                                dst[u0 + v] = ppm;
                            }
                        }
                    } else {
#pragma unroll 1
                        for (int u = 0; u < n - c * SPEC_CHUNK; ++u) {
                            const float4 x = b[u];
                            ppm = x.x != 0.0f ? 0.9f * ppm + x.y : ppm;
                            snr = 0.5f * snr + x.z;
                            dst[u] = ppm;
                        }
                    }
                } else if (loader) {
                    stage_rows(r0, Q.row, Q.pterms, 1, c + SPEC_STAGES - 1, n,
                               chunks, (float4*)work, tid - 32, THREADS - 32);
                }
            }
            if (loader) cp_async_wait_all();
            __syncthreads();
            if (tid == 0) {
                const float* last = r0 + (long long)(n - 1) * Q.row;
                s[Q.l_norm] = __ldcg(last + Q.norm);
                s[Q.l_ppm] = ppm;
                s[Q.l_ebno] = __ldcg(last + Q.ebno);
                s[Q.l_snr] = snr;
                s[Q.l_high] = __ldcg(last + Q.high);
                const int lnin = n > 1 ? g.N : w_nin[l];
                const long long lpos =
                    n > 1 ? (long long)w_pos[l] + w_nin[l] +
                                (long long)(n - 2) * g.N
                          : w_pos[l];
                const int f0 = w_f0[l] + n;
                const long long pos = lpos + lnin;
                const int nin = __ldcg(nxt + (long long)l * cap + n - 1);
                const int W = __ldcg(q + LI_W);
                const int poor_run = miss && n < SPEC_MIN_WINDOW
                                         ? __ldcg(q + LI_POOR) + 1 : 0;
                const bool poor = poor_run >= SPEC_MAX_POOR;
                const int Wn = miss ? min(max(2 * n, SPEC_MIN_WINDOW), cap)
                                    : min(2 * W, cap);
                q[LI_LPOS] = (int)lpos;
                q[LI_LNIN] = lnin;
                q[LI_F0] = f0;
                q[LI_POS] = (int)pos;
                q[LI_NIN] = nin;
                q[LI_W] = Wn;
                q[LI_POOR] = poor_run;
                q[LI_BAD] = 0x7fffffff;
                q[LI_WLEN] = poor
                                 ? 0
                                 : spec_window(g, f0, pos, nin, p.n_valid[l],
                                               Wn);
                if (p.counters != nullptr) {
                    atomicAdd(p.counters + CNT_SPEC_FRAMES,
                              (unsigned long long)n);
                    atomicAdd(p.counters + CNT_ROUNDS, 1ull);
                    if (poor)
                        atomicAdd(p.counters + CNT_FALLBACKS, 1ull);
                }
            }
            const float* last = r0 + (long long)(n - 1) * Q.row;
#pragma unroll 1
            for (int k = tid; k < half; k += THREADS)
                s[Q.l_ema + k] = __ldcg(last + Q.ema + k);
            if (tid < M) {
                const float fn = __ldcg(last + Q.fnew + tid);
                s[Q.l_fest + tid] = fn;
                s[Q.l_phi + tid] = __ldcg(last + Q.phin + tid);
                s[Q.l_fn + tid] = fn;
                s[Q.l_la + tid] = __ldcg(last + Q.la + tid);
                s[Q.l_th + tid] = __ldcg(last + Q.th + tid);
            }
        }
    }

    // ---- the state for the lane path, and the eye probe of the last kept
    // frame: its integrators formed again
#pragma unroll 1
    for (int l = blockIdx.x; l < L; l += gridDim.x) {
        const float* s = lf + l * Q.lane;
        const int* q = li + l * LI_N;
        const int f0 = __ldcg(q + LI_F0);
#pragma unroll 1
        for (int k = tid; k < half; k += THREADS)
            p.fft_out[l * half + k] = __ldcg(s + Q.l_ema + k);
        if (tid < M) {
            p.fest_out[l * M + tid] = __ldcg(s + Q.l_fest + tid);
            p.phi_out[l * M + tid] = __ldcg(s + Q.l_phi + tid);
        }
        if (tid == 0) {
            first[l] = f0;
            p.pos_out[l] = __ldcg(q + LI_POS);
            p.nin_out[l] = __ldcg(q + LI_NIN);
            p.norm_out[l] = __ldcg(s + Q.l_norm);
            p.ppm_out[l] = __ldcg(s + Q.l_ppm);
            p.ebno_out[l] = __ldcg(s + Q.l_ebno);
            p.snr_out[l] = __ldcg(s + Q.l_snr);
        }
        if (p.eye_re == nullptr || f0 == 0) continue;
        float2* d = (float2*)(work + S.d);
        float2* fi = (float2*)(work + S.fi);
        double* red = (double*)(work + S.red);
        float fn[M], la[M], th[M];
#pragma unroll
        for (int m = 0; m < M; ++m) {
            fn[m] = __ldcg(s + Q.l_fn + m);
            la[m] = __ldcg(s + Q.l_la + m);
            th[m] = __ldcg(s + Q.l_th + m);
        }
        const int nin = __ldcg(q + LI_LNIN);
        const long long base = (long long)__ldcg(q + LI_LPOS) + nin - Nmem;
        const float noldf = (float)(Nmem - nin);
#pragma unroll 1
        for (int t = tid; t < Nmem; t += THREADS)
            downconvert<M>(g, global_sample(g, p.data, p.starts[l],
                                            p.n_valid[l], base + t),
                           t, noldf, fn, la, th, d);
        __syncthreads();
        slot_sums<M, 1, false>(g, d, fi, spin_re, spin_im, warp, 0, red,
                               nullptr, 0);
        __syncthreads();
#pragma unroll 1
        for (int e = tid; e < M * g.NP; e += THREADS) {
            p.eye_re[(size_t)l * M * g.NP + e] = fi[e].x;
            p.eye_im[(size_t)l * M * g.NP + e] = fi[e].y;
        }
        if (tid == 0) {
            p.eye_high[l] = (int)__ldcg(s + Q.l_high);
            p.eye_ok[l] = 1;
        }
        __syncthreads();
    }
}

// ----------------------------------------------------------------- kernel

// one name for both paths: SPEC, the frame-parallel path (cooperative);
// otherwise the lane path, PROBE its variant that writes the traces
template <int M, bool PROBE, bool SPEC>
__global__ void __launch_bounds__(THREADS, 1)
fsk_demod_kernel(const DemodGeom g, const DemodPtrs p) {
    if constexpr (SPEC)
        spec_body<M>(g, p);
    else
        lane_body<M, PROBE>(g, p);
}

extern "C" int fsk_demod_smem_bytes(const DemodGeom* g) {
    return (int)layout(*g).total;
}

// the frame-parallel path's scratch: floats, ints
extern "C" void fsk_demod_spec_scratch(const DemodGeom* g, long long* floats,
                                       long long* ints) {
    const SpecScratch s = spec_scratch(*g);
    *floats = s.lanes;
    *ints = s.n_int;
}

template <int M>
static int spec_resident(const DemodGeom* g, int* blocks) {
    const size_t smem = spec_smem(*g).total;
    *blocks = 0;
    if (smem > 232448) return 0;
    cudaError_t err = cudaFuncSetAttribute(
        fsk_demod_kernel<M, false, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fsk_demod_kernel<M, false, true>, THREADS, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    *blocks = per_sm * sms;
    return (int)err;
}

// blocks of the frame-parallel path that fit on the card at once (0: its
// shared memory does not fit a block)
extern "C" int fsk_demod_spec_blocks(const DemodGeom* g, int* blocks) {
    if (g->M == 2) return spec_resident<2>(g, blocks);
    if (g->M == 4) return spec_resident<4>(g, blocks);
    return (int)cudaErrorInvalidValue;
}

template <int M>
static int launch_spec(const DemodGeom* g, const DemodPtrs* p, void* stream) {
    int fit = 0;
    int err = spec_resident<M>(g, &fit);
    if (err != 0) return err;
    // a block for every SPEC_FRAMES_PER_BLOCK frames of the first windows,
    // as many as fit, and one a lane at least
    const long long frames =
        (long long)g->lanes *
        (g->spec_cap < g->num_frames ? g->spec_cap : g->num_frames);
    const long long want =
        (frames + SPEC_FRAMES_PER_BLOCK - 1) / SPEC_FRAMES_PER_BLOCK;
    const int blocks = (int)(want < fit ? (want > g->lanes ? want : g->lanes)
                                        : fit);
    if (blocks > fit) return (int)cudaErrorInvalidValue;
    void* args[] = {(void*)g, (void*)p};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)fsk_demod_kernel<M, false, true>, blocks, THREADS, args,
        spec_smem(*g).total, (cudaStream_t)stream);
}

template <int M, bool PROBE>
static int launch(const DemodGeom* g, const DemodPtrs* p, void* stream) {
    const size_t smem = layout(*g).total;
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fsk_demod_kernel<M, PROBE, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (g->lanes == 0) return 0;
    if (!PROBE && g->spec_cap > 0) {
        // the frame-parallel path first; the lane path then goes on from
        // the frame and the state it leaves in place of the outputs'
        const int rc = launch_spec<M>(g, p, stream);
        if (rc != 0) return rc;
        DemodPtrs q = *p;
        q.first = p->spec_i + spec_scratch(*g).first;
        q.pos_in = p->pos_out;
        q.nin_in = p->nin_out;
        q.fft_in = p->fft_out;
        q.fest_in = p->fest_out;
        q.phi_in = p->phi_out;
        q.norm_in = p->norm_out;
        q.ppm_in = p->ppm_out;
        q.ebno_in = p->ebno_out;
        q.snr_in = p->snr_out;
        fsk_demod_kernel<M, PROBE, false>
            <<<g->lanes, THREADS, smem, (cudaStream_t)stream>>>(*g, q);
        return (int)cudaGetLastError();
    }
    fsk_demod_kernel<M, PROBE, false>
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
    // the frame-parallel path: its scratch given, and no traces
    if (g->spec_cap > 0 &&
        (probe || p->spec_f == nullptr || p->spec_i == nullptr))
        return (int)cudaErrorInvalidValue;
    if (g->M == 2)
        return probe ? launch<2, true>(g, p, stream)
                     : launch<2, false>(g, p, stream);
    if (g->M == 4)
        return probe ? launch<4, true>(g, p, stream)
                     : launch<4, false>(g, p, stream);
    return (int)cudaErrorInvalidValue;
}
