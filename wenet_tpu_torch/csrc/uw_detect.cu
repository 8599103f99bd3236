// UW acquisition of the streaming receivers on the card, hand-written for
// Hopper (sm_90a): bit for bit the C FSM of csrc/deframe_fsm.c
// (`uw_detect`), run over L lanes' soft-bit buffers where they lie on the
// card, with the carried bit register in front of each buffer and the
// buffer's tail rule (ops/deframe.py: StreamDeframer.consume) after it.
//
// It replaces no TPU kernel: the JAX package runs this FSM on the host
// (wenet_tpu/native/deframe_fsm.c), as the port's host path still does.
// It was added so that the streaming receivers' deframe reads the demod's
// soft bits in place: the positions it writes feed the window gather
// (csrc/deframe_topk.cu, fsm_windows), the BP kernel and the CRC kernel
// with no host step between them.  Its plain PyTorch version is
// wenet_tpu_torch/ops/deframe.py::uw_detect_lanes_reference.
//
// What bounds it on this card: bytes (each lane's soft buffer read once,
// 4 bytes a symbol).  What stands in the way is the FSM's chain: after a
// detection the register stays frozen through the packet, so each
// detection decides where the next search starts.  The design keeps that
// chain on one warp working from shared memory and spreads everything
// else over the card (times beside the bound: PERF.md, chip_smoke.py's
// uw_detect_vs_plain).
//
// Conventions.  Hard bit j of word w is symbol 32 w + j (soft < 0).  The
// register of the window ending at symbol t holds symbol t - k at bit k
// (newest lowest, as the C FSM shifts), nuw bits of it; `uw` holds UW bit
// 0 at bit nuw - 1, so a window matches where popcount(reg ^ uw) <=
// allowed.  Each lane's meta row is (count, cut, register low, register
// high); the next push reads its register as the register in front of
// its buffer.
//
// Design.  Two kernels on the stream from one C call; the second is
// launched early (programmatic dependent launch) and waits at its start.
//   1. Scores (grid: 1024-symbol blocks x L lanes).  A block packs the
//      signs of its symbols and of the 64 before them, 32 to a word by one
//      ballot a word, and for each symbol t < n tests the window ending at
//      t (symbols before the buffer read as 0: the windows that reach
//      them are the pick kernel's).  It stores its hard-bit words and its
//      hit words (bit j: the window ending at symbol 32 w + j matches) in
//      a global scratch.
//   2. Picks (one block a lane).  The block copies the lane's hard-bit
//      and hit words into shared memory where they fit (lanes up to about
//      900,000 symbols; past that the warp works on the global scratch),
//      then one warp runs the FSM.  The windows that mix the frozen
//      register with the buffer's bits (the first nuw - 1 of the buffer,
//      and of the symbols after each packet) are recomputed from the
//      register, a window a lane, and the first match taken by a ballot;
//      past them the next match is the first set bit of the hit words, 32
//      words a step.  A match whose packet would pass the buffer's end
//      stops the search.  Then the cut and the register: after the last
//      packet and its frozen register; with no detection, the last syms +
//      nuw symbols kept and the register of the window before them; a
//      buffer of at most syms + nuw symbols is kept whole.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCORE_THREADS 256
#define SCORE_WARPS (SCORE_THREADS / 32)
#define BLOCK_WORDS 32                    // words a score block owns
#define HALO_WORDS 2                      // words before them it reads
#define LOAD_ROUNDS ((BLOCK_WORDS + HALO_WORDS + SCORE_WARPS - 1) / SCORE_WARPS)
#define PICK_THREADS 1024
#define PICK_SMEM_LIMIT (232448 - 2048)
#define FULL 0xFFFFFFFFu

struct UwArgs {
    const float* soft;            // the lanes' buffers, one after another
    const long long* lanes;       // (L, 4): offset, symbols n, first
                                  // position slot, capacity
    const int32_t* init;          // (L, 4): the last push's meta rows
    int32_t* meta;                // (L, 4): count, cut, register lo, hi
    int32_t* pos;                 // UW-end positions, lane l's from slot
                                  // lanes[l][2], at most lanes[l][3]
    uint32_t* scratch;            // (2, L, W): hard-bit words, hit words
    long long W;                  // words a lane in the scratch
    unsigned long long uw;        // UW bit 0 at bit nuw - 1
    int L, nuw, allowed, syms;
};

__device__ __forceinline__ void pdl_wait() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void pdl_launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ unsigned long long low_bits(int k) {
    return k >= 64 ? ~0ULL : ((1ULL << k) - 1ULL);
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* w,
                                            long long i) {
    return i >= 0 ? w[i] : 0u;
}

// the register of the window ending at symbol u (bit k: symbol u - k),
// all 64 bits, symbols before the buffer 0
__device__ __forceinline__ unsigned long long reg_end(const uint32_t* w,
                                                      long long u) {
    const long long s = u - 63;               // the window's first symbol
    const long long ws = s >> 5;              // floor division
    const int sh = (int)(s & 31);
    const unsigned long long a =
        (unsigned long long)word_at(w, ws) |
        ((unsigned long long)word_at(w, ws + 1) << 32);
    const unsigned long long x =
        sh ? (a >> sh) |
                 ((unsigned long long)word_at(w, ws + 2) << (64 - sh))
           : a;
    return __brevll(x);
}

// the FSM's register at symbol u when it froze as `frozen` before symbol
// t0 (u >= t0 - 1)
__device__ __forceinline__ unsigned long long reg_at(
    const uint32_t* w, long long u, long long t0, unsigned long long frozen,
    int nuw) {
    const long long d = u - t0 + 1;           // buffer bits in the window
    const unsigned long long mask = low_bits(nuw);
    if (d >= nuw) return reg_end(w, u) & mask;
    if (d <= 0) return frozen & mask;
    return ((frozen << d) | (reg_end(w, u) & low_bits((int)d))) & mask;
}

// 1. hard-bit words and hit words of 1024 symbols of a lane
__global__ void __launch_bounds__(SCORE_THREADS)
uw_scores_kernel(const UwArgs g) {
    __shared__ uint32_t words[BLOCK_WORDS + HALO_WORDS];
    pdl_launch_dependents();
    const int l = blockIdx.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long off = g.lanes[4 * l], n = g.lanes[4 * l + 1];
    const long long w0 = (long long)blockIdx.x * BLOCK_WORDS;
    if (32 * w0 >= n) return;                 // past this lane's symbols
    const float* soft = g.soft + off;
    float f[LOAD_ROUNDS];
    #pragma unroll
    for (int q = 0; q < LOAD_ROUNDS; ++q) {   // every load in flight first
        const int j = warp + q * SCORE_WARPS;
        const long long i = 32 * (w0 - HALO_WORDS + j) + lane;
        f[q] = (j < BLOCK_WORDS + HALO_WORDS && i >= 0 && i < n)
                   ? __ldg(soft + i) : 1.f;
    }
    #pragma unroll
    for (int q = 0; q < LOAD_ROUNDS; ++q) {
        const int j = warp + q * SCORE_WARPS;
        const unsigned m = __ballot_sync(FULL, f[q] < 0.f);
        if (lane == 0 && j < BLOCK_WORDS + HALO_WORDS) words[j] = m;
    }
    __syncthreads();

    const unsigned long long mask = low_bits(g.nuw);
    uint32_t* hard_out = g.scratch + (long long)l * g.W;
    uint32_t* hit_out = g.scratch + ((long long)g.L + l) * g.W;
    #pragma unroll
    for (int q = 0; q < BLOCK_WORDS / SCORE_WARPS; ++q) {
        const int wl = warp * (BLOCK_WORDS / SCORE_WARPS) + q;
        const long long t = 32 * (w0 + wl) + lane;
        // symbol t is bit 32 (wl + HALO_WORDS) + lane of `words`
        const unsigned long long reg =
            reg_end(words, 32LL * (wl + HALO_WORDS) + lane) & mask;
        const bool hit = t < n && __popcll(reg ^ g.uw) <= g.allowed;
        const unsigned h = __ballot_sync(FULL, hit);
        if (lane == 0) {
            hard_out[w0 + wl] = words[wl + HALO_WORDS];
            hit_out[w0 + wl] = h;
        }
    }
}

// 2. the FSM of each lane on its hit words; the cut and the register
__global__ void __launch_bounds__(PICK_THREADS)
uw_picks_kernel(const UwArgs g, int on_chip) {
    extern __shared__ __align__(16) uint32_t smem[];
    pdl_wait();
    const int l = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
    const long long n = g.lanes[4 * l + 1];
    const long long first = g.lanes[4 * l + 2], cap = g.lanes[4 * l + 3];
    const long long nw = (n + 31) / 32;
    const uint32_t* hard = g.scratch + (long long)l * g.W;
    const uint32_t* hits = g.scratch + ((long long)g.L + l) * g.W;
    if (on_chip) {
        for (long long i = tid; i < nw; i += PICK_THREADS) {
            smem[i] = hard[i];
            smem[g.W + i] = hits[i];
        }
        __syncthreads();
        hard = smem;
        hits = smem + g.W;
    }
    if (tid >= 32) return;                    // one warp runs the FSM
    const int nuw = g.nuw;
    const unsigned long long mask = low_bits(nuw);
    const unsigned long long init =
        (((unsigned long long)(uint32_t)g.init[4 * l + 3] << 32) |
         (uint32_t)g.init[4 * l + 2]) & mask;
    unsigned long long frozen = init;         // the register before t0
    long long t0 = 0, t = 0, last = -1;
    long long count = 0;
    #pragma unroll 1
    while (t < n) {
        const long long fresh = t0 + nuw - 1;  // windows from here are
        long long hit_t = -1;                  // the buffer's alone
        unsigned long long hit_reg = 0;
        if (t < fresh) {
            #pragma unroll 1
            for (long long base = t; base < fresh && base < n; base += 32) {
                const long long u = base + lane;
                unsigned long long r = 0;
                bool h = false;
                if (u < fresh && u < n) {
                    r = reg_at(hard, u, t0, frozen, nuw);
                    h = __popcll(r ^ g.uw) <= g.allowed;
                }
                const unsigned b = __ballot_sync(FULL, h);
                if (b) {
                    const int src = __ffs(b) - 1;
                    hit_t = base + src;
                    hit_reg = __shfl_sync(FULL, r, src);
                    break;
                }
            }
            if (hit_t < 0) {
                t = fresh;
                continue;
            }
        } else {
            const long long wt = t >> 5;
            #pragma unroll 1
            for (long long w = wt; w < nw; w += 32) {
                const long long wi = w + lane;
                uint32_t hw = wi < nw ? hits[wi] : 0u;
                if (wi == wt) hw &= FULL << (t & 31);
                const unsigned b = __ballot_sync(FULL, hw != 0u);
                if (b) {
                    const int src = __ffs(b) - 1;
                    const uint32_t hs = __shfl_sync(FULL, hw, src);
                    hit_t = 32 * (w + src) + __ffs(hs) - 1;
                    break;
                }
            }
            if (hit_t < 0) break;
            hit_reg = reg_at(hard, hit_t, t0, frozen, nuw);
        }
        t = hit_t;
        if (t + g.syms >= n) break;           // the packet cannot complete
        if (lane == 0 && count < cap) g.pos[first + count] = (int32_t)t;
        ++count;
        last = t;
        frozen = hit_reg;
        t0 = t + g.syms + 1;                  // the packet's symbols skipped
        t = t0;
    }
    long long cut = 0;
    unsigned long long reg = init;
    if (count) {
        cut = last + g.syms + 1;
        reg = frozen;
    } else if (n > (long long)g.syms + nuw) {
        cut = n - g.syms - nuw;
        reg = reg_at(hard, cut - 1, 0, init, nuw);
    }
    if (lane == 0) {
        int32_t* m = g.meta + 4 * l;
        m[0] = (int32_t)count;
        m[1] = (int32_t)cut;
        m[2] = (int32_t)(uint32_t)(reg & 0xFFFFFFFFULL);
        m[3] = (int32_t)(uint32_t)(reg >> 32);
    }
}

// words a lane takes in the scratch for lanes of at most n symbols: whole
// score blocks
extern "C" long long uw_detect_words(long long n) {
    const long long blocks = (n + 32LL * BLOCK_WORDS - 1) / (32 * BLOCK_WORDS);
    return (blocks > 0 ? blocks : 1) * BLOCK_WORDS;
}

// once a device, before the first launch
extern "C" int uw_detect_init() {
    return (int)cudaFuncSetAttribute(
        uw_picks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PICK_SMEM_LIMIT);
}

// Launch on `stream`: n_max the longest lane's symbols (the score grid).
extern "C" int uw_detect_launch(const UwArgs* a, long long n_max,
                                void* stream_ptr) {
    if (a->nuw < 1 || a->nuw > 64 || a->allowed < 0 || a->syms < 1 ||
        a->L < 1 || a->L > 65535 || n_max < 0 || n_max >= (1LL << 31) ||
        a->W < uw_detect_words(n_max) || a->soft == nullptr ||
        a->lanes == nullptr || a->init == nullptr || a->meta == nullptr ||
        a->pos == nullptr || a->scratch == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    const dim3 grid((unsigned)(a->W / BLOCK_WORDS), (unsigned)a->L);
    uw_scores_kernel<<<grid, SCORE_THREADS, 0, stream>>>(*a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long smem = 8LL * a->W;
    const int on_chip = smem <= PICK_SMEM_LIMIT;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)a->L);
    cfg.blockDim = dim3(PICK_THREADS);
    cfg.dynamicSmemBytes = on_chip ? (size_t)smem : 0;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, uw_picks_kernel, *a, on_chip);
    return (int)err;
}
