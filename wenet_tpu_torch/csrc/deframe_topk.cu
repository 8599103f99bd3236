// Top-k UW acquisition of the fused receive paths, hand-written for Hopper
// (sm_90a): from C soft streams to the LLRs of k packet windows each.
//
// Replaces the XLA code of wenet_tpu/ops/deframe.py::deframe_topk up to
// its BP call: the +/-1 UW correlation of the hard bits, the k rounds of
// first-maximum pick (a lax.scan) with every start whose window would
// overlap the pick blanked to -inf, the exhausted-pick sentinel, the
// window gather, the v2 descramble or the v1 RS232 strip, and sd_to_llr.
// Its plain PyTorch version is
// wenet_tpu_torch/ops/deframe.py::topk_windows_reference (then
// ops/ldpc.sd_to_llr).  The LLRs go on to the BP kernel (bp_decode.cu) and
// the CRC kernel (crc_pack.cu).
//
// What bounds it on this card: bytes (a stream's soft bits read once, k
// windows of 2580 float32 LLRs written once).  What stands in the way is
// the chain of k picks within a stream, each depending on the last; the
// design keeps that chain short and spreads the rest over the card
// (times beside the bound: PERF.md, chip_smoke.py's deframe_topk_vs_plain;
// phase clocks: chip_profile.py --kernel deframe_topk).
//
// Design.  Three kernels on the stream, issued by one C call; the second
// and third are launched early (programmatic dependent launch) and wait
// for their predecessor at their start.
//   1. Scores (grid: 1024-start blocks x C streams).  A block packs the
//      signs (soft < 0) of the bits its starts reach, 32 to a word by one
//      ballot a word with every warp's loads in flight, then computes the
//      exact correlation of each placeable start t (t <= n - syms - nuw):
//      64 bits from t funnel-shifted out of three words, nuw - 2
//      popcount((bits ^ UW) & mask), stored as int16 in a global scratch.
//      Each tile of 64 starts keeps its first maximum as one key,
//      (score + 64) << 24 | (0xFFFFFF - tile), and its offset in the tile.
//   2. Picks (one block a stream).  The block copies the stream's scores,
//      tile keys and offsets into shared memory where they fit (streams up
//      to about 110,000 symbols; past that the picks work on them in the
//      global scratch), then one warp runs the k rounds.  A round is one
//      max over the keys (__reduce_max_sync): the largest score, and among
//      equal scores the smallest tile, whose offset gives the first
//      maximum, as torch.argmax and JAX's argmax_first.  A key of 0 means
//      every placeable start is blanked: this and the later picks are
//      exhausted (position -1, a zero window).  The blank
//      (s - (nuw + syms), s + nuw + syms) sets the keys of the tiles
//      wholly inside it to 0 and rescans its two boundary tiles, writing
//      the blanked scores back as -32768 so later rescans see them (a
//      boundary tile whose key is already 0 is wholly blanked: it keeps 0,
//      since its scores were never written back).
//   3. Windows (one block of 256 threads a pick).  soft[min(s + nuw + j,
//      n - 1)] for the 2580 symbols kept (v2: j = i, times the descramble
//      code; v1: symbol 8 - i % 8 of 10-bit word i / 8), then sd_to_llr
//      with block reductions of |sd|, x and x^2 (x = sd / mean - sign(sd))
//      in float32.  An exhausted window is zero, so its LLRs are NaN (0/0),
//      as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 64                       // starts a tile
#define BLOCK_TILES 16                // tiles a score block
#define BLOCK_STARTS (BLOCK_TILES * TILE)
#define BLOCK_WORDS (BLOCK_STARTS / 32 + 2)
#define SCORE_THREADS 256
#define SCORE_WARPS (SCORE_THREADS / 32)
#define WORDS_PER_WARP ((BLOCK_WORDS + SCORE_WARPS - 1) / SCORE_WARPS)
#define WIN_THREADS 256
#define WIN_WARPS (WIN_THREADS / 32)
#define CODE_LEN 2580
#define VPT ((CODE_LEN + WIN_THREADS - 1) / WIN_THREADS)
#define SENT (-32768)
#define FULL 0xFFFFFFFFu
#define TILE_MASK 0xFFFFFFu
#define PICK_THREADS 512
#define COPY_BATCH 8               // 16-byte loads in flight a thread
#define PICK_SMEM_LIMIT (232448 - 2048)

#ifdef DEFRAME_TOPK_PHASES
// clock64 at phase ends, thread 0 of the first 1024 blocks of each kernel:
// [kernel: 0 scores, 1 picks, 2 windows][block][slot]
__device__ long long deframe_topk_phases[3 * 1024 * 64];
extern "C" int deframe_topk_read_phases(long long* host) {
    return (int)cudaMemcpyFromSymbol(host, deframe_topk_phases,
                                     sizeof(deframe_topk_phases));
}
#define PHASE(kind, blk, slot)                                         \
    if (threadIdx.x == 0 && (blk) < 1024 && (slot) < 64)               \
    deframe_topk_phases[((kind) * 1024 + (blk)) * 64 + (slot)] = clock64()
#else
#define PHASE(kind, blk, slot)
#endif

struct TopkArgs {
    const float* soft;        // (C, n)
    const float* code;        // (CODE_LEN,) v2 descramble +/-1
    float* llr;               // (C * k, CODE_LEN)
    float* sd_out;            // (C * k, CODE_LEN) or null
    int32_t* pos;             // (C, k)
    uint8_t* exhausted;       // (C, k)
    unsigned char* scratch;   // scores, tile keys, tile offsets
    long long scratch_bytes;
    long long n;              // symbols a stream
    unsigned long long uw;    // bit j = UW bit j
    int C, k, nuw, syms, v2;
    int nlive;                // placeable starts, n - syms - nuw + 1 (>= 0)
    int ntiles;               // ceil(nlive / TILE)
};

__host__ __device__ static inline long long align16(long long x) {
    return (x + 15) / 16 * 16;
}

// int16 scores a stream keeps: nlive rounded up to 16 bytes
__host__ __device__ static inline long long score_stride(int nlive) {
    return (nlive + 7LL) / 8 * 8;
}

// global scratch a call needs: int16 scores (C, score_stride), uint32 tile
// keys and uint8 tile offsets (C, ntiles)
extern "C" long long deframe_topk_scratch_bytes(int C, int nlive,
                                                int ntiles) {
    return 2LL * C * score_stride(nlive) + align16(4LL * C * ntiles) +
           (long long)C * ntiles;
}

// shared memory the pick kernel takes for a stream's scores, tile keys and
// tile offsets on chip
extern "C" long long deframe_topk_pick_smem_bytes(int nlive, int ntiles) {
    return 2LL * score_stride(nlive) + align16(4LL * ntiles) + ntiles;
}

__device__ __forceinline__ void pdl_wait() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void pdl_launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// a start's key within its tile: larger score first, then smaller offset;
// 0 for a blanked start
__device__ __forceinline__ uint32_t start_key(int v, int off) {
    return v == SENT ? 0u : ((uint32_t)(v + 64) << 8) | (uint32_t)(255 - off);
}

__device__ __forceinline__ uint32_t tile_key(uint32_t best, long long tile) {
    return best == 0u ? 0u
                      : ((best >> 8) << 24) | (TILE_MASK - (uint32_t)tile);
}

__device__ __forceinline__ float sign_of(float x) {
    return (float)((x > 0.f) - (x < 0.f));
}

// sums of a and b over the block (every thread gets both)
__device__ void block_sum2(float& a, float& b, float (*red)[WIN_WARPS]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    #pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(FULL, a, off);
        b += __shfl_xor_sync(FULL, b, off);
    }
    __syncthreads();                 // red is free again
    if (lane == 0) {
        red[0][warp] = a;
        red[1][warp] = b;
    }
    __syncthreads();
    a = red[0][0];
    b = red[1][0];
    #pragma unroll
    for (int w = 1; w < WIN_WARPS; ++w) {
        a += red[0][w];
        b += red[1][w];
    }
}

struct Scratch {
    int16_t* scores;
    uint32_t* keys;
    uint8_t* offs;
};

__device__ __forceinline__ Scratch scratch_of(const TopkArgs& g, int c) {
    const long long ss = score_stride(g.nlive);
    const long long ks = 2LL * g.C * ss;
    const long long os = ks + align16(4LL * g.C * g.ntiles);
    Scratch s;
    s.scores = reinterpret_cast<int16_t*>(g.scratch) + (long long)c * ss;
    s.keys = reinterpret_cast<uint32_t*>(g.scratch + ks) +
             (long long)c * g.ntiles;
    s.offs = g.scratch + os + (long long)c * g.ntiles;
    return s;
}

// 1. hard bits, exact scores, tile maxima
__global__ void __launch_bounds__(SCORE_THREADS)
topk_scores_kernel(const TopkArgs g) {
    __shared__ uint32_t words[BLOCK_WORDS];
    pdl_launch_dependents();
    const int c = blockIdx.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    PHASE(0, blk, 0);
    const long long t0 = (long long)blockIdx.x * BLOCK_STARTS;
    const float* soft = g.soft + (long long)c * g.n;
    float f[WORDS_PER_WARP];
    #pragma unroll
    for (int q = 0; q < WORDS_PER_WARP; ++q) {
        const int j = warp + q * SCORE_WARPS;
        const long long i = t0 + 32LL * j + lane;
        f[q] = (j < BLOCK_WORDS && i < g.n) ? __ldg(soft + i) : 1.f;
    }
    #pragma unroll
    for (int q = 0; q < WORDS_PER_WARP; ++q) {
        const int j = warp + q * SCORE_WARPS;
        const unsigned m = __ballot_sync(FULL, f[q] < 0.f);
        if (lane == 0 && j < BLOCK_WORDS) words[j] = m;
    }
    __syncthreads();
    PHASE(0, blk, 1);

    const Scratch sc = scratch_of(g, c);
    const unsigned long long mask = (1ULL << g.nuw) - 1ULL;
    #pragma unroll
    for (int q = 0; q < BLOCK_TILES / SCORE_WARPS; ++q) {
        const int lt = warp * (BLOCK_TILES / SCORE_WARPS) + q;
        uint32_t best = 0u;
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int off = h * 32 + lane;
            const int local = lt * TILE + off;
            const long long t = t0 + local;
            const int w0 = local >> 5, sh = local & 31;
            const unsigned long long a =
                (unsigned long long)words[w0] |
                ((unsigned long long)words[w0 + 1] << 32);
            const unsigned long long win =
                sh ? (a >> sh) |
                         ((unsigned long long)words[w0 + 2] << (64 - sh))
                   : a;
            const int v = g.nuw - 2 * __popcll((win ^ g.uw) & mask);
            if (t < g.nlive) {
                sc.scores[t] = (int16_t)v;
                best = max(best, start_key(v, off));
            }
        }
        best = __reduce_max_sync(FULL, best);
        const long long tile = t0 / TILE + lt;
        if (lane == 0 && tile < g.ntiles) {
            sc.keys[tile] = tile_key(best, tile);
            sc.offs[tile] = (uint8_t)(255 - (best & 255u));
        }
    }
    PHASE(0, blk, 2);
}

// the keys of tiles ta and tb after blanking starts [a, b] (both tiles
// meet the blank): the blanked scores are written back as SENT.  A tile
// whose key is already 0 is wholly blanked (an earlier blank may have
// zeroed it without writing its scores) and keeps its key.
__device__ __forceinline__ void rescan(int16_t* scores, uint32_t* keys,
                                       uint8_t* offs, int ta, int tb, int a,
                                       int b, int nlive) {
    const int lane = threadIdx.x & 31;
    const bool live[2] = {keys[ta] != 0u, keys[tb] != 0u};
    int v[4];
    #pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int p = (u < 2 ? ta : tb) * TILE + (u & 1) * 32 + lane;
        v[u] = live[u >> 1] && p < nlive ? scores[p] : SENT;
    }
    #pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int p = (u < 2 ? ta : tb) * TILE + (u & 1) * 32 + lane;
        if (p >= a && p <= b && v[u] != SENT) {
            scores[p] = (int16_t)SENT;
            v[u] = SENT;
        }
    }
    const uint32_t ka = __reduce_max_sync(
        FULL, max(start_key(v[0], lane), start_key(v[1], lane + 32)));
    const uint32_t kb = __reduce_max_sync(
        FULL, max(start_key(v[2], lane), start_key(v[3], lane + 32)));
    __syncwarp();                       // every lane has read the keys
    if (lane == 0) {
        keys[ta] = tile_key(ka, ta);
        offs[ta] = (uint8_t)(255 - (ka & 255u));
        keys[tb] = tile_key(kb, tb);
        offs[tb] = (uint8_t)(255 - (kb & 255u));
    }
}

// 2. k first-maximum picks a stream, on the tile maxima
__global__ void __launch_bounds__(PICK_THREADS)
topk_picks_kernel(const TopkArgs g, int on_chip) {
    extern __shared__ __align__(16) unsigned char smem[];
    pdl_launch_dependents();
    pdl_wait();
    const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
    PHASE(1, c, 0);
    const Scratch sc = scratch_of(g, c);
    int16_t* scores = sc.scores;
    uint32_t* keys = sc.keys;
    uint8_t* offs = sc.offs;
    if (on_chip) {
        const long long ss = score_stride(g.nlive);
        scores = reinterpret_cast<int16_t*>(smem);
        keys = reinterpret_cast<uint32_t*>(smem + 2 * ss);
        offs = smem + 2 * ss + align16(4LL * g.ntiles);
        const uint4* src = reinterpret_cast<const uint4*>(sc.scores);
        uint4* dst = reinterpret_cast<uint4*>(scores);
        const int nvec = (int)(ss / 8);
        #pragma unroll 1
        for (int base = 0; base < nvec; base += COPY_BATCH * PICK_THREADS) {
            uint4 r[COPY_BATCH];
            #pragma unroll
            for (int q = 0; q < COPY_BATCH; ++q) {
                const int i = base + q * PICK_THREADS + tid;
                if (i < nvec) r[q] = src[i];
            }
            #pragma unroll
            for (int q = 0; q < COPY_BATCH; ++q) {
                const int i = base + q * PICK_THREADS + tid;
                if (i < nvec) dst[i] = r[q];
            }
        }
        for (int j = tid; j < g.ntiles; j += PICK_THREADS) {
            keys[j] = sc.keys[j];
            offs[j] = sc.offs[j];
        }
        __syncthreads();
    }
    if (tid >= 32) return;              // one warp runs the rounds
    PHASE(1, c, 1);
    const int reach = g.nuw + g.syms;
    int32_t* pos = g.pos + (long long)c * g.k;
    uint8_t* exh = g.exhausted + (long long)c * g.k;
    int r = 0;
    #pragma unroll 1
    for (; r < g.k; ++r) {
        uint32_t m = 0u;
        #pragma unroll 4
        for (int j = lane; j < g.ntiles; j += 32) m = max(m, keys[j]);
        m = __reduce_max_sync(FULL, m);
        PHASE(1, c, 2 + 2 * r);
        if (m == 0u) break;             // every placeable start blanked
        const int tile = (int)(TILE_MASK - (m & TILE_MASK));
        const int s = tile * TILE + offs[tile];
        if (lane == 0) {
            pos[r] = s;
            exh[r] = 0;
        }
        const int a = max(s - reach + 1, 0), b = min(s + reach - 1,
                                                     g.nlive - 1);
        const int ta = a / TILE, tb = b / TILE;
        for (int j = ta + 1 + lane; j < tb; j += 32) keys[j] = 0u;
        rescan(scores, keys, offs, ta, tb, a, b, g.nlive);
        __syncwarp();
        PHASE(1, c, 3 + 2 * r);
    }
    for (int q = r + lane; q < g.k; q += 32) {       // exhausted picks
        pos[q] = -1;
        exh[q] = 1;
    }
}

// 3. each pick's window, descrambled or stripped, and its LLRs
__global__ void __launch_bounds__(WIN_THREADS)
topk_windows_kernel(const TopkArgs g) {
    __shared__ float red[2][WIN_WARPS];
    const int tid = threadIdx.x;
    float vals[VPT], code[VPT];
    #pragma unroll
    for (int j = 0; j < VPT; ++j)          // the code does not wait for picks
        code[j] = g.v2 && tid + j * WIN_THREADS < CODE_LEN
                      ? __ldg(g.code + tid + j * WIN_THREADS) : 1.f;
    pdl_wait();
    const long long row = blockIdx.x;
    PHASE(2, row, 0);
    const int p = g.pos[row];
    const bool dead = p < 0;
    const long long s = dead ? 0 : p;
    const float* soft = g.soft + (row / g.k) * g.n;
    #pragma unroll
    for (int j = 0; j < VPT; ++j) {         // every load in flight first
        const int i = tid + j * WIN_THREADS;
        vals[j] = 0.f;
        if (i < CODE_LEN && !dead) {
            const int src = g.v2 ? i : (i >> 3) * 10 + 8 - (i & 7);
            long long col = s + g.nuw + src;
            if (col > g.n - 1) col = g.n - 1;
            vals[j] = __ldg(soft + col);
        }
    }
    float sabs = 0.f, unused = 0.f;
    #pragma unroll
    for (int j = 0; j < VPT; ++j) {
        const int i = tid + j * WIN_THREADS;
        if (i < CODE_LEN) {
            if (g.v2) vals[j] = vals[j] * code[j];
            if (g.sd_out != nullptr) g.sd_out[row * CODE_LEN + i] = vals[j];
            sabs += fabsf(vals[j]);
        }
    }
    PHASE(2, row, 1);
    block_sum2(sabs, unused, red);
    const float mean = sabs / (float)CODE_LEN;
    float xs = 0.f, xq = 0.f;
    #pragma unroll
    for (int j = 0; j < VPT; ++j) {
        if (tid + j * WIN_THREADS < CODE_LEN) {
            const float x = vals[j] / mean - sign_of(vals[j]);
            xs += x;
            xq += x * x;
        }
    }
    block_sum2(xs, xq, red);
    const float n_f = (float)CODE_LEN;
    const float estvar = (n_f * xq - xs * xs) /
                         (float)(CODE_LEN * (CODE_LEN - 1));
    const float scale = 4.f * (1.f / (2.f * estvar + 1e-3f));
    #pragma unroll
    for (int j = 0; j < VPT; ++j) {
        const int i = tid + j * WIN_THREADS;
        if (i < CODE_LEN) g.llr[row * CODE_LEN + i] = scale * vals[j];
    }
    PHASE(2, row, 2);
}

// once a device, before the first launch
extern "C" int deframe_topk_init() {
    return (int)cudaFuncSetAttribute(
        topk_picks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PICK_SMEM_LIMIT);
}

template <typename... KArgs, typename... Args>
static cudaError_t launch_dependent(void (*kernel)(KArgs...), dim3 grid,
                                    int threads, size_t smem,
                                    cudaStream_t stream, Args... args) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

extern "C" int deframe_topk_launch(const TopkArgs* a, void* stream_ptr) {
    if (a->nuw < 1 || a->nuw > 63 || a->k < 0 || a->C < 0 || a->n < 1 ||
        a->n >= (1LL << 30) || a->nlive < 0 ||
        a->nlive != (a->n - a->syms - a->nuw + 1 > 0
                         ? (int)(a->n - a->syms - a->nuw + 1) : 0) ||
        a->ntiles != (a->nlive + TILE - 1) / TILE || a->C > 65535 ||
        a->scratch_bytes <
            deframe_topk_scratch_bytes(a->C, a->nlive, a->ntiles) ||
        (a->scratch == nullptr && a->scratch_bytes > 0))
        return (int)cudaErrorInvalidValue;
    if (a->C == 0 || a->k == 0) return 0;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (a->nlive > 0) {
        const dim3 grid((a->nlive + BLOCK_STARTS - 1) / BLOCK_STARTS, a->C);
        topk_scores_kernel<<<grid, SCORE_THREADS, 0, stream>>>(*a);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const long long smem = deframe_topk_pick_smem_bytes(a->nlive, a->ntiles);
    const int on_chip = smem <= PICK_SMEM_LIMIT;
    cudaError_t err = launch_dependent(topk_picks_kernel, dim3(a->C),
                                       PICK_THREADS,
                                       on_chip ? (size_t)smem : 0, stream,
                                       *a, on_chip);
    if (err != cudaSuccess) return (int)err;
    err = launch_dependent(topk_windows_kernel,
                           dim3((unsigned)((long long)a->C * a->k)),
                           WIN_THREADS, 0, stream, *a);
    return (int)err;
}
