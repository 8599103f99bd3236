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
// What bounds it on this card: bytes, in principle (a stream's soft bits
// read once, k windows of 2580 float32 LLRs written once).  In practice
// the k picks are serial within a stream, each a block-wide argmax over
// every placeable start, so a stream is a chain of k reductions on one SM
// (times beside the bound: PERF.md, chip_smoke.py's deframe_topk_vs_plain).
//
// Design.  One block of 512 threads per stream.
//   1. Hard bits: each warp reads 32 soft values at a time and packs their
//      signs (soft < 0) with one ballot into a 32-bit word.
//   2. Scores: for every placeable start t (t <= n - syms - nuw), 64 bits
//      of the packed stream from t are funnel-shifted out of three words,
//      and the correlation is nuw - 2 popcount((bits ^ UW) & mask): an
//      exact integer, stored as int16.  Starts past the last placeable
//      window are never stored (the plain version's -inf).
//   3. Picks: k rounds of a block-wide argmax with first-maximum ties (the
//      smaller index wins, as torch.argmax and JAX's argmax_first); a round
//      whose maximum is the blank sentinel is exhausted (start 0, position
//      -1, a zero window).  Each round blanks the starts in
//      (s - (nuw + syms), s + nuw + syms).
//   4. Each pick's window: soft[min(s + nuw + j, n - 1)] for the 2580
//      symbols kept (v2: j = i, times the descramble code; v1: symbol
//      8 - i % 8 of 10-bit word i / 8), then sd_to_llr with block
//      reductions of |sd|, x and x^2 (x = sd / mean - sign(sd)) in float32.
//      An exhausted window is zero, so its LLRs are NaN (0/0), as in the
//      plain version.
// The words and scores live in shared memory (int16 scores: streams up to
// about 110k bits); for longer streams the wrapper hands the kernel a
// global scratch buffer for both, and the kernel runs the same code on it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define THREADS 512
#define WARPS (THREADS / 32)
#define CODE_LEN 2580
#define VPT ((CODE_LEN + THREADS - 1) / THREADS)
#define SENT (-32768)
#define FULL 0xFFFFFFFFu

struct TopkArgs {
    const float* soft;        // (C, n)
    const float* code;        // (CODE_LEN,) v2 descramble +/-1
    float* llr;               // (C * k, CODE_LEN)
    float* sd_out;            // (C * k, CODE_LEN) or null
    int32_t* pos;             // (C, k)
    uint8_t* exhausted;       // (C, k)
    uint32_t* g_words;        // (C, nwords) global scratch, or null
    int16_t* g_scores;        // (C, nlive) global scratch, or null
    long long n;              // symbols a stream
    unsigned long long uw;    // bit j = UW bit j
    int C, k, nuw, syms, v2;
    int nlive;                // placeable starts, n - syms - nuw + 1 (>= 0)
    int nwords;               // ceil(n / 32) + 2
};

__host__ __device__ static inline size_t words_bytes(int nwords) {
    return ((size_t)nwords * 4 + 15) / 16 * 16;
}

// shared memory a block needs with words and scores on chip
extern "C" long long deframe_topk_smem_bytes(int nwords, int nlive) {
    return (long long)(words_bytes(nwords) + (size_t)nlive * 2);
}

__device__ __forceinline__ void better(int& v, int& i, int ov, int oi) {
    if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
    }
}

__device__ __forceinline__ float sign_of(float x) {
    return (float)((x > 0.f) - (x < 0.f));
}

// sums of a and b over the block (every thread gets both)
__device__ void block_sum2(float& a, float& b, float (*red)[WARPS]) {
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
    for (int w = 1; w < WARPS; ++w) {
        a += red[0][w];
        b += red[1][w];
    }
}

__global__ void __launch_bounds__(THREADS)
deframe_topk_kernel(const TopkArgs g) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int red_v[WARPS], red_i[WARPS];
    __shared__ float red_f[2][WARPS];
    __shared__ int pick_s, pick_dead;

    const int c = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* soft = g.soft + (long long)c * g.n;
    uint32_t* words;
    int16_t* sc;
    if (g.g_words != nullptr) {
        words = g.g_words + (long long)c * g.nwords;
        sc = g.g_scores + (long long)c * g.nlive;
    } else {
        words = reinterpret_cast<uint32_t*>(smem);
        sc = reinterpret_cast<int16_t*>(smem + words_bytes(g.nwords));
    }

    // 1. hard bits, 32 to a word
    #pragma unroll 1
    for (int w = warp; w < g.nwords; w += WARPS) {
        const long long i = 32LL * w + lane;
        const unsigned m = __ballot_sync(FULL, i < g.n && soft[i] < 0.f);
        if (lane == 0) words[w] = m;
    }
    __syncthreads();

    // 2. exact correlation scores of the placeable starts
    const unsigned long long mask = (1ULL << g.nuw) - 1ULL;
    #pragma unroll 1
    for (int t = tid; t < g.nlive; t += THREADS) {
        const int w0 = t >> 5, sh = t & 31;
        const unsigned long long a =
            (unsigned long long)words[w0] |
            ((unsigned long long)words[w0 + 1] << 32);
        const unsigned long long win =
            sh ? (a >> sh) | ((unsigned long long)words[w0 + 2] << (64 - sh))
               : a;
        sc[t] = (int16_t)(g.nuw - 2 * __popcll((win ^ g.uw) & mask));
    }
    __syncthreads();

    const int reach = g.nuw + g.syms;
    #pragma unroll 1
    for (int r = 0; r < g.k; ++r) {
        // 3. first-maximum pick
        int bv = SENT, bi = INT_MAX;
        #pragma unroll 1
        for (int t = tid; t < g.nlive; t += THREADS) {
            const int v = sc[t];
            if (v > bv) {
                bv = v;
                bi = t;
            }
        }
        #pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            better(bv, bi, __shfl_xor_sync(FULL, bv, off),
                   __shfl_xor_sync(FULL, bi, off));
        if (lane == 0) {
            red_v[warp] = bv;
            red_i[warp] = bi;
        }
        __syncthreads();
        if (warp == 0) {
            bv = lane < WARPS ? red_v[lane] : SENT;
            bi = lane < WARPS ? red_i[lane] : INT_MAX;
            #pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                better(bv, bi, __shfl_xor_sync(FULL, bv, off),
                       __shfl_xor_sync(FULL, bi, off));
            if (lane == 0) {
                pick_dead = bv == SENT;
                pick_s = bv == SENT ? 0 : bi;
            }
        }
        __syncthreads();
        const int s = pick_s, dead = pick_dead;
        const int lo = max(s - reach + 1, 0), hi = min(s + reach, g.nlive);
        #pragma unroll 1
        for (int t = lo + tid; t < hi; t += THREADS) sc[t] = (int16_t)SENT;

        // 4. the window, descrambled or stripped, and its LLRs
        const long long row = (long long)c * g.k + r;
        float vals[VPT];
        float sabs = 0.f, unused = 0.f;
        #pragma unroll
        for (int j = 0; j < VPT; ++j) {
            const int i = tid + j * THREADS;
            float sd = 0.f;
            if (i < CODE_LEN) {
                const int src = g.v2 ? i : (i >> 3) * 10 + 8 - (i & 7);
                long long col = (long long)s + g.nuw + src;
                if (col > g.n - 1) col = g.n - 1;
                const float w = dead ? 0.f : soft[col];
                sd = g.v2 ? w * g.code[i] : w;
                if (g.sd_out != nullptr) g.sd_out[row * CODE_LEN + i] = sd;
                sabs += fabsf(sd);
            }
            vals[j] = sd;
        }
        block_sum2(sabs, unused, red_f);
        const float mean = sabs / (float)CODE_LEN;
        float xs = 0.f, xq = 0.f;
        #pragma unroll
        for (int j = 0; j < VPT; ++j) {
            if (tid + j * THREADS < CODE_LEN) {
                const float x = vals[j] / mean - sign_of(vals[j]);
                xs += x;
                xq += x * x;
            }
        }
        block_sum2(xs, xq, red_f);
        const float n_f = (float)CODE_LEN;
        const float estvar = (n_f * xq - xs * xs) /
                             (float)(CODE_LEN * (CODE_LEN - 1));
        const float scale = 4.f * (1.f / (2.f * estvar + 1e-3f));
        #pragma unroll
        for (int j = 0; j < VPT; ++j) {
            const int i = tid + j * THREADS;
            if (i < CODE_LEN) g.llr[row * CODE_LEN + i] = scale * vals[j];
        }
        if (tid == 0) {
            g.pos[row] = dead ? -1 : s;
            g.exhausted[row] = (uint8_t)dead;
        }
        __syncthreads();            // blanking done before the next scan
    }
}

extern "C" int deframe_topk_launch(const TopkArgs* a, void* stream) {
    if (a->nuw < 1 || a->nuw > 63 || a->k < 0 || a->nlive < 0 ||
        a->nwords < 3 || (long long)a->nwords * 32 < a->n + 64 ||
        a->n >= (1LL << 30))
        return (int)cudaErrorInvalidValue;
    const bool global = a->g_words != nullptr;
    if (global && a->g_scores == nullptr) return (int)cudaErrorInvalidValue;
    const long long smem =
        global ? 0 : deframe_topk_smem_bytes(a->nwords, a->nlive);
    if (smem > 232448 - 2048) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        deframe_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (a->C == 0 || a->k == 0) return 0;
    deframe_topk_kernel<<<a->C, THREADS, (size_t)smem,
                          (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}
