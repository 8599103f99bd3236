// Sum-product belief-propagation decoder for the Wenet H2064_516 LDPC code
// with the var<->edge maps as one-hot matrix products on the tensor cores,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel wenet_tpu/ops/ldpc_pallas.py::_bp_kernel (wrapper
// decode_pallas), and computes what wenet_tpu/ops/ldpc.py::decode computes:
// phi-domain sum-product with the reference clamps of phi0, per-codeword
// early exit (all data bits zero, or all 516 checks satisfied) and the same
// iteration count.  Its plain version is
// wenet_tpu_torch/ops/ldpc_onehot.py::decode_onehot_reference.
//
// Layout (the Pallas kernel's): edges slot-major, e = s * 640 + c (516
// checks padded to 640, 14 slots padded to 16: 10240 edges); vars padded to
// 2688.
//
// What bounded the TPU design: it streamed the dense one-hot matrices
// (10240 x 2688 bf16 and its transpose, 2 x 55 MB) from HBM in every
// iteration, whatever the batch.  Here the matrices are cut into the B
// tiles of mma.sync.m16n8k16 (16 x 8 bf16) and only the nonzero tiles are
// kept, as lists per output tile: 5,867 tiles for the var->edge broadcast
// and 2,028 + 2,107 + 1,963 for the three per-slot edge->var matrices,
// about 3 MB in all, which stays in the 50 MB L2.  Skipping the all-zero
// tiles is exact: their terms are zero.
//
// Exactness.  Every output column of each one-hot matrix has at most one 1
// (the edge->var map is split by var slot k = 0..2, the k-th edge of each
// var in check order), so a product only moves a value.  Tensor cores take
// bf16, so the float32 A operand is cut into three bf16 pieces
// (hi, mid, lo: each the top 8 significant bits of what is left, by bit
// mask; the subtractions are exact), each piece goes through its own
// product with float32 accumulation (one nonzero term per column: exact),
// and (hi + mid) + lo restores the float32 value exactly (for |x| >= 2^-110;
// see split3 in ops/ldpc_onehot.py).  The var-side sum is then
// qi = llr + ((g0 + g1) + g2) in CUDA cores, in the reference's order.
//
// Design.  One block of 512 threads per batch tile of 16 codewords (the M
// of the mma).  The block walks up to max_iter iterations itself, with
// converged codewords frozen, and stops when all 16 have converged.  Each
// iteration: the check side in CUDA cores (phi sum in slot order 0..13,
// logf/tanhf without fast-math, built with -fmad=false); the edge->var
// products (one warp per tile of 8 vars, three slot products); the
// var->edge broadcast (one warp per tile of 8 edges) and the extrinsic
// messages.  The state of 16 codewords (messages, signs, posteriors, about
// 1.6 MB) is far above the 227 KB of shared memory, so it lives in scratch
// that the wrapper allocates; the A operands are read from it through L1/L2.
//
// What bounds it now: each nonzero tile visit loads a 16 x 16 float32 A
// tile (1 KB) and issues three mma, about 12,000 visits per iteration for
// 16 codewords, all through L2, plus the latency of four barrier-separated
// phases per iteration.  Keeping the state on chip across a cluster, and
// wgmma/TMA, are for later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define N_DATA 2064
#define N_CHECKS 516
#define SLOTS 14
#define CHECKS_P 640
#define SLOTS_P 16
#define EDGES_P (CHECKS_P * SLOTS_P)
#define VARS_P 2688
#define BT 16
#define THREADS 512
#define WARPS (THREADS / 32)
#define NT_E (EDGES_P / 8)
#define NT_V (VARS_P / 8)
#define COL_W 3

__device__ __forceinline__ float phi0(float x) {
    // phi(x) = -ln(tanh(x/2)); x > 10 -> 0, x < 9.08e-5 -> 10
    if (x > 10.0f) return 0.0f;
    if (x < (float)9.08e-5) return 10.0f;
    return -logf(tanhf(x * 0.5f));
}

// x -> bf16 bit patterns (hi, mid, lo) with (hi + mid) + lo == x
__device__ __forceinline__ void split3(float x, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
    const uint32_t hb = __float_as_uint(x) & 0xFFFF0000u;
    const float r1 = x - __uint_as_float(hb);
    const uint32_t mb = __float_as_uint(r1) & 0xFFFF0000u;
    const float r2 = r1 - __uint_as_float(mb);
    h = hb >> 16;
    m = mb >> 16;
    l = __float_as_uint(r2) >> 16;
}

__device__ __forceinline__ uint32_t pack2(uint32_t first, uint32_t second) {
    return first | (second << 16);
}

// d += A (16x16 bf16, row) * B (16x8 bf16, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One output tile of x (16 rows, row stride K floats) times a one-hot
// matrix given by its nonzero tiles ktile[p], frag[p] for p in [p0, p1).
// Lane l = 4 g + q gets rows g, g+8 and columns 2q, 2q+1 of the tile:
// out = {(g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1)}.  x is written by this
// kernel, so it is read through the coherent path (no __ldg).
__device__ __forceinline__ void tile_product(const float* x, int K,
                                             const int32_t* __restrict__ ktile,
                                             const uint2* __restrict__ frag,
                                             int p0, int p1, int lane,
                                             float (&out)[4]) {
    float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int g = lane >> 2, q = lane & 3;
    const float* r0 = x + g * K + 2 * q;
    const float* r1 = x + (g + 8) * K + 2 * q;
    for (int p = p0; p < p1; ++p) {
        const int k0 = ktile[p] * 16;
        const float2 a00 = *reinterpret_cast<const float2*>(r0 + k0);
        const float2 a10 = *reinterpret_cast<const float2*>(r1 + k0);
        const float2 a01 = *reinterpret_cast<const float2*>(r0 + k0 + 8);
        const float2 a11 = *reinterpret_cast<const float2*>(r1 + k0 + 8);
        const uint2 b = frag[p * 32 + lane];
        uint32_t h[8], m[8], l[8];
        split3(a00.x, h[0], m[0], l[0]);
        split3(a00.y, h[1], m[1], l[1]);
        split3(a10.x, h[2], m[2], l[2]);
        split3(a10.y, h[3], m[3], l[3]);
        split3(a01.x, h[4], m[4], l[4]);
        split3(a01.y, h[5], m[5], l[5]);
        split3(a11.x, h[6], m[6], l[6]);
        split3(a11.y, h[7], m[7], l[7]);
        mma_bf16(dh, pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[4], h[5]),
                 pack2(h[6], h[7]), b.x, b.y);
        mma_bf16(dm, pack2(m[0], m[1]), pack2(m[2], m[3]), pack2(m[4], m[5]),
                 pack2(m[6], m[7]), b.x, b.y);
        mma_bf16(dl, pack2(l[0], l[1]), pack2(l[2], l[3]), pack2(l[4], l[5]),
                 pack2(l[6], l[7]), b.x, b.y);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (dh[j] + dm[j]) + dl[j];
}

__global__ void __launch_bounds__(THREADS)
bp_onehot_kernel(const float* __restrict__ llr_p,   // [Bp][VARS_P]
                 float* qi_s,                       // [Bp][VARS_P] scratch
                 float* vmsg_s,                     // [Bp][EDGES_P] scratch
                 float* rmsg_s,                     // [Bp][EDGES_P] scratch
                 uint8_t* vsgn_s,                   // [Bp][EDGES_P] scratch
                 uint8_t* bits_p,                   // [Bp][VARS_P] out
                 int32_t* __restrict__ iters_out,   // [Bp]
                 uint8_t* __restrict__ parity_out,  // [Bp]
                 const int32_t* __restrict__ bc_ptr,   // [NT_E + 1]
                 const int32_t* __restrict__ bc_k,
                 const uint2* __restrict__ bc_frag,
                 const int32_t* __restrict__ sl_ptr,   // [COL_W * NT_V + 1]
                 const int32_t* __restrict__ sl_k,
                 const uint2* __restrict__ sl_frag,
                 const int32_t* __restrict__ edge_var,  // [EDGES_P]
                 const uint8_t* __restrict__ emask,     // [EDGES_P]
                 int n_valid, int max_iter) {
    __shared__ int conv[BT], bad[BT], data_one[BT], iters[BT];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const size_t b0 = (size_t)blockIdx.x * BT;
    const float* llr = llr_p + b0 * VARS_P;
    float* qi = qi_s + b0 * VARS_P;
    float* vmsg = vmsg_s + b0 * EDGES_P;
    float* rmsg = rmsg_s + b0 * EDGES_P;
    uint8_t* vsgn = vsgn_s + b0 * EDGES_P;
    uint8_t* bits = bits_p + b0 * VARS_P;

    // rows past the batch (the ragged last tile) start converged
    if (tid < BT) {
        conv[tid] = (b0 + tid) >= (size_t)n_valid;
        bad[tid] = 0;
        data_one[tid] = 0;
        iters[tid] = max_iter;
    }
    for (int i = tid; i < BT * VARS_P; i += THREADS) bits[i] = 0;

    // var-side init: broadcast the LLRs to the edges; phi0(|llr|), llr < 0
    for (int nt = warp; nt < NT_E; nt += WARPS) {
        float bv[4];
        tile_product(llr, VARS_P, bc_k, bc_frag, bc_ptr[nt], bc_ptr[nt + 1],
                     lane, bv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int r = g + (j >> 1) * 8;
            const int e = nt * 8 + 2 * q + (j & 1);
            const bool ok = emask[e];
            vmsg[r * EDGES_P + e] = ok ? phi0(fabsf(bv[j])) : 0.0f;
            vsgn[r * EDGES_P + e] = ok && bv[j] < 0.0f;
        }
    }
    __syncthreads();

    for (int it = 0; it < max_iter; ++it) {
        // check side: phi sum in slot order, sign parity, check -> var
        for (int i = tid; i < BT * CHECKS_P; i += THREADS) {
            const int r = i / CHECKS_P, c = i - r * CHECKS_P;
            if (conv[r]) continue;
            const float* m = vmsg + r * EDGES_P + c;
            const uint8_t* sg = vsgn + r * EDGES_P + c;
            float acc = m[0];
            int par = sg[0];
            for (int s = 1; s < SLOTS; ++s) {
                acc = acc + m[s * CHECKS_P];
                par ^= sg[s * CHECKS_P];
            }
            if (par) atomicOr(&bad[r], 1);
            float* rr = rmsg + r * EDGES_P + c;
            for (int s = 0; s < SLOTS_P; ++s) {
                float out = 0.0f;
                if (emask[s * CHECKS_P + c]) {
                    const float mag = phi0(acc - m[s * CHECKS_P]);
                    out = (par ^ sg[s * CHECKS_P]) ? -mag : mag;
                }
                rr[s * CHECKS_P] = out;
            }
        }
        __syncthreads();

        // edge -> var on the tensor cores: posterior per var, hard bits
        for (int nt = warp; nt < NT_V; nt += WARPS) {
            float gk[COL_W][4];
#pragma unroll
            for (int k = 0; k < COL_W; ++k)
                tile_product(rmsg, EDGES_P, sl_k, sl_frag,
                             sl_ptr[k * NT_V + nt], sl_ptr[k * NT_V + nt + 1],
                             lane, gk[k]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = g + (j >> 1) * 8;
                const int v = nt * 8 + 2 * q + (j & 1);
                const float x = llr[r * VARS_P + v] +
                                ((gk[0][j] + gk[1][j]) + gk[2][j]);
                qi[r * VARS_P + v] = x;
                if (!conv[r]) {
                    bits[r * VARS_P + v] = x < 0.0f;
                    if (v < N_DATA && x < 0.0f) atomicOr(&data_one[r], 1);
                }
            }
        }
        __syncthreads();

        // var -> edge on the tensor cores: extrinsic messages and signs
        for (int nt = warp; nt < NT_E; nt += WARPS) {
            float bv[4];
            tile_product(qi, VARS_P, bc_k, bc_frag, bc_ptr[nt], bc_ptr[nt + 1],
                         lane, bv);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = g + (j >> 1) * 8;
                const int e = nt * 8 + 2 * q + (j & 1);
                if (!conv[r] && emask[e]) {
                    const float x = bv[j] - rmsg[r * EDGES_P + e];
                    vmsg[r * EDGES_P + e] = phi0(fabsf(x));
                    vsgn[r * EDGES_P + e] = x <= 0.0f;
                }
            }
        }
        __syncthreads();

        if (tid < BT) {
            if (!conv[tid]) {
                iters[tid] = it + 1;
                if (!data_one[tid] || !bad[tid]) conv[tid] = 1;
            }
            bad[tid] = 0;
            data_one[tid] = 0;
        }
        __syncthreads();
        int done = 1;
#pragma unroll
        for (int r = 0; r < BT; ++r) done &= conv[r];
        if (done) break;                  // uniform across the block
    }

    // epilogue: parity of the output bits per codeword
    for (int i = tid; i < BT * N_CHECKS; i += THREADS) {
        const int r = i / N_CHECKS, c = i - r * N_CHECKS;
        int par = 0;
        for (int s = 0; s < SLOTS; ++s) {
            const int e = s * CHECKS_P + c;
            if (emask[e]) par ^= bits[r * VARS_P + edge_var[e]];
        }
        if (par) atomicOr(&bad[r], 1);
    }
    __syncthreads();
    if (tid < BT) {
        iters_out[b0 + tid] = iters[tid];
        parity_out[b0 + tid] = !bad[tid];
    }
}

// Launch on `stream` (batch_p a multiple of 16, n_valid <= batch_p);
// return cudaGetLastError() (0 on success).
extern "C" int bp_onehot_launch(const float* llr_p, float* qi, float* vmsg,
                                float* rmsg, uint8_t* vsgn, uint8_t* bits_p,
                                int32_t* iters, uint8_t* parity_ok,
                                const int32_t* bc_ptr, const int32_t* bc_k,
                                const void* bc_frag, const int32_t* sl_ptr,
                                const int32_t* sl_k, const void* sl_frag,
                                const int32_t* edge_var, const uint8_t* emask,
                                int batch_p, int n_valid, int max_iter,
                                void* stream) {
    if (batch_p <= 0) return 0;
    if (batch_p % BT) return (int)cudaErrorInvalidValue;
    bp_onehot_kernel<<<batch_p / BT, THREADS, 0, (cudaStream_t)stream>>>(
        llr_p, qi, vmsg, rmsg, vsgn, bits_p, iters, parity_ok, bc_ptr, bc_k,
        reinterpret_cast<const uint2*>(bc_frag), sl_ptr, sl_k,
        reinterpret_cast<const uint2*>(sl_frag), edge_var, emask, n_valid,
        max_iter);
    return (int)cudaGetLastError();
}
