// Belief-propagation decoder for the Wenet H2064_516 LDPC code, hand-written
// for Hopper (sm_90a), with two check-node updates as template variants:
//
//   * MINSUM = false: phi-domain sum-product.  Replaces the TPU kernel
//     wenet_tpu/ops/ldpc_pallas2.py::_bp_kernel (wrapper decode_pallas2) and
//     computes what wenet_tpu/ops/ldpc.py::decode computes, with the
//     reference clamps of phi0.
//   * MINSUM = true: normalized min-sum (r = scale * sign product * smallest
//     |q| of the other edges), what wenet_tpu/ops/ldpc.py::decode_minsum
//     computes (XLA on the TPU; no Pallas kernel of its own).
//
// Both keep the per-codeword early exit (all data bits zero, or all 516
// checks satisfied) and the same iteration count.  The var side, the
// freeze/early exit and the build flags are shared.
//
// Design.  One thread block per codeword; the block walks the iterations
// itself and stops when its codeword converges, which is exact because the
// JAX decoder freezes a converged codeword's state.  All BP state of the
// codeword (edge messages, signs, per-check sums or minima, posteriors)
// lives in dynamic shared memory for the whole decode, as the Pallas kernel
// kept it resident in VMEM: device memory is touched only to read the 2580
// LLRs and the index tables and to write the result.
//
// What bounds it on this card: not HBM bytes (about 10 KB in and out per
// codeword) but the latency of up to 10 serial iterations of four
// barrier-separated phases with divergent shared-memory gathers (and
// log/tanh per edge for sum-product), and shared-memory occupancy (about
// 89 KB per block, so two blocks per SM).  Batches of ~128 codewords fill
// about one wave of the 132 SMs.
//
// Numerics: logf/tanhf without fast-math, no FMA contraction (built with
// -fmad=false), the check-side sum in slot order 0..13 and the var-side sum
// in slot order 0..2, as the plain PyTorch references do.  Min-sum: invalid
// slots hold MINSUM_BIG, the first-min slot is the lowest slot holding the
// minimum, `r_mag * scale` is one float32 multiply, and the var-side sign is
// q < 0 (sum-product: q <= 0).
//
// Tables (global memory, read-only gathers; not __constant__, since the
// accesses diverge across a warp):
//   var_idx [516*14] int32  variable of edge e = c*14 + s (0 where invalid)
//   emask   [516*14] uint8  edge validity
//   vslots  [2580*3] int32  flat edge slots of each variable (dump 7224)
//   vmask   [2580*3] uint8  validity of those slots

#include <cuda_runtime.h>
#include <stdint.h>

#define N_VARS 2580
#define N_DATA 2064
#define N_CHECKS 516
#define SLOTS 14
#define N_EDGES (N_CHECKS * SLOTS)
#define COL_W 3
#define THREADS 256

#define MINSUM_BIG 1e30f

#define SMEM_BYTES \
    (4 * (2 * N_VARS + 2 * N_EDGES + 2 * N_CHECKS) + N_EDGES + 2 * N_CHECKS)

__device__ __forceinline__ float phi0(float x) {
    // phi(x) = -ln(tanh(x/2)); x > 10 -> 0, x < 9.08e-5 -> 10
    if (x > 10.0f) return 0.0f;
    if (x < (float)9.08e-5) return 10.0f;
    return -logf(tanhf(x * 0.5f));
}

template <bool MINSUM>
__global__ void __launch_bounds__(THREADS)
bp_decode_kernel(const float* __restrict__ llr,
                 const int32_t* __restrict__ var_idx,
                 const uint8_t* __restrict__ emask,
                 const int32_t* __restrict__ vslots,
                 const uint8_t* __restrict__ vmask,
                 uint8_t* __restrict__ bits_out,
                 int32_t* __restrict__ iters_out,
                 uint8_t* __restrict__ parity_out,
                 int max_iter, float scale) {
    extern __shared__ float smem[];
    float* llr_s = smem;                      // [N_VARS]
    float* qi = llr_s + N_VARS;               // [N_VARS] posteriors
    float* vmsg = qi + N_VARS;                // [N_EDGES] var -> check, phi domain
    float* rmsg = vmsg + N_EDGES;             // [N_EDGES] check -> var, signed
    // sum-product: vmsg = phi0(|q|), phi_sum = per-check sum of vmsg;
    // min-sum: vmsg = |q| (MINSUM_BIG where invalid), phi_sum = smallest
    // and m2 = second smallest magnitude, mpos = first-min slot
    float* phi_sum = rmsg + N_EDGES;          // [N_CHECKS]
    float* m2 = phi_sum + N_CHECKS;           // [N_CHECKS]
    uint8_t* vsgn = reinterpret_cast<uint8_t*>(m2 + N_CHECKS);  // [N_EDGES]
    uint8_t* csgn = vsgn + N_EDGES;           // [N_CHECKS] sign parity per check
    uint8_t* mpos = csgn + N_CHECKS;          // [N_CHECKS]

    const int tid = threadIdx.x;
    const float* llr_b = llr + (size_t)blockIdx.x * N_VARS;

    for (int v = tid; v < N_VARS; v += THREADS) {
        llr_s[v] = llr_b[v];
        qi[v] = 0.0f;
    }
    __syncthreads();

    // var-side init: message phi0(|llr|) or |llr|, sign (llr < 0)
    for (int e = tid; e < N_EDGES; e += THREADS) {
        if (emask[e]) {
            float x = llr_s[var_idx[e]];
            vmsg[e] = MINSUM ? fabsf(x) : phi0(fabsf(x));
            vsgn[e] = x < 0.0f;
        } else {
            vmsg[e] = MINSUM ? MINSUM_BIG : 0.0f;
            vsgn[e] = 0;
        }
    }
    __syncthreads();

    int iters = max_iter;
    for (int it = 0; it < max_iter; ++it) {
        // check side: phi sum in slot order (or the two smallest
        // magnitudes and the first-min slot), sign parity, satisfied checks
        int checks_ok = 1;
        for (int c = tid; c < N_CHECKS; c += THREADS) {
            const float* m = vmsg + c * SLOTS;
            const uint8_t* sg = vsgn + c * SLOTS;
            int par = sg[0];
            for (int s = 1; s < SLOTS; ++s) par ^= sg[s];
            if (MINSUM) {
                float lo = m[0];
                for (int s = 1; s < SLOTS; ++s) lo = fminf(lo, m[s]);
                int pos = SLOTS;
                for (int s = SLOTS - 1; s >= 0; --s)
                    if (m[s] <= lo) pos = s;
                float lo2 = MINSUM_BIG;
                for (int s = 0; s < SLOTS; ++s)
                    if (s != pos) lo2 = fminf(lo2, m[s]);
                phi_sum[c] = lo;
                m2[c] = lo2;
                mpos[c] = (uint8_t)pos;
            } else {
                float acc = m[0];
                for (int s = 1; s < SLOTS; ++s) acc = acc + m[s];
                phi_sum[c] = acc;
            }
            csgn[c] = (uint8_t)par;
            checks_ok &= (par == 0);
        }
        const int all_checks = __syncthreads_and(checks_ok);

        // edge side: check -> var messages
        for (int e = tid; e < N_EDGES; e += THREADS) {
            float r = 0.0f;
            if (emask[e]) {
                int c = e / SLOTS;
                float mag;
                if (MINSUM)
                    mag = ((e - c * SLOTS) == mpos[c] ? m2[c] : phi_sum[c]) * scale;
                else
                    mag = phi0(phi_sum[c] - vmsg[e]);
                r = (csgn[c] ^ vsgn[e]) ? -mag : mag;
            }
            rmsg[e] = r;
        }
        __syncthreads();

        // var side: posterior = llr + sum of incoming messages (slot order)
        int data_one = 0;
        for (int v = tid; v < N_VARS; v += THREADS) {
            const int* sl = vslots + v * COL_W;
            const uint8_t* mk = vmask + v * COL_W;
            float g0 = mk[0] ? rmsg[sl[0]] : 0.0f;
            float g1 = mk[1] ? rmsg[sl[1]] : 0.0f;
            float g2 = mk[2] ? rmsg[sl[2]] : 0.0f;
            float q = llr_s[v] + ((g0 + g1) + g2);
            qi[v] = q;
            if (v < N_DATA && q < 0.0f) data_one = 1;
        }
        const int any_data_one = __syncthreads_or(data_one);

        // edge side: extrinsic var -> check messages
        for (int e = tid; e < N_EDGES; e += THREADS) {
            if (emask[e]) {
                float q = qi[var_idx[e]] - rmsg[e];
                vmsg[e] = MINSUM ? fabsf(q) : phi0(fabsf(q));
                vsgn[e] = MINSUM ? (q < 0.0f) : (q <= 0.0f);
            }
        }
        __syncthreads();

        if (!any_data_one || all_checks) {    // uniform across the block
            iters = it + 1;
            break;
        }
    }

    // epilogue: hard bits, iterations, parity of the output bits
    uint8_t* bits_b = bits_out + (size_t)blockIdx.x * N_VARS;
    for (int v = tid; v < N_VARS; v += THREADS) bits_b[v] = qi[v] < 0.0f;
    int ok = 1;
    for (int c = tid; c < N_CHECKS; c += THREADS) {
        int par = 0;
        for (int s = 0; s < SLOTS; ++s) {
            int e = c * SLOTS + s;
            if (emask[e]) par ^= (qi[var_idx[e]] < 0.0f);
        }
        ok &= (par == 0);
    }
    const int all_ok = __syncthreads_and(ok);
    if (tid == 0) {
        iters_out[blockIdx.x] = iters;
        parity_out[blockIdx.x] = (uint8_t)all_ok;
    }
}

template <bool MINSUM>
static int launch(const float* llr, const int32_t* var_idx,
                  const uint8_t* emask, const int32_t* vslots,
                  const uint8_t* vmask, uint8_t* bits, int32_t* iters,
                  uint8_t* parity_ok, int batch, int max_iter, float scale,
                  void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        bp_decode_kernel<MINSUM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (batch <= 0) return 0;
    bp_decode_kernel<MINSUM><<<batch, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        llr, var_idx, emask, vslots, vmask, bits, iters, parity_ok, max_iter,
        scale);
    return (int)cudaGetLastError();
}

// Launch on `stream`; return cudaGetLastError() (0 on success).
extern "C" int bp_decode_launch(const float* llr, const int32_t* var_idx,
                                const uint8_t* emask, const int32_t* vslots,
                                const uint8_t* vmask, uint8_t* bits,
                                int32_t* iters, uint8_t* parity_ok, int batch,
                                int max_iter, void* stream) {
    return launch<false>(llr, var_idx, emask, vslots, vmask, bits, iters,
                         parity_ok, batch, max_iter, 0.0f, stream);
}

extern "C" int bp_minsum_launch(const float* llr, const int32_t* var_idx,
                                const uint8_t* emask, const int32_t* vslots,
                                const uint8_t* vmask, uint8_t* bits,
                                int32_t* iters, uint8_t* parity_ok, int batch,
                                int max_iter, float scale, void* stream) {
    return launch<true>(llr, var_idx, emask, vslots, vmask, bits, iters,
                        parity_ok, batch, max_iter, scale, stream);
}
