// Sum-product belief-propagation decoder for the Wenet H2064_516 LDPC code,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel wenet_tpu/ops/ldpc_pallas2.py::_bp_kernel (wrapper
// decode_pallas2), and computes what wenet_tpu/ops/ldpc.py::decode computes:
// phi-domain sum-product with the reference clamps of phi0, per-codeword
// early exit (all data bits zero, or all 516 checks satisfied) and the same
// iteration count.
//
// Design.  One thread block per codeword; the block walks the iterations
// itself and stops when its codeword converges, which is exact because the
// JAX decoder freezes a converged codeword's state.  All BP state of the
// codeword (edge messages, signs, check sums, posteriors) lives in dynamic
// shared memory for the whole decode, as the Pallas kernel kept it resident
// in VMEM: device memory is touched only to read the 2580 LLRs and the
// index tables and to write the result.
//
// What bounds it on this card: not HBM bytes (about 10 KB in and out per
// codeword) but the latency of up to 10 serial iterations of four
// barrier-separated phases with divergent shared-memory gathers and
// log/tanh per edge, and shared-memory occupancy (about 86 KB per block, so
// two blocks per SM).  Batches of ~128 codewords fill about one wave of the
// 132 SMs.
//
// Numerics: logf/tanhf without fast-math, no FMA contraction (built with
// -fmad=false), the check-side sum in slot order 0..13 and the var-side sum
// in slot order 0..2, as the plain PyTorch reference does.
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

#define SMEM_BYTES (4 * (2 * N_VARS + 2 * N_EDGES + N_CHECKS) + N_EDGES + N_CHECKS)

__device__ __forceinline__ float phi0(float x) {
    // phi(x) = -ln(tanh(x/2)); x > 10 -> 0, x < 9.08e-5 -> 10
    if (x > 10.0f) return 0.0f;
    if (x < (float)9.08e-5) return 10.0f;
    return -logf(tanhf(x * 0.5f));
}

__global__ void __launch_bounds__(THREADS)
bp_decode_kernel(const float* __restrict__ llr,
                 const int32_t* __restrict__ var_idx,
                 const uint8_t* __restrict__ emask,
                 const int32_t* __restrict__ vslots,
                 const uint8_t* __restrict__ vmask,
                 uint8_t* __restrict__ bits_out,
                 int32_t* __restrict__ iters_out,
                 uint8_t* __restrict__ parity_out,
                 int max_iter) {
    extern __shared__ float smem[];
    float* llr_s = smem;                      // [N_VARS]
    float* qi = llr_s + N_VARS;               // [N_VARS] posteriors
    float* vmsg = qi + N_VARS;                // [N_EDGES] var -> check, phi domain
    float* rmsg = vmsg + N_EDGES;             // [N_EDGES] check -> var, signed
    float* phi_sum = rmsg + N_EDGES;          // [N_CHECKS]
    uint8_t* vsgn = reinterpret_cast<uint8_t*>(phi_sum + N_CHECKS);  // [N_EDGES]
    uint8_t* csgn = vsgn + N_EDGES;           // [N_CHECKS] sign parity per check

    const int tid = threadIdx.x;
    const float* llr_b = llr + (size_t)blockIdx.x * N_VARS;

    for (int v = tid; v < N_VARS; v += THREADS) {
        llr_s[v] = llr_b[v];
        qi[v] = 0.0f;
    }
    __syncthreads();

    // var-side init: message phi0(|llr|), sign (llr < 0)
    for (int e = tid; e < N_EDGES; e += THREADS) {
        if (emask[e]) {
            float x = llr_s[var_idx[e]];
            vmsg[e] = phi0(fabsf(x));
            vsgn[e] = x < 0.0f;
        } else {
            vmsg[e] = 0.0f;
            vsgn[e] = 0;
        }
    }
    __syncthreads();

    int iters = max_iter;
    for (int it = 0; it < max_iter; ++it) {
        // check side: phi sum in slot order, sign parity, satisfied checks
        int checks_ok = 1;
        for (int c = tid; c < N_CHECKS; c += THREADS) {
            const float* m = vmsg + c * SLOTS;
            const uint8_t* sg = vsgn + c * SLOTS;
            float acc = m[0];
            int par = sg[0];
            for (int s = 1; s < SLOTS; ++s) {
                acc = acc + m[s];
                par ^= sg[s];
            }
            phi_sum[c] = acc;
            csgn[c] = (uint8_t)par;
            checks_ok &= (par == 0);
        }
        const int all_checks = __syncthreads_and(checks_ok);

        // edge side: check -> var messages
        for (int e = tid; e < N_EDGES; e += THREADS) {
            float r = 0.0f;
            if (emask[e]) {
                int c = e / SLOTS;
                float mag = phi0(phi_sum[c] - vmsg[e]);
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
                vmsg[e] = phi0(fabsf(q));
                vsgn[e] = q <= 0.0f;
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

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int bp_decode_launch(const float* llr, const int32_t* var_idx,
                                const uint8_t* emask, const int32_t* vslots,
                                const uint8_t* vmask, uint8_t* bits,
                                int32_t* iters, uint8_t* parity_ok, int batch,
                                int max_iter, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        bp_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (batch <= 0) return 0;
    bp_decode_kernel<<<batch, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        llr, var_idx, emask, vslots, vmask, bits, iters, parity_ok, max_iter);
    return (int)cudaGetLastError();
}
