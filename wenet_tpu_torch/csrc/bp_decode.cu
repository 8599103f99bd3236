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
// checks satisfied) and the same iteration count.
//
// What bounds it on this card: not HBM bytes (about 10 KB in and 2.6 KB out
// per codeword) but the instructions of two phi0 = -log(tanh(x/2)) per edge
// per iteration (logf and tanhf from libdevice, no fast-math, which
// exactness requires; tens of instructions each) and, at small batches,
// the latency of up to 10 serial iterations.
//
// Design.  516 threads a block.  Unclustered (K = 1), a thread owns one
// check and five variables (2580 = 5 * 516):
//
//   check phase: thread c gathers q = qi[v] - rmsg[e] for its 14 slots,
//     keeps phi0(|q|) (min-sum: |q|) and the signs in registers, forms the
//     slot-ordered sum (or the two minima) and the sign parity, and writes
//     only the new rmsg of its edges;
//   var phase:   qi[v] = llr[v] + ((g0 + g1) + g2) over the var's slots.
//
// That is two barriers per iteration, and the shared state of a codeword is
// qi + rmsg (39 KB), so the index tables fit beside it: they are loaded once
// per block as uint16 (12-bit variable or 13-bit edge index plus a valid
// bit, packed by kernels/bp_decode.py) and never read from global memory
// again.  Large batches run on a persistent grid (SMs x resident blocks;
// registers allow two blocks of 516 threads per SM) whose blocks draw
// codewords from a queue, so a block that drew a slow codeword takes fewer.
// Small sum-product batches split a codeword over a cluster of K = 2 or 4
// blocks on K SMs: block r owns checks [r*516/K, ...) with K lanes a check
// (ceil(14/K) slots a lane; the slot-ordered sum runs from lane to lane by
// shuffle) and variables [r*2580/K, ...); every block holds full copies of
// qi and rmsg, writes go to all K copies through distributed shared memory,
// and cluster barriers replace __syncthreads.  The wrapper picks the shape
// from the batch (kernels/bp_decode.py: launch_shape).
//
// Numerics (bit-exact against ops/ldpc.decode_reference and
// decode_minsum_reference): logf/tanhf without fast-math, no FMA contraction
// (built with -fmad=false), the check-side sum in slot order 0..13 with
// invalid slots adding 0, the var-side sum llr + ((g0 + g1) + g2), phi0's
// clamps.  The first iteration takes q = llr (no rmsg yet) with the sign
// llr < 0; later ones q <= 0 (sum-product) or q < 0 (min-sum).  Min-sum:
// invalid slots hold MINSUM_BIG, the first-min slot is the lowest slot
// holding the minimum, `r_mag * scale` is one float32 multiply.
//
// Tables (global, uint16, slot-major):
//   ctab [14][516]  variable of edge (s, c) | VALID
//   vtab [3][2580]  edge s*516 + c of each variable slot | VALID

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define N_VARS 2580
#define N_DATA 2064
#define N_CHECKS 516
#define SLOTS 14
#define N_EDGES (N_CHECKS * SLOTS)
#define COL_W 3
#define THREADS N_CHECKS     // threads of a block, whatever the cluster
#define VALID 0x8000u
#define VAR_MASK 0x0FFFu
#define EDGE_MASK 0x1FFFu
#define N_VOTE_SLOTS 5      // [iteration parity][check, data] + final parity

#define MINSUM_BIG 1e30f

static size_t smem_bytes(int K) {
    return 4 * (N_VARS + N_EDGES) + 4 * N_VOTE_SLOTS * K
           + 2 * (SLOTS * (N_CHECKS / K) + COL_W * (N_VARS / K));
}

__device__ __forceinline__ float phi0(float x) {
    // phi(x) = -ln(tanh(x/2)); x > 10 -> 0, x < 9.08e-5 -> 10.  A warp whose
    // lanes all clamp skips logf/tanhf (most of them at high SNR).
    if (x > 10.0f) return 0.0f;
    if (x < (float)9.08e-5) return 10.0f;
    return -logf(tanhf(x * 0.5f));
}

// Block-wide (K = 1) or cluster-wide AND / OR of one int per thread.
// Each block's result goes to vote slot `slot` of every block of the
// cluster; the cluster barrier makes them visible.
template <int K, bool AND>
__device__ __forceinline__ int vote(int mine, int* const* flag_r,
                                    const int* flag, int slot, int rank) {
    const int blk = AND ? __syncthreads_and(mine) : __syncthreads_or(mine);
    if constexpr (K == 1) {
        return blk;
    } else {
        if (threadIdx.x == 0) {
#pragma unroll
            for (int r = 0; r < K; ++r) flag_r[r][slot * K + rank] = blk;
        }
        cg::this_cluster().sync();
        int out = AND ? 1 : 0;
#pragma unroll
        for (int r = 0; r < K; ++r)
            out = AND ? (out & flag[slot * K + r])
                      : (out | flag[slot * K + r]);
        return out;
    }
}

template <int K>
__device__ __forceinline__ void sync_all() {
    if constexpr (K == 1) __syncthreads();
    else cg::this_cluster().sync();
}

template <bool MINSUM, int K>
__global__ void __launch_bounds__(THREADS, 2)
bp_decode_kernel(const float* __restrict__ llr,
                 const uint16_t* __restrict__ ctab_g,
                 const uint16_t* __restrict__ vtab_g,
                 uint8_t* __restrict__ bits_out,
                 int32_t* __restrict__ iters_out,
                 uint8_t* __restrict__ parity_out,
                 int* __restrict__ queue,
                 const int* __restrict__ live,
                 int batch, int max_iter, float scale) {
    static_assert(!MINSUM || K == 1, "min-sum runs unclustered");
    constexpr int CB = N_CHECKS / K;   // checks of a block
    constexpr int VB = N_VARS / K;     // variables of a block
    constexpr int L = K;               // lanes of a check
    constexpr int SL = (SLOTS + L - 1) / L;         // slots of a lane
    constexpr int NV = (VB + THREADS - 1) / THREADS;  // variables of a thread
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* qi = reinterpret_cast<float*>(smem_raw);     // [N_VARS] full copy
    float* rmsg = qi + N_VARS;                          // [N_EDGES] full copy
    int* flag = reinterpret_cast<int*>(rmsg + N_EDGES); // [N_VOTE_SLOTS][K]
    uint16_t* ctab = reinterpret_cast<uint16_t*>(flag + N_VOTE_SLOTS * K);
    uint16_t* vtab = ctab + SLOTS * CB;                 // [COL_W][VB]

    const int t = threadIdx.x;
    int rank = 0;
    float* qi_r[K];
    float* rmsg_r[K];
    int* flag_r[K];
    if constexpr (K == 1) {
        qi_r[0] = qi;
        rmsg_r[0] = rmsg;
        flag_r[0] = flag;
    } else {
        cg::cluster_group cluster = cg::this_cluster();
        rank = (int)cluster.block_rank();
#pragma unroll
        for (int r = 0; r < K; ++r) {
            qi_r[r] = cluster.map_shared_rank(qi, r);
            rmsg_r[r] = cluster.map_shared_rank(rmsg, r);
            flag_r[r] = cluster.map_shared_rank(flag, r);
        }
    }
    // this thread: lane `lane` of local check cl (slots s0 .. s0 + SL - 1),
    // and the block's variables t, t + THREADS, ...
    const int lane = t % L, cl = t / L, c = rank * CB + cl, s0 = lane * SL;
    // the lanes of a check are neighbours in one warp; the block's last
    // warp is partial
    const unsigned wmask = (t | 31) < THREADS
        ? 0xffffffffu : (1u << (THREADS & 31)) - 1;

    // this block's columns of the tables, once
    for (int i = t; i < SLOTS * CB; i += THREADS) {
        const int s = i / CB;
        ctab[i] = ctab_g[s * N_CHECKS + rank * CB + (i - s * CB)];
    }
    for (int i = t; i < COL_W * VB; i += THREADS) {
        const int k = i / VB;
        vtab[i] = vtab_g[k * N_VARS + rank * VB + (i - k * VB)];
    }
    __syncthreads();
    uint32_t valid = 0;                // valid slots s0 + i of this lane
#pragma unroll
    for (int i = 0; i < SL; ++i)
        if (s0 + i < SLOTS)
            valid |= (uint32_t)((ctab[(s0 + i) * CB + cl] & VALID) != 0) << i;

    // the codewords to decode: the first *live of the batch where the
    // caller counts them on the card, so that a batch sized by a capacity
    // runs its live rows alone (the rows past them exit at once)
    if (live != nullptr) batch = min(batch, *live);
    __shared__ int next_cw;
    for (int cw = blockIdx.x / K; cw < batch;) {
        // qi = llr (every copy holds all of it); rmsg needs no reset, since
        // the first check phase reads none and writes every valid edge
        const float* llr_b = llr + (size_t)cw * N_VARS;
        float lv[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const int vl = t + j * THREADS;
            lv[j] = vl < VB ? llr_b[rank * VB + vl] : 0.0f;
        }
        if constexpr (K == 1) {
#pragma unroll
            for (int j = 0; j < NV; ++j) qi[t + j * THREADS] = lv[j];
        } else {
            for (int v = t; v < N_VARS; v += THREADS) qi[v] = llr_b[v];
        }
        sync_all<K>();

        int iters = max_iter;
        for (int it = 0; it < max_iter; ++it) {
            // check phase: var -> check messages of this lane's slots
            float m[SL];
            uint32_t sg = 0;
#pragma unroll
            for (int i = 0; i < SL; ++i) {
                const int s = s0 + i;
                float mag = MINSUM ? MINSUM_BIG : 0.0f;
                if (valid >> i & 1) {
                    const float qv = qi[ctab[s * CB + cl] & VAR_MASK];
                    const float q = it == 0 ? qv : qv - rmsg[s * N_CHECKS + c];
                    const bool neg = (MINSUM || it == 0) ? (q < 0.0f)
                                                         : (q <= 0.0f);
                    sg |= (uint32_t)neg << i;
                    mag = MINSUM ? fabsf(q) : phi0(fabsf(q));
                }
                m[i] = mag;
            }
            uint32_t par = __popc(sg) & 1;
#pragma unroll
            for (int off = 1; off < L; off <<= 1)
                par ^= __shfl_xor_sync(wmask, par, off, L);
            float acc, m2 = 0.0f;
            int pos = SLOTS;
            if (MINSUM) {                       // one lane (K == 1)
                acc = m[0];
#pragma unroll
                for (int i = 1; i < SLOTS; ++i) acc = fminf(acc, m[i]);
#pragma unroll
                for (int i = SLOTS - 1; i >= 0; --i)
                    if (m[i] <= acc) pos = i;
                m2 = MINSUM_BIG;
#pragma unroll
                for (int i = 0; i < SLOTS; ++i)
                    if (i != pos) m2 = fminf(m2, m[i]);
            } else {
                // the sum in slot order 0..13: lane l continues lane l-1's
                float run = 0.0f;
#pragma unroll
                for (int l = 0; l < L; ++l) {
                    const float prev =
                        L > 1 ? __shfl_up_sync(wmask, run, 1, L) : 0.0f;
                    if (lane == l) {
                        float a = l == 0 ? m[0] : prev + m[0];
#pragma unroll
                        for (int i = 1; i < SL; ++i)
                            if (s0 + i < SLOTS) a = a + m[i];
                        run = a;
                    }
                }
                acc = L > 1 ? __shfl_sync(wmask, run, L - 1, L) : run;
            }
            // check -> var messages of this lane's slots, to every copy
#pragma unroll
            for (int i = 0; i < SL; ++i) {
                if (valid >> i & 1) {
                    const int s = s0 + i;
                    const float mag = MINSUM ? (s == pos ? m2 : acc) * scale
                                             : phi0(acc - m[i]);
                    const float r = ((par ^ (sg >> i)) & 1) ? -mag : mag;
#pragma unroll
                    for (int k = 0; k < K; ++k)
                        rmsg_r[k][s * N_CHECKS + c] = r;
                }
            }
            const int all_checks = vote<K, true>(par == 0, flag_r, flag,
                                                 2 * (it & 1), rank);

            // var phase: posteriors (slot order), to every copy
            int data_one = 0;
#pragma unroll
            for (int j = 0; j < NV; ++j) {
                const int vl = t + j * THREADS, v = rank * VB + vl;
                if (vl < VB) {
                    float g[COL_W];
#pragma unroll
                    for (int k = 0; k < COL_W; ++k) {
                        const uint32_t ent = vtab[k * VB + vl];
                        g[k] = (ent & VALID) ? rmsg[ent & EDGE_MASK] : 0.0f;
                    }
                    const float q = lv[j] + ((g[0] + g[1]) + g[2]);
#pragma unroll
                    for (int k = 0; k < K; ++k) qi_r[k][v] = q;
                    data_one |= (v < N_DATA) & (q < 0.0f);
                }
            }
            const int any_data_one = vote<K, false>(data_one, flag_r, flag,
                                                    2 * (it & 1) + 1, rank);
            if (!any_data_one || all_checks) {  // uniform across the cluster
                iters = it + 1;
                break;
            }
        }

        // epilogue: hard bits, iterations, parity of the output bits (all
        // zero bits when no iteration ran)
        const bool ran = max_iter > 0;
        uint8_t* bits_b = bits_out + (size_t)cw * N_VARS + rank * VB;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
            const int vl = t + j * THREADS;
            if (vl < VB) bits_b[vl] = ran && qi[rank * VB + vl] < 0.0f;
        }
        uint32_t par = 0;
#pragma unroll
        for (int i = 0; i < SL; ++i)
            if (valid >> i & 1)
                par ^= (uint32_t)(
                    ran && qi[ctab[(s0 + i) * CB + cl] & VAR_MASK] < 0.0f);
#pragma unroll
        for (int off = 1; off < L; off <<= 1)
            par ^= __shfl_xor_sync(wmask, par, off, L);
        const int all_ok = vote<K, true>(par == 0, flag_r, flag, 4, rank);
        if (rank == 0 && t == 0) {
            iters_out[cw] = iters;
            parity_out[cw] = (uint8_t)all_ok;
        }
        // next codeword: from the queue when the grid is smaller than the
        // batch (blocks that drew slow codewords take fewer), else none
        if (K == 1 && queue != nullptr) {
            if (t == 0) next_cw = atomicAdd(queue, 1) + gridDim.x;
            __syncthreads();
            cw = next_cw;
        } else {
            cw += gridDim.x / K;
        }
    }
}

// Dynamic shared memory above 48 KB and the largest shared-memory carveout
// (three unclustered blocks per SM), set once per device.
template <bool MINSUM, int K>
static cudaError_t prepare() {
    static bool done[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
    err = cudaFuncSetAttribute(bp_decode_kernel<MINSUM, K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(K));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bp_decode_kernel<MINSUM, K>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && dev < 64) done[dev] = true;
    return err;
}

template <bool MINSUM, int K>
static cudaError_t launch_k(const float* llr, const uint16_t* ctab,
                            const uint16_t* vtab, uint8_t* bits,
                            int32_t* iters, uint8_t* parity_ok, int* queue,
                            const int* live, int batch, int max_iter,
                            float scale, int grid,
                            cudaStream_t stream) {
    auto kernel = bp_decode_kernel<MINSUM, K>;
    const size_t smem = smem_bytes(K);
    cudaError_t err = prepare<MINSUM, K>();
    if (err != cudaSuccess) return err;
    if (K > 1 || grid >= batch) {
        queue = nullptr;
    } else {
        err = cudaMemsetAsync(queue, 0, sizeof(int), stream);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, llr, ctab, vtab, bits, iters,
                             parity_ok, queue, live, batch, max_iter, scale);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <bool MINSUM>
static int launch(const float* llr, const uint16_t* ctab,
                  const uint16_t* vtab, uint8_t* bits, int32_t* iters,
                  uint8_t* parity_ok, int* queue, const int* live,
                  int batch, int max_iter, float scale, int cluster,
                  int grid, void* stream) {
    if (batch <= 0) return 0;
    if (grid <= 0 || grid % cluster) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (cluster == 1)
        return (int)launch_k<MINSUM, 1>(llr, ctab, vtab, bits, iters,
                                        parity_ok, queue, live, batch,
                                        max_iter, scale, grid, s);
    if constexpr (!MINSUM) {
        if (cluster == 2)
            return (int)launch_k<false, 2>(llr, ctab, vtab, bits, iters,
                                           parity_ok, queue, live, batch,
                                           max_iter, scale, grid, s);
        if (cluster == 4)
            return (int)launch_k<false, 4>(llr, ctab, vtab, bits, iters,
                                           parity_ok, queue, live, batch,
                                           max_iter, scale, grid, s);
    }
    return (int)cudaErrorInvalidValue;
}

// Launch on `stream` with `grid` blocks in clusters of `cluster` (1, 2 or
// 4; min-sum: 1); `queue` is one int of scratch, used (and zeroed on the
// stream first) when an unclustered grid is smaller than the batch; `live`,
// where not null, one int on the card: only the batch's first *live
// codewords are decoded (the other rows' outputs are left unwritten).
// Returns cudaGetLastError() (0 on success).
extern "C" int bp_decode_launch(const float* llr, const uint16_t* ctab,
                                const uint16_t* vtab, uint8_t* bits,
                                int32_t* iters, uint8_t* parity_ok,
                                int* queue, const int* live, int batch,
                                int max_iter, int cluster, int grid,
                                void* stream) {
    return launch<false>(llr, ctab, vtab, bits, iters, parity_ok, queue,
                         live, batch, max_iter, 0.0f, cluster, grid, stream);
}

extern "C" int bp_minsum_launch(const float* llr, const uint16_t* ctab,
                                const uint16_t* vtab, uint8_t* bits,
                                int32_t* iters, uint8_t* parity_ok,
                                int* queue, const int* live, int batch,
                                int max_iter, float scale, int cluster,
                                int grid, void* stream) {
    return launch<true>(llr, ctab, vtab, bits, iters, parity_ok, queue,
                        live, batch, max_iter, scale, cluster, grid, stream);
}

// Resident blocks per SM of the unclustered kernel (the persistent grid of
// large batches is SMs times this).
extern "C" int bp_decode_blocks_per_sm(int minsum, int* blocks) {
    cudaError_t err = minsum ? prepare<true, 1>() : prepare<false, 1>();
    if (err != cudaSuccess) return (int)err;
    auto kernel = minsum ? bp_decode_kernel<true, 1>
                         : bp_decode_kernel<false, 1>;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, THREADS, smem_bytes(1));
}
