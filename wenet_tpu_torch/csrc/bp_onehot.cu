// Sum-product belief-propagation decoder for the Wenet H2064_516 LDPC code
// with the var<->edge maps as one-hot matrix products on the tensor cores,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel wenet_tpu/ops/ldpc_pallas.py::_bp_kernel (wrapper
// decode_pallas), and computes what wenet_tpu/ops/ldpc.py::decode computes:
// phi-domain sum-product with the reference clamps of phi0, per-codeword
// early exit (all data bits zero, or all 516 checks satisfied) and the same
// iteration count.  Its plain version is
// wenet_tpu_torch/ops/ldpc_onehot.py::decode_onehot_reference; the tables
// it reads are built by ops/ldpc_onehot.py::cluster_tables / pack_tables.
//
// What bounded the earlier design (one 512-thread block per 16 codewords,
// state in device scratch, one-hot B fragments streamed from 3 MB of
// tile lists): B = 128 ran on 8 of the 132 SMs, so one SM issued
// the phi work of 16 codewords; every tile visit loaded its float32 operand
// through L1/L2; four barrier-separated phases an iteration.
//
// Design.
//
// * A tile of 8 codewords (the N of mma.m16n8k16) runs on a cluster of 8
//   blocks.  Block b owns checks [516 b / 8, 516 (b + 1) / 8) (64 or 65)
//   and variables [2580 b / 8, 2580 (b + 1) / 8) (322 or 323), so each SM
//   issues the phi work of about one codeword.  Past the clusters the card
//   holds at once (15 on an H100 SXM: a cluster must fit in one GPC), a
//   persistent grid of them walks the tiles with a fixed stride.
// * All decoder state is in shared memory: qi of the block's local
//   variables (the variables of its edges, at most 768) and r of its edges,
//   each in float32 and as bf16 pieces, the var-side sums and llr and qi of
//   its own variables; 186 KB plus 17 KB of tables.  Nothing but llr, the
//   tables and the outputs touches device memory.
// * Edges are slot-major over the block's checks (e = s * 65 + c), local
//   variables numbered in order of first appearance along e, so the
//   broadcast's one-hot matrix is close to a staircase: about 180 visits of
//   16x16 tiles a block and iteration, and about 200 for the edge -> var
//   map, whose rows are the block's (variable, slot) pairs sorted by
//   variable (the 16-codeword design: about 12,000 per 16 codewords).
// * The one-hot matrix is the A operand (16 output rows by 16 of K), the
//   codewords the N.  A visit is one uint32 a lane: the k-tile and the
//   column of the one in its two rows (0xFF: none), from which it builds
//   its A fragment with a few integer operations.  Each block copies its
//   own table region into shared memory once (cp.async).
// * Exactness.  Each row of each one-hot matrix holds at most one 1, so a
//   product only moves a value.  Tensor cores take bf16: the float32
//   operand is cut into three bf16 pieces (hi, mid, lo: each the top 8
//   significant bits of what is left, by bit mask; the subtractions are
//   exact), each piece goes through its own product with float32
//   accumulation (one nonzero term a row: exact), and (hi + mid) + lo
//   restores the float32 value exactly (for |x| >= 2^-110; see split3 in
//   ops/ldpc_onehot.py).  Each block cuts its float32 qi and r into pieces
//   once an iteration (split_rows), so a visit loads its B fragments with
//   six 32-bit loads and no arithmetic.
//
// One iteration (check-owned, as in bp_decode.cu: the state is qi and r,
// q = qi_e - r is formed where it is used):
//
//   edge phase   var -> edge broadcast on the tensor cores; per edge and
//                codeword q = qi_e - r, phi0(|q|) and the sign, stored as
//                one signed float;
//   check phase  one thread per (check, codeword): the sum in slot order
//                0..13, the sign parity, r = +-phi0(acc - m);
//   edge -> var  on the tensor cores: every var's k-th edge lies in one
//                block, whose product is exact and which stores it into
//                the owner's sums through distributed shared memory;
//                cluster barrier (with the parity vote);
//   var phase    the owner forms qi = llr + ((g0 + g1) + g2) and stores it
//                into the local-variable copies of the blocks that hold
//                the variable (at most 3); cluster barrier (with the data
//                vote).  Converged codewords are frozen.
//
// Numerics (bit-exact against ops/ldpc.decode_reference): logf/tanhf
// without fast-math, no FMA contraction (built with -fmad=false), the
// check-side sum in slot order with invalid slots adding 0, the var-side
// sum llr + ((g0 + g1) + g2), phi0's clamps; the first iteration takes
// q = llr with the sign llr < 0, later ones q <= 0.  A CPU emulation of
// this schedule on the packed tables (tests/test_torch_kernels.py) equals
// the reference.
//
// What bounds it now (chip_profile.py's phase clocks; PERF.md): an
// iteration takes about 33,000 SM cycles at B = 70, of which the edge
// phase about 13,000 (tile visits and phi0), the check phase 6,500
// (phi0), edge -> var 8,500 (tile visits), the var phase 3,000 and the
// two cluster barriers 5,000.  A visit is an integer-built A fragment,
// six loads and three mma.  Fewer, denser visits and one barrier less (each
// holder forming qi itself, which needs shared memory this layout does
// not have) are the next steps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define N_VARS 2580
#define N_DATA 2064
#define SLOTS 14
#define CL 8                  // blocks per cluster (kernels/bp_onehot.py)
#define NCW 8                 // codewords per tile: the N of the mma
#define CA 65                 // slot stride of a block's edges
#define EP 912                // a block's edge slots, 14 * 65 padded to 16
#define LP 768                // local variables of a block, at most
#define VO 324                // owned variables of a block, padded
#define MS 916                // row stride of the phi buffer
#define THREADS 544
#define NWARPS (THREADS / 32)
#define HOLD_NONE 0xFFFFu

// header of a block's table region (ops/ldpc_onehot.py: H_*)
enum {
    H_C0, H_NC, H_V0, H_NV, H_NL, H_NBC, H_BC_PTR, H_BC_MASK, H_BC_CODE,
    H_NER, H_NEV, H_EV_PTR, H_EV_CODE, H_EV_DEST, H_OWN_HOLD
};

// dynamic shared memory, bytes
#define OFF_QF 0                                  // f32 [LP] rows of NCW
#define OFF_QP (OFF_QF + LP * NCW * 4)            // u32 [3][LP / 2][NCW]
#define OFF_RF (OFF_QP + 3 * LP * NCW * 2)        // f32 [EP] rows of NCW
#define OFF_RP (OFF_RF + EP * NCW * 4)            // u32 [3][EP / 2][NCW]
#define OFF_M OFF_RP                              // f32 [NCW][MS], aliased
#define OFF_G (OFF_RP + 3 * EP * NCW * 2)         // f32 [3][VO][NCW]
#define OFF_LLR (OFF_G + 3 * VO * NCW * 4)        // f32 [VO][NCW]
#define OFF_QI (OFF_LLR + VO * NCW * 4)           // f32 [VO][NCW]
#define OFF_FLAG (OFF_QI + VO * NCW * 4)          // int [64]
#define OFF_TAB (OFF_FLAG + 64 * 4)               // u16 table region
// vote flags: [0, 40) slots of CL ints (bad parity: slot it & 1; data
// one: 2 + (it & 1); final parity: 4), then the block's own accumulators
#define F_BAD 40
#define F_DATA 41
#define F_ITERS 48
static_assert(NCW * MS * 4 <= 3 * EP * NCW * 2,
              "the phi buffer outgrows r's pieces");

#ifdef BP_ONEHOT_PHASES
// clock64 at the phase ends of iteration it < 16 of blocks < 64, read by
// chip_profile.py (a build with -DBP_ONEHOT_PHASES); no-ops otherwise
__device__ long long bp_onehot_phases[64 * 16 * 8];
extern "C" int bp_onehot_read_phases(long long* host) {
    return (int)cudaMemcpyFromSymbol(host, bp_onehot_phases,
                                     sizeof(bp_onehot_phases));
}
#define PHASE(k)                                                       \
    if (tid == 0 && blockIdx.x < 64 && it < 16)                        \
    bp_onehot_phases[(blockIdx.x * 16 + it) * 8 + (k)] = clock64()
#else
#define PHASE(k)
#endif

static size_t smem_bytes(int region) {
    return (size_t)OFF_TAB + 2 * (size_t)region;
}

__device__ __forceinline__ float phi0(float x) {
    // phi(x) = -ln(tanh(x/2)); x > 10 -> 0, x < 9.08e-5 -> 10
    if (x > 10.0f) return 0.0f;
    if (x < (float)9.08e-5) return 10.0f;
    return -logf(tanhf(x * 0.5f));
}

// Float offset of row k (8 codewords, 32 bytes) of qi or r: four rows to a
// 128-byte line, the row's place in it swizzled by bit 2 of k, so that a
// warp reading rows k, k + 2, k + 4, k + 6 (k % 8 < 2) meets no bank
// conflict.
__device__ __forceinline__ int row_at(int k) {
    return (k >> 2) << 5 | ((k & 3) ^ ((k >> 2) & 1)) << 3;
}

// The bf16 pieces (hi, mid, lo) of x and y, each the top 8 significant bits
// of what is left (by bit mask; the subtractions are exact), packed in pairs
// (x in the low half): (hi + mid) + lo == x.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& h,
                                           uint32_t& m, uint32_t& l) {
    const uint32_t hx = __float_as_uint(x) & 0xFFFF0000u;
    const uint32_t hy = __float_as_uint(y) & 0xFFFF0000u;
    const float rx = x - __uint_as_float(hx), ry = y - __uint_as_float(hy);
    const uint32_t mx = __float_as_uint(rx) & 0xFFFF0000u;
    const uint32_t my = __float_as_uint(ry) & 0xFFFF0000u;
    const float sx = rx - __uint_as_float(mx), sy = ry - __uint_as_float(my);
    h = __byte_perm(hx, hy, 0x7632);
    m = __byte_perm(mx, my, 0x7632);
    l = __byte_perm(__float_as_uint(sx), __float_as_uint(sy), 0x7632);
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

// One row of a one-hot A tile, code c (the column of its one, 0xFF:
// none), as lane (g, q) holds it: `lo` = columns 2q, 2q+1 and `hi` =
// columns 2q+8, 2q+9, each a pair of bf16 (lower column in the low half).
__device__ __forceinline__ void onehot_row(uint32_t c, int q, uint32_t& lo,
                                           uint32_t& hi) {
    const uint32_t d = c - 2u * (uint32_t)q;
    lo = d < 2u ? 0x3F80u << (d << 4) : 0u;
    const uint32_t d8 = d - 8u;
    hi = d8 < 2u ? 0x3F80u << (d8 << 4) : 0u;
}

// The bf16 pieces of X (rows of NCW floats) as B operands: P[pc][m][n] =
// piece pc of rows 2m (low half) and 2m + 1 (high half), codeword n.
template <int ROWS>
__device__ __forceinline__ void split_rows(const float* X, uint32_t* P,
                                           int tid) {
    constexpr int PS = ROWS / 2 * NCW;
    for (int idx = tid; idx < PS; idx += THREADS) {
        const int m = idx >> 3, n = idx & (NCW - 1);
        split_pair(X[row_at(2 * m) + n], X[row_at(2 * m + 1) + n], P[idx],
                   P[PS + idx], P[2 * PS + idx]);
    }
}

// One visit: code word w (k-tile << 16 | row g + 8 << 8 | row g) times the
// pieces P (split_rows<ROWS>); lane (g, q) reads column g, rows 2q, 2q + 1
// (b0) and 2q + 8, 2q + 9 (b1) of the k-tile.
template <int ROWS>
__device__ __forceinline__ void visit(uint32_t w, const uint32_t* P, int g,
                                      int q, float (&dh)[4], float (&dm)[4],
                                      float (&dl)[4]) {
    constexpr int PS = ROWS / 2 * NCW;
    uint32_t a0, a1, a2, a3;
    onehot_row(w & 0xFFu, q, a0, a2);
    onehot_row((w >> 8) & 0xFFu, q, a1, a3);
    const uint32_t* b = P + (w >> 16) * (8 * NCW) + q * NCW + g;
    mma_bf16(dh, a0, a1, a2, a3, b[0], b[4 * NCW]);
    mma_bf16(dm, a0, a1, a2, a3, b[PS], b[PS + 4 * NCW]);
    mma_bf16(dl, a0, a1, a2, a3, b[2 * PS], b[2 * PS + 4 * NCW]);
}

// One 16-row output tile of a one-hot matrix, given by its visits p0..p1
// (code[p * 8 + g]), times the pieces P.  Two visits at a time into two
// sets of accumulators (each row holds one 1 in all, so the other set
// holds 0 for it and the sum is exact); a missing second visit is code
// 0xFFFF (no ones).  Lane l = 4 g + q gets
// out = {(g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1)} (row, codeword).
template <int ROWS>
__device__ __forceinline__ void onehot_tile(const uint32_t* code, int p0,
                                            int p1, const uint32_t* P, int g,
                                            int q, float (&out)[4]) {
    float dh[2][4] = {}, dm[2][4] = {}, dl[2][4] = {};
    for (int p = p0; p < p1; p += 2) {
        const uint32_t w0 = code[p * 8 + g];
        const uint32_t w1 = p + 1 < p1 ? code[(p + 1) * 8 + g] : 0xFFFFu;
        visit<ROWS>(w0, P, g, q, dh[0], dm[0], dl[0]);
        visit<ROWS>(w1, P, g, q, dh[1], dm[1], dl[1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        out[j] = ((dh[0][j] + dh[1][j]) + (dm[0][j] + dm[1][j]))
                 + (dl[0][j] + dl[1][j]);
}

// Write value to `slot` of every block's flags (thread 0 only).
__device__ __forceinline__ void post(cg::cluster_group& cluster, int* flag,
                                     int slot, int rank, int value) {
#pragma unroll
    for (int r = 0; r < CL; ++r)
        cluster.map_shared_rank(flag, r)[slot * CL + rank] = value;
}

__device__ __forceinline__ int gather(const int* flag, int slot) {
    int out = 0;
#pragma unroll
    for (int r = 0; r < CL; ++r) out |= flag[slot * CL + r];
    return out;
}

struct Tables {
    int nc, v0, nv, n_rows;
    const uint16_t *bc_ptr, *bc_mask, *ev_ptr, *ev_dest, *own_hold;
    const uint32_t *bc_code, *ev_code;
};

enum { EDGE_FIRST, EDGE_LATER, EDGE_FINAL };

// Edge phase: qi_e by the broadcast product; M[n][e] = +-phi0(|q|) with
// the sign of the var -> check message (EDGE_FINAL: -0 where the output
// bit of the edge's variable is 1, else +0).  Invalid edges get +0.
__device__ __forceinline__ void edge_phase(const Tables& tb, int mode,
                                           bool ran, const uint32_t* qP,
                                           const float* rF, float* M,
                                           int warp, int g, int q) {
    for (int t = warp; t < EP / 16; t += NWARPS) {
        float x[4];
        onehot_tile<LP>(tb.bc_code, tb.bc_ptr[t], tb.bc_ptr[t + 1], qP, g, q,
                        x);
        const uint32_t mask = tb.bc_mask[t];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = g + 8 * half, e = t * 16 + row;
            float2 r = make_float2(0.0f, 0.0f);
            if (mode == EDGE_LATER)
                r = *reinterpret_cast<const float2*>(rF + row_at(e) + 2 * q);
            const float rv[2] = {r.x, r.y};
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const float xv = x[2 * half + c];
                float out = 0.0f;
                if (mask >> row & 1u) {
                    if (mode == EDGE_FINAL) {
                        out = (ran && xv < 0.0f) ? -0.0f : 0.0f;
                    } else {
                        const float qv = mode == EDGE_FIRST ? xv : xv - rv[c];
                        const bool neg = mode == EDGE_FIRST ? qv < 0.0f
                                                            : qv <= 0.0f;
                        const float m = phi0(fabsf(qv));
                        out = neg ? -m : m;
                    }
                }
                M[(2 * q + c) * MS + e] = out;
            }
        }
    }
}

// Check phase: thread (check c, codeword n) sums its 14 slots in order,
// takes the sign parity, and (write_r) stores r = +-phi0(acc - m) of its
// valid slots; ORs the parity into *bad.
__device__ __forceinline__ void check_phase(const Tables& tb, bool write_r,
                                            uint32_t valid, const float* M,
                                            float* rF, int* bad, int tid,
                                            int lane) {
    const int n = tid & (NCW - 1), c = tid >> 3;
    uint32_t par = 0;
    if (c < tb.nc) {
        float m[SLOTS];
        uint32_t sg = 0;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
            const float v = M[n * MS + s * CA + c];
            m[s] = fabsf(v);
            sg |= (__float_as_uint(v) >> 31) << s;
        }
        float acc = m[0];
#pragma unroll
        for (int s = 1; s < SLOTS; ++s) acc = acc + m[s];
        par = __popc(sg) & 1u;
        if (write_r) {
#pragma unroll
            for (int s = 0; s < SLOTS; ++s) {
                if (valid >> s & 1u) {
                    const float mag = phi0(acc - m[s]);
                    rF[row_at(s * CA + c) + n] =
                        ((par ^ (sg >> s)) & 1u) ? -mag : mag;
                }
            }
        }
    }
    const uint32_t bits = __reduce_or_sync(0xffffffffu, par << n);
    if (lane == 0 && bits) atomicOr(bad, (int)bits);
}

// Edge -> var: each output tile (16 (variable, slot) rows) is the product
// over the block's edges; each row goes to its owner's sums G[k][i][n]
// through distributed shared memory.
__device__ __forceinline__ void edge_to_var(cg::cluster_group& cluster,
                                            const Tables& tb,
                                            const uint32_t* rP, float* G,
                                            int warp, int g, int q) {
    for (int t = warp; t * 16 < tb.n_rows; t += NWARPS) {
        float x[4];
        onehot_tile<EP>(tb.ev_code, tb.ev_ptr[t], tb.ev_ptr[t + 1], rP, g, q,
                        x);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = t * 16 + g + 8 * half;
            if (row < tb.n_rows) {
                const uint32_t dest = tb.ev_dest[row];
                float* Gr = cluster.map_shared_rank(G, (int)(dest >> 11));
                *reinterpret_cast<float2*>(
                    Gr + ((int)(dest >> 9 & 3u) * VO + (int)(dest & 0x1FFu))
                             * NCW + 2 * q) =
                    make_float2(x[2 * half], x[2 * half + 1]);
            }
        }
    }
}

// Var phase of the owner, one thread per variable and half of the
// codewords: qi = llr + ((g0 + g1) + g2) for the unconverged codewords
// (init: qi = llr), the data-one vote, and qi into the local-variable
// copies of the (at most 3) blocks holding the variable.
__device__ __forceinline__ void var_phase(cg::cluster_group& cluster,
                                          const Tables& tb, bool init,
                                          uint32_t conv, const float* llr_o,
                                          float* qi_o, const float* G,
                                          float* qF, int* data, int tid,
                                          int lane) {
    uint32_t one = 0;
    for (int idx = tid; idx < 2 * tb.nv; idx += THREADS) {
        const int i = idx >> 1, h4 = (idx & 1) * 4;
        float4* q4 = reinterpret_cast<float4*>(qi_o + i * NCW + h4);
        float4 qv = *reinterpret_cast<const float4*>(llr_o + i * NCW + h4);
        if (!init) {
            const float4 g0 = *reinterpret_cast<const float4*>(
                G + i * NCW + h4);
            const float4 g1 = *reinterpret_cast<const float4*>(
                G + (VO + i) * NCW + h4);
            const float4 g2 = *reinterpret_cast<const float4*>(
                G + (2 * VO + i) * NCW + h4);
            const float4 old = *q4;
            const float l[4] = {qv.x, qv.y, qv.z, qv.w};
            const float a[4] = {g0.x, g0.y, g0.z, g0.w};
            const float b[4] = {g1.x, g1.y, g1.z, g1.w};
            const float c[4] = {g2.x, g2.y, g2.z, g2.w};
            const float o[4] = {old.x, old.y, old.z, old.w};
            const bool is_data = tb.v0 + i < N_DATA;
            float x[4];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                const float v = l[n] + ((a[n] + b[n]) + c[n]);
                one |= (uint32_t)(is_data && v < 0.0f) << (h4 + n);
                x[n] = (conv >> (h4 + n) & 1u) ? o[n] : v;
            }
            qv = make_float4(x[0], x[1], x[2], x[3]);
        }
        *q4 = qv;
#pragma unroll
        for (int h = 0; h < 3; ++h) {
            const uint32_t hold = tb.own_hold[i * 3 + h];
            if (hold == HOLD_NONE) break;
            *reinterpret_cast<float4*>(
                cluster.map_shared_rank(qF, (int)(hold >> 12))
                + row_at((int)(hold & 0xFFFu)) + h4) = qv;
        }
    }
    const uint32_t bits = __reduce_or_sync(0xffffffffu, one);
    if (lane == 0 && bits) atomicOr(data, (int)bits);
}

__global__ void __launch_bounds__(THREADS, 1)
bp_onehot_kernel(const float* __restrict__ llr,
                 const uint16_t* __restrict__ tab_g, int region,
                 uint8_t* __restrict__ bits_out,
                 int32_t* __restrict__ iters_out,
                 uint8_t* __restrict__ parity_out, int batch, int max_iter) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* qF = reinterpret_cast<float*>(smem + OFF_QF);
    uint32_t* qP = reinterpret_cast<uint32_t*>(smem + OFF_QP);
    float* rF = reinterpret_cast<float*>(smem + OFF_RF);
    uint32_t* rP = reinterpret_cast<uint32_t*>(smem + OFF_RP);
    float* M = reinterpret_cast<float*>(smem + OFF_M);
    float* G = reinterpret_cast<float*>(smem + OFF_G);
    float* llr_o = reinterpret_cast<float*>(smem + OFF_LLR);
    float* qi_o = reinterpret_cast<float*>(smem + OFF_QI);
    int* flag = reinterpret_cast<int*>(smem + OFF_FLAG);
    uint16_t* tab = reinterpret_cast<uint16_t*>(smem + OFF_TAB);

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;

    // this block's tables, once (cp.async, 16 bytes a copy); zero the
    // state (padding rows and never-written sums stay 0) and the flags
    {
        const uint16_t* src = tab_g + (size_t)rank * region;
        for (int i = tid; i < region / 8; i += THREADS) {
            const uint32_t dst =
                (uint32_t)__cvta_generic_to_shared(tab + 8 * i);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(dst), "l"(src + 8 * i));
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        uint4* z = reinterpret_cast<uint4*>(smem);
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (int i = tid; i < OFF_TAB / 16; i += THREADS) z[i] = zero;
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();
    Tables tb;
    tb.nc = tab[H_NC];
    tb.v0 = tab[H_V0];
    tb.nv = tab[H_NV];
    tb.n_rows = tab[H_NER];
    tb.bc_ptr = tab + tab[H_BC_PTR];
    tb.bc_mask = tab + tab[H_BC_MASK];
    tb.bc_code = reinterpret_cast<const uint32_t*>(tab + tab[H_BC_CODE]);
    tb.ev_ptr = tab + tab[H_EV_PTR];
    tb.ev_code = reinterpret_cast<const uint32_t*>(tab + tab[H_EV_CODE]);
    tb.ev_dest = tab + tab[H_EV_DEST];
    tb.own_hold = tab + tab[H_OWN_HOLD];
    // the valid slots of this thread's check
    uint32_t valid = 0;
    if ((tid >> 3) < tb.nc) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
            const int e = s * CA + (tid >> 3);
            valid |= (uint32_t)(tb.bc_mask[e >> 4] >> (e & 15) & 1u) << s;
        }
    }
    cluster.sync();                    // every copy zeroed before any push

    const int n_tiles = (batch + NCW - 1) / NCW;
    const bool ran = max_iter > 0;
    for (int tile = blockIdx.x / CL; tile < n_tiles;
         tile += gridDim.x / CL) {
        const int b0 = tile * NCW;
        // codewords past the batch (a ragged last tile) start converged
        uint32_t conv = 0;
#pragma unroll
        for (int n = 0; n < NCW; ++n) conv |= (uint32_t)(b0 + n >= batch) << n;
        for (int idx = tid; idx < tb.nv * NCW; idx += THREADS) {
            const int n = idx / tb.nv, i = idx - n * tb.nv;
            llr_o[i * NCW + n] = b0 + n < batch
                ? llr[(size_t)(b0 + n) * N_VARS + tb.v0 + i] : 0.0f;
        }
        if (tid < NCW) flag[F_ITERS + tid] = max_iter;
        __syncthreads();
        var_phase(cluster, tb, true, conv, llr_o, qi_o, G, qF, &flag[F_DATA],
                  tid, lane);
        cluster.sync();

        for (int it = 0; it < max_iter; ++it) {
            PHASE(0);
            split_rows<LP>(qF, qP, tid);
            __syncthreads();
            edge_phase(tb, it == 0 ? EDGE_FIRST : EDGE_LATER, ran, qP, rF, M,
                       warp, g, q);
            __syncthreads();
            PHASE(1);
            check_phase(tb, true, valid, M, rF, &flag[F_BAD], tid, lane);
            __syncthreads();
            PHASE(2);
            split_rows<EP>(rF, rP, tid);   // over M, read no more
            __syncthreads();
            if (tid == 0) {
                post(cluster, flag, it & 1, rank, flag[F_BAD]);
                flag[F_BAD] = 0;
            }
            edge_to_var(cluster, tb, rP, G, warp, g, q);
            PHASE(3);
            cluster.sync();            // sums complete, parity votes posted
            PHASE(4);
            var_phase(cluster, tb, false, conv, llr_o, qi_o, G, qF,
                      &flag[F_DATA], tid, lane);
            __syncthreads();
            PHASE(5);
            if (tid == 0) {
                post(cluster, flag, 2 + (it & 1), rank, flag[F_DATA]);
                flag[F_DATA] = 0;
            }
            cluster.sync();            // qi copies complete, data votes posted
            PHASE(6);
            const uint32_t bad = (uint32_t)gather(flag, it & 1);
            const uint32_t one = (uint32_t)gather(flag, 2 + (it & 1));
            const uint32_t live = ~conv & 0xFFu;
            if (tid == 0) {
#pragma unroll
                for (int n = 0; n < NCW; ++n)
                    if (live >> n & 1u) flag[F_ITERS + n] = it + 1;
            }
            conv |= live & (~one | ~bad);
            if (conv == 0xFFu) break;  // uniform across the cluster
        }

        // epilogue: parity of the output bits, bits, iterations
        split_rows<LP>(qF, qP, tid);
        __syncthreads();
        edge_phase(tb, EDGE_FINAL, ran, qP, rF, M, warp, g, q);
        __syncthreads();
        check_phase(tb, false, valid, M, rF, &flag[F_BAD], tid, lane);
        __syncthreads();
        if (tid == 0) {
            post(cluster, flag, 4, rank, flag[F_BAD]);
            flag[F_BAD] = 0;
        }
        cluster.sync();
        const uint32_t fin = (uint32_t)gather(flag, 4);
        for (int idx = tid; idx < tb.nv * NCW; idx += THREADS) {
            const int n = idx / tb.nv, i = idx - n * tb.nv;
            if (b0 + n < batch)
                bits_out[(size_t)(b0 + n) * N_VARS + tb.v0 + i] =
                    (uint8_t)(ran && qi_o[i * NCW + n] < 0.0f);
        }
        if (rank == 0 && tid < NCW && b0 + tid < batch) {
            iters_out[b0 + tid] = flag[F_ITERS + tid];
            parity_out[b0 + tid] = (uint8_t)!(fin >> tid & 1u);
        }
        __syncthreads();
    }
}

// Dynamic shared memory above 48 KB, set once per device.
static cudaError_t prepare(int region) {
    static int done[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 64 && done[dev] == region) return cudaSuccess;
    err = cudaFuncSetAttribute(bp_onehot_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(region));
    if (err == cudaSuccess && dev < 64) done[dev] = region;
    return err;
}

static cudaLaunchConfig_t config(int grid, int region, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem_bytes(region);
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// Launch on `stream` with `grid` blocks (a multiple of 8; one cluster per
// tile of 8 codewords, or fewer clusters each walking every
// (grid / 8)-th tile).  `tab` is the (8, region) uint16 table of
// ops/ldpc_onehot.py::pack_tables.  Returns the launch's cudaError_t
// (0 on success): a refused cluster launch (shared memory, cluster size)
// returns its code.
extern "C" int bp_onehot_launch(const float* llr, const uint16_t* tab,
                                int region, uint8_t* bits, int32_t* iters,
                                uint8_t* parity_ok, int batch, int max_iter,
                                int grid, void* stream) {
    if (batch <= 0) return 0;
    if (grid <= 0 || grid % CL || region <= 0 || region % 8)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = prepare(region);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(grid, region, (cudaStream_t)stream, attr);
    err = cudaLaunchKernelEx(&cfg, bp_onehot_kernel, llr, tab, region, bits,
                             iters, parity_ok, batch, max_iter);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Clusters of 8 blocks the device can hold at once.
extern "C" int bp_onehot_max_clusters(int region, int* clusters) {
    cudaError_t err = prepare(region);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(CL, region, 0, attr);
    return (int)cudaOccupancyMaxActiveClusters(clusters, bp_onehot_kernel,
                                               &cfg);
}

extern "C" int bp_onehot_smem_bytes(int region) {
    return (int)smem_bytes(region);
}
