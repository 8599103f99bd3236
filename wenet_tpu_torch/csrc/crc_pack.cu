// CRC16 gate and byte packing of decoded codewords, hand-written for Hopper
// (sm_90a).
//
// Replaces the XLA code of wenet_tpu/ops/crc.py (`bits_to_bytes`, the
// `crc16` lax.scan, `packet_crc_ok`) together with the byte packing that
// follows it in wenet_tpu/ops/deframe.py (`decode_windows`' packed rows and
// `pack_decode_results`).  Its plain PyTorch version is
// wenet_tpu_torch/ops/crc.py::crc_pack_reference (and
// packet_crc_ok_reference), a 256-step loop of small launches.
//
// What bounds it on this card: bytes.  A codeword's 2064 bits are read
// once and a row of at most 263 bytes is written once.  A CRC taken byte
// after byte is a chain of 256 dependent table lookups, so the launch
// would be latency-bound whatever the batch; this kernel cuts the chain to
// about 20 steps (times beside the bound: PERF.md, chip_smoke.py's
// crc_vs_plain).
//
// Design.  One warp per codeword, eight codewords a block.
//   1. Lane L reads the 64 bits of payload bytes 8L .. 8L + 7 (sixteen
//      32-bit loads in flight where the rows are 4-byte aligned, else byte
//      loads) and forms each byte as the exact integer sum
//      sum_t bit[t] << (7 - t), as the plain version does; lanes 0 and 1
//      form the two trailer bytes.
//   2. Each lane takes the CRC of its 8 bytes from register state 0: 8
//      lookups in the 256-entry table.
//   3. CRC16/CCITT-FALSE is linear over GF(2), so the CRC of A || B from
//      state 0 is adv_|B|(crc(A)) ^ crc(B), where adv_m advances a state
//      over m zero bytes.  Five shuffle levels join neighbours (lengths
//      8, 16, 32, 64, 128 bytes on the right), each adv_m as two
//      256-entry tables of the state's high and low byte.  The init
//      0xFFFF adds the constant adv_256(0xFFFF) at the end.
//   4. The CRC is compared with the little-endian trailer, and the warp
//      writes the row: the 258 bytes, the CRC flag, then the tail the
//      caller asks for (TAIL_ITERS: the iteration count clamped to
//      [0, 255]; TAIL_POS: the position as 4 little-endian bytes), and,
//      if asked, the flag alone into a bool array (rows may then be null).
// The tables (the byte table, then each level's high- and low-byte
// advance tables; built on the host by kernels/crc_pack.py::crc_tables)
// sit in shared memory, their load issued after the bit loads.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8
#define PKT_BYTES 258
#define CRC_BYTES 256
#define TAIL_ITERS 1
#define TAIL_POS 2
#define LEVELS 5
#define TABLE_ENTRIES (256 + LEVELS * 512)       // uint16
#define FULL 0xFFFFFFFFu

// sum_t p[t] << (7 - t) over the 8 bytes of lo (t = 0..3) and hi (4..7)
__device__ __forceinline__ int32_t byte_sum(uint32_t lo, uint32_t hi) {
    return (int32_t)(((lo & 0xFFu) << 7) + (((lo >> 8) & 0xFFu) << 6) +
                     (((lo >> 16) & 0xFFu) << 5) + ((lo >> 24) << 4) +
                     ((hi & 0xFFu) << 3) + (((hi >> 8) & 0xFFu) << 2) +
                     (((hi >> 16) & 0xFFu) << 1) + (hi >> 24));
}

template <bool ALIGNED>
__device__ __forceinline__ int32_t load_byte(const uint8_t* p) {
    if (ALIGNED) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
        return byte_sum(__ldg(w), __ldg(w + 1));
    }
    int32_t acc = 0;
    #pragma unroll
    for (int t = 0; t < 8; ++t) acc += (int32_t)__ldg(p + t) << (7 - t);
    return acc;
}

template <bool ALIGNED>
__global__ void __launch_bounds__(WARPS * 32)
crc_pack_kernel(const uint8_t* __restrict__ bits, int B, long long stride,
                const uint16_t* __restrict__ tables_g, uint32_t init_term,
                uint8_t* rows, int row_bytes, int tail,
                const int32_t* __restrict__ extra, uint8_t* ok_out) {
    __shared__ __align__(16) uint16_t tab[TABLE_ENTRIES];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + warp;

    // 1. the lane's 8 payload bytes (and a trailer byte on lanes 0, 1)
    int32_t v[8];
    int32_t tr = 0;
    if (b < B) {
        const uint8_t* src = bits + (long long)b * stride;
        #pragma unroll
        for (int m = 0; m < 8; ++m)
            v[m] = load_byte<ALIGNED>(src + 64 * lane + 8 * m);
        if (lane < 2) tr = load_byte<ALIGNED>(src + 8 * (CRC_BYTES + lane));
    }
    const uint4* tg = reinterpret_cast<const uint4*>(tables_g);
    uint4* ts = reinterpret_cast<uint4*>(tab);
    for (int i = threadIdx.x; i < TABLE_ENTRIES / 8; i += WARPS * 32)
        ts[i] = tg[i];
    __syncthreads();
    if (b >= B) return;

    // 2. the CRC of the lane's bytes from state 0
    uint32_t crc = 0;
    #pragma unroll
    for (int m = 0; m < 8; ++m)
        crc = ((crc << 8) & 0xFFFFu) ^
              tab[((crc >> 8) ^ (uint32_t)v[m]) & 0xFFu];

    // 3. join neighbours: left advanced over the right's zero bytes
    #pragma unroll
    for (int l = 0; l < LEVELS; ++l) {
        const uint32_t other = __shfl_xor_sync(FULL, crc, 1 << l);
        const bool right = (lane >> l) & 1;
        const uint32_t left = right ? other : crc;
        const uint16_t* adv = tab + 256 + l * 512;
        crc = (uint32_t)(adv[left >> 8] ^ adv[256 + (left & 0xFFu)]) ^
              (right ? crc : other);
    }
    crc ^= init_term;

    // 4. the trailer compare and the row
    const int32_t tx =
        __shfl_sync(FULL, tr, 0) | (__shfl_sync(FULL, tr, 1) << 8);
    const int ok = (int32_t)crc == tx;
    if (ok_out != nullptr && lane == 0) ok_out[b] = (uint8_t)ok;
    if (rows == nullptr) return;
    uint8_t* row = rows + (long long)b * row_bytes;
    #pragma unroll
    for (int m = 0; m < 8; ++m) row[8 * lane + m] = (uint8_t)v[m];
    if (lane < 2) row[CRC_BYTES + lane] = (uint8_t)tr;
    if (lane == 0) row[PKT_BYTES] = (uint8_t)ok;
    if (tail == TAIL_ITERS && lane == 0) {
        const int32_t it = extra[b];
        row[PKT_BYTES + 1] = (uint8_t)(it < 0 ? 0 : (it > 255 ? 255 : it));
    } else if (tail == TAIL_POS && lane < 4) {
        row[PKT_BYTES + 1 + lane] =
            (uint8_t)(((uint32_t)extra[b] >> (8 * lane)) & 0xFFu);
    }
}

extern "C" int crc_pack_launch(const uint8_t* bits, int B, long long stride,
                               const uint16_t* tables, uint32_t init_term,
                               uint8_t* rows, int row_bytes, int tail,
                               const int32_t* extra, uint8_t* ok_out,
                               void* stream) {
    if (B < 0 || stride < 8 * PKT_BYTES || tables == nullptr ||
        ((uintptr_t)tables & 15) != 0 ||
        (rows != nullptr && (tail < TAIL_ITERS || tail > TAIL_POS ||
                             extra == nullptr)) ||
        (rows == nullptr && ok_out == nullptr))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const int grid = (B + WARPS - 1) / WARPS;
    const bool aligned = (((uintptr_t)bits | (uintptr_t)stride) & 3) == 0;
    if (aligned)
        crc_pack_kernel<true><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            bits, B, stride, tables, init_term, rows, row_bytes, tail, extra,
            ok_out);
    else
        crc_pack_kernel<false><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            bits, B, stride, tables, init_term, rows, row_bytes, tail, extra,
            ok_out);
    return (int)cudaGetLastError();
}
