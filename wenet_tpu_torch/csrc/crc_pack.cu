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
// once and a row of at most 263 bytes is written once.  The CRC itself is
// a chain of 256 dependent table lookups per codeword (CRC16/CCITT-FALSE,
// init 0xFFFF, poly 0x1021) on one lane, so a launch is latency-bound,
// whatever the batch, in one launch against the plain version's 256+
// (times beside the bound: PERF.md, chip_smoke.py's crc_vs_plain).
//
// Design.  One warp per codeword, four codewords a block.  The lanes pack
// the bits MSB-first into 258 byte values (kept as exact integer sums, as
// the plain version computes them) in shared memory; lane 0 runs the CRC
// chain with the 256-entry table in shared memory, compares it with the
// little-endian trailer, and the warp writes the row: the 258 bytes, the
// CRC flag, then the tail the caller asks for (TAIL_ITERS: the iteration
// count clamped to [0, 255]; TAIL_POS: the position as 4 little-endian
// bytes), and, if asked, the flag alone into a bool array (rows may then
// be null).

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 4
#define PKT_BYTES 258
#define CRC_BYTES 256
#define TAIL_ITERS 1
#define TAIL_POS 2

__global__ void __launch_bounds__(WARPS * 32)
crc_pack_kernel(const uint8_t* __restrict__ bits, int B, long long stride,
                const int32_t* __restrict__ table_g, uint8_t* rows,
                int row_bytes, int tail, const int32_t* __restrict__ extra,
                uint8_t* ok_out) {
    __shared__ uint16_t table[256];
    __shared__ int32_t vals[WARPS][PKT_BYTES];
    for (int i = threadIdx.x; i < 256; i += blockDim.x)
        table[i] = (uint16_t)table_g[i];
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + warp;
    if (b >= B) return;
    const uint8_t* src = bits + (long long)b * stride;
    int32_t* v = vals[warp];
    #pragma unroll 1
    for (int j = lane; j < PKT_BYTES; j += 32) {
        const uint8_t* p = src + 8 * j;
        int32_t acc = 0;
        #pragma unroll
        for (int t = 0; t < 8; ++t) acc += (int32_t)p[t] << (7 - t);
        v[j] = acc;
    }
    __syncwarp();
    int ok = 0;
    if (lane == 0) {
        uint32_t crc = 0xFFFFu;
        #pragma unroll 8
        for (int i = 0; i < CRC_BYTES; ++i)
            crc = ((crc << 8) & 0xFFFFu) ^
                  table[((crc >> 8) ^ (uint32_t)v[i]) & 0xFFu];
        const int32_t tx = v[CRC_BYTES] | (v[CRC_BYTES + 1] << 8);
        ok = (int32_t)crc == tx;
    }
    ok = __shfl_sync(0xFFFFFFFFu, ok, 0);
    if (ok_out != nullptr && lane == 0) ok_out[b] = (uint8_t)ok;
    if (rows == nullptr) return;
    uint8_t* row = rows + (long long)b * row_bytes;
    for (int j = lane; j < PKT_BYTES; j += 32) row[j] = (uint8_t)v[j];
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
                               const int32_t* table, uint8_t* rows,
                               int row_bytes, int tail, const int32_t* extra,
                               uint8_t* ok_out, void* stream) {
    if (B < 0 || stride < 8 * PKT_BYTES ||
        (rows != nullptr && (tail < TAIL_ITERS || tail > TAIL_POS ||
                             extra == nullptr)) ||
        (rows == nullptr && ok_out == nullptr))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const int grid = (B + WARPS - 1) / WARPS;
    crc_pack_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        bits, B, stride, table, rows, row_bytes, tail, extra, ok_out);
    return (int)cudaGetLastError();
}
