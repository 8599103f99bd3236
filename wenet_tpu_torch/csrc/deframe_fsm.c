/* Host runtime in C: the UW acquisition state machine and sample-format
 * conversion (counterpart of wenet_tpu/native/deframe_fsm.c).
 *
 * The acquisition gating is sequential (LOOK_FOR_UW / COLLECT_PACKET with
 * the bit buffer frozen during collection; reference semantics:
 * src/wenet_ldpc.c:171-259, src/drs232_ldpc.c:176-275), so it runs as one
 * C pass over the hard decisions on the host, while the candidate windows
 * it finds decode as one batch on the card.  Bit-exact against the numpy
 * emulation `wenet_tpu_torch.ops.deframe.uw_detect_positions(...,
 * force_numpy=True)`.  Built with the host C compiler at first use and
 * bound with ctypes (`wenet_tpu_torch.native`).
 */
#include <stdint.h>

/* Set bits of x (a libgcc call, not inline, for __builtin_popcountll on
 * an x86-64 build without -mpopcnt). */
static inline int ones64(uint64_t x)
{
    x = x - ((x >> 1) & 0x5555555555555555ULL);
    x = (x & 0x3333333333333333ULL) + ((x >> 2) & 0x3333333333333333ULL);
    x = (x + (x >> 4)) & 0x0f0f0f0f0f0f0f0fULL;
    return (int)((x * 0x0101010101010101ULL) >> 56);
}

/* Sliding UW detector over hard decisions `bits` (one byte a bit, 0 or 1).
 * init_buf: nuw bytes of prior bit_buffer state (zeros at stream start).
 * Returns the number of detections (UW-end indices) written to out_pos
 * (at most max_out of them); final_buf receives the bit_buffer content
 * after the last detection, or at the stream's end if there was none.
 * A detection whose packet window [t+1, t+syms] does not fit ends the
 * search (the reference deframer simply runs out of input).
 *
 * The bit buffer is one 64-bit register, its oldest bit the highest of
 * the nuw it holds, so a shift takes in a bit and the score is nuw less
 * the mismatches, a popcount of the register against the UW's bits. */
long uw_detect(const uint8_t *bits, long n, const uint8_t *uw, int nuw,
               int allowed, long syms, const int8_t *init_buf,
               int64_t *out_pos, long max_out, int8_t *final_buf)
{
    const uint64_t mask = nuw == 64 ? ~(uint64_t)0
                                    : (((uint64_t)1 << nuw) - 1);
    uint64_t reg = 0, want = 0, last = 0;
    long ndet = 0;
    long t = 0;
    int i;

    for (i = 0; i < nuw; i++) {
        reg = (reg << 1) | (init_buf[i] != 0);
        want = (want << 1) | (uw[i] != 0);
    }

    while (t < n) {
        reg = ((reg << 1) | (bits[t] != 0)) & mask;   /* shift in a bit */
        if (ones64(reg ^ want) <= allowed) {
            if (t + syms >= n)
                break;              /* packet cannot complete: stream ends */
            if (ndet < max_out)
                out_pos[ndet] = t;
            ndet++;
            last = reg;
            t += syms;    /* skip the collected symbols; the buffer stays
                             frozen as it was at the detection */
        }
        t++;
    }
    if (ndet)
        reg = last;
    for (i = 0; i < nuw; i++)
        final_buf[i] = (int8_t)((reg >> (nuw - 1 - i)) & 1);
    return ndet;
}

/* cu8 interleaved IQ -> complex64, (x - 127) / 128 (fsk_demod.c:281-287) */
void cu8_to_c64(const uint8_t *raw, long n_samples, float *out)
{
    long i;
    for (i = 0; i < n_samples; i++) {
        out[2 * i] = ((float)raw[2 * i] - 127.0f) / 128.0f;
        out[2 * i + 1] = ((float)raw[2 * i + 1] - 127.0f) / 128.0f;
    }
}

/* cs16 interleaved IQ -> complex64, / FDMDV_SCALE (fsk_demod.c:289-296) */
void cs16_to_c64(const int16_t *raw, long n_samples, float *out)
{
    const float scale = 1.0f / 825.0f;   /* FDMDV_SCALE */
    long i;
    for (i = 0; i < n_samples; i++) {
        out[2 * i] = (float)raw[2 * i] * scale;
        out[2 * i + 1] = (float)raw[2 * i + 1] * scale;
    }
}
