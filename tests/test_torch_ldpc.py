"""PyTorch port of the LDPC decoder (wenet_tpu_torch.ops.ldpc) against the
XLA decoder (wenet_tpu.ops.ldpc.decode) and the gather-native Pallas kernel
(ldpc_pallas2.decode_pallas2, interpret mode) on identical LLRs, and of the
normalized min-sum decoder against wenet_tpu.ops.ldpc.decode_minsum.

The plain PyTorch decodes are bit-exact: bits, iteration counts and parity
flags are equal for every codeword, across the decode threshold
(2.5 dB: almost none converge; 3 dB: about half; 6 and 12 dB: all), and at
every iteration cap.  The device encoder is integer-exact.
sd_to_llr differs only in reduction order: rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wenet_tpu.ops import ldpc as jldpc
from wenet_tpu.ops import ldpc_pallas2
from wenet_tpu_torch.kernels import bp_decode
from wenet_tpu_torch.ops import ldpc

torch.set_num_threads(1)


def _soft(B, snr_db, seed):
    """Random codewords as soft symbols at Es/N0 = snr_db (rate 0.8)."""
    rng = np.random.default_rng(seed)
    ib = np.unpackbits(rng.integers(0, 256, (B, 258), dtype=np.uint8), axis=1)
    cw = np.concatenate([ib, jldpc.encode_bits_np(ib)], axis=1)
    esn0 = 10 ** (snr_db / 10) * 0.8
    sd = (1 - 2.0 * cw) + rng.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    return sd.astype(np.float32), cw


def _llrs(B, snr_db, seed):
    sd, cw = _soft(B, snr_db, seed)
    return np.array(jldpc.sd_to_llr(jnp.asarray(sd))), cw


@pytest.mark.parametrize("snr_db", [2.5, 3.0, 6.0, 12.0])
def test_decode_reference_matches_xla_and_pallas(snr_db):
    llr, _ = _llrs(12, snr_db, int(snr_db * 10))
    bt, it, okt = (a.numpy() for a in
                   ldpc.decode_reference(torch.from_numpy(llr)))
    bx, ix, okx = jldpc.decode_np(llr)
    np.testing.assert_array_equal(bt, bx)
    np.testing.assert_array_equal(it, ix)
    np.testing.assert_array_equal(okt, okx)
    bp, ip, okp = ldpc_pallas2.decode_pallas2(
        jnp.asarray(llr), batch_tile=16, interpret=True)
    np.testing.assert_array_equal(bt, np.asarray(bp))
    np.testing.assert_array_equal(it, np.asarray(ip))
    np.testing.assert_array_equal(okt, np.asarray(okp))


def test_decode_odd_batch():
    """A batch that is not a power of two decodes each row on its own."""
    llr, cw = _llrs(7, 10.0, 99)
    bits, iters, ok = ldpc.decode_reference(torch.from_numpy(llr))
    np.testing.assert_array_equal(bits.numpy(), cw)
    assert ok.all() and bits.shape == (7, 2580) and iters.dtype == torch.int32
    b1, i1, _ = ldpc.decode_reference(torch.from_numpy(llr[3:4]))
    assert torch.equal(b1[0], bits[3]) and int(i1[0]) == int(iters[3])


def test_sd_to_llr_matches():
    sd, _ = _soft(8, 4.0, 5)
    want = np.asarray(jldpc.sd_to_llr(jnp.asarray(sd)))
    got = ldpc.sd_to_llr(torch.from_numpy(sd)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_encode_matches():
    rng = np.random.default_rng(3)
    ib = np.unpackbits(rng.integers(0, 256, (4, 258), dtype=np.uint8), axis=1)
    np.testing.assert_array_equal(ldpc.encode_bits_np(ib),
                                  jldpc.encode_bits_np(ib))
    payload = rng.integers(0, 256, 258, dtype=np.uint8).tobytes()
    assert ldpc.encode_bytes(payload) == jldpc.encode_bytes(payload)
    with pytest.raises(ValueError):
        ldpc.encode_bytes(payload[:10])


def test_decode_on_cpu_uses_reference():
    """A CPU tensor goes through the plain version and never the kernel."""
    llr, _ = _llrs(4, 6.0, 11)
    before = bp_decode.launches
    got = ldpc.decode(torch.from_numpy(llr))
    want = ldpc.decode_reference(torch.from_numpy(llr))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bp_decode.launches == before


def test_kernel_wrapper_rejects_cpu_tensor():
    with pytest.raises(ValueError):
        bp_decode.decode(torch.zeros(2, 2580))
    with pytest.raises(ValueError):
        bp_decode.decode_minsum(torch.zeros(2, 2580))


def test_encode_bits_matches_jax():
    rng = np.random.default_rng(8)
    ib = rng.integers(0, 2, (5, 2064)).astype(np.uint8)
    want = np.asarray(jldpc.encode_bits(jnp.asarray(ib)))
    got = ldpc.encode_bits(torch.from_numpy(ib))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ldpc.encode_bits_np(ib))
    # a leading batch shape and an int64 input give the same parity
    got3 = ldpc.encode_bits(torch.from_numpy(ib.astype(np.int64))[None])
    np.testing.assert_array_equal(got3[0].numpy(), want)


@pytest.mark.parametrize("max_iter", [0, 1, 3, 10])
@pytest.mark.parametrize("snr_db", [2.5, 3.0, 6.0, 12.0])
def test_decode_minsum_reference_matches_jax(snr_db, max_iter):
    llr, _ = _llrs(12, snr_db, int(snr_db * 10) + 1)
    bt, it, okt = (a.numpy() for a in ldpc.decode_minsum_reference(
        torch.from_numpy(llr), max_iter=max_iter))
    bx, ix, okx = (np.asarray(a) for a in jldpc.decode_minsum(
        jnp.asarray(llr), max_iter=max_iter))
    np.testing.assert_array_equal(bt, bx)
    np.testing.assert_array_equal(it, ix)
    np.testing.assert_array_equal(okt, okx)


def test_decode_minsum_on_cpu_uses_reference():
    llr, cw = _llrs(4, 8.0, 12)
    before = bp_decode.minsum_launches
    got = ldpc.decode_minsum(torch.from_numpy(llr))
    want = ldpc.decode_minsum_reference(torch.from_numpy(llr))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[0].numpy(), cw)
    assert bp_decode.minsum_launches == before
    with pytest.raises(ValueError):
        ldpc.decode_minsum(torch.zeros(1, 2580, device="meta"))

