"""The hand-written CUDA kernels of wenet_tpu_torch against their plain
PyTorch versions.  This file imports no JAX, so on a machine with the card
it runs without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked `cuda` skip where there is no CUDA device or no nvcc.
"""
import os

import numpy as np
import pytest
import torch

from wenet_tpu_torch import kernels
from wenet_tpu_torch.kernels import bp_decode, bp_onehot
from wenet_tpu_torch.ops import ldpc, ldpc_onehot

torch.set_num_threads(1)


def _llr(B, snr_db, seed, device):
    rng = np.random.default_rng(seed)
    ib = np.unpackbits(rng.integers(0, 256, (B, 258), dtype=np.uint8), axis=1)
    cw = np.concatenate([ib, ldpc.encode_bits_np(ib)], axis=1)
    esn0 = 10 ** (snr_db / 10) * 0.8
    sd = (1 - 2.0 * cw) + rng.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    return ldpc.sd_to_llr(torch.as_tensor(sd, dtype=torch.float32,
                                          device=device)), cw


def _card():
    if not kernels.available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def test_build_flags_target_hopper_without_fast_math():
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "use_fast_math" not in flags and "-fmad=false" in flags
    for name in ("bp_decode", "bp_onehot"):
        assert os.path.isfile(os.path.join(kernels.CSRC, f"{name}.cu"))
    assert kernels.BUILD_DIR.endswith(os.path.join("build", "wenet_tpu_torch"))


def test_wrapper_takes_only_cuda_tensors():
    """On the CPU the wrapper raises and launches nothing; ops.ldpc.decode
    takes the plain version for CPU tensors."""
    llr, cw = _llr(3, 8.0, 1, "cpu")
    before = bp_decode.launches
    with pytest.raises(ValueError):
        bp_decode.decode(llr)
    bits, iters, ok = ldpc.decode(llr)
    assert bp_decode.launches == before
    np.testing.assert_array_equal(bits.numpy(), cw)
    assert ok.all()


@pytest.mark.parametrize("name", ["minsum", "onehot"])
def test_variant_wrappers_take_only_cuda_tensors(name):
    """The min-sum and one-hot wrappers raise on a CPU tensor and launch
    nothing; their ops take the plain versions for CPU tensors."""
    llr, cw = _llr(3, 8.0, 2, "cpu")
    counts = (bp_decode.minsum_launches, bp_onehot.launches)
    with pytest.raises(ValueError):
        if name == "minsum":
            bp_decode.decode_minsum(llr)
        else:
            bp_onehot.decode(llr, ldpc_onehot.kernel_tables(llr.device))
    op = ldpc.decode_minsum if name == "minsum" else ldpc_onehot.decode_onehot
    bits, _, ok = op(llr)
    assert (bp_decode.minsum_launches, bp_onehot.launches) == counts
    np.testing.assert_array_equal(bits.numpy(), cw)
    assert ok.all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,snr_db", [(1, 6.0), (7, 3.0), (128, 2.5),
                                      (128, 3.0), (128, 6.0), (64, 12.0)])
def test_bp_kernel_matches_plain(B, snr_db):
    """Bits, iterations and parity flags equal for every codeword,
    converged or not (the kernel keeps the reference's sum orders and is
    built without fused multiply-adds)."""
    dev = _card()
    llr, _ = _llr(B, snr_db, int(10 * snr_db) + B, dev)
    before = bp_decode.launches
    bk, ik, ok_k = ldpc.decode(llr)
    br, ir, ok_r = ldpc.decode_reference(llr)
    torch.cuda.synchronize()
    assert bp_decode.launches == before + 1
    assert torch.equal(ok_k, ok_r)
    assert torch.equal(bk, br) and torch.equal(ik, ir)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_bp_kernel_iteration_cap(max_iter):
    dev = _card()
    llr, _ = _llr(16, 3.0, 5, dev)
    got = ldpc.decode(llr, max_iter=max_iter)
    want = ldpc.decode_reference(llr, max_iter=max_iter)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bp_wrapper_rejects_bad_inputs():
    dev = _card()
    llr, _ = _llr(4, 6.0, 9, dev)
    with pytest.raises(TypeError):
        bp_decode.decode(llr.double())
    with pytest.raises(ValueError):
        bp_decode.decode(llr[:, :2000])
    with pytest.raises(ValueError):
        bp_decode.decode(torch.cat([llr, llr], dim=1)[:, ::2])


# the kernel variants against their plain versions: (op, plain, counter)
VARIANTS = {
    "minsum": (ldpc.decode_minsum, ldpc.decode_minsum_reference,
               lambda: bp_decode.minsum_launches),
    "onehot": (ldpc_onehot.decode_onehot, ldpc_onehot.decode_onehot_reference,
               lambda: bp_onehot.launches),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("B,snr_db", [(1, 6.0), (7, 3.0), (128, 2.5),
                                      (128, 3.0), (128, 6.0), (33, 12.0)])
def test_variant_kernels_match_plain(name, B, snr_db):
    """Min-sum and one-hot kernels: bits, iterations and parity flags equal
    their plain versions for every codeword (B=7 and 33 leave a ragged
    one-hot batch tile); the one-hot kernel also equals the sum-product
    plain decoder."""
    dev = _card()
    op, plain, count = VARIANTS[name]
    llr, _ = _llr(B, snr_db, int(10 * snr_db) + B + 1, dev)
    before = count()
    got = op(llr)
    want = plain(llr)
    torch.cuda.synchronize()
    assert count() == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if name == "onehot":
        for a, b in zip(got, ldpc.decode_reference(llr)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_variant_kernels_iteration_cap(name, max_iter):
    dev = _card()
    op, plain, _ = VARIANTS[name]
    llr, _ = _llr(16, 3.0, 6, dev)
    for a, b in zip(op(llr, max_iter=max_iter), plain(llr, max_iter=max_iter)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_variant_wrappers_reject_bad_inputs():
    dev = _card()
    llr, _ = _llr(4, 6.0, 9, dev)
    tables = ldpc_onehot.kernel_tables(llr.device)
    for call in (bp_decode.decode_minsum,
                 lambda x: bp_onehot.decode(x, tables)):
        with pytest.raises(TypeError):
            call(llr.double())
        with pytest.raises(ValueError):
            call(llr[:, :2000])
        with pytest.raises(ValueError):
            call(torch.cat([llr, llr], dim=1)[:, ::2])
    with pytest.raises(ValueError):
        ldpc_onehot.decode_onehot(llr, batch_tile=32)
