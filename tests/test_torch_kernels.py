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
from wenet_tpu_torch.kernels import bp_decode
from wenet_tpu_torch.ops import ldpc

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
    assert os.path.isfile(os.path.join(kernels.CSRC, "bp_decode.cu"))
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
