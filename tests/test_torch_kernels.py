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
from wenet_tpu_torch.core import ldpc_tables as T
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


def _emulate(llr, max_iter, minsum=False, scale=0.8):
    """The BP kernel's schedule in plain torch on the packed tables: one
    check phase (q = qi - rmsg, the sum or the two minima, new rmsg) and one
    var phase (qi) per iteration, first-iteration signs llr < 0, a
    converged codeword frozen."""
    ctab, vtab = (torch.from_numpy(a.astype(np.int64))
                  for a in bp_decode.packed_tables())
    cvalid, cvar = (ctab & bp_decode.VALID) != 0, ctab & bp_decode.VAR_MASK
    vvalid, vedge = (vtab & bp_decode.VALID) != 0, vtab & bp_decode.EDGE_MASK
    B = llr.shape[0]
    big = ldpc.MINSUM_BIG if minsum else 0.0
    slot = torch.arange(14)[:, None]
    qi, rmsg = llr.clone(), torch.zeros(B, 14, 516)
    iters = torch.full((B,), max_iter, dtype=torch.int32)
    done = torch.zeros(B, dtype=torch.bool)
    for it in range(max_iter):
        q = qi[:, cvar] - rmsg                                # (B, 14, 516)
        neg = ((q < 0) if minsum or it == 0 else (q <= 0)) & cvalid
        mag = torch.where(cvalid, q.abs() if minsum else ldpc.phi0(q.abs()),
                          big)
        par = neg.int().sum(1) & 1                            # (B, 516)
        if minsum:
            m1 = mag.min(1, keepdim=True).values
            pos = torch.where(mag <= m1, slot, 14).min(1, keepdim=True).values
            m2 = torch.where(slot == pos, big, mag).min(1, keepdim=True).values
            rmag = torch.where(slot == pos, m2, m1) * scale
        else:
            acc = mag[:, 0]
            for s in range(1, 14):
                acc = acc + mag[:, s]
            rmag = ldpc.phi0(acc[:, None] - mag)
        flip = ((par[:, None] ^ neg.int()) & 1) == 1
        r = torch.where(cvalid, torch.where(flip, -rmag, rmag), 0.0)
        g = torch.where(vvalid, r.reshape(B, -1)[:, vedge], 0.0)  # (B, 3, 2580)
        q_new = llr + ((g[:, 0] + g[:, 1]) + g[:, 2])
        upd = ~done
        qi = torch.where(upd[:, None], q_new, qi)
        rmsg = torch.where(upd[:, None, None], r, rmsg)
        iters = torch.where(upd, it + 1, iters).int()
        done |= (par == 0).all(1) | ~(q_new[:, :2064] < 0).any(1)
        if bool(done.all()):
            break
    bits = ((qi < 0) & (max_iter > 0)).to(torch.uint8)
    ok = ((bits[:, cvar].int() * cvalid.int()).sum(1) % 2 == 0).all(1)
    return bits, iters, ok


def test_packed_tables_match_the_code():
    """Each packed check entry names the check's variable; each packed var
    entry names an edge whose check entry names that variable back."""
    ctab, vtab = bp_decode.packed_tables()
    var_idx, mask = T.check_edges()
    vslots, vmask = T.var_edges()
    assert ctab.shape == (14, 516) and ctab.dtype == np.uint16
    assert vtab.shape == (3, 2580) and vtab.dtype == np.uint16
    np.testing.assert_array_equal((ctab & bp_decode.VALID) != 0, mask.T)
    np.testing.assert_array_equal(np.where(mask.T, ctab & 0x0FFF, 0),
                                  np.where(mask.T, var_idx.T, 0))
    np.testing.assert_array_equal((vtab & bp_decode.VALID) != 0, vmask.T)
    e = (vtab & bp_decode.EDGE_MASK).astype(np.int64)
    s, c = np.divmod(e, 516)
    back = ctab[s, c] & bp_decode.VAR_MASK
    v = np.broadcast_to(np.arange(2580), e.shape)
    assert (back[vmask.T] == v[vmask.T]).all()
    np.testing.assert_array_equal((c * 14 + s)[vmask.T], vslots.T[vmask.T])
    assert int(vmask.sum()) == int(mask.sum()) == 7223


def test_packed_tables_fit_their_fields():
    ctab, vtab = bp_decode.packed_tables()
    assert int((ctab & bp_decode.VAR_MASK).max()) < 2580 <= bp_decode.VAR_MASK
    assert int((vtab & bp_decode.EDGE_MASK).max()) < 7224 <= bp_decode.EDGE_MASK
    assert not (ctab & ~np.uint16(bp_decode.VALID | bp_decode.VAR_MASK)).any()
    assert not (vtab & ~np.uint16(bp_decode.VALID | bp_decode.EDGE_MASK)).any()
    # a block of a cluster of K has 516 threads: 516/K checks of K lanes,
    # whose slots, ceil(14/K) a lane, cover the 14 in order; and 2580/K
    # variables
    for k in (1, 2, 4):
        assert (516 // k) * k == 516 and (2580 // k) * k == 2580
        sl = -(-14 // k)
        slots = [s for lane in range(k) for s in range(lane * sl, lane * sl + sl)
                 if s < 14]
        assert slots == list(range(14))


@pytest.mark.parametrize("minsum", [False, True], ids=["sum-product",
                                                       "min-sum"])
@pytest.mark.parametrize("B,sp,ms", [
    (0, (1, 0), (1, 0)), (1, (4, 4), (1, 1)), (7, (4, 28), (1, 7)),
    (16, (4, 64), (1, 16)), (17, (2, 34), (1, 17)), (40, (2, 80), (1, 40)),
    (66, (2, 132), (1, 66)), (67, (1, 67), (1, 67)), (70, (1, 70), (1, 70)),
    (133, (1, 133), (1, 133)), (264, (1, 264), (1, 264)),
    (2048, (1, 264), (1, 264))])
def test_launch_shape(minsum, B, sp, ms):
    """132 SMs, 2 resident blocks each: sum-product clusters of 4 while
    4B <= 66, of 2 while 2B <= 132; else, and for min-sum, one block per
    codeword up to 264 blocks, which draw from a queue past that."""
    want = ms if minsum else sp
    assert bp_decode.launch_shape(B, 132, 2, minsum) == want
    k, grid = want
    assert grid % k == 0
    if B:
        assert grid // k <= B and (k == 1 or grid <= 132)


@pytest.mark.parametrize("minsum", [False, True], ids=["sum-product",
                                                       "min-sum"])
@pytest.mark.parametrize("B,snr_db,max_iter", [
    (6, 2.5, 10), (6, 3.5, 10), (6, 6.0, 10), (5, 3.0, 0), (5, 3.0, 1),
    (5, 3.0, 3)])
def test_kernel_schedule_matches_plain(minsum, B, snr_db, max_iter):
    """On the CPU, the kernel's schedule (check-owned phase, first-iteration
    sign rule, freeze) gives the plain decoder's bits, iterations and parity
    flags exactly."""
    llr, _ = _llr(B, snr_db, int(10 * snr_db) + B + max_iter, "cpu")
    plain = ldpc.decode_minsum_reference if minsum else ldpc.decode_reference
    got = _emulate(llr, max_iter, minsum)
    want = plain(llr, max_iter=max_iter)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("name", ["sum-product", "min-sum"])
@pytest.mark.parametrize("B", [1, 7, 40, 70, 133, 2048])
@pytest.mark.parametrize("snr_db", [2.5, 4.0, 7.5])
@pytest.mark.parametrize("max_iter", [0, 1, 3, 10])
def test_bp_kernels_every_launch_shape(name, B, snr_db, max_iter):
    """Both BP variants equal their plain versions in bits, iterations and
    parity flags on every codeword, in every launch shape the wrapper picks
    (clusters of 4 and 2, one block per codeword, a persistent grid)."""
    dev = _card()
    minsum = name == "min-sum"
    sms, per_sm = bp_decode.card_shape(dev, minsum)
    assert per_sm >= 2
    cluster, grid = bp_decode.launch_shape(B, sms, per_sm, minsum)
    assert cluster == (1 if minsum else {1: 4, 7: 4, 40: 2}.get(B, 1))
    assert (grid < B) == (B == 2048)
    llr, _ = _llr(B, snr_db, B + int(10 * snr_db) + 100 * max_iter, dev)
    op = ldpc.decode_minsum if minsum else ldpc.decode
    plain = ldpc.decode_minsum_reference if minsum else ldpc.decode_reference
    got = op(llr, max_iter=max_iter)
    want = plain(llr, max_iter=max_iter)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
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
