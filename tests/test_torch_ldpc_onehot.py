"""The one-hot BP decoder of the port (wenet_tpu_torch.ops.ldpc_onehot)
against the Pallas one-hot kernel (wenet_tpu.ops.ldpc_pallas.decode_pallas,
interpret mode) and the sum-product decoders, and its host-built tables.

On the CPU `decode_onehot` runs the plain emulation of the CUDA kernel:
the same tile lists, the same bf16 pieces and float32 sums.  Every
comparison is exact: bits, iteration counts and parity flags, the split
into bf16 pieces, the tiled products and the tile lists.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wenet_tpu.ops import ldpc as jldpc
from wenet_tpu.ops import ldpc_pallas
from wenet_tpu_torch.kernels import bp_onehot
from wenet_tpu_torch.ops import ldpc
from wenet_tpu_torch.ops import ldpc_onehot as oh

torch.set_num_threads(1)


def _llrs(B, snr_db, seed):
    """Random codewords -> LLRs at Es/N0 = snr_db (rate 0.8)."""
    rng = np.random.default_rng(seed)
    ib = np.unpackbits(rng.integers(0, 256, (B, 258), dtype=np.uint8), axis=1)
    cw = np.concatenate([ib, jldpc.encode_bits_np(ib)], axis=1)
    esn0 = 10 ** (snr_db / 10) * 0.8
    sd = (1 - 2.0 * cw) + rng.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    return np.array(jldpc.sd_to_llr(jnp.asarray(sd, jnp.float32))), cw


def _assert_same(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_decode_onehot_matches_pallas_interpret():
    """One interpret run of the Pallas kernel (it is slow on the CPU)."""
    llr, cw = _llrs(6, 7.5, 75)
    got = oh.decode_onehot(torch.from_numpy(llr))
    want = ldpc_pallas.decode_pallas(jnp.asarray(llr), batch_tile=8,
                                     interpret=True)
    _assert_same([t.numpy() for t in got], want)
    np.testing.assert_array_equal(got[0].numpy(), cw)


@pytest.mark.parametrize("snr_db", [2.5, 3.0, 6.0])
def test_decode_onehot_matches_decode_reference(snr_db):
    llr, _ = _llrs(8, snr_db, int(snr_db * 10) + 3)
    before = bp_onehot.launches
    got = oh.decode_onehot(torch.from_numpy(llr))
    assert bp_onehot.launches == before          # CPU: the plain version
    _assert_same(got, ldpc.decode_reference(torch.from_numpy(llr)))
    _assert_same(got, jldpc.decode_np(llr))


@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_decode_onehot_iteration_cap(max_iter):
    llr, _ = _llrs(4, 3.0, 31)
    t = torch.from_numpy(llr)
    _assert_same(oh.decode_onehot_reference(t, max_iter=max_iter),
                 ldpc.decode_reference(t, max_iter=max_iter))


def test_decode_onehot_ragged_batch():
    """B = 7 is not a multiple of the kernel's 8-codeword tile nor of any
    batch_tile: each row decodes as it does alone."""
    llr, cw = _llrs(7, 10.0, 99)
    bits, iters, ok = oh.decode_onehot(torch.from_numpy(llr))
    assert bits.shape == (7, 2580) and bits.dtype == torch.uint8
    assert iters.dtype == torch.int32 and ok.dtype == torch.bool
    np.testing.assert_array_equal(bits.numpy(), cw)
    b1, i1, _ = oh.decode_onehot(torch.from_numpy(llr[3:4]))
    assert torch.equal(b1[0], bits[3]) and int(i1[0]) == int(iters[3])
    for bt in (0, -8, 2.5):
        with pytest.raises(ValueError):
            oh.decode_onehot(torch.from_numpy(llr), batch_tile=bt)
    with pytest.raises(ValueError):
        bp_onehot.decode(torch.from_numpy(llr),
                         oh.kernel_tables(torch.device("cpu")))


@pytest.mark.parametrize("batch_tile", [8, 16, 32, 64])
def test_decode_onehot_batch_tile_is_a_hint(batch_tile):
    """decode_onehot takes decode_pallas's batch_tile (any positive int)
    and its outputs do not depend on it."""
    llr, cw = _llrs(9, 3.5, 40 + batch_tile)
    t = torch.from_numpy(llr)
    got = oh.decode_onehot(t, batch_tile=batch_tile)
    _assert_same(got, ldpc.decode_reference(t))
    assert got[2].any()


def _reassemble(pieces):
    hi, mid, lo = (p.float() for p in pieces)
    return (hi + mid) + lo


def test_split3_exact_on_llrs_and_messages():
    llr, _ = _llrs(4, 3.0, 5)
    x = torch.from_numpy(llr)
    msgs = ldpc.phi0(torch.abs(x))                  # check-side messages
    for t in (x, msgs, -msgs, torch.zeros(3), x * 1e-20):
        pieces = oh.split3(t)
        assert all(p.dtype == torch.bfloat16 for p in pieces)
        assert torch.equal(_reassemble(pieces).view(torch.int32)
                           [t != 0], t.view(torch.int32)[t != 0])
        assert torch.equal(_reassemble(pieces), t)


def test_split3_exponent_sweep():
    """Exact for every exponent down to 2**-110 (random mantissas, both
    signs); below that the error is under 2**-133, toward zero."""
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, 64)
    e = np.arange(-110, 128)
    x = (mant[None, :] * np.exp2(e.astype(np.float64))[:, None]).astype(
        np.float32)
    x = np.concatenate([x, -x])
    assert np.all(np.isfinite(x))
    t = torch.from_numpy(x)
    assert torch.equal(_reassemble(oh.split3(t)), t)
    tiny = torch.from_numpy(
        (mant * np.exp2(-140.0)).astype(np.float32))       # f32 subnormals
    back = _reassemble(oh.split3(tiny))
    err = (tiny.double() - back.double())
    assert torch.all(err.abs() < 2.0 ** -133) and torch.all(err >= 0)


def test_tile_lists_match_pallas_tables():
    """The tile lists densify to the nonzero pattern of the Pallas kernel's
    one-hot matrix (edges x vars) and its transpose; the three slot
    matrices are disjoint with at most one 1 per output column."""
    _, scat = ldpc_pallas._tables()
    bcast, slots = oh.tile_lists()
    assert (len(bcast.ktile), [len(s.ktile) for s in slots]) == (
        5867, [2028, 2107, 1963])
    np.testing.assert_array_equal(oh.densify(bcast), (scat.T != 0))
    dense = [oh.densify(s) for s in slots]
    np.testing.assert_array_equal(sum(d.astype(int) for d in dense),
                                  (scat != 0).astype(int))
    assert max(int(d.sum(axis=0).max()) for d in dense) == 1
    assert int(oh.densify(bcast).sum(axis=0).max()) == 1
    for tl in (bcast, *slots):
        assert tl.ptr[-1] == len(tl.ktile) and np.all(np.diff(tl.ptr) >= 0)
        assert np.all(np.diff(tl.ntile) >= 0)


def test_kernel_tables_layout():
    """The kernel's packed tables: one region per block of the cluster, the
    same length (a multiple of 8 uint16, for 16-byte copies), a header of
    offsets and counts; the codes as uint32 at even offsets, entry g of a
    visit = k-tile << 16 | row g + 8 << 8 | row g; kernel_tables holds the
    same bits as int16."""
    ranks = oh.cluster_tables()
    packed = oh.pack_tables()
    assert packed.shape[0] == bp_onehot.CLUSTER == len(ranks)
    assert packed.shape[1] % 8 == 0
    assert bp_onehot.smem_bytes(packed.shape[1]) <= bp_onehot.SMEM_LIMIT
    kt = oh.kernel_tables(torch.device("cpu"))
    assert kt.dtype == torch.int16
    np.testing.assert_array_equal(kt.numpy().view(np.uint16), packed)
    for region, t in zip(packed.astype(np.int64), ranks):
        assert region[oh.H_C0] == t.c0 and region[oh.H_NC] == t.n_checks
        assert region[oh.H_V0] == t.v0 and region[oh.H_NV] == t.n_own
        assert region[oh.H_NL] == len(t.loc_vars)
        assert region[oh.H_NBC] == len(t.bc_k)
        assert region[oh.H_NER] == len(t.ev_dest)
        assert region[oh.H_NEV] == len(t.ev_k)
        for field, want in ((oh.H_BC_PTR, t.bc_ptr), (oh.H_BC_MASK, t.bc_mask),
                            (oh.H_EV_PTR, t.ev_ptr), (oh.H_EV_DEST, t.ev_dest),
                            (oh.H_OWN_HOLD, t.own_hold.reshape(-1))):
            off = region[field]
            np.testing.assert_array_equal(region[off:off + len(want)], want)
        for field, k, code in ((oh.H_BC_CODE, t.bc_k, t.bc_code),
                               (oh.H_EV_CODE, t.ev_k, t.ev_code)):
            off = region[field]
            assert off % 2 == 0
            w = region[off:off + 16 * len(k)].reshape(-1, 8, 2)
            words = w[..., 0] | w[..., 1] << 16
            np.testing.assert_array_equal(words >> 16,
                                          np.repeat(k[:, None], 8, axis=1))
            np.testing.assert_array_equal(words & 0xFF, code[:, :8])
            np.testing.assert_array_equal(words >> 8 & 0xFF, code[:, 8:])
        assert t.n_checks <= bp_onehot.CHECKS_B
        assert t.n_own <= bp_onehot.OWN_VARS_B
        assert len(t.loc_vars) <= bp_onehot.LOCAL_VARS_B
        assert len(t.bc_ptr) == bp_onehot.EDGES_B // 16 + 1
        assert len(t.ev_ptr) == -(-len(t.ev_dest) // 16) + 1


def test_onehot_product_equals_gather():
    """The emulated tiled products are index gathers, exactly."""
    rng = np.random.default_rng(3)
    bcast, slots, emask = oh.device_tables(torch.device("cpu"))
    edge_var, edge_mask, var_edge, var_mask = oh.edge_layout()
    x = torch.from_numpy(rng.normal(0, 30, (3, oh.VARS_P)).astype(np.float32))
    want = x[:, torch.from_numpy(edge_var).long()] * emask
    assert torch.equal(oh.onehot_product_reference(x, bcast), want)
    m = torch.from_numpy(rng.normal(0, 3, (3, oh.EDGES_P)).astype(np.float32))
    for k in range(3):
        got = oh.onehot_product_reference(m, slots[k])
        idx = torch.from_numpy(var_edge[:, k]).long()
        want = m[:, idx] * torch.from_numpy(var_mask[:, k])
        assert torch.equal(got[:, :2580], want)
        assert torch.all(got[:, 2580:] == 0)
