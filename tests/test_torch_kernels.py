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
from wenet_tpu_torch.kernels import bp_decode, bp_onehot, fsk_demod
from wenet_tpu_torch.ops import channel, fsk, ldpc, ldpc_onehot
from wenet_tpu_torch.ops import ldpc_onehot as oh

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
    for name in ("bp_decode", "bp_onehot", "fsk_demod"):
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


def _unpack(region):
    """A block's packed table region read back as the kernel reads it."""
    a = region.astype(np.int64)
    n = {f: int(a[f]) for f in range(15)}
    nbt = bp_onehot.EDGES_B // 16
    nbc, ner, nev = n[oh.H_NBC], n[oh.H_NER], n[oh.H_NEV]

    def take(field, count):
        return a[n[field]:n[field] + count]

    def codes(field, count):
        w = take(field, 16 * count).reshape(count, 8, 2)
        kt, rows = w[:, 0, 1], w[..., 0]
        return kt, np.concatenate([rows & 0xFF, rows >> 8], axis=1)
    return dict(
        c0=n[oh.H_C0], nc=n[oh.H_NC], v0=n[oh.H_V0], nv=n[oh.H_NV],
        nl=n[oh.H_NL], n_rows=ner,
        bc=(take(oh.H_BC_PTR, nbt + 1), take(oh.H_BC_MASK, nbt),
            *codes(oh.H_BC_CODE, nbc)),
        ev=(take(oh.H_EV_PTR, -(-ner // 16) + 1), None,
            *codes(oh.H_EV_CODE, nev)),
        ev_dest=take(oh.H_EV_DEST, ner),
        own_hold=take(oh.H_OWN_HOLD, 3 * n[oh.H_NV]).reshape(-1, 3))


def _product(lists, x):
    """The tile products as the kernel runs them: x (K, B) float32, cut
    into bf16 pieces -> (n_out, 16, B) float32, (hi + mid) + lo."""
    ptr, _, kt, code = lists
    src = _pieces(x)
    V = len(kt)
    n_out = len(ptr) - 1
    A = torch.zeros(V, 16, 16)
    v, row = np.nonzero(code != 0xFF)
    A[v, row, code[v, row]] = 1.0
    cols = torch.as_tensor(kt[:, None] * 16 + np.arange(16))      # (V, 16)
    out_of = torch.as_tensor(np.repeat(np.arange(n_out), np.diff(ptr)))
    d = []
    for p in range(3):
        prod = A @ src[p][cols]                                    # (V, 16, B)
        d.append(torch.zeros(n_out, 16, x.shape[1]).index_add_(0, out_of,
                                                               prod))
    return (d[0] + d[1]) + d[2]


def _pieces(x):
    """float32 (K, B) -> (3, K, B): its bf16 pieces, as float32."""
    return torch.stack([p.float() for p in oh.split3(x.contiguous())])


def _emulate_onehot(llr, max_iter):
    """The one-hot kernel's cluster schedule in plain torch, read from the
    packed tables as the kernel reads them: the 8 blocks' edge phases (the
    broadcast product, q = qi_e - r, the signed phi), check phases (slot
    order, r as pieces), edge -> var products into the owners' sums, and
    the owners' var phases into the holders' copies; the freeze, the votes
    and the final parity of the output bits."""
    CA, EP = bp_onehot.CHECKS_B, bp_onehot.EDGES_B
    blocks = [_unpack(r) for r in oh.pack_tables()]
    B = llr.shape[0]
    qF = [torch.zeros(bp_onehot.LOCAL_VARS_B, B) for _ in blocks]
    rF = [torch.zeros(EP, B) for _ in blocks]
    G = [torch.zeros(3, bp_onehot.OWN_VARS_B, B) for _ in blocks]
    llr_o = [llr[:, b["v0"]:b["v0"] + b["nv"]].T.clone() for b in blocks]
    qi_o = [x.clone() for x in llr_o]

    def push(o):
        for i, hold in enumerate(blocks[o]["own_hold"]):
            for h in hold[hold != 0xFFFF]:
                qF[h >> 12][h & 0xFFF] = qi_o[o][i]

    def edge_values(bi):
        bl = blocks[bi]
        x = _product(bl["bc"], qF[bi]).reshape(EP, B)
        valid = torch.as_tensor(((bl["bc"][1][:, None] >> np.arange(16)) & 1)
                                .reshape(-1) == 1)
        return x, valid

    for o in range(len(blocks)):
        push(o)
    conv = torch.zeros(B, dtype=torch.bool)
    iters = torch.full((B,), max_iter, dtype=torch.int32)
    for it in range(max_iter):
        bad = torch.zeros(B, dtype=torch.bool)
        for bi, bl in enumerate(blocks):
            x, valid = edge_values(bi)
            if it == 0:
                q, neg = x, x < 0
            else:
                q = x - rF[bi]
                neg = q <= 0
            m = ldpc.phi0(q.abs())
            M = torch.where(valid[:, None], torch.where(neg, -m, m), 0.0)
            Ms = M[:14 * CA].reshape(14, CA, B)
            mag, sg = Ms.abs(), torch.signbit(Ms).int()
            acc = mag[0]
            for s in range(1, 14):
                acc = acc + mag[s]
            par = sg.sum(0) & 1
            rmag = ldpc.phi0(acc - mag)
            r = torch.where(((par ^ sg) & 1) == 1, -rmag, rmag).reshape(-1, B)
            v14 = valid[:14 * CA]
            rF[bi][:14 * CA][v14] = r[v14]
            bad |= (par[:bl["nc"]] != 0).any(0)
        for bi, bl in enumerate(blocks):
            g = _product(bl["ev"], rF[bi]).reshape(-1, B)
            for row, dest in enumerate(bl["ev_dest"]):
                G[dest >> 11][dest >> 9 & 3, dest & 0x1FF] = g[row]
        data = torch.zeros(B, dtype=torch.bool)
        for o, bl in enumerate(blocks):
            nv = bl["nv"]
            new = llr_o[o] + ((G[o][0, :nv] + G[o][1, :nv]) + G[o][2, :nv])
            is_data = torch.arange(bl["v0"], bl["v0"] + nv) < T.N_DATA
            data |= ((new < 0) & is_data[:, None]).any(0)
            qi_o[o] = torch.where(conv[None], qi_o[o], new)
            push(o)
        upd = ~conv
        iters = torch.where(upd, it + 1, iters).int()
        conv = conv | (upd & (~data | ~bad))
        if bool(conv.all()):
            break
    ran = max_iter > 0
    bits = torch.cat([(qi_o[o] < 0) & ran for o in range(len(blocks))]).T
    bad = torch.zeros(B, dtype=torch.bool)
    for bi, bl in enumerate(blocks):
        x, valid = edge_values(bi)
        sg = ((x < 0) & ran & valid[:, None])[:14 * CA].reshape(14, CA, B)
        bad |= (sg.int().sum(0) & 1 != 0).any(0)
    return bits.to(torch.uint8).contiguous(), iters, ~bad



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


def _lane_fragment(code, lane):
    """The A fragment a lane builds from a tile code (csrc/bp_onehot.cu:
    onehot_row): four registers of two bf16 each."""
    g, q = lane // 4, lane % 4

    def row(c):
        d = (int(c) - 2 * q) & 0xFFFFFFFF
        d8 = (d - 8) & 0xFFFFFFFF
        return (0x3F80 << (d << 4) if d < 2 else 0,
                0x3F80 << (d8 << 4) if d8 < 2 else 0)
    (a0, a2), (a1, a3) = row(code[g]), row(code[g + 8])
    return a0, a1, a2, a3


def _ptx_fragment(tile, lane):
    """The A fragment of mma.m16n8k16 .bf16 (row-major 16x16) for a lane,
    from the PTX ISA's layout: rows g, g + 8 by columns 2q, 2q + 1 and
    2q + 8, 2q + 9, lower column in the low half."""
    g, q = lane // 4, lane % 4
    bf = np.where(tile != 0, 0x3F80, 0).astype(np.int64)
    pair = [bf[r, c] | bf[r, c + 1] << 16
            for r, c in ((g, 2 * q), (g + 8, 2 * q), (g, 2 * q + 8),
                         (g + 8, 2 * q + 8))]
    return tuple(int(x) for x in pair)


def _dense(lists, n_rows, K):
    """The 0/1 matrix a code list stands for."""
    ptr, _, kt, code = lists
    out = np.zeros((-(-n_rows // 16) * 16, -(-K // 16) * 16 + 16), np.uint8)
    for t in range(len(ptr) - 1):
        for p in range(ptr[t], ptr[t + 1]):
            for r in np.flatnonzero(code[p] != 0xFF):
                out[t * 16 + r, kt[p] * 16 + code[p, r]] += 1
    return out


def test_onehot_codes_decode_to_mma_fragments():
    """Every packed tile code of every block gives, in every lane, the A
    fragment of its dense 16x16 tile; the codes densify to the broadcast
    (edges by local variables) and edge -> var ((variable, slot) rows by
    edges) one-hot matrices of the code, one 1 per valid row."""
    var_idx, cmask = T.check_edges()
    vslots, vmask = T.var_edges()
    CA, EP = bp_onehot.CHECKS_B, bp_onehot.EDGES_B
    blocks = [_unpack(r) for r in oh.pack_tables()]
    for bl, rt in zip(blocks, oh.cluster_tables()):
        for lists in (bl["bc"], bl["ev"]):
            code = lists[3]
            for p in range(0, len(code), 7):
                tile = np.zeros((16, 16), np.uint8)
                rows = np.flatnonzero(code[p] != 0xFF)
                tile[rows, code[p, rows]] = 1
                for lane in range(32):
                    assert (_lane_fragment(code[p], lane)
                            == _ptx_fragment(tile, lane))
        nl = bl["nl"]
        want = np.zeros((EP, nl), np.uint8)
        jmap = {v: j for j, v in enumerate(rt.loc_vars)}
        for c in range(bl["nc"]):
            for s in np.flatnonzero(cmask[bl["c0"] + c]):
                want[s * CA + c, jmap[var_idx[bl["c0"] + c, s]]] = 1
        got = _dense(bl["bc"], EP, nl)
        np.testing.assert_array_equal(got[:EP, :nl], want)
        assert got[:, nl:].sum() == 0
        got = _dense(bl["ev"], bl["n_rows"], EP)
        assert got[bl["n_rows"]:].sum() == 0 and got[:, EP:].sum() == 0
        for row, dest in enumerate(bl["ev_dest"]):
            k, v = dest >> 9 & 3, blocks[dest >> 11]["v0"] + (dest & 0x1FF)
            c, s = divmod(int(vslots[v, k]), 14)
            assert vmask[v, k] and bl["c0"] <= c < bl["c0"] + bl["nc"]
            assert got[row].sum() == 1 and got[row, s * CA + c - bl["c0"]]


def test_onehot_cluster_partition():
    """The 8 blocks' edges cover each valid edge of the code exactly once;
    each var's k-th edge is a row of exactly one block's edge -> var
    product; each var has one owner, whose holder list names exactly the
    blocks whose checks touch it, at the local index each gave it."""
    var_idx, cmask = T.check_edges()
    vslots, vmask = T.var_edges()
    CA = bp_onehot.CHECKS_B
    seen = np.zeros(cmask.shape, np.int64)
    kth = np.zeros(vmask.shape, np.int64)
    owners = np.zeros(T.CODE_LEN, np.int64)
    blocks = [_unpack(r) for r in oh.pack_tables()]
    ranks = oh.cluster_tables()
    c0s = [bl["c0"] for bl in blocks]
    for r, bl in enumerate(blocks):
        e = np.flatnonzero(((bl["bc"][1][:, None] >> np.arange(16)) & 1)
                           .reshape(-1))
        np.add.at(seen, (bl["c0"] + e % CA, e // CA), 1)
        for dest in bl["ev_dest"]:
            kth[blocks[dest >> 11]["v0"] + (dest & 0x1FF), dest >> 9 & 3] += 1
        owners[bl["v0"]:bl["v0"] + bl["nv"]] += 1
        for i, hold in enumerate(bl["own_hold"]):
            v = bl["v0"] + i
            holders = sorted(set(np.searchsorted(
                c0s, vslots[v][vmask[v]] // 14, side="right") - 1))
            hs = hold[hold != 0xFFFF]
            assert sorted(h >> 12 for h in hs) == holders
            for h in hs:
                assert ranks[h >> 12].loc_vars[h & 0xFFF] == v
    np.testing.assert_array_equal(seen, cmask.astype(np.int64))
    np.testing.assert_array_equal(kth, vmask.astype(np.int64))
    assert (owners == 1).all()
    assert c0s == [r * 516 // 8 for r in range(8)]


@pytest.mark.parametrize("B,clusters", [(1, 1), (7, 1), (16, 2), (70, 9),
                                        (128, 16), (2048, 16)])
def test_onehot_launch_shape(B, clusters):
    """A cluster of 8 blocks per tile of 8 codewords, up to the 16 clusters
    an H100 holds (B = 128: 128 blocks); past that a persistent grid; the
    shared memory of every block fits the 232,448 bytes of sm_90."""
    region = oh.pack_tables().shape[1]
    shape = bp_onehot.launch_shape(B, 16, region)
    assert shape == (8, 8 * clusters, bp_onehot.smem_bytes(region))
    assert shape.smem_bytes <= bp_onehot.SMEM_LIMIT == 232448
    assert region % 8 == 0
    assert bp_onehot.FIXED_SMEM % 16 == 0


@pytest.mark.parametrize("B,snr_db,max_iter", [
    (5, 2.5, 10), (6, 3.0, 10), (4, 6.0, 10), (9, 4.0, 10), (3, 3.0, 0),
    (3, 3.0, 1), (3, 3.0, 3), (2, 7.5, 10)])
def test_onehot_cluster_schedule_matches_plain(B, snr_db, max_iter):
    """On the CPU, the one-hot kernel's cluster schedule on its packed
    tables gives decode_reference's bits, iterations and parity flags
    exactly."""
    llr, _ = _llr(B, snr_db, 7 * B + int(10 * snr_db) + max_iter, "cpu")
    got = _emulate_onehot(llr, max_iter)
    want = ldpc.decode_reference(llr, max_iter=max_iter)
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
    for bad in (tables.cpu(), tables.int(), tables[:4], tables[:, :-8]):
        with pytest.raises(ValueError):
            bp_onehot.decode(llr, bad)


@pytest.mark.cuda
def test_onehot_batch_tile_is_a_hint():
    """decode_onehot takes decode_pallas's batch_tile and ignores it: 8,
    16, 32 and 64 give the same outputs, one launch each."""
    dev = _card()
    llr, _ = _llr(70, 3.0, 11, dev)
    want = ldpc_onehot.decode_onehot(llr)
    for bt in (8, 16, 32, 64):
        before = bp_onehot.launches
        got = ldpc_onehot.decode_onehot(llr, batch_tile=bt)
        torch.cuda.synchronize()
        assert bp_onehot.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 16, 70, 128, 129, 2048])
@pytest.mark.parametrize("snr_db", [2.5, 4.0, 7.5])
@pytest.mark.parametrize("max_iter", [0, 1, 3, 10])
def test_variant_kernels_every_launch_shape(B, snr_db, max_iter):
    """The one-hot kernel equals decode_onehot_reference and
    decode_reference in bits, iterations and parity flags on every
    codeword, in every launch shape: one cluster (B = 1, 7: ragged), 2,
    9 and 16 clusters, and the persistent grid (B = 129: one cluster walks
    two tiles; 2048: 16 tiles each)."""
    dev = _card()
    region = ldpc_onehot.kernel_tables(dev).shape[1]
    clusters = bp_onehot.card_clusters(dev, region)
    shape = bp_onehot.launch_shape(B, clusters, region)
    assert shape.cluster == 8
    assert shape.blocks == 8 * min(-(-B // 8), clusters)
    llr, _ = _llr(B, snr_db, B + int(10 * snr_db) + 100 * max_iter, dev)
    before = bp_onehot.launches
    got = ldpc_onehot.decode_onehot(llr, max_iter=max_iter)
    torch.cuda.synchronize()
    assert bp_onehot.launches == before + 1
    for plain in (ldpc.decode_reference, ldpc_onehot.decode_onehot_reference):
        for a, b in zip(got, plain(llr, max_iter=max_iter)):
            assert torch.equal(a, b)


# ------------------------------------------------------------ demod kernel

DEMOD_CFG = {"v2": fsk.V2_CONFIG, "v1": fsk.V1_CONFIG}
# soft bits: the kernel sums the DFT, the window sums and the means in
# another order than torch, so soft bits differ by float32 rounding; 1e-4
# of the mean |soft| leaves about a hundred ulps of room and is far below
# any decision.  Hard bits are compared where |soft| exceeds 1e-3 of it.
SOFT_TOL = 1e-4
BIT_TOL = 1e-3


def _demod_raw(mode, fmt, n, seed):
    """(n, 2) raw pairs of a random-bit 2FSK capture at 10 dB (numpy)."""
    cfg = DEMOD_CFG[mode]
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n // cfg.Ts + cfg.Nbits).astype(np.uint8)
    sig, _ = fsk.fsk_mod_np(cfg, bits[: len(bits) // cfg.Nbits * cfg.Nbits],
                            2 * cfg.Rs, cfg.Rs)
    iq = channel.add_awgn(sig[:n], 10.0, cfg.Fs, cfg.Rs, rng=rng) * 0.4
    if fmt == "cu8":
        return fsk.iq_to_cu8(iq).reshape(-1, 2)
    if fmt == "cs16":
        raw = np.empty((len(iq), 2), np.int16)
        raw[:, 0] = np.round(iq.real * 820)
        raw[:, 1] = np.round(iq.imag * 820)
        return raw
    return np.ascontiguousarray(iq.astype(np.complex64).view(np.float32)
                                .reshape(-1, 2))


def assert_demod_close(got, want):
    """valid and nin equal on every frame; f_est equal on valid frames; hard
    bits equal where |soft| is clear of zero; soft bits within SOFT_TOL of
    the mean |soft|; the final states' integer fields equal.  With an eye
    probe: ok and high_sample equal, f_int within SOFT_TOL of its mean
    magnitude."""
    (gs, go), (ws, wo) = got[:2], want[:2]
    valid = wo.valid.cpu()
    assert torch.equal(go.valid.cpu(), valid)
    assert torch.equal(go.nin.cpu()[valid], wo.nin.cpu()[valid])
    assert torch.equal(go.f_est.cpu()[valid], wo.f_est.cpu()[valid])
    soft_g, soft_w = go.soft.cpu()[valid], wo.soft.cpu()[valid]
    scale = soft_w.abs().mean()
    assert float((soft_g - soft_w).abs().max()) <= SOFT_TOL * float(scale)
    clear = soft_w.abs() > BIT_TOL * scale
    assert torch.equal(go.bits.cpu()[valid][clear], wo.bits.cpu()[valid][clear])
    for name in ("ebno_db", "norm_rx_timing", "ppm"):
        a, b = getattr(go, name).cpu()[valid], getattr(wo, name).cpu()[valid]
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4), name
    assert torch.equal(gs.pos.cpu(), ws.pos.cpu())
    assert torch.equal(gs.nin.cpu(), ws.nin.cpu())
    assert torch.equal(gs.f_est.cpu(), ws.f_est.cpu())
    if len(want) == 3:
        ge, we = got[2], want[2]
        assert torch.equal(ge.ok.cpu(), we.ok.cpu())
        assert torch.equal(ge.high_sample.cpu(), we.high_sample.cpu())
        fg, fw = ge.f_int.cpu(), we.f_int.cpu()
        tol = SOFT_TOL * float(fw.abs().mean())
        assert float((fg - fw).abs().max()) <= tol


def test_demod_wrapper_takes_only_cuda_tensors():
    """On the CPU the kernel wrapper raises and launches nothing;
    ops.fsk.demod_raw takes the plain loop for CPU tensors."""
    cfg = fsk.FSKConfig(Fs=96000, Rs=9600)
    data = torch.zeros((4 * cfg.N, 2), dtype=torch.uint8)
    starts = torch.zeros(1, dtype=torch.int64)
    nv = torch.full((1,), 4 * cfg.N, dtype=torch.int64)
    before = fsk_demod.launches
    with pytest.raises(ValueError):
        fsk_demod.demod(cfg, data, "cu8", 3, starts, nv)
    _, outs = fsk.demod_raw(cfg, data, "cu8", 5, starts, nv)
    assert fsk_demod.launches == before
    assert outs.valid.tolist() == [[True] * 4 + [False]]


@pytest.mark.cuda
@pytest.mark.parametrize("with_eye", [False, True], ids=["", "eye"])
@pytest.mark.parametrize("lanes", [1, 3, 16])
@pytest.mark.parametrize("fmt", ["cu8", "cs16", "c64"])
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_demod_kernel_matches_plain(mode, fmt, lanes, with_eye):
    """L lanes at their own starts in one buffer, overlapping, each with
    its own n_valid, the first lane starting before sample 0 and the last
    running past the buffer's end."""
    dev = _card()
    cfg = DEMOD_CFG[mode]
    span = 40 * cfg.N
    raw = _demod_raw(mode, fmt, span // 2 * (lanes + 1), 5 + lanes)
    data = torch.from_numpy(raw).to(dev)
    starts = torch.arange(lanes, dtype=torch.int64, device=dev) * (span // 2)
    starts[0] -= 3 * cfg.N + 5               # before sample 0: reads 0.0
    n_valid = span - 7 * torch.arange(lanes, dtype=torch.int64, device=dev)
    n_valid[-1] += cfg.N                     # past the end: reads 0.0
    nf = cfg.num_frames(span + cfg.N)
    before = fsk_demod.launches
    got = fsk.demod_raw(cfg, data, fmt, nf, starts, n_valid,
                        with_eye=with_eye)
    torch.cuda.synchronize()
    assert fsk_demod.launches == before + 1
    want = fsk.demod_raw_reference(cfg, data, fmt, nf, starts, n_valid,
                                   with_eye=with_eye)
    assert_demod_close(got, want)
    assert bool(want[1].valid[:, :30].all())


@pytest.mark.cuda
@pytest.mark.parametrize("with_eye", [False, True], ids=["", "eye"])
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_demod_kernel_carries_state(mode, with_eye):
    """Receiver-style pushes: the second push starts from the first's
    carried state, with n_valid short of the buffer (and its buffer a view
    that does not start on 16 bytes); a third push too short for a frame
    gives an eye probe with ok False."""
    dev = _card()
    cfg = DEMOD_CFG[mode]
    raw = torch.from_numpy(_demod_raw(mode, "cu8", 70 * cfg.N, 9)).to(dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    first = raw[: 30 * cfg.N].contiguous()
    nv1 = torch.full((1,), 30 * cfg.N, dtype=torch.int64, device=dev)
    nf = cfg.num_frames(30 * cfg.N)
    got1 = fsk.demod_raw(cfg, first, "cu8", nf, zero, nv1, None, with_eye)
    want1 = fsk.demod_raw_reference(cfg, first, "cu8", nf, zero, nv1, None,
                                    with_eye)
    assert_demod_close(got1, want1)
    state = want1[0]
    end = int(state.pos[0])
    keep = min(end, cfg.Nmem)
    second = raw[end - keep:]                 # a view at 2 (end - keep) bytes
    state = state._replace(pos=torch.full((1,), keep, dtype=torch.int32,
                                          device=dev))
    nv2 = torch.full((1,), second.shape[0] - 5 * cfg.N, dtype=torch.int64,
                     device=dev)
    nf2 = cfg.num_frames(second.shape[0])
    got2 = fsk.demod_raw(cfg, second, "cu8", nf2, zero, nv2, state,
                         with_eye)
    want2 = fsk.demod_raw_reference(cfg, second, "cu8", nf2, zero, nv2, state,
                                    with_eye)
    assert_demod_close(got2, want2)
    assert not bool(want2[1].valid[0, -3:].any())
    if with_eye:
        short = torch.full((1,), 10, dtype=torch.int64, device=dev)
        got3 = fsk.demod_raw(cfg, second, "cu8", 2, zero, short, state, True)
        assert not bool(got3[2].ok.any())
        assert not bool(got3[2].f_int.abs().any())


@pytest.mark.cuda
def test_demod_stream_and_lanes_launch_the_kernel():
    """demod_stream (one lane) and demod_lanes (L lanes) on CUDA tensors
    go through the kernel and equal their plain versions."""
    dev = _card()
    cfg = fsk.V2_CONFIG
    raw = _demod_raw("v2", "c64", 3 * 25 * cfg.N, 3)
    iq = torch.from_numpy(raw.view(np.complex64)[:, 0].copy()).to(dev)
    nf = cfg.num_frames(25 * cfg.N)
    before = fsk_demod.launches
    got = fsk.demod_stream(cfg, iq[: 25 * cfg.N], nf)
    want = fsk.demod_stream_reference(cfg, iq[: 25 * cfg.N], nf)
    lanes = iq.reshape(3, -1)
    got_l = fsk.demod_lanes(cfg, lanes, nf)
    want_l = fsk.demod_lanes_reference(cfg, lanes, nf)
    torch.cuda.synchronize()
    assert fsk_demod.launches == before + 2
    lift = [tuple(t[None] for t in part) for part in (got[0], got[1],
                                                      want[0], want[1])]
    assert_demod_close((fsk.DemodState(*lift[0]), fsk.FrameOut(*lift[1])),
                       (fsk.DemodState(*lift[2]), fsk.FrameOut(*lift[3])))
    assert_demod_close(got_l, want_l)


def assert_probe_close(got, want, valid, final_fft):
    """The PROBE variant's traces against the plain loop's on valid frames:
    high_sample exact, rx_timing within 1e-4 (rtol and atol, as
    norm_rx_timing), f_int and the EMA within 1e-5 of their rms (float32
    sums in another order, as the CPU test holds the port to JAX);
    frames past a lane's end: zeros, and the kernel's final EMA
    (final_fft, (L, Ndft/2))."""
    v = valid.cpu()
    g = fsk.ProbeTrace(*(t.cpu() for t in got))
    w = fsk.ProbeTrace(*(t.cpu() for t in want))
    assert torch.equal(g.high_sample[v], w.high_sample[v])
    assert torch.allclose(g.rx_timing[v], w.rx_timing[v], rtol=1e-4,
                          atol=1e-4)
    for name in ("f_int", "fft_est"):
        a, b = getattr(g, name)[v], getattr(w, name)[v]
        rms = float(b.abs().square().mean().sqrt())
        assert float((a - b).abs().max()) <= 1e-5 * rms, name
    assert not bool(g.f_int[~v].abs().any())
    assert not bool(g.high_sample[~v].any() or g.rx_timing[~v].any())
    for lane in range(v.shape[0]):
        past = g.fft_est[lane][~v[lane]]
        assert torch.equal(past, final_fft[lane].cpu().expand_as(past))


@pytest.mark.cuda
@pytest.mark.parametrize("with_eye", [False, True], ids=["", "eye"])
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_demod_probe_variant_matches_plain(mode, lanes, with_eye):
    """with_probe launches the PROBE instantiation once (counted apart from
    the flight path's launches): its traces match the plain loop's, its
    frame outputs and state are bit-equal to the non-probe kernel's on the
    same lanes, and its eye probe (before the trace) is the last valid
    frame's trace.  Lanes end at their own n_valid, with frames past it."""
    dev = _card()
    cfg = DEMOD_CFG[mode]
    span = 30 * cfg.N
    raw = _demod_raw(mode, "cu8", span // 2 * (lanes + 1), 21 + lanes)
    data = torch.from_numpy(raw).to(dev)
    starts = torch.arange(lanes, dtype=torch.int64, device=dev) * (span // 2)
    n_valid = span - 5 * cfg.N * torch.arange(lanes, dtype=torch.int64,
                                               device=dev)
    nf = cfg.num_frames(span)
    before, before_probe = fsk_demod.launches, fsk_demod.probe_launches
    got = fsk.demod_raw(cfg, data, "cu8", nf, starts, n_valid,
                        with_eye=with_eye, with_probe=True)
    torch.cuda.synchronize()
    assert fsk_demod.probe_launches == before_probe + 1
    assert fsk_demod.launches == before
    plain_kernel = fsk.demod_raw(cfg, data, "cu8", nf, starts, n_valid,
                                 with_eye=with_eye)
    for a, b in zip(got[:-1], plain_kernel):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    want = fsk.demod_raw_reference(cfg, data, "cu8", nf, starts, n_valid,
                                   with_eye=with_eye, with_probe=True)
    assert_demod_close(got[:-1], want[:-1])
    assert_probe_close(got[-1], want[-1], want[1].valid, got[0].fft_est)
    assert not bool(want[1].valid[-1].all())
    if with_eye:
        for lane in range(lanes):
            last = int(torch.nonzero(got[1].valid[lane])[-1])
            assert torch.equal(got[-1].f_int[lane, last],
                               got[2].f_int[lane])
            assert int(got[-1].high_sample[lane, last]) == \
                int(got[2].high_sample[lane])


@pytest.mark.cuda
def test_probe_demod_on_the_card():
    """utils/probe.probe_demod on the card (one PROBE launch) against the
    same call on the CPU, and its rx_sd bit-equal to demod_iq_np on the
    card."""
    from wenet_tpu_torch.utils import probe
    _card()
    cfg = fsk.V2_CONFIG
    iq = _demod_raw("v2", "c64", 40 * cfg.N, 31).view(np.complex64)[:, 0]
    before = fsk_demod.probe_launches
    got = probe.probe_demod(cfg, iq)
    assert fsk_demod.probe_launches == before + 1
    want = probe.probe_demod(cfg, iq, device="cpu")
    v = want["valid"]
    assert np.array_equal(got["valid"], v) and v.sum() >= 35
    for k in ("t_nin", "t_high_sample", "t_f_est"):
        assert np.array_equal(got[k][v], want[k][v]), k
    scale = np.abs(want["rx_sd"][v]).mean()
    assert np.abs(got["rx_sd"][v] - want["rx_sd"][v]).max() <= SOFT_TOL * scale
    soft, _, _ = fsk.demod_iq_np(cfg, iq)
    assert np.array_equal(got["rx_sd"][v].reshape(-1), soft)


@pytest.mark.cuda
def test_demod_wrapper_rejects_bad_inputs():
    dev = _card()
    cfg = fsk.V2_CONFIG
    data = torch.zeros((10 * cfg.N, 2), dtype=torch.uint8, device=dev)
    starts = torch.zeros(2, dtype=torch.int64, device=dev)
    nv = torch.full((2,), 10 * cfg.N, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        fsk_demod.demod(cfg, data.float(), "cu8", 3, starts, nv)
    with pytest.raises(TypeError):
        fsk_demod.demod(cfg, data, "cu8", 3, starts.int(), nv)
    with pytest.raises(ValueError):
        fsk_demod.demod(cfg, data, "cu8", 3, starts, nv[:1])
    with pytest.raises(ValueError):
        fsk_demod.demod(cfg, data, "s16", 3, starts, nv)
    with pytest.raises(ValueError):
        fsk_demod.demod(cfg, data.cpu(), "cu8", 3, starts, nv)


@pytest.mark.cuda
def test_demod_kernel_second_estimator_block():
    """Ts = 5, Nsym = 51: N = 255 and Ndft = 128, so frames with nin = 257
    window a second estimator block, which the kernel sums in the frame
    (the first block's DFT is summed the frame before)."""
    dev = _card()
    cfg = fsk.FSKConfig(Fs=48000, Rs=9600, Nsym=51)
    rng = np.random.default_rng(13)
    bits = rng.integers(0, 2, cfg.Nbits * 60).astype(np.uint8)
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    half = len(sig) // 2
    sig = np.concatenate([channel.resample_linear(sig[:half], 1.004),
                          channel.resample_linear(sig[half:], 0.996)])
    iq = channel.add_awgn(sig, 8.0, cfg.Fs, cfg.Rs, rng=rng)
    raw = np.ascontiguousarray(iq.astype(np.complex64).view(np.float32)
                               .reshape(-1, 2))
    data = torch.from_numpy(raw).to(dev)
    starts = torch.zeros(1, dtype=torch.int64, device=dev)
    n_valid = torch.full((1,), data.shape[0], dtype=torch.int64, device=dev)
    nf = cfg.num_frames(data.shape[0])
    got = fsk.demod_raw(cfg, data, "c64", nf, starts, n_valid, with_eye=True)
    want = fsk.demod_raw_reference(cfg, data, "c64", nf, starts, n_valid,
                                   with_eye=True)
    torch.cuda.synchronize()
    assert_demod_close(got, want)
    nins = want[1].nin[want[1].valid]
    assert bool((nins >= 2 * cfg.Ndft).any())


# ---------------------------------------- CRC, top-k acquisition, channelizer

def _codewords(B, seed, n_bad=0, width=2580):
    """(B, width) uint8 codeword bits of random packets with their CRC
    trailers, the last n_bad with one payload bit flipped."""
    from wenet_tpu_torch.core import framing
    rng = np.random.default_rng(seed)
    out = np.zeros((B, width), np.uint8)
    for i in range(B):
        body = framing.pad_payload(rng.integers(0, 256, 256, np.uint8)
                                   .tobytes())
        body += int(framing.crc16_ccitt(body)).to_bytes(2, "little")
        bits = np.unpackbits(np.frombuffer(body + ldpc.encode_bytes(body),
                                           np.uint8))[:width]
        if i >= B - n_bad:
            bits[rng.integers(0, 2064)] ^= 1
        out[i, :len(bits)] = bits
    return out


def _soft_train(mode, n_packets, sigma, seed, lead=500, gap=300):
    """A soft stream of framed packets between random idle bits."""
    from wenet_tpu_torch.core import framing
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, lead).astype(np.uint8)]
    for _ in range(n_packets):
        p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        bits.append(framing.frame_to_bits(
            framing.frame_packet(p, ldpc.encode_bytes, mode=mode), mode))
        bits.append(rng.integers(0, 2, gap).astype(np.uint8))
    b = np.concatenate(bits)
    return (1 - 2.0 * b + rng.normal(0, sigma, b.shape)).astype(np.float32)


def test_new_wrappers_take_only_cuda_tensors():
    """The CRC, acquisition and channelizer wrappers raise on CPU tensors
    and launch nothing; their ops take the plain versions for CPU
    tensors."""
    from wenet_tpu_torch.kernels import channelize as kch
    from wenet_tpu_torch.kernels import crc_pack as kcrc
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.ops import channelizer, crc, deframe
    bits = torch.from_numpy(_codewords(3, 1, n_bad=1))
    soft = torch.from_numpy(_soft_train("v2", 1, 0.3, 2))[None]
    pairs = torch.zeros((64, 2), dtype=torch.float32)
    counts = (kcrc.launches, ktopk.launches, kch.launches)
    for call in (lambda: kcrc.pack(bits, iters=torch.zeros(3)),
                 lambda: kcrc.crc_ok(bits),
                 lambda: ktopk.llrs(soft, "v2", 2),
                 lambda: kch.channelize(pairs, 8, 12, (0, 1)),
                 lambda: kch.channelize(pairs[:, 0].to(torch.uint8), 8, 12,
                                        (0, 1), "cu8")):
        with pytest.raises(ValueError):
            call()
    assert crc.packet_crc_ok(bits).tolist() == [True, True, False]
    assert crc.crc_pack(bits, positions=torch.tensor([1, 2, -1])).shape == (
        3, 263)
    pb, ok, _, pos = deframe.deframe_topk(soft, "v2", 2, device="cpu")
    assert bool(ok[0, 0]) and int(pos[0, 1]) == -1
    assert channelizer.channelize_pairs(pairs, 8).shape == (64, 2)
    assert (kcrc.launches, ktopk.launches, kch.launches) == counts


@pytest.mark.cuda
@pytest.mark.parametrize("tail", ["none", "iters", "pos"])
@pytest.mark.parametrize("B", [1, 7, 128, 176, 2047, 2048])
def test_crc_pack_kernel_matches_plain(B, tail):
    """Rows bit-exact against the plain version: valid and corrupted
    packets, random bits, and bits that are not 0/1 (exact integer byte
    sums, as the plain version forms them); a strided (B, 2580) view."""
    from wenet_tpu_torch.kernels import crc_pack as kcrc
    from wenet_tpu_torch.ops import crc
    dev = _card()
    rng = np.random.default_rng(B)
    good = _codewords(B, B, n_bad=B // 3)
    noise = rng.integers(0, 2, good.shape).astype(np.uint8)
    odd = rng.integers(0, 4, good.shape).astype(np.uint8)
    wide = np.concatenate([good, good], axis=1)
    extra = torch.as_tensor(rng.integers(-300, 300, B), dtype=torch.int32,
                            device=dev)
    kw = {"none": None, "iters": {"iters": extra},
          "pos": {"positions": extra}}[tail]
    for arr in (good, noise, odd):
        bits = torch.from_numpy(arr).to(dev)
        before = kcrc.launches
        ok = crc.packet_crc_ok(bits)
        if kw is None:              # the flags alone; rows need a tail
            with pytest.raises(ValueError):
                crc.crc_pack(bits)
            got = want = None
        else:
            got = crc.crc_pack(bits, **kw)
            want = crc.crc_pack_reference(bits, **kw)
        torch.cuda.synchronize()
        assert kcrc.launches == before + 1 + (kw is not None)
        assert got is want or torch.equal(got, want)
        assert torch.equal(ok, crc.packet_crc_ok_reference(bits))
    view = torch.from_numpy(wide).to(dev)[:, 2580:]
    assert torch.equal(crc.packet_crc_ok(view),
                       crc.packet_crc_ok_reference(view))
    if kw is not None:
        assert torch.equal(crc.crc_pack(view, **kw),
                           crc.crc_pack_reference(view, **kw))
    assert int(crc.packet_crc_ok(torch.from_numpy(good).to(dev)).sum()) \
        == B - B // 3


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [2064, 2068, 2071, 2600, 2581])
def test_crc_pack_kernel_row_strides(stride):
    """Rows of any stride >= 2064: 4-byte aligned strides (the kernel's
    word loads) and odd ones (its byte loads), bit-exact in both layouts
    and the flags alone, on valid, corrupted and non-0/1 bits."""
    from wenet_tpu_torch.ops import crc
    dev = _card()
    B = 33
    rng = np.random.default_rng(stride)
    good = _codewords(B, stride, n_bad=11, width=2064)
    odd = rng.integers(0, 4, good.shape).astype(np.uint8)
    extra = torch.as_tensor(rng.integers(-300, 300, B), dtype=torch.int32,
                            device=dev)
    for arr in (good, odd):
        wide = np.zeros((B, stride), np.uint8)
        wide[:, :2064] = arr
        bits = torch.from_numpy(wide).to(dev)[:, :2064]
        assert bits.stride(0) == stride
        for kw in ({"iters": extra}, {"positions": extra}):
            assert torch.equal(crc.crc_pack(bits, **kw),
                               crc.crc_pack_reference(bits, **kw))
        assert torch.equal(crc.packet_crc_ok(bits),
                           crc.packet_crc_ok_reference(bits))
    assert int(crc.packet_crc_ok(torch.from_numpy(good).to(dev)).sum()) \
        == B - 11


def _assert_topk_close(got, want):
    """(llr, positions, exhausted, sd) of the kernel against the plain
    version: positions, exhausted and sd exact; LLRs within rtol 1e-5
    (the order of sd_to_llr's sums), NaN where the plain version has NaN."""
    llr, pos, exh, sd = got
    sd_w, pos_w, exh_w = want
    llr_w = ldpc.sd_to_llr(sd_w)
    assert torch.equal(pos.cpu(), pos_w.cpu())
    assert torch.equal(exh.cpu(), exh_w.cpu())
    assert torch.equal(sd.cpu(), sd_w.cpu())
    torch.testing.assert_close(llr.cpu(), llr_w.cpu(), rtol=1e-5, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_deframe_topk_kernel_matches_plain(mode):
    """Three streams: a noisy packet train, its reverse (noise picks), and
    a periodic stream whose UW hits all tie (first-maximum ties decide);
    more picks than placeable windows (exhausted picks)."""
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.ops import deframe
    dev = _card()
    train = _soft_train(mode, 3, 0.5, 3 if mode == "v2" else 4)
    period = _soft_train(mode, 1, 0.0, 5, lead=40, gap=40)
    tied = np.resize(period, len(train))
    soft = torch.from_numpy(np.stack([train, train[::-1].copy(), tied])
                            ).to(dev)
    k = 9
    before = ktopk.launches
    got = ktopk.llrs(soft, mode, k, with_sd=True)
    torch.cuda.synchronize()
    assert ktopk.launches == before + 1
    want = deframe.topk_windows_reference(soft, mode, k)
    _assert_topk_close(got, want)
    assert bool(want[2][:, -1].all()) and not bool(want[2][:, 0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_deframe_topk_kernel_long_stream(mode):
    """Streams too long for the pick kernel's on-chip copy of the scores
    and tile maxima (150,000 and 3.2 M symbols: it picks on them in the
    global scratch) equal the plain version; a stream too short for one
    window gives only exhausted picks."""
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.ops import deframe
    dev = _card()
    train = _soft_train(mode, 40, 0.6, 11, gap=400)
    for C, n, k in ((2, 150_000, 12), (1, 3_200_000, 20)):
        soft = torch.from_numpy(np.resize(train, (C, n)).copy()).to(dev)
        assert ktopk.geometry(n, mode)[3] > ktopk.SMEM_LIMIT
        got = ktopk.llrs(soft, mode, k, with_sd=True)
        _assert_topk_close(got, deframe.topk_windows_reference(soft, mode, k))
    short = soft[:, :2000].contiguous()
    got = ktopk.llrs(short, mode, 3, with_sd=True)
    want = deframe.topk_windows_reference(short, mode, 3)
    _assert_topk_close(got, want)
    assert bool(want[2].all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_deframe_topk_kernel_wideband_shape(mode):
    """The wideband fused step's shape (8 streams of 39,888 symbols, 18
    picks) with packet trains at several noise levels, and one stream
    (C = 1) with more picks than placeable windows."""
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.ops import deframe
    dev = _card()
    rows = [np.resize(_soft_train(mode, 12, 0.3 + 0.1 * c, 70 + c, gap=512),
                      39_888) for c in range(8)]
    soft = torch.from_numpy(np.stack(rows).astype(np.float32)).to(dev)
    before = ktopk.launches
    got = ktopk.llrs(soft, mode, 18, with_sd=True)
    torch.cuda.synchronize()
    assert ktopk.launches == before + 1
    _assert_topk_close(got, deframe.topk_windows_reference(soft, mode, 18))
    one = soft[:1, :9000].contiguous()
    got = ktopk.llrs(one, mode, 5, with_sd=True)
    want = deframe.topk_windows_reference(one, mode, 5)
    _assert_topk_close(got, want)
    assert bool(want[2][0, -1]) and not bool(want[2][0, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_deframe_topk_on_the_card_matches_the_cpu(mode):
    """deframe_topk through the three kernels against the plain path on
    the CPU: payload bytes, ok, iterations, positions and the packed rows
    exact."""
    from wenet_tpu_torch.kernels import crc_pack as kcrc
    from wenet_tpu_torch.kernels import deframe_topk as ktopk
    from wenet_tpu_torch.ops import deframe
    dev = _card()
    train = _soft_train(mode, 3, 0.5, 21)
    soft = np.stack([train, train[::-1].copy()])
    counts = (ktopk.launches, bp_decode.launches, kcrc.launches)
    got = deframe.deframe_topk(soft, mode, 6, device=dev)
    packed = deframe.deframe_topk(soft, mode, 6, device=dev, packed=True)
    torch.cuda.synchronize()
    assert (ktopk.launches, bp_decode.launches, kcrc.launches) == tuple(
        c + 2 for c in counts)
    want = deframe.deframe_topk(soft, mode, 6, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(packed.cpu(), deframe.deframe_topk(
        soft, mode, 6, device="cpu", packed=True))
    assert int(want[1][0].sum()) == 3


def _chan_inputs(n, seed, dev):
    """(raw cu8 bytes (2 n,), their float32 pairs (n, 2)) on `dev`."""
    raw = np.random.default_rng(seed).integers(0, 256, 2 * n, dtype=np.uint8)
    pairs = fsk.iq_from_cu8(raw).view(np.float32).reshape(-1, 2)
    return torch.from_numpy(raw).to(dev), torch.from_numpy(pairs).to(dev)


def _chan_gaussian(n, seed, dev):
    """(n, 2) float32 pairs of unit-variance Gaussian samples on `dev`:
    arbitrary mantissas, magnitudes above 1."""
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, 2)).astype(np.float32)).to(dev)


def _chan_plain(pairs, N, sel, T=12):
    from wenet_tpu_torch.ops import channelizer
    return torch.view_as_real(channelizer.channelize_reference(
        torch.view_as_complex(pairs), N, T, channels=sel)).reshape(-1, 2)


def _chan_close(got, want):
    assert got.shape == want.shape
    rms = float(want.square().mean().sqrt())
    assert float((got - want).abs().max()) <= 1e-5 * rms


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["c64", "cu8"])
@pytest.mark.parametrize("channels", [None, (5, 0, 3)], ids=["all", "sel"])
@pytest.mark.parametrize("N", [4, 8, 16, 6, 256])
def test_channelize_kernel_matches_plain(N, channels, fmt):
    """A length that is not a multiple of N or of the tile, N = 4, 8, 16
    (N a template constant), 6 and 256 (N read at run time; 256 has more
    phases than FIR threads), Gaussian float pairs or raw cu8 bytes:
    within 1e-5 of the output's rms of the plain version, one launch a
    call."""
    from wenet_tpu_torch.kernels import channelize as kch
    from wenet_tpu_torch.ops import channelizer
    dev = _card()
    n = N * 3000 + 3
    if fmt == "cu8":
        x, pairs = _chan_inputs(n, N, dev)
    else:
        x = pairs = _chan_gaussian(n, N, dev)
    sel = None if channels is None else [k % N for k in channels]
    before = kch.launches
    got = channelizer.channelize_pairs(x, N, channels=sel, input_format=fmt)
    torch.cuda.synchronize()
    assert kch.launches == before + 1
    _chan_close(got, _chan_plain(pairs, N, sel))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["c64", "cu8"])
@pytest.mark.parametrize("N,T", [(8, 16), (6, 4), (256, 16), (1300, 12)])
def test_channelize_kernel_run_time_taps_and_tiles(N, T, fmt):
    """Taps other than 12 (read at run time, the single-output FIR) and
    N = 1300, whose tile shrinks (2 frames on float pairs): within 1e-5 of the output's
    rms of the plain version, one launch a call."""
    from wenet_tpu_torch.kernels import channelize as kch
    from wenet_tpu_torch.ops import channelizer
    dev = _card()
    n = N * 2000 + 5
    if fmt == "cu8":
        x, pairs = _chan_inputs(n, N + T, dev)
    else:
        x = pairs = _chan_gaussian(n, N + T, dev)
    sel = [N - 1, 2, 0]
    before = kch.launches
    got = channelizer.channelize_pairs(x, N, T, channels=sel,
                                       input_format=fmt)
    torch.cuda.synchronize()
    assert kch.launches == before + 1
    _chan_close(got, _chan_plain(pairs, N, sel, T))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 8, 16, 6, 5, 128, 256])
def test_channelize_cu8_equals_pairs_bitwise(N):
    """The cu8 route and the float-pair route on the same samples give the
    same bits (the conversion is exact), each call one launch; a long
    capture spreads over many tiles a block."""
    from wenet_tpu_torch.kernels import channelize as kch
    from wenet_tpu_torch.ops import channelizer
    dev = _card()
    n = N * kch.plan(N, 12, 3, "cu8")[0] * 700 + N - 1
    raw, pairs = _chan_inputs(n, 7, dev)
    sel = [N - 1, 0, 1 % N]
    before = kch.launches
    a = channelizer.channelize_pairs(raw, N, channels=sel, input_format="cu8")
    b = channelizer.channelize_pairs(pairs, N, channels=sel)
    torch.cuda.synchronize()
    assert kch.launches == before + 2
    assert torch.equal(a, b)
    _chan_close(a, _chan_plain(pairs, N, sel))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,offset", [("cu8", 2), ("cu8", 8), ("cu8", 16),
                                        ("cu8", 14), ("c64", 8),
                                        ("c64", 16)])
def test_channelize_kernel_unaligned_capture(fmt, offset):
    """A capture whose device pointer lies `offset` bytes past an aligned
    address (a slice of a larger buffer): the same output as the aligned
    copy, bit for bit."""
    from wenet_tpu_torch.ops import channelizer
    dev = _card()
    N = 8
    n = N * 5000 + 5
    x = _chan_inputs(n, 9, dev)[0] if fmt == "cu8" else _chan_gaussian(
        n, 9, dev)
    flat = x.reshape(-1)
    step = flat.element_size()
    big = torch.zeros(flat.numel() + 64 // step, dtype=flat.dtype, device=dev)
    big[offset // step: offset // step + flat.numel()] = flat
    moved = big[offset // step: offset // step + flat.numel()].view(x.shape)
    assert (moved.data_ptr() - big.data_ptr()) == offset
    got = channelizer.channelize_pairs(moved, N, input_format=fmt)
    want = channelizer.channelize_pairs(x, N, input_format=fmt)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("N,T,fmt,in_flight", [
    (3228, 4, "c64", 0), (3228, 4, "cu8", 2), (2600, 4, "c64", 1),
    (6456, 1, "c64", 0)])
def test_channelize_kernel_at_the_first_versions_reach(N, T, fmt,
                                                       in_flight):
    """The largest N of the first version of the kernel at T = 4 (3228)
    and T = 1 (6456, 1-frame tiles), and an N that needs one tile in
    flight: 3 channels within 1e-5 of the output's (complex) rms of the
    plain version, as chip_smoke.py holds the channelizer (the kernel's
    32 lanes an item sum 3228 phases to about 4e-7 of it in the numpy
    emulation), one launch."""
    from wenet_tpu_torch.kernels import channelize as kch
    from wenet_tpu_torch.ops import channelizer
    dev = _card()
    assert kch.plan(N, T, 3, fmt)[2] == in_flight
    n = N * 64 + 5
    if fmt == "cu8":
        x, pairs = _chan_inputs(n, N, dev)
    else:
        x = pairs = _chan_gaussian(n, N, dev)
    sel = [N - 1, 2, 0]
    before = kch.launches
    got = channelizer.channelize_pairs(x, N, T, channels=sel,
                                       input_format=fmt)
    torch.cuda.synchronize()
    assert kch.launches == before + 1
    want = _chan_plain(pairs, N, sel, T)
    assert got.shape == want.shape
    rms = float(want.square().sum(1).mean().sqrt())
    assert float((got - want).abs().max()) <= 1e-5 * rms


@pytest.mark.cuda
def test_channelize_negative_channels_on_the_card():
    """channels (-1, 3) on the card equal the plain version's (N-1, 3);
    N and -N-1 raise IndexError before any launch; the wrapper raises on
    what the kernel does not take (no taps, an N for which not even a
    2-frame tile fits a block, float64 pairs, an odd number of cu8
    bytes)."""
    from wenet_tpu_torch.kernels import channelize as kch
    from wenet_tpu_torch.ops import channelizer
    dev = _card()
    N = 8
    raw, pairs = _chan_inputs(N * 2000 + 1, 13, dev)
    got = channelizer.channelize_pairs(pairs, N, channels=(-1, 3))
    _chan_close(got, _chan_plain(pairs, N, (N - 1, 3)))
    before = kch.launches
    for bad in (N, -N - 1):
        with pytest.raises(IndexError):
            channelizer.channelize_pairs(pairs, N, channels=(0, bad))
    for call in (lambda: kch.channelize(pairs, N, 0, (0,)),
                 lambda: kch.channelize(pairs, 4096, 12, (0,)),
                 lambda: kch.channelize(raw[:-1], N, 12, (0,), "cu8")):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(TypeError):
        kch.channelize(pairs.double(), N, 12, (0,))
    assert kch.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"fused": True}, {"vectorized": False}],
                         ids=["vectorized", "fused", "receiver"])
def test_demod_multichannel_on_the_card_matches_the_cpu(kw):
    """Two packets on channels 2 and 5 of an 8-channel capture (Fs 96 kHz
    a channel): every mode's lists on the card equal the CPU's."""
    from wenet_tpu_torch.ops import channelizer
    dev = _card()
    cfg = fsk.FSKConfig(Fs=96000, Rs=9600)
    wide, sent = _wideband(cfg, 8, {2: 1, 5: 1}, 30.0, 40)
    got = channelizer.demod_multichannel(wide, 8 * cfg.Fs, 8, cfg,
                                         channels=[2, 5], device=dev, **kw)
    want = channelizer.demod_multichannel(wide, 8 * cfg.Fs, 8, cfg,
                                          channels=[2, 5], device="cpu", **kw)
    assert got == want == {k: sent[k] for k in (2, 5)}


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"fused": True}, {"vectorized": False}],
                         ids=["vectorized", "fused", "receiver"])
def test_demod_multichannel_cu8_and_negative_channels_on_the_card(kw):
    """The same capture as cu8 bytes (scaled by 1/4) with channels
    [-1, 2, 5]: every mode's lists on the card equal the CPU's, keyed by
    the indices as given."""
    from wenet_tpu_torch.ops import channelizer
    dev = _card()
    cfg = fsk.FSKConfig(Fs=96000, Rs=9600)
    wide, sent = _wideband(cfg, 8, {2: 1, 5: 1}, 30.0, 40)
    raw = fsk.iq_to_cu8(wide / 4)
    got = channelizer.demod_multichannel(raw, 8 * cfg.Fs, 8, cfg,
                                         channels=[-1, 2, 5], device=dev,
                                         input_format="cu8", **kw)
    want = channelizer.demod_multichannel(raw, 8 * cfg.Fs, 8, cfg,
                                          channels=[-1, 2, 5], device="cpu",
                                          input_format="cu8", **kw)
    assert got == want == {-1: [], 2: sent[2], 5: sent[5]}


def _wideband(cfg, n_ch, packets, ebno_db, seed):
    """(capture, {channel: payloads}): each channel's packets synthesised
    at the wideband rate and mixed to its centre, AWGN at ebno_db per
    channel."""
    import dataclasses
    from wenet_tpu_torch.core import framing
    from wenet_tpu_torch.ops import channelizer
    rng = np.random.default_rng(seed)
    fs_total = cfg.Fs * n_ch
    wide_cfg = dataclasses.replace(cfg, Fs=fs_total)
    centres = channelizer.channel_centres(fs_total, n_ch)
    streams, sent = {}, {}
    for k, count in packets.items():
        bits = [rng.integers(0, 2, cfg.Nbits * 4).astype(np.uint8)]
        sent[k] = []
        for _ in range(count):
            p = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
            sent[k].append(p)
            bits += [framing.frame_to_bits(framing.frame_packet(
                p, ldpc.encode_bytes, "v2"), "v2"),
                rng.integers(0, 2, 200).astype(np.uint8)]
        streams[k] = np.concatenate(bits)
    n_bits = max(len(b) for b in streams.values()) + 4 * cfg.Nbits
    n_bits += (-n_bits) % cfg.Nbits
    wide = np.zeros(n_bits * wide_cfg.Ts, np.complex64)
    t = np.arange(len(wide), dtype=np.float64) / fs_total
    for k, b in streams.items():
        b = np.concatenate([b, rng.integers(0, 2, n_bits - len(b)
                                            ).astype(np.uint8)])
        sig, _ = fsk.fsk_mod_np(wide_cfg, b, 2 * cfg.Rs, cfg.Rs)
        wide += (sig * np.exp(2j * np.pi * centres[k] * t)).astype(
            np.complex64)
    wide = channel.add_awgn(wide, ebno_db + 10 * np.log10(len(packets)),
                            fs_total, cfg.Rs, rng=rng)
    return wide.astype(np.complex64), sent
