"""The design of the demod frame-loop kernel (csrc/fsk_demod.cu), checked on
the CPU: the CUDA source cannot run here, so its index arithmetic and its
summation orders are emulated in numpy and held against the plain loop.

- The exact twiddles: the kernel rebuilds `compat._dft_matrix(n, n/2)`
  from a base and an exception table; the rebuild is bit for bit.
- The rotated twiddle copies give the 16 bins of a half-warp 16 distinct
  shared-memory banks at every sample.
- The sample ring: its fill (16-byte chunks, zero chunks outside the
  buffer, a zero-filled tail) and its reads give the windows of the plain
  guards, for lanes that start before sample 0 and run past n_valid and
  past the buffer.
- The frame in the kernel's orders (DFT sample groups, fmaf accumulation,
  shuffle trees for the timing line and the Eb/N0 sums) keeps valid, nin,
  f_est and hard bits exact against `demod_stream_reference`, and soft
  bits within 1e-4 of the mean |soft|, as the kernel must.
"""
import numpy as np
import pytest
import torch

from wenet_tpu_torch.kernels import fsk_demod as K
from wenet_tpu_torch.ops import channel, fsk
from wenet_tpu_torch.utils import compat

torch.set_num_threads(1)

THREADS = 512                       # csrc/fsk_demod.cu
GEOMETRIES = {
    "v2": fsk.V2_CONFIG, "v1": fsk.V1_CONFIG,
    "v2_scaled": fsk.FSKConfig(Fs=96000, Rs=9600),
    "v1_scaled": fsk.FSKConfig(Fs=92000, Rs=11500),
    "odd_ts5": fsk.FSKConfig(Fs=48000, Rs=9600),
    "m4": fsk.FSKConfig(Fs=96000, Rs=9600, M=4),
    # N = 255, Ndft = 128: nin = 257 windows a second estimator block
    "two_blocks": fsk.FSKConfig(Fs=48000, Rs=9600, Nsym=51),
}
SOFT_TOL = 1e-4                     # of the mean |soft|, as the card tests


# ----------------------------------------------------------------- twiddles


def _dft_rows(n):
    T = compat._dft_matrix(n, n // 2, torch.device("cpu")).numpy()[:n]
    return T[:, : n // 2], T[:, n // 2:]


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024])
def test_twiddle_tables_rebuild_the_dft_matrix_bit_for_bit(n):
    C, S = _dft_rows(n)
    w = K.twiddle(n, np.arange(n)[:, None], np.arange(n // 2)[None, :])
    assert np.array_equal(w[..., 0].view(np.int32), C.view(np.int32))
    assert np.array_equal(w[..., 1].view(np.int32), S.view(np.int32))
    base, exc = K.twiddle_tables(n)
    assert base.shape == (n, 2) and exc.shape == (K.n_exceptions(n), 2)
    assert base.dtype == exc.dtype == np.float32


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_twiddles_of_each_geometry(name):
    """Every (sample, bin) a frame of this geometry reads, samples below
    the largest fs and bins below Ndft/2, is the DFT matrix's entry; the
    zero pad samples up to the next multiple of 4 read entries inside the
    table; the tables fit the kernel's shared memory with the rest of its
    state, the index table too at Ndft <= 256."""
    cfg = GEOMETRIES[name]
    n = cfg.Ndft
    fs_max = min(max(max(cfg.nin_choices) - n, 0), n)
    C, S = _dft_rows(n)
    w = K.twiddle(n, np.arange(fs_max)[:, None], np.arange(n // 2)[None, :])
    assert np.array_equal(w[..., 0], C[:fs_max])
    assert np.array_equal(w[..., 1], S[:fs_max])
    tab, idx = K.dft_tables(n)
    assert idx.shape == (n // 4 + 1, n // 2, 4) and int(idx.max()) < len(tab)
    for fmt in ("cu8", "cs16", "c64"):
        geom = K.geometry(cfg, fmt, 1, 1, 1 << 20)
        assert geom.n_tab == len(tab) and geom.idx_smem == (n <= 256)
        assert K.smem_layout_bytes(geom) <= K.SMEM_LIMIT


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024])
def test_twiddle_copies_spread_a_half_warp_over_distinct_banks(n):
    """At sample i the warp's bins read copy min(ctz(i), copies - 1);
    within each half-warp of 16 consecutive bins the distinct entries of
    the copies fall in distinct 8-byte banks (entry mod 16), so no twiddle
    load is replayed (the rare exception entries aside)."""
    tab, idx = K.dft_tables(n)
    copies = K.n_copies(n)
    for i in range(n + 4):
        row = idx[i // 4, :, i % 4].astype(np.int64)
        for k0 in range(0, n // 2, 16):
            e = np.unique(row[k0: k0 + 16])
            e = e[e < copies * n]
            assert len(np.unique(e % 16)) == len(e), (i, k0)
    # each copy is a permutation of the base table
    base, _ = K.twiddle_tables(n)
    for a in range(copies):
        block = tab[a * n: (a + 1) * n]
        assert np.array_equal(np.sort(block.view(np.int64).ravel()),
                              np.sort(base.view(np.int64).ravel()))


# --------------------------------------------------------------------- ring


class RingEmulation:
    """The kernel's sample ring in numpy: `fill` requests the 16-byte
    chunks of global samples up to `upto` (stored at once: the worst case
    for a slot still being read), `window` reads a frame's Nmem samples
    with the lane guards."""

    def __init__(self, geom, raw, fmt):
        self.g, self.fmt = geom, fmt
        self.bps = K.SAMPLE_BYTES[fmt]
        self.spc = 16 // self.bps
        self.bytes = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
        self.ring = np.full(geom.ring * self.bps, 0xAB, np.uint8)
        self.owner = np.full(geom.ring, -(1 << 60), np.int64)
        self.next_chunk = None

    def fill(self, upto):
        hi = -(-upto // self.spc)
        for c in range(self.next_chunk, hi):
            g0 = c * self.spc
            slot = (g0 % self.g.ring) * self.bps
            if not 0 <= g0 < self.g.n_total:     # not fetched
                continue
            chunk = np.zeros(16, np.uint8)      # cp.async's zero-filled tail
            avail = min(16, (self.g.n_total - g0) * self.bps)
            chunk[:avail] = self.bytes[g0 * self.bps: g0 * self.bps + avail]
            self.ring[slot: slot + 16] = chunk
            self.owner[g0 % self.g.ring + np.arange(self.spc)] = \
                g0 + np.arange(self.spc)
        self.next_chunk = max(self.next_chunk, hi)

    def window(self, start, base, nvalid):
        g = self.g
        li = base + np.arange(g.Nmem)
        gi = start + li
        slots = gi % g.ring
        read = (li >= 0) & (li < nvalid) & (gi >= 0) & (gi < g.n_total)
        assert np.array_equal(self.owner[slots][read], gi[read]), \
            "a window slot was lost"
        raw = self.ring.reshape(g.ring, self.bps)[slots]
        x = raw.copy().view({"cu8": np.uint8, "cs16": np.int16,
                             "c64": np.float32}[self.fmt]).reshape(-1, 2)
        x = torch.from_numpy(np.ascontiguousarray(x))
        iq = fsk.to_iq(x, self.fmt).numpy()
        return np.where(read, iq, 0)


def _raw(fmt, n, seed):
    rng = np.random.default_rng(seed)
    if fmt == "cu8":
        return rng.integers(0, 256, (n, 2), dtype=np.uint8)
    if fmt == "cs16":
        return rng.integers(-3000, 3000, (n, 2)).astype(np.int16)
    return rng.normal(size=(n, 2)).astype(np.float32)


@pytest.mark.parametrize("fmt", ["cu8", "cs16", "c64"])
@pytest.mark.parametrize("start_of", ["before_zero", "inside", "past_end"])
def test_ring_windows_equal_the_plain_guards(fmt, start_of):
    """Frames of random nin walk a lane through the ring; every window
    equals the plain version's gather (zero where li < 0, li >= n_valid or
    the global index lies outside the buffer)."""
    cfg = fsk.V2_CONFIG
    n_total = 40 * cfg.N + 5                 # a ragged last chunk
    raw = _raw(fmt, n_total, 3)
    start = {"before_zero": -1234, "inside": 777,
             "past_end": n_total - 20 * cfg.N}[start_of]
    nvalid = 30 * cfg.N + 3
    geom = K.geometry(cfg, fmt, 1, 40, n_total)
    ring = RingEmulation(geom, raw, fmt)
    iq = fsk.to_iq(torch.from_numpy(raw), fmt).numpy()
    rng = np.random.default_rng(11)
    pos, nin = 0, cfg.N
    end = start + pos + nin
    ring.next_chunk = (end - cfg.Nmem) // ring.spc      # the first fill
    ring.fill(end + geom.ahead)
    frames = 0
    while pos + nin <= nvalid:
        ring.fill(start + pos + nin + geom.ahead)        # the frame's fill
        base = pos + nin - cfg.Nmem
        got = ring.window(start, base, nvalid)
        li = base + np.arange(cfg.Nmem)
        gi = start + li
        inside = (li >= 0) & (li < nvalid) & (gi >= 0) & (gi < n_total)
        want = np.where(inside, iq[np.clip(gi, 0, n_total - 1)], 0)
        assert np.array_equal(got, want), frames
        pos += nin
        nin = int(rng.choice(cfg.nin_choices))
        frames += 1
    assert frames >= 29
    assert geom.ring >= cfg.Nmem + geom.ahead + 2 * ring.spc


# ----------------------------------------------- the frame in kernel order


def _fmaf(a, b, c):
    """fmaf in float32 (through float64: the product is exact)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _fma1(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _tree(v):
    """lane 0 of a warp's __shfl_down_sync sum tree over 32 lanes."""
    v = np.array(v, copy=True)
    for off in (16, 8, 4, 2, 1):
        v[: 32 - off] = v[: 32 - off] + v[off: 32]
    return v[0]


def _group_sums(wr, wi, lo, hi, groups, TW, half):
    """The kernel's DFT partials of samples [lo, hi) in `groups` sample
    groups (spans a multiple of 4): per group, even and odd samples in two
    fmaf sums, then added."""
    f32 = np.float32
    n = hi - lo
    span = ((n + groups - 1) // groups + 3) & ~3
    out = []
    for grp in range(groups):
        i0 = lo + min(grp * span, n)
        i1 = min(hi, i0 + span)
        acc = np.zeros((2, 2, half), f32)          # (even, odd), (re, im)
        for i in range(i0, i0 + -(-(i1 - i0) // 4) * 4):
            c, s = TW[i, :, 0], TW[i, :, 1]
            r, q = acc[(i - i0) % 2]
            r = _fmaf(wr[i], c, r)
            r = _fmaf(-wi[i], s, r)
            q = _fmaf(wr[i], s, q)
            q = _fmaf(wi[i], c, q)
            acc[(i - i0) % 2] = r, q
        out.append((acc[0, 0] + acc[1, 0], acc[0, 1] + acc[1, 1]))
    return out


def emulate_frames(cfg, iq, nf):
    """The kernel's frame loop in numpy, in its summation orders: the DFT
    of block 0's common head in Gc sample groups and of its tail in one
    group (even and odd samples in two fmaf sums a group), the partials
    added in that order, the timing line's float64 terms summed per warp
    and across warps by shuffle trees, the Eb/N0 sums per lane and by a
    shuffle tree.  Returns a dict of per-frame outputs."""
    f32 = np.float32
    N, Ts, P, M, Nsym, Nmem = cfg.N, cfg.Ts, cfg.P, cfg.M, cfg.Nsym, cfg.Nmem
    S, Ndft, half = Ts // P, cfg.Ndft, cfg.Ndft // 2
    NP = (Nsym + 1) * P
    G = 1 if half >= THREADS else THREADS // half
    Gc = 1 if half >= K.DFT_THREADS else K.DFT_THREADS // half
    fsc = K.fs_common(cfg)
    hann = fsk.hann_window(Ndft)
    consts = fsk._constants(cfg, torch.device("cpu"))
    spin_re = consts["spin_re"].numpy().astype(np.float64)
    spin_im = consts["spin_im"].numpy().astype(np.float64)
    TW = K.twiddle(Ndft, np.arange(Ndft + 3)[:, None],
                   np.arange(half)[None, :])
    tc = f32(cfg.ema_tc)
    one_m_tc = f32(1) - tc
    bin_hz = f32(cfg.Fs / Ndft)
    two_pi = f32(fsk.TWO_PI)
    inv_fs = f32(1.0 / cfg.Fs)
    two_pi_fs = two_pi * inv_fs
    bins = np.arange(half)
    band = (bins >= cfg.f_min_bin) & (bins < cfg.f_max_bin - 1)
    atan_c = [f32(c) for c in compat._atan_coeffs()]

    def atan2(y, x):
        ax, ay = abs(x), abs(y)
        hi, lo = max(ax, ay), min(ax, ay)
        t = f32(lo / (hi if hi > 0 else f32(1)))
        s = f32(t * t)
        p = atan_c[8]
        for k in range(7, -1, -1):
            p = f32(f32(p * s) + atan_c[k])
        r = f32(t * p)
        if ay > ax:
            r = f32(f32(np.pi / 2) - r)
        if x < 0:
            r = f32(f32(np.pi) - r)
        if y < 0:
            r = -r
        return r if hi > 0 else f32(0)

    iq = np.asarray(iq, np.complex64)
    n = len(iq)
    pos, nin = 0, N
    fft = np.zeros(half, f32)
    fest = np.zeros(M, f32)
    phi = np.zeros(M, f32)
    st_norm = st_ppm = f32(0)
    out = {k: [] for k in ("valid", "nin", "f_est", "soft", "bits",
                           "ebno_db")}
    for _ in range(nf):
        if pos + nin > n:
            out["valid"].append(False)
            continue
        nold = Nmem - nin
        li = pos + nin - Nmem + np.arange(Nmem)
        win = np.where((li >= 0) & (li < n), iq[np.clip(li, 0, n - 1)], 0)
        xr, xi = win.real.astype(f32), win.imag.astype(f32)
        for j in range(nin // Ndft):
            fs = min(max(nin - (j + 1) * Ndft, 0), Ndft)
            t0 = nold + j * Ndft
            wr = np.zeros(Ndft + 4, f32)
            wi = np.zeros(Ndft + 4, f32)
            wr[:fs] = xr[t0: t0 + fs] * hann[:fs]
            wi[:fs] = xi[t0: t0 + fs] * hann[:fs]
            # block 0: its common head in Gc groups, then its tail in one
            # group (both summed the frame before); later blocks in G groups
            if j == 0:
                sums = (_group_sums(wr, wi, 0, fsc, Gc, TW, half)
                        + _group_sums(wr, wi, fsc, fs, 1, TW, half))
            else:
                sums = _group_sums(wr, wi, 0, fs, G, TW, half)
            re, im = sums[0]
            for r_, i_ in sums[1:]:
                re = re + r_
                im = im + i_
            mag = np.sqrt(np.where(band, re * re + im * im, f32(0)))
            fft = fft * one_m_tc + mag * tc
        work = fft.copy()
        peaks = []
        for _ in range(M):
            imax = int(np.argmax(work))
            peaks.append(imax)
            work[(bins >= imax - cfg.f_zero_bins)
                 & (bins < imax + cfg.f_zero_bins)] = 0
        peaks.sort()
        f_new = np.array(peaks, f32) * bin_hz
        latched = f_new if fest[0] < 1 else fest
        noldf, ninf, Sf = f32(nold), f32(nin), f32(S)
        theta0 = np.array([_fma1(-((two_pi * (noldf - Sf)) * latched[m]),
                                 inv_fs, phi[m]) for m in range(M)], f32)
        phi_next = []
        for m in range(M):
            x = _fma1(two_pi_fs, _fma1(latched[m], noldf,
                                       f32(f_new[m] * (ninf - Sf))), theta0[m])
            r = f32(np.fmod(x, two_pi))
            if r != 0 and (r < 0) != (two_pi < 0):
                r = f32(r + two_pi)
            phi_next.append(r)
        t = np.arange(Nmem, dtype=f32)
        d = []
        for m in range(M):
            inner = _fma1(f_new[m], np.maximum(t - noldf, f32(0)),
                          (latched[m] * np.minimum(t, noldf)).astype(f32))
            ang = _fma1(two_pi_fs, inner, theta0[m])
            c, s = np.cos(ang).astype(f32), np.sin(ang).astype(f32)
            d.append((xr * c + xi * s, xi * c - xr * s))
        fi_re = np.zeros((M, NP), f32)
        fi_im = np.zeros((M, NP), f32)
        for m in range(M):
            for u in range(Ts):
                seg = slice(u, u + NP * S, S)
                fi_re[m] = d[m][0][seg] if u == 0 else fi_re[m] + d[m][0][seg]
                fi_im[m] = d[m][1][seg] if u == 0 else fi_im[m] + d[m][1][seg]
        ft = _fma1(fi_re[0], fi_re[0], fi_im[0] * fi_im[0])
        for m in range(1, M):
            ft = ft + _fma1(fi_re[m], fi_re[m], fi_im[m] * fi_im[m])
        nthreads = -(-NP // 32) * 32
        terms = np.zeros((2, max(nthreads, THREADS)))
        terms[0, :NP] = ft.astype(np.float64) * spin_re
        terms[1, :NP] = ft.astype(np.float64) * spin_im
        sums = []
        for row in terms:
            per_thread = row[:THREADS].copy()
            for q in range(THREADS, NP):         # threads' later q's
                per_thread[q % THREADS] += row[q]
            warps = [_tree(per_thread[w * 32:(w + 1) * 32])
                     for w in range(THREADS // 32)]
            sums.append(_tree(np.array(warps + [0.0] * (32 - len(warps)))))
        norm = f32(atan2(f32(sums[1]), f32(sums[0])) / two_pi)
        rx = f32(norm * f32(P))
        d_norm = f32(norm - st_norm)
        appm = f32(f32(f32(1e6) * d_norm) / f32(Nsym))
        ppm = (f32(f32(f32(0.9) * st_ppm) + f32(f32(0.1) * appm))
               if abs(d_norm) < f32(0.2) else st_ppm)
        nin_next = (N + Ts // 2 if norm > 0.25
                    else (N - Ts // 2 if norm < -0.25 else N))
        low = np.floor(rx)
        fract = f32(rx - low)
        high = f32(low + (f32(1) if fract > 0 else f32(0)))
        st_ = (np.arange(Nsym) + 1) * P
        ilo = np.clip(st_ + int(low), 0, NP - 1)
        ihi = np.clip(st_ + int(high), 0, NP - 1)
        w_lo = f32(1) - fract
        tr = fi_re[:, ilo] * w_lo + fi_re[:, ihi] * fract
        ti = fi_im[:, ilo] * w_lo + fi_im[:, ihi] * fract
        tmax = tr * tr + ti * ti
        mags = np.sqrt(tmax)
        if M == 2:
            bits = (tmax[1] > tmax[0]).astype(np.uint8)
            soft = mags[0] - mags[1]
        else:
            sym = np.argmax(tmax, axis=0)
            bits = np.stack([(sym >> 1) & 1, sym & 1], -1).reshape(-1)
            s0 = ((-mags[0] - mags[1]) + mags[2]) + mags[3]
            s1 = ((-mags[0] + mags[1]) - mags[2]) + mags[3]
            soft = np.stack([s0, s1], -1).reshape(-1)
        wv = tmax.max(axis=0)
        lanes = np.zeros((2, 32), f32)
        for k in range(Nsym):                  # lane k % 32, in k order
            lanes[0, k % 32] = lanes[0, k % 32] + np.sqrt(wv[k])
            lanes[1, k % 32] = lanes[1, k % 32] + wv[k]
        sm, sw = _tree(lanes[0]), _tree(lanes[1])
        meane = f32(sm / f32(Nsym))
        stde = f32(np.sqrt(max(f32(f32(sw / f32(Nsym)) - f32(meane * meane)),
                               f32(0))))
        ebno = f32(f32(-6) + f32(f32(20) * np.log10(
            f32(f32(1e-6) + meane) / f32(f32(1e-6) + stde))))
        out["ebno_db"].append(ebno)
        out["valid"].append(True)
        out["nin"].append(nin)
        out["f_est"].append(f_new)
        out["soft"].append(soft)
        out["bits"].append(bits)
        pos, nin = pos + nin, nin_next
        fest, phi = f_new, np.array(phi_next, f32)
        st_norm, st_ppm = norm, ppm
    return {k: np.array(v) for k, v in out.items()}


def _capture(cfg, seed, nframes=30, ebno_db=8.0):
    """Random bits, FSK, AWGN; resampled 0.4% fast, then 0.4% slow, so
    the elastic nin takes all three values."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, cfg.Nbits * nframes).astype(np.uint8)
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    half = len(sig) // 2
    sig = np.concatenate([channel.resample_linear(sig[:half], 1.004),
                          channel.resample_linear(sig[half:], 0.996)])
    return channel.add_awgn(sig, ebno_db, cfg.Fs, cfg.Rs, rng=rng)


@pytest.mark.parametrize("name", ["v2_scaled", "v1_scaled", "odd_ts5", "m4",
                                  "two_blocks"])
def test_kernel_summation_orders_keep_the_plain_decisions(name):
    cfg = GEOMETRIES[name]
    iq = _capture(cfg, seed=len(name) + 3)
    nf = cfg.num_frames(len(iq))
    emu = emulate_frames(cfg, iq, nf)
    _, want = fsk.demod_stream_reference(cfg, torch.from_numpy(iq), nf)
    valid = want.valid.numpy()
    assert np.array_equal(emu["valid"], valid)
    assert valid.sum() > 20
    nins = want.nin.numpy()[valid]
    assert np.array_equal(emu["nin"], nins)
    assert len(set(nins.tolist())) >= 2
    assert np.array_equal(emu["f_est"], want.f_est.numpy()[valid])
    assert np.array_equal(emu["bits"], want.bits.numpy()[valid])
    soft = want.soft.numpy()[valid]
    err = np.abs(emu["soft"] - soft).max()
    assert err <= SOFT_TOL * np.abs(soft).mean()
    np.testing.assert_allclose(emu["ebno_db"], want.ebno_db.numpy()[valid],
                               rtol=1e-4, atol=1e-4)
