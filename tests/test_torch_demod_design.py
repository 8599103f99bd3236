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
- The estimator warps' three candidates, formed a frame ahead for every
  nin choice, give bit for bit the estimate of the serial chain for the
  nin that the timing chooses.
- The wrapper's mirror of the shared-memory layout follows the kernel's.
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


def _kernel_layout(geom):
    """Bytes of each region of `layout()` in csrc/fsk_demod.cu, its C
    expressions read from the source and evaluated on this geometry."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                            "fsk_demod.cu")).read()
    body = src[src.index("static inline Layout layout("):]
    body = body[: body.index("L.total = at;")]

    def py(expr):
        expr = " ".join(expr.split()).replace("(size_t)", "")
        for c_type, size in (("double", 8), ("float2", 8), ("float", 4)):
            expr = expr.replace(f"sizeof({c_type})", str(size))
        expr = expr.replace("/", "//").replace("NWARPS", str(THREADS // 32))
        m = re.fullmatch(r"(.+?)\?(.+):(.+)", expr)
        if m:
            expr = f"({m[2]}) if ({m[1]}) else ({m[3]})"
        return expr
    env = {"g": geom,
           "sample_bytes": lambda fmt: K.SAMPLE_BYTES_BY_FMT[fmt],
           "dft_groups": lambda h: 1 if h >= THREADS else THREADS // h,
           "common_groups": lambda h: (1 if h >= K.DFT_THREADS
                                       else K.DFT_THREADS // h)}
    for name, expr in re.findall(r"const bool (\w+) = (.+?);", body):
        env[name] = eval(py(expr), env)
    return [eval(py(e), env)
            for e in re.findall(r"take\(\s*at,(.+?)\);", body, re.S)]


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_smem_layout_mirror_follows_the_kernel(name):
    """kernels/fsk_demod.smem_layout_bytes, which sizes the geometry
    without the card, equals the kernel's own layout() (its region sizes
    read from the CUDA source), 16-byte aligned regions, and stays under a
    block's shared memory; on the card chip_smoke.py holds it to
    fsk_demod_smem_bytes."""
    cfg = GEOMETRIES[name]
    for fmt in ("cu8", "cs16", "c64"):
        for idx_smem in (0, 1):
            geom = K.geometry(cfg, fmt, 1, 1, 1 << 20)
            geom.idx_smem = idx_smem
            regions = _kernel_layout(geom)
            assert len(regions) >= 16
            total = sum((b + 15) // 16 * 16 for b in regions)
            assert K.smem_layout_bytes(geom) == total
        assert K.smem_layout_bytes(K.geometry(cfg, fmt, 1, 1, 1 << 20)) \
            <= K.SMEM_LIMIT


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

    def window(self, start, base, nvalid, count=None):
        g = self.g
        li = base + np.arange(g.Nmem if count is None else count)
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
        # the estimator warps read the next frame's blocks in this frame,
        # its first block at pos + nin, up to its largest nin
        ahead = ring.window(start, pos + nin, nvalid, max(cfg.nin_choices))
        li = pos + nin + np.arange(max(cfg.nin_choices))
        gi = start + li
        inside = (li >= 0) & (li < nvalid) & (gi >= 0) & (gi < n_total)
        want = np.where(inside, iq[np.clip(gi, 0, n_total - 1)], 0)
        assert np.array_equal(ahead, want), frames
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


class EstConsts:
    """The tone estimator's constants, float32 as the kernel holds them."""

    def __init__(self, cfg):
        f32 = np.float32
        self.cfg = cfg
        self.Ndft, self.half = cfg.Ndft, cfg.Ndft // 2
        self.G = 1 if self.half >= THREADS else THREADS // self.half
        self.Gc = (1 if self.half >= K.DFT_THREADS
                   else K.DFT_THREADS // self.half)
        self.fsc = K.fs_common(cfg)
        self.hann = fsk.hann_window(cfg.Ndft)
        self.TW = K.twiddle(cfg.Ndft, np.arange(cfg.Ndft + 3)[:, None],
                            np.arange(self.half)[None, :])
        self.tc = f32(cfg.ema_tc)
        self.one_m_tc = f32(1) - self.tc
        self.bin_hz = f32(cfg.Fs / cfg.Ndft)
        self.two_pi = f32(fsk.TWO_PI)
        self.inv_fs = f32(1.0 / cfg.Fs)
        self.two_pi_fs = self.two_pi * self.inv_fs
        self.bins = np.arange(self.half)
        self.band = ((self.bins >= cfg.f_min_bin)
                     & (self.bins < cfg.f_max_bin - 1))


def _ema_step(E, fft, sums):
    """The EMA after one block: its DFT partials added in order, the
    band-masked magnitude."""
    f32 = np.float32
    re, im = sums[0]
    for r_, i_ in sums[1:]:
        re = re + r_
        im = im + i_
    mag = np.sqrt(np.where(E.band, re * re + im * im, f32(0)))
    return fft * E.one_m_tc + mag * E.tc


def _peaks_and_phases(E, fft, nin, fest, phi):
    """M first-max peak picks with blanking, sorted; the latched tones and
    the carrier phases of a frame of this nin."""
    f32 = np.float32
    cfg = E.cfg
    work = fft.copy()
    peaks = []
    for _ in range(cfg.M):
        imax = int(np.argmax(work))
        peaks.append(imax)
        work[(E.bins >= imax - cfg.f_zero_bins)
             & (E.bins < imax + cfg.f_zero_bins)] = 0
    peaks.sort()
    f_new = np.array(peaks, f32) * E.bin_hz
    latched = f_new if fest[0] < 1 else fest
    noldf, ninf, Sf = f32(cfg.Nmem - nin), f32(nin), f32(cfg.Ts // cfg.P)
    theta0 = np.array([_fma1(-((E.two_pi * (noldf - Sf)) * latched[m]),
                             E.inv_fs, phi[m]) for m in range(cfg.M)], f32)
    phi_next = []
    for m in range(cfg.M):
        x = _fma1(E.two_pi_fs, _fma1(latched[m], noldf,
                                     f32(f_new[m] * (ninf - Sf))), theta0[m])
        r = f32(np.fmod(x, E.two_pi))
        if r != 0 and (r < 0) != (E.two_pi < 0):
            r = f32(r + E.two_pi)
        phi_next.append(r)
    return (np.array(peaks), f_new, np.asarray(latched, f32), theta0,
            np.array(phi_next, f32))


def estimate_serial(E, xr, xi, nin, fft, fest, phi):
    """A frame's tone estimate from its window (xr, xi: Nmem samples ending
    at pos + nin), as one chain: the blocks in order (block 0's common head
    in Gc sample groups and its tail in one group, later blocks in G), the
    EMA after each, the peaks and phases.  Returns (EMA, peaks, f_new,
    latched, theta0, phi_next)."""
    f32 = np.float32
    Ndft, nold = E.Ndft, E.cfg.Nmem - nin
    for j in range(nin // Ndft):
        fs = min(max(nin - (j + 1) * Ndft, 0), Ndft)
        t0 = nold + j * Ndft
        wr = np.zeros(Ndft + 4, f32)
        wi = np.zeros(Ndft + 4, f32)
        wr[:fs] = xr[t0: t0 + fs] * E.hann[:fs]
        wi[:fs] = xi[t0: t0 + fs] * E.hann[:fs]
        if j == 0:
            sums = (_group_sums(wr, wi, 0, E.fsc, E.Gc, E.TW, E.half)
                    + _group_sums(wr, wi, E.fsc, fs, 1, E.TW, E.half))
        else:
            sums = _group_sums(wr, wi, 0, fs, E.G, E.TW, E.half)
        fft = _ema_step(E, fft, sums)
    return (fft,) + _peaks_and_phases(E, fft, nin, fest, phi)


def estimate_candidates(E, iq, pos, fft, fest, phi):
    """The warp-specialised kernel's estimator: the three candidates of
    the frame whose first block starts at lane sample pos (iq: the lane's
    samples, zero outside), one for each nin choice, from the frame
    before's chosen EMA, f_new and phi_next.  Block 0's head is windowed
    and summed once for all three, its tails one each; a candidate's
    later blocks start at pos + j Ndft.  Returns three tuples as
    estimate_serial's."""
    f32 = np.float32
    cfg, Ndft = E.cfg, E.Ndft

    def block(j, fs):
        li = pos + j * Ndft + np.arange(fs)
        x = np.where((li >= 0) & (li < len(iq)),
                     iq[np.clip(li, 0, len(iq) - 1)], 0)
        wr = np.zeros(Ndft + 4, f32)
        wi = np.zeros(Ndft + 4, f32)
        wr[:fs] = x.real.astype(f32) * E.hann[:fs]
        wi[:fs] = x.imag.astype(f32) * E.hann[:fs]
        return wr, wi

    fs_tail = [min(max(nin - Ndft, 0), Ndft) for nin in cfg.nin_choices]
    wr, wi = block(0, max(fs_tail))
    head = _group_sums(wr, wi, 0, E.fsc, E.Gc, E.TW, E.half)
    out = []
    for c, nin in enumerate(cfg.nin_choices):
        ema = fft
        if nin >= Ndft:
            tr, ti = wr.copy(), wi.copy()
            tr[fs_tail[c]:] = 0
            ti[fs_tail[c]:] = 0
            ema = _ema_step(E, ema, head + _group_sums(
                tr, ti, E.fsc, fs_tail[c], 1, E.TW, E.half))
        for j in range(1, nin // Ndft):
            fs = min(max(nin - (j + 1) * Ndft, 0), Ndft)
            br, bi = block(j, fs)
            ema = _ema_step(E, ema, _group_sums(br, bi, 0, fs, E.G, E.TW,
                                                E.half))
        out.append((ema,) + _peaks_and_phases(E, ema, nin, fest, phi))
    return out


def emulate_frames(cfg, iq, nf):
    """The kernel's frame loop in numpy, in its summation orders: the tone
    estimate as one chain (estimate_serial: the DFT of block 0's common
    head in Gc sample groups and of its tail in one group, even and odd
    samples in two fmaf sums a group, the partials added in that order),
    the timing line's float64 terms summed per 32-thread slot and across
    slots by shuffle trees, the Eb/N0 sums per lane and by a shuffle tree.
    Returns a dict of per-frame outputs."""
    f32 = np.float32
    N, Ts, P, M, Nsym, Nmem = cfg.N, cfg.Ts, cfg.P, cfg.M, cfg.Nsym, cfg.Nmem
    S, half = Ts // P, cfg.Ndft // 2
    NP = (Nsym + 1) * P
    E = EstConsts(cfg)
    consts = fsk._constants(cfg, torch.device("cpu"))
    spin_re = consts["spin_re"].numpy().astype(np.float64)
    spin_im = consts["spin_im"].numpy().astype(np.float64)
    two_pi, two_pi_fs = E.two_pi, E.two_pi_fs
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
        fft, _, f_new, latched, theta0, phi_next = estimate_serial(
            E, xr, xi, nin, fft, fest, phi)
        noldf = f32(nold)
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


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_three_candidate_estimator_equals_the_serial_one(name):
    """The kernel's estimator warps form frame f+1's estimate for all three
    nin choices while frame f demodulates; the candidate that frame f's
    timing then chooses equals, bit for bit, the estimate formed in the
    frame itself from its window (EMA, peaks, f_new, latched, theta0,
    phi_next), frame after frame along a capture, over a random walk of
    nin that takes every choice."""
    cfg = GEOMETRIES[name]
    E = EstConsts(cfg)
    iq = _capture(cfg, seed=len(name) + 11, nframes=24)
    rng = np.random.default_rng(len(name))
    f32 = np.float32
    fft = np.zeros(E.half, f32)
    fest = np.zeros(cfg.M, f32)
    phi = np.zeros(cfg.M, f32)
    pos, nin = 0, cfg.N
    chosen = set()
    frames = 0
    while pos + nin <= len(iq):
        cands = estimate_candidates(E, iq, pos, fft, fest, phi)
        li = pos + nin - cfg.Nmem + np.arange(cfg.Nmem)
        win = np.where(li >= 0, iq[np.clip(li, 0, len(iq) - 1)], 0)
        want = estimate_serial(E, win.real.astype(f32),
                               win.imag.astype(f32), nin, fft, fest, phi)
        c = cfg.nin_choices.index(nin)
        for got, ref in zip(cands[c], want):
            assert got.dtype == ref.dtype
            assert np.array_equal(np.asarray(got).view(np.uint8),
                                  np.asarray(ref).view(np.uint8)), frames
        chosen.add(c)
        fft, _, fest, _, _, phi = cands[c]
        pos += nin
        nin = int(rng.choice(cfg.nin_choices))
        frames += 1
    assert frames >= 20 and chosen == {0, 1, 2}
    assert float(fest[0]) > 0


# ------------------------------------------------ the frame-parallel path


def _window(cfg, f0, pos0, nin0, n, nf, W):
    """Frames the window at frame f0 takes (spec_window of the kernel)."""
    if f0 >= nf or pos0 + nin0 > n:
        return 0
    return min(W, nf - f0, (n - pos0 - nin0) // cfg.N + 1)


def emulate_frame_parallel(cfg, iq, nf, state=None, n_valid=None,
                           first=K.SPEC_FIRST_WINDOW, cap=K.SPEC_WINDOW):
    """The frame-parallel path's schedule (csrc/fsk_demod.cu, 6.) run with
    the plain loop's per-frame pieces: a window of frames whose nin after
    the first is guessed N; (a) each frame's estimator magnitudes, (b) the
    EMA chain, (c) the peaks, (d) the phase chain, (e) each frame's demod
    and the first frame whose next nin missed the guess, (f) the ppm and
    SNR chains over the frames kept up to it; the next window from the
    first frame not kept; a lane whose rounds miss before keeping
    SPEC_MIN_WINDOW frames SPEC_MAX_POOR times in a row is left to the lane
    path (here the plain loop).  Returns (final state, FrameOut stacked over frames,
    rounds, fell back, the windows' (first frame, frames, kept))."""
    dev = torch.device("cpu")
    iq = torch.as_tensor(iq).to(torch.complex64)
    n = iq.shape[0] if n_valid is None else n_valid
    consts = fsk._constants(cfg, dev)
    pad, NB = cfg.Nmem, cfg.Ndft * cfg.max_fft_blocks
    buf = torch.cat([torch.zeros(pad, dtype=torch.complex64), iq,
                     torch.zeros(cfg.Nmem + NB, dtype=torch.complex64)])
    st = fsk.demod_init(cfg, dev) if state is None else state
    cap = min(cap, nf)
    W, f0, rounds, poor, fell = min(first, cap), 0, 0, 0, False
    outs, windows = [], []
    while True:
        pos0, nin0 = int(st.pos), int(st.nin)
        wlen = _window(cfg, f0, pos0, nin0, n, nf, W)
        if wlen == 0:
            break
        nins = [nin0] + [cfg.N] * (wlen - 1)
        poss = [pos0] + [pos0 + nin0 + (j - 1) * cfg.N
                         for j in range(1, wlen)]
        nin_t = [torch.tensor(v, dtype=torch.int32) for v in nins]
        mags = [fsk._est_mags(cfg, buf[pad + p + consts["ar_nb"]], v,
                              consts) for p, v in zip(poss, nin_t)]   # (a)
        emas, e = [], st.fft_est
        for j in range(wlen):                                      # (b)
            e = fsk._est_ema(cfg, e, mags[j], nin_t[j])
            emas.append(e)
        fnew = [fsk._est_peaks(cfg, e, consts) for e in emas]      # (c)
        phases, f_prev, phi = [], st.f_est, st.phi
        for j in range(wlen):                                      # (d)
            phases.append(fsk._tone_phases(cfg, f_prev, phi, fnew[j],
                                           nin_t[j]))
            f_prev, phi = fnew[j], phases[-1][2]
        body = []
        for j in range(wlen):                                      # (e)
            end = pad + poss[j] + nins[j]
            stream = buf[end - cfg.Nmem + consts["ar_nmem"]]
            la, th0, _ = phases[j]
            body.append(fsk._demod_body(cfg, stream, la, fnew[j], th0,
                                        nin_t[j], consts))
        miss = next((j for j in range(wlen - 1)
                     if int(body[j][3]) != cfg.N), None)
        keep = wlen if miss is None else miss + 1
        norm_prev, ppm, snr = st.norm_rx_timing, st.ppm, st.snr_est
        for j in range(keep):                                      # (f)
            _, _, norm, _, soft, bits, ebno, _, _ = body[j]
            ppm = fsk._ppm_step(cfg, norm_prev, ppm, norm)
            snr = 0.5 * snr + 0.5 * ebno
            outs.append(fsk.FrameOut(soft, bits, torch.tensor(True),
                                     fnew[j], ebno, norm, ppm, nin_t[j]))
            norm_prev = norm
        last = keep - 1
        st = fsk.DemodState(
            pos=torch.tensor(poss[last] + nins[last], dtype=torch.int32),
            nin=body[last][3], fft_est=emas[last], f_est=fnew[last],
            phi=phases[last][2], norm_rx_timing=norm_prev, ppm=ppm,
            ebno_db=body[last][6], snr_est=snr)
        windows.append((f0, wlen, keep))
        rounds, f0 = rounds + 1, f0 + keep
        W = (min(max(2 * keep, K.SPEC_MIN_WINDOW), cap) if miss is not None
             else min(2 * W, cap))
        poor = poor + 1 if miss is not None and keep < K.SPEC_MIN_WINDOW else 0
        if poor >= K.SPEC_MAX_POOR:
            fell = True
            break
    if f0 < nf:                     # the lane path from the frame reached
        st, rest = fsk.demod_stream_reference(cfg, iq, nf - f0, st, n)
        outs += [fsk.FrameOut(*(t[k] for t in rest))
                 for k in range(nf - f0)]
    return (st, fsk.FrameOut(*(torch.stack(t) for t in zip(*outs))),
            rounds, fell, windows)


def _predicted_rounds(cfg, nins, first, cap, nf):
    """Rounds and fallback of the schedule from the plain loop's nin of
    each valid frame alone: a window misses at its first frame whose next
    frame's nin is not N."""
    f0, W, rounds, poor = 0, min(first, cap), 0, 0
    while f0 < len(nins):
        wlen = min(W, len(nins) - f0, nf - f0)
        miss = next((j for j in range(wlen - 1)
                     if nins[f0 + j + 1] != cfg.N), None)
        keep = wlen if miss is None else miss + 1
        rounds, f0 = rounds + 1, f0 + keep
        W = (min(max(2 * keep, K.SPEC_MIN_WINDOW), cap) if miss is not None
             else min(2 * W, cap))
        poor = poor + 1 if miss is not None and keep < K.SPEC_MIN_WINDOW else 0
        if poor >= K.SPEC_MAX_POOR:
            return rounds, True
    return rounds, False


def _generator(mode, frames, seed, ppm=0.0):
    """`frames` frames of flight traffic: back-to-back random-payload
    packets at 15 dB, resampled ppm parts per million fast (an SDR clock
    offset), through cu8 and back as a receiver reads them."""
    from wenet_tpu_torch.tools import captures
    cfg = GEOMETRIES[mode]
    rng = np.random.default_rng(seed)
    per_packet = len(captures.make_packet_bits(
        cfg, 1, np.random.default_rng(0), gap_bits=0, lead_bits=0,
        mode=mode))
    n_packets = -(-(frames + 60) * cfg.Nbits // per_packet)
    bits = captures.make_packet_bits(cfg, n_packets, rng, gap_bits=0,
                                     lead_bits=0, mode=mode)
    sig, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    if ppm:
        sig = channel.resample_linear(sig, 1 + ppm * 1e-6)
    iq = channel.add_awgn(sig, 15.0, cfg.Fs, cfg.Rs, rng=rng)
    raw = fsk.iq_to_cu8(iq).reshape(-1, 2).astype(np.float32) - 127.0
    iq = (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64) / np.float32(128)
    return iq[: frames * cfg.N]


def _noise(cfg, frames, seed):
    rng = np.random.default_rng(seed)
    n = frames * cfg.N
    return (rng.normal(0, 0.3, n) + 1j * rng.normal(0, 0.3, n)).astype(
        np.complex64)


def _assert_schedule_equals_plain(cfg, iq, nf, got, state=None, n_valid=None):
    st, out = got[:2]
    want_st, want = fsk.demod_stream_reference(
        cfg, torch.from_numpy(iq), nf, state, n_valid)
    v = want.valid
    assert torch.equal(out.valid, v)
    for name in fsk.FrameOut._fields:
        a, b = getattr(out, name)[v], getattr(want, name)[v]
        assert torch.equal(a.view(torch.uint8) if a.is_floating_point()
                           else a, b.view(torch.uint8)
                           if b.is_floating_point() else b), name
    for name, a, b in zip(fsk.DemodState._fields, st, want_st):
        assert torch.equal(a, b), name
    return want


# (traffic, frames, first window, window cap): the generator's traffic in
# one window after acquisition; drifting 60 ppm fast and slow in windows of
# 48 frames, several of which hold a slip; noise alone
SCHEDULE_CASES = {
    "v2_generator": ("v2", 0.0, 220, K.SPEC_FIRST_WINDOW, K.SPEC_WINDOW),
    "v1_generator": ("v1", 0.0, 220, K.SPEC_FIRST_WINDOW, K.SPEC_WINDOW),
    "v2_fast_60ppm": ("v2", 60.0, 420, 48, 48),
    "v2_slow_60ppm": ("v2", -60.0, 420, 48, 48),
    "v2_noise": ("v2", None, 90, K.SPEC_FIRST_WINDOW, K.SPEC_WINDOW),
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_frame_parallel_schedule_equals_the_plain_loop(case):
    """The schedule, bit for bit the plain loop on every valid frame's
    outputs and in the final state, with the rounds and the fallback that
    the plain loop's own nin sequence predicts: the generator's traffic
    misses only in acquisition, drift misses at its slips and goes on,
    noise falls back to the lane path."""
    mode, ppm, frames, first, cap = SCHEDULE_CASES[case]
    cfg = GEOMETRIES[mode]
    iq = (_noise(cfg, frames, 7) if ppm is None
          else _generator(mode, frames, 5 + frames, ppm))
    nf = cfg.num_frames(len(iq))
    got = emulate_frame_parallel(cfg, iq, nf, first=first, cap=cap)
    want = _assert_schedule_equals_plain(cfg, iq, nf, got)
    nins = want.nin[want.valid].tolist()
    assert got[2:4] == _predicted_rounds(cfg, nins, first, min(cap, nf), nf)
    rounds, fell, windows = got[2:]
    if ppm is None:
        assert fell and rounds == K.SPEC_MAX_POOR
    else:
        assert not fell and sum(k for _, _, k in windows) == len(nins)
        changes = sum(a != b for a, b in zip(nins, nins[1:]))
        assert changes > 0
    if ppm:
        slips = [w for w in windows if w[2] < w[1]]
        assert len(windows) >= 8 and len(slips) >= 2


def test_frame_parallel_schedule_over_carried_pushes():
    """Noise, then the generator's traffic, then noise, in pushes of 70
    frames with the state carried (a launch each, as the receiver's): the
    frames of the pushes are the plain loop's over the whole stream, the
    noise pushes fall back and the traffic's keep to the frame-parallel
    path."""
    cfg = GEOMETRIES["v2"]
    iq = np.concatenate([_noise(cfg, 45, 8), _generator("v2", 190, 9),
                         _noise(cfg, 45, 10)])
    push = 70 * cfg.N
    st, frames, verdicts = None, [], []
    for end in range(push, len(iq) + push, push):
        n_valid = min(end, len(iq))
        got = emulate_frame_parallel(cfg, iq, 80, st, n_valid)
        st, out = got[:2]
        frames.append(fsk.FrameOut(*(t[out.valid] for t in out)))
        verdicts.append(got[3])
    nf = cfg.num_frames(len(iq))
    want_st, want = fsk.demod_stream_reference(cfg, torch.from_numpy(iq), nf)
    v = want.valid
    for k, name in enumerate(fsk.FrameOut._fields):
        joined = torch.cat([f[k] for f in frames])
        assert torch.equal(joined, getattr(want, name)[v]), name
    for a, b in zip(st, want_st):
        assert torch.equal(a, b)
    assert verdicts[0] and not verdicts[1] and not verdicts[2]


def _mod_two_pi_kernel(x):
    """mod_two_pi's short path in exact arithmetic (numpy float32 for its
    float32 products, fractions for the fmaf remainders, which are exact
    for the right quotient and only compared otherwise)."""
    from fractions import Fraction
    y = np.float32(fsk.TWO_PI)
    ax = np.float32(abs(x))
    q = np.trunc(np.float32(ax * np.float32(np.float32(1) / y)))
    rem = [Fraction(float(ax)) - Fraction(float(k)) * Fraction(float(y))
           for k in (q, q - 1, q + 1)]
    r0 = rem[0]
    r = rem[1] if r0 < 0 else (rem[2] if r0 >= Fraction(float(y)) else r0)
    r = np.float32(float(r))
    r = np.float32(-r) if x < 0 or (x == 0 and np.signbit(x)) else r
    if r != 0 and r < 0:
        r = np.float32(r + y)
    return r


def test_mod_two_pi_short_path_is_the_floor_mod():
    """The phase chain's floor-mod without fmodf's loop: the truncated
    quotient from |x| / two_pi's reciprocal, corrected by one either way,
    gives bit for bit jnp.mod's fmod-then-add on float32 phases of both
    signs, next to the multiples of two_pi and up to 2^20."""
    rng = np.random.default_rng(3)
    y = np.float32(fsk.TWO_PI)
    k = rng.integers(-2000, 2000, 400).astype(np.float32)
    near = (k * y).astype(np.float32)
    xs = np.concatenate([
        rng.uniform(-4000, 4000, 600).astype(np.float32), near,
        np.nextafter(near, np.float32(np.inf)),
        np.nextafter(near, np.float32(-np.inf)),
        np.float32([0.0, -0.0, 1e-30, -1e-30, 1048575.0, -1048575.0, y, -y])])
    want = fsk._fmod_floor(torch.from_numpy(xs), float(y)).numpy()
    got = np.array([_mod_two_pi_kernel(x) for x in xs], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_schedule_constants_mirror_the_kernel():
    """The wrapper's copies of the schedule's constants, which the
    emulation above runs with, are the kernel's #defines."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                            "fsk_demod.cu")).read()
    for name in ("SPEC_FIRST_WINDOW", "SPEC_MIN_WINDOW", "SPEC_MAX_POOR"):
        m = re.search(rf"^#define {name} (\d+)", src, re.M)
        assert m and int(m[1]) == getattr(K, name), name
