"""Reed-Solomon (255,223) over GF(2^8) — the FEC used by SSDV type-0x66
packets (fsphil/ssdv vendors Phil Karn's fixed 8-bit rs8 code: symbol size
8, field polynomial 0x187, first consecutive root 112, primitive element
alpha^11, 32 roots).  Systematic: 223 data bytes -> 32 parity bytes.

Pure numpy table-driven implementation: encode, syndrome check, and full
Berlekamp-Massey + Chien + Forney error correction (up to 16 byte errors).
Wenet itself runs SSDV in no-FEC mode (`ssdv -e -n`) under the outer LDPC,
so this exists for interop with standard SSDV streams, not the hot path.
"""
from __future__ import annotations

import numpy as np

MM = 8                    # symbol bits
NN = 255                  # codeword length
NROOTS = 32               # parity symbols
KK = NN - NROOTS          # data symbols (223)
FCR = 112                 # first consecutive root
PRIM = 11                 # primitive element exponent
GFPOLY = 0x187            # x^8 + x^7 + x^2 + x + 1


def _build_tables():
    alpha_to = np.zeros(NN + 1, np.int32)   # index -> polynomial
    index_of = np.zeros(NN + 1, np.int32)   # polynomial -> index
    index_of[0] = NN                        # log(0) sentinel = NN
    alpha_to[NN] = 0
    sr = 1
    for i in range(NN):
        index_of[sr] = i
        alpha_to[i] = sr
        sr <<= 1
        if sr & 0x100:
            sr ^= GFPOLY
        sr &= 0xFF
    # iprim: inverse of PRIM mod NN (for root -> location mapping)
    iprim = next(i for i in range(1, NN + 1) if (i * PRIM) % NN == 1)
    # generator polynomial: roots alpha^(PRIM*(FCR+i)), i = 0..NROOTS-1
    genpoly = np.zeros(NROOTS + 1, np.int32)
    genpoly[0] = 1
    root = FCR * PRIM
    for i in range(NROOTS):
        genpoly[i + 1] = 1
        for j in range(i, 0, -1):
            if genpoly[j]:
                genpoly[j] = genpoly[j - 1] ^ alpha_to[
                    (index_of[genpoly[j]] + root) % NN]
            else:
                genpoly[j] = genpoly[j - 1]
        genpoly[0] = alpha_to[(index_of[genpoly[0]] + root) % NN]
        root += PRIM
    # store generator as indices (all coefficients nonzero)
    return alpha_to, index_of, index_of[genpoly].copy(), iprim


ALPHA, INDEX, GENPOLY_IDX, IPRIM = _build_tables()


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(ALPHA[(INDEX[a] + INDEX[b]) % NN])


def encode(data: bytes) -> bytes:
    """223 data bytes -> 32 parity bytes (KA9Q encode_rs_8 semantics:
    LFSR division of data*x^NROOTS by the generator polynomial)."""
    if len(data) != KK:
        raise ValueError(f"RS(255,223) needs {KK} data bytes")
    par = np.zeros(NROOTS, np.int32)
    for d in data:
        fb = int(INDEX[d ^ int(par[0])])
        par[:-1] = par[1:]
        par[-1] = 0
        if fb != NN:
            for j in range(NROOTS):
                par[j] ^= ALPHA[(fb + GENPOLY_IDX[NROOTS - 1 - j]) % NN]
    return bytes(int(x) for x in par)


def syndromes(codeword: bytes) -> np.ndarray:
    """32 syndromes of a full 255-byte codeword (data+parity); all zero
    iff the codeword is valid."""
    cw = np.frombuffer(bytes(codeword), np.uint8).astype(np.int32)
    if len(cw) != NN:
        raise ValueError("syndromes need the full 255-byte codeword")
    syn = np.zeros(NROOTS, np.int32)
    for i in range(NROOTS):
        root = (FCR + i) * PRIM % NN
        s = 0
        for c in cw:
            s = _gf_mul(s, int(ALPHA[root])) ^ int(c)
        syn[i] = s
    return syn


def check(codeword: bytes) -> bool:
    return not syndromes(codeword).any()


def correct(codeword: bytes):
    """Correct up to 16 byte errors in a 255-byte codeword.

    Returns (corrected bytes, n_errors) or (None, -1) if uncorrectable.
    Berlekamp-Massey -> Chien search -> Forney, mirroring KA9Q decode_rs.
    """
    cw = bytearray(codeword)
    syn = syndromes(cw)
    if not syn.any():
        return bytes(cw), 0
    s_idx = [int(INDEX[s]) for s in syn]          # NN == log(0)

    # Berlekamp-Massey
    lam = [0] * (NROOTS + 1)
    b = [0] * (NROOTS + 1)
    lam[0] = b[0] = 1
    L = 0
    for r in range(NROOTS):
        # discrepancy
        d = 0
        for i in range(L + 1):
            if lam[i] and s_idx[r - i] != NN:
                d ^= int(ALPHA[(INDEX[lam[i]] + s_idx[r - i]) % NN])
        if d == 0:
            b = [0] + b[:-1]
        else:
            t = lam[:]
            di = int(INDEX[d])
            for i in range(NROOTS):
                if b[i]:
                    t[i + 1] ^= int(ALPHA[(di + INDEX[b[i]]) % NN])
            if 2 * L <= r:
                L = r + 1 - L
                dinv = (NN - di) % NN
                b = [(_gf_mul(c, int(ALPHA[dinv])) if c else 0) for c in lam]
                lam = t
            else:
                lam = t
                b = [0] + b[:-1]
    deg = max(i for i in range(NROOTS + 1) if lam[i]) if any(lam) else 0
    if deg != L or L > NROOTS // 2:
        return None, -1

    # Chien search: roots of lambda -> error locations
    locs = []
    for i in range(NN):
        # evaluate lambda at alpha^{-i·?}: try X = alpha^i as root of
        # lambda(x); error locator roots are X_j^{-1}
        v = 0
        for j in range(deg + 1):
            if lam[j]:
                v ^= int(ALPHA[(INDEX[lam[j]] + j * i) % NN])
        if v == 0:
            # root at alpha^i => error locator X = alpha^{-i}; polynomial
            # degree d satisfies alpha^{prim*d} = X => d = (-i*iprim) mod NN;
            # byte position (cw[0] is the x^254 coefficient) = NN-1-d
            d = (NN - i) * IPRIM % NN
            locs.append((i, NN - 1 - d))
    if len(locs) != L:
        return None, -1

    # Forney: omega(x) = [syn(x) * lambda(x)] mod x^NROOTS
    omega = [0] * NROOTS
    for i in range(NROOTS):
        v = 0
        for j in range(min(i, deg) + 1):
            if lam[j] and s_idx[i - j] != NN:
                v ^= int(ALPHA[(INDEX[lam[j]] + s_idx[i - j]) % NN])
        omega[i] = v
    for i_root, p in locs:
        xinv = int(ALPHA[i_root])                # X^{-1} = alpha^{i_root}
        # numerator: omega(X^{-1}) * X^{FCR*?}; follow KA9Q: err =
        # X^{1-FCR} * omega(X^{-1}) / lambda'(X^{-1})
        num = 0
        for j in range(NROOTS):
            if omega[j]:
                num ^= int(ALPHA[(INDEX[omega[j]] + j * i_root) % NN])
        if num == 0:
            continue
        # X^{1-FCR} where X = alpha^{-i_root}
        xexp = (NN - i_root) % NN                # log X
        num = _gf_mul(num, int(ALPHA[(xexp * (1 - FCR)) % NN]))
        # lambda'(X^{-1}): odd-power terms
        den = 0
        for j in range(1, deg + 1, 2):
            if lam[j]:
                den ^= int(ALPHA[(INDEX[lam[j]] + (j - 1) * i_root) % NN])
        if den == 0:
            return None, -1
        mag = _gf_mul(num, int(ALPHA[(NN - INDEX[den]) % NN]))
        cw[p] ^= mag
    if syndromes(cw).any():
        return None, -1
    return bytes(cw), L
