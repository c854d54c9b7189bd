"""A small baseline JPEG encoder, in NumPy: JFIF, YCbCr 4:2:0, the standard
quantisation tables of ITU-T T.81 Annex K scaled to a quality as the IJG
library scales them, the Annex K Huffman tables, one interleaved scan, no
restart markers.  That is how the BKAI polyp frames are shipped; the
benchmark writes them so that the loader's baseline JPEG decoder does the
work it does on the real files.

Every step is vectorised: the colour transform, the 8 x 8 DCT as two matrix
products, quantisation, and the entropy coder (run lengths and categories
of all blocks at once, each Huffman code and its extra bits as one
variable-length word, the words unpacked to bits and packed to bytes)."""

from __future__ import annotations

import struct

import numpy as np

#: zigzag position -> natural (row-major) index
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
                   41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
                   15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
                   62, 63])

LUMA_Q = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                   14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                   18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                   49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66,
                                                          24, 26, 56, 47, 66]

_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1"
    "f02433627282090a161718191a25262728292a3435363738393a4344454647"
    "48494a535455565758595a636465666768696a737475767778797a83848586"
    "8788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9ba"
    "c2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3"
    "f4f5f6f7f8f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352"
    "f0156272d10a162434e125f11718191a262728292a35363738393a43444546"
    "4748494a535455565758595a636465666768696a737475767778797a828384"
    "85868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8"
    "b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3"
    "f4f5f6f7f8f9fa")
#: (class, id) -> (counts of codes of length 1..16, symbols)
HUFFMAN = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], _AC_LUMA_VALS),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _AC_CHROMA_VALS),
}


def _code_table(counts, symbols):
    """Canonical Huffman codes: ``(code, length)`` arrays indexed by symbol."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n_bits, n in enumerate(counts, start=1):
        for _ in range(n):
            code[symbols[k]] = c
            length[symbols[k]] = n_bits
            c += 1
            k += 1
        c <<= 1
    return code, length


_TABLES = {key: _code_table(*v) for key, v in HUFFMAN.items()}


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``base`` scaled to ``quality`` (1-100) as the IJG library does."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """``(H, W)`` plane (multiples of 8) -> ``(H/8, W/8, 8, 8)`` blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _category(v: np.ndarray):
    """JPEG's magnitude category of each value and its extra bits."""
    a = np.abs(v)
    s = np.zeros_like(a)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    extra = np.where(v >= 0, v, v + (1 << s) - 1)
    return s, extra


def _scan(ycc: np.ndarray, qy: np.ndarray, qc: np.ndarray):
    """The quantised zigzag coefficients of every block in scan order
    ``(N, 64)`` and each block's component (0 Y, 1 Cb, 2 Cr)."""
    H, W = ycc.shape[:2]
    y = _blocks(ycc[..., 0] - 128.0)                       # (H/8, W/8, 8, 8)
    sub = ycc[..., 1:].reshape(H // 2, 2, W // 2, 2, 2).mean((1, 3)) - 128.0
    cb, cr = _blocks(sub[..., 0]), _blocks(sub[..., 1])
    my, mx = H // 16, W // 16
    # four Y blocks of each 16 x 16 MCU, row by row, then its Cb and its Cr
    y = y.reshape(my, 2, mx, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5).reshape(my, mx, 4, 8, 8)
    mcu = np.concatenate([y, cb[:, :, None], cr[:, :, None]], 2).reshape(-1, 8, 8)
    coef = _DCT @ mcu @ _DCT.T
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    q = np.where(comp[:, None] == 0, qy[None, :], qc[None, :]).reshape(-1, 8, 8)
    quant = np.round(coef / q).astype(np.int64).reshape(-1, 64)
    return quant[:, ZIGZAG], comp


def _entropy_code(zz: np.ndarray, comp: np.ndarray) -> bytes:
    """Huffman-code the blocks ``zz (N, 64)`` in order; byte-stuffed."""
    N = zz.shape[0]
    table = (comp > 0).astype(np.int64)                    # 0 luma, 1 chroma tables
    dc = zz[:, 0].copy()
    diff = np.empty_like(dc)
    for c in range(3):
        idx = np.nonzero(comp == c)[0]
        d = dc[idx]
        diff[idx] = d - np.concatenate([[0], d[:-1]])
    s, extra = _category(diff)
    dc_code = np.where(table == 0, _TABLES[(0, 0)][0][s], _TABLES[(0, 1)][0][s])
    dc_len = np.where(table == 0, _TABLES[(0, 0)][1][s], _TABLES[(0, 1)][1][s])
    keys = [np.arange(N) * 1024]
    words = [(dc_code << s) | extra]
    lens = [dc_len + s]

    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    s, extra = _category(v)
    sym = ((run % 16) << 4) | s
    tb = table[b]
    ac_code = np.where(tb == 0, _TABLES[(1, 0)][0][sym], _TABLES[(1, 1)][0][sym])
    ac_len = np.where(tb == 0, _TABLES[(1, 0)][1][sym], _TABLES[(1, 1)][1][sym])
    keys.append(b * 1024 + 1 + k * 4 + 3)
    words.append((ac_code << s) | extra)
    lens.append(ac_len + s)
    for j in range(3):                                      # ZRL: 16 zeros each
        z = run // 16 > j
        keys.append(b[z] * 1024 + 1 + k[z] * 4 + j)
        words.append(np.where(tb[z] == 0, _TABLES[(1, 0)][0][0xF0], _TABLES[(1, 1)][0][0xF0]))
        lens.append(np.where(tb[z] == 0, _TABLES[(1, 0)][1][0xF0], _TABLES[(1, 1)][1][0xF0]))
    last = np.zeros(N, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 1024 + 1023)
    words.append(np.where(table[eob] == 0, _TABLES[(1, 0)][0][0], _TABLES[(1, 1)][0][0]))
    lens.append(np.where(table[eob] == 0, _TABLES[(1, 0)][1][0], _TABLES[(1, 1)][1][0]))

    order = np.argsort(np.concatenate(keys), kind="stable")
    words = np.concatenate(words)[order]
    lens = np.concatenate(lens)[order]
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    j = np.arange(int(lens.sum())) - np.repeat(start, lens)
    bits = (np.repeat(words, lens) >> (np.repeat(lens, lens) - 1 - j)) & 1
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.int64)])   # pad with 1 bits
    data = np.packbits(bits.astype(np.uint8))
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """``img (H, W, 3)`` uint8 RGB as a baseline JFIF JPEG, YCbCr 4:2:0."""
    h, w = img.shape[:2]
    H, W = -(-h // 16) * 16, -(-w // 16) * 16
    rgb = np.pad(img.astype(np.float64), ((0, H - h), (0, W - w), (0, 0)), mode="edge")
    m = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                  [0.5, -0.418688, -0.081312]])
    ycc = rgb @ m.T + [0.0, 128.0, 128.0]
    qy, qc = quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)
    zz, comp = _scan(ycc, qy, qc)
    out = b"\xff\xd8" + _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xFFDB, b"\x00" + bytes(qy[ZIGZAG].tolist())
                    + b"\x01" + bytes(qc[ZIGZAG].tolist()))
    out += _segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1,
                                                                      3, 0x11, 1]))
    for (cls, tid), (counts, symbols) in HUFFMAN.items():
        out += _segment(0xFFC4, bytes([cls << 4 | tid]) + bytes(counts) + symbols)
    out += _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + _entropy_code(zz, comp) + b"\xff\xd9"
