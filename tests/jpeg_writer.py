"""A JPEG writer for the codings Pillow cannot write, for the decoder tests.

Pillow writes sequential and progressive Huffman JPEG with its own
component ids, JFIF or Adobe segments and sampling factors. This module
writes the rest from quantised DCT coefficients (or, for lossless, from
samples), so that Pillow can decode them as the oracle:
- sequential Huffman coding with the standard tables of ITU-T T.81 Annex K
  (any component ids, sampling factors 1-4, 1, 3 or 4 components);
- arithmetic coding, sequential (SOF9) and progressive (SOF10), with DAC
  conditioning and restart intervals: jcarith.c's encoder over T.81
  Table D.2;
- lossless (SOF3): predictors 1-7, the point transform, restart intervals
  of whole rows, interleaved or one scan a component;
- a JFIF or an Adobe APP14 segment (any transform), or neither.

read_coefficients() reads the coefficients back out of a sequential
Huffman JPEG (Pillow's files), so that the same coefficients can be
written in another coding; dct_coefficients() makes them from sample
planes. The same coefficients written with Huffman and with arithmetic
coding decode to the same pixels under Pillow (the test of the writer
itself).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# zig-zag position -> natural index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# T.81 Annex K.3: (code counts by length 1-16, symbols)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282"
    "090a161718191a25262728292a3435363738393a434445464748494a535455565758595a63"
    "6465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6"
    "a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6"
    "e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a"
    "162434e125f11718191a262728292a35363738393a434445464748494a535455565758595a"
    "636465666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4"
    "a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5"
    "e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))

# T.81 Annex K.1 quantization tables, natural order
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)


def scaled_quant(table: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c's quality scaling of a base table (1..255 entries)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((table * scale + 50) // 100, 1, 255).astype(np.int64)


@dataclass
class Component:
    id: int
    h: int
    v: int
    tq: int
    td: int = 0   # DC (or lossless) table: Huffman table, or arithmetic conditioning
    ta: int = 0   # AC table


@dataclass
class Frame:
    """What a DCT JPEG holds: size, components, quantization tables
    (natural order) and each component's quantised coefficients
    [blocks_h, blocks_w, 64] in natural order, whole MCUs."""
    width: int
    height: int
    components: List[Component]
    quant: Dict[int, np.ndarray]
    coefs: List[np.ndarray] = field(default_factory=list)

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.components)

    def mcus(self) -> Tuple[int, int]:
        return (-(-self.width // (8 * self.hmax)), -(-self.height // (8 * self.vmax)))

    def comp_size(self, c: Component) -> Tuple[int, int]:
        """(width, height) in blocks that carry image data (jdinput.c)."""
        w = -(-self.width * c.h // self.hmax)
        h = -(-self.height * c.v // self.vmax)
        return -(-w // 8), -(-h // 8)


# ------------------------------------------------------------ coefficients

def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


def dct_coefficients(planes: Sequence[np.ndarray], frame: Frame) -> Frame:
    """frame with coefs from one full-size [H, W] plane a component: each
    plane box-averaged to its sampling factors, edge-padded to whole MCUs,
    through a float DCT and the frame's quantization tables (rounded)."""
    m = _dct_matrix()
    mx, my = frame.mcus()
    frame.coefs = []
    for plane, c in zip(planes, frame.components):
        fh, fv = frame.hmax // c.h, frame.vmax // c.v
        p = np.asarray(plane, np.float64)
        ph, pw = -(-p.shape[0] // fv) * fv, -(-p.shape[1] // fh) * fh
        p = np.pad(p, ((0, ph - p.shape[0]), (0, pw - p.shape[1])), mode="edge")
        p = p.reshape(ph // fv, fv, pw // fh, fh).mean(axis=(1, 3))
        bh, bw = my * c.v, mx * c.h
        p = np.pad(p, ((0, max(0, 8 * bh - p.shape[0])), (0, max(0, 8 * bw - p.shape[1]))),
                   mode="edge")[:8 * bh, :8 * bw] - 128
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        f = m @ blocks @ m.T
        q = frame.quant[c.tq].reshape(8, 8)
        frame.coefs.append(np.clip(np.round(f / q), -1023, 1023).astype(np.int64)
                           .reshape(bh, bw, 64))
    return frame


def rgb_to_ycc(rgb: np.ndarray) -> List[np.ndarray]:
    """JFIF's YCbCr planes of [H, W, 3] uint8 (float, unrounded)."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    return [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


# ------------------------------------------------------------------ read

def _segments(data: bytes):
    """(marker, payload, the entropy-coded data after it for SOS, else
    None) for each segment up to EOI."""
    pos = 2
    while pos < len(data):
        while data[pos + 1] == 0xFF:
            pos += 1
        marker = data[pos + 1]
        if marker == 0xD9:
            return
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        end = pos + 2 + length
        payload = data[pos + 4:end]
        if marker == 0xDA:
            scan_end = end
            while not (data[scan_end] == 0xFF and data[scan_end + 1] not in (0, 0xFF)
                       and not 0xD0 <= data[scan_end + 1] <= 0xD7):
                scan_end += 1
            yield marker, payload, data[end:scan_end]
            pos = scan_end
        else:
            yield marker, payload, None
            pos = end


def _huffman_lookup(counts, symbols) -> Dict[Tuple[int, int], int]:
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            table[(length, code)] = symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return table


def _unstuffed_bits(entropy: bytes) -> str:
    """The scan's bits as a string of '0'/'1', stuffed zeros and restart
    markers dropped."""
    out, i = bytearray(), 0
    while i < len(entropy):
        b = entropy[i]
        if b == 0xFF:
            if entropy[i + 1] == 0:
                out.append(0xFF)
            i += 2   # FF00, or an RSTn (this reader does not read restarts)
            continue
        out.append(b)
        i += 1
    return "".join(f"{b:08b}" for b in out)


def read_coefficients(data: bytes) -> Frame:
    """The frame and quantised coefficients of a sequential Huffman JPEG
    (SOF0/SOF1, one interleaved scan or one scan a component, no restart
    intervals), as Pillow writes them."""
    quant, dc, ac, frame = {}, {}, {}, None
    for marker, payload, entropy in _segments(data):
        if marker == 0xDB:
            i = 0
            while i < len(payload):
                pq, tq = payload[i] >> 4, payload[i] & 15
                n = 128 if pq else 64
                vals = (np.frombuffer(payload[i + 1:i + 1 + n], ">u2") if pq
                        else np.frombuffer(payload[i + 1:i + 1 + n], np.uint8))
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                quant[tq] = table
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(payload):
                tc, th = payload[i] >> 4, payload[i] & 15
                counts = list(payload[i + 1:i + 17])
                n = sum(counts)
                (ac if tc else dc)[th] = _huffman_lookup(counts, list(payload[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker == 0xDD and struct.unpack(">H", payload)[0]:
            raise ValueError("read_coefficients does not read restart intervals")
        elif marker in (0xC0, 0xC1):
            height, width = struct.unpack(">HH", payload[1:5])
            comps = [Component(payload[6 + 3 * i], payload[7 + 3 * i] >> 4,
                               payload[7 + 3 * i] & 15, payload[8 + 3 * i])
                     for i in range(payload[5])]
            frame = Frame(width, height, comps, quant)
            mx, my = frame.mcus()
            frame.coefs = [np.zeros((my * c.v, mx * c.h, 64), np.int64) for c in comps]
        elif marker in range(0xC2, 0xD0) and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"read_coefficients reads sequential Huffman JPEG, not SOF{marker - 0xC0}")
        elif marker == 0xDA:
            _read_scan(frame, payload, entropy, dc, ac)
    return frame


def _read_scan(frame: Frame, payload: bytes, entropy: bytes, dc, ac) -> None:
    ns = payload[0]
    scan = []
    for i in range(ns):
        cid, t = payload[1 + 2 * i], payload[2 + 2 * i]
        ci = next(j for j, c in enumerate(frame.components) if c.id == cid)
        scan.append((ci, dc[t >> 4], ac[t & 15]))
    bits, pos = _unstuffed_bits(entropy), 0

    def symbol(table):
        nonlocal pos
        for length in range(1, 17):
            s = table.get((length, int(bits[pos:pos + length], 2)))
            if s is not None:
                pos += length
                return s
        raise ValueError("bad Huffman code")

    def value(size):
        nonlocal pos
        if size == 0:
            return 0
        v = int(bits[pos:pos + size], 2)
        pos += size
        return v if v >= 1 << (size - 1) else v - (1 << size) + 1

    pred = [0] * ns

    def block(k, dct, act, out):
        pred[k] += value(symbol(dct))
        out[0] = pred[k]
        i = 1
        while i < 64:
            rs = symbol(act)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r != 15:
                    break
                i += 16
                continue
            i += r
            out[ZIGZAG[i]] = value(s)
            i += 1

    mx, my = frame.mcus()
    if ns == 1:
        ci, dct, act = scan[0]
        bw, bh = frame.comp_size(frame.components[ci])
        for by in range(bh):
            for bx in range(bw):
                block(0, dct, act, frame.coefs[ci][by, bx])
        return
    for y in range(my):
        for x in range(mx):
            for k, (ci, dct, act) in enumerate(scan):
                c = frame.components[ci]
                for v in range(c.v):
                    for h in range(c.h):
                        block(k, dct, act, frame.coefs[ci][y * c.v + v, x * c.h + h])


# ----------------------------------------------------------------- write

def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe_segment(transform: int) -> bytes:
    """APP14 'Adobe', version 100, flags 0, the colour transform."""
    return _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))


def _header(frame: Frame, sof: int, markers: bytes, tables: bytes, restart: int,
            precision: int = 8) -> bytes:
    out = [b"\xff\xd8", markers]
    if sof != 0xC3:
        for tq in sorted({c.tq for c in frame.components}):
            out.append(_segment(0xDB, bytes([tq]) + bytes(frame.quant[tq][ZIGZAG].astype(np.uint8))))
    sof_payload = struct.pack(">BHHB", precision, frame.height, frame.width, len(frame.components))
    for c in frame.components:
        sof_payload += bytes([c.id, (c.h << 4) | c.v, c.tq])
    out.append(_segment(sof, sof_payload))
    out.append(tables)
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    return b"".join(out)


def _sos(frame: Frame, comps: Sequence[int], ss: int, se: int, ah: int, al: int) -> bytes:
    payload = bytes([len(comps)])
    for ci in comps:
        c = frame.components[ci]
        payload += bytes([c.id, (c.td << 4) | c.ta])
    return _segment(0xDA, payload + bytes([ss, se, (ah << 4) | al]))


def _dht(tc: int, th: int, table) -> bytes:
    counts, symbols = table
    return _segment(0xC4, bytes([(tc << 4) | th]) + bytes(counts) + bytes(symbols))


class BitWriter:
    """Huffman-coded data: bits high first, 0xFF stuffed with 0x00, the last
    byte padded with ones."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out = bytes(self.out)
        self.out = bytearray()
        return out


def _huffman_codes(table) -> Dict[int, Tuple[int, int]]:
    return {s: (code, length) for (length, code), s in _huffman_lookup(*table).items()}


def _category(v: int) -> int:
    return abs(int(v)).bit_length()


def _put_value(bw: BitWriter, v: int, size: int) -> None:
    if size:
        bw.put(v if v >= 0 else v + (1 << size) - 1, size)


def _mcu_blocks(frame: Frame, comps: Sequence[int]):
    """The blocks a scan codes, MCU by MCU: [(component index, (by, bx)), ...]
    per MCU; one block an MCU in a one-component scan."""
    if len(comps) == 1:
        c = frame.components[comps[0]]
        bw, bh = frame.comp_size(c)
        return [[(comps[0], (by, bx))] for by in range(bh) for bx in range(bw)]
    mx, my = frame.mcus()
    mcus = []
    for y in range(my):
        for x in range(mx):
            mcu = []
            for ci in comps:
                c = frame.components[ci]
                mcu += [(ci, (y * c.v + v, x * c.h + h)) for v in range(c.v) for h in range(c.h)]
            mcus.append(mcu)
    return mcus


def _restart_segments(mcus, restart: int):
    """The scan's MCUs in restart intervals (one interval without restarts)."""
    if not restart:
        return [mcus]
    return [mcus[i:i + restart] for i in range(0, len(mcus), restart)]


def _join_intervals(parts: List[bytes]) -> bytes:
    out = bytearray(parts[0])
    for i, part in enumerate(parts[1:]):
        out += bytes([0xFF, 0xD0 + (i & 7)]) + part
    return bytes(out)


def write_huffman(frame: Frame, *, markers: bytes = JFIF, restart: int = 0,
                  interleaved: bool = True) -> bytes:
    """A sequential Huffman JPEG (SOF0) of frame.coefs with the Annex K
    tables (component 0 luma tables, the others chroma): one interleaved
    scan, or one scan a component."""
    comps = frame.components
    for i, c in enumerate(comps):
        c.td = c.ta = 0 if i == 0 else 1
    tables = _dht(0, 0, DC_LUMA) + _dht(1, 0, AC_LUMA)
    if len(comps) > 1:
        tables += _dht(0, 1, DC_CHROMA) + _dht(1, 1, AC_CHROMA)
    codes = {(0, 0): _huffman_codes(DC_LUMA), (1, 0): _huffman_codes(AC_LUMA),
             (0, 1): _huffman_codes(DC_CHROMA), (1, 1): _huffman_codes(AC_CHROMA)}
    out = [_header(frame, 0xC0, markers, tables, restart)]
    scans = [list(range(len(comps)))] if interleaved else [[i] for i in range(len(comps))]
    for scan in scans:
        parts = []
        for interval in _restart_segments(_mcu_blocks(frame, scan), restart):
            bw, pred = BitWriter(), {}
            for mcu in interval:
                for ci, (by, bx) in mcu:
                    c, blk = comps[ci], frame.coefs[ci][by, bx]
                    dcc, acc = codes[(0, c.td)], codes[(1, c.ta)]
                    diff = int(blk[0]) - pred.get(ci, 0)
                    pred[ci] = int(blk[0])
                    s = _category(diff)
                    bw.put(*dcc[s])
                    _put_value(bw, diff, s)
                    zz = blk[ZIGZAG]
                    nz = np.nonzero(zz[1:])[0]
                    run = 0
                    last = nz[-1] + 1 if len(nz) else 0
                    for k in range(1, last + 1):
                        v = int(zz[k])
                        if v == 0:
                            run += 1
                            continue
                        while run > 15:
                            bw.put(*acc[0xF0])
                            run -= 16
                        s = _category(v)
                        bw.put(*acc[(run << 4) | s])
                        _put_value(bw, v, s)
                        run = 0
                    if last < 63:
                        bw.put(*acc[0x00])
            parts.append(bw.flush())
        out.append(_sos(frame, scan, 0, 63, 0, 0) + _join_intervals(parts))
    return b"".join(out) + b"\xff\xd9"


# ------------------------------------------------------------ arithmetic

# T.81 Table D.2: (Qe, next state after an LPS, after an MPS, MPS switch);
# the last entry is jaricom.c's fixed probability 0.5
QE_TABLE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


class ArithEncoder:
    """jcarith.c's arith_encode and finish_pass (T.81 D.1): a statistics
    bin is one byte of a bytearray, the MPS sense in bit 7."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte_out(self, temp: int) -> None:
        if temp > 0xFF:   # a carry into the bytes held back
            if self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe, nlps, nmps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nlps | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            b = (self.c >> 19) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


@dataclass
class Conditioning:
    """DAC conditioning of one table: DC bounds L, U; AC bound K."""
    L: int = 0
    U: int = 1
    K: int = 5


class _ArithScan:
    """One scan's arithmetic coding state (jcarith.c): statistics bins per
    table, DC predictions and contexts per component."""

    def __init__(self, frame: Frame, comps, cond: Dict[int, Conditioning]):
        self.frame, self.comps, self.cond = frame, comps, cond
        self.fixed = bytearray([113])

    def reset(self):
        """A new encoder and fresh statistics: the scan's start, or a
        restart."""
        self.enc = ArithEncoder()
        self.dc_stats = {self.frame.components[ci].td: bytearray(64) for ci in self.comps}
        self.ac_stats = {self.frame.components[ci].ta: bytearray(256) for ci in self.comps}
        self.last_dc = {ci: 0 for ci in self.comps}
        self.dc_ctx = {ci: 0 for ci in self.comps}

    def _dc_magnitude(self, stats: bytearray, s: int, v: int) -> None:
        """Figures F.8 and F.9 after a DC difference's sign: v - 1's
        magnitude category from bin s on (then from X1 = 20 on), and its
        bits."""
        enc = self.enc
        m, v = 0, v - 1
        if v:
            enc.encode(stats, s, 1)
            m, v2 = 1, v
            s = 20
            while v2 >> 1:
                v2 >>= 1
                enc.encode(stats, s, 1)
                m <<= 1
                s += 1
        enc.encode(stats, s, 0)
        s += 14
        m >>= 1
        while m:
            enc.encode(stats, s, 1 if m & v else 0)
            m >>= 1

    def dc(self, ci: int, value: int) -> None:
        c = self.frame.components[ci]
        stats, cond, enc = self.dc_stats[c.td], self.cond.get(c.td, Conditioning()), self.enc
        s = self.dc_ctx[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            enc.encode(stats, s, 0)
            self.dc_ctx[ci] = 0
            return
        self.last_dc[ci] = value
        enc.encode(stats, s, 1)
        if v > 0:
            enc.encode(stats, s + 1, 0)
            s += 2
            ctx = 4
        else:
            v = -v
            enc.encode(stats, s + 1, 1)
            s += 3
            ctx = 8
        m = 0
        if v - 1:
            m = 1 << ((v - 1).bit_length() - 1)
        if m < (1 << cond.L) >> 1:
            ctx = 0
        elif m > (1 << cond.U) >> 1:
            ctx += 8
        self.dc_ctx[ci] = ctx
        self._dc_magnitude(stats, s, v)

    def ac_first(self, ci: int, block: np.ndarray, ss: int, se: int, al: int) -> None:
        """Figure F.5 over ss..se of one block after the point transform al
        (sequential: 1..63, al 0)."""
        c = self.frame.components[ci]
        stats, cond, enc = self.ac_stats[c.ta], self.cond.get(c.ta, Conditioning()), self.enc
        zz = [int(block[ZIGZAG[k]]) for k in range(64)]
        vals = [(abs(v) >> al) * (1 if v >= 0 else -1) for v in zz]
        ke = 0
        for k in range(se, 0, -1):
            if vals[k]:
                ke = k
                break
        k = ss
        while k <= ke:
            s = 3 * (k - 1)
            enc.encode(stats, s, 0)   # not the end of the block
            while vals[k] == 0:
                enc.encode(stats, s + 1, 0)
                s += 3
                k += 1
            enc.encode(stats, s + 1, 1)
            v = vals[k]
            enc.encode(self.fixed, 0, 0 if v > 0 else 1)
            v = abs(v)
            s += 2
            m, v1 = 0, v - 1
            if v1:
                enc.encode(stats, s, 1)
                m, v2 = 1, v1
                if v2 >> 1:
                    v2 >>= 1
                    enc.encode(stats, s, 1)
                    m <<= 1
                    s = 189 if k <= cond.K else 217
                    while v2 >> 1:
                        v2 >>= 1
                        enc.encode(stats, s, 1)
                        m <<= 1
                        s += 1
            enc.encode(stats, s, 0)
            s += 14
            m >>= 1
            while m:
                enc.encode(stats, s, 1 if m & v1 else 0)
                m >>= 1
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)

    def ac_refine(self, ci: int, block: np.ndarray, ss: int, se: int, ah: int, al: int) -> None:
        """Figure G.10 over ss..se: bit al of each coefficient."""
        c = self.frame.components[ci]
        stats, enc = self.ac_stats[c.ta], self.enc
        zz = [abs(int(block[ZIGZAG[k]])) for k in range(64)]
        neg = [int(block[ZIGZAG[k]]) < 0 for k in range(64)]
        ke = next((k for k in range(se, 0, -1) if zz[k] >> al), 0)
        kex = next((k for k in range(ke, 0, -1) if zz[k] >> ah), 0)
        k = ss
        while k <= ke:
            s = 3 * (k - 1)
            if k > kex:
                enc.encode(stats, s, 0)
            while True:
                v = zz[k] >> al
                if v:
                    if v >> 1:
                        enc.encode(stats, s + 2, v & 1)
                    else:
                        enc.encode(stats, s + 1, 1)
                        enc.encode(self.fixed, 0, 1 if neg[k] else 0)
                    break
                enc.encode(stats, s + 1, 0)
                s += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)


def simple_progression(ncomp: int) -> List[Tuple[Tuple[int, ...], int, int, int, int]]:
    """jcparam.c:jpeg_simple_progression's script: (components, Ss, Se, Ah, Al)."""
    all_c = tuple(range(ncomp))
    if ncomp == 3:
        return [(all_c, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), (all_c, 0, 0, 1, 0),
                ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    one = [(c,) for c in all_c]
    return ([(all_c, 0, 0, 0, 1)] + [(c, 1, 5, 0, 2) for c in one] + [(c, 6, 63, 0, 2) for c in one]
            + [(c, 1, 63, 2, 1) for c in one] + [(all_c, 0, 0, 1, 0)]
            + [(c, 1, 63, 1, 0) for c in one])


def write_arithmetic(frame: Frame, *, progressive: bool = False, script=None,
                     markers: bytes = JFIF, restart: int = 0,
                     conditioning: Optional[Dict[int, Conditioning]] = None,
                     tables: Optional[Sequence[Tuple[int, int]]] = None) -> bytes:
    """An arithmetic-coded JPEG of frame.coefs: sequential (SOF9, one
    interleaved scan) or progressive (SOF10, script as simple_progression
    gives it, by default that one). tables: each component's (DC, AC)
    conditioning table ids (default 0 for component 0, 1 for the rest);
    conditioning: their DAC values, written in a DAC segment."""
    comps = frame.components
    for i, c in enumerate(comps):
        c.td, c.ta = tables[i] if tables else ((0, 0) if i == 0 else (1, 1))
    cond = conditioning or {}
    dac = b""
    for t, cd in sorted(cond.items()):
        dac += bytes([t, (cd.U << 4) | cd.L, 0x10 | t, cd.K])
    out = [_header(frame, 0xCA if progressive else 0xC9, markers,
                   _segment(0xCC, dac) if dac else b"", restart)]
    if not progressive:
        script = [(tuple(range(len(comps))), 0, 63, 0, 0)]
    elif script is None:
        script = simple_progression(len(comps))
    for scan_comps, ss, se, ah, al in script:
        coder = _ArithScan(frame, scan_comps, cond)
        parts = []
        for interval in _restart_segments(_mcu_blocks(frame, scan_comps), restart):
            coder.reset()
            for mcu in interval:
                for ci, (by, bx) in mcu:
                    blk = frame.coefs[ci][by, bx]
                    if not progressive:
                        coder.dc(ci, int(blk[0]))
                        coder.ac_first(ci, blk, 1, 63, 0)
                    elif ss == 0 and ah == 0:
                        coder.dc(ci, int(blk[0]) >> al)
                    elif ss == 0:
                        coder.enc.encode(coder.fixed, 0, (int(blk[0]) >> al) & 1)
                    elif ah == 0:
                        coder.ac_first(ci, blk, ss, se, al)
                    else:
                        coder.ac_refine(ci, blk, ss, se, ah, al)
            parts.append(coder.enc.finish())
        out.append(_sos(frame, scan_comps, ss, se, ah, al) + _join_intervals(parts))
    return b"".join(out) + b"\xff\xd9"


# -------------------------------------------------------------- lossless

def _predict(psv: int, ra, rb, rc):
    if psv == 1:
        return ra
    if psv == 2:
        return rb
    if psv == 3:
        return rc
    if psv == 4:
        return ra + rb - rc
    if psv == 5:
        return ra + ((rb - rc) >> 1)
    if psv == 6:
        return rb + ((ra - rc) >> 1)
    return (ra + rb) >> 1


def lossless_differences(samples: np.ndarray, psv: int, pt: int,
                         restart_rows: Sequence[int] = ()) -> np.ndarray:
    """jclossls.c's differences of one component's [h, w] samples after the
    point transform pt: predictor psv, the first row (and each row in
    restart_rows) from 2^(7 - pt) then its left neighbour, the first
    column from the sample above."""
    x = samples.astype(np.int64) >> pt
    h, w = x.shape
    pred = np.zeros_like(x)
    for y in range(h):
        if y == 0 or y in restart_rows:
            pred[y, 0] = 1 << (8 - pt - 1)
            pred[y, 1:] = x[y, :-1]
            continue
        pred[y, 0] = x[y - 1, 0]
        pred[y, 1:] = _predict(psv, x[y, :-1], x[y - 1, 1:], x[y - 1, :-1])
    return x - pred


def write_lossless(planes: Sequence[np.ndarray], ids: Sequence[int], *, psv: int = 1,
                   pt: int = 0, markers: bytes = b"", restart_rows: int = 0,
                   sampling: Optional[Sequence[Tuple[int, int]]] = None,
                   interleaved: bool = True) -> bytes:
    """A lossless Huffman JPEG (SOF3) of sample planes (each [h, w] uint8
    at its component's downsampled size, full size without sampling), the
    DC luminance table of Annex K for every component; restart_rows: a
    restart every so many MCU rows (libjpeg restarts in whole rows)."""
    sampling = sampling or [(1, 1)] * len(planes)
    comps = [Component(i, h, v, 0) for i, (h, v) in zip(ids, sampling)]
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    width = next(p.shape[1] for p, c in zip(planes, comps) if c.h == hmax)
    height = next(p.shape[0] for p, c in zip(planes, comps) if c.v == vmax)
    frame = Frame(width, height, comps, {})
    codes = _huffman_codes(DC_LUMA)
    mx, my = -(-width // hmax), -(-height // vmax)
    scans = [list(range(len(comps)))] if interleaved else [[i] for i in range(len(comps))]
    out = [_header(frame, 0xC3, markers, _dht(0, 0, DC_LUMA), 0)]
    for scan in scans:
        # every MCU row of the scan as (component, sample row, columns) cuts
        if len(scan) == 1:
            n_rows, per_row = planes[scan[0]].shape
        else:
            per_row, n_rows = mx, my
        rows_per = restart_rows or n_rows
        restart_mcu = per_row * restart_rows
        diffs = {}
        for ci in scan:
            c, p = comps[ci], planes[ci]
            # pad to whole MCUs: the padding is coded but never decoded
            full = np.pad(p, ((0, my * c.v - p.shape[0] if len(scan) > 1 else 0),
                              (0, mx * c.h - p.shape[1] if len(scan) > 1 else 0)), mode="edge")
            rows_per_mcu_row = c.v if len(scan) > 1 else 1
            restarts = [r * rows_per_mcu_row for r in range(rows_per, n_rows, rows_per)]
            diffs[ci] = lossless_differences(full, psv, pt, restarts)
        parts, bw = [], BitWriter()
        for r in range(n_rows):
            if r and restart_rows and r % restart_rows == 0:
                parts.append(bw.flush())
                bw = BitWriter()
            for x in range(per_row):
                for ci in scan:
                    c = comps[ci]
                    hh, vv = (c.h, c.v) if len(scan) > 1 else (1, 1)
                    for v in range(vv):
                        for h in range(hh):
                            d = int(diffs[ci][r * vv + v, x * hh + h])
                            s = _category(d)
                            bw.put(*codes[s])
                            _put_value(bw, d, s)
        parts.append(bw.flush())
        out.append(_segment(0xDD, struct.pack(">H", restart_mcu)) if restart_rows else b"")
        out.append(_sos(frame, scan, psv, 0, 0, pt) + _join_intervals(parts))
    return b"".join(out) + b"\xff\xd9"


def insert_segment(data: bytes, segment: bytes, *, replace_app0: bool = False) -> bytes:
    """data with segment after SOI, or in place of its APP0 segment."""
    if replace_app0:
        assert data[2:4] == b"\xff\xe0"
        end = 4 + struct.unpack(">H", data[4:6])[0]
        return data[:2] + segment + data[end:]
    return data[:2] + segment + data[2:]
