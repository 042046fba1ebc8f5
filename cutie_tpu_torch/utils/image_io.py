"""Image files for the eval harness, the training data, the scripts and the
GUI, without PIL or cv2.

The port's counterpart of every PIL.Image and cv2 still-image call in
cutie_tpu's readers, datasets, result saver, demos, scripts and GUI:
- a PNG codec in zlib and numpy. It reads every PNG layout, as Pillow
  opens it (read_png): grayscale, RGB, palette, grayscale-alpha and RGBA;
  palette and grayscale images also packed at 1, 2 or 4 bits; 16-bit
  samples (grayscale as mode 'I;16', the other types keep the high byte,
  grayscale-alpha opening as RGBA);
  all five row filters; Adam7 interlacing; and the tRNS transparency that
  convert('RGBA') honours (read_rgba). It writes 8-bit palette, grayscale,
  RGB and RGBA images (write_png);
- Pillow's BILINEAR and NEAREST resizes, bit for bit (resize_bilinear,
  resize_nearest), the readers' shorter-edge resize (resize_shorter), and
  cv2's INTER_AREA downscale (resize_area);
- a JPEG decoder (read_jpeg), bit-equal to Pillow's decode: Huffman and
  arithmetic coding, sequential, progressive (with libjpeg-turbo's block
  smoothing) and lossless, any integral sampling, grayscale, YCbCr, RGB,
  CMYK and YCCK (mode 'CMYK' as Pillow opens it); and a baseline JPEG
  encoder (encode_jpeg, write_jpeg), byte-equal to Pillow's
  save and to cv2.imwrite at the same quality: host C++ in
  csrc_host/jpeg_decode.cpp and csrc_host/jpeg_encode.cpp, built with g++
  at first use into _build/ and called through ctypes, which releases the
  GIL, so that loader and saver threads run in parallel;
- Pillow's CMYK to RGB (Convert.c:cmyk2rgb), under to_rgb and to_rgba;
- the mask conversions the training datasets ask of Pillow
  (convert_mask: convert('L') and convert('P'), the latter from RGB by
  Pillow's Floyd-Steinberg dither over its browser palette, host C++ in
  csrc_host/palette_dither.cpp, and from RGBA by Pillow's fast octree
  quantizer, csrc_host/quantize_octree.cpp);
- binary PPM (P6) in memory, which tkinter's PhotoImage reads (encode_ppm).
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from cutie_tpu_torch.utils.host_build import CSRC_HOST_DIR, host_library

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, Pillow's mode)
_COLOR_TYPES = {0: (1, "L"), 2: (3, "RGB"), 3: (1, "P"), 4: (2, "LA"),
                6: (4, "RGBA")}
_LOW_BIT_TYPES = (0, 3)   # the colour types that may pack 1, 2 or 4 bits


def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE


# ------------------------------------------------------------------ PNG read

def _chunks(data: bytes):
    """(type, payload) of every chunk, each CRC checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends without an IEND chunk")


def _unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters. raw [H, rowbytes] uint8 (the filter bytes
    removed), filters [H]; bpp: bytes a filter unit (a pixel, or a byte
    where pixels are smaller). Pixel (r, c) depends on (r, c-1), (r-1, c)
    and (r-1, c-1), so the anti-diagonals r + c = d are computed in turn,
    each at once, in a skewed copy where every neighbour is a slice:
    S[d + 2, r + 1] holds unit (r, d - r)."""
    if filters.max() > 4:
        raise ValueError(f"PNG row filter {int(filters.max())} is not defined")
    if not filters.any():
        return raw
    h, rowbytes = raw.shape
    units = rowbytes // bpp
    diagonals = h + units - 1
    r3 = raw.reshape(h, units, bpp).astype(np.int16)
    dd = np.arange(diagonals)[:, None]
    rr = np.arange(h)[None, :]
    col = dd - rr
    inside = (col >= 0) & (col < units)
    raw_s = r3[rr, np.clip(col, 0, units - 1)] * inside[..., None]
    s = np.zeros((diagonals + 2, h + 1, bpp), np.int16)
    f = filters[:, None]
    is_sub, is_up, is_avg, is_paeth = (f == 1), (f == 2), (f == 3), (f == 4)
    for d in range(diagonals):
        r0, r1 = max(0, d - units + 1), min(h - 1, d) + 1
        a = s[d + 1, r0 + 1:r1 + 1]   # left
        b = s[d + 1, r0:r1]           # up
        c = s[d, r0:r1]               # up-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (is_sub[r0:r1] * a + is_up[r0:r1] * b
                + is_avg[r0:r1] * ((a + b) >> 1) + is_paeth[r0:r1] * paeth)
        s[d + 2, r0 + 1:r1 + 1] = (raw_s[d, r0:r1] + pred) & 255
    rows = np.arange(h)[:, None]
    out = s[rows + np.arange(units)[None, :] + 2, rows + 1]
    return out.astype(np.uint8).reshape(h, rowbytes)


def _unpack(rows: np.ndarray, bits: int, width: int) -> np.ndarray:
    """[H, rowbytes] packed samples of `bits` bits -> [H, width] uint8."""
    per = 8 // bits
    shifts = (8 - bits) - bits * np.arange(per)
    vals = (rows[:, :, None] >> shifts.astype(np.uint8)) & ((1 << bits) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width].astype(np.uint8)


# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _subimage(stream: np.ndarray, w: int, h: int, channels: int, bits: int):
    """The raw samples of one filtered (sub)image of w x h pixels: [h, w]
    for bits < 8 (one channel), else [h, w, channels] (uint16 at 16 bits)."""
    block = stream.reshape(h, -1)
    rows = _unfilter(block[:, 1:], block[:, 0], max(1, channels * bits // 8))
    if bits < 8:
        return _unpack(rows, bits, w)
    if bits == 16:
        pairs = rows.reshape(h, w, channels, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    return rows.reshape(h, w, channels)


def _decode_png(data: bytes, name: str):
    """(pixels, mode, palette, transparency) of a PNG file's bytes, as
    Pillow opens it; transparency is its info['transparency'] from tRNS:
    bytes (an alpha a palette entry), an int (grayscale) or an (r, g, b)
    tuple, in the file's sample scale (0/255 for mode '1'); None without
    tRNS."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name} is not a PNG file")
    header, plte, trns, idat = None, None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            plte = payload
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, bits, color_type, _, _, interlace = header
    if color_type not in _COLOR_TYPES:
        raise ValueError(f"{name}: PNG colour type {color_type} is not defined")
    channels, mode = _COLOR_TYPES[color_type]
    if not (bits in (8, 16) and color_type != 3
            or bits in (1, 2, 4, 8) and color_type in _LOW_BIT_TYPES):
        raise ValueError(f"{name}: {bits}-bit samples in PNG colour type "
                         f"{color_type} are not defined")
    if interlace > 1:
        raise ValueError(f"{name}: PNG interlace method {interlace} is not defined")
    if color_type == 3 and plte is None:
        raise ValueError(f"{name}: a palette image without a PLTE chunk")
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    layout = []   # (x0, y0, dx, dy, width, height) of each pass that has pixels
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:   # an empty pass takes no bytes
            layout.append((x0, y0, dx, dy, pw, ph))
    sizes = [ph * ((pw * channels * bits + 7) // 8 + 1) for *_, pw, ph in layout]
    if stream.size != sum(sizes):
        raise ValueError(f"{name}: image data of {stream.size} bytes, "
                         f"expected {sum(sizes)}")
    samples = np.zeros((h, w) if bits < 8 else (h, w, channels),
                       np.uint16 if bits == 16 else np.uint8)
    used = 0
    for (x0, y0, dx, dy, pw, ph), size in zip(layout, sizes):
        samples[y0::dy, x0::dx] = _subimage(stream[used:used + size], pw, ph,
                                            channels, bits)
        used += size
    if bits < 8:
        pixels = samples
        if color_type == 0 and bits == 1:
            mode, pixels = "1", samples.astype(bool)
        elif color_type == 0:
            pixels = samples * np.uint8(255 // ((1 << bits) - 1))
    else:
        pixels = samples[..., 0] if channels == 1 else samples
        if bits == 16 and channels == 1:
            mode = "I;16"
        elif bits == 16:
            pixels = (pixels >> 8).astype(np.uint8)
            if color_type == 4:   # Pillow opens 16-bit LA as RGBA: L, L, L, A
                mode, pixels = "RGBA", pixels[..., [0, 0, 0, 1]]
    palette = list(plte) if color_type == 3 else None
    transparency = None
    if trns is not None:
        if color_type == 3:
            transparency = bytes(trns)
        elif color_type == 0 and len(trns) >= 2:
            transparency = struct.unpack(">H", trns[:2])[0]
            if mode == "1":   # Pillow scales it to the mode's 0/255
                transparency *= 255
        elif color_type == 2 and len(trns) >= 6:
            transparency = struct.unpack(">HHH", trns[:6])
    return np.ascontiguousarray(pixels), mode, palette, transparency


def read_png(path: str) -> Tuple[np.ndarray, str, Optional[List[int]]]:
    """(pixels, mode, palette) of a PNG file, as np.array(Image.open(path)),
    its .mode and .getpalette() give them: [H, W] for 'P', 'L', 'I;16'
    (uint16) and '1' (bool), [H, W, C] for 'LA', 'RGB' and 'RGBA'; the
    palette (the PLTE entries, 3 ints each) for 'P', else None."""
    with open(path, "rb") as f:
        return _decode_png(f.read(), path)[:3]


def _transparent_rgba(rgb: np.ndarray, transparency) -> np.ndarray:
    """Convert.c:rgbT2rgba after the RGB conversion: alpha 0 where the
    colour equals the transparent one, each channel's value taken & 0xff as
    Pillow takes it; 255 elsewhere."""
    t = (transparency,) * 3 if isinstance(transparency, int) else transparency
    key = np.array([v & 0xFF for v in t], np.uint8)
    alpha = np.where((rgb == key).all(axis=-1), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, alpha[..., None]], axis=-1)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Convert.c:cmyk2rgb of [..., 4] uint8: each channel nk - nk * c / 255
    (MULDIV255's rounding), nk = 255 - k."""
    v = cmyk.astype(np.int32)
    nk = 255 - v[..., 3:]
    t = v[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def to_rgb(pixels: np.ndarray, mode: str,
           palette: Optional[List[int]] = None) -> np.ndarray:
    """[H, W, 3] uint8, as Image.convert('RGB') makes it from these
    pixels (read_any's result)."""
    if mode == "RGB":
        return pixels
    if mode == "RGBA":
        return np.ascontiguousarray(pixels[..., :3])
    if mode == "CMYK":
        return cmyk_to_rgb(pixels)
    if mode == "P":
        return _palette_table(palette)[pixels, :3]
    return np.repeat(_to_l(pixels, mode)[..., None], 3, axis=-1)


def to_rgba(pixels: np.ndarray, mode: str, palette: Optional[List[int]] = None,
            transparency=None) -> np.ndarray:
    """[H, W, 4] uint8, as Image.convert('RGBA') makes it from these pixels
    and the image's tRNS transparency (_decode_png's results): alpha per
    palette entry for 'P', one transparent colour for '1', 'L', 'I;16' and
    'RGB'; otherwise opaque but for an alpha channel."""
    if mode == "RGBA":
        return pixels
    if mode == "LA":
        return np.concatenate([np.repeat(pixels[..., :1], 3, axis=-1),
                               pixels[..., 1:]], axis=-1)
    if mode == "P":
        table = _palette_table(palette)
        if transparency is not None:
            alphas = np.frombuffer(bytes(transparency), np.uint8)[:256]
            table[:len(alphas), 3] = alphas
        return table[pixels]
    rgb = to_rgb(pixels, mode, palette)
    if transparency is not None:
        return _transparent_rgba(rgb, transparency)
    alpha = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def read_rgba(path: str) -> np.ndarray:
    """np.array(Image.open(path).convert('RGBA')) of a PNG or JPEG file,
    tRNS transparency included."""
    if is_png(path):
        with open(path, "rb") as f:
            return to_rgba(*_decode_png(f.read(), path))
    return to_rgba(*read_jpeg(path))


# ----------------------------------------------------------------- JPEG read

JPEG_SOURCE = CSRC_HOST_DIR / "jpeg_decode.cpp"
_ERR_LEN = 256


@functools.cache
def jpeg_library() -> ctypes.CDLL:
    """The decoder's shared library (utils/host_build.py: built with g++ at
    first use into _build/, named by a hash of the source and the flags;
    raises if g++ fails or the library does not load)."""
    lib = host_library(JPEG_SOURCE)
    size_t, u8p, intp = ctypes.c_size_t, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    lib.jpeg_header.argtypes = [u8p, size_t, intp, intp, intp,
                                ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [u8p, size_t, u8p, size_t,
                                ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    return lib


def decode_jpeg(data: bytes, name: str = "JPEG data") -> np.ndarray:
    """A JPEG held in memory as [H, W] uint8 (one component, mode 'L'),
    [H, W, 3] uint8 RGB or [H, W, 4] uint8 CMYK (four components, inverted
    as Pillow's 'CMYK;I' raw mode inverts them), as np.array(Image.open(...))
    gives it; raises ValueError naming what it does not decode
    (hierarchical and lossless arithmetic processes, 12-bit samples,
    fractional sampling, lossless YCbCr and YCCK, which libjpeg and so
    Pillow refuse too)."""
    lib = jpeg_library()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_header(buf.ctypes.data, buf.size, ctypes.byref(w), ctypes.byref(h),
                       ctypes.byref(c), err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    if lib.jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, out.size,
                       err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    if c.value == 4:
        np.invert(out, out=out)   # JpegImagePlugin opens CMYK with raw mode 'CMYK;I'
    return out


JPEG_MODES = {1: "L", 3: "RGB", 4: "CMYK"}


def read_jpeg(path: str) -> Tuple[np.ndarray, str]:
    """(pixels, mode) of a JPEG file: [H, W] 'L', [H, W, 3] 'RGB' or
    [H, W, 4] 'CMYK', as np.array(Image.open(path)) and its .mode give
    them."""
    with open(path, "rb") as f:
        pixels = decode_jpeg(f.read(), path)
    return pixels, JPEG_MODES[1 if pixels.ndim == 2 else pixels.shape[2]]


def read_any(path: str) -> Tuple[np.ndarray, str, Optional[List[int]]]:
    """(pixels, mode, palette) of a PNG or JPEG file (read_png's result;
    a JPEG has no palette)."""
    if is_png(path):
        return read_png(path)
    return (*read_jpeg(path), None)


def read_image(path: str) -> np.ndarray:
    """An image file as [H, W, 3] uint8 RGB (Image.open(path).convert('RGB')):
    PNG by read_png, anything else by read_jpeg."""
    return to_rgb(*read_any(path))


def l24_luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's L24 luma of [..., 3] uint8 (Convert.c): (r*19595 + g*38470
    + b*7471 + 0x8000) >> 16."""
    v = rgb.astype(np.int64)
    return ((v[..., 0] * 19595 + v[..., 1] * 38470 + v[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _palette_table(palette: Optional[List[int]]) -> np.ndarray:
    """[256, 4] uint8 RGBA: the palette's entries, opaque; black past its
    end."""
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    entries = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
    table[:len(entries), :3] = entries
    return table


def _to_l(pixels: np.ndarray, mode: str) -> np.ndarray:
    """convert('L') of a one-channel mode: '1' to 0/255, 'I;16' clipped at
    255 (Convert.c:I16_L), 'LA' its L; 'L' itself."""
    if mode == "L":
        return pixels
    if mode == "LA":
        return np.ascontiguousarray(pixels[..., 0])
    if mode == "1":
        return pixels.astype(np.uint8) * np.uint8(255)
    if mode == "I;16":
        return np.minimum(pixels, 255).astype(np.uint8)
    raise ValueError(f"mode {mode!r} has no grayscale conversion")


# Pillow's browser palette (Palette.c:ImagingPaletteNewBrowser): ten black
# entries, then the 6x6x6 cube of levels 0, 51, ..., 255, red fastest
WEB_PALETTE = np.concatenate([
    np.zeros((10, 3), np.uint8),
    np.stack(np.meshgrid(np.arange(6), np.arange(6), np.arange(6), indexing="ij"),
             -1)[..., ::-1].reshape(-1, 3).astype(np.uint8) * np.uint8(51)])

PALETTE_DITHER_SOURCE = CSRC_HOST_DIR / "palette_dither.cpp"


@functools.cache
def palette_dither_library() -> ctypes.CDLL:
    """The dither's shared library, built as jpeg_library() is."""
    lib = host_library(PALETTE_DITHER_SOURCE)
    lib.rgb_to_palette.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.rgb_to_palette.restype = None
    return lib


def rgb_to_web_palette(rgb: np.ndarray) -> np.ndarray:
    """Image.convert('P') of [H, W, 3] uint8 RGB: indices into WEB_PALETTE
    by Pillow's Floyd-Steinberg dither (csrc_host/palette_dither.cpp)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    out = np.empty((h, w), np.uint8)
    palette = np.ascontiguousarray(WEB_PALETTE)
    palette_dither_library().rgb_to_palette(rgb.ctypes.data, w, h, palette.ctypes.data,
                                            len(palette), out.ctypes.data)
    return out


QUANTIZE_OCTREE_SOURCE = CSRC_HOST_DIR / "quantize_octree.cpp"


@functools.cache
def quantize_octree_library() -> ctypes.CDLL:
    """The octree quantizer's shared library, built as jpeg_library() is."""
    lib = host_library(QUANTIZE_OCTREE_SOURCE)
    lib.rgba_to_octree_palette.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                                           ctypes.c_void_p]
    lib.rgba_to_octree_palette.restype = None
    return lib


def quantize_rgba(rgba: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Image.convert('P') of [H, W, 4] uint8 RGBA, which is
    Image.quantize(256) by Pillow's fast octree
    (csrc_host/quantize_octree.cpp): ([H, W] uint8 indices, [256, 4] uint8
    RGBA palette, as getpalette('RGBA') lists it)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"quantize_rgba takes [H, W, 4] RGBA, not {rgba.shape}")
    h, w = rgba.shape[:2]
    out = np.empty((h, w), np.uint8)
    palette = np.empty((256, 4), np.uint8)
    quantize_octree_library().rgba_to_octree_palette(rgba.ctypes.data, h * w, out.ctypes.data,
                                                     palette.ctypes.data)
    return out, palette


def convert_mask(pixels: np.ndarray, mode: str, palette: Optional[List[int]],
                 target: str) -> np.ndarray:
    """Image.convert(target) of a mask read by read_any, for the two
    conversions the training datasets make:
    - 'L': Pillow's L24 luma of the colour for RGB, RGBA, CMYK (its RGB)
      and P (the palette's), the L of LA, 0/255 from '1', 'I;16' clipped at
      255;
    - 'P': the indices of P; a copy of L; L first for '1', LA and 'I;16'
      (Pillow converts those through L); RGB, and CMYK through its RGB,
      dithered onto the browser palette (rgb_to_web_palette); RGBA by the
      fast octree (quantize_rgba).
    Any other mode raises, naming it."""
    if target not in ("L", "P"):
        raise ValueError(f"convert_mask converts to 'L' or 'P', not {target!r}")
    if mode == "P":
        if target == "P":
            return pixels
        return l24_luma(_palette_table(palette)[:, :3])[pixels]
    if mode == "CMYK":
        pixels, mode = cmyk_to_rgb(pixels), "RGB"
    if mode in ("RGB", "RGBA"):
        if target == "L":
            return l24_luma(pixels[..., :3])
        if mode == "RGB":
            return rgb_to_web_palette(pixels)
        return quantize_rgba(pixels)[0]
    if mode in ("L", "LA", "1", "I;16"):
        return _to_l(pixels, mode)
    raise ValueError(f"a mask of mode {mode!r} cannot be converted to {target!r}")


def read_mask(path: str, target: str) -> np.ndarray:
    """np.array(Image.open(path).convert(target)) for target 'L' or 'P'."""
    return convert_mask(*read_any(path), target)


# ----------------------------------------------------------------- PNG write

def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, pixels: np.ndarray, palette=None) -> None:
    """Write [H, W] uint8 (a palette image when `palette` is given, its
    entries as 3 ints or bytes each, else grayscale), [H, W, 3] uint8 RGB or
    [H, W, 4] uint8 RGBA as an 8-bit PNG, every row unfiltered."""
    pixels = np.asarray(pixels)
    if pixels.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, not {pixels.dtype}")
    if pixels.ndim == 2:
        color_type = 0 if palette is None else 3
    elif pixels.ndim == 3 and pixels.shape[2] in (3, 4) and palette is None:
        color_type = 2 if pixels.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png: pixels of shape {pixels.shape} "
                         f"{'with' if palette is not None else 'without'} "
                         f"a palette")
    h, w = pixels.shape[:2]
    rows = np.zeros((h, 1 + pixels[0].size), np.uint8)
    rows[:, 1:] = pixels.reshape(h, -1)
    out = [PNG_SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))]
    if palette is not None:
        plte = bytes(bytearray(palette))[:768]
        if not plte or len(plte) % 3:
            raise ValueError(f"a palette of {len(plte)} bytes")
        out.append(_chunk(b"PLTE", plte))
    out.append(_chunk(b"IDAT", zlib.compress(rows.tobytes())))
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))


# ---------------------------------------------------------------- JPEG write

JPEG_ENCODE_SOURCE = CSRC_HOST_DIR / "jpeg_encode.cpp"


@functools.cache
def jpeg_encode_library() -> ctypes.CDLL:
    """The encoder's shared library, built as jpeg_library() is."""
    lib = host_library(JPEG_ENCODE_SOURCE)
    lib.jpeg_encode_bound.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.jpeg_encode_bound.restype = ctypes.c_size_t
    lib.jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t]
    lib.jpeg_encode.restype = ctypes.c_long
    return lib


def encode_jpeg(rgb: np.ndarray, quality: int = 75) -> bytes:
    """[H, W, 3] uint8 RGB as a baseline JFIF JPEG (YCbCr 4:2:0), the bytes
    Pillow's save(quality=quality) and cv2.imencode('.jpg', bgr,
    [IMWRITE_JPEG_QUALITY, quality]) write."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or 0 in rgb.shape:
        raise ValueError(f"encode_jpeg takes [H, W, 3] uint8, not {rgb.dtype} "
                         f"{rgb.shape}")
    lib = jpeg_encode_library()
    h, w = rgb.shape[:2]
    out = np.empty(lib.jpeg_encode_bound(w, h), np.uint8)
    n = lib.jpeg_encode(rgb.ctypes.data, w, h, int(quality), out.ctypes.data, out.size)
    if n < 0:
        raise ValueError(f"encode_jpeg: cannot encode a {w}x{h} image")
    return out[:n].tobytes()


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 75) -> None:
    """[H, W, 3] uint8 RGB as a JPEG file (encode_jpeg)."""
    data = encode_jpeg(rgb, quality)
    with open(path, "wb") as f:
        f.write(data)


def encode_ppm(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 RGB as a binary PPM (P6), which tkinter's PhotoImage
    reads from memory."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_ppm takes [H, W, 3] uint8, not {rgb.shape}")
    return b"P6\n%d %d\n255\n" % (rgb.shape[1], rgb.shape[0]) + rgb.tobytes()


# ------------------------------------------------------------------- resizes

def _triangle(x: np.ndarray) -> np.ndarray:
    """Pillow's bilinear_filter (Resample.c), support 1."""
    return np.maximum(1.0 - np.abs(x), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter (Resample.c): the cubic convolution kernel
    with a = -0.5, support 2, in its order of operations."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _filter_coefficients(in_size: int, out_size: int, kernel, support: float):
    """Pillow's precompute_coeffs (Resample.c) for `kernel` of half-width
    `support`, then normalize_coeffs_8bpc: per output index its first input
    index, and [out, taps] coefficients fixed to 22 fractional bits
    (rounded half away from zero)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64)
    count = xmax - xmin
    j = np.arange(taps)[None, :]
    w = kernel((j + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(j < count[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in range(taps):   # in C's order: the sum is sequential
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0, 1, total)[:, None], w)
    fixed = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << 22)).astype(np.int64)
    return xmin, fixed


def _resample_pass(img: np.ndarray, axis: int, out_size: int, kernel,
                   support: float) -> np.ndarray:
    """One of Pillow's two 8-bit passes along `axis`: each output the
    fixed-point sum of its taps, rounded (+2^21 >> 22) and clipped."""
    in_size = img.shape[axis]
    xmin, fixed = _filter_coefficients(in_size, out_size, kernel, support)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << 21, np.int64)
    shape = (out_size,) + (1,) * (src.ndim - 1)
    for t in range(fixed.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)
        acc += src[idx] * fixed[:, t].reshape(shape)
    out = np.clip(acc >> 22, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resample(img: np.ndarray, out_h: int, out_w: int, kernel, support: float
              ) -> np.ndarray:
    """Pillow's ImagingResample of [H, W] or [H, W, C] uint8: a horizontal
    pass, then a vertical one, each only where that size changes."""
    img = np.asarray(img, np.uint8)
    if img.shape[1] != out_w:
        img = _resample_pass(img, 1, out_w, kernel, support)
    if img.shape[0] != out_h:
        img = _resample_pass(img, 0, out_h, kernel, support)
    return img


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Image.resize((out_w, out_h), Image.BILINEAR) of [H, W] or [H, W, C]
    uint8, bit for bit."""
    return _resample(img, out_h, out_w, _triangle, 1.0)


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Image.resize((out_w, out_h), Image.BICUBIC), Pillow's default filter
    for RGB and L, of [H, W] or [H, W, C] uint8, bit for bit."""
    return _resample(img, out_h, out_w, _bicubic, 2.0)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's ImagingScaleAffine: source index trunc(x_k), x_0 = s / 2,
    x_{k+1} = x_k + s, s = in / out, accumulated in float64."""
    s = in_size / out_size
    steps = np.full(out_size, s)
    steps[0] = s * 0.5
    return np.minimum(np.add.accumulate(steps).astype(np.int64), in_size - 1)


def resize_nearest(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Image.resize((out_w, out_h), Image.NEAREST) of [H, W] or [H, W, C],
    bit for bit (any dtype)."""
    img = np.asarray(img)
    ys = _nearest_index(img.shape[0], out_h)
    xs = _nearest_index(img.shape[1], out_w)
    return img[ys[:, None], xs[None, :]]


def _area_taps(in_size: int, out_size: int):
    """cv2's computeResizeAreaTab (imgproc/src/resize.cpp) as [out, taps]
    source indices and weights (float32 values, as cv2 stores them; zero
    weight where an output has fewer taps)."""
    scale = in_size / out_size
    rows = []
    for d in range(out_size):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, in_size - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, in_size - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    n = max(len(t) for t in rows)
    idx = np.zeros((out_size, n), np.int64)
    wts = np.zeros((out_size, n), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], wts[d, j] = s, a
    return idx, wts


def resize_area(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """cv2.resize(img, (out_w, out_h), interpolation=INTER_AREA) of a
    downscale of uint8 [H, W] or [H, W, C]. At integer factors it takes
    cv2's fast path bit for bit: (a + b + c + d + 2) >> 2 at 2x, else the
    sum times the float32 reciprocal of the area, rounded half to even. At
    other factors it sums cv2's area weights in float64 and rounds, where
    cv2 sums them in float32 in its own order: within one level of cv2."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if out_w > w or out_h > h:
        raise ValueError(f"resize_area downscales: {w}x{h} -> {out_w}x{out_h}")
    kx, ky = w / out_w, h / out_h
    if kx == int(kx) and ky == int(ky):
        kx, ky = int(kx), int(ky)
        v = img.astype(np.int64)
        acc = sum(v[i::ky, j::kx][:out_h, :out_w]
                  for i in range(ky) for j in range(kx))
        if kx == ky == 2:
            return ((acc + 2) >> 2).astype(np.uint8)
        prod = acc.astype(np.float32) * np.float32(1.0 / (kx * ky))
        return np.clip(np.rint(prod), 0, 255).astype(np.uint8)
    xi, xw = _area_taps(w, out_w)
    yi, yw = _area_taps(h, out_h)
    v = img.astype(np.float64)
    tmp = sum(v[:, xi[:, t]] * xw[:, t].astype(np.float64).reshape(
        (1, -1) + (1,) * (img.ndim - 2)) for t in range(xi.shape[1]))
    out = sum(tmp[yi[:, t]] * yw[:, t].astype(np.float64).reshape(
        (-1,) + (1,) * (img.ndim - 1)) for t in range(yi.shape[1]))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_shorter(img: np.ndarray, size: int, bilinear: bool) -> np.ndarray:
    """cutie_tpu/data/video_reader.py:_resize_shorter: the shorter side to
    `size` (the other rounded as there) by Pillow's BILINEAR (images) or
    NEAREST (masks); unchanged when it is already that size."""
    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    if h < w:
        new_h, new_w = size, round(w * size / h)
    else:
        new_h, new_w = round(h * size / w), size
    return (resize_bilinear if bilinear else resize_nearest)(img, new_h, new_w)
