"""The image files cutie_tpu reads through Pillow, read by the port without
it (cutie_tpu_torch/utils/image_io.py), against Pillow 12 and cutie_tpu.

- Progressive JPEG (csrc_host/jpeg_decode.cpp): the decoder matrix's
  progressive twin and the 12 progressive VOS frames bit-equal to Pillow's
  decode and to their baseline twins; a seeded loop of small noisy images
  (sizes 1-40, qualities, subsamplings, restart intervals: EOB runs and
  the AC refinement's correction bits); a file without its DC refinement
  or its last AC refinement (which libjpeg-turbo smooths) decodes as
  Pillow decodes it.
- PNG: Adam7 at every colour type and bit depth, 1x1 to 9x9 (empty
  passes), rows filtered at random; 16-bit samples in Pillow's modes; tRNS
  through convert('RGBA'); convert('P') from RGB (Floyd-Steinberg over the
  browser palette), '1', 'LA', 'I;16' and RGBA (the fast octree).
- The committed fixtures (png/, vos_progressive/) against the manifest.
- The slice as a whole: cutie_tpu's VideoReader against the port's on
  the progressive twin; the VOS training dataset on progressive frames
  with RGB masks; the four scripts/data tools against the root scripts,
  run as subprocesses.

png_bytes writes the PNG layouts Pillow does not (Adam7, 16-bit RGB,
chosen filters); Pillow decodes them as the oracle.
"""
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from tests.test_torch_jpeg import (FIXTURES, MATRIX, PNG_FIXTURES,  # noqa: E402
                                   PROGRESSIVE_SUFFIX, VOS_FRAMES, VOS_TWIN,
                                   _decoded_sha, _pillow_decode, without_scan)
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.utils import image_io  # noqa: E402

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# every (colour type, bit depth) PNG defines
LAYOUTS = ([(0, b) for b in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)]
           + [(3, b) for b in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8), (6, 16)])


# ------------------------------------------------------------ PNG writer

def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _pack(samples: np.ndarray, bits: int) -> np.ndarray:
    """[h, n] sample values -> [h, rowbytes] uint8, big-endian at 16 bits,
    packed high bits first below 8."""
    samples = samples.astype(np.int64)
    if bits == 16:
        pairs = np.stack([samples >> 8, samples & 255], -1)
        return pairs.reshape(len(samples), -1).astype(np.uint8)
    if bits == 8:
        return samples.astype(np.uint8)
    per = 8 // bits
    padded = np.pad(samples, ((0, 0), (0, -samples.shape[1] % per)))
    shifts = (8 - bits) - bits * np.arange(per)
    return (padded.reshape(len(samples), -1, per) << shifts).sum(-1).astype(np.uint8)


def _filter(rows: np.ndarray, bpp: int, kinds: np.ndarray) -> bytes:
    """PNG's forward row filters (None, Sub, Up, Average, Paeth), row r by
    kinds[r], each filter byte in front of its row."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])[kinds, np.arange(len(x))]
    out = np.concatenate([kinds[:, None], (x - pred) & 255], axis=1)
    return out.astype(np.uint8).tobytes()


def png_bytes(samples: np.ndarray, bits: int, color_type: int, *, interlace: int = 0,
              rng=None, plte: bytes = None, trns: bytes = None) -> bytes:
    """A PNG of samples [h, w, channels] (values in the bit depth's range),
    Adam7-interlaced if asked, each (pass) row filtered by a filter drawn
    from rng (None: no filter)."""
    h, w, c = samples.shape
    bpp = max(1, c * bits // 8)
    data = []
    for x0, y0, dx, dy in (image_io._ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        kinds = (rng.integers(0, 5, len(sub)) if rng is not None
                 else np.zeros(len(sub), np.int64))
        data.append(_filter(_pack(sub.reshape(len(sub), -1), bits), bpp, kinds))
    out = [image_io.PNG_SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color_type, 0, 0, interlace))]
    if plte is not None:
        out.append(_chunk(b"PLTE", plte))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    out += [_chunk(b"IDAT", zlib.compress(b"".join(data))), _chunk(b"IEND", b"")]
    return b"".join(out)


def write_png_fixtures(root: Path):
    """png/ and the twin's Adam7 first mask (tests/test_torch_jpeg.py's
    write_fixtures calls this after writing vos/); returns each file's
    conversions to hash, by its path under root."""
    from cutie_tpu_torch.utils.palette import davis_palette_np
    from cutie_tpu_torch.utils.synth_video import synth_gt_masks_480

    rng = np.random.default_rng(16)
    (root / "png").mkdir(parents=True)
    y, x = np.mgrid[0:37, 0:53]
    gray16 = (x * 23 + y * 9 + rng.integers(0, 40, (37, 53))).astype(np.uint16)
    Image.fromarray(gray16, "I;16").save(root / "png" / "gray16.png")
    rgb16 = rng.integers(0, 1 << 16, (29, 41, 3))
    (root / "png" / "rgb16.png").write_bytes(png_bytes(rgb16, 16, 2, rng=rng))
    p = Image.fromarray(rng.integers(0, 8, (23, 31)).astype(np.uint8), "P")
    p.putpalette(rng.integers(0, 256, 24).astype(np.uint8).tobytes())
    p.save(root / "png" / "palette_trns.png", transparency=bytes([0, 128, 255, 64]))
    mask = synth_gt_masks_480(1)[0]
    Image.fromarray(davis_palette_np[mask]).save(root / "png" / "mask_rgb_480x854.png")
    with Image.open(root / "vos" / "Annotations" / "synth_a" / "00000.png") as im:
        first, plte = np.array(im), bytes(im.getpalette())
    twin_mask = root / VOS_TWIN / "Annotations" / "synth_a" / "00000.png"
    twin_mask.parent.mkdir(parents=True)
    twin_mask.write_bytes(png_bytes(first[..., None], 8, 3, interlace=1, rng=rng, plte=plte))
    return {**{f"png/{name}.png": conv for name, conv in PNG_FIXTURES.items()},
            twin_mask.relative_to(root).as_posix(): ()}


def _pillow_opens_like_the_port(path):
    """read_png against np.array, .mode and .getpalette() of Pillow."""
    pixels, mode, palette = image_io.read_png(str(path))
    with Image.open(path) as ref:
        want = np.array(ref)
        assert (mode, pixels.dtype, pixels.shape) == (ref.mode, want.dtype, want.shape), path
        np.testing.assert_array_equal(pixels, want)
        assert palette == ref.getpalette()
    return mode


def _conversions_match_pillow(path, targets=("RGB", "RGBA", "L", "P")):
    readers = {"RGB": image_io.read_image, "RGBA": image_io.read_rgba,
               "L": lambda p: image_io.read_mask(p, "L"),
               "P": lambda p: image_io.read_mask(p, "P")}
    with Image.open(path) as ref:
        mode = ref.mode
    for target in targets:
        with Image.open(path) as ref:
            want = np.array(ref.convert(target))
        np.testing.assert_array_equal(readers[target](str(path)), want,
                                      err_msg=f"{path} {mode} -> {target}")


# ------------------------------------------------------ progressive JPEG

@pytest.mark.parametrize("name", sorted(MATRIX))
def test_progressive_matrix_bit_equal_to_pillow_and_baseline(name):
    """Each matrix case saved progressive decodes to Pillow's array and to
    the baseline file's (Pillow's two decodes are equal too)."""
    path = FIXTURES / "jpeg" / f"{name}{PROGRESSIVE_SUFFIX}.jpg"
    data = path.read_bytes()
    assert b"\xff\xc2" in data
    pixels, mode = image_io.read_jpeg(str(path))
    want = _pillow_decode(path)
    assert mode == ("L" if want.ndim == 2 else "RGB")
    np.testing.assert_array_equal(pixels, want)
    np.testing.assert_array_equal(
        pixels, image_io.read_jpeg(str(FIXTURES / "jpeg" / f"{name}.jpg"))[0])
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    assert manifest[f"jpeg/{name}{PROGRESSIVE_SUFFIX}.jpg"]["sha256"] == _decoded_sha(pixels)


def test_progressive_vos_twin_bit_equal_to_baseline():
    """The 12 progressive frames of vos_progressive/ decode to Pillow's
    arrays, to the baseline synth_a frames' and to the manifest; the
    twin's Adam7 first mask reads as the baseline's palette PNG."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    twin = sorted((FIXTURES / VOS_TWIN / "JPEGImages" / "synth_a").iterdir())
    assert len(twin) == VOS_FRAMES
    for path in twin:
        got = image_io.read_image(str(path))
        np.testing.assert_array_equal(got, _pillow_decode(path), err_msg=str(path))
        base = FIXTURES / "vos" / "JPEGImages" / "synth_a" / path.name
        np.testing.assert_array_equal(got, image_io.read_image(str(base)))
        assert _decoded_sha(got) == manifest[path.relative_to(FIXTURES).as_posix()]["sha256"]
    mask = FIXTURES / VOS_TWIN / "Annotations" / "synth_a" / "00000.png"
    assert mask.read_bytes()[28] == 1   # IHDR's interlace method: Adam7
    assert _pillow_opens_like_the_port(mask) == "P"
    base = image_io.read_png(str(FIXTURES / "vos" / "Annotations" / "synth_a" / "00000.png"))
    twin_mask = image_io.read_png(str(mask))
    np.testing.assert_array_equal(twin_mask[0], base[0])
    assert twin_mask[2] == base[2]


def test_progressive_noisy_images_match_pillow():
    """50 seeded images of noise over a flat colour, 1 to 40 pixels a side,
    random qualities and subsamplings, some with restart intervals: Pillow's
    progressive script codes EOB runs and, at noise, the AC refinement's
    correction bits on coefficients already nonzero."""
    rng = np.random.default_rng(7)
    for i in range(50):
        w, h = (int(v) for v in rng.integers(1, 41, 2))
        img = np.clip(rng.integers(0, 256, 3) + rng.normal(0, rng.choice([4, 30, 90]), (h, w, 3)),
                      0, 255).astype(np.uint8)
        im = Image.fromarray(img)
        kw = dict(quality=int(rng.integers(5, 100)), progressive=True)
        if rng.random() < 0.2:
            im = im.convert("L")
        else:
            kw["subsampling"] = int(rng.integers(0, 3))
        if rng.random() < 0.3:
            kw["restart_marker_blocks"] = int(rng.integers(1, 4))
        buf = io.BytesIO()
        im.save(buf, "JPEG", **kw)
        want = np.array(Image.open(io.BytesIO(buf.getvalue())))
        np.testing.assert_array_equal(image_io.decode_jpeg(buf.getvalue()), want,
                                      err_msg=f"image {i}: {w}x{h} {kw}")


@pytest.mark.parametrize("dropped", ["dc_refinement", "last_ac_refinement"])
def test_progressive_without_a_scan(dropped):
    """Pillow's progressive script for YCbCr has 10 scans. Without the DC
    refinement (scan 6) every component's first coefficients are refined
    but the DC's bit 0, which leaves libjpeg's block smoothing off. Without
    the last scan (luma AC bit 0) luma's coefficients 1-9 stay unrefined,
    which libjpeg-turbo smooths. Either decode equals Pillow's."""
    data = (FIXTURES / "jpeg" / "q75_420_progressive.jpg").read_bytes()
    assert data.count(b"\xff\xda") == 10
    cut = without_scan(data, 6 if dropped == "dc_refinement" else 9)
    assert cut.count(b"\xff\xda") == 9
    want = np.array(Image.open(io.BytesIO(cut)))
    assert not np.array_equal(want, _pillow_decode(FIXTURES / "jpeg" / "q75_420.jpg"))
    np.testing.assert_array_equal(image_io.decode_jpeg(cut), want)


# ------------------------------------------------------------------- PNG

@pytest.mark.parametrize("color_type,bits", LAYOUTS, ids=lambda v: str(v))
def test_adam7_matches_pillow(tmp_path, color_type, bits):
    """Every size from 1x1 to 9x9 on a grid (passes without pixels take no
    bytes), interlaced and not, rows filtered at random, half the files
    with a tRNS chunk where the colour type takes one: read_png and the
    RGB, RGBA, L and P conversions equal Pillow's."""
    rng = np.random.default_rng(100 * color_type + bits)
    c = CHANNELS[color_type]
    for h in (1, 2, 3, 5, 8, 9):
        for w in (1, 2, 4, 7, 9):
            for interlace in (1, 0) if (h, w) in ((9, 9), (2, 7)) else (1,):
                high = min(1 << bits, 7) if color_type == 3 else 1 << bits
                samples = rng.integers(0, high, (h, w, c))
                plte = trns = None
                if color_type == 3:
                    plte = rng.integers(0, 256, 21).astype(np.uint8).tobytes()
                if rng.random() < 0.5:
                    if color_type == 3:
                        alphas = rng.integers(0, 256, int(rng.integers(1, 8)))
                        trns = alphas.astype(np.uint8).tobytes()
                    elif color_type in (0, 2):
                        trns = struct.pack(">" + "H" * c, *samples[0, 0].tolist())
                path = tmp_path / f"{h}x{w}_{interlace}.png"
                path.write_bytes(png_bytes(samples, bits, color_type, interlace=interlace,
                                           rng=rng, plte=plte, trns=trns))
                _pillow_opens_like_the_port(path)
                _conversions_match_pillow(path)


TRNS_CASES = {
    # name: (samples, bits, colour type, plte, tRNS payload)
    "palette_alphas": (np.arange(12).reshape(3, 4, 1) % 5, 8, 3, bytes(range(30)),
                       bytes([0, 90, 255])),
    "palette_one_transparent": (np.arange(12).reshape(3, 4, 1) % 5, 4, 3, bytes(range(30)),
                                bytes([255, 0, 255])),
    "gray8": (np.arange(12).reshape(3, 4, 1) * 20, 8, 0, None, struct.pack(">H", 60)),
    "gray1": (np.arange(12).reshape(3, 4, 1) % 2, 1, 0, None, struct.pack(">H", 1)),
    "gray16": (np.arange(12).reshape(3, 4, 1) * 40, 16, 0, None, struct.pack(">H", 120)),
    "rgb8": (np.arange(36).reshape(3, 4, 3) % 7, 8, 2, None, struct.pack(">HHH", 3, 4, 5)),
    # Pillow compares the high bytes it keeps with the low bytes of tRNS
    "rgb16": (np.array([[[0x0307, 0x0400, 0x05FF], [0x0103, 0x0204, 0x0305]]]), 16, 2, None,
              struct.pack(">HHH", 0x0103, 0x0204, 0x0305)),
}


@pytest.mark.parametrize("case", sorted(TRNS_CASES))
def test_trns_conversions_match_pillow(tmp_path, case):
    samples, bits, color_type, plte, trns = TRNS_CASES[case]
    path = tmp_path / f"{case}.png"
    path.write_bytes(png_bytes(samples, bits, color_type, plte=plte, trns=trns))
    _pillow_opens_like_the_port(path)
    _conversions_match_pillow(path)
    rgba = image_io.read_rgba(str(path))
    assert (rgba[..., 3] == 0).any() or case == "gray16", case


def _convert_p_images(rng):
    from cutie_tpu_torch.utils.palette import davis_palette_np

    noise = rng.integers(0, 256, (37, 61, 3)).astype(np.uint8)
    mask = np.zeros((40, 70), np.uint8)
    mask[5:30, 10:40], mask[20:38, 30:65], mask[2:6, :] = 1, 2, 3
    return {
        "RGB_noise": Image.fromarray(noise),
        "RGB_davis_mask": Image.fromarray(davis_palette_np[mask]),
        "RGB_web_colours": Image.fromarray((rng.integers(0, 6, (9, 11, 3)) * 51).astype(np.uint8)),
        "1": Image.fromarray(rng.integers(0, 2, (13, 17)).astype(bool)),
        "LA": Image.fromarray(rng.integers(0, 256, (13, 17, 2)).astype(np.uint8), "LA"),
        "I;16": Image.fromarray(rng.integers(0, 700, (13, 17)).astype(np.uint16), "I;16"),
    }


@pytest.mark.parametrize("case", ["RGB_noise", "RGB_davis_mask", "RGB_web_colours",
                                  "1", "LA", "I;16"])
def test_convert_p_matches_pillow(tmp_path, case):
    """convert('P') (and 'L') of masks Pillow saved in these modes: RGB
    dithered onto the browser palette, '1', 'LA' and 'I;16' through L."""
    im = _convert_p_images(np.random.default_rng(3))[case]
    path = tmp_path / "mask.png"
    im.save(path)
    _pillow_opens_like_the_port(path)
    for target in ("P", "L"):
        np.testing.assert_array_equal(image_io.read_mask(str(path), target),
                                      np.array(Image.open(path).convert(target)),
                                      err_msg=f"{case} -> {target}")
    if case.startswith("RGB"):
        assert Image.open(path).convert("P").getpalette() == image_io.WEB_PALETTE.ravel().tolist()


def test_rgba_to_p_refused_naming_quantize(tmp_path):
    """RGBA to 'P' is Pillow's adaptive quantizer (Image.quantize, the fast
    octree), not the browser palette: the port's equals it (it refused
    before csrc_host/quantize_octree.cpp), and 'L' is the RGB's luma."""
    path = tmp_path / "rgba.png"
    rgba = np.random.default_rng(0).integers(0, 256, (5, 6, 4)).astype(np.uint8)
    Image.fromarray(rgba).save(path)
    np.testing.assert_array_equal(image_io.read_mask(str(path), "P"),
                                  np.array(Image.open(path).convert("P")))
    np.testing.assert_array_equal(image_io.read_mask(str(path), "L"),
                                  np.array(Image.open(path).convert("L")))


def test_png_fixtures_match_pillow_and_the_manifest():
    """png/ and the twin's mask: read_png and every conversion the
    manifest hashes equal Pillow's, and the manifest's hashes are Pillow's."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    pngs = sorted(rel for rel in manifest if rel.endswith(".png"))
    assert pngs == sorted([f"png/{n}.png" for n in PNG_FIXTURES]
                          + [f"{VOS_TWIN}/Annotations/synth_a/00000.png"])
    readers = {"RGB": image_io.read_image, "RGBA": image_io.read_rgba,
               "L": lambda p: image_io.read_mask(p, "L"),
               "P": lambda p: image_io.read_mask(p, "P")}
    for rel in pngs:
        path, entry = FIXTURES / rel, manifest[rel]
        mode = _pillow_opens_like_the_port(path)
        pixels = image_io.read_png(str(path))[0]
        assert (mode, str(pixels.dtype), list(pixels.shape)) == (
            entry["mode"], entry["dtype"], entry["shape"]), rel
        assert _decoded_sha(pixels) == entry["sha256"], rel
        for target, sha in entry["convert"].items():
            got = readers[target](str(path))
            np.testing.assert_array_equal(got, np.array(Image.open(path).convert(target)))
            assert _decoded_sha(got) == sha, (rel, target)
    assert manifest["png/gray16.png"]["mode"] == "I;16"


# ------------------------------------------------------ the slice whole

def test_video_reader_matches_cutie_tpu_on_the_progressive_twin():
    """cutie_tpu's VideoReader (Pillow) and the port's over
    vos_progressive/ (progressive JPEG frames, the Adam7 first mask) at
    size 480 and -1: the same frames, first mask, labels and info."""
    from cutie_tpu.data.video_reader import VideoReader as Ref
    from cutie_tpu_torch.data.video_reader import VideoReader

    image_dir = str(FIXTURES / VOS_TWIN / "JPEGImages" / "synth_a")
    mask_dir = str(FIXTURES / VOS_TWIN / "Annotations" / "synth_a")
    for size in (480, -1):
        port = VideoReader("synth_a", image_dir, mask_dir, size=size)
        ref = Ref("synth_a", image_dir, mask_dir, size=size)
        assert len(port) == len(ref) == VOS_FRAMES
        assert port.get_palette() == ref.get_palette()
        for idx in (0, 1, 11):
            a, b = port[idx], ref[idx]
            np.testing.assert_array_equal(a["rgb"], b["rgb"])
            assert ("mask" in a) == ("mask" in b) == (idx == 0)
            if idx == 0:
                np.testing.assert_array_equal(a["mask"], b["mask"])
                np.testing.assert_array_equal(a["valid_labels"], b["valid_labels"])
            assert a["info"] == b["info"]


def _port_tool(tool):
    """The port's tool run as python -m with PIL and cv2 blocked."""
    code = ("import runpy, sys\n"
            "sys.modules.update(dict.fromkeys(('PIL', 'cv2')))\n"
            f"sys.argv = ['{tool}'] + sys.argv[1:]\n"
            f"runpy.run_module('cutie_tpu_torch.scripts.data.{tool}', run_name='__main__',\n"
            f"                 alter_sys=True)\n")
    return [sys.executable, "-c", code]


@pytest.fixture(scope="module")
def scripts_data_runs(tmp_path_factory):
    """The four root scripts and the port's tools over chip_smoke's
    scripts_data_tree, each in a subprocess: (tree, root outputs, port
    outputs, their summaries)."""
    import chip_smoke

    tmp = tmp_path_factory.mktemp("scripts_data")
    vos = chip_smoke.scripts_data_tree(tmp)
    ref = chip_smoke.run_scripts_data(
        vos, tmp / "ref", lambda tool: [sys.executable, f"scripts/data/{tool}.py"])
    port = chip_smoke.run_scripts_data(vos, tmp / "port", _port_tool)
    return vos, tmp / "ref", tmp / "port", ref, port


@pytest.mark.parametrize("tool", ["expand_long_vid", "find_empty_mask",
                                  "find_empty_video", "preprocess_lvos"])
def test_scripts_data_match_the_root_scripts(scripts_data_runs, tool):
    """Each tool's outputs equal the root script's on the same tree (file
    lists and bytes, the JSON, stdout, decoded PNG pixels and palettes
    under Pillow) and scripts_data_expected.json, which the card's formats
    phase holds its run to."""
    import chip_smoke

    vos, ref_out, port_out, ref, port = scripts_data_runs
    expected = json.loads(chip_smoke.SCRIPTS_DATA_EXPECTED.read_text())
    keys = {"expand_long_vid": ["expand_long_vid"], "find_empty_mask": ["find_empty_mask"],
            "find_empty_video": ["find_empty_video"],
            "preprocess_lvos": ["preprocess_lvos", "lvos_dirs"]}[tool]
    for key in keys:
        assert port[key] == ref[key] == expected[key], key
    if tool == "find_empty_mask":
        assert ref[tool]["synth_b"] == ["00003", "00004", "00005"]
        assert ref[tool]["synth_empty"] == []
    if tool == "find_empty_video":
        assert ref[tool] == ["synth_c", "synth_empty (no masks)"]
    if tool == "expand_long_vid":
        assert len(ref[tool]) == 3 * 2 * 2 * VOS_FRAMES
    if tool == "preprocess_lvos":
        written = sorted(f.relative_to(ref_out / "lvos")
                         for f in (ref_out / "lvos").rglob("*.png"))
        assert written == sorted(f.relative_to(port_out / "lvos")
                                 for f in (port_out / "lvos").rglob("*.png"))
        assert {p.as_posix() for p in written} >= {"synth_a/00000.png", "synth_a/00001.png"}
        for rel in written:
            with Image.open(ref_out / "lvos" / rel) as a, Image.open(port_out / "lvos" / rel) as b:
                assert a.mode == b.mode, rel
                np.testing.assert_array_equal(np.array(a), np.array(b))
                assert a.getpalette() == b.getpalette(), rel


def test_vos_dataset_matches_cutie_tpu_on_progressive_frames_and_rgb_masks(tmp_path):
    """VOSMergeTrainDataset.get on a copy of the VOS fixture whose frames
    are progressive JPEGs and whose masks are RGB PNGs (cutie_tpu's
    convert('P') dithers them onto Pillow's browser palette) equals
    cutie_tpu's, with and without the merge."""
    from cutie_tpu.data.vos_dataset import VOSMergeTrainDataset as Ref
    from cutie_tpu_torch.data.vos_dataset import VOSMergeTrainDataset
    from tests.test_torch_data_pipeline import assert_sample_equal

    root = tmp_path / "vos"
    for vid in ("synth_a", "synth_b"):
        (root / "JPEGImages" / vid).mkdir(parents=True)
        (root / "Annotations" / vid).mkdir(parents=True)
        for ti in range(VOS_FRAMES):
            with Image.open(FIXTURES / "vos" / "JPEGImages" / vid / f"{ti:05d}.jpg") as im:
                im.save(root / "JPEGImages" / vid / f"{ti:05d}.jpg", quality=90, progressive=True)
            with Image.open(FIXTURES / "vos" / "Annotations" / vid / f"{ti:05d}.png") as im:
                im.convert("RGB").save(root / "Annotations" / vid / f"{ti:05d}.png")
    cfg = {"rgb": {"im_root": str(root / "JPEGImages"), "gt_root": str(root / "Annotations"),
                   "max_skip": 3, "subset": None, "empty_masks": None, "multiplier": 1}}
    assert image_io.read_png(str(root / "Annotations" / "synth_a" / "00000.png"))[1] == "RGB"
    for merge in (0.0, 1.0):
        kw = dict(seq_length=3, max_num_obj=3, size=64, merge_probability=merge)
        port, ref = VOSMergeTrainDataset(cfg, **kw), Ref(cfg, **kw)
        assert port.video_frames == ref.video_frames
        for idx in (0, 13):
            a = port.get(idx, np.random.default_rng(idx))
            b = ref.get(idx, np.random.default_rng(idx))
            assert_sample_equal(a, b)
