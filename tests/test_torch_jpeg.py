"""The port's JPEG decoder and mask conversions against Pillow.

cutie_tpu_torch/utils/image_io.py decodes JPEG in host C++
(csrc_host/jpeg_decode.cpp) without Pillow. The bar is bit equality with
np.array(Image.open(path)) on every committed JPEG: the decoder matrix
(qualities 30/75/95; 4:4:4, 4:2:2, 4:2:0; grayscale; a restart interval;
odd sizes, down to widths that take libjpeg's box upsampling) and its
progressive twin, the VOS frames (480x854, 4:2:0, q90) and their
progressive copies, and the static images. What the decoder refuses,
Pillow refuses too, and the refusal names it. The masks' convert('L') and
convert('P') are held to Pillow's on every mode they take
(tests/test_torch_image_formats.py holds the PNG formats and progressive
JPEG, tests/test_torch_jpeg_codings.py the other codings).

write_fixtures() writes tests/torch_fixtures/ with Pillow (run
`python -m tests.test_torch_jpeg` from the repository root to rewrite
them): the VOS set (3 videos x 12 frames of the port's synthetic video,
utils/synth_video.py, box-blurred so that they compress like camera
frames, with DAVIS-palette P masks), its progressive twin of synth_a
(vos_progressive/: the same pixels saved progressive at q90 4:2:0, the
first mask as an Adam7-interlaced palette PNG), the static set (16 images
of about 384x512 with soft L masks), the decoder matrix and its
progressive twin, a few PNGs Pillow opens in other modes (png/: 16-bit
grayscale and RGB, a palette with tRNS, a 480x854 RGB mask), the codings
Pillow cannot write (jpeg_codings/ and the vos_encodings/ twin of synth_a,
by tests/jpeg_writer.py), the SHA-256 of Pillow's decode of every JPEG and
of these PNGs, with their conversions (manifest.json), and Pillow's arrays
of the matrix (jpeg_expected.npz). The card holds its decode to the
manifest.
"""
import hashlib
import io
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.utils import image_io  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
MANIFEST = FIXTURES / "manifest.json"
EXPECTED = FIXTURES / "jpeg_expected.npz"
VOS_VIDEOS = ("synth_a", "synth_b", "synth_c")
VOS_FRAMES = 12
STATIC_IMAGES = 16

# the decoder matrix: name -> (width, height, quality, subsampling or None
# for grayscale, save options)
MATRIX = {
    **{f"q{q}_{name}": (101, 77, q, ss, {})
       for q in (30, 75, 95) for name, ss in (("444", 0), ("422", 1), ("420", 2))},
    "gray_q75": (101, 77, 75, None, {}),
    "gray_q95_odd": (33, 65, 95, None, {}),
    "restart_q75_420": (96, 64, 75, 2, {"restart_marker_blocks": 3}),
    "restart_q90_422": (61, 45, 90, 1, {"restart_marker_rows": 1}),
    "odd_17x9_420": (17, 9, 75, 2, {}),
    "odd_3x5_420": (3, 5, 75, 2, {}),      # chroma width 2: box upsampling
    "odd_4x3_422": (4, 3, 95, 1, {}),
    "one_pixel_444": (1, 1, 75, 0, {}),
    "wide_854x24_420": (854, 24, 90, 2, {}),  # chroma width 427, as at 480p
}
PROGRESSIVE = "progressive_q75"
PROGRESSIVE_SUFFIX = "_progressive"   # the matrix's progressive twin: <name>_progressive.jpg
VOS_TWIN = "vos_progressive"          # synth_a, progressive, its first mask Adam7
# png/: name -> the conversions whose hashes the manifest keeps
PNG_FIXTURES = {"gray16": ("L", "RGB", "P"), "rgb16": ("RGB", "L", "P"),
                "palette_trns": ("RGBA", "RGB"), "mask_rgb_480x854": ("P", "L")}
# the directories write_fixtures owns (jpeg_enc/ is tests/test_torch_jpeg_encode.py's;
# jpeg_codings/ and vos_encodings/ are written by tests/test_torch_jpeg_codings.py)
OWN_DIRS = ("vos", VOS_TWIN, "static", "jpeg", "png")
CODINGS_DIR, VOS_ENCODINGS = "jpeg_codings", "vos_encodings"


def _decoded_sha(pixels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def _pillow_decode(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.array(im)


def _blurred_frame(rgb01: np.ndarray, radius: int) -> Image.Image:
    from PIL import ImageFilter

    u8 = (np.transpose(rgb01, (1, 2, 0)) * 255).round().astype(np.uint8)
    return Image.fromarray(u8).filter(ImageFilter.BoxBlur(radius))


def write_fixtures(root: Path = FIXTURES) -> None:
    """Write every fixture file under root with Pillow (see the module
    docstring)."""
    from PIL import ImageFilter

    from cutie_tpu_torch.utils.palette import davis_palette
    from cutie_tpu_torch.utils.synth_video import synth_frames_480, synth_gt_masks_480

    from tests.test_torch_image_formats import write_png_fixtures

    for name in OWN_DIRS:
        if (root / name).exists():
            shutil.rmtree(root / name)
    # VOS: three videos; the second keeps objects 1 and 2, the third runs
    # backwards
    masks = synth_gt_masks_480(VOS_FRAMES)
    for vi, vid in enumerate(VOS_VIDEOS):
        frames, _ = synth_frames_480(VOS_FRAMES, seed=9 + vi)
        vm = np.where(masks <= (2 if vi == 1 else 3), masks, 0).astype(np.uint8)
        if vi == 2:
            frames, vm = frames[::-1], vm[::-1]
        (root / "vos" / "JPEGImages" / vid).mkdir(parents=True)
        (root / "vos" / "Annotations" / vid).mkdir(parents=True)
        if vi == 0:
            (root / VOS_TWIN / "JPEGImages" / vid).mkdir(parents=True)
        for ti in range(VOS_FRAMES):
            frame = _blurred_frame(frames[ti], 2)
            frame.save(root / "vos" / "JPEGImages" / vid / f"{ti:05d}.jpg", quality=90)
            if vi == 0:   # the same pixels, progressive, at the same q90 4:2:0
                frame.save(root / VOS_TWIN / "JPEGImages" / vid / f"{ti:05d}.jpg",
                           quality=90, progressive=True)
            p = Image.fromarray(vm[ti], "P")
            p.putpalette(davis_palette)
            p.save(root / "vos" / "Annotations" / vid / f"{ti:05d}.png")
    # static: images of about 384x512 with one soft-edged object each
    (root / "static").mkdir(parents=True)
    for i in range(STATIC_IMAGES):
        h, w = 384 + 8 * (i % 3), 512 - 16 * (i % 4)
        frames, _ = synth_frames_480(1, h, w, seed=20 + i)
        _blurred_frame(frames[0], 2).save(root / "static" / f"{i:03d}.jpg", quality=90)
        obj = (synth_gt_masks_480(1, h, w)[0] == 1 + i % 3).astype(np.uint8) * 255
        Image.fromarray(obj, "L").filter(ImageFilter.BoxBlur(1)).save(
            root / "static" / f"{i:03d}.png")
    # the decoder matrix
    (root / "jpeg").mkdir(parents=True)
    expected = {}
    for name, (w, h, q, ss, extra) in MATRIX.items():
        frames, _ = synth_frames_480(1, max(h, 8), max(w, 8), seed=40)
        im = _blurred_frame(frames[0][:, :h, :w], 1)
        kw = dict(quality=q, **extra)
        if ss is None:
            im = im.convert("L")
        else:
            kw["subsampling"] = ss
        path = root / "jpeg" / f"{name}.jpg"
        im.save(path, **kw)
        expected[name] = _pillow_decode(path)
        im.save(root / "jpeg" / f"{name}{PROGRESSIVE_SUFFIX}.jpg", progressive=True, **kw)
    frames, _ = synth_frames_480(1, 48, 64, seed=41)
    _blurred_frame(frames[0], 1).save(root / "jpeg" / f"{PROGRESSIVE}.jpg",
                                      quality=75, progressive=True)
    np.savez_compressed(root / "jpeg_expected.npz", **expected)
    png_conversions = write_png_fixtures(root)
    from tests.test_torch_jpeg_codings import write_coding_fixtures

    write_coding_fixtures(root)
    manifest = {}
    for path in sorted(root.rglob("*.jpg")):
        if path.parent.name == "jpeg_enc":
            continue
        pixels = _pillow_decode(path)
        manifest[path.relative_to(root).as_posix()] = {
            "sha256": _decoded_sha(pixels), "shape": list(pixels.shape),
            "supported": True}
    for rel, conversions in png_conversions.items():
        with Image.open(root / rel) as im:
            pixels = np.array(im)
            manifest[rel] = {
                "sha256": _decoded_sha(pixels), "shape": list(pixels.shape),
                "mode": im.mode, "dtype": str(pixels.dtype),
                "convert": {m: _decoded_sha(np.array(im.convert(m))) for m in conversions}}
    (root / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True)
                                        + "\n")
    # what the root scripts/data tools give on chip_smoke's tree of the VOS set
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        vos = chip_smoke.scripts_data_tree(tmp)
        expected = chip_smoke.run_scripts_data(
            vos, Path(tmp) / "out", lambda tool: [sys.executable, f"scripts/data/{tool}.py"])
    chip_smoke.SCRIPTS_DATA_EXPECTED.write_text(json.dumps(expected, indent=1, sort_keys=True)
                                                + "\n")


def _manifest():
    return json.loads(MANIFEST.read_text())


def test_fixtures_hash_to_the_manifest_under_pillow():
    """Pillow's decode of every committed JPEG still hashes to the
    manifest, and the matrix's expected arrays are Pillow's decode."""
    from tests.test_torch_jpeg_codings import CODINGS

    manifest = _manifest()
    assert len(manifest) == (len(VOS_VIDEOS) * VOS_FRAMES + STATIC_IMAGES + 2 * len(MATRIX)
                             + 1 + VOS_FRAMES + len(PNG_FIXTURES) + 1
                             + len(CODINGS) + VOS_FRAMES)
    for rel, entry in manifest.items():
        pixels = _pillow_decode(FIXTURES / rel)
        assert list(pixels.shape) == entry["shape"], rel
        assert _decoded_sha(pixels) == entry["sha256"], rel
    with np.load(EXPECTED) as exp:
        assert sorted(exp.files) == sorted(MATRIX)
        for name in MATRIX:
            np.testing.assert_array_equal(
                exp[name], _pillow_decode(FIXTURES / "jpeg" / f"{name}.jpg"))
    # the restart cases carry a DRI marker, the progressive one SOF2
    for name in ("restart_q75_420", "restart_q90_422"):
        assert b"\xff\xdd" in (FIXTURES / "jpeg" / f"{name}.jpg").read_bytes(), name
    assert b"\xff\xc2" in (FIXTURES / "jpeg" / f"{PROGRESSIVE}.jpg").read_bytes()


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_decoder_bit_equal_to_pillow_on_the_matrix(name):
    path = FIXTURES / "jpeg" / f"{name}.jpg"
    pixels, mode = image_io.read_jpeg(str(path))
    with Image.open(path) as ref:
        assert mode == ref.mode
        want = np.array(ref)
        rgb = np.array(ref.convert("RGB"))
    assert pixels.dtype == np.uint8 and pixels.shape == want.shape
    np.testing.assert_array_equal(pixels, want)
    with np.load(EXPECTED) as exp:
        np.testing.assert_array_equal(pixels, exp[name])
    np.testing.assert_array_equal(image_io.read_image(str(path)), rgb)


@pytest.mark.parametrize("subset", ["vos", "static"])
def test_decoder_bit_equal_to_pillow_on_the_datasets(subset):
    """Every VOS frame (480x854, 4:2:0, q90) and static image decodes to
    Pillow's array, and to the manifest's hash."""
    manifest = _manifest()
    paths = sorted((FIXTURES / subset).rglob("*.jpg"))
    assert len(paths) == (len(VOS_VIDEOS) * VOS_FRAMES if subset == "vos"
                          else STATIC_IMAGES)
    for path in paths:
        got = image_io.read_image(str(path))
        np.testing.assert_array_equal(got, _pillow_decode(path), err_msg=str(path))
        rel = path.relative_to(FIXTURES).as_posix()
        assert _decoded_sha(got) == manifest[rel]["sha256"], rel


def without_scan(data: bytes, index: int) -> bytes:
    """The JPEG without its index-th scan (the SOS segment and its
    entropy-coded data)."""
    pos, scans, out = 2, -1, [data[:2]]
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            out.append(data[pos:])
            break
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            scans += 1
            while not (data[end] == 0xFF and data[end + 1] != 0
                       and not 0xD0 <= data[end + 1] <= 0xD7):
                end += 1
        if not (marker == 0xDA and scans == index):
            out.append(data[pos:end])
        pos = end
    return b"".join(out)


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    """data with the byte `offset` bytes after the first `marker` set."""
    pos = data.index(marker) + offset
    return data[:pos] + bytes([value]) + data[pos + 1:]


def _refused_by_pillow_too():
    """what -> a JPEG that libjpeg (under Pillow) refuses, with the words
    of the port's refusal."""
    from tests import jpeg_writer as jw

    base = (FIXTURES / "jpeg" / "q75_420.jpg").read_bytes()
    sof = b"\xff\xc0"
    gray = np.arange(13 * 9, dtype=np.uint8).reshape(9, 13)
    lossless = jw.write_lossless([gray], [1])
    planes = [np.full((16, 24), v, np.uint8) for v in (90, 120, 200, 30)]

    def frame(sampling):
        comps = [jw.Component(i + 1, h, v, 0) for i, (h, v) in enumerate(sampling)]
        return jw.dct_coefficients(planes[:len(comps)],
                                   jw.Frame(24, 16, comps, {0: jw.LUMA_QUANT}))

    return {
        "12-bit": _patched(base, sof, 4, 12),
        "hierarchical JPEG \\(SOF5\\)": _patched(base, sof, 1, 0xC5),
        "lossless arithmetic-coded JPEG \\(SOF11\\)": _patched(lossless, b"\xff\xc3", 1, 0xCB),
        "fractional sampling": jw.write_huffman(frame([(3, 1), (2, 1), (1, 1)])),
        "an MCU of 12 blocks": jw.write_huffman(frame([(2, 2), (2, 2), (2, 2)])),
        "2 components": jw.write_huffman(frame([(1, 1), (1, 1)])),
        "lossless YCCK": jw.write_lossless(planes, [1, 2, 3, 4], markers=jw.adobe_segment(2)),
        "lossless YCbCr": jw.write_lossless(planes[:3], [1, 2, 3], markers=jw.JFIF),
        "not a JPEG": b"\x89PNG\r\n\x1a\n" + bytes(16),
        "truncated|RST|marker": base[:len(base) // 3],
    }


def test_unsupported_encodings_raise_naming_them():
    """What the decoder refuses is what Pillow refuses too: 12-bit samples,
    the hierarchical and lossless arithmetic processes, fractional sampling
    ratios, MCUs of more than 10 blocks, 2 components, lossless YCCK and
    YCbCr, a file that is not a JPEG, a truncated one. Each raises,
    naming it, and Pillow fails on the same bytes."""
    for what, data in _refused_by_pillow_too().items():
        with pytest.raises(Exception):
            np.array(Image.open(io.BytesIO(data)))
        with pytest.raises(ValueError, match=what):
            image_io.decode_jpeg(data)


def _mask_images(rng):
    from cutie_tpu_torch.utils.palette import davis_palette

    p = Image.fromarray(rng.integers(0, 6, (20, 30)).astype(np.uint8), "P")
    p.putpalette(davis_palette)
    return {
        "P": p,
        "L": Image.fromarray(rng.integers(0, 256, (20, 30)).astype(np.uint8), "L"),
        "RGB": Image.fromarray(rng.integers(0, 256, (20, 30, 3)).astype(np.uint8), "RGB"),
        "RGBA": Image.fromarray(rng.integers(0, 256, (20, 30, 4)).astype(np.uint8), "RGBA"),
        "LA": Image.fromarray(rng.integers(0, 256, (20, 30, 2)).astype(np.uint8), "LA"),
    }


@pytest.mark.parametrize("mode", ["P", "L", "RGB", "RGBA", "LA"])
def test_mask_conversions_match_pillow(tmp_path, mode):
    """convert('L') and convert('P') from every mode equal Pillow's
    (convert('P') of RGB is Pillow's dither onto its browser palette, of
    RGBA its fast octree quantizer)."""
    im = _mask_images(np.random.default_rng(0))[mode]
    path = tmp_path / f"{mode}.png"
    im.save(path)
    np.testing.assert_array_equal(image_io.read_mask(str(path), "L"),
                                  np.array(Image.open(path).convert("L")))
    np.testing.assert_array_equal(image_io.read_mask(str(path), "P"),
                                  np.array(Image.open(path).convert("P")))
    # a grayscale JPEG mask converts too
    if mode == "L":
        jpg = tmp_path / "mask.jpg"
        im.save(jpg)
        np.testing.assert_array_equal(image_io.read_mask(str(jpg), "L"),
                                      np.array(Image.open(jpg).convert("L")))


if __name__ == "__main__":
    write_fixtures()
    print(f"wrote {FIXTURES}: "
          f"{sum(p.stat().st_size for p in FIXTURES.rglob('*') if p.is_file())} bytes")
