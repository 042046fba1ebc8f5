"""The JPEG codings cutie_tpu reads through Pillow beyond baseline and
Huffman progressive, and the RGBA masks' convert('P'), read by the port
without Pillow (cutie_tpu_torch/utils/image_io.py), against Pillow 12 and
cutie_tpu.

- jpeg_codings/: small files of every coding the decoder
  (csrc_host/jpeg_decode.cpp) reads since the Adobe fix: an Adobe APP14
  segment on YCbCr (transform 1, with or without JFIF; transform 2), RGB
  by component ids or Adobe transform 0, unknown ids, no DHT (the
  standard tables), sampling factors 4:4:0 and others (fancy h1v2,
  integral replication, chroma sampled finer than luma), CMYK and YCCK,
  lossless (predictors 1-7, point transforms, restarts, sampling, RGB,
  CMYK), arithmetic coding (sequential and progressive, DAC conditioning,
  restarts) and progressive files cut short, which libjpeg-turbo smooths.
  Each decodes bit-equal to Pillow and to the manifest's hash, and
  converts to RGB as Pillow converts it.
- vos_encodings/: synth_a's 12 frames in four codings in turn (arithmetic
  sequential and progressive from the baseline frame's coefficients, the
  baseline file with an Adobe transform-1 segment, lossless RGB of its
  pixels), each bit-equal to the baseline frame; cutie_tpu's VideoReader
  and VOS dataset (with RGBA masks) against the port's on it.
- The writer itself (tests/jpeg_writer.py): the same coefficients written
  with Huffman and with arithmetic coding decode to the same pixels under
  Pillow.
- RGBA to 'P' (Pillow's fast octree, csrc_host/quantize_octree.cpp):
  indices and palette against Pillow's.

write_coding_fixtures() writes jpeg_codings/ and vos_encodings/ (called by
tests/test_torch_jpeg.py:write_fixtures, `python -m tests.test_torch_jpeg`).
"""
import functools
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from tests import jpeg_writer as jw  # noqa: E402
from tests.test_torch_jpeg import (FIXTURES, VOS_FRAMES, _blurred_frame,  # noqa: E402
                                   _decoded_sha, _pillow_decode, without_scan)
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.utils import image_io  # noqa: E402

CODINGS_DIR = "jpeg_codings"
VOS_ENCODINGS = "vos_encodings"
# frame ti of the twin takes TWIN_CODINGS[ti % 4]
TWIN_CODINGS = ("arithmetic_sequential", "arithmetic_progressive", "adobe_ycbcr",
                "lossless_rgb")
# the SOF marker each twin coding carries
TWIN_SOF = {"arithmetic_sequential": 0xC9, "arithmetic_progressive": 0xCA,
            "adobe_ycbcr": 0xC0, "lossless_rgb": 0xC3}

Q75 = {0: jw.scaled_quant(jw.LUMA_QUANT, 75), 1: jw.scaled_quant(jw.CHROMA_QUANT, 75)}
C = jw.Component


def _picture(w: int, h: int, seed: int = 40) -> np.ndarray:
    """[h, w, 3] uint8: the synthetic video's frame, box-blurred as the
    decoder matrix's (tests/test_torch_jpeg.py)."""
    from cutie_tpu_torch.utils.synth_video import synth_frames_480

    frames, _ = synth_frames_480(1, max(h, 8), max(w, 8), seed=seed)
    return np.array(_blurred_frame(frames[0][:, :h, :w], 1))


def _dct_frame(w, h, comps, planes, quant=Q75) -> jw.Frame:
    return jw.dct_coefficients([p[:h, :w] for p in planes], jw.Frame(w, h, comps, quant))


def _ycc(w, h, sampling, seed=40, ids=(1, 2, 3)):
    comps = [C(ids[i], *sampling[i], min(i, 1)) for i in range(3)]
    return _dct_frame(w, h, comps, jw.rgb_to_ycc(_picture(w, h, seed)))


def _without_dht(data: bytes) -> bytes:
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out + data[pos:])


def _first_scans(data: bytes, keep: int) -> bytes:
    """A progressive file cut after its first `keep` scans (EOI kept)."""
    for i in range(data.count(b"\xff\xda") - 1, keep - 1, -1):
        data = without_scan(data, i)
    return data


def _cmyk_planes(w, h):
    rgb = _picture(w, h, 42)
    return [rgb[..., 0], rgb[..., 1], rgb[..., 2], 255 - rgb.max(-1)]


def _ycck_planes(w, h):
    rgb = _picture(w, h, 42)
    return jw.rgb_to_ycc(255 - rgb) + [255 - rgb.max(-1)]


def _pillow_cmyk(w, h) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_picture(w, h, 43)).convert("CMYK").save(buf, "JPEG", quality=80)
    return buf.getvalue()


def _matrix(name: str) -> bytes:
    return (FIXTURES / "jpeg" / f"{name}.jpg").read_bytes()


W, H = 37, 29   # the size of most jpeg_codings/ fixtures


@functools.cache
def _gray() -> np.ndarray:
    return _picture(W, H, 44).mean(-1).astype(np.uint8)


@functools.cache
def _rgb_planes():
    rgb = _picture(W, H, 45)
    return [rgb[..., i] for i in range(3)]


@functools.cache
def _seq420() -> jw.Frame:
    return _ycc(W, H, [(2, 2), (1, 1), (1, 1)])


@functools.cache
def _gray_frame() -> jw.Frame:
    return _dct_frame(W, H, [C(1, 1, 1, 0)], [_gray()])


@functools.cache
def _cmyk_frame() -> jw.Frame:
    return _dct_frame(W, H, [C(i + 1, 1, 1, min(i, 1)) for i in range(4)], _cmyk_planes(W, H))


def _rgb_ids_frame() -> jw.Frame:
    return _dct_frame(W, H, [C(82, 1, 1, 0), C(71, 1, 1, 0), C(66, 1, 1, 0)], _rgb_planes())


# name -> what writes each jpeg_codings/ fixture (deterministic bytes)
CODINGS = {
    # colour space: Adobe segments, component ids, no markers; no DHT
    "adobe1_jfif_q75_420": lambda: jw.insert_segment(_matrix("q75_420"), jw.adobe_segment(1)),
    "adobe1_q75_422": lambda: jw.insert_segment(_matrix("q75_422"), jw.adobe_segment(1),
                                                replace_app0=True),
    "adobe2_q75_444": lambda: jw.insert_segment(_matrix("q75_444"), jw.adobe_segment(2),
                                                replace_app0=True),
    "no_dht_q75_420": lambda: _without_dht(_matrix("q75_420")),
    "rgb_ids_444": lambda: jw.write_huffman(_rgb_ids_frame(), markers=b""),
    "rgb_ids_jfif_444": lambda: jw.write_huffman(_rgb_ids_frame()),
    "adobe0_rgb_420": lambda: jw.write_huffman(
        _dct_frame(W, H, [C(1, 2, 2, 0), C(2, 1, 1, 0), C(3, 1, 1, 0)], _rgb_planes()),
        markers=jw.adobe_segment(0)),
    "unknown_ids_444": lambda: jw.write_huffman(_ycc(W, H, [(1, 1)] * 3, ids=(7, 8, 9)),
                                                markers=b""),
    "huffman_one_scan_a_component_420": lambda: jw.write_huffman(_seq420(), interleaved=False),
    # sampling factors
    "s440_37x29": lambda: jw.write_huffman(_ycc(W, H, [(1, 2), (1, 1), (1, 1)])),
    "s440_3x9": lambda: jw.write_huffman(_ycc(3, 9, [(1, 2), (1, 1), (1, 1)])),
    "s411_37x29": lambda: jw.write_huffman(_ycc(W, H, [(4, 1), (1, 1), (1, 1)])),
    "s410_37x29": lambda: jw.write_huffman(_ycc(W, H, [(4, 2), (1, 1), (1, 1)])),
    "s_y2x4_37x29": lambda: jw.write_huffman(_ycc(W, H, [(2, 4), (1, 1), (1, 1)])),
    "s_chroma_finer_37x29": lambda: jw.write_huffman(_ycc(W, H, [(1, 1), (2, 2), (1, 1)])),
    "s_mixed_17x33": lambda: jw.write_huffman(_ycc(17, 33, [(2, 2), (1, 2), (2, 1)])),
    "s_mixed_3x9": lambda: jw.write_huffman(_ycc(3, 9, [(2, 2), (2, 1), (1, 2)])),
    # four components
    "cmyk_pillow_q80": lambda: _pillow_cmyk(W, H),
    "cmyk_no_adobe_444": lambda: jw.write_huffman(_cmyk_frame(), markers=b""),
    "ycck_adobe2_2112": lambda: jw.write_huffman(
        _dct_frame(W, H, [C(1, 2, 2, 0), C(2, 1, 1, 1), C(3, 1, 1, 1), C(4, 2, 2, 0)],
                   _ycck_planes(W, H)), markers=jw.adobe_segment(2)),
    "ycck_adobe1_444": lambda: jw.write_huffman(
        _dct_frame(W, H, [C(i + 1, 1, 1, min(i, 1)) for i in range(4)], _ycck_planes(W, H)),
        markers=jw.adobe_segment(1)),
    "cmyk_arith_progressive": lambda: jw.write_arithmetic(_cmyk_frame(), progressive=True,
                                                          markers=jw.adobe_segment(0)),
    # lossless
    **{f"lossless_gray_p{psv}_pt{pt}":
       (lambda psv=psv, pt=pt: jw.write_lossless([_gray()], [1], psv=psv, pt=pt))
       for psv, pt in ((1, 0), (2, 1), (3, 2), (4, 0), (5, 3), (6, 0), (7, 1))},
    "lossless_gray_restart_p4": lambda: jw.write_lossless([_gray()], [1], psv=4, restart_rows=2),
    "lossless_rgb_ids_p7": lambda: jw.write_lossless(_rgb_planes(), [82, 71, 66], psv=7),
    "lossless_rgb_adobe0_one_scan_a_component_p5": lambda: jw.write_lossless(
        _rgb_planes(), [1, 2, 3], psv=5, markers=jw.adobe_segment(0), interleaved=False),
    "lossless_ids123_p1": lambda: jw.write_lossless(_rgb_planes(), [1, 2, 3], psv=1),
    "lossless_cmyk_adobe0_p6": lambda: jw.write_lossless(
        _cmyk_planes(W, H), [1, 2, 3, 4], psv=6, markers=jw.adobe_segment(0)),
    "lossless_rgb_2x2_restart_p3": lambda: jw.write_lossless(
        [_rgb_planes()[0], _rgb_planes()[1][::2, ::2], _rgb_planes()[2][::2, ::2]],
        [82, 71, 66], psv=3, sampling=[(2, 2), (1, 1), (1, 1)], restart_rows=2),
    # arithmetic coding
    "arith_sequential_gray": lambda: jw.write_arithmetic(_gray_frame()),
    "arith_sequential_420": lambda: jw.write_arithmetic(_seq420()),
    "arith_sequential_422_dac_restart": lambda: jw.write_arithmetic(
        _ycc(W, H, [(2, 1), (1, 1), (1, 1)]), restart=3,
        conditioning={0: jw.Conditioning(1, 4, 12), 1: jw.Conditioning(0, 0, 2)}),
    "arith_progressive_420": lambda: jw.write_arithmetic(_seq420(), progressive=True),
    "arith_progressive_444_restart": lambda: jw.write_arithmetic(
        _ycc(W, H, [(1, 1)] * 3), progressive=True, restart=5),
    "arith_progressive_gray": lambda: jw.write_arithmetic(_gray_frame(), progressive=True),
    # progressive files cut short: libjpeg-turbo's block smoothing
    "arith_progressive_420_first6": lambda: jw.write_arithmetic(
        _seq420(), progressive=True, script=jw.simple_progression(3)[:6]),
    "arith_progressive_420_dc_only": lambda: jw.write_arithmetic(
        _seq420(), progressive=True, script=jw.simple_progression(3)[:1]),
    "smooth_q75_420_first9": lambda: _first_scans(_matrix("q75_420_progressive"), 9),
    "smooth_q75_420_first5": lambda: _first_scans(_matrix("q75_420_progressive"), 5),
    "smooth_q75_420_dc_only": lambda: _first_scans(_matrix("q75_420_progressive"), 1),
    "smooth_gray_q95_odd_first3": lambda: _first_scans(_matrix("gray_q95_odd_progressive"), 3),
}


def coding_fixtures():
    """name -> the bytes of each jpeg_codings/ fixture."""
    return {name: write() for name, write in CODINGS.items()}


def twin_frame(ti: int, baseline: bytes) -> bytes:
    """synth_a's frame ti in its TWIN_CODINGS coding, from the committed
    baseline file: its coefficients, its bytes or its decoded pixels."""
    coding = TWIN_CODINGS[ti % 4]
    k = ti // 4
    if coding == "adobe_ycbcr":   # the JFIF segment replaced, or kept beside it
        return jw.insert_segment(baseline, jw.adobe_segment(1), replace_app0=k != 1)
    if coding == "lossless_rgb":
        rgb = np.array(Image.open(io.BytesIO(baseline)))
        planes = [rgb[..., i] for i in range(3)]
        if k == 1:
            return jw.write_lossless(planes, [1, 2, 3], psv=4, markers=jw.adobe_segment(0))
        return jw.write_lossless(planes, [82, 71, 66], psv=(7, 4, 1)[k],
                                 restart_rows=60 if k == 2 else 0)
    frame = jw.read_coefficients(baseline)
    kw = ([{}, {"restart": 53}, {"conditioning": {0: jw.Conditioning(1, 4, 8)}}][k]
          if coding == "arithmetic_sequential" else [{}, {"restart": 40}, {}][k])
    return jw.write_arithmetic(frame, progressive=coding == "arithmetic_progressive", **kw)


def write_coding_fixtures(root: Path = FIXTURES) -> None:
    """Write jpeg_codings/ and vos_encodings/ under root (the decoder
    matrix and the VOS set must be written first)."""
    for name in (CODINGS_DIR, VOS_ENCODINGS):
        if (root / name).exists():
            shutil.rmtree(root / name)
    (root / CODINGS_DIR).mkdir(parents=True)
    for name, data in coding_fixtures().items():
        (root / CODINGS_DIR / f"{name}.jpg").write_bytes(data)
    frames = root / VOS_ENCODINGS / "JPEGImages" / "synth_a"
    masks = root / VOS_ENCODINGS / "Annotations" / "synth_a"
    frames.mkdir(parents=True)
    masks.mkdir(parents=True)
    for ti in range(VOS_FRAMES):
        baseline = (root / "vos" / "JPEGImages" / "synth_a" / f"{ti:05d}.jpg").read_bytes()
        (frames / f"{ti:05d}.jpg").write_bytes(twin_frame(ti, baseline))
    shutil.copy(root / "vos" / "Annotations" / "synth_a" / "00000.png", masks)


def _manifest():
    return json.loads((FIXTURES / "manifest.json").read_text())


def _sof(data: bytes) -> int:
    """The frame header's marker code."""
    for marker, _, _ in jw._segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return marker
    raise AssertionError("no frame header")


@pytest.mark.parametrize("name", sorted(CODINGS))
def test_coding_bit_equal_to_pillow(name):
    """Each jpeg_codings/ fixture: the port's decode and mode equal
    Pillow's and the manifest's hash; read_image equals convert('RGB')
    (Convert.c:cmyk2rgb for CMYK) and read_rgba convert('RGBA')."""
    path = FIXTURES / CODINGS_DIR / f"{name}.jpg"
    pixels, mode = image_io.read_jpeg(str(path))
    with Image.open(path) as ref:
        assert mode == ref.mode
        np.testing.assert_array_equal(pixels, np.array(ref))
        np.testing.assert_array_equal(image_io.read_image(str(path)), np.array(ref.convert("RGB")))
        np.testing.assert_array_equal(image_io.read_rgba(str(path)), np.array(ref.convert("RGBA")))
    entry = _manifest()[f"{CODINGS_DIR}/{name}.jpg"]
    assert list(pixels.shape) == entry["shape"] and _decoded_sha(pixels) == entry["sha256"]


def test_coding_fixtures_are_the_codings_named():
    """The committed files are what coding_fixtures() writes, and carry the
    frame header and segments their names promise."""
    want = coding_fixtures()
    assert sorted(p.stem for p in (FIXTURES / CODINGS_DIR).glob("*.jpg")) == sorted(want)
    for name, data in want.items():
        assert (FIXTURES / CODINGS_DIR / f"{name}.jpg").read_bytes() == data, name
        sof = _sof(data)
        if name.startswith("lossless"):
            assert sof == 0xC3, name
        elif name.startswith("arith") or name == "cmyk_arith_progressive":
            assert sof == (0xCA if "progressive" in name else 0xC9), name
        adobe = "adobe" in name.replace("no_adobe", "") or name in ("cmyk_pillow_q80",
                                                                     "cmyk_arith_progressive")
        assert (b"Adobe" in data) == adobe, name
        if "dac" in name:
            assert b"\xff\xcc" in data, name
    # the Adobe segment of the fault: transform 1 on Pillow's own q75_420
    assert want["adobe1_jfif_q75_420"][2:4] == b"\xff\xee"
    assert want["adobe1_jfif_q75_420"][2 + 2 + 2 + 11] == 1


def test_adobe_transform_1_decodes_as_without_it():
    """The fault of the Adobe check: Photoshop writes an Adobe segment with
    transform 1 (YCbCr) on ordinary JPEGs; such a file decodes as the file
    without it, as under Pillow."""
    base = _matrix("q75_420")
    data = jw.insert_segment(base, jw.adobe_segment(1))
    np.testing.assert_array_equal(image_io.decode_jpeg(data), image_io.decode_jpeg(base))
    np.testing.assert_array_equal(image_io.decode_jpeg(data),
                                  np.array(Image.open(io.BytesIO(data))))


WRITER_CASES = {
    "gray": [(1, 1)],
    "444": [(1, 1)] * 3,
    "420": [(2, 2), (1, 1), (1, 1)],
    "440": [(1, 2), (1, 1), (1, 1)],
    "mixed": [(2, 2), (1, 2), (2, 1)],
    "cmyk": [(1, 1), (1, 1), (1, 1), (2, 2)],
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_writer_huffman_and_arithmetic_agree(case):
    """The same coefficients written with Huffman coding, with arithmetic
    coding (sequential, with restarts and DAC conditioning) and
    progressive arithmetic coding decode to the same pixels under Pillow,
    and the port's decode of each equals Pillow's."""
    sampling = WRITER_CASES[case]
    w, h = 45, 27
    planes = jw.rgb_to_ycc(_picture(w, h, 46))
    planes = (planes + [planes[0]])[:len(sampling)]
    comps = [C(i + 1, *s, min(i, 1)) for i, s in enumerate(sampling)]
    frame = _dct_frame(w, h, comps, planes)
    markers = jw.adobe_segment(0) if len(comps) == 4 else jw.JFIF
    huffman = jw.write_huffman(frame, markers=markers)
    want = np.array(Image.open(io.BytesIO(huffman)))
    codings = [jw.write_arithmetic(frame, markers=markers),
               jw.write_arithmetic(frame, markers=markers, restart=2,
                                   conditioning={0: jw.Conditioning(2, 3, 1)}),
               jw.write_arithmetic(frame, markers=markers, progressive=True, restart=3)]
    for data in [huffman] + codings:
        np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(data))), want)
        np.testing.assert_array_equal(image_io.decode_jpeg(data), want)


def test_arithmetic_file_past_pillows_first_read():
    """libjpeg's arithmetic decoder cannot suspend for more data, and
    Pillow hands it the file 64 KiB at a time (ImageFile.MAXBLOCK): an
    arithmetic-coded file whose scan runs past that fails under Pillow. The
    port decodes it (ROADMAP.md D17), to the pixels Pillow decodes from the
    same coefficients Huffman-coded."""
    noise = np.random.default_rng(8).integers(0, 256, (256, 320)).astype(np.uint8)
    frame = _dct_frame(320, 256, [C(1, 1, 1, 0)], [noise], {0: np.ones(64, np.int64)})
    data = jw.write_arithmetic(frame)
    assert len(data) > 65536
    with pytest.raises(OSError):
        np.array(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(image_io.decode_jpeg(data),
                                  np.array(Image.open(io.BytesIO(jw.write_huffman(frame)))))


def test_read_coefficients_rewrites_pillow_files_byte_for_byte():
    """read_coefficients + write_huffman reproduce a file Pillow wrote with
    the standard tables (4:2:0 and grayscale), so the twin's arithmetic
    frames hold the baseline frame's coefficients."""
    for name in ("q75_420", "gray_q75"):
        data = _matrix(name)
        frame = jw.read_coefficients(data)
        again = jw.write_huffman(frame)
        np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(again))),
                                      _pillow_decode(FIXTURES / "jpeg" / f"{name}.jpg"))


def test_progressive_cut_short_matches_pillow():
    """30 seeded images saved progressive by Pillow (Huffman) or the writer
    (arithmetic), cut after a random number of scans: libjpeg-turbo smooths
    their unrefined blocks, and the port equals Pillow's decode."""
    rng = np.random.default_rng(11)
    for i in range(30):
        w, h = int(rng.integers(1, 70)), int(rng.integers(1, 60))
        img = np.clip(_picture(w, h, 47).astype(np.float64)
                      + rng.normal(0, rng.choice([2, 20]), (h, w, 3)), 0, 255).astype(np.uint8)
        q = int(rng.integers(10, 95))
        if i % 2:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=q, progressive=True,
                                      subsampling=int(rng.integers(0, 3)))
            data = buf.getvalue()
            data = _first_scans(data, int(rng.integers(1, data.count(b"\xff\xda") + 1)))
        else:
            frame = _dct_frame(w, h, [C(1, 2, 2, 0), C(2, 1, 1, 1), C(3, 1, 1, 1)],
                               jw.rgb_to_ycc(img), {0: jw.scaled_quant(jw.LUMA_QUANT, q),
                                                    1: jw.scaled_quant(jw.CHROMA_QUANT, q)})
            script = jw.simple_progression(3)
            data = jw.write_arithmetic(frame, progressive=True,
                                       script=script[:int(rng.integers(1, len(script) + 1))])
        np.testing.assert_array_equal(image_io.decode_jpeg(data),
                                      np.array(Image.open(io.BytesIO(data))),
                                      err_msg=f"image {i}: {w}x{h} q{q}")


# ------------------------------------------------------------- the twin

def test_vos_encodings_twin_bit_equal_to_baseline():
    """The 12 frames of vos_encodings/ are the codings TWIN_CODINGS names,
    twin_frame's output, and decode to the baseline synth_a frames, to
    Pillow's arrays and to the manifest; the first mask is the baseline's."""
    manifest = _manifest()
    twin = sorted((FIXTURES / VOS_ENCODINGS / "JPEGImages" / "synth_a").iterdir())
    assert len(twin) == VOS_FRAMES
    for ti, path in enumerate(twin):
        data = path.read_bytes()
        assert _sof(data) == TWIN_SOF[TWIN_CODINGS[ti % 4]], path.name
        base = FIXTURES / "vos" / "JPEGImages" / "synth_a" / path.name
        if ti < 3:   # the first frame of each coding but lossless (~2 s a frame)
            assert data == twin_frame(ti, base.read_bytes()), path.name
        got = image_io.read_image(str(path))
        np.testing.assert_array_equal(got, _pillow_decode(path), err_msg=path.name)
        np.testing.assert_array_equal(got, image_io.read_image(str(base)), err_msg=path.name)
        assert _decoded_sha(got) == manifest[path.relative_to(FIXTURES).as_posix()]["sha256"]
    assert ((FIXTURES / VOS_ENCODINGS / "Annotations" / "synth_a" / "00000.png").read_bytes()
            == (FIXTURES / "vos" / "Annotations" / "synth_a" / "00000.png").read_bytes())


def test_video_reader_matches_cutie_tpu_on_the_encodings_twin():
    """cutie_tpu's VideoReader (Pillow) and the port's over vos_encodings/
    at size 480 and -1: the same frames, first mask, labels and info."""
    from cutie_tpu.data.video_reader import VideoReader as Ref
    from cutie_tpu_torch.data.video_reader import VideoReader

    image_dir = str(FIXTURES / VOS_ENCODINGS / "JPEGImages" / "synth_a")
    mask_dir = str(FIXTURES / VOS_ENCODINGS / "Annotations" / "synth_a")
    for size in (480, -1):
        port = VideoReader("synth_a", image_dir, mask_dir, size=size)
        ref = Ref("synth_a", image_dir, mask_dir, size=size)
        assert len(port) == len(ref) == VOS_FRAMES
        assert port.get_palette() == ref.get_palette()
        for idx in (0, 1, 2, 3):   # one frame of each coding
            a, b = port[idx], ref[idx]
            np.testing.assert_array_equal(a["rgb"], b["rgb"])
            assert ("mask" in a) == ("mask" in b) == (idx == 0)
            if idx == 0:
                np.testing.assert_array_equal(a["mask"], b["mask"])
                np.testing.assert_array_equal(a["valid_labels"], b["valid_labels"])
            assert a["info"] == b["info"]


def _rgba_mask(pixels: np.ndarray, palette) -> np.ndarray:
    """A palette mask as RGBA: each object's colour, opaque; the
    background transparent black."""
    table = np.zeros((256, 4), np.uint8)
    table[:len(palette) // 3, :3] = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
    table[1:, 3] = 255
    return table[pixels]


def test_vos_dataset_matches_cutie_tpu_on_the_encodings_twin_and_rgba_masks(tmp_path):
    """VOSMergeTrainDataset.get over the twin's frames with RGBA masks
    (cutie_tpu's convert('P') quantizes them by the fast octree) equals
    cutie_tpu's, with and without the merge."""
    from cutie_tpu.data.vos_dataset import VOSMergeTrainDataset as Ref
    from cutie_tpu_torch.data.vos_dataset import VOSMergeTrainDataset
    from tests.test_torch_data_pipeline import assert_sample_equal

    root = tmp_path / "vos"
    for vid in ("synth_a", "synth_b"):
        src = (FIXTURES / VOS_ENCODINGS / "JPEGImages" / "synth_a" if vid == "synth_a"
               else FIXTURES / "vos" / "JPEGImages" / vid)
        shutil.copytree(src, root / "JPEGImages" / vid)
        (root / "Annotations" / vid).mkdir(parents=True)
        for ti in range(VOS_FRAMES):
            mask, _, palette = image_io.read_png(
                str(FIXTURES / "vos" / "Annotations" / vid / f"{ti:05d}.png"))
            Image.fromarray(_rgba_mask(mask, palette), "RGBA").save(
                root / "Annotations" / vid / f"{ti:05d}.png")
    cfg = {"rgba": {"im_root": str(root / "JPEGImages"), "gt_root": str(root / "Annotations"),
                    "max_skip": 3, "subset": None, "empty_masks": None, "multiplier": 1}}
    assert image_io.read_png(str(root / "Annotations" / "synth_a" / "00000.png"))[1] == "RGBA"
    for merge in (0.0, 1.0):
        kw = dict(seq_length=3, max_num_obj=3, size=64, merge_probability=merge)
        port, ref = VOSMergeTrainDataset(cfg, **kw), Ref(cfg, **kw)
        assert port.video_frames == ref.video_frames
        for idx in (0, 13):
            a = port.get(idx, np.random.default_rng(idx))
            b = ref.get(idx, np.random.default_rng(idx))
            assert_sample_equal(a, b)


# ----------------------------------------------------------- RGBA to P

def _rgba_images():
    rng = np.random.default_rng(5)
    few = rng.integers(0, 256, (7, 4)).astype(np.uint8)
    few[:, 3] = [0, 255, 255, 0, 128, 255, 255]
    noisy = np.clip(rng.integers(0, 256, 4) + rng.normal(0, 25, (40, 50, 4)), 0, 255)
    noisy[..., 3] = rng.choice([0, 100, 255], (40, 50))
    return {
        "random": rng.integers(0, 256, (33, 47, 4)).astype(np.uint8),
        "few_colours": few[rng.integers(0, 7, (31, 29))],
        "opaque": np.concatenate([rng.integers(0, 256, (20, 60, 3)),
                                  np.full((20, 60, 1), 255)], -1).astype(np.uint8),
        "noisy_alpha": noisy.astype(np.uint8),
        "one_pixel": np.array([[[10, 20, 30, 0]]], np.uint8),
        "large": rng.integers(0, 256, (300, 301, 4)).astype(np.uint8),
    }


@pytest.mark.parametrize("case", sorted(_rgba_images()))
def test_rgba_to_p_matches_pillow_quantize(tmp_path, case):
    """convert('P') of RGBA: quantize_rgba's indices and palette equal
    Pillow's fast octree (Image.quantize(256)), and read_mask(path, 'P')
    of the PNG equals Image.open(path).convert('P')."""
    rgba = _rgba_images()[case]
    im = Image.fromarray(rgba, "RGBA").convert("P")
    indices, palette = image_io.quantize_rgba(rgba)
    np.testing.assert_array_equal(indices, np.array(im))
    assert im.palette.mode == "RGBA"
    assert palette.ravel().tolist() == im.getpalette("RGBA")
    path = tmp_path / "mask.png"
    Image.fromarray(rgba, "RGBA").save(path)
    np.testing.assert_array_equal(image_io.read_mask(str(path), "P"),
                                  np.array(Image.open(path).convert("P")))


def test_cmyk_conversions_match_pillow():
    """A CMYK JPEG through every conversion the readers make: RGB, RGBA,
    and the masks' 'L' and 'P' (both through RGB, as Pillow converts)."""
    path = FIXTURES / CODINGS_DIR / "cmyk_pillow_q80.jpg"
    with Image.open(path) as ref:
        assert ref.mode == "CMYK"
        for target, got in (("RGB", image_io.read_image(str(path))),
                            ("RGBA", image_io.read_rgba(str(path))),
                            ("L", image_io.read_mask(str(path), "L")),
                            ("P", image_io.read_mask(str(path), "P"))):
            np.testing.assert_array_equal(got, np.array(ref.convert(target)), err_msg=target)
    rng = np.random.default_rng(6)
    cmyk = rng.integers(0, 256, (17, 23, 4)).astype(np.uint8)
    np.testing.assert_array_equal(image_io.cmyk_to_rgb(cmyk),
                                  np.array(Image.fromarray(cmyk, "CMYK").convert("RGB")))
