"""The port's image I/O (cutie_tpu_torch/utils/image_io.py) against Pillow,
its copies of rle and palette against cutie_tpu's, and its config presets,
get_dataset_cfg and command-line overrides against cutie_tpu's."""
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

pytest.importorskip("torch")

from cutie_tpu.config import config as jax_config  # noqa: E402
from cutie_tpu.data.video_reader import _resize_shorter  # noqa: E402
from cutie_tpu.utils import palette as jax_palette  # noqa: E402
from cutie_tpu.utils import rle as jax_rle  # noqa: E402
from cutie_tpu_torch.config import config as port_config  # noqa: E402
from cutie_tpu_torch.utils import image_io  # noqa: E402
from cutie_tpu_torch.utils import palette as port_palette  # noqa: E402
from cutie_tpu_torch.utils import rle as port_rle  # noqa: E402
from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

RNG_SEED = 0


def _png(w, h, bits, color_type, rows, plte=None, interlace=0):
    """A PNG file's bytes from already-filtered rows (each with its filter
    byte), for the layouts Pillow does not write."""
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    out = [image_io.PNG_SIGNATURE,
           chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color_type, 0, 0,
                                      interlace))]
    if plte is not None:
        out.append(chunk(b"PLTE", bytes(plte)))
    out += [chunk(b"IDAT", zlib.compress(b"".join(rows))), chunk(b"IEND", b"")]
    return b"".join(out)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filter_rows(pixels, bpp):
    """PNG's forward filters, row r by filter r % 5, in plain Python: the
    reference the decoder's five inverse filters are held to."""
    rows, prior = [], [0] * len(pixels[0])
    for r, line in enumerate(pixels):
        line = [int(x) for x in line]
        kind = r % 5
        out = []
        for i, x in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            b, c = prior[i], (prior[i - bpp] if i >= bpp else 0)
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((x - pred) & 255)
        rows.append(bytes([kind] + out))
        prior = line
    return rows


def _pack(values, bits):
    """Rows of samples packed `bits` to a byte, filter byte 0."""
    rows = []
    for line in values:
        acc, out, n = 0, [], 0
        for v in line:
            acc = (acc << bits) | int(v)
            n += bits
            if n == 8:
                out.append(acc)
                acc, n = 0, 0
        if n:
            out.append(acc << (8 - n))
        rows.append(bytes([0] + out))
    return rows


def _pillow_written(tmp_path, case):
    rng = np.random.default_rng(RNG_SEED)
    path = tmp_path / f"{case}.png"
    if case.startswith("palette_"):
        entries = {"palette_1bit": 2, "palette_2bit": 3, "palette_4bit": 16,
                   "palette_8bit": 256}[case]
        im = Image.fromarray(rng.integers(0, entries, (37, 53)).astype(np.uint8),
                             mode="P")
        im.putpalette(list(rng.integers(0, 256, 3 * entries)))
    elif case == "youtube_palette":
        im = Image.fromarray(rng.integers(0, 16, (37, 53)).astype(np.uint8), mode="P")
        im.putpalette(port_palette.youtube_palette)
    elif case == "L":
        im = Image.fromarray(rng.integers(0, 256, (37, 53)).astype(np.uint8))
    elif case in ("RGB", "RGBA"):
        im = Image.fromarray(rng.integers(0, 256, (37, 53, len(case))).astype(np.uint8))
    elif case == "LA":
        im = Image.fromarray(rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)).convert("LA")
    elif case == "mode_1":
        im = Image.fromarray(rng.integers(0, 2, (37, 53)).astype(bool))
    else:  # adaptive_rgb: smooth noisy RGB, so that Pillow's adaptive filtering picks several filters
        y, x = np.mgrid[0:120, 0:200]
        im = Image.fromarray((np.stack([(x + y) % 256, (2 * x) % 256, (3 * y) % 256], -1)
                              + rng.integers(0, 8, (120, 200, 3))).astype(np.uint8))
    im.save(path)
    return path


def _hand_written(tmp_path, case):
    rng = np.random.default_rng(RNG_SEED)
    path = tmp_path / f"{case}.png"
    if case == "all_filters_rgb":
        # few levels: Paeth's predictor often ties (a + b = 2c), and its
        # tie order decides the value
        px = (rng.integers(0, 3, (23, 17, 3)) * 100 + 7).astype(np.uint8)
        data = _png(17, 23, 8, 2, _filter_rows(px.reshape(23, -1), 3))
    elif case == "all_filters_palette":
        px = rng.integers(0, 7, (19, 31)).astype(np.uint8)
        data = _png(31, 19, 8, 3, _filter_rows(px, 1),
                    plte=rng.integers(0, 256, 21).astype(np.uint8).tobytes())
    else:  # gray_2bit, gray_4bit
        bits = int(case[5])
        px = rng.integers(0, 1 << bits, (13, 21))
        data = _png(21, 13, bits, 0, _pack(px, bits))
    path.write_bytes(data)
    return path


PILLOW_CASES = ["palette_1bit", "palette_2bit", "palette_4bit", "palette_8bit",
                "youtube_palette", "L", "RGB", "RGBA", "LA", "mode_1",
                "adaptive_rgb"]
HAND_CASES = ["all_filters_rgb", "all_filters_palette", "gray_2bit", "gray_4bit"]


@pytest.mark.parametrize("case", PILLOW_CASES + HAND_CASES)
def test_png_decoder_matches_pillow(tmp_path, case):
    """Pixels, mode and palette equal to what Pillow reads, and to_rgb
    equal to Image.convert('RGB')."""
    path = (_pillow_written if case in PILLOW_CASES else _hand_written)(tmp_path, case)
    pixels, mode, palette = image_io.read_png(str(path))
    ref = Image.open(path)
    want = np.array(ref)
    assert (mode, pixels.dtype, pixels.shape) == (ref.mode, want.dtype, want.shape)
    np.testing.assert_array_equal(pixels, want)
    assert palette == ref.getpalette()
    np.testing.assert_array_equal(image_io.read_image(str(path)),
                                  np.array(ref.convert("RGB")))
    if case == "adaptive_rgb":   # the case is only worth its name if so
        raw = zlib.decompress(b"".join(p for k, p in image_io._chunks(path.read_bytes())
                                       if k == b"IDAT"))
        filters = np.frombuffer(raw, np.uint8).reshape(120, -1)[:, 0]
        assert len(set(filters.tolist()) - {0}) >= 3, np.bincount(filters)
    if case in ("palette_2bit", "palette_4bit", "youtube_palette"):
        header = struct.unpack(">IIBBBBB", path.read_bytes()[16:29])
        assert header[2] < 8, header   # Pillow packed it


@pytest.mark.parametrize("kind", ["davis_palette", "youtube_palette", "L", "RGB"])
def test_png_writer_read_by_pillow(tmp_path, kind):
    rng = np.random.default_rng(RNG_SEED)
    palette = {"davis_palette": port_palette.davis_palette,
               "youtube_palette": port_palette.youtube_palette}.get(kind)
    shape = (29, 41, 3) if kind == "RGB" else (29, 41)
    high = 16 if kind == "youtube_palette" else 256
    pixels = rng.integers(0, high, shape).astype(np.uint8)
    path = tmp_path / "w.png"
    image_io.write_png(str(path), pixels, palette)
    ref = Image.open(path)
    assert ref.mode == ("P" if palette is not None else kind)
    np.testing.assert_array_equal(np.array(ref), pixels)
    if palette is not None:
        assert ref.getpalette() == list(palette)
    np.testing.assert_array_equal(image_io.read_png(str(path))[0], pixels)


@pytest.mark.parametrize("header", [dict(bits=16, color_type=2), dict(interlace=1)])
def test_png_rejects_16_bit_and_interlaced(tmp_path, header):
    """A 16-bit RGB and an Adam7-interlaced grayscale file decode as Pillow
    decodes them; what PNG leaves undefined, a 16-bit palette and
    interlace method 2, raises."""
    from tests.test_torch_image_formats import png_bytes

    rng = np.random.default_rng(RNG_SEED)
    args = dict(bits=8, color_type=0, interlace=0)
    args.update(header)
    channels = 3 if args["color_type"] == 2 else 1
    samples = rng.integers(0, 1 << args["bits"], (5, 7, channels))
    path = tmp_path / "x.png"
    path.write_bytes(png_bytes(samples, args["bits"], args["color_type"],
                               interlace=args["interlace"], rng=rng))
    pixels, mode, _ = image_io.read_png(str(path))
    ref = Image.open(path)
    assert mode == ref.mode
    np.testing.assert_array_equal(pixels, np.array(ref))
    np.testing.assert_array_equal(image_io.read_image(str(path)), np.array(ref.convert("RGB")))
    bad = dict(bits=16, color_type=3) if args["bits"] == 16 else dict(bits=8, color_type=0,
                                                                        interlace=2)
    bad = dict(args, **bad)
    path.write_bytes(_png(4, 2, bad["bits"], bad["color_type"], [b"\0" * 9] * 2,
                          plte=b"\0" * 3, interlace=bad["interlace"]))
    with pytest.raises(ValueError, match="16-bit samples in PNG colour type 3|interlace method 2"):
        image_io.read_png(str(path))


SHAPE_PAIRS = [((720, 1280), (480, 854)), ((480, 854), (600, 1067)),
               ((333, 500), (480, 721)), ((1080, 1920), (480, 853)),
               ((96, 128), (48, 64)), ((37, 100), (13, 211))]


@pytest.mark.parametrize("src,dst", SHAPE_PAIRS, ids=lambda s: "x".join(map(str, s)))
def test_resizes_match_pillow(src, dst):
    """BILINEAR on RGB and L images, NEAREST on index masks, bit for bit."""
    rng = np.random.default_rng(RNG_SEED)
    rgb = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    size = (dst[1], dst[0])
    np.testing.assert_array_equal(image_io.resize_bilinear(rgb, *dst),
                                  np.array(Image.fromarray(rgb).resize(size, Image.BILINEAR)))
    gray = rgb[..., 1].copy()
    np.testing.assert_array_equal(image_io.resize_bilinear(gray, *dst),
                                  np.array(Image.fromarray(gray).resize(size, Image.BILINEAR)))
    mask = rng.integers(0, 5, src).astype(np.uint8)
    np.testing.assert_array_equal(image_io.resize_nearest(mask, *dst),
                                  np.array(Image.fromarray(mask).resize(size, Image.NEAREST)))


@pytest.mark.parametrize("size", [480, 600, 64])
def test_resize_shorter_matches_cutie_tpu(size):
    """The readers' shorter-edge resize against cutie_tpu's, which is
    Pillow's, on a frame and a palette mask."""
    rng = np.random.default_rng(RNG_SEED)
    rgb = rng.integers(0, 256, (720, 1280, 3)).astype(np.uint8)
    mask = rng.integers(0, 4, (720, 1280)).astype(np.uint8)
    pmask = Image.fromarray(mask, mode="P")
    pmask.putpalette(port_palette.davis_palette)
    np.testing.assert_array_equal(
        image_io.resize_shorter(rgb, size, bilinear=True),
        np.array(_resize_shorter(Image.fromarray(rgb), size, Image.BILINEAR)))
    np.testing.assert_array_equal(
        image_io.resize_shorter(mask, size, bilinear=False),
        np.array(_resize_shorter(pmask, size, Image.NEAREST)))


def test_rle_and_palette_match_cutie_tpu():
    rng = np.random.default_rng(RNG_SEED)
    for shape in [(1, 1), (7, 5), (64, 48), (480, 854)]:
        for density in (0.0, 0.02, 0.5, 1.0):
            mask = (rng.random(shape) < density).astype(np.uint8)
            enc = port_rle.encode(mask)
            assert enc == jax_rle.encode(mask)
            np.testing.assert_array_equal(port_rle.decode(enc), jax_rle.decode(enc))
            np.testing.assert_array_equal(port_rle.decode(enc), mask)
    assert port_palette.davis_palette == jax_palette.davis_palette
    assert port_palette.youtube_palette == jax_palette.youtube_palette
    np.testing.assert_array_equal(port_palette.davis_palette_np,
                                  jax_palette.davis_palette_np)
    ids = []
    for module in (port_palette, jax_palette):
        np.random.seed(3)
        conv = module.ID2RGBConverter()
        ids.append([(i, conv.convert(o)[0], conv.convert(o)[1].tolist())
                    for i, o in enumerate([5, 9, 5, 300])])
    assert ids[0] == ids[1]


@pytest.mark.parametrize("model", ["base", "small"])
@pytest.mark.parametrize("plus", [False, True], ids=["eval_config", "eval_plus_config"])
def test_config_matches_cutie_tpu(model, plus):
    """eval_config / eval_plus_config equal to cutie_tpu's key for key
    (including the keys the port carries and ignores: max_objects,
    matmul_precision, read_backend), plus mem_mesh_devices = 0, the default
    cutie_tpu reads the key with, and get_dataset_cfg equal on every
    preset, with and without explicit top-level values."""
    make = "eval_plus_config" if plus else "eval_config"
    port, ref = getattr(port_config, make)(model), getattr(jax_config, make)(model)
    assert "mem_mesh_devices" not in ref
    ref.mem_mesh_devices = 0
    assert port.to_dict() == ref.to_dict()
    assert port.mem_every is None and port.use_long_term is None
    for name in ref.datasets.keys():
        for explicit in ({}, {"mem_every": 3, "use_long_term": False, "size": 600}):
            p, r = port.copy(), ref.copy()
            p.merge(dict(explicit, dataset=name))
            r.merge(dict(explicit, dataset=name))
            assert (port_config.get_dataset_cfg(p).to_dict()
                    == jax_config.get_dataset_cfg(r).to_dict()), (name, explicit)
            assert p.to_dict() == r.to_dict(), (name, explicit)
            if not explicit:
                long_term = name == "generic" or name.startswith(("lvos", "burst"))
                assert p.use_long_term is long_term, name


def test_apply_overrides_match_cutie_tpu():
    overrides = ["dataset=lvos-val", "model.key_dim=32", "weights=null",
                 "use_long_term=false", "amp=True", "long_term.max_num_tokens=20000",
                 "top_k=20", "output_dir=/out/dir", "size=-1", "flip_aug=yes",
                 "exp_id='quoted'", "max_internal_size=480", "new.key=1.5e+2",
                 "chunk_size=.5", "subset=a_b.txt", "save_scores=on"]
    port = port_config.eval_config("small").apply_overrides(overrides)
    ref = jax_config.eval_config("small").apply_overrides(overrides)
    ref.mem_mesh_devices = 0   # the port's one key more (test_config_matches_cutie_tpu)
    assert port.to_dict() == ref.to_dict()


def test_jpeg_needs_pillow(tmp_path, monkeypatch):
    """JPEG needs no Pillow: with Pillow missing, a JPEG still reads (the
    port's decoder, equal to Pillow's decode), PNG reads, write_jpeg writes
    the bytes Pillow wrote, and a visualizing ResultSaver, which writes
    JPEGs, is built."""
    from cutie_tpu_torch.inference.object_manager import ObjectManager
    from cutie_tpu_torch.utils.results import ResultSaver

    rgb = np.random.default_rng(RNG_SEED).integers(0, 256, (8, 8, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "a.jpg")
    want = np.array(Image.open(tmp_path / "a.jpg").convert("RGB"))
    image_io.write_png(str(tmp_path / "a.png"), rgb)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "a.jpg")), want)
    image_io.write_jpeg(str(tmp_path / "b.jpg"), rgb)
    assert (tmp_path / "b.jpg").read_bytes() == (tmp_path / "a.jpg").read_bytes()
    saver = ResultSaver(str(tmp_path), "v", dataset="d17-val",
                        object_manager=ObjectManager(), use_long_id=False,
                        visualize=True)
    assert saver.visualize
    saver.end()
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "a.png")), rgb)
