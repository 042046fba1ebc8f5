"""The port's image writers and the resize of the GUI's shorter-edge cap
(cutie_tpu_torch/utils/image_io.py) against Pillow and cv2, on the CPU:

- the baseline JPEG encoder (csrc_host/jpeg_encode.cpp): the file, and in
  it the DQT, SOF, DHT and scan bytes, equal Pillow's save and
  cv2.imencode at qualities 50, 75, 90 and 95, on the fixture frames and on
  random and blurred images of 1x1, 17x33, 15x16 and 480x854; it writes
  with Pillow blocked; the committed references under
  tests/torch_fixtures/jpeg_enc/ (which chip_smoke.py's phase gui holds the
  card's build to) are what Pillow and cv2 write today;
- resize_area against cv2's INTER_AREA: bit-equal at factors 2 and 3; at
  1.5 and 4/3 within one level, with the share of differing pixels bounded
  at 1e-3 (measured: 0 on these random images, 4.0e-4 of the pixels at
  1280x720 -> 853x480);
- write_png of RGBA, read_png and to_rgba against Pillow, the in-memory PPM,
  and aggregate_wbg_np's hard mode against cutie_tpu's.

`python -m tests.test_torch_jpeg_encode` rewrites the references with
Pillow and cv2 (commit them and manifest.json).
"""
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

from cutie_tpu_torch.utils import image_io  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
ENC_DIR = FIXTURES / "jpeg_enc"
QUALITIES = (50, 75, 90, 95)
# the references chip_smoke.py reproduces: two fixture frames and an
# odd-sized crop, each by Pillow at 75 (the eval harness) and cv2 at 95
# (the GUI's visualizations)
SOURCES = {"synth_a_00000": ("vos/JPEGImages/synth_a/00000.jpg", None),
           "synth_b_00007": ("vos/JPEGImages/synth_b/00007.jpg", None),
           "synth_c_00003_crop": ("vos/JPEGImages/synth_c/00003.jpg",
                                  (slice(13, 314), slice(27, 544)))}


def reference_sources():
    """{name: [H, W, 3] uint8} of the references' sources, decoded by the
    port's decoder (equal to Pillow's decode)."""
    out = {}
    for name, (rel, crop) in SOURCES.items():
        rgb = image_io.read_image(str(FIXTURES / rel))
        out[name] = np.ascontiguousarray(rgb[crop] if crop else rgb)
    return out


def pillow_jpeg(rgb, quality):
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def cv2_jpeg(rgb, quality):
    ok, data = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                            [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return data.tobytes()


def reference_files():
    """{file name: bytes} of the committed references, made now."""
    files = {}
    for name, rgb in reference_sources().items():
        files[f"{name}_pillow_q75.jpg"] = pillow_jpeg(rgb, 75)
        files[f"{name}_cv2_q95.jpg"] = cv2_jpeg(rgb, 95)
    return files


def segments(data: bytes):
    """[(marker, segment bytes)] up to and including SOS, then ('scan', the
    entropy-coded data and EOI)."""
    out, pos = [], 2
    while pos < len(data):
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, data[pos:pos + 2 + length]))
        pos += 2 + length
        if marker == 0xDA:
            out.append(("scan", data[pos:]))
            break
    return out


def _images():
    rng = np.random.default_rng(0)
    cases = {}
    for h, w in ((1, 1), (17, 33), (15, 16), (480, 854)):
        rand = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cases[f"random_{h}x{w}"] = rand
        cases[f"blurred_{h}x{w}"] = cv2.GaussianBlur(rand, (7, 7), 2.5)
    return cases


IMAGE_NAMES = sorted(_images()) + ["fixture_synth_a", "fixture_synth_b"]


def _image(name):
    if name.startswith("fixture_"):
        return reference_sources()[{"fixture_synth_a": "synth_a_00000",
                                    "fixture_synth_b": "synth_b_00007"}[name]]
    return _images()[name]


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("name", IMAGE_NAMES)
def test_encoder_equals_pillow_and_cv2(name, quality):
    rgb = _image(name)
    ours = image_io.encode_jpeg(rgb, quality)
    for ref in (pillow_jpeg(rgb, quality), cv2_jpeg(rgb, quality)):
        mine, theirs = segments(ours), segments(ref)
        kinds = [m for m, _ in theirs]
        assert [m for m, _ in mine] == kinds
        for (marker, a), (_, b) in zip(mine, theirs):
            if marker in (0xDB, 0xC0, 0xC4, 0xDA, "scan"):
                assert a == b, (name, quality, marker)
        assert ours == ref


def test_committed_references_are_current():
    """The references chip_smoke.py holds the card's encoder to are what
    Pillow and cv2 write today, and the port's encoder writes them."""
    manifest = json.loads((ENC_DIR / "manifest.json").read_text())
    files = reference_files()
    assert sorted(files) == sorted(manifest["files"])
    sources = reference_sources()
    for fname, data in files.items():
        assert (ENC_DIR / fname).read_bytes() == data, fname
        name, lib, q = fname[:-4].rsplit("_", 2)
        assert manifest["files"][fname] == {"source": name, "quality": int(q[1:]),
                                            "writer": lib}
        assert image_io.encode_jpeg(sources[name], int(q[1:])) == data, fname
    assert sum(len(d) for d in files.values()) <= 600 * 1024


def test_write_jpeg_without_pillow(tmp_path, monkeypatch):
    rgb = _images()["random_17x33"]
    want = pillow_jpeg(rgb, 75)
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    image_io.write_jpeg(str(tmp_path / "a.jpg"), rgb)
    assert (tmp_path / "a.jpg").read_bytes() == want
    image_io.write_jpeg(str(tmp_path / "b.jpg"), rgb, quality=95)
    assert (tmp_path / "b.jpg").read_bytes() == cv2_jpeg(rgb, 95)


def test_encoder_rejects_what_it_does_not_write():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((0, 4, 3), np.uint8), np.zeros((4, 4, 3), np.float32)):
        with pytest.raises(ValueError):
            image_io.encode_jpeg(bad)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("factor", [2, 3])
def test_resize_area_integer_factors_bit_equal(factor, channels):
    rng = np.random.default_rng(factor * 10 + channels)
    for out_h, out_w in ((32, 48), (11, 17), (1, 1)):
        shape = (out_h * factor, out_w * factor) + ((3,) if channels == 3 else ())
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(image_io.resize_area(img, out_w, out_h), want)


@pytest.mark.parametrize("in_hw,out_hw", [((48, 72), (32, 48)), ((64, 96), (48, 72)),
                                          ((720, 1280), (480, 853))])
def test_resize_area_fractional_factors_within_one_level(in_hw, out_hw):
    img = np.random.default_rng(7).integers(0, 256, in_hw + (3,), dtype=np.uint8)
    want = cv2.resize(img, out_hw[::-1], interpolation=cv2.INTER_AREA).astype(int)
    diff = np.abs(image_io.resize_area(img, out_hw[1], out_hw[0]).astype(int) - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def test_rgba_png_and_conversions(tmp_path):
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (9, 13, 4), dtype=np.uint8)
    image_io.write_png(str(tmp_path / "a.png"), rgba)
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "a.png")), rgba)
    pixels, mode, palette = image_io.read_png(str(tmp_path / "a.png"))
    assert mode == "RGBA"
    np.testing.assert_array_equal(image_io.to_rgba(pixels, mode, palette), rgba)
    np.testing.assert_array_equal(image_io.to_rgb(pixels, mode, palette), rgba[..., :3])
    sources = {"L": rgba[..., 0], "RGB": rgba[..., :3], "LA": rgba[..., :2],
               "P": rgba[..., 0] % 7}
    for mode, arr in sources.items():
        im = Image.fromarray(arr, mode)
        if mode == "P":
            im.putpalette(list(range(7 * 3)))
        im.save(tmp_path / f"{mode}.png")
        got = image_io.to_rgba(*image_io.read_any(str(tmp_path / f"{mode}.png")))
        want = np.array(Image.open(tmp_path / f"{mode}.png").convert("RGBA"))
        np.testing.assert_array_equal(got, want, err_msg=mode)


def test_encode_ppm():
    rgb = np.random.default_rng(4).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    im = Image.open(io.BytesIO(image_io.encode_ppm(rgb)))
    assert im.mode == "RGB"
    np.testing.assert_array_equal(np.array(im), rgb)


@pytest.mark.parametrize("hard", [False, True])
def test_aggregate_wbg_np_matches_cutie_tpu(hard):
    from cutie_tpu.ops.tensor_utils import aggregate_wbg_np as theirs

    from cutie_tpu_torch.ops.tensor_utils import aggregate_wbg_np as ours

    prob = np.random.default_rng(5).random((3, 6, 9)).astype(np.float32)
    prob[:, 0, 0] = [0.5, 0.5, 0.0]
    for keep_bg in (False, True):
        np.testing.assert_array_equal(ours(prob, keep_bg=keep_bg, hard=hard),
                                      theirs(prob, keep_bg=keep_bg, hard=hard))


def write_fixtures():
    ENC_DIR.mkdir(exist_ok=True)
    files = reference_files()
    manifest = {"files": {}}
    for fname, data in files.items():
        (ENC_DIR / fname).write_bytes(data)
        name, lib, q = fname[:-4].rsplit("_", 2)
        manifest["files"][fname] = {"source": name, "quality": int(q[1:]), "writer": lib}
    manifest["sources"] = {name: {"file": rel, "crop": [[c.start, c.stop] for c in crop]
                                  if crop else None}
                           for name, (rel, crop) in SOURCES.items()}
    (ENC_DIR / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    print(f"wrote {len(files)} references, {sum(map(len, files.values()))} bytes")


if __name__ == "__main__":
    write_fixtures()
