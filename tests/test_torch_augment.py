"""The port's numpy augmentations (cutie_tpu_torch/data/augment.py) against
cutie_tpu/data/augment.py, which calls cv2 5.0 and Pillow: each op fed the
same np.random.Generator draws.

Bar: equal, bit for bit, for masks (INTER_NEAREST warps, resizes and
remaps) and images (warpAffine and remap at INTER_LINEAR, cv2.resize at
INTER_LINEAR, the Gaussian blur, the colour jitter and its HSV round trip,
grayscale and Image.blend).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from tests.test_torch_stream import one_intra_op_thread  # noqa: E402,F401

import cutie_tpu.data.augment as R  # noqa: E402
from cutie_tpu_torch.data import augment as A  # noqa: E402


def _image(rng, h, w, c=3):
    shape = (h, w, c) if c > 1 else (h, w)
    return rng.integers(0, 256, shape).astype(np.uint8)


def _mask(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    m[h // 4:3 * h // 4, w // 5:w // 2] = 1
    m[h // 2:, w // 2:] = 2 + rng.integers(0, 2, (h - h // 2, w - w // 2))
    return m


@pytest.mark.parametrize("size", [(48, 64), (77, 101), (480, 854)])
def test_affine_matches_cv2(size):
    """apply_affine on images (INTER_LINEAR, fill IM_MEAN) and masks
    (INTER_NEAREST, fill 0), one and three channels, at the draws of both
    datasets' affine transforms: equal."""
    rng = np.random.default_rng(size[0])
    h, w = size
    for degrees, scale, shear in ((25, None, 20), (20, (0.5, 2.0), 10), (0, (0.5, 2.0), 0)):
        params = A.sample_affine_params(np.random.default_rng(h + degrees), degrees,
                                        scale, shear)
        assert params == R.sample_affine_params(np.random.default_rng(h + degrees),
                                                degrees, scale, shear)
        img, gray, mask = _image(rng, h, w), _image(rng, h, w, 1), _mask(rng, h, w)
        for x, fill, nearest in ((img, A.IM_MEAN, False), (gray, A.IM_MEAN, False),
                                 (mask, 0, True), (img[:, ::-1], A.IM_MEAN, False)):
            np.testing.assert_array_equal(
                A.apply_affine(x, *params, fill=fill, nearest=nearest),
                R.apply_affine(x, *params, fill=fill, nearest=nearest))


@pytest.mark.parametrize("src,out", [((96, 140), 64), ((40, 40), 77), ((300, 400), 480),
                                     ((900, 700), 480), ((64, 64), 32)])
def test_resized_crop_and_resizes(src, out):
    """RandomResizedCrop's draws equal; its crop resized to out x out,
    resize_shorter_np and a resize of each axis its own way (up, down,
    past both edges): masks and images equal."""
    rng = np.random.default_rng(src[0])
    h, w = src
    img, mask = _image(rng, h, w), _mask(rng, h, w)
    crop = A.sample_resized_crop(np.random.default_rng(1), h, w, scale=(0.36, 1.0))
    assert crop == R.sample_resized_crop(np.random.default_rng(1), h, w, scale=(0.36, 1.0))
    np.testing.assert_array_equal(A.apply_resized_crop(mask, *crop, out, True),
                                  R.apply_resized_crop(mask, *crop, out, True))
    np.testing.assert_array_equal(A.resize_shorter_np(mask, out, True),
                                  R.resize_shorter_np(mask, out, True))
    for got, want in ((A.apply_resized_crop(img, *crop, out, False),
                       R.apply_resized_crop(img, *crop, out, False)),
                      (A.resize_shorter_np(img, out, False),
                       R.resize_shorter_np(img, out, False)),
                      (A.resize(img[..., 0], 2 * w // 3, h // 2 + 7, False),
                       cv2.resize(img[..., 0], (2 * w // 3, h // 2 + 7)))):
        np.testing.assert_array_equal(got, want)
    # an exact 2x downscale is INTER_AREA's mean: equal
    if h % 2 == 0 and w % 2 == 0:
        np.testing.assert_array_equal(A.resize(img, w // 2, h // 2, False),
                                      cv2.resize(img, (w // 2, h // 2)))


def test_pad_and_crop_draws():
    rng = np.random.default_rng(0)
    img, mask = _image(rng, 30, 50), _mask(rng, 30, 50)
    np.testing.assert_array_equal(A.pad_to_min(img, 64, A.IM_MEAN),
                                  R.pad_to_min(img, 64, A.IM_MEAN))
    np.testing.assert_array_equal(A.pad_to_min(mask, 64, 0), R.pad_to_min(mask, 64, 0))
    for seed in range(5):
        assert (A.sample_crop(np.random.default_rng(seed), 90, 70, 64)
                == R.sample_crop(np.random.default_rng(seed), 90, 70, 64))


@pytest.mark.parametrize("factors", [(0.1, 0.05, 0.05, 0.05), (0.1, 0.03, 0.03, 0),
                                     (0.9, 0.9, 0.9, 0.4)])
def test_color_jitter_and_grayscale(factors):
    """ColorJitter (Brightness, Contrast, Color and the HSV hue shift in a
    drawn order) and the random grayscale: equal, over many draws."""
    rng = np.random.default_rng(3)
    for seed in range(12):
        img = _image(rng, 37, 53)
        got = A.color_jitter(np.random.default_rng(seed), img, *factors)
        want = np.asarray(R.color_jitter(np.random.default_rng(seed),
                                         Image.fromarray(img), *factors))
        np.testing.assert_array_equal(got, want)
        got = A.maybe_grayscale(np.random.default_rng(seed), img, 0.5)
        want = np.asarray(R.maybe_grayscale(np.random.default_rng(seed),
                                            Image.fromarray(img), 0.5))
        np.testing.assert_array_equal(got, want)


def test_blend_and_enhance_match_pillow():
    """Image.blend inside [0, 1] (truncated) and outside it (clipped), and
    the three ImageEnhance ops at factors on both sides of 1."""
    from PIL import ImageEnhance

    rng = np.random.default_rng(4)
    a, b = _image(rng, 20, 30), _image(rng, 20, 30)
    for alpha in (-0.5, 0.0, 0.3, 0.7731, 1.0, 1.09, 1.7):
        np.testing.assert_array_equal(
            A.blend(a, b, alpha),
            np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b), alpha)))
    for f in (0.0, 0.5, 0.93, 1.0, 1.07, 2.0):
        for ours, ref in ((A.brightness, ImageEnhance.Brightness),
                          (A.contrast, ImageEnhance.Contrast),
                          (A.color, ImageEnhance.Color)):
            np.testing.assert_array_equal(
                ours(a, f), np.asarray(ref(Image.fromarray(a)).enhance(f)))


def test_hsv_round_trip_exhaustive():
    """RGB -> HSV and HSV -> RGB of all 2^24 triples equal Pillow's."""
    v = np.arange(1 << 24, dtype=np.uint32)
    triples = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                       -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(A.rgb_to_hsv(triples),
                                  np.asarray(Image.fromarray(triples).convert("HSV")))
    np.testing.assert_array_equal(
        A.hsv_to_rgb(triples),
        np.asarray(Image.fromarray(triples, "HSV").convert("RGB")))


@pytest.mark.parametrize("size", [(40, 50), (384, 384)])
def test_tps_warp_matches_cv2_remap(size):
    """The TPS control-point draws, grid and cv2.remap of image (linear)
    and mask (nearest): equal."""
    h, w = size
    rng = np.random.default_rng(h)
    img, mask = _image(rng, h, w), _mask(rng, h, w)
    for seed in range(3):
        got = A.random_tps_warp(np.random.default_rng(seed), img, mask, scale=0.02)
        want = R.random_tps_warp(np.random.default_rng(seed), img, mask, scale=0.02)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    c = np.stack([rng.uniform(size=8), rng.uniform(size=8)], 1)
    for got, want in zip(A.tps_warp_grid(c, c + 0.01, h, w),
                         R.tps_warp_grid(c, c + 0.01, h, w)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 8])
def test_gaussian_blur_matches_cv2(channels):
    """cv2.GaussianBlur((5, 5), 1.0) of float32 0/1 masks, as the VOS
    merge calls it over T channels (vos_dataset.py:194-198): equal."""
    rng = np.random.default_rng(channels)
    for h, w in ((48, 48), (61, 97), (480, 480)):
        masks = (rng.uniform(size=(h, w, channels)) > 0.6).astype(np.float32)
        want = cv2.GaussianBlur(masks, (5, 5), 1.0).reshape(h, w, channels)
        np.testing.assert_array_equal(A.gaussian_blur_5x5(masks), want)
