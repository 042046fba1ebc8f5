"""Host-side training augmentations in numpy, with an explicit RNG.

The port's counterpart of cutie_tpu/data/augment.py, without cv2 or PIL:
the same parameter draws from the same np.random.Generator in the same
order, and the same pixels. Each cv2 and Pillow call of cutie_tpu is
reimplemented here as that library computes it on 8-bit images:
- cv2.warpAffine (warp_affine) and cv2.remap with float maps (remap) at
  INTER_LINEAR and INTER_NEAREST with BORDER_CONSTANT, as cv2 5.0
  computes them: source coordinates in float32 (cv2 inverts the forward
  matrix), the nearest pixel by rounding, the bilinear blend in float32;
- cv2.resize (resize) at INTER_LINEAR (11-bit weights, half-pixel
  centres, the vertical pass's rounding; an exact 2x downscale is
  INTER_AREA's 2x2 mean) and INTER_NEAREST (floor of x * scale);
- cv2.GaussianBlur((5, 5), 1.0) of float32 0/1 masks (gaussian_blur_5x5);
- Pillow's ImageEnhance Brightness, Contrast and Color (Image.blend's
  float32 in1 + a * (in2 - in1), truncated; clipped outside [0, 1]), its
  RGB <-> HSV round trip (Convert.c) and its L24 grayscale.
Images are [H, W, 3] uint8 arrays wherever cutie_tpu passes PIL images.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from cutie_tpu_torch.utils.image_io import l24_luma, resize_area

IM_MEAN = (124, 116, 104)

_RESIZE_BITS = 11        # cv2.resize INTER_LINEAR's fixed-point weights


# ------------------------------------------------------------------ affine

def sample_affine_params(rng: np.random.Generator, degrees: float,
                         scale_range: Optional[Tuple[float, float]] = None,
                         shear: float = 0.0):
    angle = rng.uniform(-degrees, degrees) if degrees > 0 else 0.0
    scale = rng.uniform(*scale_range) if scale_range else 1.0
    shear_x = rng.uniform(-shear, shear) if shear > 0 else 0.0
    return angle, scale, shear_x


def _affine_matrix(angle, scale, shear_x, center):
    """torchvision convention: M = T(center) R(angle) Shear Scale T(-center)
    (cutie_tpu/data/augment.py:_affine_matrix, the same operations)."""
    rot = math.radians(angle)
    sx = math.radians(shear_x)
    cx, cy = center
    r = np.array([[math.cos(rot), -math.sin(rot)], [math.sin(rot), math.cos(rot)]])
    sh = np.array([[1.0, -math.tan(sx)], [0.0, 1.0]])
    m = r @ sh * scale
    t = np.eye(3)
    t[:2, :2] = m
    t[:2, 2] = [cx - m[0, 0] * cx - m[0, 1] * cy, cy - m[1, 0] * cx - m[1, 1] * cy]
    return t[:2]


def _round(x):
    """cvRound: to nearest, ties to even, as int64."""
    return np.rint(x).astype(np.int64)


def _padded_pixels(img: np.ndarray, fill, pad: int) -> np.ndarray:
    """img framed by `pad` pixels of the border value on every side, each
    pixel's (up to 4) channels packed into one uint32: [(H + 2 pad) *
    (W + 2 pad)], so that a gather moves one word a pixel."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    out = np.zeros((h + 2 * pad, w + 2 * pad, 4), np.uint8)
    out[..., :c] = np.asarray(fill, np.uint8).reshape(-1)[:c] if not np.isscalar(fill) else fill
    out[pad:pad + h, pad:pad + w, :c] = img.reshape(h, w, c)
    return out.view(np.uint32).reshape(-1)


def _sample(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, fill,
            nearest: bool) -> np.ndarray:
    """cv2's warp kernels on uint8 at float32 source coordinates: the
    nearest pixel (cvRound), or the bilinear blend in float32 of the four
    around floor(s), each lerp a fused multiply-add, rounded to nearest;
    taps outside the image take the border value."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    if c > 4:
        raise ValueError(f"warps of {c}-channel images are not supported")
    # coordinates are clamped into a 2-pixel frame of border value: a tap
    # that lies outside the image stays outside
    flat = _padded_pixels(img, fill, 2)
    stride = w + 4

    def channels(words):   # [H, W] uint32 -> c planes [H, W] uint8
        return words.view(np.uint8).reshape(h, w, 4)[..., :c]

    if nearest:
        ix = np.clip(_round(sx), -2, w + 1) + 2
        iy = np.clip(_round(sy), -2, h + 1) + 2
        return np.ascontiguousarray(channels(flat[iy * stride + ix])).reshape(img.shape)
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx).astype(np.float64), (sy - fy).astype(np.float64)
    base = ((np.clip(fy, -2, h).astype(np.int64) + 2) * stride
            + np.clip(fx, -2, w).astype(np.int64) + 2)
    taps = [channels(flat[base + off]) for off in (0, 1, stride, stride + 1)]
    out = np.empty((h, w, c), np.uint8)
    for ch in range(c):
        p00, p01, p10, p11 = (t[..., ch].astype(np.float64) for t in taps)
        # fma(t, b - a, a) in float32 rounds once: in float64 the product
        # and the sum are exact, then one rounding to float32
        top = (ax * (p01 - p00) + p00).astype(np.float32)
        bottom = (ax * (p11 - p10) + p10).astype(np.float32)
        val = (ay * (bottom - top) + top).astype(np.float32)
        out[..., ch] = np.clip(np.rint(val), 0, 255)
    return out.reshape(img.shape)


def warp_affine(img: np.ndarray, m: np.ndarray, fill, nearest: bool) -> np.ndarray:
    """cv2.warpAffine(img, m, (w, h), flags, BORDER_CONSTANT, fill) for a
    forward 2x3 matrix m, on uint8 [H, W] or [H, W, C]. cv2 inverts m in
    float64 and maps each output pixel to source coordinates in float32."""
    h, w = img.shape[:2]
    m = np.asarray(m, np.float64).reshape(6).copy()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0] = a11
    m[1] *= -det
    m[3] *= -det
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    mf = m.astype(np.float32).astype(np.float64)
    xs = np.arange(w, dtype=np.float64)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    f32 = np.float32
    # cv2's vector loop, 16 pixels a step, computes fma(M0, x, y*M1 + M2);
    # its scalar loop over the last w % 16 columns fma(M0, x, y*M1) + M2.
    # A float32 product is exact in float64, so each fma rounds once here.
    main = xs < (w // 16) * 16
    sx = np.where(main, (xs * mf[0] + f32(ys * f32(mf[1]) + f32(mf[2]))).astype(f32),
                  (xs * mf[0] + f32(ys * f32(mf[1]))).astype(f32) + f32(mf[2]))
    sy = np.where(main, (xs * mf[3] + f32(ys * f32(mf[4]) + f32(mf[5]))).astype(f32),
                  (xs * mf[3] + f32(ys * f32(mf[4]))).astype(f32) + f32(mf[5]))
    return _sample(img, sx, sy, fill, nearest)


def apply_affine(img: np.ndarray, angle, scale, shear_x, *, fill, nearest: bool
                 ) -> np.ndarray:
    h, w = img.shape[:2]
    m = _affine_matrix(angle, scale, shear_x, ((w - 1) * 0.5, (h - 1) * 0.5))
    if not np.isscalar(fill):
        fill = tuple(fill)[:img.shape[2]] if img.ndim == 3 else fill[0]
    return warp_affine(img, m, fill, nearest)


def remap(img: np.ndarray, mapx: np.ndarray, mapy: np.ndarray,
          nearest: bool) -> np.ndarray:
    """cv2.remap(img, mapx, mapy, interp) with float32 maps and the
    default constant border of 0."""
    return _sample(img, mapx.astype(np.float32), mapy.astype(np.float32), 0, nearest)


# ------------------------------------------------------ crops and resizes

def _linear_taps(in_size: int, out_size: int):
    """cv2.resize INTER_LINEAR's taps along one axis: source indices and
    11-bit weights (first, second), from f = (x + 0.5) * scale - 0.5 in
    float32. Past either edge cv2 clamps the indices and keeps the weights
    of f's fraction, so both taps read the edge pixel; the vertical pass
    truncates each product, so that differs from a weight of one."""
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    frac = f - s
    s = s.astype(np.int64)
    w0 = _round((np.float32(1) - frac) * np.float32(1 << _RESIZE_BITS))
    w1 = _round(frac * np.float32(1 << _RESIZE_BITS))
    return np.clip(s, 0, in_size - 1), np.clip(s + 1, 0, in_size - 1), w0, w1


def resize(img: np.ndarray, out_w: int, out_h: int, nearest: bool) -> np.ndarray:
    """cv2.resize(img, (out_w, out_h), interpolation=INTER_NEAREST or
    INTER_LINEAR) of uint8 [H, W] or [H, W, C]."""
    h, w = img.shape[:2]
    if nearest:
        ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))).astype(np.int64), h - 1)
        xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))).astype(np.int64), w - 1)
        return img[ys[:, None], xs[None, :]]
    if w == 2 * out_w and h == 2 * out_h:   # cv2 takes INTER_AREA at exactly 2x
        return resize_area(img, out_w, out_h)
    x0, x1, a0, a1 = _linear_taps(w, out_w)
    y0, y1, b0, b1 = _linear_taps(h, out_h)
    v = img.astype(np.int32)
    shape = (1, -1) + (1,) * (img.ndim - 2)
    rows = (np.take(v, x0, axis=1) * a0.astype(np.int32).reshape(shape)
            + np.take(v, x1, axis=1) * a1.astype(np.int32).reshape(shape)) >> 4
    shape = (-1,) + (1,) * (img.ndim - 1)
    # the vertical pass as cv2 rounds it: each product's high half, then
    # (sum + 2) >> 2
    out = (((b0.astype(np.int32).reshape(shape) * np.take(rows, y0, axis=0)) >> 16)
           + ((b1.astype(np.int32).reshape(shape) * np.take(rows, y1, axis=0)) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def sample_resized_crop(rng: np.random.Generator, h: int, w: int,
                        scale=(0.36, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop.get_params: 10 area attempts + fallback."""
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    # fallback: center crop at the closest valid ratio
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def apply_resized_crop(img: np.ndarray, top, left, ch, cw, out_size: int,
                       nearest: bool) -> np.ndarray:
    crop = img[top:top + ch, left:left + cw]
    return resize(crop, out_size, out_size, nearest)


def resize_shorter_np(img: np.ndarray, size: int, nearest: bool) -> np.ndarray:
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    return resize(img, nw, nh, nearest)


def sample_crop(rng: np.random.Generator, h: int, w: int, size: int):
    """RandomCrop offsets for an image already padded to >= size."""
    top = int(rng.integers(0, h - size + 1)) if h > size else 0
    left = int(rng.integers(0, w - size + 1)) if w > size else 0
    return top, left


def pad_to_min(img: np.ndarray, size: int, fill) -> np.ndarray:
    """Pad symmetrically to at least size x size, each channel with its
    value of fill (cutie_tpu's pad_to_min)."""
    h, w = img.shape[:2]
    ph, pw = max(0, size - h), max(0, size - w)
    if ph == 0 and pw == 0:
        return img
    pads = [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)]
    if img.ndim == 3:
        values = np.atleast_1d(np.asarray(fill, img.dtype))
        return np.stack([np.pad(img[..., c], pads,
                                constant_values=values[min(c, values.size - 1)])
                         for c in range(img.shape[2])], axis=-1)
    return np.pad(img, pads, constant_values=fill)


# --------------------------------------------------------------- color ops

def blend(in1: np.ndarray, in2: np.ndarray, alpha: float) -> np.ndarray:
    """Image.blend(in1, in2, alpha) of uint8 arrays (Blend.c): in float32,
    in1 + alpha * (in2 - in1), truncated; clipped to [0, 255] when alpha
    lies outside [0, 1]."""
    a = np.float32(alpha)
    i1 = in1.astype(np.int32)
    out = i1.astype(np.float32) + a * (in2.astype(np.int32) - i1).astype(np.float32)
    if 0.0 <= a <= 1.0:
        return out.astype(np.uint8)
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def to_gray(img: np.ndarray) -> np.ndarray:
    """img.convert('L').convert('RGB') of an RGB image."""
    return np.repeat(l24_luma(img)[..., None], 3, axis=-1)


def brightness(img: np.ndarray, f: float) -> np.ndarray:
    return blend(np.zeros_like(img), img, f)


def contrast(img: np.ndarray, f: float) -> np.ndarray:
    """ImageEnhance.Contrast: towards the grey of the mean luma, rounded as
    int(mean + 0.5)."""
    luma = l24_luma(img)
    mean = int(int(luma.sum(dtype=np.int64)) / luma.size + 0.5)
    return blend(np.full_like(img, mean), img, f)


def color(img: np.ndarray, f: float) -> np.ndarray:
    return blend(to_gray(img), img, f)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> HSV (Convert.c:rgb2hsv_row), each operation in the
    float or double precision of its C expression."""
    v = img.astype(np.int32)
    r, g, b = v[..., 0], v[..., 1], v[..., 2]
    maxc, minc = v.max(-1), v.min(-1)
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(np.float32)
    s = cr / np.maximum(maxc, 1).astype(np.float32)
    rc = (maxc - r).astype(np.float32) / cr
    gc = (maxc - g).astype(np.float32) / cr
    bc = (maxc - b).astype(np.float32) / cr
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc,
                          (2.0 + rc.astype(np.float64) - bc).astype(np.float32),
                          (4.0 + gc.astype(np.float64) - rc).astype(np.float32)))
    h = h.astype(np.float32)
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip(np.trunc(h.astype(np.float64) * 255.0), 0, 255)
    us = np.clip(np.trunc(s.astype(np.float64) * 255.0), 0, 255)
    out = np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc], axis=-1)
    return out.astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Pillow's HSV -> RGB (Convert.c:hsv2rgb)."""
    h = hsv[..., 0].astype(np.float64)
    s = hsv[..., 1].astype(np.float32)
    v = hsv[..., 2].astype(np.float64)
    i = np.floor(h * 6.0 / 255.0)
    f = (h * 6.0 / 255.0 - i).astype(np.float32)
    fs = (s.astype(np.float64) / 255.0).astype(np.float32)
    fs64 = fs.astype(np.float64)

    def rnd(x):   # C round(): half away from zero (x >= 0 here)
        return np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)

    p = rnd(v * (1.0 - fs64))
    q = rnd(v * (1.0 - (fs * f).astype(np.float64)))
    t = rnd(v * (1.0 - fs64 * (1.0 - f.astype(np.float64))))
    vv = hsv[..., 2]
    sector = i.astype(np.int64) % 6
    choices = [np.stack(c, axis=-1) for c in
               ((vv, t, p), (q, vv, p), (p, vv, t), (p, q, vv), (t, p, vv), (vv, p, q))]
    out = np.choose(sector[..., None], choices)
    grey = (hsv[..., 1] == 0)[..., None]
    return np.where(grey, vv[..., None], out).astype(np.uint8)


def color_jitter(rng: np.random.Generator, img: np.ndarray, brightness_, contrast_,
                 saturation, hue) -> np.ndarray:
    """torchvision ColorJitter: factors uniform around 1, ops in random
    order (cutie_tpu's color_jitter on an [H, W, 3] uint8 array)."""
    ops = []
    if brightness_ > 0:
        f = rng.uniform(max(0, 1 - brightness_), 1 + brightness_)
        ops.append(lambda im, f=f: brightness(im, f))
    if contrast_ > 0:
        f = rng.uniform(max(0, 1 - contrast_), 1 + contrast_)
        ops.append(lambda im, f=f: contrast(im, f))
    if saturation > 0:
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda im, f=f: color(im, f))
    if hue > 0:
        shift = rng.uniform(-hue, hue)

        def hue_op(im, shift=shift):
            hsv = rgb_to_hsv(im)
            hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(shift * 255)) % 256
            return hsv_to_rgb(hsv)

        ops.append(hue_op)
    order = rng.permutation(len(ops))
    for i in order:
        img = ops[i](img)
    return img


def maybe_grayscale(rng: np.random.Generator, img: np.ndarray, p: float) -> np.ndarray:
    if rng.uniform() < p:
        return to_gray(img)
    return img


# ------------------------------------------------------------------- blur

def gaussian_blur_5x5(masks: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(masks, (5, 5), 1.0) of float32 [H, W] or [H, W, C]
    0/1 masks, BORDER_REFLECT_101, as cv2 computes it on them: the
    float32 kernel of getGaussianKernel, a row pass c k2 + (b + d) k1 +
    (a + e) k0, then a column pass of fused multiply-adds over each row of
    W * C values, eight at a time; the last (W * C) % 8 without fusing."""
    k = np.exp(-(np.arange(5) - 2.0) ** 2 / 2.0)
    k = (k / k.sum()).astype(np.float32)
    x = masks.astype(np.float32)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    h, w, c = x.shape
    p = np.pad(x, ((2, 2), (2, 2), (0, 0)), mode="reflect")
    rows = (p[:, 2:2 + w] * k[2] + (p[:, 1:1 + w] + p[:, 3:3 + w]) * k[1]
            + (p[:, 0:w] + p[:, 4:4 + w]) * k[0]).reshape(h + 4, w * c)
    a, b, mid, d, e = (rows[i:i + h] for i in range(5))
    fused = ((a + e).astype(np.float64) * k[0]
             + ((b + d).astype(np.float64) * k[1]
                + (mid * k[2]).astype(np.float64)).astype(np.float32)).astype(np.float32)
    tail = (mid * k[2] + (b + d) * k[1] + (a + e) * k[0]).astype(np.float32)
    start = (w * c) // 8 * 8
    fused[:, start:] = tail[:, start:]
    out = fused.reshape(h, w, c)
    return out[..., 0] if squeeze else out


# ------------------------------------------------------------------- TPS

def _tps_kernel(r2):
    return np.where(r2 == 0, 0.0, r2 * np.log(np.maximum(r2, 1e-12)) * 0.5)


def _tps_fit(c_src: np.ndarray, c_dst: np.ndarray) -> np.ndarray:
    """Solve thin-plate-spline coefficients mapping c_dst -> displacement.
    Standard closed-form system [[K, P], [P^T, 0]] w = v (one solve per axis)."""
    n = c_src.shape[0]
    d2 = np.sum((c_dst[:, None] - c_dst[None]) ** 2, axis=-1)
    k = _tps_kernel(d2)
    p = np.concatenate([np.ones((n, 1)), c_dst], axis=1)
    a = np.zeros((n + 3, n + 3))
    a[:n, :n] = k
    a[:n, n:] = p
    a[n:, :n] = p.T
    v = np.zeros((n + 3, 2))
    v[:n] = c_src - c_dst
    return np.linalg.solve(a, v)  # [n+3, 2]


def tps_warp_grid(c_src: np.ndarray, c_dst: np.ndarray, h: int, w: int):
    """Backward-warp sampling grid: for each output pixel, where to sample."""
    theta = _tps_fit(c_src, c_dst)
    n = c_src.shape[0]
    # control points are normalized as index/h (pick_random_points), so the
    # grid uses the same convention — identity then maps pixel i to i exactly
    ys, xs = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    pts = np.stack([ys.ravel(), xs.ravel()], axis=1)  # normalized (y, x)
    d2 = np.sum((pts[:, None] - c_dst[None]) ** 2, axis=-1)
    k = _tps_kernel(d2)
    disp = k @ theta[:n] + theta[n] + pts @ theta[n + 1:]
    sample = pts + disp
    mapy = (sample[:, 0].reshape(h, w) * h).astype(np.float32)
    mapx = (sample[:, 1].reshape(h, w) * w).astype(np.float32)
    return mapx, mapy


def random_tps_warp(rng: np.random.Generator, img: np.ndarray, mask: np.ndarray,
                    scale: float = 0.02, n_ctrl_pts: int = 12):
    """(parity: cutie/dataset/tps.py:8-36)"""
    h, w = mask.shape[:2]
    y_idx = rng.choice(h, size=n_ctrl_pts, replace=False) / h
    x_idx = rng.choice(w, size=n_ctrl_pts, replace=False) / w
    c_src = np.stack([y_idx, x_idx], axis=1)
    c_dst = c_src + rng.normal(scale=scale, size=c_src.shape)
    mapx, mapy = tps_warp_grid(c_src, c_dst, h, w)
    return remap(img, mapx, mapy, nearest=False), remap(mask, mapx, mapy, nearest=True)
