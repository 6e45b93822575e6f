"""Procedurally rendered digit-image datasets — the port of
:mod:`tpfl.learning.dataset.rendered`, bit-equal to it without PIL or
matplotlib.

The reference renders a digit glyph with PIL from one of matplotlib's
DejaVu fonts, rotates it (``Image.rotate(expand=True, resample=BILINEAR)``),
scales it to ~80% of the canvas (``Image.resize(BILINEAR)``) and pastes it
with a random shift. The port reads the glyphs from a committed atlas
(``glyphs.npz``, made by ``tests/make_torch_glyph_atlas.py`` through the
reference's own ``_glyph``) and repeats Pillow's arithmetic in numpy:

- rotate: the matrix and expanded size of ``Image.rotate``'s Python code,
  then the C affine filter (``Geometry.c``: sample at pixel centres,
  double bilinear interpolation with clamped neighbours, 0 outside the
  source, a truncating cast to uint8), or a transpose at 0/90/180/270°;
- resize: ``Resample.c``'s separable bilinear convolution with its
  coefficients in 22-bit fixed point, a horizontal pass into uint8 and a
  vertical pass;
- paste: a copy clipped at the canvas's edges.

So the canvases are Pillow's byte for byte, and the images and labels are
the reference's for the same arguments, given the Pillow, FreeType and
matplotlib versions recorded in the atlas. Random draws follow the
reference's order exactly.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np

from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset

ATLAS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "glyphs.npz")
ATLAS_SCRIPT = "tests/make_torch_glyph_atlas.py"

_PRECISION_BITS = 32 - 8 - 2  # Resample.c's PRECISION_BITS for 8-bit images


class _Atlas(NamedTuple):
    pixels: np.ndarray
    index: dict[tuple[int, int, int], tuple[int, int, int]]
    fonts: tuple[str, ...]
    sizes: tuple[int, int]
    versions: tuple[str, ...]


@lru_cache(maxsize=1)
def _atlas() -> _Atlas:
    with np.load(ATLAS_PATH) as z:
        pixels, table = z["pixels"], z["table"]
        fonts, versions = tuple(str(f) for f in z["fonts"]), tuple(str(v) for v in z["versions"])
    index = {(int(f), int(s), int(d)): (int(o), int(h), int(w)) for f, s, d, o, h, w in table}
    return _Atlas(pixels, index, fonts, (int(table[:, 1].min()), int(table[:, 1].max())), versions)


def _check_size(size: int) -> None:
    lo, hi = _atlas().sizes
    if size * 3 // 4 < lo or size * 5 // 4 > hi:
        raise ValueError(
            f"size={size} draws font sizes {size * 3 // 4}..{size * 5 // 4}, but the glyph "
            f"atlas holds font sizes {lo}..{hi} (canvas sizes {-(-lo * 4 // 3)}..{hi * 4 // 5}); "
            f"extend it with {ATLAS_SCRIPT} --min-size/--max-size")


# --- Pillow's geometry, in numpy, over a batch of images ---------------------
#
# A batch is padded to its largest image; a padded pixel is never read. The
# images travel as float64 arrays of integer values 0..255.


def _rotate_matrix(w: int, h: int, angle: float) -> tuple[list[float], int, int]:
    """``Image.rotate(angle, expand=True)``'s inverse affine matrix and
    output size, computed as its Python code computes them."""
    center = (w / 2, h / 2)
    angle = -math.radians(angle)
    matrix = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
              round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]

    def transform(x: float, y: float) -> tuple[float, float]:
        a, b, c, d, e, f = matrix
        return a * x + b * y + c, d * x + e * y + f

    matrix[2], matrix[5] = transform(-center[0] - 0, -center[1] - 0)
    matrix[2] += center[0]
    matrix[5] += center[1]
    xx, yy = zip(*(transform(x, y) for x, y in ((0, 0), (w, 0), (w, h), (0, h))))
    nw = math.ceil(max(xx)) - math.floor(min(xx))
    nh = math.ceil(max(yy)) - math.floor(min(yy))
    matrix[2], matrix[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0)
    return matrix, nw, nh


def _col(v: np.ndarray) -> np.ndarray:
    """One value per image, broadcast over its rows and columns."""
    return np.asarray(v)[:, None, None]


def rotate_many(pixels: np.ndarray, off: np.ndarray, h: np.ndarray, w: np.ndarray,
                angles: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``Image.rotate(angle, expand=True, resample=Image.BILINEAR)`` of each
    uint8 image stored row-major in ``pixels`` at ``off`` with shape
    ``(h, w)``. Returns the rotated batch, its heights and its widths.

    Pillow transposes at 0/90/180/270°; any other angle goes through
    ``Geometry.c``'s affine filter: sample at the pixel centre, 0 outside
    the source, bilinear in double between clamped neighbours (the lower
    row alone past the last row), a truncating cast to uint8."""
    m = len(angles)
    mat = np.zeros((m, 6))
    nh, nw = np.array(h, dtype=np.int64), np.array(w, dtype=np.int64)
    square = []
    for i in range(m):
        angle = float(angles[i]) % 360.0
        if angle in (0.0, 90.0, 180.0, 270.0):
            square.append((i, int(angle) // 90))
            if angle in (90.0, 270.0):
                nh[i], nw[i] = w[i], h[i]
        else:
            mat[i], nw[i], nh[i] = _rotate_matrix(int(w[i]), int(h[i]), angle)
    xin = np.arange(nw.max(), dtype=np.float64)[None, None, :] + 0.5
    yin = np.arange(nh.max(), dtype=np.float64)[None, :, None] + 0.5
    xs = _col(mat[:, 0]) * xin + _col(mat[:, 1]) * yin + _col(mat[:, 2])
    ys = _col(mat[:, 3]) * xin + _col(mat[:, 4]) * yin + _col(mat[:, 5])
    inside = ((xs >= 0.0) & (xs < _col(w)) & (ys >= 0.0) & (ys < _col(h))
              & (xin < _col(nw)) & (yin < _col(nh)))
    xs -= 0.5
    ys -= 0.5
    x, y = np.floor(xs), np.floor(ys)
    dx, dy = xs - x, ys - y
    x, y = x.astype(np.int64), y.astype(np.int64)
    last_x, last_y = _col(w) - 1, _col(h) - 1
    x0, x1 = np.clip(x, 0, last_x), np.clip(x + 1, 0, last_x)
    row0 = _col(off) + np.clip(y, 0, last_y) * _col(w)
    row1 = _col(off) + np.clip(y + 1, 0, last_y) * _col(w)
    a, b = pixels[row0 + x0].astype(np.float64), pixels[row0 + x1].astype(np.float64)
    v1 = a + (b - a) * dx
    a, b = pixels[row1 + x0].astype(np.float64), pixels[row1 + x1].astype(np.float64)
    v2 = np.where((y + 1 >= 0) & (y + 1 <= last_y), a + (b - a) * dx, v1)
    out = np.where(inside, np.trunc(v1 + (v2 - v1) * dy), 0.0)
    for i, k in square:
        img = pixels[off[i]:off[i] + h[i] * w[i]].reshape(h[i], w[i])
        out[i] = 0.0
        out[i, :nh[i], :nw[i]] = np.rot90(img, k)
    return out, nh, nw


@lru_cache(maxsize=None)
def _resample_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """``Resample.c``'s ``precompute_coeffs`` for the bilinear filter and a
    whole-image box, then ``normalize_coeffs_8bpc``: an (out, in) matrix
    of 22-bit fixed-point weights (rounded half away from zero)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize, dtype=np.int64)[None, :]
    arg = np.abs(((taps + xmin[:, None]).astype(np.float64) - center[:, None] + 0.5) * ss)
    k = np.where((taps < xmax[:, None]) & (arg < 1.0), 1.0 - arg, 0.0)
    ww = np.zeros(out_size, dtype=np.float64)
    for t in range(ksize):  # C's sequential sum, tap by tap
        ww = ww + k[:, t]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    k = k * (1 << _PRECISION_BITS)
    fixed = np.where(k < 0, np.trunc(-0.5 + k), np.trunc(0.5 + k))
    out = np.zeros((out_size, in_size))
    cols = taps + xmin[:, None]
    valid = taps < xmax[:, None]
    rows = np.broadcast_to(np.arange(out_size)[:, None], cols.shape)
    out[rows[valid], cols[valid]] = fixed[valid]
    out.flags.writeable = False
    return out


def resize_many(images: np.ndarray, h: np.ndarray, w: np.ndarray, th: np.ndarray,
                tw: np.ndarray) -> np.ndarray:
    """``Image.resize((tw, th), Image.BILINEAR)`` of each ``(h, w)`` image
    of a padded batch: ``Resample.c``'s horizontal pass into uint8, then
    its vertical pass, each summing from ``1 << 21`` and clipped after
    ``>> 22``. A pass Pillow skips (an unchanged side) has identity
    weights here, which give the same bytes. The products run in float64,
    exact: every partial sum is an integer below 2**53."""
    m = len(images)
    kx = np.zeros((m, int(tw.max()), images.shape[2]))
    ky = np.zeros((m, int(th.max()), images.shape[1]))
    for i in range(m):
        kx[i, :tw[i], :w[i]] = _resample_coeffs(int(w[i]), int(tw[i]))
        ky[i, :th[i], :h[i]] = _resample_coeffs(int(h[i]), int(th[i]))
    half, one = float(1 << (_PRECISION_BITS - 1)), float(1 << _PRECISION_BITS)
    wide = np.clip(np.floor((half + images @ kx.transpose(0, 2, 1)) / one), 0.0, 255.0)
    return np.clip(np.floor((half + ky @ wide) / one), 0.0, 255.0)


def paste_many(images: np.ndarray, h: np.ndarray, w: np.ndarray, ox: np.ndarray,
               oy: np.ndarray, size: int) -> np.ndarray:
    """``Image.new("L", (size, size), 0).paste(img, (ox, oy))`` of each
    ``(h, w)`` image of a padded batch, clipped at every edge: an (m, size,
    size) uint8 stack."""
    cx = np.arange(size)[None, None, :] - _col(ox)
    cy = np.arange(size)[None, :, None] - _col(oy)
    valid = (cx >= 0) & (cx < _col(w)) & (cy >= 0) & (cy < _col(h))
    picked = images[np.arange(len(images))[:, None, None],
                    np.clip(cy, 0, images.shape[1] - 1), np.clip(cx, 0, images.shape[2] - 1)]
    return np.where(valid, picked, 0.0).astype(np.uint8)


# --- the reference's generators -------------------------------------------


def _render_canvases(font_idx: np.ndarray, font_sizes: np.ndarray, digits: np.ndarray,
                     angles: np.ndarray, shifts: np.ndarray, size: int) -> np.ndarray:
    """The (size, size) uint8 canvases of ``_render_batch``'s loop body,
    for a batch: the glyph rotated, scaled to 80% of the canvas along its
    longer side, pasted centred plus the shift."""
    atlas = _atlas()
    off, h, w = np.array([atlas.index[(int(f), int(s), int(d))]
                          for f, s, d in zip(font_idx, font_sizes, digits)],
                         dtype=np.int64).reshape(-1, 3).T
    rot, nh, nw = rotate_many(atlas.pixels, off, h, w, angles)
    scale = max(1, int(size * 0.8)) / np.maximum(nw, nh)
    th = np.maximum(1, (nh * scale).astype(np.int64))
    tw = np.maximum(1, (nw * scale).astype(np.int64))
    small = resize_many(rot, nh, nw, th, tw)
    ox = (size - tw) // 2 + np.asarray(shifts[:, 0], dtype=np.int64)
    oy = (size - th) // 2 + np.asarray(shifts[:, 1], dtype=np.int64)
    return paste_many(small, th, tw, ox, oy, size)


_CHUNK = 1024  # images per vectorised step (~100 MB of float64 temporaries at size 32)


def _render_batch(n: int, size: int, rng: np.random.Generator, noise: float
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Render ``n`` (size, size) float32 digit images in [0, 1] + labels,
    drawing from ``rng`` in the reference's order."""
    n_fonts = len(_atlas().fonts)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    font_idx = rng.integers(0, n_fonts, size=n)
    font_sizes = rng.integers(size * 3 // 4, size * 5 // 4 + 1, size=n)
    angles = rng.uniform(-25.0, 25.0, size=n)
    shifts = rng.integers(-size // 8, size // 8 + 1, size=(n, 2))
    intensity = rng.uniform(0.6, 1.0, size=n).astype(np.float32)

    x = np.empty((n, size, size), dtype=np.float32)
    for s in range(0, n, _CHUNK):
        e = min(s + _CHUNK, n)
        canvas = _render_canvases(font_idx[s:e], font_sizes[s:e], y[s:e], angles[s:e],
                                  shifts[s:e], size)
        # the reference's per-image float32 * (float32 / 255.0)
        x[s:e] = canvas.astype(np.float32) * (intensity[s:e] / 255.0)[:, None, None]

    if noise > 0:
        x += rng.normal(0.0, noise, size=x.shape).astype(np.float32)
    return np.clip(x, 0.0, 1.0), y


def rendered_digits(
    n_train: int = 2000,
    n_test: int = 400,
    seed: int = 0,
    size: int = 28,
    noise: float = 0.08,
) -> TpflDataset:
    """28×28 grayscale rendered digits, 10 classes — the hermetic stand-in
    for real MNIST. Raises ``ValueError`` for a ``size`` whose font sizes
    leave the atlas."""
    _check_size(size)
    rng = np.random.default_rng(seed)
    x_tr, y_tr = _render_batch(n_train, size, rng, noise)
    x_te, y_te = _render_batch(n_test, size, rng, noise)
    return TpflDataset.from_arrays(x_tr, y_tr, x_te, y_te)


def rendered_color_digits(
    n_train: int = 2000,
    n_test: int = 400,
    seed: int = 0,
    size: int = 32,
    noise: float = 0.08,
) -> TpflDataset:
    """32×32×3 rendered digits on coloured backgrounds — CIFAR-shaped image
    data for the CNN / ResNet cells."""
    _check_size(size)
    rng = np.random.default_rng(seed)

    def colorize(x_gray: np.ndarray) -> np.ndarray:
        n = x_gray.shape[0]
        fg = rng.uniform(0.5, 1.0, size=(n, 1, 1, 3)).astype(np.float32)
        bg = rng.uniform(0.0, 0.4, size=(n, 1, 1, 3)).astype(np.float32)
        g = x_gray[..., None]
        return np.clip(g * fg + (1.0 - g) * bg, 0.0, 1.0)

    x_tr, y_tr = _render_batch(n_train, size, rng, noise)
    x_te, y_te = _render_batch(n_test, size, rng, noise)
    return TpflDataset.from_arrays(colorize(x_tr), y_tr, colorize(x_te), y_te)


__all__ = ["paste_many", "rendered_color_digits", "rendered_digits", "resize_many",
           "rotate_many"]
