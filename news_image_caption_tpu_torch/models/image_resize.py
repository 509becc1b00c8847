"""OpenCV's 8-bit image resizes, written in numpy, byte for byte.

The reference resizes with OpenCV on the host: `cv2.INTER_AREA` in
`models/facenet.py::MTCNN._resize` (the pyramid and the crops for RNet,
ONet and the embedder) and `cv2.INTER_LINEAR` in `models/yolov3.py::
letterbox`. The card's machine has no OpenCV (and no PIL), so the port
carries both here, for uint8 images [H, W] or [H, W, C], with OpenCV's
own arithmetic (`imgproc/src/resize.cpp`):

- a target of the source's size is a copy;
- INTER_LINEAR, and INTER_AREA that enlarges along either axis: 11-bit
  fixed-point coefficients, rounded from float32 weights; each row is
  interpolated in int32, then two rows are mixed the way OpenCV's SIMD
  vertical pass does it (each row's sum shifted right by 4, multiplied
  by its 11-bit coefficient keeping the high 16 bits, the two added and
  rounded by 2 bits). Columns clamp at the edges (weight 0 past them);
  rows keep their weights and repeat the edge row. INTER_AREA's
  coefficients are its "area" ones (`sx = floor(dx * scale)`,
  `fx = (dx + 1) - (sx + 1) / scale`, its fraction);
- INTER_LINEAR at exactly half size on both axes, and INTER_AREA that
  shrinks by whole factors on both axes: the mean of each block, the
  2 x 2 one as (sum + 2) >> 2, others as round-half-even of the float32
  product sum * (1 / area);
- INTER_AREA that shrinks by a fraction: each target pixel the float32
  sum of the source pixels it covers weighted by the covered share,
  accumulated left to right then top to bottom, rounded half to even.

This is host code, as the reference's is; no device runs it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_DBL_EPSILON = np.finfo(np.float64).eps


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)`."""
    return _resize(img, height, width, area=False)


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """`cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)`."""
    return _resize(img, height, width, area=True)


def _resize(img: np.ndarray, height: int, width: int,
            area: bool) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize takes uint8 [H, W] or [H, W, C], got "
                         f"{img.dtype} {img.shape}")
    if height < 1 or width < 1 or img.shape[0] < 1 or img.shape[1] < 1:
        raise ValueError(f"resize: empty size {img.shape[:2]} -> "
                         f"{(height, width)}")
    gray = img.ndim == 2
    x = img[..., None] if gray else img
    H, W = x.shape[:2]
    if (H, W) == (height, width):
        out = x.copy()
    else:
        scale_x, scale_y = 1.0 / (width / W), 1.0 / (height / H)
        ix, iy = _round_half_even(scale_x), _round_half_even(scale_y)
        whole = (abs(scale_x - ix) < _DBL_EPSILON
                 and abs(scale_y - iy) < _DBL_EPSILON)
        if not area and whole and ix == 2 and iy == 2:
            area = True                 # OpenCV's own switch
        if area and scale_x >= 1 and scale_y >= 1:
            out = (_block_mean(x, height, width, ix, iy) if whole
                   else _area_shrink(x, height, width, scale_x, scale_y))
        else:
            out = _bilinear(x, height, width, area)
    return out[..., 0] if gray else out


def _round_half_even(v: float) -> int:
    return int(np.rint(v))


def _coefficients(n_src: int, n_dst: int, area: bool, clamp: bool
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first source index, its weight, the next one's weight) a target
    index, weights in 11-bit fixed point."""
    inv = n_dst / n_src
    scale = 1.0 / inv
    d = np.arange(n_dst, dtype=np.float64)
    if area:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(
            np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        low, high = s < 0, s >= n_src - 1
        f[low | high] = 0
        s[low] = 0
        s[high] = n_src - 1
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(
        np.int32)
    return s, w0, w1


def _bilinear(x: np.ndarray, height: int, width: int,
              area: bool) -> np.ndarray:
    H, W, C = x.shape
    sx, a0, a1 = _coefficients(W, width, area, clamp=True)
    sy, b0, b1 = _coefficients(H, height, area, clamp=False)
    src = x.astype(np.int32)
    rows = (src[:, sx] * a0[None, :, None]
            + src[:, np.minimum(sx + 1, W - 1)] * a1[None, :, None])
    r0 = rows[np.clip(sy, 0, H - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, H - 1)] >> 4
    mixed = (((r0 * b0[:, None, None]) >> 16)
             + ((r1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(mixed, 0, 255).astype(np.uint8)


def _block_mean(x: np.ndarray, height: int, width: int, ix: int,
                iy: int) -> np.ndarray:
    C = x.shape[2]
    sums = x[:height * iy, :width * ix].astype(np.int32).reshape(
        height, iy, width, ix, C).sum(axis=(1, 3))
    if ix == 2 and iy == 2:
        return ((sums + 2) >> 2).astype(np.uint8)
    mean = sums.astype(np.float32) * (np.float32(1) / np.float32(ix * iy))
    return np.clip(np.rint(mean), 0, 255).astype(np.uint8)


def _area_table(n_src: int, n_dst: int, scale: float
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's `computeResizeAreaTab`: (target, source, float32 weight)
    entries, in order, each target's sources left to right."""
    dst, src, alpha = [], [], []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s2 = min(math.floor(f2), n_src - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            dst.append(d), src.append(s1 - 1), alpha.append((s1 - f1) / cell)
        for s in range(s1, s2):
            dst.append(d), src.append(s), alpha.append(1.0 / cell)
        if f2 - s2 > 1e-3:
            dst.append(d), src.append(s2)
            alpha.append(min(min(f2 - s2, 1.0), cell) / cell)
    return (np.asarray(dst), np.asarray(src),
            np.asarray(alpha, np.float64).astype(np.float32))


def _by_slot(dst: np.ndarray):
    """The table's entries grouped by their rank among their target's:
    within a group every target appears once, so a group is one
    vectorised step and the groups in turn keep each target's order."""
    first = np.r_[0, np.flatnonzero(np.diff(dst)) + 1]
    rank = np.arange(len(dst)) - np.repeat(first, np.diff(
        np.r_[first, len(dst)]))
    return [np.flatnonzero(rank == r) for r in range(int(rank.max()) + 1)]


def _area_shrink(x: np.ndarray, height: int, width: int, scale_x: float,
                 scale_y: float) -> np.ndarray:
    H, W, C = x.shape
    src = x.astype(np.float32)
    xd, xs, xa = _area_table(W, width, scale_x)
    rows = np.zeros((H, width, C), np.float32)
    for idx in _by_slot(xd):
        rows[:, xd[idx]] += src[:, xs[idx]] * xa[idx][None, :, None]
    yd, ys, ya = _area_table(H, height, scale_y)
    out = np.zeros((height, width, C), np.float32)
    for r, idx in enumerate(_by_slot(yd)):
        term = ya[idx][:, None, None] * rows[ys[idx]]
        if r == 0:
            out[yd[idx]] = term
        else:
            out[yd[idx]] += term
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
