"""Image loading: the port's copy of ``sfm_tpu/io/images.py``.

Native PPM/PGM (P2/P3/P5/P6) decoding in numpy, with an optional PIL/cv2
fallback for other formats. Mask semantics: binarize at 127, invert (the
object is dark in the source silhouettes), morphological close with a 3x3
kernel. ``tests/test_torch_host_copies.py`` holds it against the original.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np


def _read_pnm(path: Path) -> np.ndarray:
    """Decode P2/P3 (ascii) and P5/P6 (binary) netpbm files to uint8/uint16."""
    data = Path(path).read_bytes()
    if not data[:1] == b"P":
        raise ValueError(f"not a PNM file: {path}")
    magic = data[:2].decode("ascii")
    if magic not in ("P2", "P3", "P5", "P6"):
        raise ValueError(f"unsupported PNM magic {magic!r} in {path}")

    # Tokenize the header: magic, width, height, maxval; '#' starts a comment.
    tokens = []
    pos = 2
    while len(tokens) < 3:
        m = re.match(rb"\s*(?:#[^\n]*\n\s*)*(\S+)", data[pos:])
        if m is None:
            raise ValueError(f"truncated PNM header in {path}")
        tokens.append(m.group(1))
        pos += m.end()
    width, height, maxval = int(tokens[0]), int(tokens[1]), int(tokens[2])
    channels = 3 if magic in ("P3", "P6") else 1
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")

    if magic in ("P5", "P6"):
        pos += 1  # single whitespace byte after maxval
        count = width * height * channels
        arr = np.frombuffer(data, dtype=dtype, count=count, offset=pos)
    else:
        arr = np.array(data[pos:].split(), dtype=np.int64).astype(dtype)
    arr = arr.reshape(height, width, channels) if channels == 3 else arr.reshape(height, width)
    if maxval >= 256:
        arr = (arr.astype(np.float32) * (255.0 / maxval)).astype(np.uint8)
    return np.asarray(arr)


def load_image(path) -> np.ndarray:
    """Load an image as (H, W, 3) uint8 RGB or (H, W) uint8 gray."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in (".ppm", ".pgm", ".pnm"):
        return _read_pnm(path)
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        pass
    try:
        import cv2

        img = cv2.imread(str(path))
        if img is None:
            raise ValueError(f"failed to read {path}")
        return img[..., ::-1].copy()  # BGR -> RGB
    except ImportError as e:
        raise ValueError(
            f"cannot decode {path}: install PIL/cv2 for non-PNM formats"
        ) from e


def to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W[, 3]) uint8 -> (H, W) float32 in [0, 1] (ITU-R BT.601 luma)."""
    img = np.asarray(img)
    if img.ndim == 3:
        img = img @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
    return img.astype(np.float32) / 255.0


def load_image_gray(path) -> np.ndarray:
    return to_gray(load_image(path))


def load_image_gray_u16(path) -> np.ndarray:
    """(H, W) uint16 luma in [0, 65535] — lossless-for-practical-purposes
    wire format (quantization error 7.6e-6, far below the DoG contrast
    threshold). The detection frontend normalizes on device
    (frontend._normalize_image)."""
    g = to_gray(load_image(path))
    return np.round(g * 65535.0).astype(np.uint16)


def load_image_gray_u8(path) -> np.ndarray:
    """(H, W) uint8 luma — the frontend's default wire format.

    Half the host->device bytes of u16. Quantization error (<=0.002) sits
    below the DoG contrast threshold (0.006) and matches the precision the
    reference's own detector consumes (cv2 feeds u8 grayscale to FAST/ORB,
    ref find_matches.py:57); measured on bunny the keypoint set shifts by
    <0.1% and reconstruction is unchanged (36/36 cameras)."""
    g = to_gray(load_image(path))
    return np.round(g * 255.0).astype(np.uint8)


def _binary_close(mask: np.ndarray) -> np.ndarray:
    """3x3 morphological close (dilate then erode) on a boolean mask."""

    def _shift_or(m):
        out = m.copy()
        out[1:, :] |= m[:-1, :]
        out[:-1, :] |= m[1:, :]
        out[:, 1:] |= m[:, :-1]
        out[:, :-1] |= m[:, 1:]
        out[1:, 1:] |= m[:-1, :-1]
        out[:-1, :-1] |= m[1:, 1:]
        out[1:, :-1] |= m[:-1, 1:]
        out[:-1, 1:] |= m[1:, :-1]
        return out

    def _shift_and(m):
        out = m.copy()
        out[1:, :] &= m[:-1, :]
        out[:-1, :] &= m[1:, :]
        out[:, 1:] &= m[:, :-1]
        out[:, :-1] &= m[:, 1:]
        out[1:, 1:] &= m[:-1, :-1]
        out[:-1, :-1] &= m[1:, 1:]
        out[1:, :-1] &= m[:-1, 1:]
        out[:-1, 1:] &= m[1:, :-1]
        return out

    return _shift_and(_shift_or(mask))


def load_mask(path, invert: bool = True) -> np.ndarray:
    """Load a silhouette mask as boolean (True = foreground / object).

    Reference semantics (find_matches.py:49-72): threshold at 127, invert
    (the source silhouettes mark the object as dark), then a 3x3 close.
    """
    img = load_image(path)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    mask = img > 127
    if invert:
        mask = ~mask
    return _binary_close(mask)
