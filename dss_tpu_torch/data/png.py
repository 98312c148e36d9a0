"""PNG reading and writing in numpy and the standard library's zlib.

The decoder reads 8-bit, non-interlaced PNGs of colour type gray, gray +
alpha, RGB and RGBA, with all five row filters (None, Sub, Up, Average,
Paeth); any other PNG raises ValueError naming what it found.  The encoder
writes filter-0 rows.

Sub, Average and Paeth predict a pixel from its left neighbour, so a row is
sequential along x; Up, Average and Paeth also read the row above.  Pixel
(y, x) therefore depends only on pixels of the anti-diagonals y + x − 1 and
y + x − 2, and `_unfilter` reconstructs one anti-diagonal per step, for all
its rows, all channels and every image of a batch at once: H + W − 1
vectorized steps per batch instead of a Python step per byte.  The images
of one `read_pngs` call that share their size and colour type form one
batch.
"""
from __future__ import annotations

import os
import struct
import zlib
from collections import defaultdict
from typing import List, Sequence, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels, for bit depth 8
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}
# work arrays of one decoded batch stay below this many bytes
_BATCH_BYTES = 1 << 28


def _parse(data: bytes, name: str = "<bytes>") -> Tuple[int, int, int, np.ndarray]:
    """(height, width, channels, filtered rows (H, 1 + W·C) uint8) of one
    PNG file's bytes; the first byte of each row is its filter type."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: CRC mismatch in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, colour, _compression, _filter, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(
            f"{name}: bit depth {depth}, colour type {colour}: only 8-bit "
            f"gray, gray+alpha, RGB and RGBA PNGs are supported")
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not supported")
    c = _CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + w * c):
        raise ValueError(f"{name}: {len(raw)} bytes of image data, expected "
                         f"{h * (1 + w * c)}")
    return h, w, c, np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)


def _unfilter(rows: np.ndarray, c: int) -> np.ndarray:
    """Reconstruct filtered rows (N, H, 1 + W·C) uint8 → (N, H, W, C)
    uint8, one anti-diagonal y + x = d per step.

    The reconstruction is kept skewed: sk[:, y + 1, d + 2] holds pixel
    (y, d − y), so the left neighbour a, the one above b and the upper-left
    c of a diagonal's pixels are plain slices of the two previous columns;
    row 0 and columns 0–1 stay zero, the PNG value outside the image."""
    n, h, width = rows.shape
    w = (width - 1) // c
    ftype = rows[:, :, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    filt = rows[:, :, 1:].reshape(n, h, w, c)
    if not ftype.any():
        return filt.copy()
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    skew_f = np.zeros((n, h, h + w, c), np.int16)
    skew_f[:, yy, yy + xx] = filt
    sk = np.zeros((n, h + 1, h + w + 1, c), np.int16)
    ftype = ftype.astype(np.int16)[:, :, None]
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h - 1, d) + 1
        a = sk[:, y0 + 1:y1 + 1, d + 1]
        b = sk[:, y0:y1, d + 1]
        ul = sk[:, y0:y1, d]
        pa, pb, pc = np.abs(b - ul), np.abs(a - ul), np.abs(a + b - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        pred = np.choose(ftype[:, y0:y1], (0, a, b, (a + b) >> 1, paeth))
        sk[:, y0 + 1:y1 + 1, d + 2] = (skew_f[:, y0:y1, d] + pred) & 0xFF
    return sk[:, yy + 1, yy + xx + 2].astype(np.uint8)


def _shaped(img: np.ndarray) -> np.ndarray:
    """(H, W) for one channel, as imageio returns gray images."""
    return img[..., 0] if img.shape[-1] == 1 else img


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode PNG files: (H, W) uint8 for gray, (H, W, C) for gray+alpha,
    RGB and RGBA.  Files of equal size and colour type are reconstructed
    together."""
    parsed = []
    for p in paths:
        with open(p, "rb") as f:
            parsed.append(_parse(f.read(), os.fspath(p)))
    groups = defaultdict(list)
    for i, (h, w, c, _) in enumerate(parsed):
        groups[(h, w, c)].append(i)
    out: List[np.ndarray] = [None] * len(parsed)
    for (h, w, c), idx in groups.items():
        per_image = (h + 1) * (h + w + 1) * c * 2 * 2
        step = max(1, _BATCH_BYTES // per_image)
        for k in range(0, len(idx), step):
            part = idx[k:k + step]
            imgs = _unfilter(np.stack([parsed[i][3] for i in part]), c)
            for i, img in zip(part, imgs):
                out[i] = _shaped(img)
    return out


def read_png(path: str) -> np.ndarray:
    return read_pngs([path])[0]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit image as PNG bytes: (H, W) gray or (H, W, C) with C = 1
    (gray), 2 (gray+alpha), 3 (RGB) or 4 (RGBA); every row with filter 0."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in _COLOUR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1..4) images, "
                         f"got shape {a.shape}")
    h, w, c = a.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an 8-bit image (see `encode_png`) to `path`."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
