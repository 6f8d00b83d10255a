"""PNG files on the standard library's ``zlib`` and ``struct`` and numpy
(no PIL is needed).

- ``read_png(path)`` decodes a non-interlaced PNG of bit depth 8 (grey,
  grey + alpha, RGB, RGBA, palette) or 16 (grey, KITTI's disparity maps)
  to its samples as stored: (H, W) for grey, (H, W, C) otherwise (the
  palette indices for a palette image), uint8 or uint16. IDAT may be split
  over any number of chunks; each chunk's CRC is checked. Anything else
  (interlacing, other bit depths, 16-bit colour, a bad CRC or a truncated
  file) raises ValueError naming what it met.
- ``read_png_rgb(path)`` -> (H, W, 3) uint8, as PIL's ``.convert("RGB")``
  gives it: grey replicated, alpha dropped, the palette looked up.
- ``png_size(path)`` -> (width, height) from IHDR alone, as PIL's ``.size``.
- ``write_png(path, array, filter_type=None)`` encodes (H, W, 3) uint8 RGB
  or (H, W) uint16 grey; ``filter_type`` 0-4 forces one filter on every
  row, None picks each row's by the smallest sum of absolute filtered bytes
  (libpng's heuristic).

The five filters are undone over the image at once, not byte by byte:
Sub, Average and Paeth read the reconstructed pixel to the left, so the
decoder walks the image by anti-diagonals (pixel (y, x) on step y + x),
where every pixel's left, upper and upper-left neighbours are done.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (name, samples a pixel)
_COLOR = {0: ("grey", 1), 2: ("RGB", 3), 3: ("palette", 1), 4: ("grey + alpha", 2),
          6: ("RGBA", 4)}


def _chunks(data: bytes, path: str):
    """-> (type, payload) of every chunk, CRCs checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (signature {data[:8]!r})")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind.decode('latin1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length


def _header(body: bytes, path: str) -> Tuple[int, int, int, int, int]:
    if len(body) != 13:
        raise ValueError(f"{path}: IHDR of {len(body)} bytes")
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if color not in _COLOR:
        raise ValueError(f"{path}: unknown colour type {color}")
    if comp != 0 or filt != 0:
        raise ValueError(f"{path}: compression method {comp}, filter method {filt}")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not read")
    if depth not in (8, 16) or (depth == 16 and color != 0):
        raise ValueError(f"{path}: bit depth {depth} with {_COLOR[color][0]} is not read "
                         "(8-bit grey, grey + alpha, RGB, RGBA, palette; 16-bit grey)")
    return w, h, depth, color, _COLOR[color][1]


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) from the IHDR chunk alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != SIGNATURE or head[8:16] != struct.pack(">I4s", 13, b"IHDR"):
        raise ValueError(f"{path}: not a PNG file that starts with IHDR")
    if zlib.crc32(head[12:29]) != struct.unpack(">I", head[29:33])[0]:
        raise ValueError(f"{path}: bad CRC in the IHDR chunk")
    w, h, *_ = _header(head[16:29], path)
    return w, h


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int, path: str) -> np.ndarray:
    """(h, 1 + w * bpp) filtered scanlines -> (h, w, bpp) uint8 bytes."""
    kinds = raw[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"{path}: filter type {int(kinds.max())} (0-4 only)")
    filt = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if (kinds == 0).all():
        return filt.astype(np.uint8)
    # skewed layout: pixel (y, x) at column y + x + 1, a zero column and a
    # zero row before the image stand for the neighbours outside it
    out = np.zeros((h + 1, w + h + 1, bpp), np.int32)
    rows = np.arange(h)
    skew = np.zeros((h, w + h + 1, bpp), np.int32)
    skew[rows[:, None], rows[:, None] + np.arange(w)[None, :] + 1] = filt
    for t in range(w + h - 1):
        lo, hi = max(0, t - w + 1), min(h - 1, t)
        col = t + 1
        ys = slice(lo, hi + 1)
        a = out[lo + 1:hi + 2, col - 1]  # left
        b = out[lo:hi + 1, col - 1]  # up: row y - 1 at x, one column back in the skew
        c = out[lo:hi + 1, col - 2]  # up-left
        k = kinds[ys, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(k == 3, (a + b) >> 1,
                                                                np.where(k == 4, _paeth(a, b, c),
                                                                         0))))
        out[lo + 1:hi + 2, col] = (skew[ys, col] + pred) & 0xFF
    return out[1 + rows[:, None], rows[:, None] + np.arange(w)[None, :] + 1].astype(np.uint8)


def _decode(path: str):
    """-> (samples, colour type, palette or None)."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = _header(body, path)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, channels = header
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    bpp = channels * depth // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: IDAT does not inflate ({e})") from None
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"{path}: {len(raw)} bytes of scanlines, expected "
                         f"{h * (1 + w * bpp)} for {w}x{h}")
    px = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp), h, w, bpp, path)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    return (px[..., 0] if channels == 1 else px), color, palette


def read_png(path: str) -> np.ndarray:
    """The samples as stored (see the module doc)."""
    return _decode(path)[0]


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's Image.open(path).convert("RGB")."""
    px, color, palette = _decode(path)
    if color == 2:
        return px
    if color == 6:
        return np.ascontiguousarray(px[..., :3])
    if color == 3:
        if int(px.max(initial=0)) >= len(palette):
            palette = np.concatenate([palette, np.zeros((256 - len(palette), 3), np.uint8)])
        return palette[px]
    grey = px[..., 0] if color == 4 else px
    if grey.dtype != np.uint8:
        raise ValueError(f"{path}: a 16-bit grey image has no 8-bit RGB form here")
    return np.repeat(grey[..., None], 3, axis=-1)


def _filtered(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """(h, n) bytes -> (h, n) bytes filtered with `kind` on every row."""
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = [0, a, b, (a + b) >> 1, None][kind]
    if kind == 4:
        pred = _paeth(a, b, c)
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, array: np.ndarray, filter_type: Optional[int] = None,
              level: int = 6) -> None:
    """Encode (H, W, 3) uint8 as RGB or (H, W) uint16 as 16-bit grey."""
    array = np.asarray(array)
    if array.ndim == 3 and array.shape[2] == 3 and array.dtype == np.uint8:
        color, depth, rows = 2, 8, array.reshape(array.shape[0], -1)
    elif array.ndim == 2 and array.dtype == np.uint16:
        color, depth, rows = 0, 16, array.astype(">u2").view(np.uint8).reshape(
            array.shape[0], -1)
    else:
        raise ValueError(f"write_png takes (H, W, 3) uint8 or (H, W) uint16, not "
                         f"{array.shape} {array.dtype}")
    h, w = array.shape[:2]
    bpp = 3 if color == 2 else 2
    if filter_type is None:
        cand = np.stack([_filtered(rows, bpp, k) for k in range(5)])
        cost = np.abs(cand.view(np.int8).astype(np.int64)).sum(axis=2)
        kinds = cost.argmin(axis=0)
        body = cand[kinds, np.arange(h)]
    elif filter_type in range(5):
        kinds = np.full(h, filter_type)
        body = _filtered(rows, bpp, filter_type)
    else:
        raise ValueError(f"filter type {filter_type} (0-4 or None)")
    raw = np.concatenate([kinds.astype(np.uint8)[:, None], body], axis=1).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))
