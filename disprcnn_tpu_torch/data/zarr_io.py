"""Minimal pure-python zarr-v2 DirectoryStore reader (a copy of
disprcnn_tpu/data/zarr_io.py).

The reference's pseudo-GT instance masks are zarr stores
(data/datasets/kitti_car.py:275-288: ``zarr.load(imgid + '.zarr') != 0``),
written by ``zarr.save`` with the v2 defaults — Blosc(cname='lz4', clevel=5,
shuffle=SHUFFLE). zarr/numcodecs/blosc are not installed in this image, so
this module implements just enough of the on-disk format to read them:

- ``.zarray`` v2 metadata (shape/chunks/dtype/order/fill_value/compressor),
  both at the store root (``zarr.save`` of one array) and one level down
  (``.zgroup`` + named arrays).
- chunk assembly with edge clipping and fill_value for missing chunks,
  C and F order, '.' or '/' dimension separators.
- codecs: raw (compressor null), zlib, gzip, numcodecs-LZ4 framing, and
  c-blosc1 chunks (memcpy, lz4 and zlib internal codecs, byte shuffle,
  block splitting) — the zarr default. blosclz/zstd/snappy/bit-shuffle are
  rejected with a clear error rather than mis-decoded.

Everything is stdlib + numpy; the LZ4 block decoder is implemented here.
"""
from __future__ import annotations

import gzip
import json
import os
import struct
import zlib
from typing import Optional

import numpy as np

# c-blosc1 constants (blosc.h)
_BLOSC_MEMCPYED = 0x2
_BLOSC_DOSHUFFLE = 0x1
_BLOSC_DOBITSHUFFLE = 0x4
_BLOSC_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_MAX_SPLITS = 16
_MIN_BUFFERSIZE = 128


def lz4_decompress_block(src: bytes, dst_size: int) -> bytes:
    """Raw LZ4 block decode (the standard token/literals/match format)."""
    dst = bytearray(dst_size)
    si, di, n = 0, 0, len(src)
    while si < n:
        token = src[si]
        si += 1
        # literals
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[si]
                si += 1
                lit += b
                if b != 255:
                    break
        dst[di : di + lit] = src[si : si + lit]
        si += lit
        di += lit
        if si >= n:  # last sequence has no match
            break
        # match
        offset = src[si] | (src[si + 1] << 8)
        si += 2
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[si]
                si += 1
                mlen += b
                if b != 255:
                    break
        ref = di - offset
        if offset == 0:
            raise ValueError("corrupt lz4 block: zero offset")
        for _ in range(mlen):  # may overlap: byte-at-a-time is the semantics
            dst[di] = dst[ref]
            di += 1
            ref += 1
    if di != dst_size:
        raise ValueError(f"lz4 block decoded {di} bytes, expected {dst_size}")
    return bytes(dst)


def _unshuffle(data: bytes, typesize: int) -> bytes:
    """Inverse of blosc byte shuffle: typesize planes -> interleaved items."""
    arr = np.frombuffer(data, np.uint8)
    n = len(data) // typesize
    return arr.reshape(typesize, n).T.tobytes()


def blosc_decompress(buf: bytes) -> bytes:
    """Decode one c-blosc1 chunk (README_CHUNK_FORMAT.rst layout)."""
    if len(buf) < 16:
        raise ValueError("blosc chunk shorter than its 16-byte header")
    flags, typesize = buf[2], buf[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", buf, 4)
    if flags & _BLOSC_MEMCPYED:
        return bytes(buf[16 : 16 + nbytes])
    if flags & _BLOSC_DOBITSHUFFLE:
        raise NotImplementedError("blosc bit-shuffle not supported")
    codec = _BLOSC_CODECS.get(flags >> 5, "?")
    if codec == "lz4":
        decomp = lz4_decompress_block
    elif codec == "zlib":
        decomp = lambda s, d: zlib.decompress(bytes(s))
    else:
        raise NotImplementedError(f"blosc internal codec '{codec}' not supported")

    nblocks = (nbytes + blocksize - 1) // blocksize
    bstarts = struct.unpack_from(f"<{nblocks}I", buf, 16)
    # c-blosc1 split_block(): blosclz/lz4 streams split per byte-plane
    split = codec in ("blosclz", "lz4") and 1 < typesize <= _MAX_SPLITS \
        and blocksize // typesize >= _MIN_BUFFERSIZE
    out = bytearray(nbytes)
    for j in range(nblocks):
        bsize = min(blocksize, nbytes - j * blocksize)
        nsplits = typesize if split and bsize % typesize == 0 else 1
        neblock = bsize // nsplits
        pos = bstarts[j]
        block = bytearray()
        for _ in range(nsplits):
            (csize,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            stream = buf[pos : pos + csize]
            pos += csize
            if csize == 0:
                block += b"\x00" * neblock
            elif csize == neblock:  # stored raw (incompressible stream)
                block += stream
            else:
                block += decomp(stream, neblock)
        if flags & _BLOSC_DOSHUFFLE and typesize > 1:
            block = _unshuffle(bytes(block), typesize)
        out[j * blocksize : j * blocksize + bsize] = block
    return bytes(out)


def _decompress(data: bytes, compressor: Optional[dict], nbytes: int) -> bytes:
    if compressor is None:
        return data
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.decompress(data)
    if cid == "gzip":
        return gzip.decompress(data)
    if cid == "blosc":
        return blosc_decompress(data)
    if cid == "lz4":  # numcodecs framing: <u4 uncompressed size, then block
        (size,) = struct.unpack_from("<I", data, 0)
        return lz4_decompress_block(data[4:], size)
    raise NotImplementedError(f"zarr compressor '{cid}' not supported")


def _find_array_dir(path: str) -> str:
    if os.path.exists(os.path.join(path, ".zarray")):
        return path
    if os.path.exists(os.path.join(path, ".zgroup")):
        # zarr.save of one array names it 'arr_0'; otherwise take the sole
        # array member (deterministic order for reproducibility)
        cand = sorted(
            d for d in os.listdir(path)
            if os.path.exists(os.path.join(path, d, ".zarray"))
        )
        if "arr_0" in cand:
            return os.path.join(path, "arr_0")
        if len(cand) == 1:
            return os.path.join(path, cand[0])
        raise ValueError(f"{path}: zarr group with {len(cand)} arrays; "
                         "expected exactly one (or 'arr_0')")
    raise FileNotFoundError(f"{path}: no .zarray/.zgroup")


def load_zarr(path: str) -> np.ndarray:
    """Read a zarr-v2 DirectoryStore array (zarr.load equivalent)."""
    adir = _find_array_dir(path)
    with open(os.path.join(adir, ".zarray")) as f:
        meta = json.load(f)
    if meta.get("zarr_format") != 2:
        raise NotImplementedError(f"zarr_format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise NotImplementedError("zarr filters not supported")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value", 0)
    if fill is None:
        fill = 0
    out = np.full(shape, fill, dtype=dtype)
    if not shape:
        shape_, chunks_ = (1,), (1,)
        out = out.reshape(1)
    else:
        shape_, chunks_ = shape, chunks
    grid = [max(1, -(-s // c)) for s, c in zip(shape_, chunks_)]
    for idx in np.ndindex(*grid):
        key = sep.join(map(str, idx)) if idx else "0"
        cpath = os.path.join(adir, key)
        if not os.path.exists(cpath):
            continue
        with open(cpath, "rb") as f:
            raw = f.read()
        nbytes = int(np.prod(chunks_)) * dtype.itemsize
        data = _decompress(raw, meta.get("compressor"), nbytes)
        chunk = np.frombuffer(data, dtype=dtype).reshape(chunks_, order=order)
        sel = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks_, shape_)
        )
        chunk_sel = tuple(slice(0, sl.stop - sl.start) for sl in sel)
        out_view = out if shape else out  # 0-d handled via reshape above
        out_view[sel] = chunk[chunk_sel]
    return out.reshape(shape) if not shape else out


def save_zarr(path: str, arr: np.ndarray, compressor: Optional[str] = "zlib") -> None:
    """Write a single-chunk zarr-v2 DirectoryStore (the layout zarr.save
    produces for one array). Used by tools/make_mini_kitti.py so the staged
    e2e pipeline exercises the same store format the reference's pseudo-GT
    dumps use; compressor 'zlib' or None (raw)."""
    os.makedirs(path, exist_ok=True)
    arr = np.ascontiguousarray(arr)
    meta = {
        "zarr_format": 2,
        "shape": list(arr.shape),
        "chunks": list(arr.shape) if arr.shape else [1],
        "dtype": arr.dtype.str,
        "order": "C",
        "fill_value": 0,
        "filters": None,
        "compressor": {"id": "zlib", "level": 1} if compressor == "zlib" else None,
    }
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump(meta, f)
    data = arr.tobytes()
    if compressor == "zlib":
        data = zlib.compress(data, 1)
    key = ".".join("0" for _ in (arr.shape or (1,)))
    with open(os.path.join(path, key), "wb") as f:
        f.write(data)
