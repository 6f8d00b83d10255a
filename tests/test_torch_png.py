"""data/png.py, the PNG codec of the port, held bit for bit to PIL.

The decoder against PIL on files PIL writes (RGB, RGBA, grey, grey +
alpha, palette of more than 16 colours, 16-bit grey; odd widths,
one-pixel images and KITTI's 375x1242) and on files the encoder writes
with each of the five filters forced and with its per-row choice; PIL
decodes the encoder's files to the arrays written. IDAT split over many chunks reads the same; interlaced
files, bit depths it does not take and a bad CRC raise.
"""
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from disprcnn_tpu_torch.data import png


def _image(rng, h, w, c):
    """Smooth gradients with noise: rows that each filter type wins on."""
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    a = 127 + 100 * np.sin(7 * x + 3 * y + np.arange(c)) + rng.normal(0, 8, (h, w, c))
    return a.clip(0, 255).astype(np.uint8)


SHAPES = [(375, 1242), (7, 13), (1, 1), (5, 1), (3, 31)]


@pytest.mark.parametrize("mode,c", [("RGB", 3), ("RGBA", 4), ("L", 1), ("LA", 2)])
def test_decoder_equals_pil_on_pil_files(tmp_path, mode, c):
    rng = np.random.default_rng(len(mode))
    for h, w in SHAPES:
        a = _image(rng, h, w, c)
        path = str(tmp_path / f"{mode}_{h}x{w}.png")
        Image.fromarray(a[..., 0] if c == 1 else a, mode).save(path)
        with Image.open(path) as im:
            want_rgb = np.asarray(im.convert("RGB"))
            want_raw = np.asarray(im)
            size = im.size
        got = png.read_png_rgb(path)
        assert got.dtype == np.uint8 and np.array_equal(got, want_rgb), (mode, h, w)
        assert np.array_equal(png.read_png(path), want_raw)
        assert png.png_size(path) == size == (w, h)


def test_decoder_equals_pil_on_palette_files(tmp_path):
    rng = np.random.default_rng(9)
    for colors, (h, w) in ((100, (33, 57)), (17, (375, 1242)), (256, (4, 9))):
        path = str(tmp_path / f"p{colors}.png")
        Image.fromarray(_image(rng, h, w, 3)).quantize(colors).save(path)
        with Image.open(path) as im:
            assert im.mode == "P"
            want, idx = np.asarray(im.convert("RGB")), np.asarray(im)
        assert np.array_equal(png.read_png_rgb(path), want)
        assert np.array_equal(png.read_png(path), idx)


def _disparity(rng, h, w):
    return (rng.uniform(0, 200, (h, w)) * 256).astype(np.uint16)


def test_decoder_equals_pil_on_16_bit_grey(tmp_path):
    rng = np.random.default_rng(10)
    for h, w in SHAPES:
        d = _disparity(rng, h, w)
        path = str(tmp_path / f"d_{h}x{w}.png")
        Image.fromarray(d).save(path)
        with Image.open(path) as im:
            want = np.asarray(im)
        got = png.read_png(path)
        assert got.dtype == np.uint16 and np.array_equal(got, want) and np.array_equal(got, d)
        assert png.png_size(path) == (w, h)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, None])
def test_encoder_filters_round_trip_through_pil(tmp_path, filter_type):
    rng = np.random.default_rng(11)
    for h, w in ((375, 1242) if filter_type is None else (61, 257), (6, 5), (1, 3)):
        rgb, disp = _image(rng, h, w, 3), _disparity(rng, h, w)
        for arr, name in ((rgb, "rgb"), (disp, "disp")):
            path = str(tmp_path / f"{name}_{h}x{w}.png")
            png.write_png(path, arr, filter_type)
            with Image.open(path) as im:
                assert np.array_equal(np.asarray(im), arr), (name, h, w)
                assert im.size == (w, h)
            assert np.array_equal(png.read_png(path), arr)
            if name == "rgb":
                assert np.array_equal(png.read_png_rgb(path), arr)


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _raw_png(w, h, depth, color, rows, interlace=0, idat_parts=1):
    data = zlib.compress(rows)
    step = -(-len(data) // idat_parts)
    idats = b"".join(_chunk(b"IDAT", data[i:i + step]) for i in range(0, len(data), step))
    return (png.SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + idats + _chunk(b"IEND", b""))


def test_idat_over_many_chunks(tmp_path):
    rng = np.random.default_rng(12)
    a = _image(rng, 40, 50, 3)
    rows = b"".join(b"\x00" + a[y].tobytes() for y in range(40))
    for parts in (1, 3, 17):
        path = tmp_path / f"split{parts}.png"
        path.write_bytes(_raw_png(50, 40, 8, 2, rows, idat_parts=parts))
        assert np.array_equal(png.read_png_rgb(str(path)), a)
        with Image.open(path) as im:
            assert np.array_equal(np.asarray(im), a)


@pytest.mark.parametrize("what,kw,match", [
    ("interlaced", dict(depth=8, color=2, interlace=1), "interlaced"),
    ("1-bit", dict(depth=1, color=0), "bit depth 1"),
    ("4-bit palette", dict(depth=4, color=3), "bit depth 4"),
    ("16-bit RGB", dict(depth=16, color=2), "bit depth 16"),
])
def test_unsupported_files_raise(tmp_path, what, kw, match):
    path = tmp_path / "x.png"
    path.write_bytes(_raw_png(4, 2, kw["depth"], kw["color"], b"\x00" * 64,
                              interlace=kw.get("interlace", 0)))
    with pytest.raises(ValueError, match=match):
        png.read_png(str(path))
    with pytest.raises(ValueError, match=match):
        png.png_size(str(path))


def test_bad_crc_and_truncation_raise(tmp_path):
    good = tmp_path / "good.png"
    png.write_png(str(good), _image(np.random.default_rng(13), 8, 8, 3))
    data = bytearray(good.read_bytes())
    bad = tmp_path / "bad.png"
    data[-20] ^= 0xFF  # inside IDAT
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad CRC in the IDAT"):
        png.read_png(str(bad))
    head = bytearray(good.read_bytes())
    head[20] ^= 0x01  # the IHDR width
    bad.write_bytes(bytes(head))
    with pytest.raises(ValueError, match="bad CRC in the IHDR"):
        png.png_size(str(bad))
    bad.write_bytes(good.read_bytes()[:-30])
    with pytest.raises(ValueError, match="truncated"):
        png.read_png(str(bad))
    with pytest.raises(ValueError, match="not a PNG"):
        png.png_size(os.devnull)
