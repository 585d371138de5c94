"""The port's Pillow-free PNG reader and writer against Pillow.

The reader must give ``np.asarray(Image.open(p).convert("L"))`` exactly:
on every tracked PNG, on synthetic images that Pillow saves (its encoder
picks the row filters), and on synthetic images encoded here with one row
filter throughout, for each filter and each supported color type, that
Pillow decodes to the source image. Pillow reads the writer's output back
unchanged. The unsupported formats raise.
"""

import glob
import os
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from nsol_tpu_torch import data  # noqa: E402
from nsol_tpu_torch.io import (DataReader, DataWriter, read_png,  # noqa: E402
                               write_png)

TRACKED = sorted(glob.glob(os.path.join(data.data_dir(), "*.png")))


def _pil_l(path):
    return np.asarray(Image.open(path).convert("L"))


def test_there_are_eight_tracked_pngs():
    assert len(TRACKED) == 8


@pytest.mark.parametrize("path", TRACKED, ids=os.path.basename)
def test_reader_equals_pillow_on_tracked_pngs(path):
    got = read_png(path)
    assert got.dtype == np.uint8 and got.ndim == 2
    np.testing.assert_array_equal(got, _pil_l(path))


def _image(mode, shape=(23, 37), seed=0):
    """A seeded image with a smooth half and a noisy half."""
    rng = np.random.RandomState(seed)
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    ramp = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1]))
    a = (ramp[..., None] * (1 + np.arange(channels))
         + rng.randint(0, 40, shape + (channels,))) % 256
    a[shape[0] // 2:] = rng.randint(0, 256, a[shape[0] // 2:].shape)
    a = a.astype(np.uint8)
    return Image.fromarray(a[..., 0] if channels == 1 else a, mode)


def _filters(path):
    """The row filter types of an 8-bit non-interlaced PNG."""
    raw = open(path, "rb").read()
    pos, idat, width, bpp = 8, b"", 0, 1
    while pos < len(raw):
        n, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            width, _, _, ctype = struct.unpack(">IIBB", body[:10])
            bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(rows.reshape(-1, width * bpp + 1)[:, 0].tolist())


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("png_filter", ["none", "sub", "up", "average",
                                        "paeth", "adaptive"])
def test_reader_equals_pillow_per_filter_and_color_type(tmp_path, mode,
                                                        png_filter):
    """Pillow's encoder picks filters itself ("adaptive"); for one filter
    type on every row the image is encoded here and Pillow's decoding of
    it is the oracle."""
    path = str(tmp_path / "img.png")
    codes = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}
    img = _image(mode)
    if png_filter == "adaptive":
        img.save(path)
    else:
        _save_with_filter(img, path, codes[png_filter])
        assert _filters(path) == {codes[png_filter]}
    np.testing.assert_array_equal(read_png(path), _pil_l(path))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _write(path, width, height, ctype, rows, interlace=0):
    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))


def _save_with_filter(img, path, ftype):
    """Encode ``img`` with every row under filter ``ftype``, then check
    that Pillow reads it back as ``img``."""
    a = np.asarray(img).astype(np.int64)
    a = a.reshape(a.shape[0], -1)
    bpp = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[img.mode]
    ctype = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6}[img.mode]
    out = []
    prev = np.zeros(a.shape[1], np.int64)
    for row in a:
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([ftype]) + ((row - pred) % 256).astype(
            np.uint8).tobytes())
        prev = row
    _write(path, img.width, img.height, ctype, b"".join(out))
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  np.asarray(img))


def test_pillow_reads_the_writer_output_unchanged(tmp_path):
    a = np.random.RandomState(1).randint(0, 256, (31, 17)).astype(np.uint8)
    path = str(tmp_path / "w.png")
    write_png(a, path)
    img = Image.open(path)
    assert img.mode == "L"
    np.testing.assert_array_equal(np.asarray(img), a)
    np.testing.assert_array_equal(read_png(path), a)


def test_data_writer_rounds_to_uint8_and_data_reader_reads_back(tmp_path):
    """DataWriter's png path rounds then casts to uint8 (reference:
    nsol/data_writer.py:53-55); DataReader returns float64."""
    x = np.random.RandomState(2).rand(9, 11) * 255.0
    path = str(tmp_path / "x.png")
    DataWriter(x, path).write_data()
    reader = DataReader(path)
    reader.read_data()
    got = reader.get_data()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.round(x).astype(np.uint8))
    np.testing.assert_array_equal(_pil_l(path), np.round(x).astype(np.uint8))


@pytest.mark.parametrize("mode", ["I;16", "P", "interlaced"])
def test_unsupported_pngs_raise(tmp_path, mode):
    path = str(tmp_path / "u.png")
    if mode == "I;16":
        Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4)).save(
            path)
    elif mode == "P":
        _image("RGB").convert("P").save(path)
    else:  # Pillow writes no Adam7: set the flag; the header must refuse
        _write(path, 4, 3, 0, b"\x00\x01\x02\x03\x04" * 3, interlace=1)
    with pytest.raises(ValueError):
        read_png(path)


def test_not_a_png_and_corrupt_chunk_raise(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        read_png(str(bad))
    path = str(tmp_path / "ok.png")
    write_png(np.zeros((4, 4), np.uint8), path)
    raw = bytearray(open(path, "rb").read())
    raw[20] ^= 0xFF  # inside the IHDR body: the CRC no longer matches
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        read_png(str(bad))
