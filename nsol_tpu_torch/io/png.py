"""8-bit PNG read and write with zlib and numpy only (no Pillow).

The reader takes non-interlaced 8-bit images of color type 0 (gray),
2 (RGB), 4 (gray + alpha) and 6 (RGBA), undoes the five row filters (None,
Sub, Up, Average, Paeth) and returns the image as Pillow's
``Image.open(path).convert("L")`` would: gray as it is, alpha dropped, RGB
by Pillow's integer ITU-R 601-2 rule ``(19595 R + 38470 G + 7471 B +
0x8000) >> 16``. 16-bit, palette (type 3) and interlaced files raise
``ValueError``. The writer stores an 8-bit grayscale image.
"""

import struct
import zlib

import numpy as np

__all__ = ["read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: samples per pixel of each supported color type
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(raw, path):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + length]
        crc = raw[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("%s: truncated PNG chunk %r" % (path, kind))
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError("%s: bad CRC in PNG chunk %r" % (path, kind))
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("%s: PNG without IEND" % path)


def _paeth_row(raw, prev, bpp):
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(raw, prev, bpp):
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prev[i]) >> 1)) & 0xFF
    return out


def _unfilter(data, height, stride, bpp, path):
    """Undo the per-row filters of the decompressed stream."""
    if len(data) != height * (stride + 1):
        raise ValueError("%s: PNG image data has %d bytes, expected %d"
                         % (path, len(data), height * (stride + 1)))
    rows = np.frombuffer(data, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        ftype, raw = int(rows[r, 0]), rows[r, 1:]
        if ftype == 0:
            cur = raw
        elif ftype == 1:  # Sub: a running sum per sample, mod 256
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = raw + prev
        elif ftype == 3:  # Average
            cur = np.frombuffer(_average_row(raw.tobytes(), prev.tobytes(),
                                             bpp), np.uint8)
        elif ftype == 4:  # Paeth
            cur = np.frombuffer(_paeth_row(raw.tobytes(), prev.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError("%s: unknown PNG filter type %d in row %d"
                             % (path, ftype, r))
        out[r] = cur
        prev = out[r]
    return out


def read_png(path):
    """The image at ``path`` as a 2-D uint8 array, with Pillow's
    ``convert("L")`` semantics."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(_SIGNATURE):
        raise ValueError("%s is not a PNG file" % path)
    header, idat = None, []
    for kind, body in _chunks(raw, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("%s: PNG without IHDR" % path)
    width, height, depth, ctype, compression, filtering, interlace = header
    if depth != 8:
        raise ValueError("%s: %d-bit PNG; only 8-bit samples are supported"
                         % (path, depth))
    if ctype not in _CHANNELS:
        raise ValueError("%s: PNG color type %d (palette or unknown) is not "
                         "supported" % (path, ctype))
    if interlace != 0:
        raise ValueError("%s: interlaced PNG is not supported" % path)
    if compression != 0 or filtering != 0:
        raise ValueError("%s: unknown PNG compression/filter method" % path)
    bpp = _CHANNELS[ctype]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                       bpp, path).reshape(height, width, bpp)
    if ctype in (0, 4):
        return np.ascontiguousarray(pixels[..., 0])
    rgb = pixels[..., :3].astype(np.uint32)
    lum = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
           + 0x8000) >> 16
    return lum.astype(np.uint8)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(nda, path):
    """Write a 2-D uint8 array as an 8-bit grayscale PNG (filter None)."""
    nda = np.asarray(nda)
    if nda.ndim != 2 or nda.dtype != np.uint8:
        raise ValueError("write_png takes a 2-D uint8 array, got %s %s"
                         % (nda.dtype, nda.shape))
    height, width = nda.shape
    rows = np.zeros((height, width + 1), np.uint8)
    rows[:, 1:] = nda
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
