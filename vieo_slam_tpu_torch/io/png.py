"""PNG files on numpy and zlib alone (no OpenCV, no matplotlib).

`write_png` writes 8-bit gray or RGB, every row unfiltered, with optional
tEXt chunks; `read_png` reads non-interlaced 8- or 16-bit gray and RGB
(any row filter) and returns the tEXt chunks beside the pixels.  The
EuRoC reader (`io/euroc.load_image_gray`) and the viewer use them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}          # PNG color type -> samples a pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, array, text: dict | None = None) -> str:
    """Write uint8 [H, W] (gray) or [H, W, 3] (RGB) pixels; `text` maps
    keywords to tEXt strings (Latin-1).  Returns `path`."""
    a = np.asarray(array)
    if a.dtype != np.uint8 or not (a.ndim == 2
                                   or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 [H, W] or [H, W, 3], got "
                         f"{a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = a.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    parts = [MAGIC, _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0))]
    for key, value in (text or {}).items():
        parts.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0"
                            + str(value).encode("latin-1")))
    parts += [_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)),
              _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))
    return path


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif ftype == 2:
            cur = (line + prev) % 256
        elif ftype in (3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (line[x:x + bpp] + pred) % 256
        else:
            raise ValueError(f"PNG row filter {ftype} is not defined")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str):
    """(pixels, text): uint8 or uint16 [H, W] (gray) or [H, W, 3] (RGB),
    and the tEXt chunks as a dict.  Raises ValueError for any other PNG
    (palette, alpha, interlaced, other bit depths)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr, text = 8, [], None, {}
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", chunk)
        elif kind == b"IDAT":
            idat.append(chunk)
        elif kind == b"tEXt":
            key, _, value = chunk.partition(b"\0")
            text[key.decode("latin-1")] = value.decode("latin-1")
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: PNG color type {ctype}, bit depth "
                         f"{depth}, interlace {interlace} not supported")
    ch, bpp = _CHANNELS[ctype], _CHANNELS[ctype] * depth // 8
    pix = _unfilter(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8),
                    h, w * bpp, bpp)
    if depth == 16:
        pix = pix.reshape(h, -1).view(">u2").astype(np.uint16)
    pix = pix.reshape(h, w, ch)
    return (pix[..., 0] if ch == 1 else pix), text
