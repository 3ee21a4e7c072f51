"""Frame output as PNG — port of `vk3dgaussiansplatting_tpu.io.image`.

The reference presents RGBA8 swapchain images (Swapchain.cpp:20-48); a
headless renderer writes frames to PNG instead.  The JAX package encodes
with PIL; the port needs no imaging package: 8-bit PNG is encoded and
decoded here with the standard library's `zlib` and `struct`.  The writer
emits RGB or RGBA with filter 0 on every row; the reader takes 8-bit
greyscale, greyscale + alpha, RGB and RGBA, non-interlaced, with the five
row filters (0-4) other encoders such as PIL use, and returns the array PIL
would ([H, W] for greyscale, [H, W, 2|3|4] otherwise).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit samples only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, image_u8: np.ndarray) -> None:
    """Write an [H, W, 3|4] uint8 image to PNG."""
    arr = np.asarray(image_u8)
    if arr.dtype != np.uint8:
        raise TypeError("expected uint8 image")
    if arr.ndim != 3 or arr.shape[-1] not in (3, 4):
        raise ValueError(f"expected an [H, W, 3|4] image, got {arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_MAGIC + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec §9): raw is [h, 1 + stride]."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # sub: a running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            # Left neighbours depend on this row's own output: one byte
            # column group (bpp bytes) at a time.
            cur = np.zeros(stride, np.uint8)
            zero = np.zeros(bpp, np.uint8)
            for x in range(0, stride, bpp):
                left = cur[x - bpp : x] if x else zero
                up = prev[x : x + bpp]
                if kind == 3:
                    pred = ((left.astype(np.uint16) + up) // 2).astype(np.uint8)
                else:
                    pred = _paeth(left, up, prev[x - bpp : x] if x else zero)
                cur[x : x + bpp] = line[x : x + bpp] + pred
        else:
            raise ValueError(f"bad PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """Read an 8-bit, non-interlaced greyscale, RGB or RGBA (with or
    without alpha) PNG into a uint8 array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) PNG is supported "
                         f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, expected {h * (1 + w * c)}")
    img = _unfilter(raw.reshape(h, 1 + w * c), h, w * c, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img
