"""What `cv2` and `imageio` do on the NeRF path, written with `zlib` and
numpy from the PNG specification (https://www.w3.org/TR/png/):

- `read_png`: 8-bit grayscale, RGB and RGBA PNGs, not interlaced, with
  any of the five row filters; anything else raises.  Returns uint8
  [H, W] or [H, W, C] in the file's channel order (RGB(A), where cv2 gives
  BGR(A)).
- `write_png`: 8-bit grayscale, RGB or RGBA arrays, every row unfiltered.
- `downscale_area`: shrink by an integer factor as `cv2.resize(...,
  interpolation=cv2.INTER_AREA)` does to (W // f, H // f): a box mean of
  f x f pixels rounded half up when f divides both sides, else cv2's
  area weights of each source pixel's overlap, rounded to nearest.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels (8-bit only)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n


def _unfilter_slow(ftype: int, row: bytearray, prior: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) rows, in place: each byte depends on the
    reconstructed byte to its left."""
    n = len(row)
    if ftype == 3:
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
        return
    for i in range(n):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}); 8-bit gray, RGB or RGBA, not interlaced, "
                         "is supported")
    C = _CHANNELS[ctype]
    stride = W * C
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != H * (stride + 1):
        raise ValueError(f"{path}: image data has {len(raw)} bytes, expected {H * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(H, stride + 1)
    ftypes = rows[:, 0]
    if int(ftypes.max(initial=0)) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(ftypes.max())}")
    out = np.empty((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        f, cur = int(ftypes[y]), rows[y, 1:]
        if f == 0:
            rec = cur.copy()
        elif f == 1:  # Sub: a running sum along each channel, mod 256
            rec = np.cumsum(cur.reshape(W, C), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:  # Up
            rec = cur + prior
        else:
            buf = bytearray(cur.tobytes())
            _unfilter_slow(f, buf, prior.tobytes(), C)
            rec = np.frombuffer(bytes(buf), np.uint8)
        out[y] = rec
        prior = out[y]
    return out.reshape(H, W) if C == 1 else out.reshape(H, W, C)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W], [H, W, 3] or [H, W, 4] as an 8-bit PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png expects uint8, got {img.dtype}")
    C = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(C)
    if ctype is None or img.ndim not in (2, 3):
        raise ValueError(f"write_png expects [H, W], [H, W, 3] or [H, W, 4], got {img.shape}")
    H, W = img.shape[:2]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """[n_dst, n_src] weights of cv2's INTER_AREA: destination pixel j
    covers [j s, (j + 1) s) of the source, s = n_src / n_dst, each source
    pixel weighted by its overlap over s."""
    s = n_src / n_dst
    w = np.zeros((n_dst, n_src), np.float64)
    for j in range(n_dst):
        a, b = j * s, (j + 1) * s
        for i in range(int(np.floor(a)), min(int(np.ceil(b)), n_src)):
            w[j, i] = (min(b, i + 1) - max(a, i)) / s
    return w


def downscale_area(img: np.ndarray, factor: int) -> np.ndarray:
    """uint8 [H, W(, C)] -> [H // factor, W // factor(, C)] (see the module
    docstring)."""
    if factor <= 1:
        return img
    H, W = img.shape[:2]
    h, w = H // factor, W // factor
    x = img.astype(np.int64)
    if H % factor == 0 and W % factor == 0:
        s = x.reshape(h, factor, w, factor, *img.shape[2:]).sum(axis=(1, 3))
        area = factor * factor
        return ((s + area // 2) // area).astype(np.uint8)
    wy, wx = _area_weights(H, h), _area_weights(W, w)
    t = np.tensordot(wy, x.astype(np.float64), axes=(1, 0))  # [h, W(, C)]
    out = np.moveaxis(np.tensordot(wx, t, axes=(1, 1)), 0, 1)  # [h, w(, C)]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
