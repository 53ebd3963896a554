'''
PNG reader and writer in numpy and zlib, for the Kubric data path (the port reads and
writes no image through cv2 or PIL).

`read_png` decodes non-interlaced PNGs of bit depth 8 or 16 and colour type 0 (gray),
2 (RGB), 3 (palette, 8-bit), 4 (gray + alpha) or 6 (RGBA). Channels come in the file's
order, RGB(A), not cv2's BGR(A). The row filters are undone by the native library
(native.png_unfilter); `unfilter_numpy` is its oracle, and the path under
TCOW_NO_NATIVE=1. `write_png` writes the same formats, every row with one filter type.
'''

import struct
import zlib
from typing import Optional

import numpy as np

from tcow_tpu_torch import native

SIGNATURE = b'\x89PNG\r\n\x1a\n'
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_numpy(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    '''numpy version of native.png_unfilter: one row at a time; Avg and Paeth one pixel
    at a time, as their prediction reads the byte just reconstructed to the left.'''
    rows = np.asarray(raw, np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int32)
    for y in range(height):
        ftype, x = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = x
        elif ftype == 1:
            cur = np.cumsum(x.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (x + prev) & 0xFF
        elif ftype in (3, 4):
            cur = x.copy()
            for i in range(0, row_bytes, bpp):
                a = cur[i - bpp:i] if i >= bpp else 0
                b = prev[i:i + bpp]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp:i] if i >= bpp else 0
                    pred = _paeth(np.asarray(a), b, np.asarray(c))
                cur[i:i + bpp] = (x[i:i + bpp] + pred) & 0xFF
        else:
            raise ValueError(f'unknown PNG filter type {ftype} in row {y}')
        out[y] = cur
        prev = cur.astype(np.int32)
    return out


def read_png(path: str) -> np.ndarray:
    '''The image at `path`: (H, W) for gray, else (H, W, C) in the file's channel order
    (gray + alpha, RGB or RGBA; a palette image as RGB, or RGBA when it has a tRNS
    chunk); uint8 or uint16. Raises ValueError naming the path for an unsupported or
    damaged file.'''
    with open(path, 'rb') as f:
        data = f.read()
    try:
        return _decode(data)
    except (ValueError, zlib.error, struct.error) as e:
        raise ValueError(f'{path}: {e}') from e


def _decode(data: bytes) -> np.ndarray:
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG file')
    pos, header, palette, trns, idat = 8, None, None, None, []
    while pos < len(data):
        length, ctype = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack('>I', data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f'bad CRC in chunk {ctype!r}')
        pos += 12 + length
        if ctype == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif ctype == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b'tRNS':
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b'IDAT':
            idat.append(body)
        elif ctype == b'IEND':
            break
    if header is None:
        raise ValueError('no IHDR chunk')
    width, height, depth, ctype, _, _, interlace = header
    if interlace != 0:
        raise ValueError('interlaced (Adam7) PNGs are not supported')
    if ctype not in CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f'unsupported PNG: colour type {ctype}, bit depth {depth}')
    if ctype == 3 and palette is None:
        raise ValueError('palette image without a PLTE chunk')
    channels = CHANNELS[ctype]
    bpp = channels * depth // 8
    row_bytes = width * bpp
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f'IDAT holds {raw.size} bytes, expected {height} x (1 + {row_bytes})')
    if native.enabled():
        rows = native.png_unfilter(raw, height, row_bytes, bpp)
    else:
        rows = unfilter_numpy(raw, height, row_bytes, bpp)
    img = rows.view('>u2').astype(np.uint16) if depth == 16 else rows
    img = img.reshape(height, width, channels)
    if ctype == 3:
        idx = img[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError('palette index out of range')
        if trns is None:
            return palette[idx]
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:min(len(trns), len(palette))] = trns[:len(palette)]
        return np.concatenate([palette[idx], alpha[idx][..., None]], axis=-1)
    return img[..., 0] if channels == 1 else img


def _filter_rows(rows: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    x = rows.astype(np.int32)
    if filter_type == 0:
        return rows
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    if filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    elif filter_type == 4:
        c = np.zeros_like(x)
        c[1:, bpp:] = x[:-1, :-bpp]
        pred = _paeth(a, b, c)
    else:
        raise ValueError(f'unknown PNG filter type {filter_type}')
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack('>I', len(body)) + ctype + body + \
        struct.pack('>I', zlib.crc32(ctype + body))


def write_png(path: str, array: np.ndarray, level: int = 1, filter_type: int = 0,
              palette: Optional[np.ndarray] = None):
    '''Writes `array` as a PNG: (H, W) gray, (H, W, 2) gray + alpha, (H, W, 3) RGB or
    (H, W, 4) RGBA, uint8 or uint16; with `palette` ((N, 3) uint8), `array` is (H, W)
    uint8 indices into it (colour type 3). Every row gets filter `filter_type` (0 None,
    1 Sub, 2 Up, 3 Avg, 4 Paeth); zlib compresses at `level`.'''
    array = np.asarray(array)
    if array.dtype not in (np.uint8, np.uint16):
        raise TypeError(f'write_png takes uint8 or uint16, got {array.dtype}')
    img = array[..., None] if array.ndim == 2 else array
    if img.ndim != 3 or img.shape[-1] not in (1, 2, 3, 4):
        raise ValueError(f'write_png takes (H, W[, C]) with C in 1-4, got {array.shape}')
    height, width, channels = img.shape
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        if array.ndim != 2 or array.dtype != np.uint8 or int(array.max(initial=0)) >= len(palette):
            raise ValueError('a palette image is (H, W) uint8 indices into the palette')
        ctype = 3
    else:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    depth = 8 * img.dtype.itemsize
    rows = (img.astype('>u2') if depth == 16 else img).reshape(height, -1)
    rows = rows.view(np.uint8).reshape(height, -1)
    bpp = channels * img.dtype.itemsize
    filtered = _filter_rows(rows, bpp, filter_type)
    raw = np.concatenate([np.full((height, 1), filter_type, np.uint8), filtered], axis=1)
    out = [SIGNATURE,
           _chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, depth, ctype, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b'PLTE', palette.tobytes()))
    out += [_chunk(b'IDAT', zlib.compress(raw.tobytes(), level)), _chunk(b'IEND', b'')]
    with open(path, 'wb') as f:
        f.write(b''.join(out))
