'''
The port's PNG codec (tcow_tpu_torch/data/png.py) and its native row unfiltering
(tcow_tpu_torch/native.png_unfilter): round trips for every colour type and bit depth,
every filter type decoded against cv2.imread (the JAX loader's reader), files that cv2
writes (adaptive filters), the native unfiltering against its numpy oracle, and the
files it refuses.
'''

import struct
import zlib

import cv2
import numpy as np
import pytest

import conftest  # noqa: F401
from tcow_tpu_torch import native
from tcow_tpu_torch.data import png


def smooth_image(shape, dtype, seed):
    '''Random image with smooth regions and noise, so every filter has work to do.'''
    rng = np.random.default_rng(seed)
    top = 255 if dtype == np.uint8 else 65535
    H, W = shape[:2]
    ramp = np.add.outer(np.arange(H), np.arange(W)) * (top // (H + W))
    img = ramp.reshape(H, W, *([1] * (len(shape) - 2))) + rng.integers(0, top // 8, shape)
    return np.clip(img, 0, top).astype(dtype)


def bgr_to_rgb(img):
    if img.ndim == 3 and img.shape[-1] in (3, 4):
        return img[..., [2, 1, 0, 3][:img.shape[-1]]]
    return img


@pytest.mark.parametrize('channels,dtype', [
    (1, np.uint8), (1, np.uint16), (2, np.uint8), (2, np.uint16), (3, np.uint8),
    (3, np.uint16), (4, np.uint8), (4, np.uint16)])
@pytest.mark.parametrize('filter_type', [0, 1, 4])
def test_round_trip_every_colour_type_and_depth(tmp_path, channels, dtype, filter_type):
    shape = (13, 21) if channels == 1 else (13, 21, channels)
    img = smooth_image(shape, dtype, seed=channels)
    path = str(tmp_path / 'x.png')
    png.write_png(path, img, filter_type=filter_type)
    got = png.read_png(path)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


def test_round_trip_palette(tmp_path):
    rng = np.random.default_rng(1)
    palette = rng.integers(0, 256, (7, 3)).astype(np.uint8)
    idx = rng.integers(0, 7, (9, 14)).astype(np.uint8)
    path = str(tmp_path / 'p.png')
    png.write_png(path, idx, palette=palette, filter_type=2)
    np.testing.assert_array_equal(png.read_png(path), palette[idx])
    np.testing.assert_array_equal(bgr_to_rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED)),
                                  palette[idx])


@pytest.mark.parametrize('filter_type', [0, 1, 2, 3, 4])
@pytest.mark.parametrize('channels,dtype', [(4, np.uint8), (3, np.uint8), (1, np.uint8),
                                            (1, np.uint16)])
def test_each_filter_type_decodes_as_cv2(tmp_path, filter_type, channels, dtype):
    shape = (24, 31) if channels == 1 else (24, 31, channels)
    img = smooth_image(shape, dtype, seed=filter_type)
    path = str(tmp_path / 'f.png')
    png.write_png(path, img, filter_type=filter_type)
    want = bgr_to_rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED))
    got = png.read_png(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize('shape', [(40, 56, 4), (40, 56, 3), (40, 56)])
def test_files_cv2_writes_decode_as_cv2(tmp_path, shape):
    '''cv2 chooses a filter per row (adaptive), so one file mixes the types.'''
    img = smooth_image(shape, np.uint8, seed=5)
    path = str(tmp_path / 'c.png')
    cv2.imwrite(path, bgr_to_rgb(img), [cv2.IMWRITE_PNG_COMPRESSION, 1])
    np.testing.assert_array_equal(png.read_png(path),
                                  bgr_to_rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED)))


@pytest.mark.parametrize('bpp', [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_numpy(bpp):
    '''Random bytes under a random filter type per row: the native library's result is
    the numpy oracle's, byte for byte.'''
    rng = np.random.default_rng(bpp)
    height, row_bytes = 17, bpp * 23
    raw = rng.integers(0, 256, (height, row_bytes + 1)).astype(np.uint8)
    raw[:, 0] = rng.integers(0, 5, height)
    got = native.png_unfilter(raw.reshape(-1), height, row_bytes, bpp)
    want = png.unfilter_numpy(raw.reshape(-1), height, row_bytes, bpp)
    np.testing.assert_array_equal(got, want)


def test_numpy_path_reads_as_native(tmp_path, monkeypatch):
    img = smooth_image((20, 26, 4), np.uint8, seed=9)
    path = str(tmp_path / 'n.png')
    cv2.imwrite(path, bgr_to_rgb(img))
    want = png.read_png(path)
    monkeypatch.setenv('TCOW_NO_NATIVE', '1')
    assert not native.enabled()
    np.testing.assert_array_equal(png.read_png(path), want)


def raw_png(width, height, depth, ctype, interlace=0, rows=None, filter_byte=0,
            corrupt_crc=False):
    channels = png.CHANNELS.get(ctype, 1)
    row_bytes = max(1, width * channels * depth // 8)
    if rows is None:
        rows = np.zeros((height, row_bytes), np.uint8)
    body = np.concatenate([np.full((height, 1), filter_byte, np.uint8), rows], axis=1)
    chunks = [png._chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, depth, ctype,
                                              0, 0, interlace))]
    if ctype == 3:
        chunks.append(png._chunk(b'PLTE', bytes(range(12))))
    idat = png._chunk(b'IDAT', zlib.compress(body.tobytes()))
    if corrupt_crc:
        idat = idat[:-1] + bytes([idat[-1] ^ 1])
    return png.SIGNATURE + b''.join(chunks) + idat + png._chunk(b'IEND', b'')


@pytest.mark.parametrize('kind,match', [
    ('adam7', 'interlaced'), ('depth4', 'bit depth 4'), ('palette16', 'colour type 3'),
    ('ctype5', 'colour type 5'), ('filter7', 'filter type 7'), ('crc', 'CRC'),
    ('not_png', 'not a PNG')])
def test_unsupported_files_raise_naming_the_path(tmp_path, kind, match):
    data = {
        'adam7': lambda: raw_png(8, 8, 8, 2, interlace=1),
        'depth4': lambda: raw_png(8, 8, 4, 0),
        'palette16': lambda: raw_png(8, 8, 16, 3),
        'ctype5': lambda: raw_png(8, 8, 8, 5),
        'filter7': lambda: raw_png(8, 4, 8, 0, filter_byte=7),
        'crc': lambda: raw_png(8, 4, 8, 0, corrupt_crc=True),
        'not_png': lambda: b'GIF89a' + bytes(40),
    }[kind]()
    path = tmp_path / f'{kind}.png'
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match) as err:
        png.read_png(str(path))
    assert str(path) in str(err.value)
