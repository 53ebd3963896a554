'''
Native (C++) host-preprocessing kernels of the Kubric data path, loaded with ctypes: the
port's copy of tcow_tpu/native/__init__.py (:24-179) plus `png_unfilter`.

The library is built with g++ at first use into tcow_tpu_torch/_build/, named by the hash
of its source and flags (as ops/_build.py names the CUDA libraries), so an edited source
is rebuilt and concurrent builds never clash. A failed build raises: nothing falls back
quietly. Only TCOW_NO_NATIVE=1 selects the numpy versions (`enabled()` is then False),
which the tests use as the oracle.
'''

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / 'preprocess.cpp'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
GXX_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']
# scene_overlap_stats packs the visible id into 7 bits beside a 57-bit instance mask.
MAX_STATS_K = 57
_lock = threading.Lock()
_lib = None


def enabled() -> bool:
    '''False only when TCOW_NO_NATIVE=1 asks for the numpy versions.'''
    return os.environ.get('TCOW_NO_NATIVE', '') != '1'


def lib_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + ' '.join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'libtcow_preprocess-{digest}.so'


def _build(lib: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f'{lib.name}.tmp{os.getpid()}')
    out = subprocess.run(['g++', *GXX_FLAGS, str(SRC), '-o', str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f'g++ failed on {SRC} (rc {out.returncode}):\n{out.stderr}')
    os.replace(tmp, lib)


def get_lib() -> ctypes.CDLL:
    '''The loaded library, built first if missing. Raises when the build fails or when
    TCOW_NO_NATIVE=1 (callers test `enabled()` first).'''
    global _lib
    if _lib is not None:
        return _lib
    if not enabled():
        raise RuntimeError('native preprocessing is disabled by TCOW_NO_NATIVE=1')
    with _lock:
        if _lib is not None:
            return _lib
        lib_fp = lib_path()
        if not lib_fp.exists():
            _build(lib_fp)
        lib = ctypes.CDLL(str(lib_fp))
        i64 = ctypes.c_int64
        p = ctypes.POINTER
        lib.scene_overlap_stats.restype = ctypes.c_int
        lib.scene_overlap_stats.argtypes = [
            p(ctypes.c_int32), p(ctypes.c_uint8), i64, i64, i64, i64,
            p(ctypes.c_int64), p(ctypes.c_int64), p(ctypes.c_int64), p(ctypes.c_int64)]
        lib.paint_recon_segm.restype = None
        lib.paint_recon_segm.argtypes = [
            p(ctypes.c_uint8), p(ctypes.c_int32), i64, i64, i64, i64, p(ctypes.c_int32)]
        lib.gather_div_bits.restype = None
        lib.gather_div_bits.argtypes = [
            p(ctypes.c_uint8), i64, i64, i64, i64, i64,
            p(i64), p(i64), p(i64), i64, i64, i64,
            p(ctypes.c_uint8), p(ctypes.c_uint8), p(ctypes.c_uint8), p(i64)]
        lib.gather_segm_i16.restype = None
        lib.gather_segm_i16.argtypes = [
            p(ctypes.c_int16), i64, i64, i64,
            p(i64), p(i64), p(i64), i64, i64, i64, p(ctypes.c_int32)]
        lib.png_unfilter.restype = i64
        lib.png_unfilter.argtypes = [p(ctypes.c_uint8), i64, i64, i64, p(ctypes.c_uint8)]
        _lib = lib
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def scene_overlap_stats(segm: np.ndarray, div: np.ndarray):
    '''(T,H,W) int32 segm + (T,H,W,K) uint8 div ->
    (vis_cnt (T,K), tot_cnt (T,K), dd (T,K,K), dv (T,K,K)) int64. K <= MAX_STATS_K.'''
    lib = get_lib()
    T, H, W, K = div.shape
    if not 1 <= K <= MAX_STATS_K:
        raise ValueError(f'scene_overlap_stats takes 1 <= K <= {MAX_STATS_K}, got {K}')
    segm = np.ascontiguousarray(segm, np.int32)
    div = np.ascontiguousarray(div, np.uint8)
    vis = np.zeros((T, K), np.int64)
    tot = np.zeros((T, K), np.int64)
    dd = np.zeros((T, K, K), np.int64)
    dv = np.zeros((T, K, K), np.int64)
    rc = lib.scene_overlap_stats(
        _ptr(segm, ctypes.c_int32), _ptr(div, ctypes.c_uint8), T, H, W, K,
        _ptr(vis, ctypes.c_int64), _ptr(tot, ctypes.c_int64),
        _ptr(dd, ctypes.c_int64), _ptr(dv, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f'scene_overlap_stats failed (rc {rc}) at K={K}')
    return vis, tot, dd, dv


def gather_div_bits(packed: np.ndarray, K: int, t_map: np.ndarray, y_map: np.ndarray,
                    x_map: np.ndarray, want_kthw: bool = True, want_thwk: bool = False,
                    want_packw: bool = False, want_delta: bool = False):
    '''Fused frame-select/flip/crop/nearest-resize gather over bit-packed amodal masks.

    :param packed (Tv, H, W, KB) uint8: np.packbits(div, axis=-1) of the (Tv,H,W,K) masks.
    :param t_map/y_map/x_map int64 index maps (len Tc/h/w) composing the augmentation.
    :return (kthw (K,Tc,h,w) u8 | None, thwk (Tc,h,w,K) u8 | None,
             packw (K,Tc,h,w//8) u8 | None, delta (K,Tc) i64 | None) per the want_*
             flags. delta[:, t] counts pixels differing between consecutive output frames
             (column 0 = 0); requires want_kthw.
    '''
    lib = get_lib()
    Tv, H, W, KB = packed.shape
    if K > KB * 8:
        raise ValueError(f'K={K} exceeds the {KB * 8} packed bits')
    if want_delta and not want_kthw:
        raise ValueError('want_delta requires want_kthw')
    Tc, h, w = len(t_map), len(y_map), len(x_map)
    for m, n in ((t_map, Tv), (y_map, H), (x_map, W)):
        if len(m) and (m.min() < 0 or m.max() >= n):
            raise IndexError(f'index map out of range [0, {n})')
    packed = np.ascontiguousarray(packed, np.uint8)
    t_map = np.ascontiguousarray(t_map, np.int64)
    y_map = np.ascontiguousarray(y_map, np.int64)
    x_map = np.ascontiguousarray(x_map, np.int64)
    kthw = np.empty((K, Tc, h, w), np.uint8) if want_kthw else None
    thwk = np.empty((Tc, h, w, K), np.uint8) if want_thwk else None
    packw = None
    if want_packw:
        if w % 8:
            raise ValueError(f'want_packw needs a width divisible by 8, got {w}')
        packw = np.zeros((K, Tc, h, w // 8), np.uint8)  # kernel ORs set bits in
    delta = np.zeros((K, Tc), np.int64) if want_delta else None
    null = ctypes.POINTER(ctypes.c_uint8)()
    lib.gather_div_bits(
        _ptr(packed, ctypes.c_uint8), Tv, H, W, KB, K,
        _ptr(t_map, ctypes.c_int64), _ptr(y_map, ctypes.c_int64),
        _ptr(x_map, ctypes.c_int64), Tc, h, w,
        _ptr(kthw, ctypes.c_uint8) if kthw is not None else null,
        _ptr(thwk, ctypes.c_uint8) if thwk is not None else null,
        _ptr(packw, ctypes.c_uint8) if packw is not None else null,
        _ptr(delta, ctypes.c_int64) if delta is not None
        else ctypes.POINTER(ctypes.c_int64)())
    return kthw, thwk, packw, delta


def gather_segm_i16(segm: np.ndarray, t_map: np.ndarray, y_map: np.ndarray,
                    x_map: np.ndarray) -> np.ndarray:
    '''(Tv,H,W) int16 visible-id map -> (Tc,h,w) int32 via the composed index maps.'''
    lib = get_lib()
    Tv, H, W = segm.shape
    for m, n in ((t_map, Tv), (y_map, H), (x_map, W)):
        if len(m) and (np.min(m) < 0 or np.max(m) >= n):
            raise IndexError(f'index map out of range [0, {n})')
    segm = np.ascontiguousarray(segm, np.int16)
    t_map = np.ascontiguousarray(t_map, np.int64)
    y_map = np.ascontiguousarray(y_map, np.int64)
    x_map = np.ascontiguousarray(x_map, np.int64)
    out = np.empty((len(t_map), len(y_map), len(x_map)), np.int32)
    lib.gather_segm_i16(_ptr(segm, ctypes.c_int16), Tv, H, W,
                        _ptr(t_map, ctypes.c_int64), _ptr(y_map, ctypes.c_int64),
                        _ptr(x_map, ctypes.c_int64),
                        out.shape[0], out.shape[1], out.shape[2],
                        _ptr(out, ctypes.c_int32))
    return out


def paint_recon_segm(div: np.ndarray, order: np.ndarray) -> np.ndarray:
    '''(T,H,W,K) uint8 div + (T,K) int32 back-to-front order -> (T,H,W) int32.'''
    lib = get_lib()
    T, H, W, K = div.shape
    order = np.ascontiguousarray(order, np.int32)
    if order.shape != (T, K) or (K and (order.min() < 0 or order.max() >= K)):
        raise ValueError(f'order must be (T, K) = ({T}, {K}) indices in [0, K)')
    div = np.ascontiguousarray(div, np.uint8)
    recon = np.zeros((T, H, W), np.int32)
    lib.paint_recon_segm(_ptr(div, ctypes.c_uint8), _ptr(order, ctypes.c_int32),
                         T, H, W, K, _ptr(recon, ctypes.c_int32))
    return recon


def png_unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    '''The decompressed IDAT stream (height rows of a filter byte + row_bytes) ->
    (height, row_bytes) uint8 unfiltered rows. Raises ValueError on an unknown filter
    type.'''
    lib = get_lib()
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f'IDAT holds {raw.size} bytes, expected '
                         f'{height} x (1 + {row_bytes})')
    out = np.empty((height, row_bytes), np.uint8)
    rc = lib.png_unfilter(_ptr(raw, ctypes.c_uint8), height, row_bytes, max(int(bpp), 1),
                          _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f'unknown PNG filter type {raw[(rc - 1) * (row_bytes + 1)]} '
                         f'in row {rc - 1}')
    return out
