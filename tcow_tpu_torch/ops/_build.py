'''
Builds the CUDA sources under csrc/ with nvcc into shared libraries with a plain C
interface, and loads them with ctypes. Nothing is built at import: the first CUDA call
builds (or reuses) `tcow_tpu_torch/_build/lib<name>-<hash>.so` for every source at once,
one nvcc process each, all started together; each library is keyed by its source's
content hash, so an edited source is rebuilt and concurrent builds never clash.
'''

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
# The quicker build first, so that each wait's time is its own source's.
SOURCES = ('gemm_sm90', 'fused_attention')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# Seconds each source's nvcc took in this process (absent: the library was already built).
build_seconds = {}


def nvcc_path() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and os.path.isfile(os.path.join(cand, 'bin', 'nvcc')):
            return os.path.join(cand, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH)')
    return found


def lib_path(name: str) -> Path:
    '''The library built from csrc/<name>.cu, named by the hash of the source and flags.'''
    digest = hashlib.sha1((CSRC / f'{name}.cu').read_bytes()
                          + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build_all():
    '''Compiles every source of SOURCES whose library is missing, one nvcc each, started
    together. The compiler's output (registers, shared memory, spills from -Xptxas -v) goes
    to <lib>.log; the seconds from the start to the end of each wait to build_seconds (for
    a source waited on after a slower one, the slower one's time).'''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in SOURCES:
        lib = lib_path(name)
        if not lib.exists():
            tmp = lib.with_name(f'{lib.name}.tmp{os.getpid()}')
            with open(lib.with_suffix('.log'), 'w') as log:
                jobs.append((name, lib, tmp, subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
                    stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, proc in jobs:
        proc.wait()
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f'nvcc failed on {name}.cu (rc {proc.returncode}):\n'
                          + lib.with_suffix('.log').read_text())
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError('\n'.join(failed))


def load(name: str) -> ctypes.CDLL:
    '''Loads the library for csrc/<name>.cu, building every missing library first.'''
    lib = lib_path(name)
    if not lib.exists():
        build_all()
    return ctypes.CDLL(str(lib))
