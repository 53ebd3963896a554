'''
Builds the CUDA sources under csrc/ with nvcc into shared libraries with a plain C
interface, and loads them with ctypes. Nothing is built at import: the first CUDA call
builds (or reuses) `tcow_tpu_torch/_build/lib<name>-<hash>.so`, keyed by the source's
content hash, so an edited source is rebuilt and concurrent builds never clash.
'''

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3', '-shared',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v']


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


def load(name: str) -> ctypes.CDLL:
    '''Loads the library for csrc/<name>.cu, compiling it first if it is missing. The
    compiler's output (registers, shared memory, spills from -Xptxas -v) goes to
    <lib>.log.'''
    lib = lib_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f'{lib.name}.tmp{os.getpid()}')
        out = subprocess.run([nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lib.with_suffix('.log').write_text(out.stdout)
        if out.returncode != 0:
            raise RuntimeError(f'nvcc failed on {name}.cu (rc {out.returncode}):\n{out.stdout}')
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
