"""Build and bind the CUDA kernels under ``tmae_tpu_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. Builds go to
``tmae_tpu_torch/_build`` (listed in ``.gitignore``), named by a hash of the
source and flags, so a changed source is rebuilt and an unchanged one is
reused. ``build_all`` starts one ``nvcc`` per source, all at once.

Every exported launcher returns the ``cudaError_t`` of its launch
(``cudaGetLastError`` right after it); ``CudaKernel`` raises when that is not
0 and otherwise adds one to its launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / '_build'
SOURCES = ('windows.cu', 'encoder_layer_tiled.cu', 'encoder_layer_bwd.cu',
           'encoder_layer_narrow.cu', 'segment_max.cu', 'subm_conv.cu',
           'iou_nms.cu', 'pointnet2.cu')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
# iou_nms.cu and pointnet2.cu repeat their plain versions' roundings: no
# contraction of a product and a sum into one fused multiply-add
SOURCE_FLAGS = {'iou_nms.cu': ('-fmad=false',),
                'pointnet2.cu': ('-fmad=false',)}


def _flags(source: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _target(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha256()
    for part in sorted(CSRC.glob('*.cuh')) + [src]:
        h.update(part.read_bytes())
    h.update(' '.join(_flags(source)).encode())
    return BUILD_DIR / f'{src.stem}-{h.hexdigest()[:16]}.so'


def build_all(sources=SOURCES) -> dict[str, dict]:
    """Compile every source whose library is missing, in parallel. Returns
    ``{source: {'seconds': s, 'log': ptxas output}}`` for what it built."""
    BUILD_DIR.mkdir(exist_ok=True)
    started = {}
    for name in sources:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp.so')
        cmd = [_nvcc(), *_flags(name), '-o', str(tmp), str(CSRC / name)]
        started[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    built = {}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc failed for {name}:\n{log}')
            continue
        os.replace(tmp, out)
        built[name] = {'seconds': time.perf_counter() - t0, 'log': log}
    if failed:
        raise RuntimeError('\n'.join(failed))
    return built


def build_file(src: Path, flags_of: str, tag: str, extra=()) -> Path:
    """Compile a ``.cu`` file from anywhere (another checkout's version of
    a source) with the flags of ``flags_of`` and ``extra`` into ``_build``,
    named by ``tag`` and a hash of the file, its directory's headers and
    the flags; reused when present. Raises with nvcc's output on
    failure."""
    src = Path(src)
    flags = [*_flags(flags_of), *extra]
    h = hashlib.sha256()
    for part in sorted(src.parent.glob('*.cuh')) + [src]:
        h.update(part.read_bytes())
    h.update(' '.join(flags).encode())
    out = BUILD_DIR / f'{src.stem}-{tag}-{h.hexdigest()[:16]}.so'
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f'{out.stem}.{os.getpid()}.tmp.so')
        proc = subprocess.run([_nvcc(), *flags, '-o', str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for {src}:\n{proc.stdout}'
                               f'{proc.stderr}')
        os.replace(tmp, out)
    return out


def library(source: str) -> ctypes.CDLL:
    with _lock:
        if source not in _libs:
            build_all((source,))
            _libs[source] = ctypes.CDLL(str(_target(source)))
        return _libs[source]


class CudaKernel:
    """One exported launcher of a ``csrc`` library, with its launch count
    (``path``: a library built elsewhere, in place of ``source``'s)."""

    def __init__(self, source: str, symbol: str, argtypes, path=None):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.path = path
        self.launches = 0
        self._fn = None
        self._err = None

    def _bind(self):
        lib = (ctypes.CDLL(str(self.path)) if self.path
               else library(self.source))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.tmae_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def __call__(self, *args):
        if self._fn is None:
            self._bind()
        code = self._fn(*args)
        if code != 0:
            raise RuntimeError(
                f'{self.symbol}: CUDA error {code} '
                f'({self._err(code).decode()})')
        self.launches += 1


def stream_handle() -> int:
    """The current CUDA stream of the current device as an int, as
    ``torch.cuda.current_stream().cuda_stream`` gives it, through torch's
    raw C accessors: no Stream object (7.6 us against 0.7 on the H100's
    host), which a wrapper pays on every call."""
    import torch

    c = torch._C
    return c._cuda_getCurrentRawStream(c._cuda_getDevice())
