"""Build the hand-written CUDA kernels and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a``
(all started together), then linked into ONE shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), at first use,
into ``_build/`` inside the package.  The file name carries a hash of the
sources and flags: a changed source rebuilds, an unchanged one loads the
existing build.  Each C entry point takes raw device pointers and the CUDA
stream as ``void*``, launches on that stream and returns the launch's
``cudaError_t``; ``launch`` raises on nonzero.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: argument types of every C entry point (the stream, last, is added)
SIGNATURES = {
    "sdr_mono_mix": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I,
                     _I, _I, _P, _I, _I, _I],
    "sdr_mono_stage": [_P, _I, _I, _P, _I, _P, _I, _I, _I, _P, _I, _I, _I,
                       _P, _I, _I, _I, _I],
    "sdr_wfm_quad_halfband": [_P, _I, _I, _I, _I, _P, _F, _P, _I, _P, _I,
                              _P, _I, _I, _P, _P, _P, _I, _I, _I],
    "sdr_wfm_halfband": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _I, _P, _I,
                         _I, _I],
    "sdr_wfm_stereo": [_P, _P, _I, _I, _I, _I, _P, _P, _F, _F, _P, _I, _P,
                       _I, _I, _I, _I],
    "sdr_mpx_poly": [_P, _I, _P, _I, _I, _P, _I, _I, _I, _P, _I, _I,
                     _I, _I, _I, _I],
    "sdr_fft_frames": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                       _I, _P, _F, _P],
    "sdr_fft_cols": [_P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _P, _P, _P],
    "sdr_fft_rows": [_P, _I, _I, _I, _I, _P, _F, _P],
    "sdr_pfb_bins": [_P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                     _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "sdr_pfb_big": [_P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P,
                    _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sdr_chan_post_d2": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                         _I, _P, _I, _P, _I, _P, _I, _I, _I, _I],
    "sdr_chan_post_fir": [_P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _I, _I, _P,
                          _I, _I, _I, _I, _I],
    "sdr_fm_audio_fir": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _F, _P, _I, _P,
                         _P, _I, _P, _I, _I, _I, _I],
    "sdr_fm_audio_poly": [_P, _I, _P, _I, _P, _I, _I, _I, _P, _I, _I, _I, _P,
                          _I, _I, _I, _I, _I, _I],
    "sdr_fir_rows": [_P, _I, _P, _I, _P, _I, _I, _I, _P, _I, _P, _I, _I,
                     _I, _I, _I, _I],
    "sdr_fir_cplx": [_P, _I, _P, _I, _P, _I, _I, _P, _I, _P, _I, _I, _I,
                     _I],
    "sdr_fused_mix": [_P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I,
                      _P, _I, _I, _I],
    "sdr_agc_rows": [_P, _I, _I, _P, _P, _I, _F, _F, _F, _F, _F, _F, _I,
                     _P, _P, _P, _P],
    "sdr_agc_cplx_rows": [_P, _I, _I, _P, _P, _I, _F, _F, _F, _F, _F, _F,
                          _I, _P, _P, _P, _P],
    "sdr_pll_rows": [_P, _I, _I, _P, _P, _F, _F, _F, _F, _P, _P, _P, _P],
    "sdr_costas_rows": [_P, _I, _I, _I, _P, _P, _F, _F, _F, _F, _F, _P, _P,
                        _P, _P],
    "sdr_costas_rotor": [_P, _I, _P],
    "sdr_costas_nearest_rows": [_P, _I, _I, _P, _P, _F, _F, _F, _F, _F, _F,
                                _F, _F, _P, _P, _P, _P],
    "sdr_logmmse_frames": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P, _P,
                           _P],
    "sdr_linear_recurrence": [_P, _F, _F, _P, _F, _P, _P, _I, _I, _I, _I,
                              _P, _P],
    "sdr_mm_rows": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                    _F, _F, _P, _P, _P, _P, _P, _P],
    "sdr_fd_rows": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                    _F, _F, _P, _P, _P, _P, _P, _P, _P],
    "sdr_viterbi_rows": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
}

#: what the last build did (for chip_smoke.py's report)
BUILD_INFO: dict = {}
_LIB: list = []
# build() names its objects by the process id: a second thread's first
# launch waits for the first's build instead of compiling over it
_LIB_LOCK = threading.Lock()


def _sources():
    return sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if CUDA_HOME and os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or under CUDA_HOME")


def build() -> str:
    """Path of the kernel library, compiling it first if needed."""
    so = os.path.join(BUILD_DIR, f"libsdrkernels_{source_digest()}.so")
    if os.path.exists(so):
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("cached", True)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so[:-3]}.{os.getpid()}"
    units = [f for f in _sources() if f.endswith(".cu")]
    objs = [f"{tag}.{u[:-3]}.o" for u in units]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o,
                               os.path.join(CSRC, u)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for u, o in zip(units, objs)]
    logs, failed = [], []
    for u, p in zip(units, procs):
        out, _ = p.communicate()
        logs.append(f"== {u}\n{out}")
        if p.returncode != 0:
            failed.append(u)
    res = None
    if not failed:
        res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                              "-shared", "-o", f"{tag}.tmp", *objs],
                             capture_output=True, text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    log = "".join(logs)
    with open(so[:-3] + ".log", "w") as fh:
        fh.write(log)
    if failed or res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({failed or 'link'}):\n"
                           f"{log[-6000:]}")
    os.replace(f"{tag}.tmp", so)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      log=log)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    if not _LIB:
        with _LIB_LOCK:
            if not _LIB:
                so = ctypes.CDLL(build())
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(so, name)
                    fn.argtypes = argtypes + [_P]
                    fn.restype = ctypes.c_int
                so.sdr_error_string.argtypes = [ctypes.c_int]
                so.sdr_error_string.restype = ctypes.c_char_p
                _LIB.append(so)
    return _LIB[0]


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream and
    raise if the launch was refused."""
    so = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(so, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({so.sdr_error_string(rc).decode()})")
    _LAUNCHED[0] += 1


def chain_clock(clk, rows: int, device, slots: int = 1) -> int | None:
    """The ``clk`` argument of a sequential kernel (K12, K13, K16): None
    (the served path: the kernel reads no clock), or an int64 [rows, 2 ·
    slots] CUDA tensor that the kernel fills with its chains' SM cycles
    and nanoseconds a row, a pair a chain (csrc/common.cuh:ChainClock;
    K16 has two: its trellis and its traceback)."""
    if clk is None:
        return None
    return check(clk, "chain clock", torch.int64, (rows, 2 * slots), device)


def check(t: torch.Tensor, what: str, dtype, shape=None, device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` / ``device`` where given); returns its data pointer."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    return t.data_ptr()


#: launches ``launch`` made (for ``counted_launches``)
_LAUNCHED = [0]


def counted(fn):
    """Give a kernel wrapper a plain integer ``launches``: one per call
    that launched its kernel (a call that raises counts nothing)."""
    @functools.wraps(fn)
    def wrapper(*args):
        out = fn(*args)
        wrapper.launches += 1
        return out
    wrapper.launches = 0
    return wrapper


def counted_launches(fn):
    """``counted`` for a wrapper whose kernel is more than one launch:
    ``launches`` counts each CUDA launch (``launch``) a call made."""
    @functools.wraps(fn)
    def wrapper(*args):
        n0 = _LAUNCHED[0]
        out = fn(*args)
        wrapper.launches += _LAUNCHED[0] - n0
        return out
    wrapper.launches = 0
    return wrapper
