"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled to an object by its own ``nvcc`` process,
all started together, and the objects are linked by one more into one
shared library with a plain C interface (``csrc/sanm_kernels.h``), at
first use, into ``sanm_tpu_torch/_build/`` (gitignored).  The library's name
carries a hash of the sources and flags, so it is rebuilt only when they
change.  It is loaded with ctypes; no source includes PyTorch's headers.

Nothing here runs at import: this module, like every module of the
package, must import on a machine without ``nvcc`` or a card.  A failing
build raises with ``nvcc``'s stderr; there is no fallback.

Launch counts: each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel on the card, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from .utils import SANMError

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = NVCC_ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                          "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 300
#: the block size s of the Cholesky kernels (K5-K7, ``kBlock`` of
#: ``csrc/chol_blocks.h``): one s x s f64 block (128 KB) fits one CTA's
#: shared memory.  Their plans take other sizes only on the CPU.
BLOCK = 128

LAUNCHES = {"remap_in": 0, "remap_out": 0, "jac_asm": 0, "nhc_step": 0,
            "element_matvec": 0, "band_assemble": 0, "band_factor": 0,
            "band_solve": 0, "svd_w": 0, "arap_step": 0, "jac_asm_arap": 0,
            "nhi_step": 0, "jac_asm_nhi": 0, "grad_t": 0,
            "inv_nhc_step": 0, "inv_nhi_step": 0, "jac_asm_inv": 0,
            "jac_asm_inv_nhi": 0, "dense_factor": 0, "dense_solve": 0,
            "spike_rhs_solve": 0, "spike_solve": 0, "hess_proj": 0,
            "hess_proj_nhi": 0, "hess_proj_arap": 0, "csr_matvec": 0,
            "csr_matvec_t": 0, "diag_blocks": 0, "pcg_step": 0}

_lock = threading.Lock()
_lib = None
BUILD_INFO = {}  # seconds, path, ptxas report of the build in this process

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F64 = ctypes.c_double
_SIGNATURES = {
    # name: argtypes (every pointer and the stream are c_void_p)
    "sanm_remap_in": [_P, _P, _P, _P, _I64, _I32, _I32, _P],
    "sanm_remap_out": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _P],
    "sanm_jac_asm": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32,
                     _I64, _F64, _F64, _P],
    "sanm_nhc_step": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _F64, _F64,
                      _I32, _P],
    "sanm_element_matvec": [_P] * 7 + [_I64, _I64, _I64, _I32, _I32, _P],
    "sanm_band_assemble": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                           _I64, _I64, _P],
    "sanm_band_factor": [_P, _P, _P, _P, _I64, _I64, _P],
    "sanm_band_solve": [_P] * 10 + [_I64, _I64, _P],
    "sanm_svd_w": [_P, _P, _P, _P, _I64, _P],
    "sanm_arap_step": [_P, _P, _P, _P, _I64, _I32, _I32, _F64, _I32, _P],
    "sanm_jac_asm_arap": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32,
                          _I32, _I64, _F64, _P],
    "sanm_nhi_step": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _F64, _F64,
                      _I32, _P],
    "sanm_jac_asm_nhi": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32,
                         _I32, _I64, _F64, _F64, _P],
    "sanm_grad_t": [_P, _P, _P, _P, _I64, _P],
    "sanm_inv_nhc_step": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _F64, _F64,
                          _I32, _P],
    "sanm_inv_nhi_step": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _F64, _F64,
                          _I32, _P],
    "sanm_jac_asm_inv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32,
                         _I32, _I64, _F64, _F64, _P],
    "sanm_jac_asm_inv_nhi": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32,
                             _I32, _I64, _F64, _F64, _P],
    "sanm_dense_factor": [_P, _P, _P, _I64, _P],
    "sanm_dense_solve": [_P, _P, _P, _P, _P, _P, _I64, _I64, _P],
    "sanm_spike_rhs_solve": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                             _P],
    "sanm_spike_solve": [_P] * 19 + [_I64, _I64, _I64, _I64, _P],
    "sanm_hess_proj": [_P] * 9 + [_I64, _I32, _I32, _I64, _F64, _F64, _P],
    "sanm_hess_proj_nhi": [_P] * 9 + [_I64, _I32, _I32, _I64, _F64, _F64,
                                      _P],
    "sanm_hess_proj_arap": [_P] * 10 + [_I64, _I32, _I32, _I64, _F64, _P],
    "sanm_csr_matvec": [_P] * 6 + [_I64, _P],
    "sanm_diag_blocks": [_P, _P, _P, _I64, _I64, _P],
    "sanm_pcg_step": [_P] * 15 + [_I64] * 4 + [_F64, _F64, _P],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    names = sorted(os.listdir(SRC_DIR))
    cu = [os.path.join(SRC_DIR, f) for f in names if f.endswith(".cu")]
    hdr = [os.path.join(SRC_DIR, f) for f in names if f.endswith(".h")]
    return cu, hdr


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise SANMError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build():
    """Compile the library if its hashed file is missing; return its path."""
    cu, hdr = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + hdr:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, "libsanm_kernels_%s.so" % h.hexdigest()[:16])
    if os.path.exists(so):
        BUILD_INFO.update(path=so, seconds=0.0, cached=True, report="")
        return so
    nvcc = _find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d" % (so, os.getpid())
    objs = ["%s.%s.o" % (tmp, os.path.basename(p)) for p in cu]
    t0 = time.perf_counter()
    procs = []
    try:
        for path, obj in zip(cu, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-I", SRC_DIR, "-c", "-o", obj, path]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        report = []
        for cmd, proc in procs:
            left = NVCC_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                _, err = proc.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired as e:
                raise SANMError("nvcc timed out after %ds"
                                % NVCC_TIMEOUT_S) from e
            if proc.returncode != 0:
                raise SANMError("nvcc failed (exit %d): %s\n%s"
                                % (proc.returncode, " ".join(cmd), err))
            report.append(err)
        cmd = [nvcc, *NVCC_ARCH, "-shared", "-o", tmp + ".tmp", *objs]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise SANMError("nvcc timed out after %ds"
                            % NVCC_TIMEOUT_S) from e
        if res.returncode != 0:
            raise SANMError("nvcc failed (exit %d): %s\n%s"
                            % (res.returncode, " ".join(cmd), res.stderr))
        os.replace(tmp + ".tmp", so)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    BUILD_INFO.update(path=so, seconds=time.perf_counter() - t0,
                      cached=False, report="".join(report))
    return so


def library():
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sanm_error_string.argtypes = [ctypes.c_int]
            lib.sanm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(counter: str, fn_name: str, *args):
    """Call one C entry point on the current stream, raise on a launch
    error, and count the launch."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise SANMError("%s launch failed: CUDA error %d (%s)"
                        % (fn_name, err,
                           lib.sanm_error_string(err).decode()))
    LAUNCHES[counter] += 1


def check_spin(word, fn_name: str):
    """Raise if the error word of a kernel whose CTAs wait on each other
    (a 0-d int32 tensor on the card) is non-zero: a wait exceeded its
    timeout and the kernel returned without its result.  Reading the word
    synchronises the host with the card, except while the current stream
    is captured into a CUDA graph, where nothing can be read (the word
    stays set for a later read)."""
    if torch.cuda.is_current_stream_capturing():
        return
    if int(word):
        raise SANMError("%s: a wait on another CTA's result timed out; the "
                        "result is invalid" % fn_name)


def on_card(*tensors) -> bool:
    """True when every tensor lies on the card, False when every one lies
    on the CPU; raises for anything else (mixed or other devices)."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        devs = {t.device for t in tensors}
        if len(devs) != 1:
            raise SANMError("tensors on several cards: %s" % devs)
        return True
    if types == {"cpu"}:
        return False
    raise SANMError("unsupported device mix %s" % sorted(types))


def check_block(s):
    """Raise unless ``s`` is the block size the Cholesky kernels take."""
    if s != BLOCK:
        raise SANMError("the Cholesky kernels take the block size %d, not %d"
                        % (BLOCK, s))


def check(t, name, shape, dtype):
    """Raise unless ``t`` has this shape and dtype and is contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise SANMError("%s: shape %s, expected %s"
                        % (name, tuple(t.shape), tuple(shape)))
    if t.dtype != dtype:
        raise SANMError("%s: dtype %s, expected %s" % (name, t.dtype, dtype))
    if not t.is_contiguous():
        raise SANMError("%s: not contiguous" % name)
