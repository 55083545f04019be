"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(``extern "C"`` launchers that take raw pointers, sizes and a stream), built
by ``nvcc`` for ``sm_90a``. All sources are compiled at once, one ``nvcc``
process each, into ``.cache/torch_ext/<hash>/`` at the checkout root (or
``$REPRO_TORCH_EXT_DIR``), where the hash covers the sources and the flags, so
an edit rebuilds and an unchanged tree reuses the libraries. ``nvcc``'s output
(``-Xptxas -v``: each kernel's registers, shared memory and spills) is kept
beside each library as ``lib<name>.log``; ``ptxas_info`` reads it. Nothing
here runs at import time: the CPU path never reaches this module's build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("fwht", "srht_fused", "flash_attention", "flash_attention_tc")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-lineinfo", "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of every launcher; each returns a cudaError_t (0 on success)
SIGNATURES = {
    "fwht": {
        "fwht_f32": (_P, _P, _P, _P, _LL, _I, _I, _F, _P),
        "fwht_bf16": (_P, _P, _P, _P, _LL, _I, _I, _F, _P),
    },
    "srht_fused": {
        "fwht_rowsigns_f32": (_P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P),
        "srht_decode_sum_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        "srht_gram_apply_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        "srht_cg_step_f32": (_P,) * 10 + (_I,) * 8 + (_F, _P),
    },
    "flash_attention": {
        "flash_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    },
    "flash_attention_tc": {
        "flash_attention_bf16_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "flash_attention_bf16_wgmma_smem": (_I,),  # -> bytes, not an error code
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "repro_torch cannot be built"
    )


def _cache_root() -> str:
    env = os.environ.get("REPRO_TORCH_EXT_DIR")
    if env:
        return env
    return os.path.join(_CSRC, "..", "..", "..", "..", ".cache", "torch_ext")


def _out_dir() -> str:
    return os.path.abspath(os.path.join(_cache_root(), _source_hash()))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; -> name -> CDLL.

    Raises RuntimeError with the compiler's output when a build fails."""
    with _LOCK:
        if len(_LIBS) == len(SOURCES):
            return _LIBS
        out_dir = _out_dir()
        os.makedirs(out_dir, exist_ok=True)
        procs = {}
        for name in SOURCES:
            so = os.path.join(out_dir, f"lib{name}.so")
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, so)
        failures = []
        for name, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            else:
                with open(os.path.join(out_dir, f"lib{name}.log"), "w") as f:
                    f.write(log)
                os.replace(tmp, so)
        if failures:
            raise RuntimeError("building the repro_torch CUDA kernels failed:\n"
                               + "\n".join(failures))
        for name in SOURCES:
            lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.error_string.argtypes = (ctypes.c_int,)
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS


def ptxas_info(source: str) -> str:
    """``-Xptxas -v``'s lines for ``source``'s kernels from the last build:
    registers, shared memory, stack and spills of each entry function."""
    build()
    with open(os.path.join(_out_dir(), f"lib{source}.log")) as f:
        return "".join(line for line in f if "ptxas" in line or "spill" in line)


def launch(source: str, fn: str, *args) -> None:
    """Call launcher ``fn`` of ``source``'s library; raise on a CUDA error."""
    lib = build()[source]
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {fn} failed to launch: {lib.error_string(err).decode()} ({err})"
        )
