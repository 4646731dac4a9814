"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface, and loaded with ``ctypes``.
The build happens at first use, from the sources in the checkout only, into
``build/kernels/<hash>/`` at the root of the checkout (``.gitignore`` lists
it).  The hash covers every source and the compiler flags, so an edited
source rebuilds and an unchanged tree reuses its build.  ``build()`` starts
one ``nvcc`` per source, all at once.

Every C entry returns ``cudaGetLastError()`` after its launch, or a code of
its own that its ``*_error_string`` names; ``check`` turns a nonzero code
into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("event_join", "flash_attention", "flash_attention_sm90", "ssd_scan",
           "ssd_scan_sm90", "ssd_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: (name, restype, argtypes).  Every pointer and the stream are
# c_void_p, so ctypes never cuts them to 32 bits.
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "event_join": [
        ("event_join_scratch_ints", _L, [_L, _I, _I]),
        ("event_join_launch", _I, [_P, _L, _P, _P, _I, _P, _P, _I, _I, _P]),
        ("event_join_roundtrip", _I, [_P, _L, _I, _P, _P, _I, _I, _P]),
        ("event_join_error_string", ctypes.c_char_p, [_I]),
    ],
    "flash_attention": [
        ("flash_attention_launch", _I,
         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
          _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _F, _I, _P]),
        ("flash_attention_error_string", ctypes.c_char_p, [_I]),
    ],
    "flash_attention_sm90": [
        ("flash_attention_sm90_launch", _I,
         [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
          _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _F, _P]),
        ("flash_attention_sm90_error_string", ctypes.c_char_p, [_I]),
    ],
    "ssd_scan": [
        ("ssd_scan_launch", _I,
         [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
          _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, _P]),
        ("ssd_scan_error_string", ctypes.c_char_p, [_I]),
    ],
    "ssd_scan_sm90": [
        ("ssd_scan_sm90_launch", _I,
         [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
          _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _P]),
        ("ssd_scan_sm90_error_string", ctypes.c_char_p, [_I]),
    ],
    "ssd_step": [
        ("ssd_step_launch", _I,
         [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
          _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _P]),
        ("ssd_step_error_string", ctypes.c_char_p, [_I]),
    ],
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return CSRC.parents[2] / "build" / "kernels" / h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    exe = shutil.which("nvcc") or shutil.which("nvcc", path=os.path.join(home, "bin"))
    if exe is None:
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                           "CUDA kernels are built from csrc/ at first use")
    return exe


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile each named source that is not built yet, one ``nvcc`` process
    per source, all started together.  Returns ``{name: (seconds, compiler
    output)}`` for the sources it compiled (``-Xptxas -v``: registers, shared
    memory and spills per kernel)."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)

    def compile_one(name):
        tmp = out / f"lib{name}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            return name, seconds, proc.stdout, f"{' '.join(cmd)} exited {proc.returncode}"
        os.replace(tmp, out / f"lib{name}.so")  # atomic: a loader never sees half a file
        return name, seconds, proc.stdout, None

    todo = [name for name in names if not (out / f"lib{name}.so").exists()]
    with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
        results = list(pool.map(compile_one, todo))
    failed = [f"{err}:\n{log}" for _, _, log, err in results if err]
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: (seconds, log) for name, seconds, log, _ in results}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
            for fn, restype, argtypes in _SIGNATURES[name]:
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _libs[name] = lib
        return lib


def check(err: int, lib: ctypes.CDLL, name: str) -> None:
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
