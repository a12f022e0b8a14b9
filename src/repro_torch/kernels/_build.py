"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``build/kernels/`` at the
repository root, named by a hash of the sources, the shared headers and the
flags, so an edited source is rebuilt and an unchanged one is reused.

Nothing is built at import: the first call of a kernel's wrapper builds it,
or :func:`build` builds several at once, one ``nvcc`` process each, all
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def source_key(name: str) -> str:
    """Hash of ``<name>.cu``, every shared ``*.cuh`` header and the flags."""
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_key(name)}.so"


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every library of ``names`` not yet built, in parallel. Returns
    name -> the compiler's report (registers, shared memory, spills; empty
    for a library that was already built). Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)           # atomic: a reader never sees half a file
        lib.with_suffix(".log").write_text(out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """C entry ``symbol`` of library ``name`` as a callable that raises on a
    CUDA error. The entry takes ``n_ptrs`` pointers, then ``n_ints`` ints,
    then the stream, and returns ``cudaGetLastError()`` after its launch (a
    refused launch never runs, and a later synchronize would not report it).
    Every pointer and the stream are declared ``c_void_p`` so that ctypes
    passes all 64 bits."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        lib = load(name)
        raw = getattr(lib, symbol)
        raw.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                        + [ctypes.c_void_p])
        raw.restype = ctypes.c_int
        lib.essr_error_string.argtypes = [ctypes.c_int]
        lib.essr_error_string.restype = ctypes.c_char_p

        def fn(*args):
            err = raw(*args)
            if err != 0:
                msg = lib.essr_error_string(err).decode()
                raise RuntimeError(f"{name}.{symbol}: CUDA error {err} ({msg}) at launch")

        _fns[key] = fn
    return fn
