"""Build the CUDA kernels from the package's sources and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
That keeps PyTorch's headers out of the build (seconds per file instead
of minutes).  The builds of all sources start together, one ``nvcc``
each, at the first CUDA call (or :func:`build_all`), never at import.

The libraries go to ``build/torch_ext/`` at the root of the checkout
(``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the sources,
the flags and the compiler, so an edited source never loads a stale
library.  ``REPRO_TORCH_NVCC_VERBOSE=1`` prints ``ptxas``'s register and
shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("hdc_encoder", "fused_profile", "hamming_am", "am_matmul",
           "threefry", "species_max")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parent.parent.parent / "build" / "torch_ext"


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def _flags() -> list[str]:
    flags = list(FLAGS)
    if os.environ.get("REPRO_TORCH_NVCC_VERBOSE"):
        flags.append("-Xptxas=-v")
    return flags


def nvcc_command(src: str | pathlib.Path, out: str | pathlib.Path,
                 compiler: str | None = None) -> list[str]:
    """The nvcc command line that builds ``src`` into the library ``out``."""
    return [compiler or nvcc(), *_flags(), "-o", str(out), str(src)]


def _lib_path(name: str, compiler: str) -> pathlib.Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(_flags() + [compiler]).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every named kernel library."""
    with _lock:
        missing = [n for n in names if n not in _libs]
        if not missing:
            return {n: _libs[n] for n in names}
        compiler = nvcc()
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in missing:
            target = _lib_path(name, compiler)
            if target.exists():
                continue
            fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=target.name,
                                       suffix=".tmp")
            os.close(fd)
            cmd = nvcc_command(CSRC / f"{name}.cu", tmp, compiler)
            jobs.append((name, target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failures = []
        for name, target, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}:\n{log}")
                os.unlink(tmp)
                continue
            if log and os.environ.get("REPRO_TORCH_NVCC_VERBOSE"):
                print(f"[nvcc {name}]\n{log}", flush=True)
            os.replace(tmp, target)
        if failures:
            raise RuntimeError("nvcc failed to build the repro_torch "
                               "kernels:\n" + "\n".join(failures))
        for name in missing:
            _libs[name] = ctypes.CDLL(str(_lib_path(name, compiler)))
        return {n: _libs[n] for n in names}


def count_launch(fn) -> None:
    """Add one to a wrapper's launch counter ``fn.launches``.

    Under a lock: serving pumps launch kernels from several threads, and
    ``+=`` on an attribute is not atomic across them.
    """
    with _count_lock:
        fn.launches += 1


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ``ctypes`` pointer argument."""
    return ctypes.c_void_p(t.data_ptr())


def current_stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream as a ``ctypes`` pointer argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def library_path(name: str) -> pathlib.Path:
    """The file the library of ``csrc/<name>.cu`` is (or will be) built
    into."""
    return _lib_path(name, nvcc())


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]
