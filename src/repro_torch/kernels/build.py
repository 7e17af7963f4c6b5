"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), which :func:`library` loads with ``ctypes``.  Libraries land in
``_build/`` beside this file (listed in ``.gitignore``), named by a hash of
their sources and flags, so an edited source rebuilds and an unchanged one
is reused.  :func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.

Every kernel has a :class:`Kernel` record in :data:`KERNELS`; its wrapper
adds one to ``launches`` right where it launches the kernel, and nowhere
else, so a caller can zero the counts, drive a path and see which kernels
that path ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its source, the TPU kernel it replaces,
    and how many times its wrapper launched it."""

    name: str
    source: str          # path in the repository
    replaces: str        # file:line of the Pallas kernel it replaces
    launches: int = 0


KERNELS: dict[str, Kernel] = {
    "flash_attention": Kernel(
        "flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:78"),
    "decode_attention": Kernel(
        "decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:69"),
    "block_digest": Kernel(
        "block_digest", "src/repro_torch/kernels/csrc/digest.cu",
        "src/repro/kernels/digest.py:45"),
}

#: kernel name -> source stem under csrc/
_SOURCES = {"flash_attention": "flash_attention",
            "decode_attention": "decode_attention",
            "block_digest": "digest"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to kernel ``name``'s count; called by its wrapper right
    after a launch (mover workers may launch from several threads)."""
    with _count_lock:
        KERNELS[name].launches += 1


def reset_launches() -> None:
    with _count_lock:
        for k in KERNELS.values():
            k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{stem}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[list[str]] = None) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns seconds per kernel built
    (0.0 when the library was already there).  Raises with the compiler's
    output if any build fails; the ``-Xptxas -v`` report of each build
    (registers, shared memory, spills) is kept in ``_build/<stem>.log``."""
    names = list(KERNELS) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.monotonic()
    for name in names:
        stem = _SOURCES[name]
        out = _lib_path(stem)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, stem)
    took = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, stem) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.monotonic() - t0
        (BUILD_DIR / f"{stem}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return took


def build_log(name: str) -> str:
    """The compiler's report from the last build of kernel ``name``."""
    path = BUILD_DIR / f"{_SOURCES[name]}.log"
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(_SOURCES[name])))
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, f, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    if name == "flash_attention":
        fn = lib.flash_attention_fwd
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, f, i, i, p]
        fn.restype = i
    elif name == "decode_attention":
        fn = lib.decode_attention_fwd
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p, f, i, p]
        fn.restype = i
        lib.decode_attention_smem_bytes.argtypes = [i, i]
        lib.decode_attention_smem_bytes.restype = i64
    elif name == "block_digest":
        fn = lib.block_digest_u32
        fn.argtypes = [p, p, i64, p]
        fn.restype = i
    else:
        raise KeyError(name)


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def strides_arg(*tensors_dims) -> ctypes.Array:
    """Pack element strides for the C interface: each argument is
    ``(tensor, dims)`` and contributes ``tensor.stride(d)`` for each d."""
    vals = [t.stride(d) for t, dims in tensors_dims for d in dims]
    return (ctypes.c_int64 * len(vals))(*vals)
