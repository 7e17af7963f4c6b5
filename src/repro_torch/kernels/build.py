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
    "digest_items": Kernel(
        "digest_items", "src/repro_torch/kernels/csrc/digest.cu",
        "src/repro/kernels/digest.py:45"),
    "ssd_scan": Kernel(
        "ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:67"),
    "quantize_int8": Kernel(
        "quantize_int8", "src/repro_torch/kernels/csrc/quantize.cu",
        "src/repro/kernels/quantize.py:33"),
    "dequantize_int8": Kernel(
        "dequantize_int8", "src/repro_torch/kernels/csrc/quantize.cu",
        "src/repro/kernels/quantize.py:58"),
}

#: kernel name -> source stem under csrc/ (the quantize pair shares one)
_SOURCES = {"flash_attention": "flash_attention",
            "decode_attention": "decode_attention",
            "block_digest": "digest",
            "digest_items": "digest",
            "ssd_scan": "ssd_scan",
            "quantize_int8": "quantize",
            "dequantize_int8": "quantize"}

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
    for part in (CSRC / f"{stem}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[list[str]] = None) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns seconds per source built
    (0.0 when the library was already there).  Raises with the compiler's
    output if any build fails; the ``-Xptxas -v`` report of each build
    (registers, shared memory, spills) is kept in ``_build/<stem>.log``."""
    names = list(KERNELS) if names is None else names
    stems = sorted({_SOURCES[name] for name in names})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.monotonic()
    for stem in stems:
        out = _lib_path(stem)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    took = {stem: 0.0 for stem in stems}
    failures = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[stem] = time.monotonic() - t0
        (BUILD_DIR / f"{stem}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{stem}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return took


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or will be) built."""
    return _lib_path(_SOURCES[name])


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
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p, f, i, i, p]
        fn.restype = i
    elif name == "block_digest":
        fn = lib.block_digest_u32
        fn.argtypes = [p, p, i64, p]
        fn.restype = i
    elif name == "digest_items":
        fn = lib.digest_items
        fn.argtypes = [p, i, p, i, ctypes.c_char_p, i, p, p, p]
        fn.restype = i
        lib.digest_items_ws_words.argtypes = []
        lib.digest_items_ws_words.restype = i
    elif name == "ssd_scan":
        fn = lib.ssd_scan_fwd
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p, p]
        fn.restype = i
        lib.ssd_scan_smem_bytes.argtypes = []
        lib.ssd_scan_smem_bytes.restype = i64
    elif name == "quantize_int8":
        fn = lib.quantize_int8_f32
        fn.argtypes = [p, i64, p, p, i64, p]
        fn.restype = i
    elif name == "dequantize_int8":
        fn = lib.dequantize_int8_f32
        fn.argtypes = [p, p, p, i64, i64, p]
        fn.restype = i
    else:
        raise KeyError(name)


def refuse_grad(name: str, *inputs) -> None:
    """Raise if autograd would record a launch of kernel ``name``: the
    kernels write into buffers through ctypes and have no backward pass,
    so their output would carry no gradient back to these inputs."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"the {name} kernel has no backward pass, and an input requires "
            "gradients: run it under torch.no_grad(), or train on the plain "
            "path (impl='ref')")


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def aligned16(t, dims) -> bool:
    """Whether ``t`` starts on 16 bytes and its stride along each of
    ``dims`` that has more than one element is a multiple of 16 bytes: what
    a 16-byte vector load or a TMA tile of its rows needs."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        t.stride(d) * es % 16 == 0 for d in dims if t.shape[d] > 1)


def strides_arg(*tensors_dims) -> ctypes.Array:
    """Pack element strides for the C interface: each argument is
    ``(tensor, dims)`` and contributes ``tensor.stride(d)`` for each d."""
    vals = [t.stride(d) for t, dims in tensors_dims for d in dims]
    return (ctypes.c_int64 * len(vals))(*vals)
