"""Build of the CUDA kernels and their ctypes binding.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, and loaded with
``ctypes``. Nothing is compiled when this module is imported: a host without
``nvcc`` or without a card can import the package and use the plain versions
on CPU tensors.

The library goes into ``build/repro_torch_kernels/<key>/`` at the root of the
checkout, where ``<key>`` is a hash of the sources and the flags, so an edit
to a source builds a new library. Each source is compiled by its own ``nvcc``
process, all started together, and the objects are linked into the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/build.py -> the checkout's root
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# element type codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a non-zero code."""


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, "
            "/usr/local/cuda and on PATH): the CUDA kernels cannot be built")
    return found


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):      # .cu and .cuh
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources if their library is not there yet; return its
    path. Raises KernelBuildError with the compiler's output on failure."""
    out_dir = BUILD_ROOT / _key()
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.is_file():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"$ nvcc {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if verbose:
        print("\n".join(log), flush=True)
    if failed:
        raise KernelBuildError(
            f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
    tmp = out_dir / f"librepro_torch_kernels.{os.getpid()}.tmp.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)        # another process sees all of it or none
    return lib_path


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rt_rmsnorm.restype = i
    lib.rt_rmsnorm.argtypes = [p, p, p, p, ll, i, f, i, i, i, p]
    lib.rt_flash_attention.restype = i
    lib.rt_flash_attention.argtypes = (
        [p, p, p, p] + [i] * 6 + [ll] * 9 + [i, f, i, p])
    lib.rt_wkv6.restype = i
    lib.rt_wkv6.argtypes = [p] * 8 + [i] * 4 + [ll] * 12 + [i, p]
    lib.rt_ssd.restype = i
    lib.rt_ssd.argtypes = [p] * 6 + [i] * 5 + [ll] * 12 + [i, p]


def library() -> ctypes.CDLL:
    """The loaded kernel library; built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry reported an error."""
    if code == 0:
        return
    if code < 0:
        what = {-1: "unsupported dtype", -2: "unsupported shape",
                -3: "no TMA tensor map for this layout"}.get(
            code, "rejected arguments")
        raise KernelLaunchError(f"{name}: {what} (code {code})")
    raise KernelLaunchError(
        f"{name}: CUDA error {code} at launch (cudaGetLastError)")
