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

``launch`` is the one way the wrappers call a C entry: it appends the handle
of the current stream, switches the device only when the tensors are not on
the current one, and raises on an error code. It does as little as it can,
since at a decode step a call costs more on the host than on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/build.py -> the checkout's root
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# element type codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

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
    lib.rt_rmsnorm.argtypes = [p, p]
    lib.rt_rmsnorm_backward.restype = i
    lib.rt_rmsnorm_backward.argtypes = [p] * 7 + [ll, i, f, i, i, i, p]
    lib.rt_flash_attention.restype = i
    lib.rt_flash_attention.argtypes = (
        [p, p, p, p] + [i] * 6 + [ll] * 9 + [i, f, i, p])
    lib.rt_wkv6.restype = i
    lib.rt_wkv6.argtypes = [p] * 8 + [i] * 4 + [ll] * 12 + [i, p]
    lib.rt_ssd.restype = i
    lib.rt_ssd.argtypes = [p] * 6 + [i] * 5 + [ll] * 12 + [i, i, p]


def library() -> ctypes.CDLL:
    """The loaded kernel library; built on the first call. Once it is
    loaded it is read without the lock."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


# torch's own lookups of the current card and of its current stream's raw
# handle, resolved at the first launch (the public forms where a build of
# torch lacks them); with one card there is no other device to switch to
_current_device: Optional[Callable[[], int]] = None
_raw_stream: Optional[Callable[[int], int]] = None
_one_card = False


def _resolve() -> None:
    global _current_device, _raw_stream, _one_card
    _current_device = getattr(torch._C, "_cuda_getDevice", None) or \
        torch.cuda.current_device
    _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or \
        (lambda i: torch.cuda.current_stream(i).cuda_stream)
    _one_card = torch.cuda.device_count() == 1


def current_stream(index: int) -> int:
    """Raw handle of the current stream of card `index`: the one a
    ``torch.cuda.stream(...)`` context has set, else the default stream. The
    lookup is resolved once; the stream is read on every call."""
    if _raw_stream is None:
        _resolve()
    return _raw_stream(index)


def _call(name: str, device: torch.device, args: tuple) -> None:
    entry = _entries.get(name)
    if entry is None:
        entry = _entries[name] = getattr(library(), "rt_" + name)
        _resolve()
    if _one_card:
        index = current = 0
    else:
        index, current = device.index, _current_device()
    if index is None or index == current:
        code = entry(*args, _raw_stream(current))
    else:
        with torch.cuda.device(index):
            code = entry(*args, _raw_stream(index))
    if code:
        check(code, name)


_entries: dict = {}                # name -> the library's C entry rt_<name>
_packed = threading.local()        # each thread's buffer for launch_packed


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry ``rt_<name>`` with `args` and the current stream of
    `device`, on that device; raise KernelLaunchError if it reports an
    error. The device is switched only when it is not the current one."""
    _call(name, device, args)


def launch_packed(name: str, device: torch.device, layout: struct.Struct,
                  *values) -> None:
    """As `launch`, for a C entry that takes a pointer to its arguments
    packed by `layout` into one struct: ctypes then converts one argument
    instead of one for each value, which is most of a call's cost on the
    host. Each thread packs into a buffer of its own."""
    buf = getattr(_packed, "buf", None)
    if buf is None or len(buf) < layout.size:
        buf = _packed.buf = ctypes.create_string_buffer(max(layout.size, 256))
        _packed.addr = (ctypes.addressof(buf),)
    layout.pack_into(buf, 0, *values)
    _call(name, device, _packed.addr)


def refuse_gradients(name: str, *tensors) -> None:
    """Raise if grad mode is on and a tensor needs a gradient: the kernel
    `name` has no backward, and its output, filled through ctypes, would
    have none either, so autograd would take the kernel for a constant and
    lose every gradient upstream of it without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: no backward kernel yet (ROADMAP.md, Queue 2); the "
            f"training path takes attn_impl='full'/'blocked'")


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
