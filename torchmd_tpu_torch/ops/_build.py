"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each `.cu` file has a plain C interface and is compiled on its own into a
shared library under `torchmd_tpu_torch/_build/`, named by a hash of its
source and the compiler flags, so an edited source builds anew and an
unchanged one loads at once. The build runs at first use, inside the
first wrapper call on a CUDA tensor. A missing compiler or a failed build
raises: there is no fallback. ptxas reports each kernel's registers,
spills and shared memory into a `.log` beside the library, which
`resource_usage` reads back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict = {}


CUDA_NVCC = "/usr/local/cuda/bin/nvcc"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), CUDA_NVCC):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        f"nvcc not found on PATH or at {CUDA_NVCC}; "
        "the CUDA kernels of torchmd_tpu_torch are built from source")


def library_path(name: str) -> str:
    """Path of the shared library built from `csrc/<name>.cu`, keyed by
    its source, the shared `csrc/*.cuh` headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists;
    returns the library path. Raises RuntimeError if nvcc fails."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    with open(f"{tmp}.log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    # atomic, log first: a concurrent loader never sees a partial file,
    # and a library on disk always has its log
    os.replace(f"{tmp}.log", _log_path(out))
    os.replace(tmp, out)
    return out


def _log_path(library: str) -> str:
    return library[:-len(".so")] + ".log"


def _kernel_name(mangled: str) -> str:
    """`pair_kernel<1,0>` from `_Z11pair_kernelILb1ELb0EEv...`, or from the
    nested `_ZN<len><namespace><len>pair_kernelILb1ELb0EEEv...`; integer
    template arguments (`ILi4EE`) read the same way."""
    if not mangled.startswith("_Z"):
        return mangled
    pos, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while m := re.match(r"\d+", mangled[pos:]):
        pos += m.end()
        name = mangled[pos:pos + int(m.group())]
        pos += int(m.group())
    flags = re.match(r"I((?:L[bi]\d+E)+)E", mangled[pos:])
    args = f"<{','.join(re.findall(r'L[bi](\d+)E', flags.group(1)))}>" if flags else ""
    return name + args


def resource_usage(name: str) -> dict:
    """{kernel: {registers, smem, stack, spill_stores, spill_loads}} of the
    built `csrc/<name>.cu`, from ptxas's report in its build log."""
    with open(_log_path(build(name))) as fh:
        text = fh.read()
    usage: dict = {}
    kernel = None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            kernel = usage.setdefault(_kernel_name(m.group(1)), {})
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            kernel.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                          spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            kernel.update(registers=int(m.group(1)),
                          smem=int(smem.group(1)) if smem else 0)
            kernel = None
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib


def check_tensor(t, name, dtype, shape, device):
    """Raise unless `t` has this device, dtype and shape and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
