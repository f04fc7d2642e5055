"""Build and bind the hand-written CUDA kernels (nvcc + ctypes).

Each kernel source in `pingoo_tpu_torch/csrc/` exposes a plain
`extern "C"` launcher that returns its `cudaGetLastError()`. At first use
on a CUDA tensor the sources are compiled, one nvcc process per source
and all started together, for `sm_90a` into `pingoo_tpu_torch/_build/`,
named by a hash of the source and flags, so an edited source rebuilds
and an unchanged one is loaded as it is. The libraries are loaded with
`ctypes`: every pointer and the stream travel as `c_void_p`.

Nothing here runs at import time, so the package imports on a host with
no nvcc and no card. A build or launch failure raises; there is no
fallback to the plain versions on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

SOURCES = {
    "nfa_scan": "nfa_scan.cu",
    "bitsplit_dfa": "bitsplit_dfa.cu",
    "prefilter": "prefilter.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas resource reports (registers, shared memory, spills) of the
# builds this process ran with verbose=True.
ptxas_reports: dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        "pingoo_tpu_torch/csrc at first use on a CUDA tensor")


def lib_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None, verbose: bool = False) -> dict[str, float]:
    """Compile every named kernel library that is not built yet, all
    nvcc processes at once; returns {name: seconds} for this call."""
    names = list(names or SOURCES)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {n: 0.0 for n in names}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for n in todo:
        out = lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(CSRC_DIR / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, out)
    took: dict[str, float] = {}
    errors = []
    for n, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        took[n] = time.monotonic() - t0
        if proc.returncode != 0:
            errors.append(f"{SOURCES[n]}: nvcc exited {proc.returncode}\n"
                          f"{stdout}{stderr}")
            continue
        if verbose:
            ptxas_reports[n] = stderr
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


class Kernel:
    """One CUDA launcher bound through ctypes, with its launch count.

    `launches` grows by one where the kernel is launched and nowhere
    else, so a run can show that its path went through the kernel."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            lib = load(self.name)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"pingoo_{self.name}_error")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._bind()(*args)
        if rc != 0:
            msg = self._err(rc).decode(errors="replace")
            raise RuntimeError(
                f"CUDA kernel {self.name} failed to launch: error {rc} "
                f"({msg})")
        self.launches += 1


KERNELS: dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(
                f"kernel inputs must share one CUDA device, got {t.device} "
                f"and {dev}")
