"""Build and load the hand-written CUDA kernels (``hpclinalg_torch/csrc``).

Each ``.cu`` file has a plain C interface and is compiled with nvcc for
``sm_90a`` into a shared library under the git-ignored ``build/kernels/``
directory at the repository root, at first use, then loaded with ctypes.
Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from functools import lru_cache

from ..utils.profiling import span

_PKG = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# seconds spent in nvcc per library, for the build-time report
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (CUDA_HOME or PATH)")
    return found


@lru_cache(maxsize=None)
def load_kernel_lib(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu into build/kernels/lib<name>.so if it or a
    header of csrc/ is newer than the library, and load it. nvcc's resource
    report (-Xptxas -v) is kept beside the library as <name>.ptxas.txt.
    Raises when the build fails."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    inputs = [src] + [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                      if f.endswith(".cuh")]
    if not os.path.exists(so) or max(map(os.path.getmtime, inputs)) \
            > os.path.getmtime(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True)
        build_seconds[name] = time.perf_counter() - t0
        with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def launch_range(name: str):
    """A range named after the kernel on the profiler's host timeline while
    a torch.profiler session is on, recorded while the span recorder is on,
    else a no-op context (``utils/profiling.span``): a trace then names
    each hand-written kernel at its launch even where it recorded no
    device activity."""
    return span(name)


def stream_ptr(t) -> ctypes.c_void_p:
    """The current PyTorch stream of ``t``'s device, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
