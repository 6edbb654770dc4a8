"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``.cu`` file with a plain C interface (no PyTorch
headers), compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_ext/`` at the repository root (listed in ``.gitignore``).
The library's file name carries a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads straight away. A plain
C interface keeps a build to seconds; including PyTorch's headers
(``torch.utils.cpp_extension``) costs minutes of every fresh machine's
time. Nothing here runs when a module is imported: the CPU tests import
every module on a machine with no ``nvcc``.

Pointers cross into C as ``tensor.data_ptr()`` and the launch stream as
``torch.cuda.current_stream().cuda_stream``; each C entry point returns
``cudaGetLastError()`` after its launch and the wrapper raises on a
nonzero code. A failed build or launch raises — nothing falls back to
the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "torch_ext"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]


@dataclass
class BuiltLibrary:
    name: str
    lib: ctypes.CDLL
    path: Path
    seconds: float          # nvcc wall time; 0.0 when loaded from disk
    log: str                # nvcc's output (ptxas register/smem report)


_LOADED: Dict[str, BuiltLibrary] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(cuda_home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                           "CUDA kernels are built on the machine with the "
                           "card")
    return nvcc


def build(name: str, sources: Sequence[Path],
          configure: Optional[Callable[[ctypes.CDLL], None]] = None,
          defines: Sequence[str] = ()) -> BuiltLibrary:
    """Compile ``sources`` into ``build/torch_ext/<name>-<hash>.so`` (once
    per content) and load it; ``configure`` declares the C functions'
    ``argtypes``/``restype`` once, at load; ``defines`` are preprocessor
    macros (``-D``), so one source can build a smaller library. Raises
    ``RuntimeError`` with nvcc's output when the build fails."""
    if name in _LOADED:
        return _LOADED[name]
    sources = [Path(s) for s in sources]
    flags: List[str] = ARCH_FLAGS + NVCC_FLAGS + [f"-D{d}" for d in defines]
    h = hashlib.sha256(" ".join(flags).encode())
    for s in sources:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"({' '.join(cmd)}):\n{proc.stdout}"
                               f"{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(out))
    if configure is not None:
        configure(lib)
    built = BuiltLibrary(name=name, lib=lib, path=out, seconds=seconds,
                         log=log)
    _LOADED[name] = built
    return built


def check_launch(name: str, code: int) -> None:
    """Raise when a C entry point returned a nonzero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with "
                           f"cudaError_t {code}")
