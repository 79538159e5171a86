"""Build and bind the hand-written CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into its own shared library with
a plain C interface and loaded with `ctypes`. No PyTorch header is
included, so a build takes seconds. Libraries are cached in `_build/`
beside this file (listed in .gitignore) under a name that carries the
hash of the source, so an edited kernel is rebuilt at its first use.

Nothing here runs at import time: `Kernel.launch` builds its library on
first use, and `build_all` builds every kernel at once, one `nvcc`
process per source started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def _start_build(source: Path, out: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    proc.out_path = out  # type: ignore[attr-defined]
    return proc


def _finish_build(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)  # type: ignore[attr-defined]
    Path(str(proc.out_path) + ".log").write_text(log)  # type: ignore[attr-defined]
    return log


class Kernel:
    """One CUDA kernel behind a C launch function.

    `launches` counts successful launches: it is incremented in `launch`
    and nowhere else, so a run can show which kernels its path went
    through. The C function returns `cudaGetLastError()` after the
    launch; a nonzero code raises here.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None

    @property
    def built(self) -> bool:
        return self._fn is not None

    def _bind(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        describe = lib.kernel_error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        self._lib = lib  # keep the library alive with its functions
        self._describe = describe
        self._fn = fn

    def launch(self, *args) -> None:
        if self._fn is None:
            build_all([self])
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA launch failed with error {err} "
                f"({self._describe(err).decode()})"
            )
        self.launches += 1


def build_all(kernels: Sequence[Kernel]) -> Dict[str, str]:
    """Build every kernel not built yet, all nvcc processes started
    together, then bind them. Returns {name: nvcc log} for the kernels
    this call compiled."""
    logs: Dict[str, str] = {}
    with _LOCK:
        todo = [k for k in kernels if k._fn is None]
        procs: List = []
        for k in todo:
            out = _lib_path(k.source)
            procs.append((k, out, None if out.exists() else _start_build(k.source, out)))
        errors: List[str] = []
        for k, out, proc in procs:
            if proc is None:
                continue
            try:
                k.build_log = _finish_build(proc)
                logs[k.name] = k.build_log
            except RuntimeError as exc:
                errors.append(f"{k.name}: {exc}")
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        for k, out, _ in procs:
            k._bind(out)
    return logs
