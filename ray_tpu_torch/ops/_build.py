"""Build and bind the hand-written CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into its own shared library with
a plain C interface and loaded with `ctypes`. No PyTorch header is
included, so a build takes seconds. Libraries are cached in `_build/`
beside this file (listed in .gitignore) under a name that carries the
hash of the source and of the headers it includes from `csrc/`, so an
edited kernel or header is rebuilt at its first use.

Nothing here runs at import time: `Kernel.launch` builds its library on
first use, and `build_all` builds every kernel at once, one `nvcc`
process per source started together. Several `Kernel`s may bind launch
functions of one source (the flash backward's dkv and dq): the source is
compiled once and each of them binds the one library. Nothing links
against libcuda (`-lcuda`) and no CUTLASS header is needed: the Hopper
instructions (wgmma, cp.async, the swizzled layout) are inline PTX.
`sass_counts` reads a built library's instructions back through
`cuobjdump`, so a run can show which instances use them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    "-I", str(CSRC),  # a variant of a source built from elsewhere finds the headers
)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_files(source: Path) -> List[Path]:
    """The source and, after it, every header it includes by a quoted name
    (resolved beside the including file, then in `csrc/`), nested ones too."""
    files: List[Path] = []
    todo = [source]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            found = [d / name for d in (path.parent, CSRC) if (d / name).exists()]
            if found:
                todo.append(found[0])
    return files


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha256()
    for path in _source_files(source):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


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


def parse_sass(text: str, opcodes: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """{function: {opcode: count}} from `cuobjdump -sass` output: each
    "Function : <name>" header opens a function, and an instruction counts
    for an opcode when its mnemonic starts with it (HGMMA.64x64x16... is
    HGMMA)."""
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("Function :"):
            current = counts.setdefault(stripped.split(":", 1)[1].strip(), dict.fromkeys(opcodes, 0))
            continue
        if current is None or "*/" not in stripped:
            continue
        # "/*0090*/   @!P0 HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], ... ;"
        words = stripped.split("*/", 1)[1].split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            for op in opcodes:
                if words[0].startswith(op):
                    current[op] += 1
    return counts


def sass_counts(kernel: "Kernel", opcodes: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """`parse_sass` of the kernel's built library, by `cuobjdump` from the
    toolkit that holds nvcc."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(_lib_path(kernel.source))], check=True,
                          capture_output=True, text=True).stdout
    return parse_sass(text, opcodes)


def build_all(kernels: Sequence[Kernel]) -> Dict[str, str]:
    """Build every kernel not built yet, all nvcc processes started
    together, then bind them. Returns {name: nvcc log} for the kernels
    this call compiled."""
    logs: Dict[str, str] = {}
    with _LOCK:
        todo = [k for k in kernels if k._fn is None]
        # one nvcc per source, however many kernels bind it
        by_source: Dict[Path, List[Kernel]] = {}
        for k in todo:
            by_source.setdefault(k.source, []).append(k)
        procs: List = []
        for source, group in by_source.items():
            out = _lib_path(source)
            procs.append((group, out, None if out.exists() else _start_build(source, out)))
        errors: List[str] = []
        for group, out, proc in procs:
            if proc is None:  # built earlier: keep the log nvcc wrote beside it
                saved = Path(str(out) + ".log")
                for k in group:
                    k.build_log = saved.read_text() if saved.exists() else ""
                continue
            try:
                log = _finish_build(proc)
            except RuntimeError as exc:
                errors.append(f"{group[0].source.name}: {exc}")
                continue
            for k in group:
                k.build_log = log
                logs[k.name] = log
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        for group, out, _ in procs:
            for k in group:
                k._bind(out)
    return logs
