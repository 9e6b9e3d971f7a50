"""Build the CUDA sources under ``kernels/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

All sources compile in parallel at the first CUDA call (one ``nvcc``
process each).  The library name carries a hash of the source and flags,
so an edited source is never served a stale build.  A missing ``nvcc``
or a failed build raises; there is no fallback.
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
from typing import Dict, NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildResult(NamedTuple):
    path: Path
    seconds: float      # wall time of this source's nvcc (0 when cached)
    log: str            # nvcc's output, including -Xptxas -v


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_results: Dict[str, BuildResult] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, BuildResult]:
    """Compile every ``csrc/*.cu`` not built yet, all at once; returns
    {name: BuildResult}.  Raises with nvcc's output on any failure."""
    with _lock:
        todo = {src.stem: src for src in sorted(CSRC.glob("*.cu"))
                if src.stem not in _results}
        if not todo:
            return dict(_results)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        procs = {}
        for name, src in todo.items():
            out = _target(src)
            if out.is_file():
                _results[name] = BuildResult(out, 0.0, "cached")
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (rc {proc.returncode})\n{log}")
                continue
            os.replace(tmp, out)
            _results[name] = BuildResult(out, secs, log)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return dict(_results)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building on first use."""
    lib = _libs.get(name)
    if lib is None:
        res = build_all().get(name)
        if res is None:
            raise RuntimeError(f"no CUDA source csrc/{name}.cu")
        lib = _libs.setdefault(name, ctypes.CDLL(str(res.path)))
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")
