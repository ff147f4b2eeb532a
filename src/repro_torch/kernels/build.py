"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each source under ``csrc/`` compiles, at first use, into its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so \\
         csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads as it is. The build directory
is ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``). Builds of several sources run in parallel. Nothing here
runs at import: the CPU tests import every module, and this machine may
have no ``nvcc``.

No ``--use_fast_math``: ``quant_pack`` must round exactly as the
reference does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# source name -> {exported C function: argtypes}; every function returns
# the cudaError_t of its launch as an int
SOURCES = {
    "quant_pack": {
        "quant_pack_rows_launch": (_P, _P, _P, _P, _P, _I, _I, _I,
                                   ctypes.c_float, _P),
    },
    "dequant_agg": {
        "dequant_agg_rows_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _P),
    },
    "multi_lora_matmul": {
        "multi_lora_matmul_q_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _I, ctypes.c_float, _P),
        "multi_lora_matmul_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                     _I, _I, _I, ctypes.c_float, _P),
    },
}


def find_nvcc() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    got = shutil.which("nvcc")
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if got is None and (cuda_home / "bin" / "nvcc").exists():
        got = str(cuda_home / "bin" / "nvcc")
    if got is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return got


def _lib_path(name: str, build_dir: Path) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir / f"lib{name}-{h[:12]}.so"


class KernelLibrary:
    """The built and loaded kernel libraries of one build directory."""

    def __init__(self, build_dir: Path = BUILD_DIR):
        self.build_dir = Path(build_dir)
        self._libs: dict[str, ctypes.CDLL] = {}

    def build(self, names=None) -> dict:
        """Compile every named source that has no library yet, all at
        once (one ``nvcc`` each). Returns {name: {"path", "seconds",
        "log"}} for the sources it compiled; raises on a failed build."""
        names = list(SOURCES) if names is None else list(names)
        todo = {n: _lib_path(n, self.build_dir) for n in names}
        todo = {n: p for n, p in todo.items() if not p.exists()}
        if not todo:
            return {}
        nvcc = find_nvcc()
        self.build_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for n, path in todo.items():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp, path)
        built, failed = {}, {}
        for n, (proc, tmp, path) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed[n] = log
                continue
            os.replace(tmp, path)
            built[n] = {"path": str(path), "log": log,
                        "seconds": time.perf_counter() - t0}
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {n}\n{log}" for n, log in failed.items()))
        return built

    def lib(self, name: str) -> ctypes.CDLL:
        got = self._libs.get(name)
        if got is not None:
            return got
        path = _lib_path(name, self.build_dir)
        if not path.exists():
            self.build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SOURCES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        self._libs[name] = lib
        return lib

    def fn(self, name: str, fn: str):
        return getattr(self.lib(name), fn)


# the default build directory's libraries, loaded on first launch
LIBRARY = KernelLibrary()


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
