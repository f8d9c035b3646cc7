"""Host C++ libraries of the port: build on demand, load with ctypes.

The sources live in `cpr_tpu_torch/native/src/` (the generic MDP
compiler, `generic_compiler.cpp`, is host C++, not a kernel). `build_lib`
compiles one with `g++ <opt> -std=c++17 -shared -fPIC` into
`build/cpr_tpu_torch/` (or `$CPR_TORCH_BUILD_DIR`), under a name that
carries a hash of the source and the command, so an edited source
rebuilds and an unchanged one loads at once. The build writes a
temporary file and renames it into place, so processes that build at
the same time (test workers) never load a torn library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def _cmd(opt: str) -> list[str]:
    return ["g++", opt, "-std=c++17", "-shared", "-fPIC"]


def library_path(src: str | Path, opt: str = "-O2") -> Path:
    """Where `build_lib` puts the library of `src` built with `opt`."""
    from cpr_tpu_torch.kernels import build_dir

    src = Path(src)
    h = hashlib.sha256(" ".join(_cmd(opt)).encode())
    h.update(src.read_bytes())
    return build_dir() / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_lib(src: str | Path, opt: str = "-O2") -> Path:
    """Compile `src` unless its library exists; returns the path."""
    so = library_path(src, opt)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}")
    cmd = [*_cmd(opt), str(src), "-o", str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native build failed ({' '.join(cmd)}):\n{r.stderr}")
    os.replace(tmp, so)
    return so


def load_lib(src: str | Path, opt: str = "-O2") -> ctypes.CDLL:
    """Lock-guarded memoized build + load; callers attach ctypes
    signatures to the returned CDLL once."""
    with _LOCK:
        key = f"{Path(src).resolve()} {opt}"
        lib = _LOADED.get(key)
        if lib is None:
            lib = _LOADED[key] = ctypes.CDLL(str(build_lib(src, opt)))
        return lib


__all__ = ["SRC", "build_lib", "library_path", "load_lib"]
