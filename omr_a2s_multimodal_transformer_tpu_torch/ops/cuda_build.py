"""Build and load the port's CUDA kernels (``csrc/``) on first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
libraries go to ``build/torch_kernels/`` at the root of the checkout (a
git-ignored directory), named by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is reused. ``build_all``
starts one ``nvcc`` per source, all at once. Nothing here runs at import.
``launch`` calls a launch function on the card of its tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("flash_fwd", "flash_bwd", "flash_dq", "flash_dkv", "keep_mask", "fused_stem_k1", "fused_stem_k2",
           "legacy_flash_fwd", "legacy_flash_dq", "legacy_flash_dkv", "legacy_flash_any_fwd", "legacy_flash_any_dq",
           "legacy_flash_any_dkv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# argtypes of each library's launch function: pointers and the stream as
# c_void_p (a bare Python int would be passed as a 32-bit int and cut).
SIGNATURES = {
    "flash_fwd": ("flash_fwd_launch", [_P] * 10 + [_I] * 10 + [_F, _F, _U, _P]),
    "flash_bwd": ("flash_bwd_launch", [_P] * 11 + [_I] * 6 + [_F, _F, _U, _P]),
    "flash_dq": ("flash_dq_launch", [_P] * 10 + [_I] * 10 + [_F, _F, _U, _P]),
    "flash_dkv": ("flash_dkv_launch", [_P] * 10 + [_I] * 8 + [_F, _F, _U, _P]),
    "keep_mask": ("keep_mask_launch", [_P] * 2 + [_I] * 6 + [_U, _P]),
    "fused_stem_k1": ("fused_stem_k1_launch", [_P] * 13 + [_I] * 12 + [_F, _P]),
    "fused_stem_k2": ("fused_stem_k2_launch", [_P] * 9 + [_I] * 15 + [_F, _P]),
    "legacy_flash_fwd": ("lf_fwd_launch", [_P] * 9 + [_I] * 10 + [_F, _P]),
    "legacy_flash_dq": ("lf_dq_launch", [_P] * 9 + [_I] * 9 + [_F, _P]),
    "legacy_flash_dkv": ("lf_dkv_launch", [_P] * 9 + [_I] * 7 + [_F, _P]),
    "legacy_flash_any_fwd": ("lfany_fwd_launch", [_P] * 7 + [_I] * 9 + [_F, _P]),
    "legacy_flash_any_dq": ("lfany_dq_launch", [_P] * 9 + [_I] * 8 + [_F, _P]),
    "legacy_flash_any_dkv": ("lfany_dkv_launch", [_P] * 10 + [_I] * 8 + [_F, _P]),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h"))  # not the host-only .cpp


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():  # every header and source, so a header edit rebuilds
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(name.encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library that is not built yet, one nvcc per source in
    parallel. Returns {name: library path}; raises with nvcc's output on a
    failed build. ptxas's register and spill report is kept beside each
    library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
        else:
            os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """Library ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib


def host_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cpp`` (at -O3) or ``csrc/<name>.h`` built alone by the
    host's C++ compiler: host code (the native edit distance and
    Smith-Waterman), or the geometry a kernel's launch shares with the host
    (its extern "C" functions), for a machine without nvcc. Built once into
    BUILD_DIR; a failed build raises with the compiler's output."""
    key = f"host_{name}"
    lib = _loaded.get(key)
    if lib is None:
        src = CSRC / f"{name}.cpp"
        opt = "-O3"
        if not src.exists():
            src, opt = CSRC / f"{name}.h", "-O1"
        path = BUILD_DIR / f"lib{key}_{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
        if not path.exists():
            cxx = shutil.which(os.environ.get("CXX", "c++"))
            if cxx is None:
                raise RuntimeError("no host C++ compiler (c++ or $CXX) to build " + src.name)
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, "-std=c++17", opt, "-shared", "-fPIC", "-x", "c++", "-o", str(tmp),
                                   str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed for {src.name}:\n{proc.stdout}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        _loaded[key] = lib
    return lib


def load(name: str):
    """The launch function of library ``name``, built on first use."""
    lib = library(name)
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, device, *args) -> int:
    """Library ``name``'s launch function called with ``args`` while
    ``device`` (the card of the tensors it launches on) is the CUDA
    runtime's current device: a launch goes to the current device, and a
    launcher opts its kernel in to its shared memory there. Returns the
    launcher's cudaError_t (0: launched)."""
    fn = load(name)
    with torch.cuda.device(device):
        return fn(*args)


def build_log(name: str) -> str:
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""
