"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc/`` is a self-contained ``.cu`` file with a
plain C interface. It is compiled by ``nvcc`` for ``sm_90a`` into a shared
library on first use and loaded with :mod:`ctypes`; the wrappers in
:mod:`sheeprl_tpu_torch.kernels.ops` pass tensor pointers and PyTorch's
current stream. The sources include only the CUDA runtime, so a build takes
seconds (a source that includes PyTorch's headers, as
``torch.utils.cpp_extension.load`` builds it, takes minutes).

Libraries go to ``<repo>/.torch_ext_build/`` (listed in ``.gitignore``) under
a name that hashes the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

__all__ = [
    "BUILD_DIR",
    "CSRC",
    "NVCC_FLAGS",
    "SOURCES",
    "build_all",
    "build_library",
    "load_library",
    "tensor_core_instructions",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext_build"
#: every kernel source of the port, by library name
SOURCES: Dict[str, Path] = {"hafner_gru": CSRC / "hafner_gru.cu"}
NVCC_FLAGS: List[str] = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for candidate in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc was not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from source on the machine with the card"
    )


def _library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_library(name: str) -> "tuple[Path, str]":
    """Compile one source unless its library exists. Returns the library's
    path and the compiler's log (``-Xptxas=-v`` register and shared-memory
    lines; empty when the library was already built)."""
    out = _library_path(name)
    if out.exists():
        from sheeprl_tpu_torch.obs.counters import add_compile_cache_hit

        add_compile_cache_hit()
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
            capture_output=True,
            text=True,
            check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name} (rc={proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def build_all() -> Dict[str, str]:
    """Build every source at once, one ``nvcc`` each, started together.
    Returns the compiler log of each library."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(build_library, name) for name in SOURCES}
        return {name: fut.result()[1] for name, fut in futures.items()}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    path, _log = build_library(name)
    return ctypes.CDLL(str(path))


def tensor_core_instructions(name: str) -> Dict[str, int]:
    """The tensor-core instructions in the SASS of one built library, by
    form (``HGMMA.64x128x8.F32.TF32``: Hopper's ``wgmma``; ``HMMA...``:
    ``mma.sync``), each with its count of static occurrences, from
    ``cuobjdump -sass`` (beside ``nvcc``)."""
    path, _log = build_library(name)
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    counts: Dict[str, int] = {}
    for form in re.findall(r"\b(HG?MMA(?:\.[0-9A-Za-z]+)*)", sass):
        counts[form] = counts.get(form, 0) + 1
    return counts
