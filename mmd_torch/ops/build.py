"""Build a CUDA source of the port into a shared library at first use.

`nvcc` compiles one `.cu` file with a plain C interface into
`build/lib<name>-<digest>.so` at the repository root; the digest covers the
source, the flags and the compiler path, so an edited source never loads a
stale library. The library is loaded with `ctypes` by the op that owns it.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build"
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    tried = []
    if os.environ.get("CUDA_HOME"):
        tried.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    tried.append("/usr/local/cuda/bin/nvcc")
    if shutil.which("nvcc"):
        tried.append(shutil.which("nvcc"))
    for path in tried:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise FileNotFoundError(
        "nvcc not found; tried $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc "
        f"and PATH: {tried}")


def build_shared_library(source: Path, name: str) -> Path:
    """Compile `source` unless a library of the same digest exists."""
    nvcc = find_nvcc()
    digest = hashlib.sha256(
        source.read_bytes() + "\0".join((nvcc, *NVCC_FLAGS)).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out
