"""Build a CUDA source of the port into a shared library at first use.

`nvcc` compiles each `.cu` file with a plain C interface into
`build/lib<stem>-<digest>.so` at the repository root; the digest covers the
source, the headers of `csrc/` it may include, the flags and the compiler
path, so an edited source or header never loads a stale library. The library is loaded with `ctypes` by the op that owns it.
Each call that runs nvcc hands its seconds to every function in
`COMPILE_LISTENERS` (`utils.profiling.compile_time_monitor`) and adds the
libraries it built to an open recording's counter `kernels.built`.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, List, Sequence

from mmd_torch.utils.profiling import count, span

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build"
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
# Called with the seconds of each build that ran nvcc.
COMPILE_LISTENERS: List[Callable[[float], None]] = []
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


def build_shared_libraries(sources: Sequence[Path],
                           build_dir: Path = BUILD_DIR) -> List[Path]:
    """Compile each source whose library is missing from `build_dir`, with
    one nvcc process per source, all started together; return the
    libraries in order."""
    nvcc = find_nvcc()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    outs, jobs = [], []
    t0 = time.perf_counter()
    try:
        for source in sources:
            digest = hashlib.sha256(source.read_bytes() + headers + "\0".join(
                (nvcc, *NVCC_FLAGS)).encode()).hexdigest()[:16]
            out = build_dir / f"lib{source.stem}-{digest}.so"
            outs.append(out)
            if out.exists():
                continue
            build_dir.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((source, out, tmp, proc))
        errors = []
        for source, out, tmp, proc in jobs:
            log, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {source} (rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if jobs:
            count("kernels.built", sum(proc.returncode == 0 for *_, proc in jobs))
            for listener in list(COMPILE_LISTENERS):
                listener(time.perf_counter() - t0)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def load_kernels() -> None:
    """Build the port's kernels (one nvcc per missing library, all started
    together) and load them, so that no later call builds one."""
    from mmd_torch.ops import collision_guide, guide_loop, sdf_kernel

    with span("kernels.load"):
        build_shared_libraries([sdf_kernel.SOURCE, collision_guide.SOURCE, guide_loop.SOURCE])
        sdf_kernel.load_library()
        collision_guide.load_library()
        guide_loop.load_library()
