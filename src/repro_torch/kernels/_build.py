"""Build the CUDA kernels from the sources in ``csrc/`` and load them.

Each ``.cu`` file exports a plain C interface and is compiled on its own by
``nvcc`` into a shared library under ``build/kernels/`` at the repository
root (listed in ``.gitignore``), then loaded with ``ctypes``. The build runs
at first use; a library's file name carries a hash of its source, of the
shared headers (``csrc/*.cuh``) and of its own flags (``NVCC_FLAGS``), so
an edited source, header or flag is rebuilt and an unchanged one is
reused. Several sources build in parallel, one ``nvcc`` each.

A measurement build (``scripts/*_variants.cu``: a source that includes a
kernel's ``.cu`` with extra defines, never part of the solve) is built and
cached the same way through :func:`build`'s ``variants``; its hash covers
every file under ``csrc/``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"sweep": "sweep.cu", "sweep_rwa": "sweep_rwa.cu",
           "sweep_rsa": "sweep_rsa.cu",
           "colored_sweep": "colored_sweep.cu",
           "colored_sweep_hopper": "colored_sweep_hopper.cu",
           "local_field": "local_field.cu",
           "bitplane_field": "bitplane_field.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu",
           "flash_attention_wgmma": "flash_attention_wgmma.cu",
           "flash_attention_bwd_wgmma": "flash_attention_bwd_wgmma.cu"}
COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: The Ising kernels round every multiply and add on its own (-fmad=false)
#: to agree bitwise with their plain versions; flash attention (forward and
#: backward) contracts.
EXACT = ("-fmad=false",)
NVCC_FLAGS = {"sweep": COMMON_FLAGS + EXACT,
              "sweep_rwa": COMMON_FLAGS + EXACT,
              "sweep_rsa": COMMON_FLAGS + EXACT,
              "colored_sweep": COMMON_FLAGS + EXACT,
              "colored_sweep_hopper": COMMON_FLAGS + EXACT,
              "local_field": COMMON_FLAGS + EXACT,
              "bitplane_field": COMMON_FLAGS + EXACT,
              "flash_attention": COMMON_FLAGS,
              "flash_attention_bwd": COMMON_FLAGS,
              "flash_attention_wgmma": COMMON_FLAGS,
              "flash_attention_bwd_wgmma": COMMON_FLAGS}


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float   # 0.0 when an earlier build was reused
    log: str         # nvcc's output (ptxas register and shared-memory use)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from source at first use")


def _spec(name: str, variants: dict) -> tuple:
    """(source, flags, the files its hash covers besides the source) of a
    kernel source or of a measurement build ``variants[name] = (source,
    the kernel source name whose flags it takes, extra flags)``."""
    if name in SOURCES:
        return (CSRC / SOURCES[name], NVCC_FLAGS[name],
                sorted(CSRC.glob("*.cuh")))
    source, base, extra = variants[name]
    return (Path(source), (*NVCC_FLAGS[base], *extra, "-I", str(CSRC)),
            sorted(CSRC.glob("*.cu*")))


def _target(name: str, source: Path, flags, deps) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for dep in deps:
        h.update(dep.name.encode() + dep.read_bytes())
    h.update(" ".join(flags).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=None, variants=None) -> dict[str, Built]:
    """Compile the named sources (default: all) and the measurement builds
    in ``variants`` (name -> (source path, kernel source name, extra
    flags)) that are not built yet, all at once, and return where each
    library is. Raises on a failed build, with the compiler's output."""
    variants = variants or {}
    names = list(SOURCES) if names is None else list(names)
    names += [v for v in variants if v not in names]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: dict[str, Built] = {}
    running = {}
    for name in names:
        source, flags, deps = _spec(name, variants)
        target = _target(name, source, flags, deps)
        if target.exists():
            done[name] = Built(name, target, 0.0, "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.perf_counter(), source.name)
    failures = []
    for name, (proc, tmp, target, t0, src) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        done[name] = Built(name, target, seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    return ctypes.CDLL(str(build([name])[name].path))
