"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source under ``kernels/<name>/csrc/`` has a plain C interface and is
compiled on its own into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout, for ``sm_90a``.  ``build`` starts one ``nvcc`` per
missing library, all at once, and waits for them together; ``library``
builds on first use, so importing a module never compiles anything.
The hash covers the source bytes, the headers it includes from the
port's tree and the flags, so an edited source or header is rebuilt and
a built one is reused.  ``ptxas -v`` (registers, shared
memory, spills) goes to ``build/kernels/<name>.log``.

Every exported function returns a ``cudaError_t`` (0 on success), read
right after the launch with ``cudaGetLastError``; ``check`` turns a
non-zero code into an exception naming the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build", "library", "check"]

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"

_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_COMMON = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Source:
    """One CUDA source and the flags it is compiled with besides the common ones."""

    name: str
    path: Path
    flags: tuple[str, ...] = ()
    headers: tuple[Path, ...] = ()  # the port's headers the source includes

    def library_path(self) -> Path:
        h = hashlib.sha256(self.path.read_bytes())
        for header in self.headers:
            h.update(header.read_bytes())
        h.update(" ".join(_ARCH + _COMMON + self.flags).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:12]}.so"


_PENALTY_H = _KERNELS_DIR / "utility" / "csrc" / "penalty.cuh"
_LRU_H = _KERNELS_DIR / "selection_scan" / "csrc" / "lru.cuh"
_STEP_H = _KERNELS_DIR / "selection_scan" / "csrc" / "step.cuh"
_MMA_H = _KERNELS_DIR / "flash_attention" / "csrc" / "mma.cuh"

SOURCES: dict[str, Source] = {
    "knn": Source("knn", _KERNELS_DIR / "knn" / "csrc" / "knn.cu"),
    # The Eq. 2 kernel's f64 instance must round like numpy: no FMA
    # contraction (see csrc/utility.cu).
    "utility": Source(
        "utility", _KERNELS_DIR / "utility" / "csrc" / "utility.cu", ("--fmad=false",),
        (_PENALTY_H,),
    ),
    # The pipeline's selection scan shares K1's Eq. 2 arithmetic and its
    # bit-identity rule: no FMA contraction either.
    "selection_scan": Source(
        "selection_scan", _KERNELS_DIR / "selection_scan" / "csrc" / "selection_scan.cu",
        ("--fmad=false",), (_PENALTY_H, _LRU_H, _STEP_H),
    ),
    # The chunked scan: the same arithmetic and rule, through the sequential
    # scan's step.
    "spec_scan": Source(
        "spec_scan", _KERNELS_DIR / "spec_scan" / "csrc" / "spec_scan.cu", ("--fmad=false",),
        (_PENALTY_H, _LRU_H, _STEP_H),
    ),
    # The sharded rounds score rows with the scans' step and chain the
    # carry with their update: the same arithmetic and rule.
    "shard_round": Source(
        "shard_round", _KERNELS_DIR / "shard_round" / "csrc" / "shard_round.cu",
        ("--fmad=false",), (_PENALTY_H, _LRU_H, _STEP_H),
    ),
    "flash_attention": Source(
        "flash_attention", _KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
        headers=(_MMA_H,),
    ),
    "flash_attention_bwd": Source(
        "flash_attention_bwd",
        _KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention_bwd.cu",
        headers=(_MMA_H,),
    ),
    "decode_attention": Source(
        "decode_attention", _KERNELS_DIR / "decode_attention" / "csrc" / "decode_attention.cu"
    ),
    "ssd": Source("ssd", _KERNELS_DIR / "ssd" / "csrc" / "ssd.cu"),
    "ssd_bwd": Source("ssd_bwd", _KERNELS_DIR / "ssd" / "csrc" / "ssd_bwd.cu"),
    "rglru_scan": Source("rglru_scan", _KERNELS_DIR / "rglru_scan" / "csrc" / "rglru_scan.cu"),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")


def build(names=None) -> dict[str, float]:
    """Build the named sources (default: all) that are not built yet.

    One ``nvcc`` process per source, all started before any is waited
    on.  Returns ``{name: seconds}`` for the libraries it built (0.0 for
    one found already built); raises with the compiler's output when a
    build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, out = [], {}
    for name in names:
        src = SOURCES[name]
        if src.library_path().exists():
            out[name] = 0.0
        else:
            todo.append(src)
    if not todo:
        return out
    nvcc = _nvcc()
    running = []
    for src in todo:
        final = src.library_path()
        tmp = final.with_suffix(f".{os.getpid()}.tmp")
        log_path = BUILD_DIR / f"{src.name}.log"
        cmd = [nvcc, *_ARCH, *_COMMON, *src.flags, "-o", str(tmp), str(src.path)]
        log = open(log_path, "w")
        try:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        except BaseException:
            log.close()
            raise
        running.append((src, proc, log, log_path, tmp, final, time.perf_counter()))
    failed = []
    for src, proc, log, log_path, tmp, final, t0 in running:
        try:
            rc = proc.wait()
        finally:
            log.close()
        out[src.name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{src.name} (nvcc exit {rc}):\n{log_path.read_text()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, final)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of source ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(SOURCES[name].library_path()))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
