"""Build and load the port's CUDA C++ kernels (nvcc -> shared library ->
ctypes).

Each kernel source under ``csrc/`` exposes a plain C interface, so it
compiles in seconds with ``nvcc`` alone (no PyTorch headers).  The library
lands in ``build/kernels/`` at the repository root, named after a hash of
the sources and the flags (the common ones and the kernel's own, in
:data:`EXTRA_FLAGS`): a changed ``.cu`` builds a new library, an unchanged
one is reused.  nvcc's output (ptxas' registers, shared memory and spills
of every kernel) is kept beside the library as ``<library>.log``.  Nothing
is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# IEEE sqrt and division are nvcc's defaults without --use_fast_math;
# -fmad=false keeps a*b+c as two rounded operations, so the kernel does the
# same float32 arithmetic as its plain PyTorch version op for op.
# -Xptxas -v reports registers, shared memory and spills in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Flags of one kernel library, after NVCC_FLAGS: flash_attention encodes
# its TMA descriptors with the driver API (cuTensorMapEncodeTiled).
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    "flash_attention": ("-lcuda",),
}


class Built(NamedTuple):
    path: Path
    log: str          # nvcc's output (ptxas resource usage)
    seconds: float    # build wall time; 0.0 if reused


_LOADED: Dict[str, ctypes.CDLL] = {}
BUILDS: Dict[str, Built] = {}


def tool(name: str = "nvcc") -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"{name} not found (looked in $CUDA_HOME/bin, "
            "/usr/local/cuda/bin and PATH); the CUDA kernels cannot be built")
    return found


def _sources(name: str) -> List[Path]:
    main = CSRC / f"{name}.cu"
    if not main.exists():
        raise FileNotFoundError(f"kernel source {main} does not exist")
    return [main] + sorted(CSRC.glob("*.cuh"))


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources and
    flags exists.  Raises ``RuntimeError`` with nvcc's output on failure."""
    srcs = _sources(name)
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    h = hashlib.sha256(" ".join(flags).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        return Built(out, log.read_text() if log.exists() else "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(srcs[0]),
           *EXTRA_FLAGS.get(name, ())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {srcs[0]} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: concurrent builders never see a partial
    return Built(out, proc.stdout + proc.stderr, seconds)


def load(name: str, built: Optional[Built] = None) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use
    (``built``: a build already made)."""
    lib = _LOADED.get(name)
    if lib is None:
        built = built or build(name)
        BUILDS[name] = built
        lib = ctypes.CDLL(str(built.path))
        _LOADED[name] = lib
    return lib


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Load several kernels, building the missing ones with one nvcc each,
    all started together (the builds are independent processes)."""
    from concurrent.futures import ThreadPoolExecutor

    todo = [n for n in names if n not in _LOADED]
    with ThreadPoolExecutor(max_workers=max(len(todo), 1)) as pool:
        built = dict(zip(todo, pool.map(build, todo)))
    return {n: load(n, built.get(n)) for n in names}


def sass(name: str) -> str:
    """The machine code of kernel library ``name`` (``cuobjdump -sass``),
    built first if need be."""
    built = BUILDS.get(name) or build(name)
    proc = subprocess.run([tool("cuobjdump"), "-sass", str(built.path)],
                          capture_output=True, text=True, check=True)
    return proc.stdout
