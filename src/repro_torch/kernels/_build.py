"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (device pointers, sizes, the
stream) and is compiled on first use into ``build/<name>-<hash>.so`` next to
this module, the hash covering the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later kernels.
#: ``-Xptxas -v`` reports each kernel's registers and spills (``ptxas_report``).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: flags of one source on top of ``NVCC_FLAGS``.  The scheduler kernels must
#: equal their plain versions bit for bit: ``--fmad=false`` stops nvcc
#: contracting a*b+c, so every fused multiply-add is an explicit
#: ``__fmaf_rn`` placed where the plain version fuses.  The model kernels
#: are held to a tolerance and let nvcc contract.
SOURCE_FLAGS = {
    "sched_weigh": ("--fmad=false",),
    "sched_screen": ("--fmad=false",),
}

#: seconds each source's ``nvcc`` took in the last ``build`` that compiled it
BUILD_SECONDS: Dict[str, float] = {}
#: and its output (ptxas's report of every kernel)
BUILD_LOG: Dict[str, str] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Callable[..., int]] = {}


def nvcc_path() -> str:
    """The CUDA compiler, from ``PATH`` or the toolkit's usual home."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the repro_torch CUDA kernels are built from source at first use and "
        "need the CUDA toolkit; CPU tensors use the plain PyTorch versions"
    )


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _compile_cmd(name: str, out: str) -> List[str]:
    return [nvcc_path(), *_flags(name), "-o", out, os.path.join(CSRC, f"{name}.cu")]


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns the library
    paths; raises with the compiler's output if any build fails."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _library_path(n) for n in names}
    start, procs = time.perf_counter(), []
    for n in names:
        if os.path.exists(paths[n]):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            _compile_cmd(n, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        )
        procs.append((n, tmp, proc))

    def drain(n: str, proc: subprocess.Popen) -> bytes:
        # read the pipe while nvcc runs, so a long message cannot block it;
        # each source's wall time counts from the common start
        out, _ = proc.communicate()
        BUILD_SECONDS[n] = time.perf_counter() - start
        return out

    with ThreadPoolExecutor(max_workers=max(1, len(procs))) as pool:
        outs = [pool.submit(drain, n, proc) for n, _, proc in procs]
        failed = []
        for (n, tmp, proc), out in zip(procs, outs):
            BUILD_LOG[n] = out.result().decode(errors="replace")
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{n}.cu:\n{BUILD_LOG[n]}")
            else:
                os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Registers, stack frame and spill bytes of every kernel of
    ``csrc/<name>.cu`` by its mangled name, read from ptxas's report in the
    last ``build`` that compiled the source (empty if none did)."""
    report: Dict[str, Dict[str, int]] = {}
    current = None
    for line in BUILD_LOG.get(name, "").splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            current = report.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current is not None:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        _LOADED[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """The C launch entry ``symbol`` of ``csrc/<name>.cu``, typed once
    (``argtypes``, returning ``cudaError_t`` as int) and cached."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _ENTRIES[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
