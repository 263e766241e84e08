"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, under ``build/kernels/``
at the repository root. The library's file name carries a hash of its
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is. ``build()`` starts one
``nvcc`` per source, all at once. A failed build raises
:class:`KernelBuildError`; there is no fallback. ``resource_usage()`` gives
each kernel's registers and spills as ``ptxas`` reported them (the report
is kept beside the library, so a library built by an earlier run has one).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}
_logs = {}
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


def sources():
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise KernelBuildError(
            "nvcc not found (no CUDA toolkit on PATH or under CUDA_HOME); "
            "the port's kernels build only where the CUDA toolkit is "
            "installed")
    return found


def library_path(name):
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None):
    """Compile every named source (default: all) whose library for the
    current hash is missing, one ``nvcc`` each, all started together.
    Returns ``{name: seconds}`` for the sources it compiled."""
    names = sources() if names is None else list(names)
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    took, failed = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        _logs[name] = log
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)   # atomic: a concurrent build never sees half
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return took


_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}


def _kernel_name(mangled):
    """``dkdv_kernel<bf16,128,exact>`` for a kernel template instance
    ``dkdv_kernel<T, DMAX, EXACT>`` (``sparse_dq_kernel<...>`` and the
    like keep their whole name), ``threefry_dropout_kernel<bf16>`` for one
    templated on its type alone; other names as they are."""
    m = re.search(
        r"([a-z_]+_kernel)I(f|13__nv_bfloat16|6__half)Li(\d+)ELb([01])E",
        mangled)
    if m is None:
        m = re.search(r"([a-z_]+_kernel)I(f|13__nv_bfloat16|6__half)E",
                      mangled)
        return mangled if m is None else \
            f"{m.group(1)}<{_TYPES[m.group(2)]}>"
    kind = "exact" if m.group(4) == "1" else "masked"
    return f"{m.group(1)}<{_TYPES[m.group(2)]},{m.group(3)},{kind}>"


def resource_usage(name):
    """``{kernel: (registers, spill store bytes, spill load bytes)}`` from
    ``ptxas -v`` of the build of ``csrc/<name>.cu`` (this process's, or the
    report kept beside the library; empty if there is neither)."""
    log = _logs.get(name)
    if log is None:
        kept = library_path(name).with_suffix(".log")
        log = kept.read_text() if kept.exists() else ""
    usage, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
            usage[kernel] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel is not None:
            usage[kernel][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            usage[kernel][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


def load(name):
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
