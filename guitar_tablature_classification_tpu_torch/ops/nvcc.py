"""Build route of the port's CUDA sources: ``nvcc`` into a shared library
with a plain C interface, loaded through ``ctypes``.

Each source is compiled at first use into ``_build/`` beside the package
(listed in ``.gitignore``), under a name that hashes the source, its flags
and the shared headers, so an edited source is rebuilt and an unchanged one
is not.  Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(source: str, flags: tuple[str, ...]) -> str:
    """The library's path, named by a hash of the source, the flags and
    every shared header (``*.cuh``) beside the sources."""
    tag = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [source] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            tag.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{tag.hexdigest()[:16]}.so")


def build(source: str, flags: tuple[str, ...]) -> tuple[str, str]:
    """Compile ``source`` unless it is built already.  Returns the library
    path and the compiler's log (``-Xptxas -v``: registers, shared memory
    and spills of each kernel; empty when the library was there).  A failed
    build raises."""
    path = library_path(source, flags)
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *flags, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {os.path.basename(source)} with code "
            f"{proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path, proc.stderr


def ptxas_report(log: str) -> dict[str, str]:
    """The ``-Xptxas -v`` lines of each kernel in a build log: {mangled
    kernel name: its stack and spill line and its registers and shared
    memory line, joined by "; "}."""
    report, entry = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
            report[entry] = []
        elif entry is not None and ("bytes stack frame" in line or "registers" in line):
            report[entry].append(line.split(": ", 1)[-1].strip())
    return {name: "; ".join(lines) for name, lines in report.items()}
