"""Building the CUDA kernels of `csrc/` with `nvcc` into shared libraries.

Each kernel source has a plain C entry point and is loaded with `ctypes`;
the libraries go into the git-ignored `build/` directory at first use and
are rebuilt when the source is newer. The same sources also build as plain
C++ for the CPU with `g++` (`host_build`), which the tests use to hold a
kernel's body against its plain version. Nothing here runs at import.
"""

from __future__ import annotations

import os
import subprocess

from . import BUILD_DIR

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def nvcc_command(src, out, extra=()):
    """The command that builds one kernel source into a shared library."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", *extra, "-shared", "-Xcompiler", "-fPIC", "-o", out,
            os.path.abspath(src)]


def host_build(src, out, extra=()):
    """Build one kernel source as plain C++ for the CPU (the threads of a
    block become a loop) into the shared library `out`; returns `out`.
    Nothing on an encoder's path uses such a library."""
    subprocess.run(["g++", "-O2", "-std=c++17", *extra, "-shared", "-fPIC",
                    "-x", "c++", os.path.abspath(src), "-o", out],
                   check=True, capture_output=True, text=True)
    return out


def _stale(src, so):
    return (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src))


def build_all(jobs):
    """Build every stale library of `jobs` = [(src, so, extra flags)], all
    compilers started together. Returns {so: compiler output} of the
    libraries it built (with `-Xptxas -v` among the flags, the registers,
    spills and shared memory of each kernel). Raises with the compiler's
    output if one fails."""
    running = []
    for src, so, extra in jobs:
        if not _stale(src, so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen(nvcc_command(src, tmp, extra),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((proc, src, so, tmp))
    failed, logs = [], {}
    for proc, src, so, tmp in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {os.path.basename(src)}:\n"
                          + log)
        else:
            # atomic: another process never loads a half-written file
            os.replace(tmp, so)
            logs[so] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build(src, so, extra=()):
    """Build one library if it is missing or older than its source."""
    build_all([(src, so, extra)])
    return so
