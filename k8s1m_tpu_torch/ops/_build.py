"""Build and bind the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

The libraries are ``fused_topk`` (ops/fused_topk.py) and ``delta_topk``
(ops/delta_topk.py).  A library ``<name>`` is built from
``csrc/<name>.cu`` plus every ``csrc/<name>_*.cu`` beside it (one
translation unit per stage configuration): each source compiles to an
object file — ``build_all`` starts every unit of every library at once —
and the objects link into ``build/lib<name>.so`` inside the
package (the directory is listed in ``.gitignore``), for ``sm_90a``, at
first use.  A library is rebuilt when any of its sources, or any file of
``csrc/`` they include (``#include "..."``, followed recursively), is
newer than it.  Flags keep the arithmetic exact: IEEE division and square
root, no denormal flush, ``--fmad=false`` (no contraction of a*b+c into
one rounding) — never fast math, since the f32 scores must match the
reference digit for digit before their floor.

Nothing here runs at import: the tests import every module on machines
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import threading

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
LIBRARIES = ("fused_topk", "delta_topk")


def nvcc_path() -> str:
    """The ``nvcc`` of the CUDA toolkit PyTorch builds against, else the
    one on ``PATH``; raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (no CUDA toolkit); the CUDA kernels build only "
            "on a machine with the toolkit"
        )
    return found


def library_path(name: str, build_dir: pathlib.Path = BUILD_DIR) -> pathlib.Path:
    return build_dir / f"lib{name}.so"


def sources(name: str, csrc_dir: pathlib.Path = CSRC_DIR) -> list[pathlib.Path]:
    """The translation units of library ``name``: ``<name>.cu`` first,
    then ``<name>_*.cu`` in name order."""
    main = csrc_dir / f"{name}.cu"
    if not main.exists():
        raise FileNotFoundError(f"no CUDA source {main}")
    return [main, *sorted(csrc_dir.glob(f"{name}_*.cu"))]


def inputs(name: str, csrc_dir: pathlib.Path = CSRC_DIR) -> list[pathlib.Path]:
    """Every file the library is built from: its sources and, recursively,
    the files of ``csrc_dir`` they include."""
    seen: dict[pathlib.Path, None] = {}
    todo = list(sources(name, csrc_dir))
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen[path] = None
        for inc in _INCLUDE.findall(path.read_text()):
            dep = (path.parent / inc).resolve()
            if dep.is_file() and csrc_dir.resolve() in dep.parents:
                todo.append(dep)
    return list(seen)


def is_stale(name: str, csrc_dir: pathlib.Path = CSRC_DIR,
             build_dir: pathlib.Path = BUILD_DIR) -> bool:
    """True when the library is missing or older than any of its inputs."""
    out = library_path(name, build_dir)
    if not out.exists():
        return True
    built = out.stat().st_mtime
    return any(p.stat().st_mtime > built for p in inputs(name, csrc_dir))


def _start(name: str) -> tuple[pathlib.Path, list] | None:
    """Start one ``nvcc -c`` per translation unit of a stale library;
    None when the library is current."""
    if not is_stale(name):
        return None
    nvcc = nvcc_path()
    obj_dir = BUILD_DIR / f"{name}.{os.getpid()}.obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources(name):
        obj = obj_dir / (src.stem + ".o")
        log = obj_dir / (src.stem + ".log")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(log, "w") as f:   # a file, not a pipe: no process blocks on output
            procs.append((src, obj, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT,
            )))
    return obj_dir, procs


def _finish(name: str, obj_dir: pathlib.Path, procs: list) -> str:
    """Wait for the compiles, link ``build/lib<name>.so``; returns nvcc's
    output, raises with it when a step fails."""
    report, failed = [], []
    for src, _obj, log, proc in procs:
        proc.wait()
        text = log.read_text()
        report.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {src}:\n{text}")
    if failed:
        shutil.rmtree(obj_dir, ignore_errors=True)
        raise RuntimeError("\n".join(failed))
    out = library_path(name)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc_path(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *(str(o) for _s, o, _l, _p in procs)],
        capture_output=True, text=True, check=False,
    )
    shutil.rmtree(obj_dir, ignore_errors=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}) for {out}:\n"
                           f"{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    return "\n".join(report)


def build_all(names) -> dict[str, str]:
    """Compile every stale library of ``names``, all translation units of
    all of them at once (one ``nvcc`` process each); returns nvcc's output
    per library ("" for one that was current)."""
    started = {name: _start(name) for name in names}
    reports, errors = {}, []
    for name, job in started.items():
        if job is None:
            reports[name] = ""
            continue
        try:
            reports[name] = _finish(name, *job)
        except RuntimeError as e:    # finish the others, then raise them all
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def build(name: str) -> str:
    """Compile library ``name`` into ``build/lib<name>.so`` if it is stale;
    returns nvcc's output (the ``-Xptxas -v`` register and shared-memory
    report of every kernel), "" when the library is current."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
