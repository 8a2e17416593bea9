"""Build the native in-process store library with ``g++``.

The C++ sources under ``native/`` (``memstore/memstore.cc`` and
``wirefront/wirefront.cc``) compile into ``k8s1m_tpu_torch/build/
libmemstore.so`` at first use (the directory is listed in
``.gitignore``); the library is rebuilt when a source is newer than it.
The port keeps a library of its own beside the JAX package's: each
package loads its own file with ``ctypes`` (``RTLD_LOCAL``), so two
stores in one process never share symbols or state.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import threading

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
NATIVE_DIR = PACKAGE_DIR.parent / "native"
SRC_DIRS = (NATIVE_DIR / "memstore", NATIVE_DIR / "wirefront")
LIB_PATH = PACKAGE_DIR / "build" / "libmemstore.so"

_lock = threading.Lock()


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    lib_mtime = LIB_PATH.stat().st_mtime
    return any(
        src.stat().st_mtime > lib_mtime
        for d in SRC_DIRS for src in d.iterdir()
        if src.suffix in (".cc", ".h", ".inc")
    )


def ensure_built(force: bool = False) -> str:
    """Compile ``libmemstore.so`` if missing or out of date; returns its
    path.  One shared object holds the store and the wire front-end, as
    in the JAX package's build."""
    with _lock:
        if not force and not _stale():
            return str(LIB_PATH)
        LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        # Per-process temporary: concurrent builds must not clobber each
        # other's half-written output before the atomic replace.
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-pthread",
            "-Wall", "-o", tmp,
            str(SRC_DIRS[0] / "memstore.cc"),
            str(SRC_DIRS[1] / "wirefront.cc"),
        ]
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, LIB_PATH)
        return str(LIB_PATH)


if __name__ == "__main__":
    print(ensure_built(force=True))
