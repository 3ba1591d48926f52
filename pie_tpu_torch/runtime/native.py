"""Build and load the native host runtime (``native/``) for the port.

The port's counterpart of the JAX package's ``load_native`` /
``_try_build`` (``pie_tpu/runtime/allocator.py``). The C++ sources of
``native/`` (the page allocator, the continuous-batching scheduler, the
shared-memory IPC rings and their C ABI) compile with one ``g++`` command
into ``build/pie_tpu_torch/native-<hash>/libpie_runtime.so``, the hash
taken over the flags, the sources and the headers, so an edited source
builds anew and an unchanged one is reused. ``native/build/`` belongs to
the JAX package's cmake build and is never touched here.

Several processes may build at once (test workers, a server and its
engine process): a file lock lets one compile while the others wait, and
the library is written to a temp file and renamed into place, so no
process loads a half-written file. A failed build raises with the
compiler's output; nothing falls back to a pure-Python runtime.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from pie_tpu_torch.runtime.allocator import TOKENS_PER_PAGE

REPO = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO / "native"
BUILD_ROOT = REPO / "build" / "pie_tpu_torch"
#: the library's translation units (native/CMakeLists.txt's pie_runtime)
SOURCES = ("page_allocator", "scheduler", "ipc", "ipc_reader", "capi",
           "capi_scheduler", "capi_ipc")
CXX_FLAGS = ["-std=c++20", "-O3", "-fPIC", "-shared"]
LIBS = ["-lpthread", "-lrt"]

_lib = None
_lock = threading.Lock()
#: seconds the last build in this process took (0.0 when it reused one)
build_seconds = 0.0


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native runtime cannot be built")
    return cxx


def compiler_version() -> str:
    """The first line of ``g++ --version``."""
    out = subprocess.run([_cxx(), "--version"], capture_output=True, text=True)
    return out.stdout.splitlines()[0] if out.stdout else out.stderr.strip()


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    files = [NATIVE_DIR / "src" / f"{s}.cpp" for s in SOURCES]
    files += sorted((NATIVE_DIR / "include" / "pie_runtime").glob("*.hpp"))
    for path in files:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libpie_runtime.so"


def build() -> Path:
    """Compile the library unless a build of the same sources exists;
    returns its path. Raises with the compiler's output on failure."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():  # another process built it meanwhile
            return path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        cmd = [_cxx(), *CXX_FLAGS, f"-I{NATIVE_DIR / 'include'}",
               *(str(NATIVE_DIR / "src" / f"{s}.cpp") for s in SOURCES),
               "-o", tmp, *LIBS]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"native runtime build failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, path)
        build_seconds = time.perf_counter() - t0
    return path


def _bind_allocator(lib) -> None:
    c = ctypes
    lib.pie_alloc_create.restype = c.c_void_p
    lib.pie_alloc_create.argtypes = [c.c_uint32, c.c_uint32]
    lib.pie_alloc_destroy.argtypes = [c.c_void_p]
    lib.pie_alloc_allocate.restype = c.c_int64
    lib.pie_alloc_allocate.argtypes = [c.c_void_p]
    lib.pie_alloc_allocate_n.restype = c.c_int64
    lib.pie_alloc_allocate_n.argtypes = [c.c_void_p, c.c_uint32, c.POINTER(c.c_int64)]
    lib.pie_alloc_free.restype = c.c_int32
    lib.pie_alloc_free.argtypes = [c.c_void_p, c.c_uint32]
    lib.pie_alloc_add_ref.restype = c.c_int32
    lib.pie_alloc_add_ref.argtypes = [c.c_void_p, c.c_uint32]
    lib.pie_alloc_ref_count.restype = c.c_uint32
    lib.pie_alloc_ref_count.argtypes = [c.c_void_p, c.c_uint32]
    lib.pie_alloc_num_free.restype = c.c_uint32
    lib.pie_alloc_num_free.argtypes = [c.c_void_p]
    lib.pie_alloc_num_pages.restype = c.c_uint32
    lib.pie_alloc_num_pages.argtypes = [c.c_void_p]
    lib.pie_tokens_per_page.restype = c.c_uint32
    lib.pie_tokens_per_page.argtypes = []
    lib.pie_alloc_destroy.restype = None


def load():
    """The native library (built at first use), its allocator entry points
    bound; the scheduler's and the IPC's are bound by their modules."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _bind_allocator(lib)
            if lib.pie_tokens_per_page() != TOKENS_PER_PAGE:
                raise RuntimeError(
                    f"native kTokensPerPage {lib.pie_tokens_per_page()} != "
                    f"TOKENS_PER_PAGE {TOKENS_PER_PAGE}")
            _lib = lib
        return _lib
