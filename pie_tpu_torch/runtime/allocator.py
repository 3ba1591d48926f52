"""Refcounted page-id allocators for the paged KV pool.

The port's own copies of the JAX package's ``pie_tpu/runtime/allocator.py``
allocators, with the API the port uses: ``allocate_n`` (all-or-nothing),
``free``, ``add_ref``, ``ref_count``, ``num_free``.

- ``PageAllocator``: pure Python (``_PyAllocator`` there). The Python
  scheduler's pool manager uses it.
- ``NativePageAllocator``: the C++ sharded allocator of ``native/``
  (``pie_alloc_*``), built and loaded by ``runtime/native.py``; a failed
  build raises. The native scheduler keeps its own allocator inside the
  C++ core. The JAX pool manager takes the native allocator wherever it
  builds; the port's keeps the Python one, which changes page placement
  and never results.
"""

from __future__ import annotations

import ctypes
import threading

TOKENS_PER_PAGE = 64  # tokens per KV page


class PageAllocator:
    """Refcounted page ids ``0 .. num_pages-1``; a page returns to the free
    list when its last reference is freed."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._refs = [0] * num_pages
        self._lock = threading.Lock()

    def allocate_n(self, n: int) -> list[int]:
        """``n`` page ids, or [] (nothing allocated) when fewer are free."""
        with self._lock:
            if len(self._free) < n:
                return []
            out = [self._free.pop() for _ in range(n)]
            for pid in out:
                self._refs[pid] = 1
            return out

    def free(self, page_id: int) -> None:
        with self._lock:
            if self._refs[page_id] <= 0:
                raise ValueError(f"free of unallocated page {page_id}")
            self._refs[page_id] -= 1
            if self._refs[page_id] == 0:
                self._free.append(page_id)

    def add_ref(self, page_id: int) -> None:
        with self._lock:
            if self._refs[page_id] <= 0:
                raise ValueError(f"add_ref of free page {page_id}")
            self._refs[page_id] += 1

    def ref_count(self, page_id: int) -> int:
        return self._refs[page_id]

    def num_free(self) -> int:
        return len(self._free)


class NativePageAllocator:
    """The C++ allocator of ``native/`` (``src/page_allocator.cpp``, a
    sharded free list with atomic reference counts) behind the API of
    ``PageAllocator``. ``num_shards`` 0 lets the library choose."""

    def __init__(self, num_pages: int, num_shards: int = 0):
        from pie_tpu_torch.runtime.native import load

        self._lib = lib = load()
        self.num_pages = num_pages
        self._h = ctypes.c_void_p(lib.pie_alloc_create(num_pages, num_shards))
        if not self._h:
            raise MemoryError("failed to create the native allocator")

    def allocate_n(self, n: int) -> list[int]:
        """``n`` page ids, or [] (nothing allocated) when fewer are free."""
        buf = (ctypes.c_int64 * max(n, 1))()
        got = self._lib.pie_alloc_allocate_n(self._h, n, buf)
        if got < n:
            for i in range(got):
                self._lib.pie_alloc_free(self._h, buf[i])
            return []
        return list(buf[:n])

    def free(self, page_id: int) -> None:
        if self._lib.pie_alloc_free(self._h, page_id) != 0:
            raise ValueError(f"free of unallocated page {page_id}")

    def add_ref(self, page_id: int) -> None:
        if self._lib.pie_alloc_add_ref(self._h, page_id) != 0:
            raise ValueError(f"add_ref of free page {page_id}")

    def ref_count(self, page_id: int) -> int:
        return int(self._lib.pie_alloc_ref_count(self._h, page_id))

    def num_free(self) -> int:
        return int(self._lib.pie_alloc_num_free(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pie_alloc_destroy(h)
            self._h = None
