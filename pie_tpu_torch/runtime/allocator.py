"""Refcounted page-id allocator for the paged KV pool (pure Python).

The port's own copy of the pure-Python allocator of the JAX package's
``pie_tpu/runtime/allocator.py`` (``_PyAllocator`` behind
``PageAllocator``), with the API the port uses: ``allocate_n``
(all-or-nothing), ``free``, ``add_ref``, ``ref_count``, ``num_free``. The
JAX package binds a C++ allocator from ``native/`` when it can build it;
binding it here waits for the native scheduler (ROADMAP A7).
"""

from __future__ import annotations

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
