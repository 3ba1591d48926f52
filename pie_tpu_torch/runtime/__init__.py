"""Host runtime: the refcounted page-id allocators of the paged KV pool,
the native C++ runtime (``native.py``: build and load), its scheduler
(``native_scheduler.py``), its shared-memory request rings (``ipc.py``) and
the standalone engine process (``engine_main.py``)."""

from pie_tpu_torch.runtime.allocator import (
    TOKENS_PER_PAGE,
    NativePageAllocator,
    PageAllocator,
)
