"""Host runtime: the refcounted page-id allocator of the paged KV pool."""

from pie_tpu_torch.runtime.allocator import TOKENS_PER_PAGE, PageAllocator
