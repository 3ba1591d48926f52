"""The port's page allocators (pie_tpu_torch.runtime.allocator) on the CPU:
the six tests of tests/test_allocator.py, each over the pure-Python
allocator and the native C++ one the port builds from native/, and both
against the JAX package's Python allocator on the same operations."""

import threading

import pytest

from pie_tpu.runtime import PageAllocator as JPageAllocator
from pie_tpu_torch.runtime import TOKENS_PER_PAGE, NativePageAllocator, PageAllocator

KINDS = {"python": PageAllocator, "native": NativePageAllocator}


@pytest.fixture(params=sorted(KINDS))
def make(request):
    return KINDS[request.param]


def test_tokens_per_page_constant():
    """64 tokens a page, the native library's kTokensPerPage (checked at its
    load) and the JAX package's."""
    from pie_tpu.runtime import TOKENS_PER_PAGE as J_TOKENS_PER_PAGE
    from pie_tpu_torch.runtime.native import load

    assert TOKENS_PER_PAGE == 64 == J_TOKENS_PER_PAGE
    assert load().pie_tokens_per_page() == 64


def test_exhaustion_and_uniqueness(make):
    a = make(16)
    ids = [a.allocate_n(1)[0] for _ in range(16)]
    assert sorted(ids) == list(range(16))
    assert a.allocate_n(1) == []
    assert a.num_free() == 0
    for i in ids:
        a.free(i)
    assert a.num_free() == 16


def test_refcount_sharing(make):
    a = make(4)
    (pid,) = a.allocate_n(1)
    a.add_ref(pid)
    assert a.ref_count(pid) == 2
    a.free(pid)
    assert a.ref_count(pid) == 1
    assert a.num_free() == 3
    a.free(pid)
    assert a.num_free() == 4


def test_allocate_n_all_or_nothing(make):
    a = make(8)
    got = a.allocate_n(6)
    assert len(got) == 6 == len(set(got))
    assert a.allocate_n(4) == []  # only 2 left: nothing allocated
    assert a.num_free() == 2
    for p in got:
        a.free(p)


def test_double_free_raises(make):
    a = make(4)
    (pid,) = a.allocate_n(1)
    a.free(pid)
    with pytest.raises(ValueError):
        a.free(pid)
    with pytest.raises(ValueError):
        make(4).add_ref(0)  # a page never allocated


def test_refused_free_leaves_the_count(make):
    """Recorded fact of native/ (ROADMAP C): the C++ allocator decrements
    before it checks, so a refused free leaves the page's count at 2^32 - 1
    where the Python allocator leaves 0."""
    a = make(4)
    (pid,) = a.allocate_n(1)
    a.free(pid)
    with pytest.raises(ValueError):
        a.free(pid)
    assert a.ref_count(pid) == (2**32 - 1 if make is NativePageAllocator else 0)


def test_threaded_churn(make):
    a = make(256)
    errors = []

    def worker():
        try:
            mine = []
            for _ in range(2000):
                got = a.allocate_n(1)
                mine += got
                if len(mine) > 8:
                    a.free(mine.pop(0))
            for p in mine:
                a.free(p)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert a.num_free() == 256


def _story(alloc, allocate_n):
    """What a sequence of operations observes: counts, refcounts, and
    whether an oversized request got nothing."""
    seen = []
    got = allocate_n(alloc, 5)
    seen += [len(got), alloc.num_free()]
    alloc.add_ref(got[0])
    seen += [alloc.ref_count(got[0]), len(allocate_n(alloc, 4))]
    for p in got:
        alloc.free(p)
    seen += [alloc.num_free(), alloc.ref_count(got[0])]
    alloc.free(got[0])
    seen += [alloc.num_free(), len(allocate_n(alloc, 8)), alloc.num_free()]
    return seen


def test_allocators_observe_what_jax_observes(make):
    """The same operations on the port's allocator and the JAX package's
    Python one observe the same counts (page ids may differ)."""
    want = _story(JPageAllocator(8, native=False), lambda a, n: a.allocate_n(n))
    assert _story(make(8), lambda a, n: a.allocate_n(n)) == want
