"""Reusable serialization buffers (the zero-copy model plane's allocator) —
a copy of :mod:`tpfl.learning.bufferpool`.

The v3 encoder assembles its wire object with a single ``bytes.join``
over borrowed leaf views — but a non-contiguous leaf (transposed or
sliced) must be gathered before its bytes can be borrowed, and wire
paths occasionally need writable staging. Allocating fresh buffers for
that per gossip tick is pure churn at 1000 in-process nodes; a
:class:`BufferPool` keeps a small set of reusable ``bytearray`` buffers
instead: ``acquire(size)`` hands out a :class:`PooledBuffer` (context
manager) whose backing store is recycled on release instead of freed.

Lifecycle discipline (the leak hazard this module is designed around):

- ``acquire`` is used as a context manager (``with pool.acquire(n) as
  buf:``) so an exception mid-encode — a leaf that fails to serialize,
  a truncated-payload decode error — returns the buffer to the pool
  instead of stranding it.
- Every ``PooledBuffer`` additionally carries a GC backstop
  (``__del__``): a lease dropped without release (a code path that
  forgot the context manager) is returned at collection time rather
  than leaked.
- The pool is bounded (``max_buffers`` × ``max_bytes`` total): returning
  a buffer the pool has no room for simply frees it. ``outstanding``
  never grows on error paths — asserted by
  the serialization tests.

Buffers are size-bucketed to powers of two so a node whose model size
is stable hits the same buffer every encode (the expected steady state:
one buffer per node, reused forever).
"""

from __future__ import annotations

import threading
from typing import Optional

from tpfl_torch.concurrency import make_lock


def _bucket(size: int) -> int:
    """Power-of-two capacity bucket (min 4 KiB) for ``size`` bytes."""
    cap = 4096
    while cap < size:
        cap <<= 1
    return cap


class PooledBuffer:
    """A leased slice of pool memory. Use as a context manager, or call
    :meth:`release` explicitly; a GC backstop (``__del__``) returns
    forgotten leases. ``view()`` exposes exactly the requested bytes as
    a writable memoryview."""

    # __del__ (not weakref.finalize) as the leak backstop: the encode
    # hot path leases a buffer per payload, and finalize registration
    # measurably dominated acquire() in the profile. No reference
    # cycles — a lease holds the pool, never the reverse.
    __slots__ = ("_pool", "_buf", "size", "_released")

    def __init__(self, pool: "BufferPool", buf: bytearray, size: int) -> None:
        self._pool = pool
        self._buf = buf
        self.size = size
        self._released = False

    def view(self, size: Optional[int] = None) -> memoryview:
        """Writable view of the leased bytes (default: the acquired size)."""
        if self._released:
            raise ValueError("PooledBuffer used after release")
        n = self.size if size is None else size
        if n > len(self._buf):
            raise ValueError(f"view({n}) exceeds buffer capacity {len(self._buf)}")
        return memoryview(self._buf)[:n]

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._pool._repool(self._buf)
        self._buf = bytearray()  # drop the reference promptly

    def __enter__(self) -> "PooledBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __del__(self) -> None:
        try:
            self.release()
        except Exception:
            pass


class BufferPool:
    """Thread-safe bounded pool of reusable serialization buffers.

    One per node (attached to its :class:`~tpfl_torch.learning.model.TpflModel`
    and inherited by every wire-derived copy), plus a process default
    (:func:`default_pool`) for pool-less call sites."""

    def __init__(
        self, max_buffers: int = 8, max_bytes: int = 256 * 1024 * 1024
    ) -> None:
        self.max_buffers = int(max_buffers)
        self.max_bytes = int(max_bytes)
        self._lock = make_lock("BufferPool._lock")
        # guarded-by: _lock
        self._free: list[bytearray] = []
        # guarded-by: _lock
        self._outstanding = 0
        # guarded-by: _lock writes
        self.hits = 0
        # guarded-by: _lock writes
        self.misses = 0

    # --- lease / return ---

    def acquire(self, size: int) -> PooledBuffer:
        """Lease a buffer of at least ``size`` bytes (context manager)."""
        size = int(size)
        with self._lock:
            best_i = -1
            for i, b in enumerate(self._free):
                if len(b) >= size and (
                    best_i < 0 or len(b) < len(self._free[best_i])
                ):
                    best_i = i
            if best_i >= 0:
                buf = self._free.pop(best_i)
                self.hits += 1
            else:
                buf = bytearray(_bucket(size))
                self.misses += 1
            self._outstanding += 1
        return PooledBuffer(self, buf, size)

    def _repool(self, buf: bytearray) -> None:
        """Return a buffer (release path AND GC-finalizer backstop)."""
        with self._lock:
            self._outstanding = max(0, self._outstanding - 1)
            if (
                len(self._free) < self.max_buffers
                and self.pooled_bytes_locked() + len(buf) <= self.max_bytes
            ):
                self._free.append(buf)

    # --- introspection (tests, bench) ---

    def pooled_bytes_locked(self) -> int:
        return sum(len(b) for b in self._free)

    @property
    def pooled_bytes(self) -> int:
        with self._lock:
            return self.pooled_bytes_locked()

    @property
    def pooled_buffers(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def outstanding(self) -> int:
        """Leased-but-unreturned buffers. Stays 0 at rest — growth here
        is the leak the decode-error tests guard against."""
        with self._lock:
            return self._outstanding

    def clear(self) -> None:
        with self._lock:
            self._free.clear()


_default_lock = threading.Lock()
_default: Optional[BufferPool] = None


def default_pool() -> BufferPool:
    """Process-wide fallback pool for call sites without a per-node pool
    (tests, tools, models not attached to a Node)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = BufferPool()
        return _default
