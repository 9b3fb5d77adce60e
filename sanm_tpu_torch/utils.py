"""Base utilities: errors, timing, hierarchical profiler, RNG.

Port of ``sanm_tpu/utils.py`` (reference ``libsanm/utils.{h,cpp}``).
``probe_backend`` and ``compile_guard`` are TPU/XLA tools and have no
counterpart here.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field


class SANMError(RuntimeError):
    """Base error (reference ``libsanm/utils.h:19-50``)."""


class SANMAssertionError(SANMError):
    pass


class SANMNumericalError(SANMError):
    """Numerical failure, e.g. a failed solution check (reference
    ``libsanm/utils.h:43-50``)."""


def sanm_assert(cond, msg: str = "", *fmt) -> None:
    if not cond:
        raise SANMAssertionError(msg % fmt if fmt else msg)


def verbose_mode() -> bool:
    """Reference env toggle ``SANM_VERBOSE`` (``libsanm/anm.cpp:314-317``)."""
    return os.environ.get("SANM_VERBOSE") is not None


class Timer:
    """Wall-clock timer (reference ``libsanm/utils.h:186-217``)."""

    def __init__(self):
        self._start = None
        self._accum = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> "Timer":
        if self._start is not None:
            self._accum += time.perf_counter() - self._start
            self._start = None
        return self

    def reset(self) -> "Timer":
        self._start = None
        self._accum = 0.0
        return self

    def time(self) -> float:
        extra = 0.0
        if self._start is not None:
            extra = time.perf_counter() - self._start
        return self._accum + extra


@dataclass
class _ProfNode:
    name: str
    nr_call: int = 0
    tot: float = 0.0
    tmin: float = float("inf")
    tmax: float = 0.0
    children: dict = field(default_factory=dict)

    def child(self, name: str) -> "_ProfNode":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = _ProfNode(name)
        return node


def _device_sync():
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class ScopedProfiler:
    """Hierarchical profiler with per-thread call stacks (reference
    ``libsanm/utils.h:225-249``): tags form a tree keyed by the
    enclosing scopes, with {nr_call, min, max, tot} per node.  Off unless
    ``SANM_PROFILE`` is set or ``ScopedProfiler.enabled`` is assigned.
    CUDA launches are asynchronous, so a scope that must measure device
    time passes ``block=True``: its exit calls ``torch.cuda.synchronize()``.
    """

    _tls = threading.local()
    _root = _ProfNode("<root>")
    _lock = threading.Lock()
    enabled = os.environ.get("SANM_PROFILE") is not None

    @classmethod
    def _stack(cls):
        if not hasattr(cls._tls, "stack"):
            cls._tls.stack = [cls._root]
        return cls._tls.stack

    def __init__(self, name: str, block: bool = False):
        self.name = name
        self.block = block

    def __enter__(self):
        if not self.enabled:
            return self
        stack = self._stack()
        self._node = stack[-1].child(self.name)
        stack.append(self._node)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        if self.block:
            _device_sync()
        dt = time.perf_counter() - self._t0
        node = self._node
        with self._lock:
            node.nr_call += 1
            node.tot += dt
            node.tmin = min(node.tmin, dt)
            node.tmax = max(node.tmax, dt)
        self._stack().pop()
        return False

    @classmethod
    def report(cls, file=None) -> str:
        lines = []

        def walk(node: _ProfNode, depth: int):
            if depth >= 0 and node.nr_call:
                lines.append(
                    "%s%s: calls=%d tot=%.4fs min=%.4fs max=%.4fs avg=%.4fs"
                    % ("  " * depth, node.name, node.nr_call, node.tot,
                       node.tmin, node.tmax, node.tot / node.nr_call)
                )
            for c in node.children.values():
                walk(c, depth + 1)

        walk(cls._root, -1)
        text = "\n".join(lines)
        if file is not None:
            print(text, file=file)
        return text

    @classmethod
    def stats(cls, name):
        """(calls, total_seconds) summed over every node named ``name``."""
        acc = [0, 0.0]

        def walk(n):
            for c in n.children.values():
                if c.name == name:
                    acc[0] += c.nr_call
                    acc[1] += c.tot
                walk(c)

        walk(cls._root)
        return acc[0], acc[1]

    @classmethod
    def total(cls, name) -> float:
        """Sum of ``tot`` over every node named ``name`` in the tree."""
        return cls.stats(name)[1]

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._root = _ProfNode("<root>")
        cls._tls = threading.local()


class Xorshift128pRng:
    """xorshift128+ RNG (reference ``libsanm/utils.h:252-275``), used for
    deterministic test tensors independent of any framework's PRNG."""

    def __init__(self, seed: int = 42):
        # splitmix64 seeding
        s = seed & 0xFFFFFFFFFFFFFFFF
        st = []
        for _ in range(2):
            s = (s + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
            z = s
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
            st.append(z ^ (z >> 31))
        self._s = st

    def next_u64(self) -> int:
        s0, s1 = self._s
        x = s0
        y = s1
        self._s[0] = y
        x ^= (x << 23) & 0xFFFFFFFFFFFFFFFF
        self._s[1] = x ^ y ^ (x >> 17) ^ (y >> 26)
        return (self._s[1] + y) & 0xFFFFFFFFFFFFFFFF

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        return lo + (hi - lo) * (self.next_u64() >> 11) / float(1 << 53)
