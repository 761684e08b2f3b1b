"""Fault injection for the durable store's crash contract.

The durability code (blob appends, segment publishes, manifest swaps)
calls :func:`fault_point` at every point where a process kill or an I/O
error changes what recovery sees.  In production nothing is armed and the
hook is a single global read; tests arm an injector with :func:`inject`
to kill (raise :class:`CrashError`) or fail (raise an injected
``OSError``) at an exact crashpoint, then reopen the store and assert the
recovery contract.

Crashpoints are *named* and *registered* so the crash-matrix test can
enumerate every one — an unregistered ``fault_point`` call is a bug (the
matrix would silently not cover it) and raises at hook time.
"""
from __future__ import annotations

import threading


class CrashError(BaseException):
    """A simulated process kill at a crashpoint.

    Deliberately a ``BaseException``: crash simulation must not be
    swallowed by ``except Exception`` recovery/retry code paths — a real
    ``kill -9`` cannot be caught either.
    """


#: Every registered crashpoint, in write-path order.  The crash-matrix
#: test parametrizes over this tuple; keep it in sync with the
#: ``fault_point`` call sites.
CRASHPOINTS = (
    "blob.append",         # before a blob's bytes reach the file
    "blob.append.torn",    # after a PARTIAL write, before the extent records
    "blob.fsync",          # before the blob file/dir fsync
    "segment.write",       # before a segment tmp file is written
    "segment.publish",     # after the tmp write, before its os.replace
    "manifest.tmp_write",  # before the manifest tmp is written
    "manifest.replace",    # after the tmp write, before its os.replace
    "manifest.dir_fsync",  # after the manifest rename, before the dir fsync
    "compact.mid_merge",   # segments merged in RAM, before the publish
)

_ACTIVE: "FaultInjector | None" = None


class FaultInjector:
    """One armed fault: fires when ``crash_at`` is hit.

    ``after`` skips that many hits first (crash at the Nth spill, not the
    first); ``times`` bounds how often it fires (transient errors that
    succeed on retry); ``error`` substitutes an exception instance for
    the default :class:`CrashError` kill.  ``hits`` records every hit of
    the armed point — fired or not — so tests can assert the point was
    actually reached.  Thread-safe: the background compactor hits
    crashpoints from its worker thread.
    """

    def __init__(self, *, crash_at: str, after: int = 0,
                 times: int | None = None,
                 error: BaseException | None = None):
        if crash_at not in CRASHPOINTS:
            raise ValueError(f"unknown crashpoint {crash_at!r}; "
                             f"registered: {CRASHPOINTS}")
        self.crash_at = crash_at
        self.after = after
        self.times = times
        self.error = error
        self.hits: list[int] = []
        self.fired = 0
        self._lock = threading.Lock()

    def check(self, name: str) -> None:
        if name != self.crash_at:
            return
        with self._lock:
            self.hits.append(len(self.hits) + 1)
            if len(self.hits) <= self.after:
                return
            if self.times is not None and self.fired >= self.times:
                return
            self.fired += 1
            err = self.error
        if err is not None:
            raise err
        raise CrashError(f"simulated kill at crashpoint {name!r} "
                         f"(hit #{len(self.hits)})")


def install(injector: FaultInjector | None) -> None:
    global _ACTIVE
    _ACTIVE = injector


def clear() -> None:
    install(None)


class inject:
    """``with inject(crash_at="manifest.replace") as inj: ...`` arms one
    injector process-wide for the block (always disarmed on exit, even
    when the simulated crash propagates out)."""

    def __init__(self, **kw):
        self.injector = FaultInjector(**kw)

    def __enter__(self) -> FaultInjector:
        install(self.injector)
        return self.injector

    def __exit__(self, *exc) -> bool:
        clear()
        return False


def fault_point(name: str) -> None:
    """Hook a durability-critical site.  No-op unless a test armed an
    injector; asserts the name is registered so the crash matrix always
    covers every site."""
    inj = _ACTIVE
    if inj is not None:
        if name not in CRASHPOINTS:
            raise AssertionError(f"unregistered crashpoint {name!r}")
        inj.check(name)
