"""Append-only blob files: the durable home of compressed data batches.

One ``BlobFile`` is a magic header followed by raw blobs back to back —
no in-file framing.  The (offset, length) extent of every blob lives in
the store's MANIFEST.json instead, which makes the crash contract trivial:
a torn trailing append is invisible because no manifest ever points at it,
and reopening truncates the file back to the last published extent.

The object is list-like on purpose — ``append`` / ``len`` / ``[i]`` — so
``LogStoreBase.blobs`` can be either the in-RAM ``list[bytes]`` or a
``BlobFile`` with zero call-site changes; reads are served on demand via
``os.pread`` (decompression streams from disk, nothing is resident).
"""
from __future__ import annotations

import os

from ..core.faults import fault_point
from ..core.serial import fsync_dir

MAGIC = b"DWBL0001"


class BlobFile:
    """Offset-indexed reader + appender over one append-only blob file."""

    def __init__(self, path: str, *, extents: list | None = None,
                 writable: bool = True, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self.writable = writable
        self._dir_synced = False
        self.extents: list[tuple[int, int]] = \
            [(int(o), int(n)) for o, n in (extents or [])]
        exists = os.path.exists(path)
        flags = (os.O_RDWR | os.O_CREAT) if writable else os.O_RDONLY
        self._fd = os.open(path, flags)
        if not exists:
            os.write(self._fd, MAGIC)
        elif os.pread(self._fd, len(MAGIC), 0) != MAGIC:
            os.close(self._fd)
            raise ValueError(f"{path}: bad blob-file magic")
        end = (self.extents[-1][0] + self.extents[-1][1]
               if self.extents else len(MAGIC))
        if writable and os.fstat(self._fd).st_size > end:
            # drop bytes beyond the last published extent (a torn append
            # from a crashed writer) before appending over them
            os.ftruncate(self._fd, end)
        self._end = end

    # ---------------------------------------------------------- list-like
    def append(self, blob: bytes) -> int:
        if not self.writable:
            raise ValueError(f"{self.path}: opened read-only")
        fault_point("blob.append")
        off = self._end
        try:
            fault_point("blob.append.torn")
        except BaseException:
            # leave the torn tail a real mid-write kill would: part of the
            # blob on disk, no extent recorded (reopen must truncate it)
            os.pwrite(self._fd, blob[:len(blob) // 2 + 1], off)
            raise
        os.pwrite(self._fd, blob, off)
        self._end = off + len(blob)
        self.extents.append((off, len(blob)))
        return len(self.extents) - 1

    def __len__(self) -> int:
        return len(self.extents)

    def __getitem__(self, i: int) -> bytes:
        off, n = self.extents[i]
        return os.pread(self._fd, n, off)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    # ----------------------------------------------------------- lifecycle
    def data_bytes(self) -> int:
        """Published payload bytes (excludes the magic header)."""
        return self._end - len(MAGIC)

    def sync(self) -> None:
        """Make every appended blob durable (no-op unless ``fsync``; safe
        on a closed file so ``close()`` stays idempotent).  The first sync
        also fsyncs the containing directory: file fsync does not persist
        the file's own directory entry, so without it a freshly created
        blob file can vanish entirely on power loss even though its bytes
        were synced (the manifest/segment publishes already fsync their
        directory after ``os.replace`` for the same reason)."""
        if self.fsync and self.writable and self._fd is not None:
            fault_point("blob.fsync")
            os.fsync(self._fd)
            if not self._dir_synced:
                fsync_dir(os.path.dirname(os.path.abspath(self.path)))
                self._dir_synced = True

    def close(self) -> None:
        fd = getattr(self, "_fd", None)
        if fd is not None:
            os.close(fd)
            self._fd = None

    def __del__(self):  # pragma: no cover - GC-timing dependent
        try:
            self.close()
        except OSError:
            pass
