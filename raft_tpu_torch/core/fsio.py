"""Crash-safe file writes (counterpart of ``raft_tpu/core/fsio.py``).

:func:`atomic_write` is the contract every artifact of the port uses:

    tmp file in the same directory  →  write  →  flush + fsync  →
    ``os.replace`` onto the target

so a crash at any point leaves either the previous file or the complete
new one, never a torn one. Stdlib only.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile

# per-process uniquifier for atomic_replace tmp names (mkstemp covers
# atomic_write): pid + counter keeps processes and threads from sharing one
_COUNTER = itertools.count()


def _prepare(path) -> str:
    path = os.fspath(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return path


@contextlib.contextmanager
def atomic_write(path, mode: str = "wb"):
    """Context manager yielding a stream whose contents replace ``path``
    atomically on clean exit (unique tmp + flush + fsync + ``os.replace``).
    On any exception the tmp file is removed and ``path`` is untouched.

    The tmp file sits next to the target, so the rename never crosses a
    filesystem, and concurrent writers to one target never share a tmp:
    the last ``os.replace`` wins, each result complete."""
    path = _prepare(path)
    if "r" in mode or "+" in mode or "a" in mode:
        raise ValueError(f"atomic_write is write-only, got mode {mode!r}")
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".",
        prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        # mkstemp creates 0600; match open()'s umask-honouring default
        os.chmod(tmp, 0o666 & ~_umask())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _umask() -> int:
    """The process umask (read-modify-write: stdlib offers no getter)."""
    cur = os.umask(0o022)
    os.umask(cur)
    return cur


def atomic_replace(path, producer) -> None:
    """Call ``producer(tmp_path)`` to write the new contents at a unique
    tmp path, then rename it onto ``path`` atomically — for writers that
    own the file themselves. ``producer`` must have closed and synced the
    file before returning."""
    path = _prepare(path)
    tmp = f"{path}.{os.getpid()}.{next(_COUNTER)}.tmp"
    try:
        producer(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
