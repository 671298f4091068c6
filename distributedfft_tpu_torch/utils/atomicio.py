"""Concurrent-writer-safe file primitives for the append-only stores.

The port's copy of ``distributedfft_tpu/utils/atomicio.py``. Two stores
accumulate machine-local state across processes: the tuner's wisdom
JSONL (append-only) and the calibrated hardware profile JSON (whole
document replaced). Several ranks, benchmark workers and tournaments
write them at once, and ``open(path, "a"); f.write(...)`` gives no
interleaving guarantee: Python's buffered layer may split one line
into several ``write()`` calls, and two processes' fragments can
interleave into a torn line that the lenient loaders then drop.

- :func:`append_line` / :func:`append_lines`: ``O_APPEND`` and exactly
  one ``os.write`` per call. With ``O_APPEND`` POSIX makes the offset
  update and the write one step, so concurrent appenders' payloads
  land whole, in some order, never interleaved.
- :func:`replace_file`: a temp file in the same directory, then
  ``os.replace``, so a concurrent reader sees the old or the new
  document, never half of one.

Standard library only.
"""

from __future__ import annotations

import os

__all__ = ["append_line", "append_lines", "replace_file"]


def _ensure_parent(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def append_lines(path: str, lines: list[str]) -> None:
    """Append ``lines`` (newlines added where missing) to ``path`` as one
    ``O_APPEND`` ``os.write``: concurrent appenders can never tear or
    interleave within the payload. Creates the file (and its directory)
    on first use."""
    if not lines:
        return
    _ensure_parent(path)
    payload = "".join(
        ln if ln.endswith("\n") else ln + "\n" for ln in lines
    ).encode("utf-8")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, payload)
    finally:
        os.close(fd)


def append_line(path: str, line: str) -> None:
    """Append one line to ``path`` atomically (see :func:`append_lines`)."""
    append_lines(path, [line])


def replace_file(path: str, text: str) -> None:
    """Replace ``path``'s contents atomically: write a same-directory
    temp file, then ``os.replace``."""
    _ensure_parent(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
