"""Watch frame capture (reference pkg/authz/frames.go).

Kube JSON watch streams are newline-delimited; each complete line is one
frame whose raw bytes must be preserved for byte-exact replay.  This
generator re-chunks an arbitrary byte stream into raw frame lines,
buffering partial lines across chunks (the mutex-guarded capture window in
the reference becomes plain sequential buffering here).
"""

from __future__ import annotations

from typing import AsyncIterator


async def frame_lines(stream: AsyncIterator[bytes]) -> AsyncIterator[bytes]:
    buf = bytearray()
    async for chunk in stream:
        buf.extend(chunk)
        while True:
            idx = buf.find(b"\n")
            if idx < 0:
                break
            frame = bytes(buf[: idx + 1])
            del buf[: idx + 1]
            yield frame
    if buf:
        yield bytes(buf)


# largest accepted watch frame: a corrupt/desynchronized length prefix must
# fail fast, not buffer the rest of the stream (the real apiserver caps
# request/response object sizes well below this)
MAX_WATCH_FRAME = 16 << 20


async def frame_length_delimited(
        stream: AsyncIterator[bytes]) -> AsyncIterator[bytes]:
    """k8s protobuf watch framing: 4-byte big-endian length + payload
    (k8s.io/apimachinery/pkg/util/framer).  Yields raw frames INCLUDING the
    length prefix so allowed frames replay byte-exactly.  A truncated
    trailing frame (stream ended mid-frame) is dropped, never relayed; a
    length prefix beyond MAX_WATCH_FRAME terminates the stream with an
    error log (fail fast, bounded memory)."""
    buf = bytearray()
    async for chunk in stream:
        buf.extend(chunk)
        while len(buf) >= 4:
            ln = int.from_bytes(buf[:4], "big")
            if ln > MAX_WATCH_FRAME:
                import logging
                logging.getLogger(__name__).error(
                    "watch frame length %d exceeds cap %d — corrupt or "
                    "desynchronized stream; terminating watch", ln,
                    MAX_WATCH_FRAME)
                return
            if len(buf) < 4 + ln:
                break
            yield bytes(buf[: 4 + ln])
            del buf[: 4 + ln]
