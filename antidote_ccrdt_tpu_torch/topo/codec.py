"""Per-link delta-frame codecs: a codec byte ahead of the ETF payload.

Coded wire format (negotiated per-link via `{hello}` / `{hello_ack}`):

    frame := u32_be length ++ codec_byte ++ body
    codec_byte := 0 (raw) | 1 (zlib)

Interop with un-upgraded peers is free because the first byte of every
ETF term is the version magic 131: a length-framed payload starting with
131 is a LEGACY raw frame, 0/1 are coded frames, and nothing else is
valid. `decode_body` accepts all three, so a receiver never needs to
know what the sender negotiated; negotiation only decides what we SEND
(legacy peers must never receive a codec byte they'd feed to
`etf.decode`).

Compression is per-frame self-describing: a zlib link may still emit a
raw-tagged frame when deflate would grow it (tiny heartbeats, already-
dense blobs), so `net.codec_saved_bytes` counts only real wins. The
default policy (in the transports) is zlib on cross-zone links only —
intra-zone links are cheap, the DCN is not.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Optional

from ..core import etf

CODEC_RAW = 0
CODEC_ZLIB = 1

_ETF_MAGIC = 131  # first byte of every term_to_binary payload

# Same ceiling as bridge.protocol.MAX_FRAME — a decompressed body is
# re-checked against it so a hostile/corrupt zlib frame can't balloon.
MAX_FRAME = 256 * 1024 * 1024

# zlib level 6 is the size/speed knee; deltas are small ETF terms and
# the win comes from repeated atom/key structure, not deep entropy.
_ZLIB_LEVEL = 6


def encode_frame(payload: bytes, codec: int, metrics: Optional[Any] = None) -> bytes:
    """Length-frame `payload` (ETF bytes) under `codec`.

    CODEC_ZLIB falls back to a raw-tagged frame when compression does
    not shrink the body — the codec byte makes each frame
    self-describing, so the receiver never cares which way it went."""
    if codec == CODEC_ZLIB:
        squeezed = zlib.compress(payload, _ZLIB_LEVEL)
        if len(squeezed) < len(payload):
            if metrics is not None:
                metrics.count("net.codec_zlib_frames")
                metrics.count(
                    "net.codec_saved_bytes", len(payload) - len(squeezed)
                )
            body = bytes([CODEC_ZLIB]) + squeezed
            return struct.pack(">I", len(body)) + body
        codec = CODEC_RAW
    if codec != CODEC_RAW:
        raise ValueError(f"unknown codec {codec!r}")
    body = bytes([CODEC_RAW]) + payload
    return struct.pack(">I", len(body)) + body


def decode_body(body: bytes) -> bytes:
    """Coded (or legacy bare-ETF) frame body -> ETF payload bytes."""
    if not body:
        raise ValueError("empty frame body")
    tag = body[0]
    if tag == _ETF_MAGIC:
        return body  # legacy peer: bare ETF, no codec byte
    if tag == CODEC_RAW:
        return body[1:]
    if tag == CODEC_ZLIB:
        payload = zlib.decompress(body[1:])
        if len(payload) > MAX_FRAME:
            raise ValueError(
                f"decompressed frame of {len(payload)} bytes exceeds limit"
            )
        return payload
    raise ValueError(f"unknown frame codec byte {tag}")


def unpack_coded_frames(buf: bytearray):
    """Yield decoded terms from `buf`, consuming complete frames in
    place. Mirrors `bridge.protocol.unpack_frames` but tolerates coded
    AND legacy bodies, so one reader speaks to mixed fleets."""
    while True:
        if len(buf) < 4:
            return
        (n,) = struct.unpack(">I", bytes(buf[:4]))
        if n > MAX_FRAME:
            raise ValueError(f"frame of {n} bytes exceeds limit")
        if len(buf) < 4 + n:
            return
        with memoryview(buf) as view:
            if n > 1 and buf[4] == CODEC_RAW:
                payload = bytes(view[5 : 4 + n])  # one copy of a raw body
            else:
                payload = decode_body(bytes(view[4 : 4 + n]))
        del buf[: 4 + n]
        yield etf.decode(payload)
