"""Protobuf-style RPC wire codec + offload cost hooks (paper §V-B).

A self-contained varint wire format (field numbers + wire types, nested
messages length-delimited — the Protobuf subset HyperProtoBench exercises).
``encode``/``decode`` are the functional reference; the serving front-end
uses them for request/response batches, and ``message_profile`` extracts the
(n_fields, field_bytes, nesting) statistics that drive the SimCXL NIC
pipeline timings (Fig 18 reproduction: benchmarks/paper_figs.py::fig18_rpc).

Wire types: 0 = varint (int), 2 = length-delimited (bytes / str / nested
dict).  Schema kinds on the decode side: ``'int'``, ``'bytes'``, ``'str'``
(UTF-8 decoded back to ``str``), ``'msg:<sub>'``.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

Value = Union[int, bytes, str, dict, list]


# ---------------------------------------------------------------- varint
def write_varint(out: bytearray, v: int):
    assert v >= 0
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        if pos >= len(buf):
            raise ValueError(f"truncated varint at byte {pos}")
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def varint_size(v: int) -> int:
    """Encoded length in bytes of the (already zigzagged) varint ``v``."""
    assert v >= 0
    n = 1
    while v > 0x7F:
        v >>= 7
        n += 1
    return n


def zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else v << 1


def unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


# ---------------------------------------------------------------- encode
def encode(msg: Dict[int, Value]) -> bytes:
    """msg: {field_no: value}; value = int | bytes | str | dict | list."""
    out = bytearray()
    for fno in sorted(msg):
        val = msg[fno]
        vals = val if isinstance(val, list) else [val]
        for v in vals:
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, int):
                write_varint(out, (fno << 3) | 0)
                write_varint(out, zigzag(v))
            elif isinstance(v, (bytes, str, dict)):
                payload = (v.encode() if isinstance(v, str)
                           else encode(v) if isinstance(v, dict) else v)
                write_varint(out, (fno << 3) | 2)
                write_varint(out, len(payload))
                out += payload
            else:
                raise TypeError(f"field {fno}: {type(v)}")
    return bytes(out)


def decode(buf: bytes, schema: Dict[int, str]) -> Dict[int, Value]:
    """schema: {field_no: 'int' | 'bytes' | 'str' | 'msg:<sub>'} where sub
    schemas are resolved via `schema['_subs'][name]` convention.  ``'str'``
    UTF-8 decodes the payload so str fields survive a round trip — encode
    accepts str, and without this kind decode could only hand back bytes."""
    subs = schema.get("_subs", {})
    out: Dict[int, Value] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = read_varint(buf, pos)
            val: Value = unzigzag(v)
        elif wt == 2:
            ln, pos = read_varint(buf, pos)
            if pos + ln > len(buf):
                raise ValueError(
                    f"truncated field {fno}: need {ln} bytes at {pos}, "
                    f"have {len(buf) - pos}")
            payload = buf[pos:pos + ln]
            pos += ln
            kind = schema.get(fno, "bytes")
            if isinstance(kind, str) and kind.startswith("msg:"):
                sub_schema = dict(subs[kind[4:]])
                sub_schema["_subs"] = subs
                val = decode(payload, sub_schema)
            elif kind == "str":
                val = payload.decode("utf-8")
            else:
                val = bytes(payload)
        else:
            raise ValueError(f"wire type {wt}")
        if fno in out:
            prev = out[fno]
            out[fno] = (prev if isinstance(prev, list) else [prev]) + [val]
        else:
            out[fno] = val
    return out


# ---------------------------------------------------------------- stats
def message_profile(msg: Dict[int, Value], depth: int = 1) -> dict:
    """(n_fields, payload_bytes, max_nesting) — drives the NIC timing model.

    ``payload_bytes`` counts the bytes each field's *value* occupies on the
    wire: str/bytes are their raw length and ints the exact zigzag-varint
    length (1–10 bytes) ``encode`` emits — a flat 4-bytes-per-int estimate
    would feed SimCXL a wrong ``field_bytes`` for exactly the int-heavy
    ticket/handoff shapes (see ``niccost.profile_to_bench``).  Tags and
    length prefixes are framing, not payload, and are excluded."""
    n, size, deep = 0, 0, depth
    for v in msg.values():
        vals = v if isinstance(v, list) else [v]
        for x in vals:
            n += 1
            if isinstance(x, dict):
                sub = message_profile(x, depth + 1)
                n += sub["n_fields"]
                size += sub["payload_bytes"]
                deep = max(deep, sub["nesting"])
            elif isinstance(x, str):
                size += len(x.encode())
            elif isinstance(x, bytes):
                size += len(x)
            else:
                size += varint_size(zigzag(int(x)))
    return {"n_fields": n, "payload_bytes": size, "nesting": deep}


def roundtrip_ok(msg: Dict[int, Value], schema: Dict[int, str]) -> bool:
    return decode(encode(msg), schema) == msg
