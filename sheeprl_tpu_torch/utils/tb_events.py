"""TensorBoard event files, written and read without tensorboardX or
protobuf (the JAX package logs through tensorboardX's ``SummaryWriter``;
the port's card has neither package).

A file ``events.out.tfevents.<unix seconds>.<host>`` is a sequence of
TFRecords, each ``uint64 length | uint32 masked_crc32c(length) | data |
uint32 masked_crc32c(data)`` (little-endian), where ``data`` is one
serialized ``tensorflow.Event``. The first event carries
``file_version = "brain.Event:2"``; a scalar is an event with a ``Summary``
of one ``Value{tag, simple_value}``; a text is a ``Value`` whose tag ends in
``/text_summary``, with the ``text`` plugin's metadata and a ``DT_STRING``
tensor of shape ``[1]``, as tensorboardX's ``add_text`` writes it. Every
protobuf field is encoded here by hand, in field-number order (what
``SerializeToString`` gives), and crc32c (Castagnoli) runs over a 256-entry
table.

Field numbers used (``tensorboard/compat/proto``): ``Event``: wall_time 1
(double), step 2 (int64), file_version 3 (string), summary 5;
``Summary``: value 1; ``Summary.Value``: tag 1, simple_value 2 (float),
tensor 8, metadata 9; ``SummaryMetadata``: plugin_data 1;
``PluginData``: plugin_name 1; ``TensorProto``: dtype 1 (``DT_STRING`` =
7), tensor_shape 2, string_val 8; ``TensorShapeProto``: dim 2;
``Dim``: size 1.
"""

from __future__ import annotations

import os
import re
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["EventFileWriter", "crc32c", "masked_crc32c", "read_events"]

_POLY = 0x82F63B78  # Castagnoli, reflected


def _table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord checksum: the crc rotated right by 15 bits plus a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf encoding -----------------------------------------------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 negatives as their two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, **what: bytes) -> bytes:
    """``Event``: proto3 leaves a zero step out."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(step)
    if "file_version" in what:
        out += _bytes_field(3, what["file_version"])
    if "summary" in what:
        out += _bytes_field(5, what["summary"])
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    return _bytes_field(1, tag.encode()) + _key(2, 5) + struct.pack("<f", value)


def _text_value(tag: str, text: str) -> bytes:
    metadata = _bytes_field(1, _bytes_field(1, b"text"))  # plugin_data{plugin_name: "text"}
    shape = _bytes_field(2, _key(1, 0) + _varint(1))  # dim{size: 1}
    tensor = _key(1, 0) + _varint(7) + _bytes_field(2, shape) + _bytes_field(8, text.encode("utf-8"))
    return _bytes_field(1, f"{tag}/text_summary".encode()) + _bytes_field(8, tensor) + _bytes_field(9, metadata)


_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def _clean_tag(name: str) -> str:
    """tensorboardX's tag rule: characters outside ``[-/\\w.]`` become ``_``,
    leading slashes go."""
    return _INVALID_TAG_CHARACTERS.sub("_", name).lstrip("/")


class EventFileWriter:
    """One event file in ``log_dir``, appended to under a lock and flushed
    on :meth:`flush` and :meth:`close`."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{str(now)[:10]}.{socket.gethostname()}{filename_suffix}"
        )
        self._lock = threading.Lock()
        self._file = open(self.path, "wb")
        self._write(_event(now, 0, file_version=b"brain.Event:2"))

    def _write(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        record = header + struct.pack("<I", masked_crc32c(header)) + data + struct.pack("<I", masked_crc32c(data))
        with self._lock:
            self._file.write(record)

    def add_scalar(self, tag: str, value: float, step: Optional[int] = None, walltime: Optional[float] = None):
        summary = _bytes_field(1, _scalar_value(_clean_tag(tag), float(value)))
        self._write(_event(time.time() if walltime is None else walltime, int(step or 0), summary=summary))

    def add_text(self, tag: str, text: str, step: Optional[int] = None, walltime: Optional[float] = None):
        summary = _bytes_field(1, _text_value(tag, text))
        self._write(_event(time.time() if walltime is None else walltime, int(step or 0), summary=summary))

    def flush(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.flush()

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.close()


# -- reading ---------------------------------------------------------------


def _fields(buf: bytes) -> List[tuple]:
    """``(field, wire, value)`` of one message: varints as ints, fixed64 and
    fixed32 as their 8 or 4 bytes, length-delimited fields as bytes."""
    out, i = [], 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i : i + 8], i + 8
        elif wire == 5:
            value, i = buf[i : i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i : i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        out.append((field, wire, value))
    return out


def _read_varint(buf: bytes, i: int):
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return result, i


def _decode_value(buf: bytes) -> Dict[str, Any]:
    value: Dict[str, Any] = {}
    for field, _wire, v in _fields(buf):
        if field == 1:
            value["tag"] = v.decode()
        elif field == 2:
            value["simple_value"] = struct.unpack("<f", v)[0]
        elif field == 8:
            value["string_val"] = [s.decode("utf-8") for f, _w, s in _fields(v) if f == 8]
        elif field == 9:
            plugin = [p for f, _w, p in _fields(v) if f == 1]
            if plugin:
                value["plugin_name"] = next((n.decode() for f, _w, n in _fields(plugin[0]) if f == 1), "")
    return value


def read_events(path: str) -> List[Dict[str, Any]]:
    """Every event of the file ``path`` as ``{"wall_time", "step",
    "file_version" or "values"}``; raises on a torn record or a checksum
    that does not match."""
    events = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        if len(data) - i < 12:
            raise ValueError(f"{path}: torn record header at byte {i}")
        header = data[i : i + 8]
        (length,) = struct.unpack("<Q", header)
        (header_crc,) = struct.unpack("<I", data[i + 8 : i + 12])
        body = data[i + 12 : i + 12 + length]
        if header_crc != masked_crc32c(header) or len(body) != length or len(data) < i + 16 + length:
            raise ValueError(f"{path}: torn or corrupted record at byte {i}")
        (body_crc,) = struct.unpack("<I", data[i + 12 + length : i + 16 + length])
        if body_crc != masked_crc32c(body):
            raise ValueError(f"{path}: data checksum mismatch at byte {i}")
        i += 16 + length
        event: Dict[str, Any] = {"step": 0}
        for field, _wire, v in _fields(body):
            if field == 1:
                event["wall_time"] = struct.unpack("<d", v)[0]
            elif field == 2:
                event["step"] = v - (1 << 64) if v >= 1 << 63 else v
            elif field == 3:
                event["file_version"] = v.decode()
            elif field == 5:
                event["values"] = [_decode_value(val) for f, _w, val in _fields(v) if f == 1]
        events.append(event)
    return events
