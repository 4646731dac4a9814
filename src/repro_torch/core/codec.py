"""One event codec for the whole bus: TFB1 binary record framing, the
columnar batch frame, and the single CloudEvent (de)serialization
implementation.

Three layers, bottom-up:

* **Record framing** — ``encode_record`` / ``scan_records``.  A record is
  ``varint(len(payload)) + crc32(payload) + payload``; a segment file in
  binary mode starts with the 5-byte ``MAGIC`` (``TFB1\\x00`` — the NUL
  guarantees no collision with a JSON/text v1 line).  ``scan_records``
  consumes only whole, crc-valid records and reports the byte offset
  after the last one, so a torn tail (truncation at *any* byte offset)
  is recovered as exactly the prefix of whole records: a cut payload
  fails the length check, a cut length/crc header fails the varint or
  bounds check, and a corrupted payload fails crc.

* **Columnar frames** — ``encode_frame_payload`` packs a batch of events
  into one payload holding *columns* (one interned string table for
  subject/type/source/specversion, index arrays, an id blob, tagged
  time/data/ext columns) instead of per-event dicts.
  ``decode_frame_payload`` returns an :class:`EventColumns` view whose
  columns feed ``VectorJoinPlane.triage`` directly; per-event
  ``CloudEvent`` objects are materialized lazily and only when a
  consumer actually needs them.  The payload's first byte is NUL
  (``FRAME_TAG``) so ``decode_payload`` can tell a columnar frame from
  a JSON payload without trying to parse it.

* **Event codec** — ``event_to_dict`` / ``event_from_dict`` /
  ``event_to_json`` / ``event_from_json`` are the *only* encode and
  decode implementations for ``CloudEvent``; ``repro.core.events`` binds
  them as the class's methods at import time via :func:`_install`
  (codec never imports events — that would be circular).
"""
from __future__ import annotations

import json
import struct
import sys
import zlib
from array import array
from typing import Any, Dict, Iterable, List, Optional, Tuple

# ---------------------------------------------------------------------------
# record framing

MAGIC = b"TFB1\x00"
FRAME_TAG = b"\x00C"  # columnar frame payloads start with NUL + 'C'

_CRC = struct.Struct("<I")


def encode_varint(n: int) -> bytes:
    """LEB128 unsigned varint."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _decode_varint(buf: bytes, o: int, end: int) -> Tuple[Optional[int], int]:
    """Decode one varint at ``o``; ``(None, o)`` if torn or overlong."""
    shift = 0
    n = 0
    start = o
    while o < end:
        b = buf[o]
        o += 1
        n |= (b & 0x7F) << shift
        if not (b & 0x80):
            return n, o
        shift += 7
        if shift > 35:  # >5 bytes cannot be a sane record length
            return None, start
    return None, start


def encode_record(payload: bytes) -> bytes:
    """Frame one payload: varint length + crc32 + payload bytes."""
    return (encode_varint(len(payload))
            + _CRC.pack(zlib.crc32(payload) & 0xFFFFFFFF) + payload)


def encode_records(payloads: Iterable[bytes]) -> bytes:
    return b"".join(encode_record(p) for p in payloads)


def iter_records(buf: bytes, offset: int = 0):
    """Yield ``(payload, end_offset)`` for each whole crc-valid record
    from ``offset``; stop (without advancing) at the first torn or
    corrupt record — a cut payload fails the bounds check, a cut
    length/crc header fails the varint or bounds check, a flipped byte
    fails crc."""
    o = offset
    end = len(buf)
    while o < end:
        n, h = _decode_varint(buf, o, end)
        if n is None or h + 4 + n > end:
            return
        payload = buf[h + 4:h + 4 + n]
        if zlib.crc32(payload) & 0xFFFFFFFF != _CRC.unpack_from(buf, h)[0]:
            return
        o = h + 4 + n
        yield payload, o


def scan_records(buf: bytes, offset: int = 0) -> Tuple[List[bytes], int]:
    """Consume whole valid records from ``offset``.

    Returns ``(payloads, valid_end)`` where ``valid_end`` is the offset
    just past the last whole crc-valid record.  Stops (without
    advancing) at the first torn or corrupt record, mirroring the
    text-mode torn-tail contract of ``SegmentLog.scan``.
    """
    payloads: List[bytes] = []
    o = offset
    for payload, o in iter_records(buf, offset):
        payloads.append(payload)
    return payloads, o


# ---------------------------------------------------------------------------
# the one CloudEvent (de)serialization implementation
#
# ``repro.core.events`` calls ``_install(CloudEvent)`` at import time and
# binds these functions as the class's to_dict/to_json/from_dict/from_json,
# so every surface — per-event, batch line, columnar frame — shares exactly
# one encode and one decode.

_CloudEvent: Any = None
_TYPE_DEFAULT = "event.triggerflow.termination.success"
_SOURCE_DEFAULT = "triggerflow"
_SPECVERSION = "1.0"


def _install(cls: type) -> None:
    global _CloudEvent, _TYPE_DEFAULT, _SOURCE_DEFAULT, _SPECVERSION
    _CloudEvent = cls
    fields = cls.__dataclass_fields__
    _TYPE_DEFAULT = fields["type"].default
    _SOURCE_DEFAULT = fields["source"].default
    _SPECVERSION = fields["specversion"].default


def event_to_dict(ev) -> Dict[str, Any]:
    d = {
        "specversion": ev.specversion,
        "id": ev.id,
        "source": ev.source,
        "subject": ev.subject,
        "type": ev.type,
        "time": ev.time,
        "data": ev.data,
    }
    if ev.ext is not None:
        d["ext"] = ev.ext
    return d


def event_to_json(ev) -> str:
    return json.dumps(event_to_dict(ev), separators=(",", ":"))


def event_from_dict(d: Dict[str, Any]):
    # Deserialization is the file-bus consumer's per-event floor, so it
    # bypasses the frozen-dataclass __init__ (~4x): build the instance
    # directly in __dict__ (writes don't go through __setattr__).
    ev = object.__new__(_CloudEvent)
    ev.__dict__.update({
        "subject": d["subject"],
        "type": d.get("type", _TYPE_DEFAULT),
        "data": d.get("data"),
        "source": d.get("source", _SOURCE_DEFAULT),
        "id": d["id"],
        "time": d.get("time"),
        "specversion": d.get("specversion", _SPECVERSION),
        "ext": d.get("ext"),
    })
    return ev


def event_from_json(s: str):
    return event_from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# columnar frames

_SEP = "\x1f"
_HDR = struct.Struct("<I")
_F64 = struct.Struct("<d")

# time column tags
_T_NONE = 0      # every event's time is None
_T_SAME = 1      # one shared float (the common stamp_publish_time batch)
_T_JSON = 2      # JSON list fallback (mixed / per-event times)
# data column tags
_D_RESULT = 1    # every data is exactly {"result": v}: store the v scalars
_D_JSON = 2      # JSON list of the raw data objects
# id blob tags
_I_SEP = 0       # \x1f-joined utf-8 (no id contains \x1f)
_I_JSON = 1      # JSON list fallback
# ext column tags
_E_NONE = 0      # every ext is None (the common untraced batch)
_E_JSON = 1      # JSON list of ext dicts / nulls


def _pack_str(s: bytes) -> bytes:
    return encode_varint(len(s)) + s


class _Cursor:
    __slots__ = ("buf", "o")

    def __init__(self, buf: bytes, o: int):
        self.buf = buf
        self.o = o

    def varint(self) -> int:
        n, self.o = _decode_varint(self.buf, self.o, len(self.buf))
        if n is None:
            raise ValueError("torn frame varint")
        return n

    def take(self, n: int) -> bytes:
        b = self.buf[self.o:self.o + n]
        if len(b) != n:
            raise ValueError("torn frame blob")
        self.o += n
        return b

    def byte(self) -> int:
        if self.o >= len(self.buf):
            raise ValueError("torn frame byte")
        b = self.buf[self.o]
        self.o += 1
        return b


def encode_frame_payload(events) -> bytes:
    """Pack a batch of CloudEvents into one columnar frame payload."""
    n = len(events)
    parts: List[bytes] = [FRAME_TAG, encode_varint(n)]
    if n == 0:
        return b"".join(parts)

    # one interned string table for the four low-cardinality columns
    table: Dict[Any, int] = {}

    def intern(s) -> int:
        i = table.get(s)
        if i is None:
            i = table[s] = len(table)
        return i

    subj = [intern(e.subject) for e in events]
    typ = [intern(e.type) for e in events]
    src = [intern(e.source) for e in events]
    spec = [intern(e.specversion) for e in events]
    tab_blob = json.dumps(list(table), separators=(",", ":")).encode("utf-8")
    parts.append(_pack_str(tab_blob))

    if len(table) <= 0xFF:
        parts.append(b"\x01")
        parts.append(bytes(subj))
        parts.append(bytes(typ))
        parts.append(bytes(src))
        parts.append(bytes(spec))
    else:
        # 2-byte indices up to 65535 interned strings, 4-byte beyond —
        # a pathological batch with huge subject/type cardinality still
        # encodes instead of overflowing array("H")
        code = "H" if len(table) <= 0xFFFF else "I"
        parts.append(b"\x02" if code == "H" else b"\x04")
        for col in (subj, typ, src, spec):
            a = array(code, col)
            if sys.byteorder != "little":
                a.byteswap()
            parts.append(a.tobytes())

    ids = [e.id for e in events]
    if any(type(i) is not str or _SEP in i for i in ids):
        parts.append(bytes((_I_JSON,)))
        parts.append(_pack_str(
            json.dumps(ids, separators=(",", ":")).encode("utf-8")))
    else:
        parts.append(bytes((_I_SEP,)))
        parts.append(_pack_str(_SEP.join(ids).encode("utf-8")))

    t0 = events[0].time
    if all(e.time is None for e in events):
        parts.append(bytes((_T_NONE,)))
    elif type(t0) is float and all(e.time == t0 for e in events):
        parts.append(bytes((_T_SAME,)))
        parts.append(_F64.pack(t0))
    else:
        parts.append(bytes((_T_JSON,)))
        parts.append(_pack_str(json.dumps(
            [e.time for e in events], separators=(",", ":")).encode("utf-8")))

    results: List[Any] = []
    for e in events:
        data = e.data
        if type(data) is dict and len(data) == 1 and "result" in data:
            results.append(data["result"])
        else:
            results = None  # type: ignore[assignment]
            break
    if results is not None:
        parts.append(bytes((_D_RESULT,)))
        parts.append(_pack_str(
            json.dumps(results, separators=(",", ":")).encode("utf-8")))
    else:
        parts.append(bytes((_D_JSON,)))
        parts.append(_pack_str(json.dumps(
            [e.data for e in events], separators=(",", ":")).encode("utf-8")))

    if all(e.ext is None for e in events):
        parts.append(bytes((_E_NONE,)))
    else:
        parts.append(bytes((_E_JSON,)))
        parts.append(_pack_str(json.dumps(
            [e.ext for e in events], separators=(",", ":")).encode("utf-8")))

    return b"".join(parts)


def decode_frame_payload(payload: bytes) -> "EventColumns":
    """Decode one columnar frame payload into an :class:`EventColumns`."""
    if payload[:2] != FRAME_TAG:
        raise ValueError("not a columnar frame payload")
    cur = _Cursor(payload, 2)
    n = cur.varint()
    cols = EventColumns.__new__(EventColumns)
    if n == 0:
        cols._init_empty()
        return cols

    table = json.loads(cur.take(cur.varint()))
    width = cur.byte()
    if width == 1:
        subj_i: Any = cur.take(n)
        typ_i: Any = cur.take(n)
        src_i: Any = cur.take(n)
        spec_i: Any = cur.take(n)
    elif width in (2, 4):
        code = "H" if width == 2 else "I"

        def uint(blob: bytes) -> array:
            a = array(code)
            a.frombytes(blob)
            if sys.byteorder != "little":
                a.byteswap()
            return a
        subj_i = uint(cur.take(width * n))
        typ_i = uint(cur.take(width * n))
        src_i = uint(cur.take(width * n))
        spec_i = uint(cur.take(width * n))
    else:
        raise ValueError("unknown frame index width %d" % width)

    itag = cur.byte()
    blob = cur.take(cur.varint())
    if itag == _I_SEP:
        ids = blob.decode("utf-8").split(_SEP)
    else:
        ids = json.loads(blob)

    ttag = cur.byte()
    tval: Any = None
    if ttag == _T_SAME:
        tval = _F64.unpack(cur.take(8))[0]
    elif ttag == _T_JSON:
        tval = json.loads(cur.take(cur.varint()))

    dtag = cur.byte()
    data_col = json.loads(cur.take(cur.varint()))

    etag = cur.byte()
    ext_col = json.loads(cur.take(cur.varint())) if etag == _E_JSON else None

    cols.ids = ids
    cols.subjects = [table[i] for i in subj_i]
    cols.types = [table[i] for i in typ_i]
    cols.sources = [table[i] for i in src_i]
    cols.specversions = [table[i] for i in spec_i]
    cols._time_tag = ttag
    cols._time_val = tval
    cols._data_tag = dtag
    cols._data_col = data_col
    cols._ext_col = ext_col
    cols._events = None
    return cols


class EventColumns:
    """Columnar view over a decoded event batch.

    ``subjects`` / ``types`` / ``ids`` and :meth:`results` are plain
    parallel lists the counting planes consume directly — no per-event
    objects exist until :meth:`events` (or indexing) materializes them,
    and that materialization is cached.
    """

    __slots__ = ("ids", "subjects", "types", "sources", "specversions",
                 "_time_tag", "_time_val", "_data_tag", "_data_col",
                 "_ext_col", "_events")

    def __init__(self, events=None):
        if events is None:
            self._init_empty()
        else:
            self._init_from_events(list(events))

    def _init_empty(self) -> None:
        self.ids = []
        self.subjects = []
        self.types = []
        self.sources = []
        self.specversions = []
        self._time_tag = _T_NONE
        self._time_val = None
        self._data_tag = _D_JSON
        self._data_col = []
        self._ext_col = None
        self._events = []

    def _init_from_events(self, events) -> None:
        self.ids = [e.id for e in events]
        self.subjects = [e.subject for e in events]
        self.types = [e.type for e in events]
        self.sources = [e.source for e in events]
        self.specversions = [e.specversion for e in events]
        self._time_tag = _T_JSON
        self._time_val = [e.time for e in events]
        self._data_tag = _D_JSON
        self._data_col = [e.data for e in events]
        exts = [e.ext for e in events]
        self._ext_col = exts if any(x is not None for x in exts) else None
        self._events = events

    @classmethod
    def from_events(cls, events) -> "EventColumns":
        if isinstance(events, cls):
            return events
        return cls(events)

    def __len__(self) -> int:
        return len(self.ids)

    def results(self) -> List[Any]:
        """Per-event result values, matching ``conditions._result_of``:
        ``data["result"]`` when data is a dict carrying one, else data
        itself.  Always a fresh list the caller owns — on a ``_D_RESULT``
        frame a flat copy of the stored scalar column (no per-event work;
        handing out the cached column by reference would let a mutating
        caller corrupt what ``data_at``/``events`` later read)."""
        if self._data_tag == _D_RESULT:
            return list(self._data_col)
        return [d["result"] if isinstance(d, dict) and "result" in d else d
                for d in self._data_col]

    def time_at(self, i: int):
        if self._time_tag == _T_NONE:
            return None
        if self._time_tag == _T_SAME:
            return self._time_val
        return self._time_val[i]

    def data_at(self, i: int):
        if self._data_tag == _D_RESULT:
            return {"result": self._data_col[i]}
        return self._data_col[i]

    def ext_at(self, i: int):
        return None if self._ext_col is None else self._ext_col[i]

    def events(self) -> list:
        """Materialize (once) the per-event CloudEvent objects."""
        if self._events is None:
            tag = self._data_tag
            data_col = self._data_col
            ext_col = self._ext_col
            ids = self.ids
            subjects = self.subjects
            types = self.types
            sources = self.sources
            specs = self.specversions
            new = object.__new__
            cls = _CloudEvent
            out = []
            for i in range(len(ids)):
                ev = new(cls)
                ev.__dict__.update({
                    "subject": subjects[i],
                    "type": types[i],
                    "data": ({"result": data_col[i]} if tag == _D_RESULT
                             else data_col[i]),
                    "source": sources[i],
                    "id": ids[i],
                    "time": self.time_at(i),
                    "specversion": specs[i],
                    "ext": None if ext_col is None else ext_col[i],
                })
                out.append(ev)
            self._events = out
        return self._events

    def __getitem__(self, i):
        return self.events()[i]

    def __iter__(self):
        return iter(self.events())


# ---------------------------------------------------------------------------
# payload-level helpers shared by the stores

def decode_payload(payload):
    """Decode one record payload: a columnar frame (NUL-tagged bytes)
    becomes an :class:`EventColumns`; anything else is JSON (bytes or
    str) and decodes to the raw JSON value."""
    if isinstance(payload, (bytes, bytearray)) and payload[:1] == b"\x00":
        return decode_frame_payload(bytes(payload))
    return json.loads(payload)


def events_of(obj) -> list:
    """Normalize a decoded payload to a list of CloudEvents: a columnar
    frame materializes, a JSON array maps per element, a single JSON
    object becomes a one-event list."""
    if isinstance(obj, EventColumns):
        return obj.events()
    if isinstance(obj, list):
        return [event_from_dict(d) for d in obj]
    return [event_from_dict(obj)]
