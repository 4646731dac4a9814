"""Replicated segment transport: the host-loss half of the durability story.

Every ``SegmentLog`` durability guarantee so far assumes the *disk*
survives — a SIGKILLed process leaves its torn tail behind and the next
locked writer repairs it.  A lost **node** (host plus its segment root) is
unrecoverable without a second copy.  This module is that second copy: a
thin length-prefixed TCP server/client pair that ships ``SegmentLog``
mutations (event/committed/DLQ segments, state-store delta logs, and the
small JSON meta files) from a partition's owner to a **replica root** — a
directory tree mirroring the primary's layout, byte for byte, on what would
be another host.

Protocol (4-byte big-endian length + JSON header, then ``dlen`` raw payload
bytes — segment data never pays JSON escaping; per-connection ordering;
acks are *cumulative*: the server applies every complete frame it has
buffered before acking, and a coalesced ack carries ``n``, the number of
frames it covers, plus the latest resulting size for that file):

* ``append {rel, off, data}`` — write ``data`` at byte ``off`` of
  ``<replica_root>/<rel>`` and truncate the file to ``off+len(data)``.
  ``off`` is the *primary's* offset for that append (serialized under the
  partition flock), so frames from different writer processes carry disjoint,
  totally-ordered ranges.  If the replica is missing bytes (``off`` past its
  EOF — a dropped frame or a fresh replica) the server NACKs with its
  current size and the client **heals**: it re-ships the gap straight from
  the shared local file, which is always authoritative.
* ``trunc {rel, size}`` — truncate (``size >= 0``) or remove (``size < 0``);
  mirrors torn-tail repair and log compaction.
* ``put {rel, data}`` — atomic whole-file replace; mirrors ``stream.json``
  and the state store's compacted JSON bases.

Acks carry the replica's resulting file size, so any successful ack is an
absolute **replication offset** — ``replica_lag()`` is simply shipped-bytes
minus acked-bytes, and a lost ack is healed by the next one.

Two client modes:

* ``sync=True`` — each ship blocks until acked (semi-sync replication).
  Deterministic, used by the chaos soaks: a replication fault surfaces at
  the exact append that triggered it.
* ``sync=False`` (default) — pipelined: ships are a single ``sendall``; a
  reader thread drains acks and heals NACKs in the background.  This is
  what keeps replication-on throughput within a few percent of
  replication-off (gated in ``scripts/perf_gate.py``).

Fault seams (``repro.chaos``): ``fault_hook("replicate.send", rel)`` fires
before a frame is shipped, ``fault_hook("replicate.ack", rel)`` before an
ack is applied — the seeded ``FaultPlan`` plugs in here.  A hook that
raises models a *lost frame/ack on the wire*: the local write already
happened and stays authoritative, the client counts the drop and moves on,
and the replica's gap NACK-heals on the next ack cycle (or an explicit
``heal_replication``).  Replication faults never crash a writer.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple


def _send_frame(sock: socket.socket, obj: Dict[str, Any],
                payload: bytes = b"") -> None:
    """Ship a frame: length-prefixed JSON header + raw payload bytes.

    The payload (segment bytes) rides OUTSIDE the JSON so it is never
    escaped/re-encoded — header carries ``dlen`` so the receiver knows how
    much to read.  One ``sendall`` keeps the frame atomic per connection."""
    if payload:
        obj = dict(obj, dlen=len(payload))
    head = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(struct.pack(">I", len(head)) + head + payload)


def _read_exact(rf, n: int) -> Optional[bytes]:
    buf = rf.read(n)
    if buf is None or len(buf) < n:
        return None
    return buf


def _recv_frame(rf) -> Optional[Dict[str, Any]]:
    """Read one frame from a buffered binary file-like (``sock.makefile``);
    a ``dlen`` header pulls that many raw payload bytes into ``data``."""
    head = _read_exact(rf, 4)
    if head is None:
        return None
    (n,) = struct.unpack(">I", head)
    body = _read_exact(rf, n)
    if body is None:
        return None
    msg = json.loads(body.decode("utf-8"))
    dlen = msg.get("dlen", 0)
    if dlen:
        payload = _read_exact(rf, dlen)
        if payload is None:
            return None
        msg["data"] = payload
    return msg


def _parse_frame(buf, pos: int, view: Optional[memoryview] = None):
    """Parse one frame starting at ``pos`` of ``buf`` (bytearray).

    Returns ``(msg, new_pos)``, or ``(None, pos)`` when the buffer holds
    only part of a frame (caller recvs more).  With ``view`` (a memoryview
    over ``buf``) the payload comes back as a zero-copy slice of it —
    valid only until the caller mutates ``buf``."""
    if len(buf) - pos < 4:
        return None, pos
    (n,) = struct.unpack_from(">I", buf, pos)
    if len(buf) - pos < 4 + n:
        return None, pos
    end = pos + 4 + n
    msg = json.loads(bytes(buf[pos + 4:end]).decode("utf-8"))
    dlen = msg.get("dlen", 0)
    if dlen:
        if len(buf) - end < dlen:
            return None, pos
        msg["data"] = (view[end:end + dlen] if view is not None
                       else bytes(buf[end:end + dlen]))
        end += dlen
    return msg, end


class ReplicaServer:
    """Accepts replication frames and applies them under a replica root.

    One thread per connection; applies are serialized by a global lock (the
    replica is a cold standby, not a serving path — correctness over
    concurrency).  ``fsync=False`` by default: the replica's job is to
    survive the *primary's* loss; its own power-loss durability can be
    turned on where it matters."""

    def __init__(self, replica_root: str, host: str = "127.0.0.1",
                 port: int = 0, fsync: bool = False) -> None:
        os.makedirs(replica_root, exist_ok=True)
        self.replica_root = os.path.abspath(replica_root)
        self.fsync = fsync
        self._lock = threading.Lock()
        self._files: Dict[str, Any] = {}
        self._sizes: Dict[str, int] = {}  # rel -> replica file size
        self._stopping = False
        self.frames = 0  # applied frames (all ops), for tests/diagnostics
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="replica-accept", daemon=True)
        self._accept_thread.start()

    # -- plumbing ------------------------------------------------------------
    def _path(self, rel: str) -> str:
        rel = os.path.normpath(rel)
        if os.path.isabs(rel) or rel.startswith(".."):
            raise ValueError("replication rel escapes the replica root: %r"
                             % rel)
        return os.path.join(self.replica_root, rel)

    def _handle(self, rel: str, path: str):
        f = self._files.get(rel)
        if f is None:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if not os.path.exists(path):
                open(path, "ab").close()
            # buffering=0: raw FileIO — appends are already batch-sized, so
            # the BufferedRandom layer would only add a copy and a flush
            # syscall per frame, and raw writes release the GIL (on one
            # core every cycle the replica burns is stolen from the owner)
            f = self._files[rel] = open(path, "r+b", buffering=0)
        return f

    def _drop_handle(self, rel: str) -> None:
        f = self._files.pop(rel, None)
        if f is not None:
            try:
                f.close()
            except OSError:  # pragma: no cover
                pass

    # -- op application ------------------------------------------------------
    def _apply(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        op = msg.get("op")
        rel = msg["rel"]
        path = self._path(rel)
        with self._lock:
            self.frames += 1
            if op == "append":
                off = int(msg["off"])
                size = self._sizes.get(rel)
                if size is None:
                    try:
                        size = os.path.getsize(path)
                    except OSError:
                        size = 0
                if off > size:
                    # missing bytes (dropped frame / fresh replica): the
                    # client heals from the authoritative local file
                    return {"ok": False, "rel": rel, "size": size}
                data = msg.get("data") or b""
                end = off + len(data)
                f = self._handle(rel, path)
                f.seek(off)
                mv = memoryview(data)
                while mv:  # raw write may be partial (signals, rlimits)
                    mv = mv[f.write(mv):]
                if size > end:  # only an overwrite-shrink needs ftruncate
                    f.truncate(end)
                if self.fsync:
                    # tfcheck: allow[lock-discipline] fsync-before-ack is the replica's durability contract; _lock serializes appliers, no consumer hot path contends
                    os.fsync(f.fileno())
                self._sizes[rel] = end
                return {"ok": True, "rel": rel, "size": end}
            if op == "trunc":
                size = int(msg["size"])
                self._drop_handle(rel)
                self._sizes.pop(rel, None)
                if size < 0:
                    try:
                        os.remove(path)
                    except OSError:
                        pass
                    return {"ok": True, "rel": rel, "size": 0}
                try:
                    cur = os.path.getsize(path)
                except OSError:
                    cur = 0
                if size < cur:
                    with open(path, "r+b") as f:
                        f.truncate(size)
                self._sizes[rel] = min(size, cur)
                return {"ok": True, "rel": rel, "size": min(size, cur)}
            if op == "put":
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = path + ".rep.tmp"
                data = msg.get("data") or b""
                with open(tmp, "wb") as f:
                    f.write(data)
                    f.flush()
                    if self.fsync:
                        # tfcheck: allow[lock-discipline] fsync-before-ack is the replica's durability contract; _lock serializes appliers, no consumer hot path contends
                        os.fsync(f.fileno())
                os.replace(tmp, path)
                self._drop_handle(rel)
                self._sizes[rel] = len(data)
                return {"ok": True, "rel": rel, "size": len(data)}
            return {"ok": False, "rel": rel, "size": 0,
                    "error": "unknown op %r" % op}

    # -- connection handling -------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # acks are tiny frames racing the client's stream: without
            # NODELAY Nagle holds them ~40ms and every drain pays it
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 name="replica-conn", daemon=True)
            t.start()

    def _serve(self, conn: socket.socket) -> None:
        # Manual receive buffer instead of makefile: applying every complete
        # frame before recv-ing again gives a natural ack-coalescing point.
        # Acks are flushed only when the input goes *idle* (a non-blocking
        # probe finds nothing queued), so a pipelined burst of appends to
        # one file costs ONE cumulative ack (``n`` = frames covered) rather
        # than one wakeup of the client's reader thread per frame — on a
        # small host that wakeup churn is the bulk of the transport's
        # overhead.  A semi-sync client ships one frame then waits, so its
        # probe is empty and it still gets a prompt per-frame ack.
        buf = bytearray(1 << 20)  # persistent: recv_into writes in place
        start = end = 0           # parse window [start, end)
        pending_ok: Dict[str, Dict[str, Any]] = {}  # rel -> cumulative ack
        pending_err: list = []
        try:
            while True:
                # zero-copy payloads: _apply consumes each slice before the
                # view is released and the window compacted
                view = memoryview(buf)[:end]
                try:
                    while True:
                        msg, start = _parse_frame(view, start, view)
                        if msg is None:
                            break
                        try:
                            ack = self._apply(msg)
                        except Exception as exc:  # noqa: BLE001 - keep serving
                            ack = {"ok": False, "rel": msg.get("rel", "?"),
                                   "size": 0, "error": repr(exc)}
                        if ack.get("ok"):
                            # per-rel cumulative: applies are in-order per
                            # rel, so the newest size subsumes the others
                            prev = pending_ok.get(ack["rel"])
                            if prev is not None:
                                ack["n"] = prev.get("n", 1) + 1
                            pending_ok[ack["rel"]] = ack
                        else:
                            pending_err.append(ack)
                finally:
                    view.release()
                if start == end:
                    start = end = 0
                elif start and len(buf) - end < (1 << 18):
                    buf[:end - start] = buf[start:end]  # memmove leftovers
                    end -= start
                    start = 0
                if len(buf) - end < (1 << 18):
                    buf.extend(bytes(max(1 << 20, len(buf))))  # grow
                try:
                    got = conn.recv_into(memoryview(buf)[end:],
                                         len(buf) - end, socket.MSG_DONTWAIT)
                except BlockingIOError:
                    if pending_ok or pending_err:
                        # one send for the whole batch of acks: ONE wakeup
                        # of the client's reader per idle point
                        out = bytearray()
                        for ack in list(pending_ok.values()) + pending_err:
                            head = json.dumps(
                                ack, separators=(",", ":")).encode("utf-8")
                            out += struct.pack(">I", len(head)) + head
                        pending_ok.clear()
                        pending_err.clear()
                        conn.sendall(out)
                    got = conn.recv_into(memoryview(buf)[end:],
                                         len(buf) - end)
                if not got:
                    return
                end += got
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass

    def sizes(self) -> Dict[str, int]:
        """Replica file sizes by rel path (diagnostics/tests)."""
        out: Dict[str, int] = {}
        for dirpath, _dirnames, filenames in os.walk(self.replica_root):
            for fn in filenames:
                p = os.path.join(dirpath, fn)
                out[os.path.relpath(p, self.replica_root)] = os.path.getsize(p)
        return out

    def close(self) -> None:
        self._stopping = True
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass
        with self._lock:
            for rel in list(self._files):
                self._drop_handle(rel)


class ReplicationClient:
    """Ships local ``SegmentLog`` mutations to a ``ReplicaServer``.

    Attach to a log with ``seg.replicator = client`` — ``SegmentLog`` then
    calls ``ship_append`` / ``ship_truncate`` / ``ship_remove`` after each
    durable local mutation.  ``replica_lag_bytes()`` is the acked
    replication offset deficit: bytes this client has shipped (or knows are
    local) minus bytes the replica has acknowledged."""

    def __init__(self, address: Tuple[str, int], primary_root: str,
                 sync: bool = False,
                 fault_hook: Optional[Callable[[str, str], None]] = None,
                 timeout: float = 10.0, prefix: str = "") -> None:
        self.address = (address[0], int(address[1]))
        self.primary_root = os.path.abspath(primary_root)
        # prefix: directory name prepended to every rel path, so several
        # primary trees (e.g. a deployment's bus/ and state/) can share one
        # replica root without colliding — the replica then mirrors the
        # whole deployment layout
        self.prefix = prefix.strip("/")
        self.sync = sync
        self.fault_hook = fault_hook
        self.timeout = timeout
        self._tx = threading.RLock()      # socket sends (and sync recv)
        self._state = threading.Lock()    # sent/acked counters
        self._cv = threading.Condition(self._state)
        self._sock: Optional[socket.socket] = None
        self._rfile = None                # buffered reader over _sock
        self._reader: Optional[threading.Thread] = None
        self._closed = False
        self.sent: Dict[str, int] = {}    # rel -> local end offset shipped
        self.acked: Dict[str, int] = {}   # rel -> replica size acked
        self._rel_cache: Dict[str, str] = {}
        self._pending = 0                 # unacked frames (async mode)
        # async mode batches frames in a local buffer and flushes in large
        # sendalls: on a small host every send wakes the replica thread, and
        # per-frame wakeups (GIL/scheduler convoy) dwarf the byte cost.  The
        # bytes are already durable locally, so a buffered frame lost with
        # the client is the same wire-loss case a dropped frame is: it shows
        # as replica lag and NACK-heals.  Flush: size/frame-count threshold,
        # a background flusher that bounds the age of the oldest buffered
        # frame (a trickle workload must not sit unreplicated until the next
        # ship), any drain(), and before a heal.
        #
        # Buffered frames stay UNSERIALIZED ([frame dict, payload] entries):
        # an append contiguous with the rel's last buffered append merges
        # into it, so a round-robin of partition segments ships a handful of
        # segment-sized frames instead of one per batch — per-frame cost
        # (header json, replica parse/apply/ack) is the transport's real
        # overhead, not the bytes.  Safe because appends to one rel carry
        # consecutive offsets and rels are independent; a put/trunc for a
        # rel breaks its merge chain (``_buf_tail``) to keep per-rel order.
        self._buf: list = []          # [frame dict, payload bytearray]
        self._buf_tail: Dict[str, list] = {}  # rel -> mergeable append entry
        self._buf_bytes = 0
        self._buf_t0 = 0.0
        self._flush_cv = threading.Condition(self._tx)
        self._flusher: Optional[threading.Thread] = None
        self.flush_bytes = 1 << 20
        self.flush_age = 0.02
        self.ships = 0
        self.errors = 0
        self.dropped = 0                  # frames/acks lost to fault_hook

    # -- wiring ---------------------------------------------------------------
    def _rel(self, path: str) -> str:
        rel = self._rel_cache.get(path)
        if rel is None:  # abspath+relpath syscall/normpath cost, paid once
            rel = os.path.relpath(os.path.abspath(path), self.primary_root)
            if self.prefix:
                rel = os.path.join(self.prefix, rel)
            self._rel_cache[path] = rel
        return rel

    def _local(self, rel: str) -> str:
        if self.prefix and rel.startswith(self.prefix + os.sep):
            rel = rel[len(self.prefix) + 1:]
        return os.path.join(self.primary_root, rel)

    def _ensure_sock(self) -> socket.socket:
        sock = self._sock
        if sock is None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.settimeout(self.timeout)
            # a send buffer comfortably above flush_bytes: a flush should be
            # one copy into the kernel, not a blocking ping-pong with the
            # replica thread every wmem-worth of bytes (sized pre-connect so
            # the window scales to it)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 21)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                sock.connect(self.address)
            except OSError:
                sock.close()
                raise
            self._sock = sock
            self._rfile = sock.makefile("rb")
            if not self.sync:
                sock.settimeout(None)  # the reader blocks across idle gaps
                self._reader = threading.Thread(
                    target=self._ack_loop, args=(sock, self._rfile),
                    name="replica-acks", daemon=True)
                self._reader.start()
        return sock

    def _drop_sock(self) -> None:
        sock, rfile = self._sock, self._rfile
        self._sock = self._rfile = None
        if sock is not None:
            # shutdown first: it unblocks a reader thread parked in
            # rfile.read() (which holds the buffer lock rfile.close() needs
            # — closing in the wrong order deadlocks against it)
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:  # pragma: no cover
                pass
        if rfile is not None:
            try:
                rfile.close()
            except (OSError, ValueError):  # pragma: no cover
                pass
        self._buf.clear()   # buffered frames are lost-on-wire: heal later
        self._buf_tail.clear()
        self._buf_bytes = 0
        with self._state:
            self._pending = 0
            self._cv.notify_all()

    # -- ack handling ---------------------------------------------------------
    def _read_gap(self, rel: str, start: int, end: int) -> bytes:
        path = self._local(rel)
        try:
            with open(path, "rb") as f:
                f.seek(start)
                return f.read(max(0, end - start))
        except OSError:
            return b""

    def _apply_ack(self, sock: socket.socket, ack: Dict[str, Any]) -> bool:
        """Record an ack; on NACK, heal the replica's gap from the local
        file (authoritative — all local writers share it).  Returns True if
        a heal frame was shipped (one more ack is in flight)."""
        if self.fault_hook is not None:
            try:
                self.fault_hook("replicate.ack", ack.get("rel", "?"))
            except Exception:  # noqa: BLE001 - injected: the ack is lost
                self.dropped += 1
                return False
        rel = ack.get("rel", "?")
        size = int(ack.get("size", 0))
        if ack.get("ok"):
            with self._state:
                if size > self.acked.get(rel, 0):
                    self.acked[rel] = size
            return False
        # NACK: replica is missing [size, sent[rel]) — re-ship it
        with self._state:
            end = self.sent.get(rel, 0)
        if end > size:
            gap = self._read_gap(rel, size, end)
            if gap:
                with self._tx:
                    # ordering: buffered frames carry older offsets — they
                    # must reach the replica before the heal bytes
                    self._flush_locked()
                    _send_frame(sock, {"op": "append", "rel": rel,
                                       "off": size}, gap)
                with self._state:
                    self._pending += 1
                return True
        return False

    def _ack_loop(self, sock: socket.socket, rfile) -> None:
        try:
            while True:
                ack = _recv_frame(rfile)
                if ack is None:
                    return
                try:
                    self._apply_ack(sock, ack)
                except Exception:  # noqa: BLE001 - injected/IO: drop the ack
                    self.errors += 1
                finally:
                    with self._state:
                        # a coalesced ack covers n frames (server batches
                        # while the pipe is busy); dropping its content
                        # loses the size update, never the accounting
                        self._pending -= int(ack.get("n", 1))
                        self._cv.notify_all()
        except OSError:
            pass

    # -- shipping -------------------------------------------------------------
    def _ship(self, frame: Dict[str, Any], rel: str,
              local_end: Optional[int], payload: bytes = b"") -> None:
        if self._closed:
            return
        if self.fault_hook is not None and frame["op"] == "append":
            try:
                self.fault_hook("replicate.send", rel)
            except Exception:  # noqa: BLE001 - injected: frame lost on wire
                self.dropped += 1
                with self._state:
                    # the bytes ARE local (the append preceded the ship), so
                    # the high-water mark advances and the deficit shows up
                    # as replica lag until a later ack NACK-heals the gap
                    if local_end is not None \
                            and local_end > self.sent.get(rel, 0):
                        self.sent[rel] = local_end
                return
        try:
            with self._tx:
                self.ships += 1
                with self._state:
                    if local_end is not None:
                        if local_end > self.sent.get(rel, 0):
                            self.sent[rel] = local_end
                    else:  # trunc/remove/put reset the high-water marks
                        self.sent.pop(rel, None)
                        self.acked.pop(rel, None)
                    if self.sync:
                        self._pending += 1
                if self.sync:
                    sock = self._ensure_sock()
                    _send_frame(sock, frame, payload)
                    outstanding = 1
                    while outstanding > 0:
                        ack = _recv_frame(self._rfile)
                        if ack is None:
                            raise ConnectionError("replica closed connection")
                        n = int(ack.get("n", 1))
                        with self._state:
                            self._pending -= n
                        outstanding -= n
                        if self._apply_ack(sock, ack):
                            outstanding += 1
                else:
                    if not self._buf:
                        self._buf_t0 = time.monotonic()
                        if self._flusher is None:
                            self._flusher = threading.Thread(
                                target=self._flush_loop,
                                name="replica-flush", daemon=True)
                            self._flusher.start()
                        self._flush_cv.notify()
                    tail = (self._buf_tail.get(rel)
                            if frame["op"] == "append" else None)
                    if (tail is not None
                            and tail[0]["off"] + len(tail[1])
                            == frame["off"]):
                        tail[1] += payload  # contiguous: extend the frame
                    elif frame["op"] == "append":
                        entry = [frame, bytearray(payload)]
                        self._buf.append(entry)
                        self._buf_tail[rel] = entry
                    else:
                        # put/trunc break the rel's merge chain (order!)
                        self._buf.append([frame, payload])
                        self._buf_tail.pop(rel, None)
                    self._buf_bytes += len(payload) + 64
                    # age is the flusher thread's job — only size/count
                    # thresholds here (no clock read on the hot path)
                    if (self._buf_bytes >= self.flush_bytes
                            or len(self._buf) >= 64):
                        self._flush_locked()
        except OSError:
            self.errors += 1
            self._drop_sock()

    def _flush_locked(self) -> None:
        """Serialize the buffered frames and send them in one sendall
        (``_tx`` held).  Pending-frame accounting happens here — a merged
        frame is ONE wire frame, acked once.  On failure the caller's
        ``_drop_sock`` clears the buffer and resets pending — partially-sent
        frames are wire losses that NACK-heal."""
        if not self._buf:
            return
        bufs = []
        n = 0
        for frame, payload in self._buf:
            if payload:
                frame = dict(frame, dlen=len(payload))
            head = json.dumps(frame, separators=(",", ":")).encode("utf-8")
            bufs.append(struct.pack(">I", len(head)) + head)
            if payload:
                bufs.append(payload)
            n += 1
        self._buf.clear()
        self._buf_tail.clear()
        self._buf_bytes = 0
        with self._state:
            self._pending += n
        sock = self._ensure_sock()
        # scatter-gather send: the kernel walks the frame list directly, no
        # flattened copy of the payload bytes.  Loop over partial sends.
        idx = off = 0
        while idx < len(bufs):
            first = bufs[idx]
            if off:
                first = memoryview(first)[off:]
            sent = sock.sendmsg([first] + bufs[idx + 1:])
            sent += off
            while idx < len(bufs) and sent >= len(bufs[idx]):
                sent -= len(bufs[idx])
                idx += 1
            off = sent

    def _flush_loop(self) -> None:
        """Background age bound: the oldest buffered frame is never more
        than ``flush_age`` from the wire, however slow the ship cadence —
        without this a trickle workload (or a shard about to be killed)
        could sit unreplicated behind the size threshold indefinitely."""
        with self._flush_cv:
            while not self._closed:
                if not self._buf:
                    self._flush_cv.wait()
                    continue
                left = self._buf_t0 + self.flush_age - time.monotonic()
                if left > 0:
                    self._flush_cv.wait(left)
                    continue
                try:
                    self._flush_locked()
                except OSError:
                    self.errors += 1
                    self._drop_sock()

    def flush(self) -> None:
        """Push buffered frames to the socket now (async mode ordering
        point).  A frame that reached the socket survives the *primary's*
        death — the replica keeps running and applies it — so ship-ordering
        across two clients (state vs bus) is established by flushing the
        first client before the second ships.  ``FileStateStore`` calls
        this after every checkpoint: the §3.4 checkpoint-before-commit
        contract must hold on the replica too, or a committed event whose
        state delta was still buffered loses its result to a host loss."""
        with self._tx:
            try:
                self._flush_locked()
            except OSError:
                self.errors += 1
                self._drop_sock()

    def ship_append(self, path: str, off: int, data) -> None:
        rel = self._rel(path)
        payload = data.encode("utf-8") if isinstance(data, str) else data
        self._ship({"op": "append", "rel": rel, "off": off},
                   rel, off + len(payload), payload)

    def ship_truncate(self, path: str, size: int) -> None:
        rel = self._rel(path)
        self._ship({"op": "trunc", "rel": rel, "size": size}, rel, None)

    def ship_remove(self, path: str) -> None:
        rel = self._rel(path)
        self._ship({"op": "trunc", "rel": rel, "size": -1}, rel, None)

    def ship_put(self, path: str, data) -> None:
        rel = self._rel(path)
        payload = data.encode("utf-8") if isinstance(data, str) else data
        self._ship({"op": "put", "rel": rel}, rel, None, payload)

    # -- lag ------------------------------------------------------------------
    def lag_by_rel(self) -> Dict[str, int]:
        """Unacked replication bytes per rel path (shipped minus acked)."""
        with self._state:
            return {rel: end - self.acked.get(rel, 0)
                    for rel, end in self.sent.items()
                    if end - self.acked.get(rel, 0) > 0}

    def replica_lag_bytes(self) -> int:
        return sum(self.lag_by_rel().values())

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until every shipped frame is acked (bounded).  Returns True
        if the pipeline drained."""
        deadline = time.monotonic() + timeout
        with self._tx:
            try:
                self._flush_locked()
            except OSError:
                self.errors += 1
                self._drop_sock()
        with self._state:
            while self._pending > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
        return True

    def close(self) -> None:
        with self._tx:
            if self._sock is not None:  # best effort; never connect to close
                try:
                    self._flush_locked()
                except OSError:  # pragma: no cover
                    pass
        self._closed = True
        self._drop_sock()
        with self._flush_cv:
            self._flush_cv.notify_all()  # let the flusher thread exit
