"""TCP streaming-recognition server and client over the slot-batched
engine (port of mamba_asr_tpu/serving/server.py; the same wire protocol,
so either package's client talks to either package's server).

Frames, both ways: an 8-byte big-endian header `(json_len: u32,
bin_len: u32)`, then json_len bytes of UTF-8 JSON and bin_len bytes of
payload (float32 mono PCM at the model's sample rate).

Client -> server:
  {"op": "start"}                  -> {"event": "started", "sid": N}
                                      ({"event": "error", ...} when full)
  {"op": "audio", "sid": N} + PCM  -> buffered; ids stream back
  {"op": "end", "sid": N[, "timestamps": true]}
                                   -> {"event": "tokens", ..., "final": true}
  {"op": "stats"}                  -> {"event": "stats", "stats": {...}}

Server -> client:
  {"event": "tokens", "sid": N, "ids": [...], "final": bool}: partial ids
  as the engine ticks; the final frame adds "ids_final" (the engine's
  final pass), "text" (with a tokenizer) and "words" (timestamps, with a
  tokenizer and a final pass).
  {"event": "endpoint", "sid": N, "silence_s": s}: once per trailing
  silence run longer than the server's threshold (re-armed by new ids).

The engine is driven by one lock: a tick thread advances every ready
stream, and one thread per client serves its requests. A client that
disconnects has its streams aborted (no flush). This module needs numpy
and the standard library only: `StreamingClient` runs without PyTorch.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

_HEADER = struct.Struct(">II")


def send_frame(sock: socket.socket, obj: dict, payload: bytes = b"") -> None:
    body = json.dumps(obj).encode("utf-8")
    sock.sendall(_HEADER.pack(len(body), len(payload)) + body + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None
        buf += part
    return buf


def recv_frame(sock: socket.socket) -> Optional[Tuple[dict, bytes]]:
    head = _recv_exact(sock, _HEADER.size)
    if head is None:
        return None
    jlen, blen = _HEADER.unpack(head)
    body = _recv_exact(sock, jlen)
    if body is None:
        return None
    payload = _recv_exact(sock, blen) if blen else b""
    if blen and payload is None:
        return None
    return json.loads(body.decode("utf-8")), payload


class AsrTcpServer:
    """Serve a `serving.engine.StreamingServer` over TCP. port 0 picks a
    free port (read `self.port`). endpoint_silence_s > 0 turns on endpoint
    events."""

    def __init__(self, engine, tokenizer=None, host: str = "127.0.0.1", port: int = 0,
                 tick_idle_s: float = 0.002, endpoint_silence_s: float = 0.0):
        self.engine = engine
        self.tokenizer = tokenizer
        self.tick_idle_s = tick_idle_s
        self.endpoint_silence_s = endpoint_silence_s
        self._endpoint_sent: Dict[int, bool] = {}
        self._lock = threading.Lock()
        self._conn_of_sid: Dict[int, socket.socket] = {}
        self._ids_of_sid: Dict[int, List[int]] = {}
        self._send_locks: Dict[socket.socket, threading.Lock] = {}
        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._running = False
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self._running = True
        for fn in (self._accept_loop, self._tick_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Stop the threads: shutdown() wakes the accept and the client
        reads (close() alone leaves a thread parked in its syscall)."""
        self._running = False
        for sock in [self._listener, *self._send_locks.copy()]:
            for fn in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    fn()
                except OSError:
                    pass
        for t in self._threads:
            t.join(timeout=5)

    # -- internals -----------------------------------------------------
    def _send(self, conn: socket.socket, obj: dict) -> None:
        lock = self._send_locks.setdefault(conn, threading.Lock())
        try:
            with lock:
                send_frame(conn, obj)
        except OSError:
            pass  # the client went away; its reader thread cleans up

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(target=self._client_loop, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _tick_loop(self) -> None:
        while self._running:
            # The tick holds the engine lock while it sends, so an "end"
            # (which takes the lock too) cannot send its final frame ahead
            # of this tick's partials on the same connection.
            with self._lock:
                ready = self.engine.ready_slots()
                emitted = self.engine.tick() if ready else {}
                for sid, ids in emitted.items():
                    self._ids_of_sid.setdefault(sid, []).extend(ids)
                    if ids:
                        self._endpoint_sent[sid] = False  # re-arm
                    conn = self._conn_of_sid.get(sid)
                    if conn is not None and ids:
                        self._send(conn, {"event": "tokens", "sid": sid, "ids": ids,
                                          "final": False})
                if self.endpoint_silence_s > 0 and ready:
                    for sid, conn in list(self._conn_of_sid.items()):
                        if self._endpoint_sent.get(sid):
                            continue
                        try:
                            sil = self.engine.trailing_silence_s(sid)
                        except KeyError:
                            continue  # finished meanwhile
                        if sil >= self.endpoint_silence_s:
                            self._endpoint_sent[sid] = True
                            self._send(conn, {"event": "endpoint", "sid": sid,
                                              "silence_s": round(sil, 3)})
            if not ready:
                time.sleep(self.tick_idle_s)

    def _end(self, conn: socket.socket, msg: dict, sids_here: List[int]) -> None:
        sid = msg["sid"]
        final_ids = spans = None
        has_final = self.engine.final_decode is not None
        want_times = bool(msg.get("timestamps")) and has_final
        with self._lock:
            if want_times:
                tail, final_ids, spans = self.engine.finish_final(sid, want_times=True)
            elif has_final:
                tail, final_ids = self.engine.finish_final(sid)
            else:
                tail = self.engine.finish(sid)
            all_ids = self._ids_of_sid.pop(sid, []) + tail
        self._conn_of_sid.pop(sid, None)
        self._endpoint_sent.pop(sid, None)
        if sid in sids_here:
            sids_here.remove(sid)
        out = {"event": "tokens", "sid": sid, "ids": tail, "final": True}
        if final_ids is not None:
            out["ids_final"] = final_ids  # supersedes the greedy partials
        if self.tokenizer is not None:
            out["text"] = self.tokenizer.decode(final_ids if final_ids is not None
                                                else all_ids)
        if spans is not None and self.tokenizer is not None:
            from mamba_asr_torch.decoding.timestamps import word_timestamps

            out["words"] = [list(w) for w in word_timestamps(
                [sp[0] for sp in spans], [sp[1] for sp in spans], [sp[2] for sp in spans],
                self.tokenizer, self.engine.frame_seconds, confs=[sp[3] for sp in spans])]
        self._send(conn, out)

    def _client_loop(self, conn: socket.socket) -> None:
        self._send_locks.setdefault(conn, threading.Lock())
        sids_here: List[int] = []
        try:
            while self._running:
                frame = recv_frame(conn)
                if frame is None:
                    break
                msg, payload = frame
                op = msg.get("op")
                if op == "start":
                    try:
                        with self._lock:
                            sid = self.engine.attach()
                        self._conn_of_sid[sid] = conn
                        self._ids_of_sid[sid] = []
                        sids_here.append(sid)
                        self._send(conn, {"event": "started", "sid": sid})
                    except RuntimeError as e:
                        self._send(conn, {"event": "error", "msg": str(e)})
                elif op == "audio":
                    with self._lock:
                        self.engine.feed(msg["sid"], np.frombuffer(payload, np.float32))
                elif op == "end":
                    self._end(conn, msg, sids_here)
                elif op == "stats":
                    with self._lock:
                        st = self.engine.stats()
                    self._send(conn, {"event": "stats", "stats": st})
                else:
                    self._send(conn, {"event": "error", "msg": f"unknown op {op!r}"})
        finally:
            # Streams the client abandoned: abort, not finish (no flush for
            # a client that will never read the result).
            for sid in sids_here:
                with self._lock:
                    try:
                        self.engine.abort(sid)
                    except KeyError:
                        pass
                self._conn_of_sid.pop(sid, None)
                self._ids_of_sid.pop(sid, None)
                self._endpoint_sent.pop(sid, None)
            self._send_locks.pop(conn, None)
            try:
                conn.close()
            except OSError:
                pass


class StreamingClient:
    """A client: start() a stream, send() PCM, end() -> its transcript."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port))
        self._started: List[int] = []
        self._start_evt = threading.Event()
        self._partials: Dict[int, List[int]] = {}
        self._final: Dict[int, List[int]] = {}
        self._final_beam: Dict[int, Optional[List[int]]] = {}
        self._text: Dict[int, Optional[str]] = {}
        self._final_evt: Dict[int, threading.Event] = {}
        self._words: Dict[int, Optional[list]] = {}
        self._endpoints: Dict[int, float] = {}
        self._endpoint_evt = threading.Event()
        self._stats: Optional[dict] = None
        self._stats_evt = threading.Event()
        self._error: Optional[str] = None
        self._send_lock = threading.Lock()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        while True:
            try:
                frame = recv_frame(self.sock)
            except OSError:
                return  # closed locally while blocked in recv
            if frame is None:
                return
            msg, _ = frame
            ev = msg.get("event")
            if ev == "started":
                self._started.append(msg["sid"])
                self._start_evt.set()
            elif ev == "tokens":
                sid = msg["sid"]
                if msg.get("final"):
                    self._final[sid] = msg["ids"]
                    self._final_beam[sid] = msg.get("ids_final")
                    self._text[sid] = msg.get("text")
                    self._words[sid] = msg.get("words")
                    self._final_evt.setdefault(sid, threading.Event()).set()
                else:
                    self._partials.setdefault(sid, []).extend(msg["ids"])
            elif ev == "endpoint":
                self._endpoints[msg["sid"]] = msg.get("silence_s", 0.0)
                self._endpoint_evt.set()
            elif ev == "stats":
                self._stats = msg["stats"]
                self._stats_evt.set()
            elif ev == "error":
                self._error = msg.get("msg", "server error")
                self._start_evt.set()

    def _send(self, obj: dict, payload: bytes = b"") -> None:
        with self._send_lock:
            send_frame(self.sock, obj, payload)

    def start(self, timeout: float = 30.0) -> int:
        self._start_evt.clear()
        self._send({"op": "start"})
        if not self._start_evt.wait(timeout):
            raise TimeoutError("no start reply")
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(err)
        sid = self._started.pop(0)
        self._final_evt[sid] = threading.Event()
        return sid

    def send(self, sid: int, samples: np.ndarray) -> None:
        self._send({"op": "audio", "sid": sid}, np.asarray(samples, np.float32).tobytes())

    def partial_ids(self, sid: int) -> List[int]:
        return list(self._partials.get(sid, []))

    def end(self, sid: int, timeout: float = 600.0, timestamps: bool = False):
        """Finish the stream: (ids, text or None), or with timestamps (ids,
        text, words), words the server's [[word, start_s, end_s, conf], ...]
        (a server with a final pass and a tokenizer). With a final pass the
        ids are its whole-utterance transcript, else the greedy partials and
        tail."""
        self._send({"op": "end", "sid": sid, "timestamps": timestamps})
        if not self._final_evt[sid].wait(timeout):
            raise TimeoutError("no final reply")
        self._endpoints.pop(sid, None)
        beam = self._final_beam.pop(sid, None)
        ids = self._partials.pop(sid, []) + self._final.pop(sid)
        if beam is not None:
            ids = beam
        text = self._text.pop(sid)
        words = self._words.pop(sid, None)
        return (ids, text, words) if timestamps else (ids, text)

    def endpoint_seen(self, sid: int):
        """The endpoint event's silence_s for stream `sid`, or None."""
        return self._endpoints.get(sid)

    def wait_endpoint(self, sid: int, timeout: float = 30.0):
        """Block until an endpoint event for `sid` arrives (its silence_s)
        or the timeout passes (None)."""
        deadline = time.time() + timeout
        while True:
            if sid in self._endpoints:
                return self._endpoints[sid]
            remaining = deadline - time.time()
            if remaining <= 0:
                return None
            self._endpoint_evt.clear()
            self._endpoint_evt.wait(min(remaining, 0.5))

    def stats(self, timeout: float = 30.0) -> dict:
        """The server's aggregate counters."""
        self._stats_evt.clear()
        self._send({"op": "stats"})
        if not self._stats_evt.wait(timeout):
            raise TimeoutError("no stats reply")
        return self._stats

    def close(self) -> None:
        # shutdown() before close(): with the reader parked in recv, close()
        # alone does not release the socket, no FIN reaches the server and
        # the abandoned slot is never reclaimed.
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
