"""Framed TCP channels for the cross-process pipeline's data and control
plane (counterpart of ``dcnn_tpu/parallel/comm.py``).

One blocking socket a peer, a reader thread a connection feeding one
inbox queue, and a lock-guarded blocking send. The wire format is the JAX
package's, so a port process and a JAX process read each other's frames:

  magic  u32  0x44544E31 ("1NTD" on the wire)
  flags  u8   bit0: payload present
  meta   u32  length of UTF-8 JSON metadata (always present, has "cmd")
  payload u64 length of payload blob
  [meta bytes][payload bytes]

Array payloads ride :class:`~dcnn_tpu_torch.utils.compression.
MetaCompressor`'s tensor framing (rank, dims, dtype, data, under a codec-id
header). ``Channel(compress=...)`` takes ``True`` (the ``DCNN_WIRE_CODEC``
codec, else the default), a codec name or a ``Compressor``; the receiver
dispatches on each frame's codec id, so mixed-codec peers interoperate.

Where the port departs from the JAX package:

- ``send(array=)`` takes a numpy array or a torch tensor on any device. A
  CUDA tensor is copied once into pinned host memory, queued on the
  current stream (the sender's, so after the work that produced it), and
  the send waits for that copy's event alone, never for the whole card.
  Raw frames go out as their parts, the array's own memory last.
- ``recv`` reads a raw array frame so that its data lands aligned in a
  writable buffer and hands back the array over that buffer (numpy, or a
  ``torch.bfloat16`` tensor for a ``bf16`` frame) without a copy; the
  receiver moves it onto its device with one.
- Every frame's bytes count on the process's registry:
  ``comm_bytes_sent_total`` and ``comm_bytes_received_total``.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs.registry import get_registry
from ..obs.tracer import get_tracer
from ..resilience import faults as _faults
from ..resilience.retry import retry_call
from ..utils.compression import (Compressor, MetaCompressor, RawCompressor,
                                 resolve_codec)

MAGIC = 0x44544E31
_HEADER = struct.Struct("<IBIQ")
_FLAG_PAYLOAD = 1
_CODEC_HEADER = struct.Struct("<BQ")
_ALIGN = 64

# module-level codec registry: raw unless a channel resolves another
_CODEC = MetaCompressor()


class ChannelClosed(ConnectionError):
    pass


def _count(direction: str, n: int) -> None:
    get_registry().counter(f"comm_bytes_{direction}_total",
                           f"framed wire bytes {direction}").inc(n)


def _read_into(sock: socket.socket, view: memoryview) -> None:
    got, n = 0, len(view)
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ChannelClosed("peer closed connection")
        got += r


def _read_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    _read_into(sock, memoryview(buf))
    return buf


def _read_payload(sock: socket.socket, n: int) -> memoryview:
    """``n`` payload bytes in a writable buffer. A raw array frame is
    placed so that its array data starts on an ``_ALIGN`` boundary of the
    buffer (the frame's header is 14 + 8 * rank bytes long)."""
    head = min(n, _CODEC_HEADER.size + 1)
    first = _read_exact(sock, head)
    pad = 0
    if head == _CODEC_HEADER.size + 1 and \
            first[0] == RawCompressor.codec_id:
        pad = -(head + 8 * first[-1] + 4) % _ALIGN
    buf = bytearray(pad + n)
    view = memoryview(buf)[pad:]
    view[:head] = first
    _read_into(sock, view[head:])
    return view


def _host(array):
    """``array`` readable on the host: a CUDA tensor copied once into
    pinned memory on the current stream, waiting for that copy alone."""
    if isinstance(array, torch.Tensor):
        t = array.detach()
        if not t.is_cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        done.synchronize()
        return host
    return np.asarray(array)


class Channel:
    """One bidirectional framed connection to a peer."""

    def __init__(self, sock: socket.socket,
                 compress: "bool | str | Compressor" = False):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not TCP (a socketpair): nothing to disable
        self._sock = sock
        self._send_lock = threading.Lock()
        self.compress = compress
        # the send side's codec, resolved once (it may probe the native
        # toolchain); None is the MetaCompressor default
        self._codec = resolve_codec(compress)
        # set once sendall has raised: part of a frame may be on the wire,
        # so the stream is unframeable and every later send fails fast
        self._broken = False

    # -- send --
    def send(self, cmd: str, meta: Optional[Dict[str, Any]] = None,
             array=None, raw: Optional[bytes] = None, *,
             attempts: int = 3, retry_timeout: float = 2.0,
             sleep=time.sleep, clock=time.monotonic) -> None:
        """Send one frame. A transient failure before any byte reaches the
        wire (the armed ``comm.send`` fault point, an ``ENOBUFS``-class
        error) is retried with jittered exponential backoff under
        ``retry_timeout``; once ``sendall`` has raised the channel is
        broken and the error surfaces at once. The sender's active span
        context rides the frame as ``"_trace"``."""
        m = dict(meta or {})
        m["cmd"] = cmd
        ctx = get_tracer().inject()
        if ctx is not None and "_trace" not in m:
            m["_trace"] = ctx
        parts: list = []
        if array is not None:
            parts = _CODEC.compress_parts(_host(array), codec=self._codec)
        elif raw is not None:
            parts = [raw]
            m["_raw"] = True
        mb = json.dumps(m).encode()
        plen = sum(len(memoryview(p)) for p in parts)
        head = _HEADER.pack(MAGIC, _FLAG_PAYLOAD if plen else 0, len(mb),
                            plen) + mb

        def attempt() -> None:
            _faults.trip("comm.send", cmd=cmd)
            with self._send_lock:
                if self._broken:
                    raise ChannelClosed(
                        "channel broken by an earlier partial send")
                try:
                    # deliberate blocking-send-under-lock: _send_lock
                    # exists to serialize whole frames onto the socket —
                    # the one place in the package where the blocking IO
                    # IS the critical section. Callers must not hold
                    # their own locks across send() (DL02 flags them).
                    for buf in (head, *parts):
                        self._sock.sendall(buf)  # dcnn: disable=DL02
                except OSError:
                    self._broken = True
                    raise
            _count("sent", len(head) + plen)

        if attempts <= 1:
            attempt()
            return
        retry_call(attempt, attempts=attempts, base=0.05, cap=0.5,
                   timeout=retry_timeout, retry_on=(OSError,),
                   retry_if=lambda e: not self._broken,
                   sleep=sleep, clock=clock, name="comm_send")

    # -- recv (blocking, one frame) --
    def recv(self) -> Tuple[str, Dict[str, Any], Any]:
        magic, flags, mlen, plen = _HEADER.unpack(
            _read_exact(self._sock, _HEADER.size))
        if magic != MAGIC:
            raise ConnectionError(f"bad frame magic {magic:#x}")
        meta = json.loads(_read_exact(self._sock, mlen))
        payload: Any = None
        if flags & _FLAG_PAYLOAD:
            if meta.pop("_raw", False):
                payload = bytes(_read_exact(self._sock, plen))
            else:
                payload = _CODEC.decompress_array(
                    _read_payload(self._sock, plen))
        _count("received", _HEADER.size + mlen + plen)
        return meta.pop("cmd"), meta, payload

    def set_send_timeout(self, seconds: float) -> None:
        """Kernel-level send deadline (``SO_SNDTIMEO``): a peer whose
        receive window stays full fails our send within the budget, while
        a reader's blocking ``recv`` may still wait as long as it must."""
        t = max(float(seconds), 1.0)
        try:
            self._sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                struct.pack("ll", int(t), int((t % 1.0) * 1e6)))
        except (OSError, ValueError):
            pass  # no SO_SNDTIMEO here: the close and timeout paths remain

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class Inbox:
    """One arrival-ordered message queue fed by per-connection reader
    threads."""

    def __init__(self) -> None:
        self._q: "queue.Queue[Tuple[str, Dict, Any, Channel]]" = queue.Queue()
        self._readers: List[threading.Thread] = []

    def attach(self, chan: Channel, on_close=None) -> threading.Thread:
        def reader():
            try:
                while True:
                    cmd, meta, payload = chan.recv()
                    self._q.put((cmd, meta, payload, chan))
            except (ChannelClosed, ConnectionError, OSError):
                if on_close is not None:
                    on_close(chan)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        self._readers.append(t)
        return t

    def join(self, timeout: float) -> None:
        """Wait, at most ``timeout`` seconds in all, for the reader threads
        to end (each ends when its channel closes). A process that exits
        with a reader still waking from its socket can abort in the
        interpreter's shutdown ("terminate called without an active
        exception"), so the owners join theirs first."""
        deadline = time.monotonic() + timeout
        for t in self._readers:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._readers = [t for t in self._readers if t.is_alive()]

    def get(self, timeout: Optional[float] = None):
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("no message within timeout") from None

    def empty(self) -> bool:
        """Nothing queued. A connection's reader queues every frame it
        read before its ``on_close`` runs, so a peer found closed while
        this is true has no frame left to read."""
        return self._q.empty()

    def post(self, cmd: str, meta: Optional[Dict] = None,
             payload: Any = None, chan: Optional[Channel] = None) -> None:
        """A local frame: wake-up sentinels and tests."""
        self._q.put((cmd, dict(meta or {}), payload, chan))


def listen(port: int, host: str = "0.0.0.0") -> socket.socket:
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(16)
    return srv


def connect(host: str, port: int, *, timeout: float = 60.0,
            delay: float = 0.2, compress: "bool | str | Compressor" = False,
            sleep=time.sleep, clock=time.monotonic,
            name: str = "pipeline_connect") -> Channel:
    """Dial through the shared bounded-backoff primitive: workers come up in
    any order and take seconds to import torch. Backoff starts at ``delay``
    and doubles (jittered) to a 2 s cap until ``timeout``; each retry
    counts on ``<name>_retry_attempts_total`` (a recovery sweep passes
    ``name="pipeline_reconnect"``). ``sleep``/``clock`` are injectable."""

    def attempt() -> Channel:
        _faults.trip("comm.connect", host=host, port=port)
        s = socket.create_connection((host, port), timeout=30)
        # a reader waits as long as it must (a long first step, an idle
        # gap between epochs): the connect timeout must not linger
        s.settimeout(None)
        return Channel(s, compress=compress)

    attempts = max(2, int(timeout / max(delay, 1e-3)) + 1)
    try:
        return retry_call(attempt, attempts=attempts, base=delay, cap=2.0,
                          timeout=timeout, retry_on=(OSError,),
                          sleep=sleep, clock=clock, name=name)
    except OSError as e:
        raise ConnectionError(f"cannot connect to {host}:{port} "
                              f"within {timeout}s: {e}") from e


def parse_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)
