"""The port's framed channels (``dcnn_tpu_torch/parallel/comm.py``) held
against the JAX package's on the CPU: the same frame (meta, array, codec)
is the same bytes on the wire from either package; a port ``Channel`` and
a JAX ``Channel`` over one ``socket.socketpair()`` read each other in both
directions; truncated and garbage streams are rejected; twins of the
connect-retry cases of ``tests/test_pipeline_failures.py`` (sleep-free:
injected ``sleep`` and ``clock``) and of the channel half of
``tests/test_wire_parity.py``. Every comparison is exact."""

import json
import socket
import struct
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from dcnn_tpu.parallel import comm as jax_comm
from dcnn_tpu_torch.obs import get_registry
from dcnn_tpu_torch.parallel import comm
from dcnn_tpu_torch.parallel.comm import (
    MAGIC, Channel, ChannelClosed, Inbox, _HEADER, parse_addr,
)
from dcnn_tpu_torch.resilience import FaultPlan
from dcnn_tpu_torch.utils.compression import (
    MetaCompressor, ShuffleLz4Compressor,
)


def _shuffle_lz4_or_skip():
    try:
        return ShuffleLz4Compressor()
    except RuntimeError as e:
        pytest.skip(f"native shuffle/lz4 unavailable: {e}")


def _wire_bytes(chan_cls, codec, *frames) -> bytes:
    """Everything ``chan_cls(a, compress=codec)`` writes for ``frames``
    (each ``(cmd, meta, array, raw)``), read off the other end."""
    a, b = socket.socketpair()
    try:
        chan = chan_cls(a, compress=codec)
        for cmd, meta, array, raw in frames:
            chan.send(cmd, meta, array=array, raw=raw)
        a.shutdown(socket.SHUT_WR)
        out = bytearray()
        while True:
            got = b.recv(1 << 16)
            if not got:
                return bytes(out)
            out += got
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("codec", [False, "zlib", "lz4", "shuffle-lz4"])
def test_frames_on_the_wire_equal_jax(codec):
    if codec in ("lz4", "shuffle-lz4"):
        _shuffle_lz4_or_skip()
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((3, 5, 7)).astype(np.float32)
    u8 = rng.integers(0, 256, (4, 6), dtype=np.uint8)
    bf = f32.astype(ml_dtypes.bfloat16)
    jax_frames = [("FORWARD_JOB", {"mb_id": 1, "gen": 2, "rng": 12345},
                   f32, None),
                  ("PIXELS", None, u8, None),
                  ("ACT", {"mb_id": 0}, bf, None),
                  ("CONFIG_TRANSFER", {"stage_id": 0}, None, b"blob" * 9),
                  ("BEAT", {"gen": 3}, None, None)]
    port_frames = [("FORWARD_JOB", {"mb_id": 1, "gen": 2, "rng": 12345},
                    torch.from_numpy(f32), None),
                   ("PIXELS", None, u8, None),
                   ("ACT", {"mb_id": 0},
                    torch.from_numpy(bf.view(np.int16).copy()).view(
                        torch.bfloat16), None),
                   ("CONFIG_TRANSFER", {"stage_id": 0}, None, b"blob" * 9),
                   ("BEAT", {"gen": 3}, None, None)]
    assert _wire_bytes(Channel, codec, *port_frames) == \
        _wire_bytes(jax_comm.Channel, codec, *jax_frames)


def _send_async(chan, *args, **kw):
    t = threading.Thread(target=chan.send, args=args, kwargs=kw, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("codec", [False, "shuffle-lz4"])
def test_port_and_jax_channels_read_each_other(codec):
    if codec:
        _shuffle_lz4_or_skip()
    a, b = socket.socketpair()
    mine, theirs = Channel(a, compress=codec), jax_comm.Channel(b,
                                                                compress=codec)
    rng = np.random.default_rng(2)
    f32 = rng.standard_normal((8, 16)).astype(np.float32)
    bf = f32.astype(ml_dtypes.bfloat16)
    try:
        # port -> JAX: a float32 tensor, a bf16 tensor, raw bytes
        t = _send_async(mine, "FORWARD_RESULT", {"mb_id": 3, "gen": 1},
                        torch.from_numpy(f32))
        cmd, meta, payload = theirs.recv()
        t.join(10)
        assert (cmd, meta) == ("FORWARD_RESULT", {"mb_id": 3, "gen": 1})
        np.testing.assert_array_equal(payload, f32)
        t = _send_async(mine, "ACT", None, torch.from_numpy(
            bf.view(np.int16).copy()).view(torch.bfloat16))
        cmd, _, payload = theirs.recv()
        t.join(10)
        assert payload.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(payload.view(np.uint16),
                                      bf.view(np.uint16))
        t = _send_async(mine, "WEIGHTS", {"nonce": 7}, raw=b"\x00\x01" * 50)
        cmd, meta, payload = theirs.recv()
        t.join(10)
        assert meta == {"nonce": 7} and payload == b"\x00\x01" * 50
        # JAX -> port: the same arrays
        t = _send_async(theirs, "BACKWARD_JOB", {"mb_id": 3, "gen": 1}, f32)
        cmd, meta, payload = mine.recv()
        t.join(10)
        assert (cmd, meta) == ("BACKWARD_JOB", {"mb_id": 3, "gen": 1})
        assert payload.flags.writeable and payload.flags.aligned
        np.testing.assert_array_equal(payload, f32)
        t = _send_async(theirs, "ACT", None, bf)
        cmd, _, payload = mine.recv()
        t.join(10)
        assert isinstance(payload, torch.Tensor)
        assert payload.dtype == torch.bfloat16 and payload.shape == (8, 16)
        np.testing.assert_array_equal(
            payload.view(torch.int16).numpy().view(np.uint16),
            bf.view(np.uint16))
        t = _send_async(theirs, "WEIGHTS", {"nonce": 8}, raw=b"xyz")
        cmd, meta, payload = mine.recv()
        t.join(10)
        assert meta == {"nonce": 8} and payload == b"xyz"
    finally:
        mine.close()
        theirs.close()


@pytest.mark.parametrize("rank", [0, 1, 2, 3, 4])
def test_raw_array_frames_land_aligned(rank):
    """A raw array's data lands on an aligned offset of a writable buffer
    whatever its rank, so it goes to torch with no copy."""
    a, b = socket.socketpair()
    tx, rx = Channel(a), Channel(b)
    try:
        arr = np.arange(max(1, 3 ** rank), dtype=np.float64).reshape(
            (3,) * rank)
        t = _send_async(tx, "x", None, arr)
        _, _, payload = rx.recv()
        t.join(10)
        assert payload.flags.writeable and payload.flags.aligned
        assert payload.ctypes.data % 16 == 0
        np.testing.assert_array_equal(payload, arr)
    finally:
        tx.close()
        rx.close()


def test_shuffle_lz4_through_real_channel_and_mixed_codecs():
    _shuffle_lz4_or_skip()
    a, b = socket.socketpair()
    tx, rx = Channel(a, compress="shuffle-lz4"), Channel(b)
    try:
        grads = (np.random.default_rng(4)
                 .standard_normal((32, 257)).astype(np.float32) * 1e-2)
        t = _send_async(tx, "grads", {"step": 3}, grads)
        cmd, meta, payload = rx.recv()
        t.join(10.0)
        assert cmd == "grads" and meta["step"] == 3
        assert payload.dtype == np.float32
        np.testing.assert_array_equal(payload, grads)
        pix = np.random.default_rng(5).integers(
            0, 256, size=(8, 8, 3), dtype=np.uint8)
        t = _send_async(rx, "pixels", None, pix)
        cmd2, _, payload2 = tx.recv()
        t.join(10.0)
        assert cmd2 == "pixels"
        np.testing.assert_array_equal(payload2, pix)
    finally:
        tx.close()
        rx.close()


def test_channel_rejects_truncated_and_garbage_streams():
    _shuffle_lz4_or_skip()
    a, b = socket.socketpair()
    chan = Channel(b)
    try:
        a.sendall(_HEADER.pack(0xDEADBEEF, 0, 0, 0))
        with pytest.raises(ConnectionError, match="bad frame magic"):
            chan.recv()
    finally:
        a.close()
        chan.close()
    a, b = socket.socketpair()
    chan = Channel(b)
    try:
        meta = b'{"cmd":"x"}'
        a.sendall(_HEADER.pack(MAGIC, 1, len(meta), 1000) + meta + b"par")
        a.close()
        with pytest.raises(ChannelClosed):
            chan.recv()
    finally:
        chan.close()
    blob = MetaCompressor().compress_array(np.arange(4096, dtype=np.float32),
                                           codec=ShuffleLz4Compressor())
    hdr = blob[:struct.calcsize("<BQ")]
    body = blob[struct.calcsize("<BQ"):]
    for bad in (hdr + body[:len(body) // 2], hdr + bytes(len(body))):
        a, b = socket.socketpair()
        chan = Channel(b)
        try:
            meta = b'{"cmd":"x"}'
            a.sendall(_HEADER.pack(MAGIC, 1, len(meta), len(bad)) + meta
                      + bad)
            with pytest.raises(ValueError):
                chan.recv()
        finally:
            a.close()
            chan.close()


def test_broken_channel_fails_fast_and_counts_bytes():
    reg = get_registry()
    sent0 = reg.counter("comm_bytes_sent_total").value
    recv0 = reg.counter("comm_bytes_received_total").value
    a, b = socket.socketpair()
    tx, rx = Channel(a), Channel(b)
    arr = np.zeros((4, 4), np.float32)
    t = _send_async(tx, "x", {"k": 1}, arr)
    rx.recv()
    t.join(10)
    n = len(json.dumps({"k": 1, "cmd": "x"}).encode()) + _HEADER.size + \
        len(MetaCompressor().compress_array(arr, codec=tx._codec))
    assert reg.counter("comm_bytes_sent_total").value == sent0 + n
    assert reg.counter("comm_bytes_received_total").value == recv0 + n
    rx.close()
    tx._broken = True
    with pytest.raises(ChannelClosed, match="broken"):
        tx.send("x", attempts=1)
    tx.close()


def test_send_fault_point_retries_then_sends():
    a, b = socket.socketpair()
    tx, rx = Channel(a), Channel(b)
    try:
        with FaultPlan().arm("comm.send", times=2, exc=OSError) as plan:
            tx.send("hello", {"n": 1}, sleep=lambda s: None)
            assert plan.count("comm.send") == 3
        assert rx.recv()[:2] == ("hello", {"n": 1})
    finally:
        tx.close()
        rx.close()


def test_inbox_attach_post_and_close_callback():
    a, b = socket.socketpair()
    tx, rx = Channel(a), Channel(b)
    inbox, closed = Inbox(), threading.Event()
    inbox.attach(rx, on_close=lambda ch: closed.set())
    tx.send("one", {"i": 1})
    cmd, meta, payload, chan = inbox.get(timeout=10)
    assert (cmd, meta, payload, chan) == ("one", {"i": 1}, None, rx)
    inbox.post("_STOP")
    assert inbox.get(timeout=10)[0] == "_STOP"
    with pytest.raises(TimeoutError):
        inbox.get(timeout=0.01)
    tx.close()
    assert closed.wait(10)
    rx.close()


def test_inbox_join_waits_for_readers_of_closed_channels():
    """``Inbox.join`` returns once each reader has seen its channel close
    (the stage worker and the coordinator join theirs before the process
    exits), and gives up at its timeout on a channel still open."""
    pairs = [socket.socketpair() for _ in range(3)]
    inbox = Inbox()
    readers = [inbox.attach(Channel(b)) for _, b in pairs]
    for a, _ in pairs[:2]:
        a.close()
    inbox.join(timeout=0.3)
    assert [t.is_alive() for t in readers] == [False, False, True]
    pairs[2][0].close()
    inbox.join(timeout=10)
    assert not readers[2].is_alive()
    for _, b in pairs:
        b.close()


def test_listen_connect_and_parse_addr():
    srv = comm.listen(0, host="127.0.0.1")
    try:
        port = srv.getsockname()[1]
        chan = comm.connect("127.0.0.1", port, timeout=10.0)
        peer, _ = srv.accept()
        other = Channel(peer)
        chan.set_send_timeout(0.5)
        chan.send("hi", {"x": [1, 2]})
        assert other.recv() == ("hi", {"x": [1, 2]}, None)
        chan.close()
        other.close()
    finally:
        srv.close()
    assert parse_addr("10.0.0.1:9601") == ("10.0.0.1", 9601)
    assert parse_addr(":9601") == ("127.0.0.1", 9601)
    assert parse_addr("9601") == ("127.0.0.1", 9601)


# -- twins of tests/test_pipeline_failures.py's connect-retry cases --------

class FakeSock:
    def setsockopt(self, *a):
        pass

    def settimeout(self, t):
        self.timeout = t


def test_connect_retries_flaky_socket_with_backoff(monkeypatch):
    flaky = {"left": 3}
    dialed = []

    def fake_create_connection(addr, timeout=None):
        dialed.append(addr)
        if flaky["left"] > 0:
            flaky["left"] -= 1
            raise ConnectionRefusedError("worker still importing torch")
        return FakeSock()

    sleeps = []
    t = [0.0]
    monkeypatch.setattr(comm.socket, "create_connection",
                        fake_create_connection)
    reg = get_registry()
    before = reg.counter("pipeline_connect_retry_attempts_total").value
    chan = comm.connect("10.0.0.7", 5555, timeout=30.0, delay=0.1,
                        sleep=lambda s: (sleeps.append(s),
                                         t.__setitem__(0, t[0] + s)),
                        clock=lambda: t[0])
    assert isinstance(chan._sock, FakeSock)
    assert chan._sock.timeout is None
    assert dialed == [("10.0.0.7", 5555)] * 4
    assert len(sleeps) == 3
    assert reg.counter(
        "pipeline_connect_retry_attempts_total").value == before + 3
    for i, s in enumerate(sleeps):
        d = min(2.0, 0.1 * 2 ** i)
        assert d / 2 <= s <= d, (i, s)


def test_connect_gives_up_after_deadline_with_clear_error(monkeypatch):
    def always_down(addr, timeout=None):
        raise ConnectionRefusedError("nobody home")

    t = [0.0]
    monkeypatch.setattr(comm.socket, "create_connection", always_down)
    with pytest.raises(ConnectionError, match="cannot connect.*9:9999"):
        comm.connect("9", 9999, timeout=5.0, delay=0.5,
                     sleep=lambda s: t.__setitem__(0, t[0] + s),
                     clock=lambda: t[0])
    assert t[0] <= 5.0 + 2.0


def test_connect_fault_point_drives_retry_then_recovers(monkeypatch):
    monkeypatch.setattr(comm.socket, "create_connection",
                        lambda addr, timeout=None: FakeSock())
    with FaultPlan().arm("comm.connect", times=2, exc=OSError) as plan:
        chan = comm.connect("w", 7777, timeout=10.0, delay=0.01,
                            sleep=lambda s: None)
        assert isinstance(chan._sock, FakeSock)
        assert plan.count("comm.connect") == 3


def test_reconnect_counts_under_its_own_name(monkeypatch):
    left = {"n": 2}

    def flaky(addr, timeout=None):
        if left["n"]:
            left["n"] -= 1
            raise ConnectionRefusedError("respawning")
        return FakeSock()

    monkeypatch.setattr(comm.socket, "create_connection", flaky)
    reg = get_registry()
    before = reg.counter("pipeline_reconnect_retry_attempts_total").value
    comm.connect("w", 1, timeout=10.0, delay=0.01, sleep=lambda s: None,
                 name="pipeline_reconnect")
    assert reg.counter(
        "pipeline_reconnect_retry_attempts_total").value == before + 2
