"""The port's multi-process control plane (``parallel/multihost.py``) held
to the JAX package's ``tests/test_multihost.py`` cases, on the CPU.

The JAX tests run ``jax.distributed`` in two processes; their twins run
the port's ``initialize`` (``torch.distributed`` over gloo, its TCP store
on process 0) in spawned worlds: config broadcast and barrier over the
store, and a cross-process all-reduce over the mesh's data group. The JAX
data-plane test sums 4 devices of 2 processes; here a world of 4
processes, one rank a device, sums the same 0+1+2+3. The typed
``PeerLostError`` is driven both from a fake client (the JAX package's
fake) and from the real store timing out on a peer that never arrives.
"""

import textwrap

import pytest

from dcnn_tpu_torch.parallel import multihost
from dcnn_tpu_torch.parallel.multihost import PeerLostError
from test_torch_data_parallel import spawn_world

WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import torch
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.parallel import multihost
    from dcnn_tpu_torch.parallel.data_parallel import all_reduce_
    from dcnn_tpu_torch.parallel.multihost import PeerLostError

    pid, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    multihost.initialize(f"127.0.0.1:{{port}}", num_processes=world,
                         process_id=pid, backend="gloo", timeout_s=60)
    multihost.initialize()  # idempotent
    assert multihost.process_count() == world
    assert multihost.process_index() == pid
    assert multihost.is_coordinator() == (pid == 0)

    # coordinator ships a stage config; workers receive it
    cfg = multihost.broadcast_config(
        "stage_cfg", {{"layers": [{{"type": "flatten", "name": "f"}}],
                       "pid": 0}})
    assert cfg["layers"][0]["type"] == "flatten", cfg
    assert cfg["pid"] == 0
    multihost.barrier("ready")

    # the data plane: an all-reduce over the mesh's data group
    mesh = make_mesh()
    t = torch.tensor([float(pid)])
    all_reduce_(t, mesh.get_group("data"))
    assert t.item() == sum(range(world)), t
    multihost.barrier("reduced")

    # a peer that never arrives: the store's timeout surfaces typed
    if pid == 0:
        try:
            multihost.barrier("lonely", timeout_ms=300)
            raise SystemExit("barrier without its peers returned")
        except PeerLostError as e:
            assert "barrier('lonely')" in str(e), e
        try:
            multihost.broadcast_config("never", {{}}, timeout_ms=1)
        except PeerLostError:
            raise SystemExit("the coordinator must publish, not wait")
    else:
        try:
            multihost.broadcast_config("never_published", {{}},
                                       timeout_ms=300)
            raise SystemExit("a config nobody published arrived")
        except PeerLostError as e:
            assert "broadcast_config('never_published')" in str(e), e
    multihost.barrier("done", timeout_ms=60_000)
    print(f"rank {{pid}} OK", flush=True)
    multihost.shutdown()
    assert not torch.distributed.is_initialized()
""")


@pytest.mark.parametrize("world", [2, 4])
def test_processes_config_broadcast_barrier_and_all_reduce(world,
                                                           tmp_path):
    """Twin of ``test_two_process_config_broadcast_and_barrier`` (world 2)
    and of ``test_two_process_cross_process_psum`` (world 4: 0+1+2+3 = 6),
    with the store's timeouts surfacing as ``PeerLostError``."""
    spawn_world(WORKER, world, tmp_path)


class _FakeKv:
    """``tests/test_elastic.py``'s fake distributed client."""

    def __init__(self, fail=False):
        self.fail = fail
        self.store = {}
        self.barriers = []

    def key_value_set(self, key, value):
        self.store[key] = value

    def blocking_key_value_get(self, key, timeout_ms):
        if self.fail:
            raise RuntimeError(f"Deadline Exceeded after {timeout_ms}ms")
        return self.store[key]

    def wait_at_barrier(self, name, timeout_ms):
        if self.fail:
            raise RuntimeError(f"Barrier timed out after {timeout_ms}ms")
        self.barriers.append(name)


def test_peer_lost_from_a_fake_client(monkeypatch):
    kv = _FakeKv(fail=True)
    with pytest.raises(PeerLostError, match=r"barrier\('b'\)") as e:
        multihost.barrier("b", timeout_ms=10, client=kv)
    assert "Barrier timed out after 10ms" in str(e.value)
    assert e.value.op == "barrier('b')"
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    with pytest.raises(PeerLostError, match="coordinator did not publish"):
        multihost.broadcast_config("cfg", {}, timeout_ms=10, client=kv)


def test_uninitialized_runtime_is_a_world_of_one():
    assert multihost.process_index() == 0
    assert multihost.process_count() == 1
    assert multihost.is_coordinator()
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.barrier("x")
    with pytest.raises(ValueError, match="COORDINATOR_ADDR"):
        multihost.initialize(num_processes=2, process_id=0, backend="gloo")
