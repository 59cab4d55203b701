"""Multi-process runtime (counterpart of ``dcnn_tpu/parallel/multihost.py``).

The data plane (gradient and statistics collectives) rides a
``torch.distributed`` process group: NCCL where every rank has a card of
its own, gloo otherwise (and on the CPU). What stays host-side is the
control plane: process bootstrap, rank discovery, barriers and small
config broadcasts, which run over the process group's key-value store
(the TCP store on process 0, the coordinator).

Deployment contract, as in the JAX package: every process runs the same
program with COORDINATOR_ADDR ("host:port" of process 0's store),
NUM_PROCESSES and PROCESS_ID set (or passed to :func:`initialize`).
"""

from __future__ import annotations

import datetime
import json
from typing import Any, Dict, Optional

from ..utils.env import get_env

_initialized = False


def default_backend(num_processes: int) -> str:
    """NCCL when each of the ``num_processes`` local ranks can have a card
    of its own, else gloo: NCCL refuses two ranks on one device."""
    import torch

    if torch.cuda.is_available() \
            and num_processes <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Join the process group (idempotent).

    Args default from env: COORDINATOR_ADDR ("host:port"), NUM_PROCESSES,
    PROCESS_ID. A world of one process without an address needs no
    network (an in-process store). ``backend`` defaults to
    :func:`default_backend`; an NCCL rank binds card ``rank % count``."""
    global _initialized
    import torch
    import torch.distributed as dist

    if _initialized or dist.is_initialized():
        _initialized = True
        return
    coordinator_address = (coordinator_address
                           or get_env("COORDINATOR_ADDR", "") or None)
    if num_processes is None:
        n = get_env("NUM_PROCESSES", 0)
        num_processes = n if n > 0 else 1
    if process_id is None:
        p = get_env("PROCESS_ID", -1)
        process_id = p if p >= 0 else 0
    backend = backend or default_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError(
                f"a world of {num_processes} processes needs "
                f"COORDINATOR_ADDR (host:port of process 0's store)")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            rank=process_id, world_size=num_processes, timeout=timeout)
    _initialized = True


def shutdown() -> None:
    global _initialized
    import torch.distributed as dist

    if _initialized and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """Process 0 plays the reference's coordinator role."""
    return process_index() == 0


class _StoreClient:
    """The process group's key-value store behind the JAX distributed
    client's three calls."""

    def __init__(self, store, world: int):
        self.store = store
        self.world = world

    def key_value_set(self, key: str, value: str) -> None:
        self.store.set(f"kv/{key}", value)

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        k = f"kv/{key}"
        self.store.wait([k], datetime.timedelta(milliseconds=timeout_ms))
        return self.store.get(k).decode()

    def wait_at_barrier(self, name: str, timeout_ms: int) -> None:
        arrived = self.store.add(f"barrier/{name}", 1)
        done = f"barrier/{name}/done"
        if arrived == self.world:
            self.store.set(done, "1")
        self.store.wait([done], datetime.timedelta(milliseconds=timeout_ms))


def _kv_client() -> _StoreClient:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("multihost.initialize() must be called first")
    from torch.distributed.distributed_c10d import _get_default_store

    return _StoreClient(_get_default_store(), dist.get_world_size())


class PeerLostError(RuntimeError):
    """A peer failed to show up for a collective control-plane operation
    (barrier, config exchange, gradient exchange) within its deadline — or
    its connection died outright.

    This is the typed boundary between "a peer is slow" and "a peer is
    gone": :func:`barrier` / :func:`broadcast_config` raise it instead of
    leaking the store's own timeout error, and the elastic controller
    (``parallel/elastic.py``) treats it as the signal to start a
    reconfiguration rather than hang or crash."""

    def __init__(self, op: str, detail: str = "",
                 peers: Optional[list] = None):
        self.op = op
        self.peers = list(peers) if peers else []
        who = f" (peers {self.peers})" if self.peers else ""
        super().__init__(f"peer lost during {op}{who}"
                         + (f": {detail}" if detail else ""))


def broadcast_config(key: str, config: Dict[str, Any],
                     timeout_ms: int = 60_000, *,
                     client=None) -> Dict[str, Any]:
    """Coordinator publishes a JSON config; workers block until it lands,
    for at most ``timeout_ms``: a coordinator that never publishes
    surfaces as a typed :class:`PeerLostError`. ``client`` is injectable
    for tests (defaults to the process group's store)."""
    client = client if client is not None else _kv_client()
    if is_coordinator():
        client.key_value_set(key, json.dumps(config))
        return config
    try:
        blob = client.blocking_key_value_get(key, timeout_ms)
    except Exception as e:
        raise PeerLostError(
            f"broadcast_config({key!r})",
            f"coordinator did not publish within {timeout_ms}ms "
            f"({type(e).__name__}: {e})") from e
    return json.loads(blob)


def barrier(name: str, timeout_ms: int = 60_000, *, client=None) -> None:
    """Cross-process barrier, deadline-bounded with a typed error: a peer
    that never arrives turns into :class:`PeerLostError` after
    ``timeout_ms`` instead of hanging the surviving processes. Each
    ``name`` is one barrier. ``client`` is injectable for tests."""
    client = client if client is not None else _kv_client()
    try:
        client.wait_at_barrier(name, timeout_ms)
    except Exception as e:
        raise PeerLostError(
            f"barrier({name!r})",
            f"not all peers arrived within {timeout_ms}ms "
            f"({type(e).__name__}: {e})") from e
