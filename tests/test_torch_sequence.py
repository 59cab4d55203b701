"""The port's sequence parallelism held against the JAX package on the CPU
(twins of ``tests/test_attention.py``'s ring, zigzag and Ulysses cases).

The port's ranks are processes: the module spawns gloo worlds of 2 and 4
ranks once each (``tests/test_torch_data_parallel.py``'s ``spawn_world``)
and every case runs in them; a world of one runs in this process. Each
rank feeds its shard (``shard_sequence``, ``zigzag_shard``) to the
function a ``make_*`` returns and backpropagates ``sum(out_local²)``, so
its gradients are its slice of the gradient of ``sum(out²)`` over the
whole sequence. The JAX side runs the JAX package's ``make_*`` over the
same number of the conftest's CPU devices, and ``attention`` on the whole
sequence. Inputs are numpy normals from a seed.

Tolerances (the JAX tests' own): fp32 outputs ``atol = rtol = 1e-5``,
gradients ``1e-4``. bf16 (inputs rounded to bf16, against fp32 attention
of the rounded inputs): ``atol 3e-2`` on outputs, which are bounded by
max|v| ≈ 4 here. Each live block's output leaves the flash forward
rounded to bf16 (2^-9 relative) before the fp32 merge, and the merged
output is rounded once more, so a ring output carries two bf16 roundings
of values up to max|v| (≤ 1.6e-2), and a bf16 P·V product adds its own;
a wrong mask or merge is off by O(1).

Flash calls a rank makes are counted by path (the ring and zigzag pairs
through ``_flash_forward`` / ``_flash_backward``, Ulysses through
``flash_attention`` and the flash op's backward): ring ``r + 1`` causal
and ``n`` not, zigzag ``2n + 1``, Ulysses 1, forward and backward alike.
"""

import inspect
import pickle
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.core.mesh import SEQ_AXIS
from dcnn_tpu.core.mesh import make_mesh as jax_make_mesh
from dcnn_tpu.ops.attention import attention as jax_attention
from dcnn_tpu.parallel import make_ring_attention as jax_ring
from dcnn_tpu.parallel import make_ulysses_attention as jax_ulysses
from dcnn_tpu.parallel import make_zigzag_ring_attention as jax_zigzag
from dcnn_tpu.parallel import zigzag_permutation as jax_zz_perm
from dcnn_tpu_torch.parallel.sequence import (
    live_pairs, make_ring_attention, make_ulysses_attention,
    make_zigzag_ring_attention, shard_sequence, zigzag_permutation,
    zigzag_shard,
)
from test_torch_data_parallel import spawn_world

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 3e-2

# name: (kind, causal, (B, H, S, D), dtype); the JAX tests' shapes
CASES = {
    "ring": ("ring", False, (2, 2, 64, 8), "float32"),
    "ring_causal": ("ring", True, (2, 2, 64, 8), "float32"),
    "ring_causal_grad": ("ring", True, (1, 2, 32, 8), "float32"),
    "zigzag": ("zigzag", True, (2, 2, 64, 8), "float32"),
    "zigzag_grad": ("zigzag", True, (1, 2, 32, 8), "float32"),
    "ulysses": ("ulysses", False, (2, 8, 64, 8), "float32"),
    "ulysses_causal": ("ulysses", True, (2, 8, 64, 8), "float32"),
    "ulysses_causal_grad": ("ulysses", True, (1, 8, 32, 8), "float32"),
}
BF16_CASES = {
    "ring_causal_bf16": ("ring", True, (2, 8, 64, 8), "bfloat16"),
    "zigzag_bf16": ("zigzag", True, (2, 8, 64, 8), "bfloat16"),
    "ulysses_causal_bf16": ("ulysses", True, (2, 8, 64, 8), "bfloat16"),
}
WORLD_CASES = {2: {**CASES, **BF16_CASES}, 4: {**CASES, **BF16_CASES}}


def _inputs(name, shape, dtype):
    """q, k, v as float32 numpy arrays (bf16-rounded for a bf16 case)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    qkv = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    if dtype == "bfloat16":
        qkv = [torch.from_numpy(a).bfloat16().float().numpy() for a in qkv]
    return qkv


# -- the port's side: one function for a rank, here or in a worker ------------

def run_case(mesh, kind, causal, qkv, dtype):
    """This rank's (out, dq, dk, dv) as float32 numpy, in the shard's own
    order (zigzag order for zigzag)."""
    dt = getattr(torch, dtype)
    full = [torch.from_numpy(a).to(dt) for a in qkv]
    if kind == "zigzag":
        local = zigzag_shard(full, mesh)
        f = make_zigzag_ring_attention(mesh)
    else:
        local = shard_sequence(full, mesh)
        make = make_ring_attention if kind == "ring" else \
            make_ulysses_attention
        f = make(mesh, causal=causal)
    local = [t.clone().requires_grad_(True) for t in local]
    out = f(*local)
    (out.float() ** 2).sum().backward()
    return [t.detach().float().numpy() for t in
            (out, *(x.grad for x in local))]


# the rank's side runs run_case and refusals, their source shipped in the
# spec, so that the workers import neither JAX nor this module
WORKER = textwrap.dedent("""
    import os, pickle, sys
    sys.path.insert(0, {repo!r})
    import torch
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.parallel import multihost, sequence
    from dcnn_tpu_torch.parallel.sequence import (
        make_ring_attention, make_ulysses_attention,
        make_zigzag_ring_attention, shard_sequence, zigzag_shard)

    ops_attention = sys.modules["dcnn_tpu_torch.ops.attention"]

    rank, world, port, d = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])
    multihost.initialize(f"127.0.0.1:{{port}}", world, rank,
                         backend="gloo", timeout_s=60)
    spec = pickle.load(open(os.path.join(d, "spec.pkl"), "rb"))
    exec(spec.pop("helpers"))
    mesh = make_mesh((world,), ("seq",))
    calls = {{"fwd": 0, "bwd": 0}}

    def counting(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    sequence._flash_forward = counting(sequence._flash_forward, "fwd")
    sequence._flash_backward = counting(sequence._flash_backward, "bwd")
    sequence.flash_attention = counting(sequence.flash_attention, "fwd")
    ops_attention._flash_backward = counting(ops_attention._flash_backward,
                                             "bwd")
    out = {{"coordinate": mesh.coordinate("seq")}}
    for name, (kind, causal, qkv, dtype) in spec.items():
        calls.update(fwd=0, bwd=0)
        res = run_case(mesh, kind, causal, qkv, dtype)
        out[name] = {{"arrays": res, "calls": dict(calls)}}
    out["refusals"] = refusals(mesh)
    with open(os.path.join(d, f"out{{rank}}.pkl"), "wb") as f:
        pickle.dump(out, f)
    multihost.barrier("done", timeout_ms=60_000)
    print(f"rank {{rank}} OK", flush=True)
    multihost.shutdown()
""")


def refusals(mesh):
    """The ValueError messages of the refusals at this mesh (n > 1)."""
    n = mesh.shape["seq"]
    z = lambda *shape: torch.zeros(shape)  # noqa: E731
    tries = {
        # the ring's S must divide by n (its shard is refused)
        "ring_indivisible": lambda: shard_sequence(z(1, 2, 4 * n + 1, 8),
                                                   mesh),
        # zigzag's S must divide by 2n: the permutation and an odd shard
        "zigzag_permutation": lambda: zigzag_shard(z(1, 2, 3 * n, 8), mesh),
        "zigzag_odd_shard": lambda: make_zigzag_ring_attention(mesh)(
            z(1, 2, 3, 8), z(1, 2, 3, 8), z(1, 2, 3, 8)),
        "ulysses_heads": lambda: make_ulysses_attention(mesh)(
            z(1, 2 * n + 1, 4, 8), z(1, 2 * n + 1, 4, 8),
            z(1, 2 * n + 1, 4, 8)),
        "ring_lengths": lambda: make_ring_attention(mesh)(
            z(1, 2, 4, 8), z(1, 2, 2, 8), z(1, 2, 4, 8)),
    }
    got = {}
    for name, fn in tries.items():
        try:
            fn()
            got[name] = None
        except ValueError as e:
            got[name] = str(e)
    return got


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    n = request.param
    d = tmp_path_factory.mktemp(f"seq{n}")
    spec = {name: (kind, causal, _inputs(name, shape, dtype), dtype)
            for name, (kind, causal, shape, dtype) in WORLD_CASES[n].items()}
    helpers = inspect.getsource(run_case) + inspect.getsource(refusals)
    with open(d / "spec.pkl", "wb") as f:
        pickle.dump({**spec, "helpers": helpers}, f)
    spawn_world(WORKER, n, d)
    outs = [pickle.load(open(d / f"out{r}.pkl", "rb")) for r in range(n)]
    return n, spec, outs


# -- the JAX side ---------------------------------------------------------------

def _jax_mesh(n):
    return jax_make_mesh((n,), (SEQ_AXIS,), devices=jax.devices()[:n])


def _jax_fn(kind, causal, n):
    mesh = _jax_mesh(n)
    if kind == "ring":
        return jax_ring(mesh, causal=causal)
    if kind == "zigzag":
        return jax_zigzag(mesh)
    return jax_ulysses(mesh, causal=causal, interpret=True)


def _value_and_grads(fn, qkv, grads=True):
    """[out, dq, dk, dv] of ``fn`` (``[out]`` without ``grads``)."""
    q, k, v = (jnp.asarray(a) for a in qkv)
    out = [np.asarray(fn(q, k, v))]
    if not grads:
        return out
    g = jax.grad(lambda *a: jnp.sum(fn(*a) ** 2), argnums=(0, 1, 2))(
        q, k, v)
    return out + [np.asarray(t) for t in g]


_WHOLE = {}


def _whole(causal, qkv):
    """Whole-sequence attention's [out, dq, dk, dv] of ``qkv``, computed
    once for the worlds that share the inputs."""
    key = (causal, *(a.tobytes() for a in qkv))
    if key not in _WHOLE:
        _WHOLE[key] = _value_and_grads(
            jax.jit(lambda q, k, v: jax_attention(q, k, v, causal=causal)),
            qkv)
    return _WHOLE[key]


def _jax_refs(kind, causal, qkv, n, grads=True):
    """(the JAX package's sequence-parallel run over n devices, whole-
    sequence attention), each [out, dq, dk, dv] (``[out]`` of the sharded
    run without ``grads``) in natural order; for zigzag the sharded run
    is fed and unpermuted in natural order."""
    whole = _whole(causal, qkv)
    fn = _jax_fn(kind, causal, n)
    if kind == "zigzag":
        s = qkv[0].shape[2]
        perm = jax_zz_perm(s, n)
        inv = jnp.argsort(perm)

        def natural(q, k, v):
            out = fn(*(jnp.take(t, perm, 2) for t in (q, k, v)))
            return jnp.take(out, inv, 2)

        return _value_and_grads(natural, qkv, grads), whole
    return _value_and_grads(fn, qkv, grads), whole


def _gathered(outs, name, kind, n):
    """The ranks' arrays concatenated along S, in natural order."""
    arrays = [np.concatenate([o[name]["arrays"][i] for o in outs], axis=2)
              for i in range(4)]
    if kind == "zigzag":
        inv = torch.argsort(zigzag_permutation(arrays[0].shape[2], n))
        arrays = [a[:, :, inv.numpy()] for a in arrays]
    return arrays


def _check(got, want, tol_out, tol_grad, what):
    names = ("out", "dq", "dk", "dv")
    for nm, a, b in zip(names, got, want):
        np.testing.assert_allclose(
            a, b, **(tol_out if nm == "out" else tol_grad),
            err_msg=f"{what}: {nm}")


# -- the tests ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_parallel_matches_jax(world, name):
    """Outputs (1e-5) and gradients (1e-4) of every case against whole-
    sequence attention, and against the JAX package's same function over
    the same number of devices: outputs in every case, gradients in the
    ``_grad`` cases (the JAX tests' split; Ulysses' through the Pallas
    kernels in interpret mode)."""
    n, spec, outs = world
    kind, causal, qkv, _ = spec[name]
    got = _gathered(outs, name, kind, n)
    sharded, whole = _jax_refs(kind, causal, qkv, n,
                               grads=name.endswith("_grad"))
    _check(got, sharded, OUT_TOL, GRAD_TOL, f"{name} vs JAX make_*, n={n}")
    _check(got, whole, OUT_TOL, GRAD_TOL, f"{name} vs attention, n={n}")


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_sequence_parallel_bf16(world, name):
    """bf16 (world 2): the output within ``BF16_ATOL`` of fp32 whole-
    sequence attention of the same bf16-rounded inputs (see the module
    docstring), and the gradients finite."""
    n, spec, outs = world
    if name not in spec:
        pytest.skip(f"bf16 cases run in the world of 2, not {n}")
    kind, causal, qkv, _ = spec[name]
    got = _gathered(outs, name, kind, n)
    whole = _value_and_grads(
        lambda q, k, v: jax_attention(q, k, v, causal=causal), qkv, False)
    np.testing.assert_allclose(got[0], whole[0], atol=BF16_ATOL, rtol=0)
    assert all(np.isfinite(g).all() for g in got[1:])


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_calls_follow_the_schedule(world, name):
    """Each rank's flash calls equal its schedule's live block pairs,
    forward and backward alike (ring ``r + 1`` causal and ``n`` not,
    zigzag ``2n + 1``, Ulysses 1)."""
    n, spec, outs = world
    kind, causal, _, _ = spec[name]
    for o in outs:
        r = o["coordinate"]
        want = 1 if kind == "ulysses" else live_pairs(
            n, r, causal=causal, zigzag=kind == "zigzag")
        if kind == "ring":
            assert want == (r + 1 if causal else n)
        if kind == "zigzag":
            assert want == 2 * n + 1
        assert o[name]["calls"] == {"fwd": want, "bwd": want}, (r, name)


@pytest.mark.parametrize("what", ["ring_indivisible", "zigzag_permutation",
                                  "zigzag_odd_shard", "ulysses_heads"])
def test_refusals_name_divisibility(world, what):
    _, _, outs = world
    for o in outs:
        assert o["refusals"][what] is not None, what
        assert "divisible" in o["refusals"][what]


def test_ring_refuses_unequal_lengths(world):
    _, _, outs = world
    for o in outs:
        assert "equal q/k/v" in o["refusals"]["ring_lengths"]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zigzag_balance_property(n):
    """The JAX test's count of live chunk pairs per device, against the
    port's schedule: equal across the ring for zigzag (2n + 1), i + 1 for
    the plain causal ring."""
    for i in range(n):
        cnt = 0
        for t in range(n):
            src = (i - t) % n
            for off_q in (i, 2 * n - 1 - i):
                for off_k in (src, 2 * n - 1 - src):
                    cnt += off_k <= off_q
        assert cnt == 2 * n + 1
        assert live_pairs(n, i, causal=True, zigzag=True) == cnt
        assert live_pairs(n, i, causal=True, zigzag=False) == i + 1
        assert live_pairs(n, i, causal=False, zigzag=False) == n


def test_zigzag_permutation_matches_jax():
    for s, n in ((64, 4), (32, 2), (48, 3)):
        np.testing.assert_array_equal(zigzag_permutation(s, n).numpy(),
                                      np.asarray(jax_zz_perm(s, n)))
        assert zigzag_permutation(s, n).dtype == torch.long
    with pytest.raises(ValueError, match="divisible"):
        zigzag_permutation(24, 8)


# -- a world of one, in this process --------------------------------------------

@pytest.fixture(scope="module")
def mesh1():
    from dcnn_tpu_torch.core.mesh import make_mesh
    from dcnn_tpu_torch.parallel import multihost

    multihost.initialize(num_processes=1, backend="gloo")
    try:
        yield make_mesh((1,), ("seq",))
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("name", ["ring", "ring_causal", "zigzag",
                                  "ulysses_causal"])
def test_world_of_one_matches_jax(mesh1, name):
    """At world 1 the ring holds one block and exchanges nothing (zigzag's
    two chunks give 3 live pairs): outputs against the JAX package over
    one device, outputs and gradients against whole-sequence attention."""
    kind, causal, _, dtype = CASES[name]
    qkv = _inputs(name, (2, 2 if kind != "ulysses" else 4, 32, 8), dtype)
    got = run_case(mesh1, kind, causal, qkv, dtype)
    if kind == "zigzag":
        inv = torch.argsort(zigzag_permutation(32, 1)).numpy()
        got = [a[:, :, inv] for a in got]
    sharded, whole = _jax_refs(kind, causal, qkv, 1, grads=False)
    _check(got, sharded, OUT_TOL, GRAD_TOL, f"{name} vs JAX make_*, n=1")
    _check(got, whole, OUT_TOL, GRAD_TOL, f"{name} vs attention, n=1")
