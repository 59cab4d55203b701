"""The hand-written kernels as ``dcnn::`` custom ops
(``dcnn_tpu_torch/ops/library.py``), on the CPU, where each op runs its
kernel's plain version.

- ``torch.library.opcheck`` on every op at small shapes: its schema, its
  fake rule against the real output (shapes, dtypes, strides), its
  autograd registration and its trace through AOT dispatch;
- every op exported alone (``torch.export`` of a one-op module): the graph
  holds the op as one node, and the loaded program gives the op's output
  bit for bit;
- the fake rules at the sites the served models give the ops: the 21 int8
  convs of ``resnet18_tiny_imagenet`` (NHWC, B=32, and the packed weights
  each takes) and the two flash forwards of ``mha_classifier``;
- the routes: a meta tensor gets the fake rule, the callers refuse any
  device but CUDA and the CPU and reach the ops (a CPU call counts no
  kernel launch).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from dcnn_tpu_torch.models import create_model
from dcnn_tpu_torch.ops import _kernels, library
from dcnn_tpu_torch.ops.attention import flash_attention
from dcnn_tpu_torch.ops.pallas.conv import fuse_pair_weights

OPS = {op._qualname.split("::")[1]: op for op in library.OPS}


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _randn(*shape, seed=0, dtype=torch.float32):
    return torch.randn(shape, generator=_gen(seed)).to(dtype)


def _int8(*shape, seed=0):
    return torch.randint(-127, 128, shape, generator=_gen(seed),
                         dtype=torch.int8)


def _cases():
    """{op name: [(args, kwargs)]} at small shapes."""
    q, k, v = (_randn(2, 2, 5, 8, seed=s) for s in range(3))
    o, lse = OPS["flash_fwd"](q, k, v, True, 0.3)
    do = _randn(2, 2, 5, 8, seed=4)
    delta = (do * o).sum(-1)
    x = _randn(2, 4, 6, 3, seed=5)
    w = _randn(3, 3, 3, 4, seed=6)
    sc, sh = _randn(3, seed=7), _randn(3, seed=8)
    xi = _int8(2, 3, 6, 5, seed=9)
    wi = _int8(4, 3, 3, 3, seed=10)
    xs = torch.tensor([0.02])
    scale = (xs * torch.rand(4, generator=_gen(11)) / 100).float()
    bias = _randn(4, seed=12)
    xf = _randn(2, 6, 5, 3, seed=13)
    return {
        "flash_fwd": [((q, k, v, False, 0.35), {}),
                      ((q, k[:, :, :3], v[:, :, :3], True, 0.35), {})],
        "flash_bwd_dq": [((q, k, v, do, lse, delta, True, 0.3), {})],
        "flash_bwd_dkv": [((q, k, v, do, lse, delta, True, 0.3), {})],
        "conv3x3_s1": [((x, w, torch.float32), {})],
        "conv3x3_s1_bnrelu_in": [((x, w, sc, sh, torch.float32), {})],
        "conv3x3_s1_pairs": [((x, fuse_pair_weights(w), torch.float32), {})],
        "fused_scale_bias_relu": [((x, sc, sh), {})],
        "conv_int8": [((xi, wi, [1, 1], [1, 1], "NCHW", None), {}),
                      ((xi.permute(0, 2, 3, 1).contiguous(), wi, [2, 1],
                        [0, 1], "NHWC", None), {})],
        "conv_int8_fused": [
            ((xf, xs, wi, scale, bias, [1, 1], [1, 1], "NHWC", None), {}),
            ((xf.permute(0, 3, 1, 2).contiguous(), xs, wi, scale, None,
              [2, 2], [0, 0], "NCHW", None), {})],
        "pack_int8_weight": [((wi,), {}), ((_int8(7, 70, 1, 1),), {})],
        "dense_int8": [((_int8(5, 7, seed=14), _int8(3, 7, seed=15)), {}),
                       ((_int8(2, 4, 7, seed=16), _int8(3, 7, seed=17)),
                        {})],
    }


CASES = _cases()


def test_every_wrapper_has_an_op():
    """Every kernel wrapper of ``_kernels`` is an op, and ``dense_int8``
    (``torch._int_mm`` behind its padding) one more."""
    wrappers = ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "conv3x3_s1",
                "conv3x3_s1_bnrelu_in", "conv3x3_s1_pairs",
                "fused_scale_bias_relu", "conv_int8", "conv_int8_fused",
                "pack_int8_weight"]
    assert sorted(OPS) == sorted(CASES) == sorted(wrappers + ["dense_int8"])
    for name in OPS:
        assert hasattr(torch.ops.dcnn, name)
    for name in wrappers:
        assert hasattr(_kernels, name)  # the wrapper the CUDA route calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck(name):
    for args, kwargs in CASES[name]:
        torch.library.opcheck(OPS[name], args, kwargs)


def test_opcheck_flash_forward_with_gradients():
    q, k, v = (_randn(1, 2, 4, 8, seed=s).requires_grad_() for s in range(3))
    torch.library.opcheck(OPS["flash_fwd"], (q, k, v, True, 0.3))


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_op_module_exports(name):
    """A module whose forward is the op alone exports to a graph with the
    op as its one call, and the loaded program reproduces the op bit for
    bit."""
    import io

    args, _ = CASES[name][0]
    tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    op = OPS[name]

    class One(torch.nn.Module):
        def forward(self, *ts):
            full = list(args)
            for i, t in zip(tensors, ts):
                full[i] = t
            return op(*full)

    inputs = tuple(args[i] for i in tensors)
    prog = torch.export.export(One(), inputs, strict=False)
    calls = [n.target for n in prog.graph.nodes if n.op == "call_function"]
    assert getattr(torch.ops.dcnn, name).default in calls
    buf = io.BytesIO()
    torch.export.save(prog, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue())).module()
    want, got = op(*args), loaded(*inputs)
    for a, b in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (want, got))):
        assert torch.equal(a, b)


def _conv_sites(layers, shape):
    """(per-sample NHWC input shape, conv layer) of every conv under
    ``layers``, residual shortcuts included."""
    for layer in layers:
        if layer.type_name == "residual_block":
            yield from _conv_sites(layer.layers, shape)
            yield from _conv_sites(layer.shortcut, shape)
        elif layer.type_name == "conv2d":
            yield shape, layer
        shape = layer.output_shape(shape)


def test_fake_rules_at_the_resnet18_int8_sites():
    """The int8 conv's and the packing's fake rules give, at each of the
    21 conv sites of NHWC ``resnet18_tiny_imagenet`` at B=32, the shapes
    the plain versions give (run at B=1) and the int8 plan expects."""
    model = create_model("resnet18_tiny_imagenet", "NHWC")
    sites = list(_conv_sites(model.layers, model.input_shape))
    assert len(sites) == 21
    for (h, w, c), layer in sites:
        o = layer.out_channels
        r, s = layer.kernel_size
        stride, pad = list(layer.stride), list(layer.padding)
        wq = torch.zeros((o, c, r, s), dtype=torch.int8)
        x1 = torch.zeros((1, h, w, c))
        real = OPS["conv_int8_fused"](x1, torch.tensor([1.0]), wq,
                                      torch.ones(o), None, stride, pad,
                                      "NHWC", None)
        packed = OPS["pack_int8_weight"](wq)
        with FakeTensorMode() as mode:
            fx = mode.from_tensor(torch.zeros((32, h, w, c)))
            fw = mode.from_tensor(wq)
            fake = OPS["conv_int8_fused"](fx, mode.from_tensor(
                torch.tensor([1.0])), fw, mode.from_tensor(torch.ones(o)),
                None, stride, pad, "NHWC", None)
            fpack = OPS["pack_int8_weight"](fw)
        assert tuple(fake.shape) == (32, *real.shape[1:])
        assert fake.dtype == real.dtype == torch.float32
        assert fpack.shape == packed.shape
        plan = _kernels.conv_int8_plan(32, c, h, w, o, r, s, tuple(stride),
                                       tuple(pad), torch.float32, 132,
                                       channels_last=True)
        assert tuple(fpack.shape) == (plan.tiles_n * plan.bn,
                                      plan.chunks * _kernels.INT8_CHUNK)


def test_fake_rules_at_the_mha_sites():
    """``mha_classifier``'s two flash forwards at B=32: (32, 4, 32, 16)
    fp32 in, O the same and logsumexp (32, 4, 32) fp32 out, as the plain
    version gives them."""
    q = _randn(32, 4, 32, 16)
    o, lse = OPS["flash_fwd"](q, q, q, False, 0.25)
    with FakeTensorMode() as mode:
        fq = mode.from_tensor(q)
        fo, flse = OPS["flash_fwd"](fq, fq, fq, False, 0.25)
    assert (fo.shape, fo.dtype, fo.stride()) == (o.shape, o.dtype, o.stride())
    assert (flse.shape, flse.dtype) == (lse.shape, lse.dtype) == (
        (32, 4, 32), torch.float32)


def test_callers_reach_the_ops_and_count_no_cpu_launch():
    """``flash_attention`` forward and backward on CPU tensors run the ops'
    plain versions: the gradients are the plain backward's, and no kernel
    launch is counted."""
    from dcnn_tpu_torch.ops.attention import (flash_backward_reference,
                                              flash_forward_reference)

    before = tuple(w.launches for w in _kernels.COUNTED)
    q, k, v = (_randn(1, 2, 6, 8, seed=s).requires_grad_() for s in range(3))
    out = flash_attention(q, k, v, causal=True)
    g = _randn(1, 2, 6, 8, seed=9)
    out.backward(g)
    o, lse = flash_forward_reference(q.detach(), k.detach(), v.detach(),
                                     causal=True, scale=8 ** -0.5)
    assert torch.equal(out.detach(), o)
    want = flash_backward_reference(q.detach(), k.detach(), v.detach(), o,
                                    lse, g, causal=True, scale=8 ** -0.5)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)
    assert tuple(w.launches for w in _kernels.COUNTED) == before


def test_no_route_for_another_device():
    """A meta tensor gets the fake rule (shapes only, nothing computed);
    the callers refuse any device but CUDA and the CPU."""
    x = torch.zeros((1, 4, 4, 2), device="meta")
    w = torch.zeros((3, 3, 2, 2), device="meta")
    y = OPS["conv3x3_s1"](x, w, torch.bfloat16)
    assert (y.device.type, tuple(y.shape), y.dtype) == (
        "meta", (1, 4, 4, 2), torch.bfloat16)
    from dcnn_tpu_torch.ops.pallas import conv3x3_s1

    with pytest.raises(RuntimeError, match="no implementation"):
        conv3x3_s1(x, w)


def test_pack_counts_and_the_packed_shape_rule():
    """``packed_int8_shape`` is the shape ``pack_int8_weight`` gives, and
    each pack is counted on ``_kernels.pack_int8_weight.calls``."""
    for shape in ((64, 3, 3, 3), (200, 512, 1, 1), (5, 70, 3, 3)):
        before = _kernels.pack_int8_weight.calls
        packed = OPS["pack_int8_weight"](torch.zeros(shape, dtype=torch.int8))
        assert tuple(packed.shape) == library.packed_int8_shape(shape)
        assert _kernels.pack_int8_weight.calls == before + 1
    assert np.all(library.int8_out_shape((2, 9, 9, 3), (4, 3, 3, 3),
                                         (2, 2), (1, 1), "NHWC")
                  == np.array((2, 5, 5, 4)))
