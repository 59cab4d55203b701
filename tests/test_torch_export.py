"""The served program as an artifact (``dcnn_tpu_torch/nn/export.py``), the
twins of ``tests/test_export.py`` on the CPU, where the exported graph's
``dcnn::`` ops run the kernels' plain versions.

Contracts: the loaded program equals the live model bit for bit at every
serve bucket (batch 1 included), folded and int8; the batch is symbolic
unless pinned; the artifact carries its weights (the model is gone when it
loads), its input spec and its precision mode; a repeated call traces
nothing; an exported checkpoint keeps its accuracy. And against the JAX
package: the same seeded weights, carried over with ``interop``, exported
by both packages (``dcnn_tpu.nn.export_inference(..., platforms=("cpu",))``)
and loaded, give logits within 1e-5 (folded fp32, as
``tests/test_export.py:99``), 1e-4 (``mha_classifier``, as ``:119``) and
``INT8_JAX_TOL`` of the logit scale with equal argmax (int8, as
``tests/test_torch_serve.py``).
"""

import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcnn_tpu.models import create_mha_classifier as jax_mha_classifier
from dcnn_tpu.nn import SequentialBuilder as JaxBuilder
from dcnn_tpu.nn import export_inference as jax_export
from dcnn_tpu.nn import fold_batchnorm as jax_fold
from dcnn_tpu.nn import load_inference as jax_load
from dcnn_tpu.nn import quantize_model as jax_quantize
from dcnn_tpu_torch.data import MNISTDataLoader, ensure_digits28_csvs
from dcnn_tpu_torch.interop import from_jax, state_to_jax, to_jax
from dcnn_tpu_torch.models import create_mha_classifier
from dcnn_tpu_torch.nn import (InferenceProgram, Sequential, export_inference,
                               fold_batchnorm, load_inference, quantize_model)
from dcnn_tpu_torch.ops import _kernels
from dcnn_tpu_torch.serve import InferenceEngine, serve_buckets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "model_snapshots", "mnist_cnn_model")
INT8_JAX_TOL = 1e-5  # max |port - JAX| over max |JAX logit|


def _jax_small():
    return (JaxBuilder(name="exp", data_format="NHWC").input((8, 8, 3))
            .conv2d(8, 3, padding=1).batchnorm().activation("relu")
            .maxpool2d(2).flatten().dense(10).build())


def _small(seed=0):
    """``tests/test_export.py``'s model, weights drawn by the port and the
    BN statistics at random, so folding changes the weights."""
    model = Sequential.from_config(_jax_small().get_config()).init(
        generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    bn = model.layers[1]
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, 8)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8)))
    return model.eval()


def _x(b, seed, shape=(8, 8, 3)):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(b, *shape)).astype(np.float32))


def _live(model, x):
    with torch.inference_mode():
        return model(x)


def test_export_roundtrip_matches_live_model():
    fmodel = fold_batchnorm(_small())
    blob = export_inference(fmodel, device="cpu")
    assert isinstance(blob, bytes) and len(blob) > 0
    f = load_inference(blob)
    x = _x(4, 0)
    assert torch.equal(f(x), _live(fmodel, x))


def test_export_batch_polymorphic():
    f = load_inference(export_inference(_small(), device="cpu"))
    assert f.batch_size is None
    for b in (1, 3, 16):
        assert f(_x(b, 1)).shape == (b, 10)


def test_export_pinned_batch_rejects_other_batches():
    f = load_inference(export_inference(_small(), batch_size=4,
                                        device="cpu"))
    assert f.batch_size == 4
    assert f(torch.zeros(4, 8, 8, 3)).shape == (4, 10)
    with pytest.raises(Exception):
        f(torch.zeros(2, 8, 8, 3))


def test_export_quantized_graph():
    """The int8 graph exports with its fused conv as one ``dcnn::`` node,
    the packed weights as constants (a call packs nothing), and equals the
    live int8 model."""
    qmodel = quantize_model(_small(), _x(16, 2))
    blob = export_inference(qmodel, device="cpu")
    f = load_inference(blob)
    assert f.meta["int8"]
    calls = [str(n.target) for n in f.module.graph.nodes
             if n.op == "call_function"]
    assert calls.count("dcnn.conv_int8_fused.default") == 1
    assert not any("pack_int8_weight" in c for c in calls)
    x = _x(4, 3)
    packs = _kernels.pack_int8_weight.calls
    assert torch.equal(f(x), _live(qmodel, x))
    assert _kernels.pack_int8_weight.calls == packs


def test_export_is_self_contained():
    """Only the blob is needed: the live logits computed before the export
    are reproduced after the model is deleted and collected."""
    model = _small()
    x = _x(2, 4)
    want = _live(model, x).clone()
    blob = export_inference(model, device="cpu")
    del model
    gc.collect()
    got = load_inference(blob)(x)
    assert torch.equal(got, want)
    assert want.abs().sum() > 0


def test_export_mha_model():
    """The attention family exports too, its flash forwards as two
    ``dcnn::flash_fwd`` nodes, and equals the live model."""
    model = create_mha_classifier().init(
        generator=torch.Generator().manual_seed(5), device="cpu")
    f = load_inference(export_inference(model, device="cpu"))
    calls = [str(n.target) for n in f.module.graph.nodes
             if n.op == "call_function"]
    assert calls.count("dcnn.flash_fwd.default") == 2
    x = _x(4, 5, (32, 64))
    torch.testing.assert_close(f(x), _live(model, x), rtol=0, atol=0)


def _digits28(tmp_path, split):
    d = ensure_digits28_csvs(str(tmp_path))
    ld = MNISTDataLoader(os.path.join(d, f"{split}.csv"), batch_size=20000,
                         shuffle=False, drop_last=False)
    ld.load_data()
    (x, y), = list(ld)
    x = np.asarray(x)
    xf = x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x
    return torch.from_numpy(np.ascontiguousarray(xf)), np.asarray(y)


def test_exported_checkpoint_keeps_its_accuracy(tmp_path):
    """The port cannot run the committed ``.stablehlo`` artifacts; instead
    the committed digits28 snapshot is exported through
    ``from_checkpoint`` (folded, and int8 calibrated on 64 training
    samples) into a cache under ``tmp_path``, served from the exported
    program, and scores >= 0.99 top-1 on the test split."""
    x, y = _digits28(tmp_path, "test")
    calib, _ = _digits28(tmp_path, "train")
    labels = y.argmax(-1)
    for tag, kw in (("folded", {}), ("int8", {"int8_calib": calib[:64]})):
        eng = InferenceEngine.from_checkpoint(
            SNAPSHOT, device="cpu", max_batch=512, warmup=False,
            aot_cache=str(tmp_path / "cache"), **kw)
        assert isinstance(eng._apply, InferenceProgram)
        assert eng.aot_info["program"]["committed"]
        acc = float((eng.infer(x).numpy().argmax(-1) == labels).mean())
        assert acc >= 0.99, f"{tag} program top-1 {acc}"


def test_export_requires_input_shape():
    with pytest.raises(ValueError, match="input_shape"):
        export_inference(Sequential([], name="noshape"), device="cpu")


def test_load_inference_traces_nothing_on_a_repeated_shape(monkeypatch):
    """The loaded program is a graph module run as loaded: repeated calls,
    at one shape or another, neither export, trace nor recompile."""
    import torch.fx

    f = load_inference(export_inference(_small(), device="cpu"))
    events = []
    monkeypatch.setattr(torch.fx.GraphModule, "recompile",
                        lambda self: events.append("recompile"))
    monkeypatch.setattr(torch.export, "export",
                        lambda *a, **k: events.append("export"))
    graph = f.module.graph
    x = torch.zeros(2, 8, 8, 3)
    first = f(x)
    assert torch.equal(f(x), first)
    f(torch.zeros(4, 8, 8, 3))
    assert events == [] and f.module.graph is graph


def test_roundtrip_bit_identical_at_every_serve_bucket():
    """Folded and int8 programs equal the live model bit for bit at every
    bucket an engine runs, batch 1 included (the trace ran at batch 2),
    and so does an engine built from the artifact against the engine built
    from the live model."""
    model = _small()
    calib = _x(16, 7)
    rng_seed = 8
    for tag, m in (("folded", fold_batchnorm(model)),
                   ("int8", quantize_model(model, calib))):
        blob = export_inference(m, device="cpu")
        f = load_inference(blob)
        for b in serve_buckets(8):
            x = _x(b, rng_seed + b)
            assert torch.equal(f(x), _live(m, x)), (tag, b)
        art = InferenceEngine.from_artifact(blob, device="cpu", max_batch=8)
        live = InferenceEngine(m, m.input_shape, device="cpu", max_batch=8)
        assert art.batch_invariant == (tag == "int8")
        for b in serve_buckets(8):
            x = _x(b, 20 + b)
            assert torch.equal(art.run_padded(x), live.run_padded(x)), (tag,
                                                                         b)


def test_from_artifact_reads_the_spec_and_refuses_a_pinned_batch(tmp_path):
    model = fold_batchnorm(_small())
    path = tmp_path / "model.pt2"
    path.write_bytes(export_inference(model, device="cpu"))
    eng = InferenceEngine.from_artifact(str(path), device="cpu", max_batch=4)
    assert eng.input_shape == (8, 8, 3) and eng.input_dtype == torch.float32
    assert eng.precision == "parity" and eng.bucket_sizes == [1, 2, 4]
    pinned = export_inference(model, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="pinned batch dimension"):
        InferenceEngine.from_artifact(pinned, device="cpu")


# -- against the JAX package ---------------------------------------------------

def _jax_out(blob, x):
    return np.asarray(jax_load(blob)(jnp.asarray(x.numpy())))


def test_folded_export_matches_the_jax_export():
    model = _small(3)
    jm, p, s = _jax_small(), to_jax(model), state_to_jax(model)
    x = _x(4, 9)
    want = _jax_out(jax_export(*jax_fold(jm, p, s), platforms=("cpu",)), x)
    got = load_inference(export_inference(fold_batchnorm(model),
                                          device="cpu"))(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mha_export_matches_the_jax_export():
    jm = jax_mha_classifier()
    params, state = jm.init(jax.random.PRNGKey(0), jm.input_shape)
    model = from_jax(jm.get_config(),
                     jax.tree_util.tree_map(np.asarray, params),
                     device="cpu")
    x = _x(4, 10, (32, 64))
    want = _jax_out(jax_export(jm, params, state, platforms=("cpu",)), x)
    got = load_inference(export_inference(model, device="cpu"))(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_int8_export_matches_the_jax_export():
    model = _small(4)
    jm, p, s = _jax_small(), to_jax(model), state_to_jax(model)
    calib = _x(16, 11)
    x = _x(8, 12)
    want = _jax_out(jax_export(*jax_quantize(jm, p, s,
                                             jnp.asarray(calib.numpy())),
                               platforms=("cpu",)), x)
    got = load_inference(export_inference(quantize_model(model, calib),
                                          device="cpu"))(x).numpy()
    assert np.abs(got - want).max() <= INT8_JAX_TOL * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
