"""The served program as an artifact (counterpart of
``dcnn_tpu/nn/export.py``).

:func:`export_inference` runs ``torch.export`` over a model's eval-mode
forward, after whatever deployment transform the caller chose
(:func:`~dcnn_tpu_torch.nn.fold.fold_batchnorm`,
:func:`~dcnn_tpu_torch.nn.quantize.quantize_model`), and saves the program
with its weights inside (``torch.export.save``, a ``.pt2`` archive).
:func:`load_inference` loads it back as a callable that needs neither the
model class, the layer registry nor a checkpoint: only PyTorch and the
port's ``dcnn::`` ops (:mod:`~dcnn_tpu_torch.ops.library`), which it
registers by importing them.

The hand-written kernels are custom ops, so each kernel call is one node
of the exported graph and a replay of the loaded program launches the same
kernels the live model launches. The int8 conv layers' packed weights and
``x_scale · w_scale`` products are made before the trace and become
constants of the program: a replay packs nothing. The graph keeps the aten
ops the live model runs (no decompositions are applied).

The batch dimension is symbolic unless ``batch_size`` pins it. Its range
starts at 1: the trace runs at an example batch of 2, since
``torch.export`` specialises a size it sees as 0 or 1, and the tests run
batch 1 through every artifact. The artifact records its input spec, its
batch (``None`` when symbolic), its precision mode, whether it is an int8
graph, and the device it was traced on (:data:`META`). A precision mode's
casts are part of the traced program: an artifact serves the mode it was
exported in.
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, Optional

import torch

from ..core.device import DeviceLike, resolve_device
from ..core.precision import get_precision_mode
from .quantize import is_int8
from .sequential import Sequential

# the artifact's own record, stored beside the program in the archive
META = "dcnn_export.json"
FORMAT = 1
# the example batch of a symbolic-batch trace (a size of 0 or 1 would be
# specialised)
EXAMPLE_BATCH = 2


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def export_inference(model: Sequential, *, batch_size: Optional[int] = None,
                     input_dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None) -> bytes:
    """Export ``model``'s eval-mode forward, weights included; returns the
    saved program's bytes.

    ``model`` is exported as given: fold or quantize it first. It is moved
    to ``device`` (CUDA unless ``"cpu"``) and set to eval mode, in place,
    as :meth:`~dcnn_tpu_torch.serve.engine.InferenceEngine.from_model` with
    ``fold=False`` does. ``batch_size=None`` exports a symbolic batch
    dimension (any batch from 1 up); an int pins it. Raises
    ``ValueError`` on a model without ``input_shape``."""
    if getattr(model, "input_shape", None) is None:
        raise ValueError("model has no input_shape; build it through "
                         "SequentialBuilder.input or set input_shape")
    dev = resolve_device(device)
    model = model.to(dev).eval()
    with torch.no_grad():
        # the int8 convs' kernel operands, made on real tensors before the
        # trace, which takes them as constants
        for m in model.modules():
            if hasattr(m, "kernel_operands"):
                m.kernel_operands()
        b = EXAMPLE_BATCH if batch_size is None else int(batch_size)
        x = torch.zeros((b, *model.input_shape), dtype=input_dtype,
                        device=dev)
        dynamic = (None if batch_size is not None else
                   {"x": {0: torch.export.Dim("batch", min=1)}})
        program = torch.export.export(model, (x,), dynamic_shapes=dynamic,
                                      strict=False)
    meta = {"format": FORMAT, "name": getattr(model, "name", "model"),
            "input_shape": [int(d) for d in model.input_shape],
            "input_dtype": _dtype_name(input_dtype),
            "batch_size": None if batch_size is None else int(batch_size),
            "precision": get_precision_mode(), "device": dev.type,
            "int8": is_int8(model)}
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META: json.dumps(meta)})
    return buf.getvalue()


class InferenceProgram:
    """A loaded artifact: ``program(x) -> logits``. ``meta`` is the
    artifact's record; ``input_shape``, ``input_dtype``, ``batch_size``
    (None: symbolic) and ``precision`` are read from it. The graph module
    runs as loaded: a call traces nothing, at any shape."""

    def __init__(self, blob: bytes):
        from ..ops import library  # noqa: F401  (registers the dcnn:: ops)

        extra = {META: ""}
        program = torch.export.load(io.BytesIO(bytes(blob)),
                                    extra_files=extra)
        if not extra[META]:
            raise ValueError("not an artifact of export_inference: the "
                             f"archive has no {META}")
        self.meta: Dict[str, Any] = json.loads(extra[META])
        self.input_shape = tuple(self.meta["input_shape"])
        self.input_dtype = getattr(torch, self.meta["input_dtype"])
        self.batch_size = self.meta["batch_size"]
        self.precision = self.meta["precision"]
        self.name = self.meta["name"]
        self.module = program.module()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.module(x)

    def __repr__(self) -> str:
        return (f"InferenceProgram({self.name!r}, input={self.input_shape}, "
                f"batch={self.batch_size or 'symbolic'}, "
                f"precision={self.precision!r})")


def load_inference(blob: bytes) -> InferenceProgram:
    """Load the bytes :func:`export_inference` returned as a callable
    ``f(x) -> logits`` (an :class:`InferenceProgram`)."""
    return InferenceProgram(blob)
