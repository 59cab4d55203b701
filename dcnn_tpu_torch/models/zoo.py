"""Model zoo (counterpart of ``dcnn_tpu/models/zoo.py``).

The port carries ``mha_classifier``; every other name of the JAX zoo raises
``NotImplementedError`` until its layers are ported (ROADMAP.md). Models
come back without parameters: call ``model.init(generator=..., device=...)``
or carry JAX weights over with :func:`dcnn_tpu_torch.interop.from_jax`.
"""

from __future__ import annotations

from ..nn.attention_layer import MultiHeadAttentionLayer
from ..nn.builder import SequentialBuilder
from ..nn.residual import ResidualBlock
from ..nn.sequential import Sequential


def create_mha_classifier(data_format: str = "NCHW") -> Sequential:
    """Self-attention sequence classifier: two residual MHA blocks (4 heads,
    ``impl="flash"``) + flatten + dense(10) head on (S=32, E=64) inputs.
    ``data_format`` is accepted for zoo-signature uniformity and ignored."""

    def attn_block(name: str) -> ResidualBlock:
        return ResidualBlock(
            layers=[MultiHeadAttentionLayer(num_heads=4, impl="flash",
                                            name=f"{name}_mha")],
            shortcut=[], activation="relu", name=name)

    return (SequentialBuilder("mha_classifier")
            .input((32, 64))
            .add_layer(attn_block("attn0"))
            .add_layer(attn_block("attn1"))
            .flatten("flatten")
            .dense(10, True, "head")
            .build())


MODEL_ZOO = {"mha_classifier": create_mha_classifier}

# names of the JAX zoo whose layers the port does not have yet
NOT_PORTED = (
    "mnist_cnn", "cifar10_cnn_v1", "cifar10_cnn_v2", "cnn_cifar100",
    "resnet9_cifar10", "resnet18_cifar10", "resnet20_cifar10",
    "resnet50_cifar10", "resnet9_tiny_imagenet", "cnn_tiny_imagenet",
    "resnet18_tiny_imagenet", "resnet34_tiny_imagenet",
    "resnet50_tiny_imagenet", "resnet50_imagenet", "mha_decoder",
)


def create_model(name: str, data_format: str = "NCHW") -> Sequential:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to dcnn_tpu_torch yet; see the "
            f"port's queue in ROADMAP.md")
    if name not in MODEL_ZOO:
        raise ValueError(f"unknown model {name!r}; known: "
                         f"{sorted(MODEL_ZOO) + sorted(NOT_PORTED)}")
    return MODEL_ZOO[name](data_format)
