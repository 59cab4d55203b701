"""Model zoo (counterpart of ``dcnn_tpu/models/zoo.py``).

Every CNN of the JAX zoo, its builder calls copied (layer names, widths,
strides, bias flags and BN epsilons as there, the reference's quirks
included), ``mha_classifier`` and ``mha_decoder`` (an
:class:`~dcnn_tpu_torch.models.decoder.MHADecoder`, not a ``Sequential``).
Every builder takes ``data_format``. Models come back without parameters:
call ``model.init(generator=..., device=...)`` or carry JAX weights over
with :func:`dcnn_tpu_torch.interop.from_jax` (``decoder_from_jax`` for the
decoder).
"""

from __future__ import annotations

from typing import Callable, Dict, Union

from ..nn.attention_layer import MultiHeadAttentionLayer
from ..nn.builder import SequentialBuilder
from ..nn.residual import ResidualBlock
from ..nn.sequential import Sequential
from .decoder import MHADecoder, create_mha_decoder


def create_mnist_trainer(data_format: str = "NCHW") -> Sequential:
    """LeNet-style MNIST CNN (example_models.hpp:13-31)."""
    shape = (1, 28, 28) if data_format == "NCHW" else (28, 28, 1)
    return (SequentialBuilder("mnist_cnn_model", data_format)
            .input(shape)
            .conv2d(8, 5, 1, 0, True, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
            .maxpool2d(3, 3, 0, "pool1")
            .conv2d(16, 1, 1, 0, True, "conv2_1x1").batchnorm(name="bn2").activation("relu", "relu2")
            .conv2d(48, 5, 1, 0, True, "conv3").batchnorm(name="bn3").activation("relu", "relu3")
            .maxpool2d(2, 2, 0, "pool2")
            .flatten("flatten")
            .dense(10, True, "output")
            .build())


def create_cifar10_trainer_v1(data_format: str = "NCHW") -> Sequential:
    """Small CIFAR-10 CNN (example_models.hpp:33-48)."""
    shape = (3, 32, 32) if data_format == "NCHW" else (32, 32, 3)
    return (SequentialBuilder("cifar10_cnn_classifier_v1", data_format)
            .input(shape)
            .conv2d(16, 3, 1, 0, True, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
            .maxpool2d(3, 3, 0, "maxpool1")
            .conv2d(64, 3, 1, 0, True, "conv2").activation("relu", "relu2")
            .maxpool2d(4, 4, 0, "maxpool2")
            .flatten("flatten")
            .dense(10, True, "fc1")
            .build())


def create_cifar10_trainer_v2(data_format: str = "NCHW") -> Sequential:
    """VGG-style CIFAR-10 CNN (example_models.hpp:50-93)."""
    shape = (3, 32, 32) if data_format == "NCHW" else (32, 32, 3)
    b = (SequentialBuilder("cifar10_cnn_classifier", data_format)
         .input(shape)
         .conv2d(64, 3, 1, 1, False, "conv0").batchnorm(name="bn0").activation("relu", "relu0")
         .conv2d(64, 3, 1, 1, False, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
         .maxpool2d(2, 2, 0, "pool0")
         .conv2d(128, 3, 1, 1, False, "conv2").batchnorm(name="bn2").activation("relu", "relu2")
         .conv2d(128, 3, 1, 1, False, "conv3").batchnorm(name="bn3").activation("relu", "relu3")
         .maxpool2d(2, 2, 0, "pool1")
         .conv2d(256, 3, 1, 1, False, "conv4").batchnorm(name="bn5").activation("relu", "relu5")
         .conv2d(256, 3, 1, 1, False, "conv5").activation("relu", "relu6")
         .conv2d(256, 3, 1, 1, False, "conv6").batchnorm(name="bn6").activation("relu", "relu6b")
         .maxpool2d(2, 2, 0, "pool2")
         .conv2d(512, 3, 1, 1, False, "conv7").batchnorm(name="bn8").activation("relu", "relu7")
         .conv2d(512, 3, 1, 1, False, "conv8").batchnorm(name="bn9").activation("relu", "relu8")
         .conv2d(512, 3, 1, 1, False, "conv9").batchnorm(name="bn10").activation("relu", "relu9")
         .maxpool2d(2, 2, 0, "pool3")
         .flatten("flatten")
         .dense(512, True, "fc0").activation("relu", "relu10")
         .dense(10, True, "fc1"))
    return b.build()


def create_cnn_cifar100(data_format: str = "NCHW") -> Sequential:
    """CIFAR-100 CNN: the reference's cifar100 trainer reuses the VGG-style
    cifar10_v2 architecture verbatim (examples/cifar100_cnn_trainer.cpp:40-79)
    — including a final ``dense(10)`` head even though CIFAR-100 has 100
    classes (a latent reference bug: its loader one-hots to 100). Reproduced
    layer-for-layer except the head, deliberately corrected to 100."""
    shape = (3, 32, 32) if data_format == "NCHW" else (32, 32, 3)
    b = (SequentialBuilder("cifar100_cnn_classifier", data_format)
         .input(shape)
         .conv2d(64, 3, 1, 1, False, "conv0").batchnorm(name="bn0").activation("relu", "relu0")
         .conv2d(64, 3, 1, 1, False, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
         .maxpool2d(2, 2, 0, "pool0")
         .conv2d(128, 3, 1, 1, False, "conv2").batchnorm(name="bn2").activation("relu", "relu2")
         .conv2d(128, 3, 1, 1, False, "conv3").batchnorm(name="bn3").activation("relu", "relu3")
         .maxpool2d(2, 2, 0, "pool1")
         .conv2d(256, 3, 1, 1, False, "conv4").batchnorm(name="bn5").activation("relu", "relu5")
         .conv2d(256, 3, 1, 1, False, "conv5").activation("relu", "relu6")
         .conv2d(256, 3, 1, 1, False, "conv6").batchnorm(name="bn6").activation("relu", "relu6b")
         .maxpool2d(2, 2, 0, "pool2")
         .conv2d(512, 3, 1, 1, False, "conv7").batchnorm(name="bn8").activation("relu", "relu7")
         .conv2d(512, 3, 1, 1, False, "conv8").batchnorm(name="bn9").activation("relu", "relu8")
         .conv2d(512, 3, 1, 1, False, "conv9").batchnorm(name="bn10").activation("relu", "relu9")
         .maxpool2d(2, 2, 0, "pool3")
         .flatten("flatten")
         .dense(512, True, "fc0").activation("relu", "relu10")
         .dense(100, True, "fc1"))
    return b.build()


def create_resnet9_cifar10(data_format: str = "NCHW") -> Sequential:
    """ResNet-9 (example_models.hpp:95-134)."""
    shape = (3, 32, 32) if data_format == "NCHW" else (32, 32, 3)
    return (SequentialBuilder("ResNet-9-CIFAR10", data_format)
            .input(shape)
            .conv2d(64, 3, 1, 1, True, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
            .conv2d(128, 3, 1, 1, True, "conv2").batchnorm(name="bn2").activation("relu", "relu2")
            .maxpool2d(2, 2, 0, "pool1")
            .basic_residual_block(128, 128, 1, "res_block1")
            .basic_residual_block(128, 128, 1, "res_block2")
            .conv2d(256, 3, 1, 1, True, "conv3").batchnorm(name="bn3").activation("relu", "relu3")
            .maxpool2d(2, 2, 0, "pool2")
            .basic_residual_block(256, 256, 1, "res_block3")
            .basic_residual_block(256, 256, 1, "res_block4")
            .conv2d(512, 3, 1, 1, True, "conv4").batchnorm(name="bn4").activation("relu", "relu4")
            .maxpool2d(2, 2, 0, "pool3")
            .basic_residual_block(512, 512, 1, "res_block5")
            .avgpool2d(4, 1, 0, "avgpool")
            .flatten("flatten")
            .dense(10, True, "output")
            .build())


def create_resnet18_cifar10(data_format: str = "NCHW") -> Sequential:
    """ResNet-18 CIFAR-10 (example_models.hpp:136-163; note the reference uses
    11 basic blocks with a commented-out 12th — reproduced as-is)."""
    shape = (3, 32, 32) if data_format == "NCHW" else (32, 32, 3)
    return (SequentialBuilder("ResNet-18-CIFAR10", data_format)
            .input(shape)
            .conv2d(64, 3, 1, 1, True, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
            .basic_residual_block(64, 64, 1, "layer1_block1")
            .basic_residual_block(64, 64, 1, "layer1_block2")
            .basic_residual_block(64, 128, 2, "layer2_block1")
            .basic_residual_block(128, 128, 1, "layer2_block2")
            .basic_residual_block(128, 128, 1, "layer2_block3")
            .basic_residual_block(128, 256, 2, "layer3_block1")
            .basic_residual_block(256, 256, 1, "layer3_block2")
            .basic_residual_block(256, 256, 1, "layer3_block3")
            .basic_residual_block(256, 512, 2, "layer4_block1")
            .basic_residual_block(512, 512, 1, "layer4_block2")
            .avgpool2d(4, 4, 0, "avgpool")
            .flatten("flatten")
            .dense(10, True, "output")
            .build())


def create_resnet20_cifar10(data_format: str = "NCHW") -> Sequential:
    """ResNet-20 CIFAR-10 (example_models.hpp:165-192)."""
    shape = (3, 32, 32) if data_format == "NCHW" else (32, 32, 3)
    return (SequentialBuilder("ResNet-20-CIFAR10", data_format)
            .input(shape)
            .conv2d(64, 3, 1, 1, True, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
            .basic_residual_block(64, 64, 1, "layer1_block1")
            .basic_residual_block(64, 64, 1, "layer1_block2")
            .basic_residual_block(64, 64, 1, "layer1_block3")
            .basic_residual_block(64, 128, 2, "layer2_block1")
            .basic_residual_block(128, 128, 1, "layer2_block2")
            .basic_residual_block(128, 128, 1, "layer2_block3")
            .basic_residual_block(128, 256, 2, "layer3_block1")
            .basic_residual_block(256, 256, 1, "layer3_block2")
            .basic_residual_block(256, 256, 1, "layer3_block3")
            .avgpool2d(8, 1, 0, "avgpool")
            .flatten("flatten")
            .dense(10, True, "output")
            .build())


def create_resnet50_cifar10(data_format: str = "NCHW") -> Sequential:
    """ResNet-50 CIFAR-10 (example_models.hpp:194-225; the reference flattens
    the 4×4×2048 map directly — no avgpool — reproduced as-is)."""
    shape = (3, 32, 32) if data_format == "NCHW" else (32, 32, 3)
    b = (SequentialBuilder("ResNet-50-CIFAR10", data_format)
         .input(shape)
         .conv2d(64, 3, 1, 1, True, "conv1").batchnorm(name="bn1").activation("relu", "relu1"))
    _resnet50_body(b, 64)
    return b.flatten("flatten").dense(10, True, "fc").build()


def _resnet50_body(b: SequentialBuilder, cin: int) -> SequentialBuilder:
    """The four bottleneck stages shared by every ResNet-50 variant
    (example_models.hpp:199-221/:377-395)."""
    b.bottleneck_residual_block(cin, 64, 256, 1, "layer1_block1")
    b.bottleneck_residual_block(256, 64, 256, 1, "layer1_block2")
    b.bottleneck_residual_block(256, 64, 256, 1, "layer1_block3")
    b.bottleneck_residual_block(256, 128, 512, 2, "layer2_block1")
    for i in (2, 3, 4):
        b.bottleneck_residual_block(512, 128, 512, 1, f"layer2_block{i}")
    b.bottleneck_residual_block(512, 256, 1024, 2, "layer3_block1")
    for i in (2, 3, 4, 5, 6):
        b.bottleneck_residual_block(1024, 256, 1024, 1, f"layer3_block{i}")
    b.bottleneck_residual_block(1024, 512, 2048, 2, "layer4_block1")
    for i in (2, 3):
        b.bottleneck_residual_block(2048, 512, 2048, 1, f"layer4_block{i}")
    return b


def create_resnet9_tiny_imagenet(data_format: str = "NCHW") -> Sequential:
    """ResNet-9 Tiny-ImageNet (example_models.hpp:227-260)."""
    shape = (3, 64, 64) if data_format == "NCHW" else (64, 64, 3)
    return (SequentialBuilder("ResNet-9-Tiny-ImageNet", data_format)
            .input(shape)
            .conv2d(64, 3, 1, 1, False, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
            .conv2d(128, 3, 1, 1, False, "conv2").batchnorm(name="bn2").activation("relu", "relu2")
            .maxpool2d(2, 2, 0, "pool1")
            .basic_residual_block(128, 128, 1, "res1")
            .conv2d(256, 3, 1, 1, False, "conv3").batchnorm(name="bn3").activation("relu", "relu3")
            .maxpool2d(2, 2, 0, "pool2")
            .basic_residual_block(256, 256, 1, "res2")
            .conv2d(512, 3, 1, 1, False, "conv4").batchnorm(name="bn4").activation("relu", "relu4")
            .maxpool2d(2, 2, 0, "pool3")
            .basic_residual_block(512, 512, 1, "res3")
            .avgpool2d(4, 1, 0, "avgpool")
            .flatten("flatten")
            .dense(200, True, "fc")
            .build())


def create_cnn_tiny_imagenet(data_format: str = "NCHW") -> Sequential:
    """VGG-style Tiny-ImageNet CNN (example_models.hpp:262-304)."""
    shape = (3, 64, 64) if data_format == "NCHW" else (64, 64, 3)
    b = (SequentialBuilder("cnn_tiny_imagenet", data_format)
         .input(shape)
         .conv2d(64, 3, 1, 1, False, "conv0").batchnorm(name="bn0").activation("relu", "relu0")
         .conv2d(64, 3, 1, 1, False, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
         .maxpool2d(2, 2, 0, "pool0")
         .conv2d(128, 3, 1, 1, False, "conv2").batchnorm(name="bn2").activation("relu", "relu2")
         .conv2d(128, 3, 1, 1, False, "conv3").batchnorm(name="bn3").activation("relu", "relu3")
         .maxpool2d(2, 2, 0, "pool1")
         .conv2d(256, 3, 1, 1, False, "conv4").batchnorm(name="bn5").activation("relu", "relu5")
         .conv2d(256, 3, 1, 1, False, "conv5").activation("relu", "relu6")
         .conv2d(256, 3, 1, 1, False, "conv6").batchnorm(name="bn6").activation("relu", "relu6b")
         .maxpool2d(2, 2, 0, "pool2")
         .conv2d(512, 3, 1, 1, False, "conv7").batchnorm(name="bn8").activation("relu", "relu7")
         .conv2d(512, 3, 1, 1, False, "conv8").batchnorm(name="bn9").activation("relu", "relu8")
         .conv2d(512, 3, 1, 1, False, "conv9").batchnorm(name="bn10").activation("relu", "relu9")
         .maxpool2d(2, 2, 0, "pool3")
         .flatten("flatten")
         .dense(1024, True, "fc0").activation("relu", "relu10")
         .dense(200, True, "fc1"))
    return b.build()


def create_resnet18_tiny_imagenet(data_format: str = "NCHW") -> Sequential:
    """ResNet-18 Tiny-ImageNet — the north-star benchmark model
    (example_models.hpp:306-332): 32-channel stem with BN eps 1e-3, maxpool,
    4 stages of basic blocks (64/128/256/512), avgpool-4, fc-200."""
    shape = (3, 64, 64) if data_format == "NCHW" else (64, 64, 3)
    return (SequentialBuilder("ResNet-18-Tiny-ImageNet", data_format)
            .input(shape)
            .conv2d(32, 3, 1, 1, False, "conv1")
            .batchnorm(1e-3, 0.1, True, "bn1")
            .activation("relu", "relu1")
            .maxpool2d(2, 2, 0, "maxpool")
            .basic_residual_block(32, 64, 1, "layer1_block1")
            .basic_residual_block(64, 64, 1, "layer1_block2")
            .basic_residual_block(64, 128, 2, "layer2_block1")
            .basic_residual_block(128, 128, 1, "layer2_block2")
            .basic_residual_block(128, 256, 2, "layer3_block1")
            .basic_residual_block(256, 256, 1, "layer3_block2")
            .basic_residual_block(256, 512, 2, "layer4_block1")
            .basic_residual_block(512, 512, 1, "layer4_block2")
            .avgpool2d(4, 1, 0, "avgpool")
            .flatten("flatten")
            .dense(200, True, "fc")
            .build())


def create_resnet34_tiny_imagenet(data_format: str = "NCHW") -> Sequential:
    """ResNet-34 Tiny-ImageNet (example_models.hpp:334-367)."""
    shape = (3, 64, 64) if data_format == "NCHW" else (64, 64, 3)
    b = (SequentialBuilder("ResNet-34-Tiny-ImageNet", data_format)
         .input(shape)
         .conv2d(32, 3, 1, 1, False, "conv1")
         .batchnorm(1e-3, 0.1, True, "bn1")
         .activation("relu", "relu1")
         .maxpool2d(2, 2, 0, "maxpool"))
    b.basic_residual_block(32, 64, 1, "layer1_block1")
    for i in (2, 3):
        b.basic_residual_block(64, 64, 1, f"layer1_block{i}")
    b.basic_residual_block(64, 128, 2, "layer2_block1")
    for i in (2, 3, 4):
        b.basic_residual_block(128, 128, 1, f"layer2_block{i}")
    b.basic_residual_block(128, 256, 2, "layer3_block1")
    for i in (2, 3, 4, 5, 6):
        b.basic_residual_block(256, 256, 1, f"layer3_block{i}")
    b.basic_residual_block(256, 512, 2, "layer4_block1")
    for i in (2, 3):
        b.basic_residual_block(512, 512, 1, f"layer4_block{i}")
    return (b.avgpool2d(4, 1, 0, "avgpool").flatten("flatten")
            .dense(200, True, "fc").build())


def create_resnet50_tiny_imagenet(data_format: str = "NCHW") -> Sequential:
    """ResNet-50 Tiny-ImageNet (example_models.hpp:369-402)."""
    shape = (3, 64, 64) if data_format == "NCHW" else (64, 64, 3)
    b = (SequentialBuilder("ResNet-50-Tiny-ImageNet", data_format)
         .input(shape)
         .conv2d(64, 3, 1, 1, True, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
         .maxpool2d(3, 2, 1, "maxpool"))
    _resnet50_body(b, 64)
    return (b.avgpool2d(4, 1, 0, "avgpool").flatten("flatten")
            .dense(200, True, "fc").build())


def create_resnet50_imagenet(data_format: str = "NCHW") -> Sequential:
    """ResNet-50 ImageNet-1k (example_models.hpp:404-437)."""
    shape = (3, 224, 224) if data_format == "NCHW" else (224, 224, 3)
    b = (SequentialBuilder("ResNet-50-ImageNet", data_format)
         .input(shape)
         .conv2d(64, 7, 2, 3, True, "conv1").batchnorm(name="bn1").activation("relu", "relu1")
         .maxpool2d(3, 2, 1, "maxpool"))
    _resnet50_body(b, 64)
    return (b.avgpool2d(7, 1, 0, "avgpool").flatten("flatten")
            .dense(1000, True, "fc").build())


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


MODEL_ZOO: Dict[str, Callable[..., Union[Sequential, MHADecoder]]] = {
    "mnist_cnn": create_mnist_trainer,
    "cifar10_cnn_v1": create_cifar10_trainer_v1,
    "cifar10_cnn_v2": create_cifar10_trainer_v2,
    "cnn_cifar100": create_cnn_cifar100,
    "resnet9_cifar10": create_resnet9_cifar10,
    "resnet18_cifar10": create_resnet18_cifar10,
    "resnet20_cifar10": create_resnet20_cifar10,
    "resnet50_cifar10": create_resnet50_cifar10,
    "resnet9_tiny_imagenet": create_resnet9_tiny_imagenet,
    "cnn_tiny_imagenet": create_cnn_tiny_imagenet,
    "resnet18_tiny_imagenet": create_resnet18_tiny_imagenet,
    "resnet34_tiny_imagenet": create_resnet34_tiny_imagenet,
    "resnet50_tiny_imagenet": create_resnet50_tiny_imagenet,
    "resnet50_imagenet": create_resnet50_imagenet,
    "mha_classifier": create_mha_classifier,
    "mha_decoder": create_mha_decoder,
}


def create_model(name: str, data_format: str = "NCHW"
                 ) -> Union[Sequential, MHADecoder]:
    if name not in MODEL_ZOO:
        raise ValueError(f"unknown model {name!r}; known: "
                         f"{sorted(MODEL_ZOO)}")
    return MODEL_ZOO[name](data_format)
