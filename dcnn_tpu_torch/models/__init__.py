from .decoder import MHADecoder, create_mha_decoder
from .zoo import (
    MODEL_ZOO, create_cifar10_trainer_v1, create_cifar10_trainer_v2,
    create_cnn_cifar100, create_cnn_tiny_imagenet, create_mha_classifier,
    create_mnist_trainer, create_model,
    create_resnet9_cifar10, create_resnet9_tiny_imagenet,
    create_resnet18_cifar10, create_resnet18_tiny_imagenet,
    create_resnet20_cifar10, create_resnet34_tiny_imagenet,
    create_resnet50_cifar10, create_resnet50_imagenet,
    create_resnet50_tiny_imagenet,
)

__all__ = [
    "MODEL_ZOO", "create_model",
    "MHADecoder", "create_mha_decoder",
    "create_mnist_trainer", "create_cifar10_trainer_v1",
    "create_cifar10_trainer_v2", "create_cnn_cifar100",
    "create_mha_classifier", "create_resnet9_cifar10",
    "create_resnet18_cifar10", "create_resnet20_cifar10",
    "create_resnet50_cifar10", "create_resnet9_tiny_imagenet",
    "create_cnn_tiny_imagenet", "create_resnet18_tiny_imagenet",
    "create_resnet34_tiny_imagenet", "create_resnet50_tiny_imagenet",
    "create_resnet50_imagenet",
]
