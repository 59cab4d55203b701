from .zoo import (
    MODEL_ZOO, create_mha_classifier, create_model,
    create_resnet18_tiny_imagenet,
)

__all__ = ["MODEL_ZOO", "create_mha_classifier", "create_model",
           "create_resnet18_tiny_imagenet"]
