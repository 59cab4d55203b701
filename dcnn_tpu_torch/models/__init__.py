from .decoder import MHADecoder, create_mha_decoder
from .zoo import (
    MODEL_ZOO, create_mha_classifier, create_model,
    create_resnet18_tiny_imagenet,
)

__all__ = ["MHADecoder", "MODEL_ZOO", "create_mha_classifier",
           "create_mha_decoder", "create_model",
           "create_resnet18_tiny_imagenet"]
