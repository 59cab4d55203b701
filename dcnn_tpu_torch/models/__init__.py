from .zoo import MODEL_ZOO, create_mha_classifier, create_model

__all__ = ["MODEL_ZOO", "create_mha_classifier", "create_model"]
