from mma_tpu_torch.models.node_classifier import NodeClassifier

__all__ = ["NodeClassifier"]
