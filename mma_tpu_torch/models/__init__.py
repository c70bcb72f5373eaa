from mma_tpu_torch.models.node_classifier import NodeClassifier
from mma_tpu_torch.models.zinc_net import ZincNet

__all__ = ["NodeClassifier", "ZincNet"]
