from mma_tpu_torch.data.batching import batch_graphs
from mma_tpu_torch.data.planetoid import PlanetoidData, load_planetoid
from mma_tpu_torch.data.synthetic import powerlaw_edges, synthetic_powerlaw
from mma_tpu_torch.data.zinc import ZincDataset, load_zinc

__all__ = ["PlanetoidData", "ZincDataset", "batch_graphs", "load_planetoid", "load_zinc",
           "powerlaw_edges", "synthetic_powerlaw"]
