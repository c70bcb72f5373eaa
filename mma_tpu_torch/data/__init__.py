from mma_tpu_torch.data.planetoid import PlanetoidData, load_planetoid
from mma_tpu_torch.data.synthetic import powerlaw_edges, synthetic_powerlaw

__all__ = ["PlanetoidData", "load_planetoid", "powerlaw_edges", "synthetic_powerlaw"]
