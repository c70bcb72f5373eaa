"""Sizes at which the benchmark's cells run on the CPU in the tests."""

TINY = {
    "node-large-train": {"config": {"num_nodes": 2000, "avg_deg": 8}},
    "zinc-serve": {"config": {"dataset_size": 300},
                   "params": {"min_molecules": 16, "max_molecules": 32, "pool": 4}},
}
