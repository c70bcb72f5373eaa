"""The FLOP and byte counts against hand-worked tiny shapes."""

from h100_bench import core, work

NODE = core.load_module("configs", "mma-node-large")
ZINC = core.load_module("configs", "zinc-mma")


def test_matmul_and_least_time():
    assert work.matmul(2, 3, 4) == 48
    peaks = {"hbm_bytes_per_s": 10.0, "f32_flops_per_s": 100.0}
    assert work.least_seconds(1000.0, 20.0, peaks, "f32") == 10.0
    assert work.least_seconds(100.0, 200.0, peaks, "f32") == 20.0


def test_node_step_work_by_hand():
    # 2 nodes, 2 edges, one feature, hidden 1, one class, one aggregator.
    cfg = {"num_nodes": 2, "num_features": 1, "hidden": 1, "num_classes": 1,
           "aggregators": ["mean"]}
    w = NODE.step_work(cfg, e=2, n_train=1)
    # MMA forward: c and d (2 x 2·2·1·1 = 8); per edge lane: logit add,
    # sigmoid (3), dropout, message product, sum = 7 x 2 edges = 14; mean
    # combine 2 x 2 = 4; no second aggregator; parity scale 2; @ W 4;
    # propagation 2 edges; bias 2.
    mma_fwd = 8 + 14 + 4 + 0 + 2 + 4 + 2 + 2
    # MMA backward: propagation 2; dW and d(scaled) 8; scale 2; combine 4;
    # per edge lane 9 x 2 = 18; the projections' weight and input
    # gradients 4 x 4 = 16.
    mma_bwd = 2 + 8 + 2 + 4 + 18 + 16
    assert w["mma_layer"]["flops"] == mma_fwd + mma_bwd
    gcn = (4 + 2 + 6) + (4 + 2 + 4)  # x W, propagation, bias/relu/dropout; backward
    head = 5 * 2 + 3 * 2 + 2 * 1  # log-softmax and its backward, the NLL
    adam = 12 * (1 + 1 + 2 + 1 + 1)  # 6 parameters
    assert w["step"]["flops"] == mma_fwd + mma_bwd + gcn + head + adam
    graph = 2 * 2 * 4 + 3 * 4  # src, dst; row offsets
    assert w["mma_layer"]["bytes"] == graph + 4 * (1 + 1 + 1 + 1) * 2 + 2 * 4 * (2 + 1 + 1)
    assert w["step"]["bytes"] == graph + 2 * 4 + 2 * 8 + 1 * 8 + 6 * 4 * 6


def test_zinc_forward_work_by_hand():
    cfg = {"hidden": 2, "edge_hidden": 1, "towers": 1, "aggregators": ["min", "max"],
           "scalers": ["identity", "amplification", "linear"], "num_layers": 1,
           "mlp_sizes": [2, 1]}
    w = ZINC.forward_work(cfg, n=3, m=2, g=1, n_params=10)
    layer = (8 + 4  # edge encoder and its bias
             + 48  # dst and src projections, 2 x 2·3·2·2
             + 16  # edge block, 2·2·2·2
             + 12 + 8  # message adds (3 a lane), min and max
             + 24  # amplification and linear on both aggregates
             + 168 + 6  # post-NN 2·3·14·2 and bias
             + 24 + 6  # lin and bias
             + 30)  # BatchNorm and ReLU
    assert w["flops"] == layer + 6 + 5  # pool, MLP
    assert w["bytes"] == 3 * 4 + 2 * 12 + 2 * 4 + 10 * 4 + 4
