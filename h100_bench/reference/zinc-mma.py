"""The plain reference of ``zinc-mma``: the ZINC regressor's eval forward in
plain PyTorch, float32 with TF32 off, one request at a time over its
molecules as one disjoint union (no padding, no layout).

It follows the reference code's model (github.com/asarigun/mma,
``graph_regression/mma.py`` and ``mma_conv.py``) under its parity
readings, layer by layer:

    e_l   = edge_emb[type] @ We_l + be_l                      (edge encoder)
    msg_t = [x_dst || x_src || e_l] @ P_t + p_t    (tower t, the LAST
            aggregator's pre-NN for every aggregator: N6)
    r_a   = min / max of msg over each atom's in-bonds (0 if none)
    [r, r*amp, r*amp*lin] with amp = log(deg+1)/avg_log and
            lin = deg/avg_lin                         (compounded: N9)
    out_t = [x || the scaled r's, scaler-major] @ Q_t + q_t   (post-NN)
    x     = relu(BN_eval(concat_t(out_t) @ L + l))

then the sum over each molecule's atoms and the MLP (75, 50, 25, 1). The
degree statistics are the reference code's, over the histogram's counts
(parity). It imports nothing of the program; the weights come under the
program's parameter names, which is how the benchmark hands one set of
weights to both.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def avg_deg(hist: np.ndarray) -> Dict[str, float]:
    h = np.asarray(hist, np.float32)
    return {"lin": float(h.mean(dtype=np.float32)),
            "log": float(np.log(h + np.float32(1)).mean(dtype=np.float32))}


def _scatter(msg: torch.Tensor, dst: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    out = torch.zeros((n, msg.shape[1]), device=msg.device)
    idx = dst[:, None].expand_as(msg)
    return out.scatter_reduce(0, idx, msg, reduce=reduce, include_self=False)


def _forward(w: Dict[str, torch.Tensor], cfg: Dict, stats: Dict[str, float], types, src, dst,
             etypes, graph_of, g: int) -> torch.Tensor:
    h, t = cfg["hidden"], cfg["towers"]
    n = types.shape[0]
    aggs = list(cfg["aggregators"])
    last = len(aggs) - 1
    x = w["node_emb.table"][types]
    e_emb = w["edge_emb.table"][etypes]
    deg = torch.clamp(torch.bincount(dst, minlength=n).float(), min=1.0)[:, None]
    amp = torch.log(deg + 1) / stats["log"]
    lin = deg / stats["lin"]
    for li in range(cfg["num_layers"]):
        c = f"conv{li}."
        enc = e_emb @ w[c + "edge_encoder.w"] + w[c + "edge_encoder.b"]
        outs = []
        for ti in range(t):
            pw = w[f"{c}pre_nns.{last}.{ti}.0.w"]
            msg = (x[dst] @ pw[:h] + x[src] @ pw[h:2 * h] + enc @ pw[2 * h:]
                   + w[f"{c}pre_nns.{last}.{ti}.0.b"])
            red = {a: _scatter(msg, dst, n, {"min": "amin", "max": "amax"}[a]) for a in aggs}
            scaled = []
            for a in aggs:
                cur = red[a]
                per = []
                for s in cfg["scalers"]:
                    if s == "amplification":
                        cur = cur * amp
                    elif s == "linear":
                        cur = cur * lin
                    elif s != "identity":
                        raise ValueError(f"this reference has no scaler {s!r}")
                    per.append(cur)
                scaled.append(per)
            pieces = [x] + [scaled[ai][si] for si in range(len(cfg["scalers"]))
                            for ai in range(len(aggs))]
            tower_in = torch.cat(pieces, dim=1)
            outs.append(tower_in @ w[f"{c}post_nns.{ti}.0.w"] + w[f"{c}post_nns.{ti}.0.b"])
        y = torch.cat(outs, dim=1) @ w[c + "lin.w"] + w[c + "lin.b"]
        b = f"bn{li}."
        y = (y - w[b + "mean"]) * torch.rsqrt(w[b + "var"] + 1e-5) * w[b + "scale"] + w[b + "bias"]
        x = torch.relu(y)
    pooled = torch.zeros((g, h), device=x.device).index_add_(0, graph_of, x)
    sizes = cfg["mlp_sizes"]
    for i in range(len(sizes) - 1):
        pooled = pooled @ w[f"mlp.layer{i}.w"] + w[f"mlp.layer{i}.b"]
        if i + 1 < len(sizes) - 1:
            pooled = torch.relu(pooled)
    return pooled[:, 0]


def predict(inputs: Dict, cfg: Dict, requests: Sequence[np.ndarray]) -> Dict[int, np.ndarray]:
    """Predictions of each request (a sequence of molecule ids), keyed by
    the request's position in ``requests``."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            return _predict(inputs, cfg, requests)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])


def _predict(inputs, cfg, requests):
    m = inputs["molecules"]
    w = {k: v.float() for k, v in inputs["weights"].items()}
    dev = next(iter(w.values())).device
    stats = avg_deg(m.degree_histogram())
    out = {}
    for ri, ids in enumerate(requests):
        counts = m.num_nodes[ids]
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        types = np.concatenate([m.node_types[i] for i in ids])
        src = np.concatenate([m.edge_src[i] + o for i, o in zip(ids, offs)])
        dst = np.concatenate([m.edge_dst[i] + o for i, o in zip(ids, offs)])
        et = np.concatenate([m.edge_types[i] for i in ids])
        graph_of = np.repeat(np.arange(len(ids)), counts)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        pred = _forward(w, cfg, stats, t(types), t(src), t(dst), t(et), t(graph_of), len(ids))
        out[ri] = pred.cpu().numpy()
    return out
