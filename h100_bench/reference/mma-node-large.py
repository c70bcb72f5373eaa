"""The plain reference of ``mma-node-large``: full-batch training steps of
the MMA node classifier in plain PyTorch, float32 with TF32 off.

It follows the reference code's model (github.com/asarigun/mma,
``node_classification/models.py`` and ``layers.py``) as its algebra
reads once the per-node loops are gone:

    h   = dropout(relu(A @ (x W1) + b1))
    S_k = sum over in-edges (j -> i) of mask_k(i, j) * h_j
    mask_k(i, j) = dropout(sigmoid(h_i Wtop_k + h_j Wbot_k))
    m   = sum_k (h + S_k) / max(deg, 1)          (the "mean" combine)
    out = log_softmax(A @ (3 m @ W2) + b2)       (3 scalers, parity: N3)

with the raw binary adjacency (no self-loops, no normalisation), the
NLL over the training nodes, and Adam with L2 in the gradient (N11).

It imports nothing of the program. What the program derives from the
benchmark's inputs it works out again: the destination-sorted edge order
and the degrees. The dropout keeps are the program's own draws, recorded
in the checked steps (``h100_bench/draws.py``) and handed over with the
row labels of the program's edge list, so that nothing here depends on
the order, the shapes or the padding in which the program draws them:
in each step, the draw with ``hidden`` columns and a row for each node
holds the feature keeps (nodes in their own numbering), and the draw with
``K * hidden`` columns and a row for each of the program's edge rows
holds the mask keeps, matched to the benchmark's edges by their
``(dst, src)`` labels.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def keep_of(op: str, draw: torch.Tensor, rate: float) -> torch.Tensor:
    """The keep mask of a dropout draw: a uniform draw keeps where it is at
    least ``rate``; a Bernoulli draw keeps where it is 1."""
    if op.startswith("bernoulli"):
        return draw != 0
    if op.startswith(("rand", "uniform")) and draw.is_floating_point():
        return draw >= rate
    raise ValueError(f"no keep rule for a draw of {op!r} ({draw.dtype})")


def _keeps(draws: List[Tuple[str, torch.Tensor]], n: int, hdim: int, k: int, rate: float,
           rows_of_edges: torch.Tensor, dev):
    """The step's feature keeps ``(n, hidden)`` and mask keeps ``(E, K *
    hidden)`` in the reference's edge order, from the step's recorded
    draws; ``rows_of_edges[i]`` is the program's row of edge ``i``."""
    n_rows = int(rows_of_edges.max()) + 1 if rows_of_edges.numel() else 0
    mask = [i for i, (_, d) in enumerate(draws)
            if d.dim() == 2 and d.shape[1] == k * hdim and d.shape[0] >= n_rows]
    feat = [i for i, (_, d) in enumerate(draws)
            if d.dim() == 2 and d.shape[1] == hdim and d.shape[0] >= n and i not in mask]
    if len(feat) != 1 or len(mask) != 1:
        raise ValueError("expected one feature draw (rows >= %d, %d columns) and one mask draw "
                         "(rows >= %d, %d columns) a step; recorded %s"
                         % (n, hdim, n_rows, k * hdim,
                            [(op, tuple(d.shape)) for op, d in draws]))
    feat, mask = draws[feat[0]], draws[mask[0]]
    fkeep = keep_of(feat[0], feat[1][:n], rate).to(dev)
    mkeep = keep_of(mask[0], mask[1][rows_of_edges], rate).to(dev)
    return fkeep, mkeep


def _forward(p, x, src, dst, deg, cfg, fkeep, mkeep):
    if not set(cfg["aggregators"]) <= {"mean", "mean2", "mean4"} or not cfg["parity"]:
        raise ValueError("this reference holds the sigmoid-masked mean aggregators under "
                         f"parity, not {cfg['aggregators']}")
    n, hdim = x.shape[0], cfg["hidden"]
    k = len(cfg["aggregators"])
    rate = cfg["dropout"]
    xw = x @ p["gc1.w"]
    h = torch.zeros((n, hdim), device=x.device).index_add_(0, dst, xw[src]) + p["gc1.b"]
    h = torch.relu(h)
    h = torch.where(fkeep, h / (1.0 - rate), 0.0)
    outs = 0.0
    for a in range(k):
        w = p["mma.masks"][a]  # (2H, H): [W_top; W_bot]
        logits = (h @ w[:hdim])[dst] + (h @ w[hdim:])[src]
        mask = torch.sigmoid(logits)
        mask = torch.where(mkeep[:, a * hdim:(a + 1) * hdim], mask / (1.0 - rate), 0.0)
        s = torch.zeros((n, hdim), device=x.device).index_add_(0, dst, mask * h[src])
        outs = outs + (h + s) / torch.clamp(deg, min=1.0)[:, None]
    scaled = float(len(cfg["scalers"])) * outs
    sw = scaled @ p["mma.w"]
    out = torch.zeros((n, sw.shape[1]), device=x.device).index_add_(0, dst, sw[src]) + p["mma.b"]
    return torch.log_softmax(out, dim=-1)


def edge_rows(src: np.ndarray, dst: np.ndarray, n: int, draw_rows: Dict) -> torch.Tensor:
    """For each edge in the reference's order (by destination, ties by
    source), the program's row that holds its keeps: the program's real
    rows (``draw_rows``' ``src``, ``dst``, ``real``) matched by ``(dst,
    src)``. Raises when the program's edges are not the benchmark's."""
    real = np.flatnonzero(np.asarray(draw_rows["real"]))
    p_src = np.asarray(draw_rows["src"])[real].astype(np.int64)
    p_dst = np.asarray(draw_rows["dst"])[real].astype(np.int64)
    key_ref = dst.astype(np.int64) * n + src.astype(np.int64)
    key_prog = p_dst * n + p_src
    by_ref = np.argsort(key_ref, kind="stable")
    by_prog = np.argsort(key_prog, kind="stable")
    if key_ref.shape != key_prog.shape or not np.array_equal(key_ref[by_ref], key_prog[by_prog]):
        raise ValueError("the program's edge rows are not the benchmark's edges")
    return torch.from_numpy(real[by_prog])


def train_steps(inputs: Dict, params0: Dict[str, torch.Tensor], cfg: Dict, steps: int
                ) -> Dict:
    """``steps`` training steps from ``params0``. Returns the losses, the
    first step's gradient as Adam takes it (weight decay included) and the
    parameters after the last step."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        return _train_steps(inputs, params0, cfg, steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])


def _train_steps(inputs, params0, cfg, steps):
    x = inputs["x"].float()
    dev = x.device
    n = x.shape[0]
    hdim, k, rate = cfg["hidden"], len(cfg["aggregators"]), cfg["dropout"]
    src_np, dst_np = np.asarray(inputs["src"]), np.asarray(inputs["dst"])
    order = np.lexsort((src_np, dst_np))
    src_np, dst_np = src_np[order], dst_np[order]
    rows = edge_rows(src_np, dst_np, n, inputs["draw_rows"])
    src = torch.from_numpy(src_np.astype(np.int64)).to(dev)
    dst = torch.from_numpy(dst_np.astype(np.int64)).to(dev)
    deg = torch.bincount(dst, minlength=n).float()
    labels, idx = inputs["labels"].long(), inputs["idx_train"].long()
    p = {k_: v.detach().clone().float() for k_, v in params0.items()}
    m = {k_: torch.zeros_like(v) for k_, v in p.items()}
    v2 = {k_: torch.zeros_like(v) for k_, v in p.items()}
    b1, b2 = cfg["adam_betas"]
    lr, wd, eps = cfg["lr"], cfg["weight_decay"], cfg["adam_eps"]
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        fkeep, mkeep = _keeps(inputs["draws"][t - 1], n, hdim, k, rate, rows, dev)
        leaves = {k_: v.clone().requires_grad_() for k_, v in p.items()}
        logp = _forward(leaves, x, src, dst, deg, cfg, fkeep, mkeep)
        loss = -logp[idx, labels[idx]].mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k_: gi + wd * p[k_] for k_, gi in zip(leaves, grads)}
            if grad1 is None:
                grad1 = {k_: gi.clone() for k_, gi in g.items()}
            for k_ in p:
                m[k_] = b1 * m[k_] + (1 - b1) * g[k_]
                v2[k_] = b2 * v2[k_] + (1 - b2) * g[k_] * g[k_]
                m_hat = m[k_] / (1 - b1 ** t)
                v_hat = v2[k_] / (1 - b2 ** t)
                p[k_] = p[k_] - lr * m_hat / (torch.sqrt(v_hat) + eps)
        del leaves, logp, loss, grads, fkeep, mkeep
    return {"losses": losses, "grad1": grad1, "params": p}
