"""The plain reference of ``mma-sampled-products``: training steps of the MMA
node classifier, one a sampled subgraph, in plain PyTorch, float32 with
TF32 off, deterministic.

On each subgraph (the program's sampled edges and node ids, which the
reference takes as given) it follows the reference code's model
(github.com/asarigun/mma, ``node_classification/models.py`` and
``layers.py``) as ``reference/mma-node-large.py`` writes it out:

    h   = dropout(relu(A @ (x W1) + b1))
    S_k = sum over in-edges (j -> i) of mask_k(i, j) * h_j
    mask_k(i, j) = dropout(sigmoid(h_i Wtop_k + h_j Wbot_k))
    m   = sum_k (h + S_k) / max(deg, 1)          (the "mean" combine)
    out = log_softmax(A @ (3 m @ W2) + b2)       (3 scalers, parity: N3)

with the subgraph's raw binary adjacency, ``deg`` each node's in-degree in
the whole graph (the sampler's unbiased-mean convention), the NLL over the
seeds (the subgraph's first rows), and Adam with L2 in the gradient (N11).

Every sum over edges is a sorted segment sum (:class:`Segments`): rows
stably sorted by their segment, then added in pairs, level after level,
so that the order of every addition follows from the subgraph alone. The
gathers' backward is the same sum. No ``index_add_`` and no atomics: the
reference repeats itself bit for bit.

It imports nothing of the program. The dropout keeps are the program's
own draws, recorded in the checked steps (``h100_bench/draws.py``): in
each step, the draw with ``hidden`` columns holds the feature keeps of the
subgraph's rows, and the draw with ``K * hidden`` columns the mask keeps
of its edges, row ``e`` for the edge at position ``e`` of the program's
edge list.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


class Segments:
    """A deterministic sum of rows into ``n`` segments by ``keys`` (one per
    row, any order), and the gather of segment rows by the same keys, each
    the other's backward."""

    def __init__(self, keys: torch.Tensor, n: int):
        self.keys, self.n = keys, n
        self.order = torch.argsort(keys, stable=True)
        k = keys[self.order]
        self.levels: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        while k.numel():
            idx = torch.arange(k.shape[0], device=k.device)
            rank = idx - torch.searchsorted(k, k)  # the row's place within its segment
            if int(rank.max()) == 0:
                break
            left = idx[rank % 2 == 0]
            right = torch.clamp(left + 1, max=k.shape[0] - 1)
            paired = (left + 1 < k.shape[0]) & (k[right] == k[left])
            self.levels.append((left, right, paired))
            k = k[left]
        self.segments = k  # each segment once, ascending

    def _sum(self, values: torch.Tensor) -> torch.Tensor:
        v = values[self.order]
        for left, right, paired in self.levels:
            v = v[left] + torch.where(paired[:, None], v[right], 0.0)
        out = v.new_zeros((self.n,) + tuple(v.shape[1:]))
        out[self.segments] = v
        return out

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """``out[s] = sum of values[r] over the rows r with keys[r] == s``."""
        return _SegmentSum.apply(values, self)

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows[keys]``."""
        return _Gather.apply(rows, self)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, seg):
        ctx.seg = seg
        return seg._sum(values)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.seg.keys], None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, seg):
        ctx.seg = seg
        return rows[seg.keys]

    @staticmethod
    def backward(ctx, g):
        return ctx.seg._sum(g), None


def keep_of(op: str, draw: torch.Tensor, rate: float) -> torch.Tensor:
    """The keep mask of a dropout draw: a uniform draw keeps where it is at
    least ``rate``; a Bernoulli draw keeps where it is 1."""
    if op.startswith("bernoulli"):
        return draw != 0
    if op.startswith(("rand", "uniform")) and draw.is_floating_point():
        return draw >= rate
    raise ValueError(f"no keep rule for a draw of {op!r} ({draw.dtype})")


def _keeps(draws, n_rows: int, n_edge_rows: int, hdim: int, k: int, rate: float,
           nodes: np.ndarray, edges: np.ndarray, dev):
    """The step's feature keeps of rows ``nodes`` and mask keeps of edge
    positions ``edges``, from its recorded draws: one with ``hidden``
    columns and a row a subgraph row, one with ``K * hidden`` columns and a
    row a position of the program's edge list."""
    feat = [d for d in draws if d[1].dim() == 2 and d[1].shape == (n_rows, hdim)]
    mask = [d for d in draws if d[1].dim() == 2 and d[1].shape == (n_edge_rows, k * hdim)]
    if len(feat) != 1 or len(mask) != 1:
        raise ValueError("expected one feature draw (%d, %d) and one mask draw (%d, %d) a "
                         "step; recorded %s" % (n_rows, hdim, n_edge_rows, k * hdim,
                                               [(op, tuple(d.shape)) for op, d in draws]))
    fkeep = keep_of(feat[0][0], feat[0][1][torch.from_numpy(nodes)], rate).to(dev)
    mkeep = keep_of(mask[0][0], mask[0][1][torch.from_numpy(edges)], rate).to(dev)
    return fkeep, mkeep


def _forward(p, x, seg_dst, seg_src, deg, cfg, fkeep, mkeep):
    if not set(cfg["aggregators"]) <= {"mean", "mean2", "mean4"} or not cfg["parity"]:
        raise ValueError("this reference holds the sigmoid-masked mean aggregators under "
                         f"parity, not {cfg['aggregators']}")
    hdim, k, rate = cfg["hidden"], len(cfg["aggregators"]), cfg["dropout"]
    h = seg_dst.sum(seg_src.gather(x @ p["gc1.w"])) + p["gc1.b"]
    h = torch.relu(h)
    h = torch.where(fkeep, h / (1.0 - rate), 0.0)
    h_src = seg_src.gather(h)
    outs = 0.0
    for a in range(k):
        w = p["mma.masks"][a]  # (2H, H): [W_top; W_bot]
        logits = seg_dst.gather(h @ w[:hdim]) + seg_src.gather(h @ w[hdim:])
        mask = torch.sigmoid(logits)
        mask = torch.where(mkeep[:, a * hdim:(a + 1) * hdim], mask / (1.0 - rate), 0.0)
        outs = outs + (h + seg_dst.sum(mask * h_src)) / torch.clamp(deg, min=1.0)[:, None]
    scaled = float(len(cfg["scalers"])) * outs
    out = seg_dst.sum(seg_src.gather(scaled @ p["mma.w"])) + p["mma.b"]
    return torch.log_softmax(out, dim=-1)


def subgraph(batch: Dict, dev):
    """The real edges ``(src, dst, positions)`` and the real rows of a
    sampled subgraph, checked: the real rows come first, and every real
    edge joins two of them."""
    ids = np.asarray(batch["node_ids"]).astype(np.int64)
    nodes = np.flatnonzero(ids >= 0)
    n = nodes.shape[0]
    if not np.array_equal(nodes, np.arange(n)) or batch["num_seeds"] > n:
        raise ValueError("the subgraph's real rows are not its first rows")
    edges = np.flatnonzero(np.asarray(batch["real"]))
    src = np.asarray(batch["src"]).astype(np.int64)[edges]
    dst = np.asarray(batch["dst"]).astype(np.int64)[edges]
    if edges.size and (max(src.max(), dst.max()) >= n or min(src.min(), dst.min()) < 0):
        raise ValueError("a real edge of the subgraph leaves its real rows")
    return (torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev), edges, nodes,
            torch.from_numpy(ids[:n]).to(dev))


def train_steps(inputs: Dict, params0: Dict[str, torch.Tensor], cfg: Dict, steps: int
                ) -> Dict:
    """``steps`` training steps from ``params0``, step ``t`` on
    ``inputs["batches"][t]``. Returns the losses, the first step's gradient
    as Adam takes it (weight decay included) and the parameters after the
    last step."""
    if len(inputs["batches"]) < steps:
        raise ValueError(f"{steps} steps to check, {len(inputs['batches'])} subgraphs kept")
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
    features, labels = inputs["features"], inputs["labels"]
    dev = features.device
    full_deg = torch.as_tensor(np.asarray(inputs["deg"], np.float32)).to(dev)
    hdim, k, rate = cfg["hidden"], len(cfg["aggregators"]), cfg["dropout"]
    p = {k_: v.detach().clone().float().to(dev) for k_, v in params0.items()}
    m = {k_: torch.zeros_like(v) for k_, v in p.items()}
    v2 = {k_: torch.zeros_like(v) for k_, v in p.items()}
    b1, b2 = cfg["adam_betas"]
    lr, wd, eps = cfg["lr"], cfg["weight_decay"], cfg["adam_eps"]
    losses, grad1 = [], None
    for t in range(1, steps + 1):
        batch = inputs["batches"][t - 1]
        src, dst, edges, nodes, ids = subgraph(batch, dev)
        n, s = nodes.shape[0], int(batch["num_seeds"])
        seg_dst, seg_src = Segments(dst, n), Segments(src, n)
        x = features[ids].float()
        y = labels[ids[:s]].long()
        deg = full_deg[ids]
        fkeep, mkeep = _keeps(inputs["draws"][t - 1], len(batch["node_ids"]),
                              len(batch["src"]), hdim, k, rate, nodes, edges, dev)
        leaves = {k_: v.clone().requires_grad_() for k_, v in p.items()}
        logp = _forward(leaves, x, seg_dst, seg_src, deg, cfg, fkeep, mkeep)
        loss = -logp[:s].gather(1, y[:, None]).mean()
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
        del leaves, logp, loss, grads, fkeep, mkeep, x
    return {"losses": losses, "grad1": grad1, "params": p}
