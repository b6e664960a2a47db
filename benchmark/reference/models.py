"""What the reference's model families share: the graph their forward
passes are written on, and the FLOP count over it.

Each family is a file of its own, ``reference/families/<reference>.py``,
found by the configuration's ``reference`` key (``lib/registry.family``).
Its forward reads a flat dict of f32 tensors keyed by the flax-format paths
of the weight files (``params/elan1/cv1/conv/kernel`` in HWIO,
``batch_stats/elan1/cv1/bn/mean`` ...) and computes with plain
``torch.nn.functional`` calls on a ``Graph``: BN unfolded, the stems as 3x3
stride-2 convolutions over the image. Nothing here imports the program
under test.
"""

import torch
import torch.nn.functional as F


class Graph:
    """Weights and the ops of one family: conv + BN + activation blocks
    and the 1x1 f32 heads, with an optional FLOP counter."""

    def __init__(self, weights, act: str, bn_eps: float):
        self.w = weights
        self.act = act
        self.eps = bn_eps
        self.flops = 0.0

    def conv(self, name, x, stride=1):
        k = self.w[f"params/{name}/conv/kernel"].permute(3, 2, 0, 1)
        y = F.conv2d(x, k, self.w.get(f"params/{name}/conv/bias"),
                     stride=stride, padding=k.shape[-1] // 2)
        self.flops += 2.0 * k[0].numel() * y.numel()
        if f"params/{name}/bn/scale" in self.w:
            mean = self.w[f"batch_stats/{name}/bn/mean"]
            var = self.w[f"batch_stats/{name}/bn/var"]
            scale = self.w[f"params/{name}/bn/scale"] / torch.sqrt(
                var + self.eps)
            y = (y - mean[:, None, None]) * scale[:, None, None] \
                + self.w[f"params/{name}/bn/bias"][:, None, None]
        if self.act == "leaky":
            return F.leaky_relu(y, 0.1)
        return F.silu(y)

    def head(self, name, feat):
        """1x1 conv with bias on an NCHW map -> NHWC f32 logits."""
        k = self.w[f"params/{name}/kernel"][0, 0]           # [I, O]
        x = feat.permute(0, 2, 3, 1)
        self.flops += 2.0 * k.shape[0] * x.shape[0] * x.shape[1] \
            * x.shape[2] * k.shape[1]
        return x @ k + self.w[f"params/{name}/bias"]


def pool(x, k):
    """Max pool of size ``k``, stride 1, the map's size kept."""
    return F.max_pool2d(x, k, 1, k // 2)


def grid(h, w, device):
    """Column and row index of each cell of an h x w map, f32."""
    gy, gx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    return gx, gy


def count_flops(forward, act: str, cfg: dict, weights, batch: int,
                size: int) -> float:
    """Twice the multiply-adds of every conv and head matmul of one
    ``forward(cfg, graph, x)`` over [batch, 3, size, size], run on the
    meta device over tensors of the weights' shapes."""
    meta = {k: torch.empty(v.shape, device="meta") for k, v in weights.items()}
    g = Graph(meta, act, cfg["bn_eps"])
    forward(cfg, g, torch.empty(batch, 3, size, size, device="meta"))
    return g.flops
