"""GNN-based NoC congestion model (paper §VI-C, Eq. 5-6), in torch.

Input: the core-topology graph from the Workload Compiler — nodes = routers
(feature: packet injection rate), directed edges = physical links (feature:
transmission volume in flits, link bandwidth). Message passing runs on BOTH
the graph and its reverse (upstream contention + downstream backpressure,
after Noception [30]) for T iterations; the congestion head predicts each
link's average channel waiting time:

    y_e = MLP(concat(h_u^T, h_v^T, h_e^0))                      (Eq. 5)
    t(k) = k + sum_{l in route} y_l                             (Eq. 6)

The port's counterpart of `repro.core.noc_gnn`. What differs:

  * Parameters are `repro`'s tree (`{"node_enc": [{"w", "b"}, ...], ...}`)
    with float32 tensors on one device: the device every function here
    computes on. `init_gnn` draws its own He-normal weights from a CPU
    `torch.Generator` (the same values on every device); `jax.random` cannot
    be reproduced in torch, so parity with `repro` goes through
    `gnn_params_from_jax` on `repro`'s `init_gnn` tree with numpy leaves,
    and `gnn_params_to_jax` gives that tree back (checkpoints).
  * Aggregation order is fixed. `jax.ops.segment_sum` and the gathers
    `h_v[senders]` are products with one-hot incidence matrices in IEEE
    fp32 (TF32 off for the call): the gathers are exact, and every sum runs
    in the GEMM's fixed order, forward and backward, so two runs on the
    card give bitwise-equal waits and training steps (`index_add_` on CUDA
    sums with atomics, in an order that changes from run to run).
  * Adam is written out as `repro` writes it,
    `p - lr * (m / bc1) / (sqrt(v / bc2) + 1e-8)` with `bc = 1 - b ** step`
    in float32, as `torch._foreach_*` ops over the 20 tensors of the 10
    layers. The epoch's loss is summed on the device in float64 and read
    once per epoch, where `repro` reads it.
  * The pow2 padding of nodes, edges and lanes is kept (`pad_link_graphs`,
    `fidelity._gnn_lane_makespans`): masked means equal the unpadded ones,
    and the set of shapes stays bounded.

Featurization (`LinkGraph`, `featurize_transfer`, `LinkGraphBatch`,
`pad_link_graphs`), `kendall_tau` and `TrainHistory` are NumPy copies.
CPU parity against `repro`: tests/test_torch_gnn.py.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.compiler import ChunkGraph, _xy_route
from repro_torch.core.design_space import WSCDesign
from repro_torch.core.noc_sim import packets_for_transfer, simulate
from repro_torch.device import resolve_device, to_device

HIDDEN = 32
T_ITERS = 3
NODE_F = 3      # injection rate, out-degree, in-degree
EDGE_F = 3      # log flits, bandwidth (norm), flows

# the MLPs of `repro`'s init_gnn, in its order: (name, layer widths)
LAYERS: Tuple[Tuple[str, Tuple[int, ...]], ...] = (
    ("node_enc", (NODE_F, HIDDEN, HIDDEN)),
    ("edge_enc", (EDGE_F, HIDDEN, HIDDEN)),
    ("msg_fwd", (2 * HIDDEN, HIDDEN)),
    ("msg_bwd", (2 * HIDDEN, HIDDEN)),
    ("update", (3 * HIDDEN, HIDDEN, HIDDEN)),
    ("head", (3 * HIDDEN, HIDDEN, 1)),
)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _paths() -> List[Tuple[str, int, str]]:
    """Leaf paths in `jax.tree_util` order (dict keys sorted), the order
    the evaluator's params digest walks."""
    return [(name, i, k) for name, sizes in sorted(LAYERS)
            for i in range(len(sizes) - 1) for k in ("b", "w")]


def _flatten(params: Dict) -> List[torch.Tensor]:
    return [params[n][i][k] for n, i, k in _paths()]


def _unflatten(leaves: Sequence) -> Dict:
    params = {name: [{} for _ in range(len(sizes) - 1)]
              for name, sizes in LAYERS}
    for (n, i, k), t in zip(_paths(), leaves):
        params[n][i][k] = t
    return params


def params_device(params: Dict) -> torch.device:
    """The device the parameters (and so every computation on them) live on."""
    return params["node_enc"][0]["w"].device


def init_gnn(seed: int = 0, device="cuda") -> Dict:
    """He-normal weights (std sqrt(2 / fan_in)) and zero biases, drawn in
    `LAYERS` order from a CPU generator seeded with `seed`, then moved to
    `device`: the same values on every device."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params = {}
    for name, sizes in LAYERS:
        params[name] = [
            {"w": (torch.randn((a, b), generator=gen) * (2.0 / a) ** 0.5).to(dev),
             "b": torch.zeros(b, device=dev)}
            for a, b in zip(sizes[:-1], sizes[1:])]
    return params


def gnn_params_from_jax(tree: Dict, device="cuda") -> Dict:
    """`repro`'s `init_gnn` tree with numpy leaves -> the port's params on
    `device`. Raises if the tree has another layout or a leaf that is not a
    numpy array (JAX arrays included: convert them with `np.asarray` where
    JAX runs)."""
    dev = resolve_device(device)
    if not isinstance(tree, dict) or set(tree) != {n for n, _ in LAYERS}:
        raise ValueError(f"GNN params must be a dict with keys "
                         f"{sorted(n for n, _ in LAYERS)}")
    leaves = []
    for n, i, k in _paths():
        sizes = dict(LAYERS)[n]
        a = tree[n][i][k]
        if not isinstance(a, np.ndarray):
            raise TypeError(
                f"GNN params leaf {n}[{i}][{k!r}] is a {type(a).__module__}."
                f"{type(a).__name__}, not a numpy array: the port reads "
                "numpy leaves only")
        want = (sizes[i], sizes[i + 1]) if k == "w" else (sizes[i + 1],)
        if a.shape != want:
            raise ValueError(f"GNN params leaf {n}[{i}][{k!r}] has shape "
                             f"{a.shape}, want {want}")
        leaves.append(torch.from_numpy(np.array(a, np.float32)).to(dev))
    return _unflatten(leaves)


def gnn_params_on(params: Dict, device="cuda") -> Dict:
    """`params` on `device`: `repro`'s numpy-leaf tree is converted,
    tensors elsewhere are copied, tensors already there pass as they are
    (the same object, so the evaluator's cache digest stays pinned)."""
    dev = resolve_device(device)
    if isinstance(params["node_enc"][0]["w"], np.ndarray):
        return gnn_params_from_jax(params, device=dev)
    have = params_device(params)
    if have.type == dev.type and dev.index in (None, have.index):
        return params
    return _unflatten([t.to(dev) for t in _flatten(params)])


def gnn_params_to_jax(params: Dict) -> Dict:
    """The inverse of `gnn_params_from_jax`: `repro`'s tree layout with
    float32 numpy leaves (what checkpoints and `params_path` pickles hold)."""
    return _unflatten([t.detach().cpu().numpy() for t in _flatten(params)])


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Builds numpy's classes only: a params pickle holds dicts, lists and
    numpy arrays, and any other class (a JAX array, an arbitrary object) is
    refused before it is imported or built."""

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy":
            return super().find_class(module, name)
        if module.split(".")[0] in ("jax", "jaxlib"):
            raise TypeError(
                f"the GNN params pickle holds JAX objects ({module}.{name}); "
                "the port reads numpy leaves only: re-save the params with "
                "jax.tree.map(np.asarray, params) where JAX runs")
        raise TypeError(f"the GNN params pickle holds {module}.{name}; the "
                        "port reads numpy leaves only")


def load_gnn_params(path: str, device="cuda") -> Dict:
    """Read a pickled `repro`-layout params tree with numpy leaves onto
    `device`. A pickle of JAX arrays (e.g. one written with the arrays as
    JAX holds them), or of any class but numpy's, is refused without
    importing or building it."""
    with open(path, "rb") as f:
        tree = _NumpyOnlyUnpickler(f).load()
    return gnn_params_from_jax(tree, device=device)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _ieee_fp32():
    """float32 products in IEEE fp32 (no TF32) inside: the one-hot gathers
    stay exact and the sums round as fp32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _mlp(layers, x):
    for i, layer in enumerate(layers):
        x = F.linear(x, layer["w"].T, layer["b"])
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _incidence(idx: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """(..., E) node indices -> (..., E, n_nodes) float32 one-hot rows."""
    ar = torch.arange(n_nodes, device=idx.device)
    return (idx.long().unsqueeze(-1) == ar).to(torch.float32)


def _logits(params, node_x, edge_x, S, R, edge_mask):
    """`gnn_logits` on one-hot incidence rows S (senders) and R
    (receivers): S @ h_v is h_v[senders]; R^T @ m is segment_sum(m,
    receivers)."""
    h_v = _mlp(params["node_enc"], node_x)
    h_e0 = _mlp(params["edge_enc"], edge_x)
    h_e = h_e0
    ST, RT = S.transpose(-1, -2), R.transpose(-1, -2)
    for _ in range(T_ITERS):
        m_in = _mlp(params["msg_fwd"], torch.cat([S @ h_v, h_e], dim=-1))
        m_out = _mlp(params["msg_bwd"], torch.cat([R @ h_v, h_e], dim=-1))
        if edge_mask is not None:
            m_in = m_in * edge_mask.unsqueeze(-1)
            m_out = m_out * edge_mask.unsqueeze(-1)
        h_v = _mlp(params["update"],
                   torch.cat([h_v, RT @ m_in, ST @ m_out], dim=-1))
    y = _mlp(params["head"], torch.cat([S @ h_v, R @ h_v, h_e0], dim=-1))
    return y[..., 0]


def gnn_logits(params: Dict, node_x: torch.Tensor, edge_x: torch.Tensor,
               senders: torch.Tensor, receivers: torch.Tensor, n_nodes: int,
               edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw head output = predicted log1p(waiting time) per edge — the model
    regresses in log space, which conditions training across the 4-decade
    range of waiting times. `edge_mask` (1.0 = real edge, 0.0 = padding)
    zeroes padded edges' messages before the aggregation so padded graphs
    (LinkGraphBatch) aggregate exactly like their unpadded originals.
    Leading batch dimensions broadcast: (G, n, F) nodes with (G, E) edges
    score G graphs in one call."""
    with _ieee_fp32():
        return _logits(params, node_x, edge_x, _incidence(senders, n_nodes),
                       _incidence(receivers, n_nodes), edge_mask)


def _wait(z: torch.Tensor) -> torch.Tensor:
    return torch.expm1(torch.clamp(torch.relu(z), 0.0, 30.0))


def gnn_forward(params: Dict, node_x: torch.Tensor, edge_x: torch.Tensor,
                senders: torch.Tensor, receivers: torch.Tensor, n_nodes: int,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Predicted average waiting time per edge (>= 0), Eq. 5. The log-space
    head is clipped at 30 (~1e13 cycles) so an out-of-distribution input
    can't overflow expm1 into inf/NaN downstream."""
    return _wait(gnn_logits(params, node_x, edge_x, senders, receivers,
                            n_nodes, edge_mask))


# ---------------------------------------------------------------------------
# graph featurization from a compiled chunk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LinkGraph:
    node_x: np.ndarray
    edge_x: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    links: List[Tuple[int, int]]
    n_nodes: int
    target: np.ndarray = None     # per-edge avg wait (from noc_sim)


def featurize_transfer(graph: ChunkGraph, design: WSCDesign, t_idx: int,
                       with_target: bool = False) -> LinkGraph:
    W = graph.array[1]
    n = graph.n_cores
    pkts = packets_for_transfer(graph, design, t_idx)

    link_flits: Dict[Tuple[int, int], float] = {}
    link_flows: Dict[Tuple[int, int], int] = {}
    inj = np.zeros(n)
    for p in pkts:
        inj[p.src] += p.flits
        for hop in _xy_route(p.src, p.dst, W):
            link_flits[hop] = link_flits.get(hop, 0.0) + p.flits
            link_flows[hop] = link_flows.get(hop, 0) + 1
    links = sorted(link_flits)
    senders = np.array([u for u, _ in links], np.int32)
    receivers = np.array([v for _, v in links], np.int32)

    dur = max(graph.ops[graph.transfers[t_idx].src_op].tile.cycles, 1.0)
    out_deg = np.zeros(n)
    in_deg = np.zeros(n)
    for u, v in links:
        out_deg[u] += 1
        in_deg[v] += 1
    node_x = np.stack([inj / dur, out_deg / 4.0, in_deg / 4.0], axis=1)
    edge_x = np.stack([
        np.log1p([link_flits[l] for l in links]),
        np.full(len(links), design.noc_bw / 4096.0),
        np.log1p([link_flows[l] for l in links]),
    ], axis=1)

    target = None
    if with_target:
        res = simulate(pkts, W)
        target = np.array([res.link_wait.get(l, 0.0) for l in links])
    return LinkGraph(node_x.astype(np.float32), edge_x.astype(np.float32),
                     senders, receivers, links, n, target)


# ---------------------------------------------------------------------------
# padded struct-of-arrays batching (DESIGN.md §4b)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LinkGraphBatch:
    """G link graphs padded to a common (n_nodes, n_edges) shape. Padded
    edges carry zero features, point at node 0, and are masked out of the
    message-passing aggregations (`edge_mask`); padded node rows are inert
    because no unmasked edge references them."""
    node_x: np.ndarray      # (G, n_nodes, NODE_F) float32
    edge_x: np.ndarray      # (G, n_edges, EDGE_F) float32
    senders: np.ndarray     # (G, n_edges) int32, padding -> 0
    receivers: np.ndarray   # (G, n_edges) int32, padding -> 0
    edge_mask: np.ndarray   # (G, n_edges) float32, 1 = real edge
    n_nodes: int            # static padded node count
    n_edges_real: np.ndarray  # (G,) real edge count per graph
    target: Optional[np.ndarray] = None   # (G, n_edges), 0 on padding

    def __len__(self) -> int:
        return self.node_x.shape[0]


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def pad_link_graphs(graphs: Sequence[LinkGraph],
                    n_nodes: Optional[int] = None,
                    n_edges: Optional[int] = None,
                    with_target: bool = False) -> LinkGraphBatch:
    """Stack LinkGraphs into one padded batch. Node/edge capacities default
    to the next power of two above the max in the batch, so repeated calls
    bucket onto a handful of shapes."""
    G = len(graphs)
    nn = n_nodes or next_pow2(max((g.n_nodes for g in graphs), default=1))
    ne = n_edges or next_pow2(max((len(g.links) for g in graphs), default=1))
    node_x = np.zeros((G, nn, NODE_F), np.float32)
    edge_x = np.zeros((G, ne, EDGE_F), np.float32)
    senders = np.zeros((G, ne), np.int32)
    receivers = np.zeros((G, ne), np.int32)
    mask = np.zeros((G, ne), np.float32)
    n_real = np.zeros(G, np.int64)
    target = np.zeros((G, ne), np.float32) if with_target else None
    for i, g in enumerate(graphs):
        e = len(g.links)
        n_real[i] = e
        node_x[i, :g.n_nodes] = g.node_x
        edge_x[i, :e] = g.edge_x
        senders[i, :e] = g.senders
        receivers[i, :e] = g.receivers
        mask[i, :e] = 1.0
        if with_target and g.target is not None:
            target[i, :e] = g.target
    return LinkGraphBatch(node_x, edge_x, senders, receivers, mask, nn,
                          n_real, target)


@dataclasses.dataclass
class _DeviceBatch:
    """A LinkGraphBatch (or one padded graph) uploaded once: features,
    one-hot incidence rows, mask and log1p(target) on the device."""
    node_x: torch.Tensor
    edge_x: torch.Tensor
    S: torch.Tensor
    R: torch.Tensor
    edge_mask: torch.Tensor
    log_target: Optional[torch.Tensor]


def _upload(batch: LinkGraphBatch, dev: torch.device,
            index=slice(None)) -> _DeviceBatch:
    n = int(batch.n_nodes)
    S = _incidence(to_device(batch.senders[index], torch.int64, dev), n)
    R = _incidence(to_device(batch.receivers[index], torch.int64, dev), n)
    tgt = None
    if batch.target is not None:
        tgt = torch.log1p(to_device(batch.target[index], torch.float32, dev))
    return _DeviceBatch(to_device(batch.node_x[index], torch.float32, dev),
                        to_device(batch.edge_x[index], torch.float32, dev),
                        S, R, to_device(batch.edge_mask[index],
                                        torch.float32, dev), tgt)


def gnn_forward_batch(params: Dict, batch: LinkGraphBatch) -> np.ndarray:
    """Predicted waiting time for every edge of every graph in one batched
    call on the params' device. Returns (G, n_edges) float32; padded
    positions are meaningless."""
    b = _upload(batch, params_device(params))
    with torch.no_grad(), _ieee_fp32():
        out = _wait(_logits(params, b.node_x, b.edge_x, b.S, b.R,
                            b.edge_mask))
    return out.cpu().numpy()


def _masked_loss(z: torch.Tensor, b: _DeviceBatch) -> torch.Tensor:
    """Per-graph log-space MSE over real edges (the masked mean equals the
    unpadded mean)."""
    err = (z - b.log_target) ** 2 * b.edge_mask
    return err.sum(-1) / torch.clamp(b.edge_mask.sum(-1), min=1.0)


def _val_metrics(params: Dict, batch: LinkGraphBatch,
                 b: _DeviceBatch) -> Tuple[float, float]:
    with torch.no_grad(), _ieee_fp32():
        z = _logits(params, b.node_x, b.edge_x, b.S, b.R, b.edge_mask)
        losses = _masked_loss(z, b)
        both = torch.cat([losses[:, None], z], dim=1).cpu().numpy()
    losses, zs = both[:, 0], both[:, 1:]
    real = np.asarray(batch.edge_mask) > 0
    # rank what the deployed predictor actually outputs: gnn_forward applies
    # expm1(clip(relu(z))), so negative logits collapse to tied zero waits —
    # ranking raw z would credit orderings the model cannot express
    pred = np.clip(np.maximum(zs, 0.0), 0.0, 30.0)
    kt = kendall_tau(pred[real], np.asarray(batch.target)[real])
    return float(np.mean(losses)), kt


def kendall_tau(a: np.ndarray, b: np.ndarray, max_n: int = 2000,
                seed: int = 0) -> float:
    """Kendall rank correlation, vectorized over all O(n^2) pairs (with a
    deterministic subsample above `max_n` elements)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    n = len(a)
    if n < 2:
        return 0.0
    if n > max_n:
        idx = np.random.default_rng(seed).choice(n, max_n, replace=False)
        a, b = a[idx], b[idx]
        n = max_n
    iu = np.triu_indices(n, 1)
    sa = np.sign(a[:, None] - a[None, :])[iu]
    sb = np.sign(b[:, None] - b[None, :])[iu]
    m = (sa != 0) & (sb != 0)
    den = int(m.sum())
    num = int(((sa == sb) & m).sum()) - int(((sa != sb) & m).sum())
    return num / max(den, 1)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainHistory:
    """Per-epoch training record. `train_loss` is the averaged per-graph
    log-space MSE; `val_loss` / `val_kendall_tau` are held-out metrics
    (empty when val_frac == 0). `best_epoch` indexes the epoch whose
    parameters were returned; `stopped_epoch` is set when early stopping
    fired."""
    train_loss: List[float] = dataclasses.field(default_factory=list)
    val_loss: List[float] = dataclasses.field(default_factory=list)
    val_kendall_tau: List[float] = dataclasses.field(default_factory=list)
    best_epoch: int = -1
    stopped_epoch: Optional[int] = None

    @property
    def best_val_loss(self) -> Optional[float]:
        """Validation loss of the epoch whose parameters were returned —
        NOT the last epoch's (early stopping returns the best checkpoint,
        so the stagnant tail's metrics would misstate its quality)."""
        return self.val_loss[self.best_epoch] \
            if self.val_loss and self.best_epoch >= 0 else None

    @property
    def best_val_kendall_tau(self) -> Optional[float]:
        return self.val_kendall_tau[self.best_epoch] \
            if self.val_kendall_tau and self.best_epoch >= 0 else None


_B1, _B2 = 0.9, 0.999


def _train_step(leaves: List[torch.Tensor], m: List[torch.Tensor],
                v: List[torch.Tensor], step: int, lr: float,
                b: _DeviceBatch) -> torch.Tensor:
    """One (grad + Adam) update of `leaves` in place on a padded graph, in
    `repro`'s arithmetic. Returns the loss, on the device."""
    with torch.enable_grad():
        z = _logits(_unflatten(leaves), b.node_x, b.edge_x, b.S, b.R,
                    b.edge_mask)
        lval = _masked_loss(z, b)
        grads = torch.autograd.grad(lval, leaves)
    with torch.no_grad():
        # m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
        torch._foreach_mul_(m, _B1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1 - _B1))
        g2 = torch._foreach_mul(grads, 1 - _B2)
        torch._foreach_mul_(g2, grads)
        torch._foreach_mul_(v, _B2)
        torch._foreach_add_(v, g2)
        # bias corrections in float32, as repro computes b ** step
        s = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(_B1) ** s)
        bc2 = float(np.float32(1) - np.float32(_B2) ** s)
        num = torch._foreach_div(m, bc1)
        torch._foreach_mul_(num, lr)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, 1e-8)
        torch._foreach_div_(num, den)
        torch._foreach_sub_(leaves, num)
    return lval.detach()


def train_gnn(params: Dict, dataset: List[LinkGraph], epochs: int = 60,
              lr: float = 3e-3, seed: int = 0, val_frac: float = 0.0,
              patience: Optional[int] = None) -> Tuple[Dict, TrainHistory]:
    """Full-batch-per-graph Adam on log1p(wait) MSE, on the params' device.

    With `val_frac` > 0 a deterministic held-out split is scored every epoch
    (log-space MSE + Kendall tau of predicted vs simulated waits); with
    `patience` set, training stops after that many epochs without val-loss
    improvement and the best-epoch parameters are returned — the signal the
    online calibration loop (calibration.py) early-stops on. The split, the
    epoch orders and the early stopping follow `repro`'s `train_gnn` draw
    for draw. Returns new tensors; `params` is not modified.
    """
    dev = params_device(params)
    rng = np.random.default_rng(seed)

    usable = [g for g in dataset
              if g.target is not None and len(g.links) > 0]
    val: List[LinkGraph] = []
    train = list(dataset)
    if val_frac > 0.0 and len(usable) >= 2:
        n_val = max(1, int(round(val_frac * len(usable))))
        n_val = min(n_val, len(usable) - 1)
        picked = rng.permutation(len(usable))[:n_val]
        val = [usable[i] for i in picked]
        val_ids = {id(g) for g in val}
        train = [g for g in dataset if id(g) not in val_ids]
    val_batch = pad_link_graphs(val, with_target=True) if val else None
    val_dev = _upload(val_batch, dev) if val_batch is not None else None

    # each graph padded to pow2 node/edge capacities (the masked-mean loss
    # equals the unpadded mean) and uploaded once, with its incidence rows
    padded = {}
    for g in dataset:
        if g.target is None or len(g.links) == 0:
            padded[id(g)] = None
            continue
        b = pad_link_graphs([g], n_nodes=next_pow2(g.n_nodes),
                            n_edges=next_pow2(len(g.links)), with_target=True)
        padded[id(g)] = _upload(b, dev, 0)

    leaves = [t.detach().clone().requires_grad_(True)
              for t in _flatten(params)]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    lr32 = float(np.float32(lr))

    def snapshot():
        return _unflatten([t.detach().clone() for t in leaves])

    hist = TrainHistory()
    best_params = params
    best_val = float("inf")
    since_best = 0
    step = 0
    with _ieee_fp32():
        for ep in range(epochs):
            order = rng.permutation(len(train))
            ep_loss = torch.zeros((), dtype=torch.float64, device=dev)
            for gi in order:
                b = padded.get(id(train[gi]))
                if b is None:
                    continue
                step += 1
                ep_loss += _train_step(leaves, m, v, step, lr32, b).double()
            hist.train_loss.append(float(ep_loss) / max(len(train), 1))
            if val_batch is not None:
                vl, kt = _val_metrics(_unflatten(leaves), val_batch, val_dev)
                hist.val_loss.append(vl)
                hist.val_kendall_tau.append(kt)
                if vl < best_val - 1e-12:
                    best_val, best_params, since_best = vl, snapshot(), 0
                    hist.best_epoch = ep
                else:
                    since_best += 1
                    if patience is not None and since_best >= patience:
                        hist.stopped_epoch = ep
                        return best_params, hist
    if val_batch is not None:
        return best_params, hist
    hist.best_epoch = epochs - 1
    return snapshot(), hist


# ---------------------------------------------------------------------------
# prediction (the scalar path of `GNNBackend.chunk_latency`)
# ---------------------------------------------------------------------------


def predict_transfer_makespan(params: Dict, graph: ChunkGraph,
                              design: WSCDesign, t_idx: int) -> float:
    """Eq. 6 reconstruction: per-packet t(k) = k + sum of predicted waits on
    its route; transfer makespan = max over packets of inject + latency.
    One forward on the params' device and one copy back per transfer."""
    g = featurize_transfer(graph, design, t_idx)
    if len(g.links) == 0:
        return 0.0
    dev = params_device(params)
    with torch.no_grad():
        wait = gnn_forward(
            params, to_device(g.node_x, torch.float32, dev),
            to_device(g.edge_x, torch.float32, dev),
            to_device(g.senders, torch.int64, dev),
            to_device(g.receivers, torch.int64, dev),
            int(g.n_nodes)).cpu().numpy()
    wait_by_link = {l: float(w) for l, w in zip(g.links, wait)}
    W = graph.array[1]
    pkts = packets_for_transfer(graph, design, t_idx)
    worst = 0.0
    for p in pkts:
        route = _xy_route(p.src, p.dst, W)
        t = p.flits + len(route) + sum(wait_by_link.get(h, 0.0) for h in route)
        worst = max(worst, p.inject + t)
    return worst


def chunk_latency_cycles_gnn(params: Dict, graph: ChunkGraph,
                             design: WSCDesign) -> float:
    total = 0.0
    for i, node in enumerate(graph.ops):
        total += node.tile.cycles
        if i < len(graph.transfers) and graph.transfers[i].pairs:
            total += predict_transfer_makespan(params, graph, design, i)
    return total


__all__ = [
    "EDGE_F", "HIDDEN", "LAYERS", "LinkGraph", "LinkGraphBatch", "NODE_F",
    "T_ITERS", "TrainHistory", "chunk_latency_cycles_gnn",
    "featurize_transfer", "gnn_forward", "gnn_forward_batch", "gnn_logits",
    "gnn_params_from_jax", "gnn_params_on", "gnn_params_to_jax", "init_gnn", "kendall_tau",
    "load_gnn_params", "next_pow2", "pad_link_graphs", "params_device",
    "predict_transfer_makespan", "train_gnn",
]
