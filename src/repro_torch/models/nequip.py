"""NequIP: O(3)-equivariant interatomic potential (arXiv:2101.03164).

The port of :mod:`repro.models.nequip`. Irreps: ``d_hidden`` channels each
of (0e, 1o, 2e); features are a dict ``{l: [N, mul, 2l+1]}``. One
interaction layer:

1. Per edge: Bessel radial basis × polynomial cutoff envelope; real SH
   ``Y_l`` of the edge direction.
2. Tensor-product messages, uvu-style: for each admissible path
   ``(l1, l2 → l3)``, ``m3[e,c] = R_path(rbf_e)[c] · CG ⊗ (h^{l1}[src,c] ⊗
   Y^{l2}[e])``; the radial MLP emits one weight per (path, channel).
3. :func:`segment_sum` over edges → per-node aggregates, normalized by
   √avg_degree (``premix_messages``: each path's channel mix applied per
   edge first, then one smaller segment sum; equal by linearity).
4. Self-interaction (per-l channel mix) + path mix + equivariant gate
   (scalars: SiLU; l>0: sigmoid-gated by learned scalar gates).

Readout: linear on scalars → per-atom energy → segment sum per graph.
Forces are ``−∂E/∂positions`` by ``torch.autograd.grad(...,
create_graph=True)``, so a training step differentiates through them (a
double backward through the gathers, the segment sums, the smooth norm and
the Bessel basis).

Segment sums and gathers. ``jax.ops.segment_sum`` becomes a sum into
``[n_segments, …]`` zeros. On the CPU it is ``index_add`` and a gather is
``index_select`` (whose backward is ``index_add`` again): each destination
sums its edges in index order, as XLA's CPU scatter does. On the card the
sum is ``index_put(accumulate=True)`` and a gather is advanced indexing
(whose backward is that sum again): PyTorch sorts the indices and adds each
destination's values in that order, with no float atomics, so two runs on
the card are bit-equal. (``index_add`` and ``index_select``'s backward use
atomics there.)

Padding: a batch is padded with self-edges on a ghost node. Their distance
is 0, so the norm is ``sqrt(‖rel‖² + 1e-12)`` and the basis clamps
``d ≥ 1e-6``, both as the reference. The ghost node gathers every padding
edge, and its scalars grow large and negative: SiLU is ``x ·
sigmoid(x)`` here (whose derivatives come from the sigmoid's value, as
JAX's do), so the forces and gradients stay finite.

Parameters are one flat ``dict[str, Tensor]`` keyed by the reference's
pytree paths (``species_embed``, ``layers/radial_w0``, ``layers/w_msg/1``,
…; the per-``l`` dicts are keyed by ``l``), the layers stacked on a leading
axis. ``init`` draws from a ``torch.Generator`` with the reference's
distributions (the numbers differ from ``jax.random``'s);
:func:`nequip_params_from_numpy` and :func:`nequip_params_to_numpy` carry
the reference's parameters across. Edges and node aggregates carry the
reference's sharding constraints (:func:`~repro_torch.distributed.constrain`:
the identity on a plain tensor).

On several ranks the train step splits the edges (``edge_src``,
``edge_dst``) over the ranks that ``"edges"`` resolves to (``("data",
"model")``: every rank of a pod), each rank taking a contiguous share
(:func:`~repro_torch.distributed.parallel.edge_axis`), as the reference's
``"edges"`` constraints do. It splits the node arrays (``positions``,
``species``, ``graph_id``, ``forces``, ``node_feat``) over the ranks that
``"nodes"`` resolves to (N: ``("data",)``, ``("pod", "data")`` on several
pods), each rank taking a contiguous share
(:func:`~repro_torch.distributed.parallel.node_axis`), as the reference's
``"nodes"`` constraints place them and every per-layer aggregate; a node
count that N does not divide stays whole. The other edge ranks (M,
``"model"``) hold the same node share. The parameters stay whole. Over
the ranks (:class:`~repro_torch.distributed.parallel.NodeAxis`):

- a node array gathered at the edges (positions, each layer's features)
  goes through ``gather_nodes``: all-gathered over N forward; backward,
  its per-edge gradient summed over every edge rank and cut to this
  rank's share (reduce-scatter over N, all-reduce over M);
- a segment sum of messages into nodes goes through ``scatter_nodes``,
  that backward's op: each rank keeps its node rows of every aggregate,
  and the self-interaction, the gate and the readout run on those rows;
- the per-graph energies sum the share's atoms and are summed over N
  (``reduce``; the M ranks hold the same rows), and the forces term is the
  mean over the whole ``[N, 3]``: the share's sum, summed over N, over the
  whole count;
- a node-side parameter (the embeddings, the self-interaction, the gates,
  the readout; the message mix without ``premix_messages``) enters
  through ``copy`` over N, an edge-side one (the radial MLP; the message
  mix under ``premix_messages``) through ``copy`` over every edge rank:
  the identity forward, their gradient summed over those ranks.

So the energies, the loss and every gradient come out whole and alike on
each rank, the forces as this rank's share, and the step reduces nothing.
``gather_nodes`` and ``scatter_nodes`` (as ``copy`` and ``reduce``) are
each other's backward, so the forces loss's double backward crosses the
ranks too. With the nodes whole (N of one rank) they are ``copy`` and
``reduce`` over every edge rank. Cutting a graph batch by whole graphs
would not be exact: the synthetic batches draw edges across graphs.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import NequIPConfig
from repro_torch.distributed.parallel import NodeAxis, edge_axis, node_axis
from repro_torch.distributed.sharding import constrain
from repro_torch.models import so3
from repro_torch.utils import resolve_device, tree_items

LS = (0, 1, 2)

Params = dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Segment sums and gathers.
# ---------------------------------------------------------------------------


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
                ) -> torch.Tensor:
    """``jax.ops.segment_sum``: row ``i`` of ``data`` added into row
    ``segment_ids[i]`` of ``[num_segments, …]`` zeros, each destination's
    rows in index order (see the module docstring for how, per device)."""
    out = data.new_zeros((num_segments, *data.shape[1:]))
    if data.device.type == "cuda":
        return out.index_put((segment_ids,), data, accumulate=True)
    return out.index_add(0, segment_ids, data)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · sigmoid(x)``, differentiable twice (the forces' double
    backward): ``torch.sigmoid``'s derivative comes from its value, so a
    ghost node's large negative scalars give 0, not NaN."""
    return x * torch.sigmoid(x)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` whose backward is :func:`segment_sum`."""
    return x[idx] if x.device.type == "cuda" else x.index_select(0, idx)


# ---------------------------------------------------------------------------
# Radial basis.
# ---------------------------------------------------------------------------


def bessel_basis(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """sin(nπ d / r_c) / d Bessel basis with smooth polynomial envelope.
    The clamps are ``torch.maximum`` / ``torch.minimum``, which split the
    gradient at a tie as ``jnp.maximum`` does."""
    zero, one = d.new_tensor(0.0), d.new_tensor(1.0)
    d = torch.maximum(d, d.new_tensor(1e-6))
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    basis = np.sqrt(2.0 / cutoff) * torch.sin(n * np.pi * d[..., None] / cutoff) / d[..., None]
    x = torch.minimum(torch.maximum(d / cutoff, zero), one)
    # p=6 polynomial envelope (DimeNet): 1 − 28x⁶ + 48x⁷ − 21x⁸  (C² at r_c).
    env = 1.0 - 28.0 * x**6 + 48.0 * x**7 - 21.0 * x**8
    return basis * env[..., None]


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------


def _n_paths_to(paths, l3: int) -> int:
    return sum(1 for (_, _, o) in paths if o == l3)


def _table(cfg: NequIPConfig, d_feat: int) -> dict:
    """path → (shape, logical axes, fan, scale), in the reference's draw
    order: each is ``normal · fan^-½ · scale``."""
    paths = so3.allowed_paths(cfg.l_max)
    mul, L = cfg.d_hidden, cfg.n_layers
    h0, h1 = cfg.radial_mlp
    lay = ("layers", None, None)
    table = {
        "species_embed": ((cfg.n_species, mul), (None, None), 1.0, 0.5),
        "readout_w": ((mul, 1), (None, None), mul, 1.0),
    }
    if d_feat:
        table["feat_proj"] = ((d_feat, mul), (None, None), d_feat, 1.0)
    table["layers/radial_w0"] = ((L, cfg.n_rbf, h0), lay, cfg.n_rbf, 1.0)
    table["layers/radial_w1"] = ((L, h0, h1), lay, h0, 1.0)
    table["layers/radial_w2"] = ((L, h1, len(paths) * mul), lay, h1, 1.0)
    for l in LS:
        table[f"layers/w_self/{l}"] = ((L, mul, mul), lay, mul, 1.0)
    for l in LS:
        k = _n_paths_to(paths, l) * mul
        table[f"layers/w_msg/{l}"] = ((L, k, mul), lay, k, 1.0)
    for l in (1, 2):
        table[f"layers/w_gate/{l}"] = ((L, mul, mul), lay, mul, 1.0)
    return table


def init(cfg: NequIPConfig, seed: int | torch.Generator | None,
         device: str | torch.device | None = None, d_feat: int = 0) -> Params:
    """Random float32 parameters on ``device`` (``None`` → the card) from
    ``seed`` (an int or a ``torch.Generator`` on that device); on ``meta``
    only shapes and dtypes (``seed`` unused)."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    gen = seed
    if dev.type != "meta" and not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = {}
    for path, (shape, _, fan, scale) in _table(cfg, d_feat).items():
        if dev.type == "meta":
            params[path] = torch.empty(shape, dtype=torch.float32, device=dev)
        else:
            w = torch.randn(shape, dtype=torch.float32, generator=gen, device=dev)
            params[path] = w.mul_(float(fan) ** -0.5 * scale)
    return params


def param_logical(cfg: NequIPConfig, d_feat: int = 0) -> dict[str, tuple]:
    return {path: logical for path, (_, logical, _, _) in _table(cfg, d_feat).items()}


# ---------------------------------------------------------------------------
# Forward.
# ---------------------------------------------------------------------------


def _edge_side(cfg: NequIPConfig) -> tuple[str, ...]:
    """The parameters applied per edge (their gradients are partial sums
    on each edge rank); the others are applied per node."""
    keys = ("layers/radial_w0", "layers/radial_w1", "layers/radial_w2")
    return keys + tuple(f"layers/w_msg/{l}" for l in LS) if cfg.premix_messages else keys


def _interaction(cfg: NequIPConfig, layer: Mapping[str, torch.Tensor], h, edge_src,
                 edge_dst, rbf, Y, n_nodes: int, nx: NodeAxis) -> dict[int, torch.Tensor]:
    """One NequIP interaction layer. h: {l: [N, mul, 2l+1]}, this rank's
    node share over ``nx`` of the ``n_nodes``; the edges are this rank's
    share."""
    paths = so3.allowed_paths(cfg.l_max)
    mul = cfg.d_hidden
    dt = getattr(torch, cfg.dtype)
    h_edges = {l: nx.gather_nodes(h[l]) for l in LS}                   # gathered at the edges

    # Radial weights per (path, channel).
    r = silu(rbf @ layer["radial_w0"])
    r = silu(r @ layer["radial_w1"])
    r = (r @ layer["radial_w2"]).reshape(-1, len(paths), mul).to(dt)   # [E, P, mul]

    msgs: dict[int, list[torch.Tensor]] = {l: [] for l in LS}
    for p_idx, (l1, l2, l3) in enumerate(paths):
        C = torch.as_tensor(so3.clebsch_gordan(l1, l2, l3), device=rbf.device).to(dt)
        h_src = _gather(h_edges[l1], edge_src)                         # [E, mul, d1]
        # m[e, u, m3] = Σ_{m1 m2} C[m3, m1, m2] h_src[e, u, m1] Y[e, m2]
        m = torch.einsum("abc,eub,ec->eua", C, h_src, Y[l2].to(dt))
        msgs[l3].append(m * r[:, p_idx, :, None])                      # [E, mul, d3]

    out = {}
    inv_deg = float(np.float32(1.0 / np.sqrt(cfg.avg_degree)))
    for l in LS:
        w_msg = layer[f"w_msg/{l}"].to(dt)                             # [P_l*mul, mul]
        if cfg.premix_messages:
            # Σ_p (m_p @ w_msg[block_p]) per edge, then one segment sum.
            pre = None
            for p_i, m in enumerate(msgs[l]):
                blk = w_msg[p_i * mul:(p_i + 1) * mul]                 # [mul, mul]
                term = torch.einsum("eud,um->emd", m, blk)
                pre = term if pre is None else pre + term
            mixed = constrain(nx.scatter_nodes(segment_sum(pre, edge_dst, n_nodes)),
                              "nodes", None, None) * inv_deg
        else:
            stacked = torch.cat(msgs[l], dim=1)                        # [E, P_l*mul, d]
            agg = constrain(nx.scatter_nodes(segment_sum(stacked, edge_dst, n_nodes)),
                            "nodes", None, None) * inv_deg
            mixed = torch.einsum("nkd,km->nmd", agg, w_msg)
        out[l] = torch.einsum("ncd,cm->nmd", h[l], layer[f"w_self/{l}"].to(dt)) + mixed

    # Equivariant gate: scalars through SiLU; l>0 scaled by learned gates.
    scalars = out[0]
    gated = {0: silu(scalars)}
    s = scalars[..., 0]                                                # [N, mul]
    for l in (1, 2):
        gate = torch.sigmoid(s @ layer[f"w_gate/{l}"].to(dt))          # [N, mul]
        gated[l] = out[l] * gate[..., None]
    return gated


def _embed_nodes(cfg: NequIPConfig, params: Params, species, node_feat):
    mul = cfg.d_hidden
    dt = getattr(torch, cfg.dtype)
    n = species.shape[0]
    scalars = _gather(params["species_embed"], species)                # [N, mul]
    if node_feat is not None:
        scalars = scalars + node_feat @ params["feat_proj"]
    dev = scalars.device
    return {
        0: scalars[..., None].to(dt),
        1: torch.zeros((n, mul, 3), dtype=dt, device=dev),
        2: torch.zeros((n, mul, 5), dtype=dt, device=dev),
    }


def forward_energy(cfg: NequIPConfig, params: Params, positions, species, edge_src,
                   edge_dst, graph_id=None, n_graphs: int = 1, node_feat=None
                   ) -> torch.Tensor:
    """Per-graph energies [n_graphs] (one graph without ``graph_id``).
    positions [N, 3]; edges index into nodes. Inside a train step the edges
    are this rank's share of them and the node arrays its node share
    (:func:`~repro_torch.distributed.parallel.edge_axis`,
    :func:`~repro_torch.distributed.parallel.node_axis`)."""
    ex, nx = edge_axis(), node_axis()
    n_nodes = positions.shape[0] * nx.size
    edge_src = constrain(edge_src.long(), "edges")
    edge_dst = constrain(edge_dst.long(), "edges")
    pos = nx.gather_nodes(positions)
    rel = _gather(pos, edge_src) - _gather(pos, edge_dst)              # [E, 3]
    # Smooth norm: grad of ‖·‖ at 0 is NaN, and degenerate (self-)edges must
    # not poison the force computation.
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    unit = rel / dist[..., None]
    rbf = constrain(bessel_basis(dist, cfg.n_rbf, cfg.cutoff), "edges", None)
    Y = {l: _sph(unit, l) for l in LS}

    edge_side = _edge_side(cfg)
    params = {k: ex.copy(v) if k in edge_side else nx.copy(v) for k, v in params.items()}
    h = _embed_nodes(cfg, params, species.long(), node_feat)
    stack = {k[len("layers/"):]: v for k, v in params.items() if k.startswith("layers/")}
    for i in range(cfg.n_layers):
        h = _interaction(cfg, {k: v[i] for k, v in stack.items()}, h, edge_src, edge_dst,
                         rbf, Y, n_nodes, nx)
    atom_e = (silu(h[0][..., 0]) @ params["readout_w"])[..., 0]        # [N]
    if graph_id is None:
        return nx.reduce(atom_e.sum()[None])
    return nx.reduce(segment_sum(atom_e, graph_id.long(), n_graphs))


def _sph(v: torch.Tensor, l: int) -> torch.Tensor:
    """torch version of so3.real_sph_harm (same polynomials)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return torch.ones_like(x)[..., None]
    if l == 1:
        return torch.stack([y, z, x], dim=-1) * np.sqrt(3.0)
    r2 = x * x + y * y + z * z
    return torch.stack(
        [
            np.sqrt(15.0) * x * y,
            np.sqrt(15.0) * y * z,
            np.sqrt(5.0) / 2.0 * (3 * z * z - r2),
            np.sqrt(15.0) * x * z,
            np.sqrt(15.0) / 2.0 * (x * x - y * y),
        ],
        dim=-1,
    )


def _energy_of(cfg: NequIPConfig, params: Params, batch, positions) -> torch.Tensor:
    return forward_energy(
        cfg, params, positions, batch["species"], batch["edge_src"], batch["edge_dst"],
        batch.get("graph_id"), int(batch["energy"].shape[0]), batch.get("node_feat"),
    )


def forces(cfg: NequIPConfig, params: Params, batch, create_graph: bool = False
           ) -> torch.Tensor:
    """``−∂(Σ energies)/∂positions`` [N, 3] (inside a train step, this
    rank's node share); ``create_graph`` keeps the graph, so a loss of the
    forces can be differentiated (the reference's ``-jax.grad(energy)``
    inside its loss)."""
    pos = batch["positions"]
    if not pos.requires_grad:
        pos = pos.detach().requires_grad_()
    with torch.enable_grad():
        e = _energy_of(cfg, params, batch, pos).sum()
        (g,) = torch.autograd.grad(e, pos, create_graph=create_graph)
    return -g


def loss_fn(cfg: NequIPConfig, params: Params, batch, with_forces: bool = False
            ) -> torch.Tensor:
    """Energy (+ optional force) matching loss. As in the reference, the
    energies are computed twice with forces: once for the energy term and
    once inside the force's gradient."""
    e = _energy_of(cfg, params, batch, batch["positions"])
    loss = torch.mean((e - batch["energy"]) ** 2)
    if with_forces and "forces" in batch:
        f = forces(cfg, params, batch, create_graph=torch.is_grad_enabled())
        loss = loss + _node_mean((f - batch["forces"]) ** 2)
    return loss


def _node_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a node array over all its nodes: ``torch.mean`` of the
    whole array, or of this rank's share summed over the node ranks."""
    nx = node_axis()
    if nx.size == 1:
        return torch.mean(x)
    return nx.reduce(x.sum()) / (x.numel() * nx.size)


# ---------------------------------------------------------------------------
# The parameter converters.
# ---------------------------------------------------------------------------


def nequip_params_from_numpy(cfg: NequIPConfig, tree: Any,
                             device: str | torch.device | None = None) -> Params:
    """The port's flat parameters on ``device`` (``None`` → the card) from
    the reference's parameter pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``); paths and shapes must be those
    of ``cfg`` (with ``feat_proj`` if the tree has one)."""
    dev = resolve_device(device)
    flat = {path: np.asarray(leaf) for path, leaf in tree_items(tree)}
    d_feat = flat["feat_proj"].shape[0] if "feat_proj" in flat else 0
    want = init(cfg, None, "meta", d_feat)
    if set(flat) != set(want):
        raise ValueError(
            f"{cfg.name}: parameter paths differ from the reference's: missing "
            f"{sorted(set(want) - set(flat))}, unexpected {sorted(set(flat) - set(want))}"
        )
    out = {}
    for path, leaf in flat.items():
        t = torch.from_numpy(np.array(leaf)).to(dev)
        if t.shape != want[path].shape or t.dtype != want[path].dtype:
            raise ValueError(f"{cfg.name}: {path} is {t.dtype}{list(t.shape)}, want "
                             f"{want[path].dtype}{list(want[path].shape)}")
        out[path] = t
    return out


def nequip_params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict:
    """The reference's parameter pytree (nested dicts, the per-``l`` dicts
    keyed by int ``l``) with numpy leaves: the inverse of
    :func:`nequip_params_from_numpy`."""
    nested: dict = {}
    for path, t in params.items():
        node = nested
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[int(last) if last.isdigit() else last] = t.detach().cpu().numpy()
    return nested
