"""Holding one run of the LM to another: tolerances, and the routing rule.

Tolerances (port against reference on the CPU, and card against CPU).
float32: ``F32_TOL`` = 2e-4, the reference's own (``tests/test_layers.py``).
bfloat16: the two sides round every op to bfloat16 at the same points, but
RoPE's ``cos`` and the float32 attention sums differ in the last place, so
a layer's output differs by a unit of bfloat16 here and there and the
differences travel through the layers. Logits are held to
``BF16_LOGIT_TOL`` and caches to ``BF16_CACHE_TOL`` (absolute; logits are
of magnitude 2-5, cache entries up to 8). The largest differences measured
on the CPU (``tests/test_torch_lm.py``, all five smoke configs, port
against reference) were 0.0612 in logits and 0.0469 in caches in
bfloat16, 6.3e-6 and 4.1e-6 in float32; the bfloat16 tolerances are about
twice the measured maxima.

The routing rule. A bfloat16 forward in two packages (or on two devices) drifts by a unit in
the last place here and there, and a router whose top-k choice (or an
expert whose capacity boundary) is that close to a tie can then route a
token differently. That is a discontinuity, not an error: the token's
output changes by a whole expert's share, and in prefill the change
reaches its sequence's later tokens through attention. So a comparison
records every MoE layer's routing decisions on both sides and sets aside,
from the first layer on which they differ, the sequences they differ for,
after checking that the first difference sits at a near tie: the
router-logit margin of a re-routed token (``log p_k - log p_{k+1}``), or
the margin at the capacity boundary of an expert whose kept tokens
differ, must be below ``ROUTE_MARGIN``. The drift of router logits before
any re-routing measured 0.022-0.035 on the smoke configs (port against
reference, CPU, bfloat16); ``ROUTE_MARGIN`` is about three times that.

At prefill a dispatch group is one sequence; at decode one group holds
every sequence's token, so a difference in kept tokens there sets aside
every sequence.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

F32_TOL = 2e-4
BF16_LOGIT_TOL = 0.125
BF16_CACHE_TOL = 0.125
ROUTE_MARGIN = 0.1


def to_numpy(x) -> np.ndarray:
    """A tensor or array (a JAX array, bfloat16 too) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def hold(got, want, rows: list[int], dtype: str, what: str) -> float:
    """Rows ``rows`` (batch axis first) of ``got`` within the tolerance of
    ``dtype`` of ``want`` (logits if ``what`` starts with "logits", else
    caches); returns the largest difference."""
    if not rows:
        return 0.0
    got, want = to_numpy(got)[rows], to_numpy(want)[rows]
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL, err_msg=what)
    else:
        tol = BF16_LOGIT_TOL if what.startswith("logits") else BF16_CACHE_TOL
        assert err <= tol, (what, err, tol)
    return err


def hold_caches(got: dict, want: dict, rows: list[int], dtype: str, what: str) -> float:
    """Every ``{stack: {"k", "v"}}`` cache ``[L, B, S, Hkv, Dh]``, rows of
    the batch axis, by :func:`hold`; returns the largest difference."""
    errs = [0.0]
    for name in want:
        for kv in ("k", "v"):
            errs.append(hold(np.swapaxes(to_numpy(got[name][kv]), 0, 1),
                             np.swapaxes(to_numpy(want[name][kv]), 0, 1), rows, dtype,
                             f"caches {what} {name}/{kv}"))
    return max(errs)


@dataclasses.dataclass
class Decisions:
    """One MoE call's routing: ``top`` [G, T, k] each token's experts
    (sorted ascending), ``kept`` [G, E, T] whether expert e keeps token t,
    and, on the side that supplies margins, ``top_margin`` [G, T] and
    ``cap_margin`` [G, E] (inf where no expert overflows)."""

    top: np.ndarray
    kept: np.ndarray
    top_margin: np.ndarray | None = None
    cap_margin: np.ndarray | None = None


def _kept(weight: np.ndarray, token_idx: np.ndarray) -> np.ndarray:
    """[G, E, T]: expert e holds token t in a slot with weight > 0."""
    G, T, E = weight.shape
    kept = np.zeros((G, E, T), bool)
    g, e, _ = np.indices(token_idx.shape)
    kept[g, e, token_idx] = weight.transpose(0, 2, 1)[g, e, token_idx] > 0
    return kept


def port_decisions(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
                   capacity_factor: float, route=None) -> Decisions:
    from repro_torch.models import moe

    probs, top_idx, weight, token_idx = (route or moe.route)(
        x, router_w, top_k=top_k, capacity_factor=capacity_factor)
    probs, weight = probs.double().cpu().numpy(), weight.double().cpu().numpy()
    logp = np.log(np.sort(probs, axis=-1)[..., ::-1])
    E = probs.shape[-1]
    top_margin = (logp[..., top_k - 1] - logp[..., top_k]) if top_k < E \
        else np.full(probs.shape[:2], np.inf)
    C = token_idx.shape[-1]
    w = np.sort(weight.transpose(0, 2, 1), axis=-1)[..., ::-1]          # [G, E, T]
    with np.errstate(divide="ignore", invalid="ignore"):
        cap = np.where(w[..., C] > 0, np.log(w[..., C - 1]) - np.log(w[..., C]), np.inf) \
            if C < w.shape[-1] else np.full(w.shape[:2], np.inf)
    return Decisions(np.sort(top_idx.cpu().numpy(), -1), _kept(weight, token_idx.cpu().numpy()),
                     top_margin, cap)


@contextlib.contextmanager
def record_port(calls: list):
    """Append each MoE call's :class:`Decisions` (with margins) to ``calls``
    while the port's transformer runs."""
    from repro_torch.models import transformer as tfm

    real = tfm.moe_ffn

    def recording(x, router_w, *args, top_k, capacity_factor, **kw):
        calls.append(port_decisions(x, router_w, top_k, capacity_factor))
        return real(x, router_w, *args, top_k=top_k, capacity_factor=capacity_factor, **kw)

    tfm.moe_ffn = recording
    try:
        yield calls
    finally:
        tfm.moe_ffn = real


@contextlib.contextmanager
def record_reference(calls: list):
    """Append each MoE call's :class:`Decisions` to ``calls`` while the JAX
    reference's transformer runs (also inside ``jit`` and ``scan``, through
    an ordered host callback). The decisions are the reference's own
    ``moe_ffn`` lines (``repro/models/moe.py:50-66``)."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as rmoe
    from repro.models import transformer as rtfm

    real = rtfm.moe_ffn

    def recording(x, router_w, *args, top_k, capacity_factor, **kw):
        G, T, _ = x.shape
        E = router_w.shape[1]
        C = rmoe._capacity(T, E, top_k, capacity_factor)
        probs = jax.nn.softmax(x.astype(jnp.float32) @ router_w.astype(jnp.float32), -1)
        top_p, top_idx = jax.lax.top_k(probs, top_k)
        top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
        weight = (jax.nn.one_hot(top_idx, E, dtype=jnp.float32) * top_p[..., None]).sum(2)
        priority = jnp.where(weight > 0, weight, -1.0)
        _, token_idx = jax.lax.top_k(priority.transpose(0, 2, 1), C)

        def host(top_idx, weight, token_idx):
            calls.append(Decisions(np.sort(np.asarray(top_idx), -1),
                                   _kept(np.asarray(weight), np.asarray(token_idx))))

        jax.debug.callback(host, top_idx, weight, token_idx, ordered=True)
        return real(x, router_w, *args, top_k=top_k, capacity_factor=capacity_factor, **kw)

    rtfm.moe_ffn = recording
    try:
        yield calls
    finally:
        rtfm.moe_ffn = real


def rerouted(a: Decisions, b: Decisions, batch: int) -> dict[int, str]:
    """Sequences whose routing differs between ``a`` and ``b`` (``b`` gives
    the margins), each with a failure message if its difference is not at a
    near tie (else ``""``)."""
    G, T, _ = a.top.shape
    out: dict[int, str] = {}
    per_group = G == batch            # prefill: group = sequence; decode: token = sequence
    for g in range(G):
        moved = np.nonzero((a.top[g] != b.top[g]).any(-1))[0]
        for t in moved:
            seq = g if per_group else int(t)
            m = b.top_margin[g, t]
            out.setdefault(seq, "" if m < ROUTE_MARGIN else
                           f"token {t} of group {g} re-routed at margin {m:.4g}")
        if len(moved):
            continue
        full = np.nonzero((a.kept[g] != b.kept[g]).any(-1))[0]
        for e in full:
            m = b.cap_margin[g, e]
            msg = "" if m < ROUTE_MARGIN else f"expert {e} of group {g} kept other tokens at margin {m:.4g}"
            for seq in ([g] if per_group else range(batch)):
                out.setdefault(seq, msg)
    return out


def rerouted_last(a: Decisions, b: Decisions, batch: int) -> dict[int, str]:
    """:func:`rerouted` for a model's last MoE layer when it is its last
    layer: its output reaches only the token's own logits, so a sequence
    is set aside only where the token whose logits are read (the last of a
    prefill group; at decode, each sequence's token) changed experts or
    was kept by other ones."""
    G, T, _ = a.top.shape
    out: dict[int, str] = {}
    for g in range(G):
        for t in ([T - 1] if G == batch else range(T)):
            seq = g if G == batch else t
            if (a.top[g, t] != b.top[g, t]).any():
                m = b.top_margin[g, t]
                out[seq] = "" if m < ROUTE_MARGIN else f"token {t} re-routed at margin {m:.4g}"
            elif (a.kept[g, :, t] != b.kept[g, :, t]).any():
                m = b.cap_margin[g][a.kept[g, :, t] != b.kept[g, :, t]].min()
                out[seq] = "" if m < ROUTE_MARGIN else f"token {t} kept elsewhere at margin {m:.4g}"
    return out


def set_aside(a_calls: list, b_calls: list, batch: int, out: set, lo: int = 0,
              hi: int | None = None, ignore=frozenset()) -> set:
    """Add to ``out`` the sequences re-routed in calls ``lo:hi``; fail on a
    re-routing that is not at a near tie. Only a sequence's first
    difference is checked (past it the two runs no longer compare), and
    sequences in ``ignore`` (already set aside, or fed other tokens) are
    skipped."""
    hi = len(a_calls) if hi is None else hi
    assert len(a_calls) >= hi and len(b_calls) >= hi, (len(a_calls), len(b_calls), hi)
    for a, b in zip(a_calls[lo:hi], b_calls[lo:hi]):
        for seq, msg in rerouted(a, b, batch).items():
            if seq not in out and seq not in ignore:
                assert not msg, msg
                out.add(seq)
    return out



def _concat(parts: list) -> list:
    """Per layer, its microbatches' :class:`Decisions` joined along the
    group axis."""
    return [Decisions(*(None if getattr(ds[0], f.name) is None
                        else np.concatenate([getattr(d, f.name) for d in ds])
                        for f in dataclasses.fields(Decisions)))
            for ds in parts]


@contextlib.contextmanager
def record_routes(decisions: list, passes: int = 1):
    """Append each MoE layer's routing (:class:`Decisions`, no margins)
    over the whole batch to ``decisions`` when the context exits, one per
    layer in the order the layers first run. A layer is known by its
    router's storage; of its calls, every ``passes``-th is recorded (a
    training step runs each layer ``passes`` times a microbatch: 2 under
    remat, the forward and its recomputation), and the microbatches'
    decisions are joined in order."""
    from repro_torch.models import moe

    real = moe.route
    layer_of: dict[int, int] = {}
    calls: list[int] = []
    parts: list[list[Decisions]] = []

    def recording(x, router_w, *, top_k, capacity_factor):
        out = real(x, router_w, top_k=top_k, capacity_factor=capacity_factor)
        key = router_w.data_ptr()
        if key not in layer_of:
            layer_of[key] = len(layer_of)
            calls.append(0)
            parts.append([])
        layer = layer_of[key]
        if calls[layer] % passes == 0:
            _, top_idx, weight, token_idx = (t.detach().cpu() for t in out)
            parts[layer].append(Decisions(np.sort(top_idx.numpy(), -1),
                                          _kept(weight.double().numpy(), token_idx.numpy())))
        calls[layer] += 1
        return out

    moe.route = recording
    try:
        yield decisions
    finally:
        moe.route = real
        decisions.extend(_concat(parts))


@contextlib.contextmanager
def replay_routes(decisions: list, own: list, passes: int = 1):
    """While the port runs, each MoE layer takes its experts and the tokens
    each expert keeps from ``decisions`` (one :class:`Decisions` per layer
    over the whole batch, in the order the layers first run:
    :func:`record_routes` of another run, or :func:`record_reference`) and
    computes only their weights from its own router probabilities, in
    ``moe.route``'s arithmetic. Its own decisions, with margins, go to
    ``own`` (one per layer, over the whole batch, when the context exits).
    So two runs whose routers drift across a near tie are held on the same
    routing, once :func:`rerouted` has found, on ``own`` against
    ``decisions``, that each decision that differs is a near tie.

    A layer is known by its router's storage. A training step may run the
    batch in microbatches, and each layer ``passes`` times a microbatch (2
    under remat: the forward and its recomputation): the n-th call of a
    layer routes groups ``[c·G, (c+1)·G)`` of the batch, ``c = n //
    passes``."""
    from repro_torch.models import moe

    real = moe.route
    layer_of: dict[int, int] = {}
    calls: list[int] = []
    parts: list[list[Decisions]] = []

    def replaying(x, router_w, *, top_k, capacity_factor):
        key = router_w.data_ptr()
        if key not in layer_of:
            layer_of[key] = len(layer_of)
            calls.append(0)
            parts.append([])
        layer = layer_of[key]
        chunk, first = divmod(calls[layer], passes)
        calls[layer] += 1
        if first == 0:
            parts[layer].append(port_decisions(x.detach(), router_w.detach(), top_k,
                                               capacity_factor, real))
        G = x.shape[0]
        rows = slice(chunk * G, (chunk + 1) * G)
        dec = decisions[layer]
        C = moe._capacity(x.shape[1], router_w.shape[1], top_k, capacity_factor)
        top_idx = torch.as_tensor(dec.top[rows], device=x.device).long()
        # Each expert's kept tokens first, then tokens that did not choose it
        # (weight 0), as route's capacity slots hold them.
        kept = torch.as_tensor(dec.kept[rows], device=x.device)
        token_idx = torch.argsort((~kept).to(torch.uint8), dim=-1, stable=True)[..., :C]
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        top_p = torch.gather(probs, -1, top_idx)
        top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
        weight = torch.zeros_like(probs).scatter_(-1, top_idx, top_p)
        return probs, top_idx, weight, token_idx

    moe.route = replaying
    try:
        yield own
    finally:
        moe.route = real
        own.extend(_concat(parts))


# ---------------------------------------------------------------------------
# A bfloat16 embedding's gradient (ROADMAP C11).
# ---------------------------------------------------------------------------


def embedding_case() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A 32-token table of width 16, 512 lookups (~16 repeats a token) and
    the cotangent of each looked-up row."""
    rng = np.random.default_rng(5)
    V, D, n = 32, 16, 512
    table = rng.normal(size=(V, D)).astype(np.float32)
    tokens = rng.integers(0, V, n).astype(np.int32)
    up = rng.normal(size=(n, D)).astype(np.float32)
    return table, tokens, up


def embedding_grad(table, tokens, up, device) -> torch.Tensor:
    """The gradient of a bfloat16 ``F.embedding`` lookup on ``device``."""
    t = torch.as_tensor(table, device=device).bfloat16().requires_grad_()
    out = torch.nn.functional.embedding(torch.as_tensor(tokens, device=device).long(), t)
    (g,) = torch.autograd.grad((out.float() * torch.as_tensor(up, device=device)).sum(), t)
    return g.cpu()


def bf16_sums(tokens, up, V: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's cotangent rows (rounded to bfloat16) summed in token
    order two ways: one bfloat16 rounding per add, and in float32 rounded
    once."""
    rows = torch.as_tensor(up).bfloat16()
    tok = torch.as_tensor(tokens).long()
    seq = torch.zeros(V, rows.shape[1], dtype=torch.bfloat16)
    for i in range(len(tokens)):
        seq[tok[i]] += rows[i]
    once = torch.zeros(V, rows.shape[1]).index_add_(0, tok, rows.float()).bfloat16()
    return seq, once
