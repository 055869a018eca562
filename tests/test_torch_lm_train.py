"""The port's LM training half against the JAX reference, on the CPU.

Smoke configs of Qwen3-4B (dense, QK-norm) and DeepSeek-MoE-16B (a dense
layer, then MoE layers with shared experts), in float32 and as shipped in
bfloat16. The reference's own ``init`` crosses by
``transformer_params_from_numpy``; the same numpy tokens and labels go
through ``repro.models.transformer`` and the port:

- ``chunked_cross_entropy``, its value and its gradients;
- ``loss_fn`` and the gradient of every parameter;
- one whole train step through the cells (AdamW as configured, and
  Adafactor with the ``optimizer`` field overridden, which accumulates
  microbatch gradients in bfloat16), and the port's step applied to the
  reference's gradients (the optimizers' arithmetic alone);
- microbatch 2 against the whole batch, within the port;
- remat ``"nothing"`` and ``"dots"`` against no remat, bit-equal within the
  port, and ``"dots"`` keeping the 2-D matmul outputs.

Tolerances. float32: ``lm_parity.F32_TOL`` (2e-4), for the loss relative
and for each gradient relative to its leaf's largest entry (measured:
2e-6). bfloat16: the loss within ``BF16_LOSS_TOL`` (measured 6e-4) and
each gradient within ``BF16_GRAD_TOL`` of its leaf's largest entry
(measured 0.036, ``dense_stack/attn/wk`` of DeepSeek's smoke config):
both packages round every op to bfloat16 at the same points, but RoPE's
``cos`` (ROADMAP C6) and the float32 sums differ in the last place, a
unit of bfloat16 moves here and there, and the backward pass sums those
units. A bfloat16 embedding's gradient sums a repeated token's rows in
bfloat16 in both packages on the CPU, bit-equal; on the card PyTorch sums
them in its own order and precision (ROADMAP C11,
:func:`test_bf16_embedding_gradient_sums_as_the_reference_on_the_cpu`).

A bfloat16 MoE routes a token differently where its router logits tie
within the drift: the reference's routing is recorded
(``lm_parity.record_reference``), every decision of the port that differs
must sit at a near tie (``lm_parity.rerouted``, margin < 0.1), and the
port then replays the reference's routing (``lm_parity.replay_routes``)
so that the gradients compare.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lm_parity import (  # noqa: E402
    F32_TOL,
    bf16_sums,
    embedding_case,
    embedding_grad,
    record_reference,
    replay_routes,
    rerouted,
)
from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro.models.api import make_cell as ref_make_cell  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro.train.optimizer import get_optimizer as ref_get_optimizer  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import transformer as ptfm  # noqa: E402
from repro_torch.models.api import make_cell  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.optimizer import get_optimizer  # noqa: E402
from repro_torch.utils import tree_items  # noqa: E402

ARCHS = ["qwen3-4b", "deepseek-moe-16b"]
DTYPES = ["float32", "bfloat16"]
B, S = 4, 32
BF16_LOSS_TOL = 0.01
BF16_GRAD_TOL = 1 / 16


def lm_configs(arch: str, dtype: str, **over):
    """(reference, port) smoke configs of ``arch`` in ``dtype``."""
    return tuple(dataclasses.replace(m.get_smoke_config(arch), dtype=dtype, **over)
                 for m in (ref_configs, port_configs))


@functools.lru_cache(maxsize=None)
def lm_params(arch: str, dtype: str):
    """The reference's ``init`` (key 0) and the port's copy of it."""
    rcfg, pcfg = lm_configs(arch, dtype)
    ref = jax.jit(lambda key: rtfm.init(rcfg, key))(jax.random.key(0))
    return ref, ptfm.transformer_params_from_numpy(pcfg, jax.tree.map(np.asarray, ref), "cpu")


def _batch(vocab: int, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _flat_np(tree) -> dict[str, np.ndarray]:
    return {k: _np(v) for k, v in tree_items(tree)}


def _rel(got, want) -> float:
    """Largest difference relative to ``want``'s largest entry."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def _grad_tol(dtype: str) -> float:
    return F32_TOL if dtype == "float32" else BF16_GRAD_TOL


def _hold_loss(got, want, dtype: str):
    got, want = float(_np(got)), float(_np(want))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL)
    else:
        assert abs(got - want) <= BF16_LOSS_TOL, (got, want)


def _ref_decisions(rcfg, ref_params, batch) -> list:
    """The reference's routing, one :class:`lm_parity.Decisions` per MoE
    layer, from its forward pass."""
    calls = []
    with record_reference(calls):
        jax.block_until_ready(jax.jit(functools.partial(rtfm.loss_fn, rcfg))(
            ref_params, {k: jnp.asarray(v) for k, v in batch.items()}))
    return calls


def _port_routing(pcfg, rcfg, ref_params, batch):
    """A context in which the port replays the reference's routing, after
    checking that the port's own decisions differ from it only at near
    ties (checked when the context exits); a dense config needs none."""
    import contextlib

    if not pcfg.is_moe:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def ctx():
        ref_calls, own = _ref_decisions(rcfg, ref_params, batch), []
        with replay_routes(ref_calls, own, passes=2 if pcfg.remat else 1):
            yield
        assert len(own) == len(ref_calls) == pcfg.n_moe_layers
        for ref_dec, port_dec in zip(ref_calls, own):
            for seq, msg in rerouted(ref_dec, port_dec, B).items():
                assert not msg, f"sequence {seq}: {msg}"

    return ctx()


# ---------------------------------------------------------------------------
# chunked_cross_entropy and loss_fn.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_cross_entropy_matches_reference(dtype, chunk):
    rng = np.random.default_rng(3)
    Bc, Sc, D, V = 2, 32, 16, 300
    h = rng.normal(size=(Bc, Sc, D)).astype(np.float32)
    w = (rng.normal(size=(D, V)) * D ** -0.5).astype(np.float32)
    labels = rng.integers(0, V, (Bc, Sc)).astype(np.int32)
    jdt = jnp.dtype(dtype)
    ref = jax.value_and_grad(
        lambda a, b: rtfm.chunked_cross_entropy(a, b, jnp.asarray(labels), chunk), argnums=(0, 1))
    want, (want_h, want_w) = ref(jnp.asarray(h, jdt), jnp.asarray(w, jdt))
    th = torch.as_tensor(h).to(getattr(torch, dtype)).requires_grad_()
    tw = torch.as_tensor(w).to(getattr(torch, dtype)).requires_grad_()
    got = ptfm.chunked_cross_entropy(th, tw, torch.as_tensor(labels), chunk)
    got_h, got_w = torch.autograd.grad(got, (th, tw))
    assert got.dtype == torch.float32
    _hold_loss(got, want, dtype)
    assert _rel(got_h, want_h) <= _grad_tol(dtype)
    assert _rel(got_w, want_w) <= _grad_tol(dtype)


def test_chunked_cross_entropy_refuses_a_ragged_chunk():
    h, w = torch.zeros(1, 12, 4), torch.zeros(4, 5)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ptfm.chunked_cross_entropy(h, w, torch.zeros(1, 12, dtype=torch.int32), chunk=8)


def _port_loss_and_grads(pcfg, params, batch):
    return trainer._grads(functools.partial(ptfm.loss_fn, pcfg), params,
                          {k: torch.as_tensor(v) for k, v in batch.items()})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch, dtype):
    rcfg, pcfg = lm_configs(arch, dtype)
    ref_params, params = lm_params(arch, dtype)
    batch = _batch(pcfg.vocab_size, seed=1)
    want, want_g = jax.jit(jax.value_and_grad(functools.partial(rtfm.loss_fn, rcfg)))(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    with _port_routing(pcfg, rcfg, ref_params, batch):
        got, got_g = _port_loss_and_grads(pcfg, params, batch)
    _hold_loss(got, want, dtype)
    want_g = dict(tree_items(want_g))
    assert set(got_g) == set(want_g)
    errs = {k: _rel(got_g[k], want_g[k]) for k in want_g}
    worst = max(errs, key=errs.get)
    print(f"{arch} {dtype}: loss {float(got):.6f} vs {float(want):.6f}; worst gradient "
          f"{worst} {errs[worst]:.3g}")
    assert errs[worst] <= _grad_tol(dtype), (worst, errs[worst])
    for k, g in got_g.items():
        assert g.dtype == params[k].dtype, k


def test_bf16_embedding_gradient_sums_as_the_reference_on_the_cpu():
    """ROADMAP C11: the gradient of a bfloat16 embedding lookup whose
    tokens repeat (a 32-token vocabulary, 512 lookups). JAX adds each
    occurrence's row into the table's gradient in bfloat16, one rounding
    per add, in token order; so does ``F.embedding``'s backward on the
    CPU: bit-equal. (On CUDA, PyTorch sums a token's rows in its own
    order and precision: ``tests/test_torch_cuda.py`` measures that gap;
    this test measures the gap of one float32 sum rounded once.)"""
    table, tokens, up = embedding_case()
    want = jax.grad(lambda t: jnp.sum(t[jnp.asarray(tokens)].astype(jnp.float32)
                                      * jnp.asarray(up)))(jnp.asarray(table, jnp.bfloat16))
    got = embedding_grad(table, tokens, up, "cpu")
    seq, once = bf16_sums(tokens, up, table.shape[0])
    np.testing.assert_array_equal(_np(got), _np(want))
    assert torch.equal(got, seq)
    gap = _rel(once, seq)
    print(f"bfloat16 embedding gradient, 512 lookups of 32 tokens: float32-once against "
          f"bfloat16 adds {gap:.4g} of the max")
    assert 0 < gap <= BF16_GRAD_TOL


# ---------------------------------------------------------------------------
# Train steps through the cells.
# ---------------------------------------------------------------------------


def _cells(arch: str, dtype: str, optimizer: str | None = None, microbatch: int = 0):
    over = {"optimizer": optimizer} if optimizer else {}
    rcfg, pcfg = lm_configs(arch, dtype, **over)
    shape = ShapeSpec(name="t", kind="train", seq_len=S, global_batch=B, microbatch=microbatch)
    ref_shape = ref_configs.base.ShapeSpec(**dataclasses.asdict(shape))
    return rcfg, pcfg, ref_make_cell(rcfg, ref_shape), make_cell(pcfg, shape)


def _step_on(cell, state, batch, grads: dict):
    """``cell.step`` with ``grads`` (numpy, by path) in place of its own."""
    own = trainer._grads

    def injected(loss_fn, params, b):
        loss, _ = own(loss_fn, params, b)
        return loss, {k: _tensor(grads[k]) for k in params}

    trainer._grads = injected
    try:
        return cell.step(state, batch)
    finally:
        trainer._grads = own


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype; bfloat16 bit for bit."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _hold_state(got, want, dtype: str, tol: float):
    """Every entry of a train state: parameters within one unit of their
    dtype's last place (bfloat16) or ``tol`` relative to the leaf's max
    (float32), optimizer entries within ``tol`` of their leaf's max."""
    got, want = _flat_np(got), _flat_np(want)
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("params/") and dtype == "bfloat16":
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
            assert (np.abs(got[k] - w) <= ulp).all(), k
        else:
            assert _rel(got[k], w) <= tol, (k, _rel(got[k], w))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, dtype, optimizer):
    """One step through the train cells, microbatch 2 (Adafactor
    accumulates in bfloat16): the loss and the grad norm against the
    reference's step; and the port's step on the reference's own gradients
    against the reference's step, entry by entry (a first AdamW step is
    ``lr · g / (|g| + eps)``, a sign on most entries, so the whole steps
    are compared through their gradients, in
    :func:`test_loss_and_every_gradient_match_reference`)."""
    rcfg, pcfg, ref_cell, cell = _cells(arch, dtype, optimizer, microbatch=2)
    ref_params, params = lm_params(arch, dtype)
    batch = _batch(pcfg.vocab_size, seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    ref_state = ref_trainer.init_state(ref_params, ref_get_optimizer(rcfg.optimizer))
    want_state, want_m = jax.jit(ref_cell.step)(ref_state, jbatch)
    state = trainer.init_state(params, get_optimizer(pcfg.optimizer))
    with _port_routing(pcfg, rcfg, ref_params, batch):
        got_state, got_m = cell.step(state, tbatch)
    _hold_loss(got_m["loss"], want_m["loss"], dtype)
    assert _rel(got_m["grad_norm"], want_m["grad_norm"]) <= _grad_tol(dtype)
    # The reference's step's gradients: its microbatch accumulation, in its dtype.
    ref_grads = _ref_step_grads(ref_cell, ref_state, jbatch)
    inj_state, _ = _step_on(cell, trainer.init_state(params, get_optimizer(pcfg.optimizer)), tbatch, ref_grads)
    _hold_state(inj_state, want_state, dtype, 1e-6)
    assert int(got_state.step) == 1 and int(got_state.opt_state["count"]) == 1


def _ref_step_grads(ref_cell, ref_state, jbatch) -> dict:
    """The gradients the reference's step hands its optimizer, recorded by
    wrapping the optimizer's update."""
    from repro.train import optimizer as ref_opt

    seen = {}
    opt = ref_get_optimizer(ref_cell.cfg.optimizer)

    def update(grads, state, params):
        seen.update(jax.tree.map(np.asarray, grads))
        return opt.update(grads, state, params)

    step = ref_trainer.make_train_step(
        functools.partial(rtfm.loss_fn, ref_cell.cfg), ref_opt.Optimizer(opt.init, update),
        microbatch=ref_cell.shape.microbatch,
        accum_dtype=jnp.bfloat16 if ref_cell.cfg.optimizer == "adafactor" else jnp.float32)
    step(ref_state, jbatch)
    return dict(tree_items(seen))


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_equal_the_whole_batch(arch):
    """float32, AdamW: the step on 2 microbatches of 2 against the step on
    the whole batch of 4: loss, grad norm and state within 1e-5 (the mean
    of two chunk means against one mean, and the gradient sums, reorder)."""
    _, pcfg, _, whole = _cells(arch, "float32")
    _, _, _, split = _cells(arch, "float32", microbatch=2)
    _, params = lm_params(arch, "float32")
    tbatch = {k: torch.as_tensor(v) for k, v in _batch(pcfg.vocab_size, seed=3).items()}
    opt = get_optimizer(pcfg.optimizer)
    (sw, mw), (sm, mm) = (c.step(trainer.init_state(params, opt), tbatch) for c in (whole, split))
    np.testing.assert_allclose(float(mm["loss"]), float(mw["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mm["grad_norm"]), float(mw["grad_norm"]), rtol=1e-5)
    # First AdamW step: compare the moments (m = 0.1·g, v = 0.05·g²), which
    # carry the gradients without the sign's jump at g ≈ 0.
    for which in ("m", "v"):
        for k, w in sw.opt_state[which].items():
            assert _rel(sm.opt_state[which][k], w) <= 1e-5, (which, k)


# ---------------------------------------------------------------------------
# Remat.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal_to_no_remat(arch, dtype, policy):
    _, params = lm_params(arch, dtype)
    batch = _batch(512, seed=4)
    base = dataclasses.replace(port_configs.get_smoke_config(arch), dtype=dtype)
    want, want_g = _port_loss_and_grads(dataclasses.replace(base, remat=False), params, batch)
    got, got_g = _port_loss_and_grads(
        dataclasses.replace(base, remat=True, remat_policy=policy), params, batch)
    assert torch.equal(got, want)
    for k in want_g:
        assert torch.equal(got_g[k], want_g[k]), k


def test_dots_policy_keeps_the_matmul_outputs():
    """In the backward pass, remat ``"nothing"`` recomputes a layer's 2-D
    matmuls; ``"dots"`` recomputes none of them (it keeps their outputs)
    but still recomputes the batched attention products."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    _, params = lm_params("qwen3-4b", "float32")
    batch = {k: torch.as_tensor(v) for k, v in _batch(512, seed=6).items()}
    base = dataclasses.replace(port_configs.get_smoke_config("qwen3-4b"), dtype="float32")
    counts = {}
    for name, cfg in (("none", dataclasses.replace(base, remat=False)),
                      ("nothing", dataclasses.replace(base, remat_policy="nothing")),
                      ("dots", dataclasses.replace(base, remat_policy="dots"))):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = ptfm.loss_fn(cfg, leaves, batch)
        with Count() as c:
            torch.autograd.grad(loss, list(leaves.values()))
        counts[name] = c.n
    # Per layer the forward's 2-D matmuls are q, k, v, o, gate, up and down;
    # "nothing" recomputes the first six (the recomputation stops once it
    # has every tensor the backward saved, and nothing saves down's output).
    layers = base.n_layers
    assert counts["nothing"]["mm"] - counts["none"]["mm"] == 6 * layers
    assert counts["dots"]["mm"] == counts["none"]["mm"]
    assert counts["dots"]["bmm"] > counts["none"]["bmm"]


# ---------------------------------------------------------------------------
# The train cells' shapes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-4b", "llama4-maverick-400b-a17b"])
def test_train_cell_accumulates_in_the_reference_dtype(arch):
    """Adafactor (Llama-4-Maverick's optimizer) accumulates microbatch
    gradients in bfloat16, AdamW in float32, as the reference's cells do."""
    from repro_torch.models import api

    seen = {}
    real = api.make_train_step

    def spy(loss_fn, opt, microbatch=0, grad_clip=0.0, accum_dtype=torch.float32):
        seen["accum"] = accum_dtype
        return real(loss_fn, opt, microbatch=microbatch, accum_dtype=accum_dtype)

    api.make_train_step = spy
    try:
        cfg = port_configs.get_config(arch)
        make_cell(cfg, next(s for s in cfg.shapes if s.kind == "train"))
    finally:
        api.make_train_step = real
    assert seen["accum"] == (torch.bfloat16 if cfg.optimizer == "adafactor" else torch.float32)
