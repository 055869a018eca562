"""The port's optimizers, train step, checkpoints and data pipelines
against the reference.

- Each optimizer takes the SAME gradients (numpy) as the reference's and
  must give its parameters and state within 1e-6: this separates the update
  from gradient noise (near-zero gradients make the first Adagrad or Adam
  step a sign).
- ``adagrad_rowwise``'s sparse-row path (duplicate rows included) must
  equal its own dense path on the same gradient, with untouched rows
  bit-identical.
- The reference's ``tests/test_checkpoint.py`` checks run again on the port
  (round trip, keep-last, exact resume, microbatching, each optimizer
  lowers the loss), and one train step of every RecSys cell is held to the
  reference's step.
- A checkpoint the reference writes restores in the port, and the next
  step matches; the pipelines' cursors match.
- bfloat16 leaves (an LM train state) round-trip bit for bit, stored as
  the reference stores them (``<V2``, the raw bits); a bfloat16 checkpoint
  the reference writes opens in the port, and the port writes its bytes.
"""

import dataclasses
import os
from functools import partial
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.configs as ref_configs  # noqa: E402
from repro.configs.base import ShapeSpec as RefShape  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.models.api import make_cell as ref_make_cell  # noqa: E402
from repro.models.synth import synthesize_inputs as ref_synth  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402

import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models.api import make_cell  # noqa: E402
from repro_torch.models.recsys import recsys_params_from_numpy  # noqa: E402
from repro_torch.train import checkpoint, optimizer, trainer  # noqa: E402
from repro_torch.train.trainer import TrainState, init_state, make_train_step  # noqa: E402
from repro_torch.utils import tree_items, tree_map  # noqa: E402

RECSYS = ("dlrm-rm2", "deepfm", "din", "bert4rec")


def _flat(tree) -> dict[str, np.ndarray]:
    return {
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in tree_items(tree)
    }


def _to_torch(flat: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in flat.items()}


# ---------------------------------------------------------------------------
# Optimizers on identical gradients.
# ---------------------------------------------------------------------------

SHAPES = {"w": (6, 5), "stack": (3, 4, 2), "b": (5,), "s": (), "table": (optimizer.ROWWISE_MIN_ROWS, 4)}


def _opt_case(rng):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor", "adagrad_rowwise"])
def test_optimizer_equals_the_reference_on_the_same_gradients(name):
    rng = np.random.default_rng(0)
    params = _opt_case(rng)
    grads = [_opt_case(rng) for _ in range(3)]
    grads[1]["w"][0] = 0.0   # an all-zero row and near-zero entries
    grads[2]["b"] *= 1e-6
    ref = getattr(ref_opt, name)(lr=0.05)
    port = getattr(optimizer, name)(lr=0.05)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref.init(rp)
    pp = _to_torch(params)
    ps = port.init(pp)
    for g in grads:
        rp, rs = jax.jit(ref.update)(jax.tree.map(jnp.asarray, g), rs, rp)
        pp, ps = port.update(_to_torch(g), ps, pp)
        want, got = _flat({"p": rp, "s": rs}), _flat({"p": pp, "s": ps})
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_rowwise_sparse_rows_equal_the_dense_path():
    rows, dim = optimizer.ROWWISE_MIN_ROWS, 8
    rng = np.random.default_rng(1)
    table = torch.as_tensor(rng.normal(size=(rows, dim)).astype(np.float32))
    opt = optimizer.adagrad_rowwise(lr=0.1)
    dense_p, sparse_p = {"t": table.clone()}, {"t": table.clone()}
    dense_s, sparse_s = opt.init(dense_p), opt.init(sparse_p)
    touched = np.zeros(0, dtype=np.int64)
    for _ in range(3):
        idx = rng.integers(0, 300, size=40)
        idx[:5] = idx[5]                        # duplicate rows
        vals = torch.as_tensor(rng.normal(size=(40, dim)).astype(np.float32))
        g = torch.sparse_coo_tensor(torch.as_tensor(idx)[None], vals, (rows, dim), check_invariants=True)
        before = sparse_p["t"]
        dense_p, dense_s = opt.update({"t": g.coalesce().to_dense()}, dense_s, dense_p)
        sparse_p, sparse_s = opt.update({"t": g}, sparse_s, sparse_p)
        assert sparse_p["t"] is before          # updated in place
        touched = np.union1d(touched, idx)
        untouched = np.setdiff1d(np.arange(rows), touched)
        np.testing.assert_array_equal(sparse_p["t"][untouched].numpy(), table[untouched].numpy())
        np.testing.assert_array_equal(dense_p["t"][untouched].numpy(), table[untouched].numpy())
        np.testing.assert_array_equal(sparse_p["t"].numpy(), dense_p["t"].numpy())
        np.testing.assert_array_equal(sparse_s["acc"]["t"].numpy(), dense_s["acc"]["t"].numpy())
        assert (sparse_s["acc"]["t"][untouched] == 0).all()


def test_rowwise_rejects_a_fully_sparse_table_gradient():
    opt = optimizer.adagrad_rowwise()
    p = {"t": torch.zeros(optimizer.ROWWISE_MIN_ROWS, 2)}
    g = torch.zeros(optimizer.ROWWISE_MIN_ROWS, 2).to_sparse()   # 2 sparse dims
    with pytest.raises(ValueError, match="rows x dim"):
        opt.update({"t": g}, opt.init(p), p)


# ---------------------------------------------------------------------------
# The reference's trainer/checkpoint checks, on the port.
# ---------------------------------------------------------------------------


def _toy_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _toy_params(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 2, generator=g), "b": torch.zeros(2),
            "nested/0/0": torch.ones(3), "nested/0/1": torch.zeros(3)}


def _batch_at(i, n=8):
    r = np.random.default_rng(100 + i)
    return {"x": torch.as_tensor(r.normal(size=(n, 4)).astype(np.float32)),
            "y": torch.as_tensor(r.normal(size=(n, 2)).astype(np.float32))}


def test_save_restore_roundtrip(tmp_path):
    state = init_state(_toy_params(0), optimizer.adamw(1e-2))
    save_dir = str(tmp_path)
    checkpoint.save_checkpoint(save_dir, 7, state, extra={"pipeline": {"cursor": 3, "seed": 0}})
    assert checkpoint.latest_step(save_dir) == 7
    template = init_state(_toy_params(9), optimizer.adamw(1e-2))
    restored, extra = checkpoint.restore_checkpoint(save_dir, template)
    assert extra["pipeline"]["cursor"] == 3
    assert isinstance(restored, TrainState)
    a, b = _flat(state), _flat(restored)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def test_restore_writes_into_the_template_one_leaf_at_a_time(tmp_path):
    """The restore copies into the template's own tensors (no second copy
    of the state on the device), and the file is np.savez's."""
    state = init_state(_toy_params(0), optimizer.adamw(1e-2))
    checkpoint.save_checkpoint(str(tmp_path), 1, state)
    with np.load(os.path.join(tmp_path, "step_0000000001.npz")) as data:
        assert sorted(data.files) == sorted(_flat(state))
        np.testing.assert_array_equal(data["params/w"], state.params["w"].numpy())
    template = init_state(_toy_params(3), optimizer.adamw(1e-2))
    ptrs = {k: v.data_ptr() for k, v in tree_items(template)}
    restored, _ = checkpoint.restore_checkpoint(str(tmp_path), template)
    for k, v in tree_items(restored):
        assert v.data_ptr() == ptrs[k], k
        np.testing.assert_array_equal(v.numpy(), _flat(state)[k], err_msg=k)
    wrong = init_state({**_toy_params(0), "w": torch.zeros(5, 2)}, optimizer.adamw(1e-2))
    with pytest.raises(ValueError, match="params/w"):
        checkpoint.restore_checkpoint(str(tmp_path), wrong)


def test_keep_last_gc(tmp_path):
    state = init_state(_toy_params(0), optimizer.adamw(1e-2))
    for s in range(6):
        checkpoint.save_checkpoint(str(tmp_path), s, state, keep_last=2)
    assert checkpoint.latest_step(str(tmp_path)) == 5
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npz")]) == 2


def test_training_resume_is_exact(tmp_path):
    """Train 6 steps straight vs 3 + checkpoint + restore + 3: bit-equal."""
    opt = optimizer.adamw(1e-2)
    step = make_train_step(_toy_loss, opt)
    s1 = init_state(_toy_params(1), opt)
    for i in range(6):
        s1, _ = step(s1, _batch_at(i))
    s2 = init_state(_toy_params(1), opt)
    for i in range(3):
        s2, _ = step(s2, _batch_at(i))
    checkpoint.save_checkpoint(str(tmp_path), 3, s2, extra={"step": 3})
    s2r, extra = checkpoint.restore_checkpoint(str(tmp_path), init_state(_toy_params(5), opt))
    for i in range(int(extra["step"]), 6):
        s2r, _ = step(s2r, _batch_at(i))
    a, b = _flat(s1), _flat(s2r)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("make_opt", [optimizer.adamw, optimizer.adafactor, optimizer.adagrad_rowwise])
def test_optimizers_reduce_loss(make_opt):
    opt = make_opt(5e-2)
    step = make_train_step(_toy_loss, opt)
    state = init_state(_toy_params(2), opt)
    r = np.random.default_rng(1)
    x = torch.as_tensor(r.normal(size=(64, 4)).astype(np.float32))
    w_true = torch.as_tensor(r.normal(size=(4, 2)).astype(np.float32))
    batch = {"x": x, "y": x @ w_true}
    first = None
    for _ in range(120):
        state, m = step(state, batch)
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < 0.5 * first


def test_microbatch_accumulation_matches_full_batch():
    opt = optimizer.adamw(1e-2)
    full = make_train_step(_toy_loss, opt)
    micro = make_train_step(_toy_loss, opt, microbatch=4)
    batch = _batch_at(2, n=16)
    s0 = init_state(_toy_params(3), opt)
    s_full, m_full = full(s0, batch)
    s_micro, m_micro = micro(s0, batch)
    np.testing.assert_allclose(float(m_full["loss"]), float(m_micro["loss"]), rtol=1e-5)
    for k in s_full.params:
        np.testing.assert_allclose(s_full.params[k].numpy(), s_micro.params[k].numpy(), atol=1e-6)


def test_microbatched_sparse_gradients_are_summed_then_coalesced():
    """Two chunks touching the same rows: one row each in the norm, and the
    same update as the whole batch."""
    rows = optimizer.ROWWISE_MIN_ROWS

    def loss(params, batch):
        v = torch.nn.functional.embedding(batch["ids"], params["t"], sparse=True)
        return (v.sum(-1) * batch["y"]).mean()

    opt = optimizer.adagrad_rowwise(0.1)
    g = torch.Generator().manual_seed(0)
    batch = {"ids": torch.tensor([1, 2, 1, 3, 2, 1, 7, 1]), "y": torch.randn(8, generator=g)}
    params = {"t": torch.randn(rows, 4, generator=g)}
    s_full, m_full = make_train_step(loss, opt)(init_state({"t": params["t"].clone()}, opt), batch)
    s_micro, m_micro = make_train_step(loss, opt, microbatch=4)(
        init_state({"t": params["t"].clone()}, opt), batch)
    np.testing.assert_allclose(float(m_micro["grad_norm"]), float(m_full["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(s_micro.params["t"].numpy(), s_full.params["t"].numpy(), atol=1e-6)
    dense = torch.zeros(rows, 4)
    for i, y in zip(batch["ids"], batch["y"]):
        dense[i] += y / 8
    np.testing.assert_allclose(float(m_full["grad_norm"]), float(dense.norm()), rtol=1e-6)


def test_grad_clip_scales_dense_and_sparse_gradients():
    def loss(params, batch):
        v = torch.nn.functional.embedding(batch["ids"], params["t"], sparse=True)
        return 100.0 * (v.sum() + params["w"].sum())

    opt = optimizer.adamw(1.0, weight_decay=0.0)
    seen = {}

    def spy(grads, state, params):
        seen.update(grads)
        return opt.update(grads, state, params)

    spy_opt = optimizer.Optimizer(init=opt.init, update=spy)
    state = init_state({"t": torch.zeros(10, 2), "w": torch.zeros(3)}, spy_opt)
    _, m = make_train_step(loss, spy_opt, grad_clip=1.0)(state, {"ids": torch.tensor([1, 1, 4])})
    assert float(m["grad_norm"]) > 1.0
    clipped = torch.sqrt(seen["t"].values().square().sum() + seen["w"].square().sum())
    np.testing.assert_allclose(float(clipped), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# One train step of every RecSys cell against the reference's.
# ---------------------------------------------------------------------------

TRAIN = dict(name="t", kind="train", batch=16)


def _ref_state(arch, seed=0, **over):
    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), **over)
    cell = ref_make_cell(cfg, RefShape(**TRAIN))
    return cfg, cell, jax.jit(cell.init_state)(jax.random.key(seed))


def _port_state(arch, ref_state, **over):
    """The port's state from the reference's, through the converters."""
    pcfg = dataclasses.replace(port_configs.get_smoke_config(arch), **over)
    cell = make_cell(pcfg, ShapeSpec(**TRAIN))
    params = recsys_params_from_numpy(pcfg, jax.tree.map(np.asarray, ref_state.params), "cpu")
    state = init_state(params, optimizer.get_optimizer(pcfg.optimizer))
    flat = _flat(ref_state)
    state = tree_map(
        lambda k, v: torch.as_tensor(np.array(flat[k])) if isinstance(v, torch.Tensor) else v, state)
    return cell, state


def _hold_step(got, want):
    """Every entry of the state after a step within 1e-5 of the
    reference's: a first Adam/Adagrad step on a near-zero gradient is a
    sign, so an entry whose gradient's sign differs would show here."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def _step_with_grads(cell, state, batch, grads):
    """``cell.step`` with ``grads`` (numpy, by parameter path) in place of
    the port's own gradients, in the port's layout: a table whose gradient
    the port makes sparse gets the rows that ``grads`` holds nonzero."""
    own = trainer._grads

    def injected(loss_fn, params, b):
        loss, g = own(loss_fn, params, b)
        return loss, {
            k: torch.as_tensor(np.array(grads[k])).to_sparse(1) if v.is_sparse
            else torch.as_tensor(np.array(grads[k]))
            for k, v in g.items()
        }

    with mock.patch.object(trainer, "_grads", injected):
        return cell.step(state, batch)


def _check_step(arch, **over):
    """One step of the smoke cell (config fields ``over`` replaced in both
    packages) against the reference's step; returns the port's state before
    and after it."""
    cfg, ref_cell, ref_state = _ref_state(arch, **over)
    cell, state = _port_state(arch, ref_state, **over)
    before = _flat(state)
    batch = ref_synth(ref_cell, seed=5)
    ref_step = jax.jit(ref_cell.step)
    want_state, want_m = ref_step(ref_state, batch)
    from repro.models import recsys as ref_recsys

    ref_grads = _flat(jax.jit(jax.grad(partial(ref_recsys.loss_fn, cfg)))(ref_state.params, batch))
    got_state, got_m = cell.step(state, _to_torch(batch))
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_m["grad_norm"]), float(want_m["grad_norm"]), rtol=1e-5)
    _hold_step(got_state, want_state)
    assert int(got_state.step) == int(want_state.step) == 1

    # The update alone: the same step on the reference's gradients, held
    # at the optimizers' 1e-6 in every entry.
    cell, state = _port_state(arch, ref_state, **over)
    inj_state, inj_m = _step_with_grads(cell, state, _to_torch(batch), ref_grads)
    np.testing.assert_allclose(float(inj_m["grad_norm"]), float(want_m["grad_norm"]), rtol=1e-6)
    got, want = _flat(inj_state), _flat(want_state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    return batch, before, _flat(got_state)


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_train_step_equals_the_reference(arch):
    _check_step(arch)


def test_rowwise_table_train_step_equals_the_reference():
    """A smoke DLRM whose first table is row-wise: its sparse gradient
    updates the touched rows in place, as the reference's dense row-wise
    step does, and leaves every other row bit-unchanged."""
    rows = optimizer.ROWWISE_MIN_ROWS + 1024
    vocab = (rows, *port_configs.get_smoke_config("dlrm-rm2").vocab_sizes[1:])
    batch, before, after = _check_step("dlrm-rm2", vocab_sizes=vocab)
    table, acc = after["params/tables/t0"], after["opt_state/acc/tables/t0"]
    assert table.shape[0] >= rows and acc.shape == table.shape[:1]   # row-wise
    untouched = np.ones(table.shape[0], dtype=bool)
    untouched[np.asarray(batch["sparse"])[:, 0].ravel()] = False
    assert untouched.sum() < table.shape[0]
    np.testing.assert_array_equal(table[untouched], before["params/tables/t0"][untouched])
    assert (acc[untouched] == 0).all() and (acc[~untouched] > 0).all()


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    _, ref_cell, ref_state = _ref_state("dlrm-rm2", seed=4)
    ref_step = jax.jit(ref_cell.step)
    ref_state, _ = ref_step(ref_state, ref_synth(ref_cell, seed=0))
    ref_ckpt.save_checkpoint(str(tmp_path), 1, ref_state, extra={"step": 1})
    cell = make_cell(port_configs.get_smoke_config("dlrm-rm2"), ShapeSpec(**TRAIN))
    template = cell.init_state(0, device="cpu")
    state, extra = checkpoint.restore_checkpoint(str(tmp_path), template)
    assert extra == {"step": 1}
    want = _flat(ref_state)
    got = _flat(state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    batch = ref_synth(ref_cell, seed=1)
    want_state, want_m = ref_step(ref_state, batch)
    got_state, got_m = cell.step(state, _to_torch(batch))
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]), rtol=1e-5, atol=1e-5)
    _hold_step(got_state, want_state)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    cell = make_cell(port_configs.get_smoke_config("din"), ShapeSpec(**TRAIN))
    state = cell.init_state(3, device="cpu")
    checkpoint.save_checkpoint(str(tmp_path), 2, state, extra={"step": 2})
    _, ref_cell, template = _ref_state("din")
    restored, extra = ref_ckpt.restore_checkpoint(str(tmp_path), template)
    assert extra == {"step": 2}
    want, got = _flat(state), _flat(jax.tree.map(np.asarray, restored))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Data pipelines.
# ---------------------------------------------------------------------------


def test_token_pipeline_matches_the_reference_and_resumes():
    ref = ref_pipeline.TokenPipeline(vocab_size=100, batch_size=2, seq_len=8, seed=5)
    port = pipeline.TokenPipeline(vocab_size=100, batch_size=2, seq_len=8, seed=5)
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    saved = port.state()
    nxt = port.next_batch()
    again = pipeline.TokenPipeline(vocab_size=100, batch_size=2, seq_len=8, seed=0)
    again.restore(saved)
    np.testing.assert_array_equal(again.next_batch()["tokens"], nxt["tokens"])
    assert port.state() == {"cursor": 4, "seed": 5}


def test_query_batcher_cursor_matches_the_reference():
    ref = ref_pipeline.QueryBatcher(n_queries=10, batch_queries=4)
    port = pipeline.QueryBatcher(n_queries=10, batch_queries=4)
    for _ in range(4):
        np.testing.assert_array_equal(ref.next_indices(), port.next_indices())
        assert ref.state() == port.state()
    other = pipeline.QueryBatcher(n_queries=10, batch_queries=4)
    other.restore(port.state())
    np.testing.assert_array_equal(other.next_indices(), ref.next_indices())


# ---------------------------------------------------------------------------
# bfloat16 leaves (an LM train state).
# ---------------------------------------------------------------------------


def _lm_state(seed: int):
    """A bfloat16 LM train state (smoke Qwen3-4B, AdamW) on the CPU."""
    from repro_torch.models import transformer as tfm

    cfg = port_configs.get_smoke_config("qwen3-4b")
    return init_state(tfm.init(cfg, seed, device="cpu"), optimizer.get_optimizer("adamw"))


def test_bf16_train_state_round_trips(tmp_path):
    state = _lm_state(1)
    state.opt_state["m"]["embed"].normal_(generator=torch.Generator().manual_seed(2))
    checkpoint.save_checkpoint(str(tmp_path), 3, state, extra={"step": 3})
    template = tree_map(lambda _, t: torch.zeros_like(t), state)
    restored, extra = checkpoint.restore_checkpoint(str(tmp_path), template)
    assert extra == {"step": 3}
    want = dict(tree_items(state))
    assert want["params/embed"].dtype == torch.bfloat16
    for k, t in tree_items(restored):
        assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k
    # The file holds the reference's bytes for a bfloat16 leaf: '<V2' raw.
    with np.load(os.path.join(tmp_path, "step_0000000003.npz")) as data:
        raw = data["params/embed"]
    assert raw.dtype.kind == "V" and raw.dtype.itemsize == 2
    np.testing.assert_array_equal(raw.view(np.int16),
                                  want["params/embed"].view(torch.int16).numpy())


def test_reference_bf16_checkpoint_opens_in_the_port(tmp_path):
    """A bfloat16 state written by ``repro.train.checkpoint`` restores into
    the port's template bit for bit, and the two files' bytes are equal
    leaf by leaf. (The reference's own restore raises on it: ROADMAP C10.)"""
    import zipfile

    from repro.models import transformer as rtfm

    from repro_torch.models import transformer as tfm

    rcfg = ref_configs.get_smoke_config("qwen3-4b")
    pcfg = port_configs.get_smoke_config("qwen3-4b")
    ref_params = jax.jit(lambda k: rtfm.init(rcfg, k))(jax.random.key(4))
    ref_state = ref_trainer.init_state(ref_params, ref_opt.get_optimizer("adamw"))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, ref_state, extra={"step": 5})
    with pytest.raises(ValueError, match="No cast function"):
        ref_ckpt.restore_checkpoint(str(tmp_path / "ref"), ref_state)
    template = tree_map(lambda _, t: torch.full_like(t, 7), _lm_state(0))
    restored, extra = checkpoint.restore_checkpoint(str(tmp_path / "ref"), template)
    assert extra == {"step": 5}
    params = tfm.transformer_params_from_numpy(pcfg, jax.tree.map(np.asarray, ref_params), "cpu")
    for k, p in params.items():
        assert torch.equal(restored.params[k], p), k
    for k, t in tree_items(restored.opt_state):
        assert torch.equal(t, torch.zeros_like(t)), k
    # The port writes the same bytes for every leaf.
    port_state = init_state(params, optimizer.get_optimizer("adamw"))
    checkpoint.save_checkpoint(str(tmp_path / "port"), 5, port_state, extra={"step": 5})
    names = [f"step_{5:010d}.npz"]
    with zipfile.ZipFile(tmp_path / "ref" / names[0]) as a, \
            zipfile.ZipFile(tmp_path / "port" / names[0]) as b:
        assert sorted(a.namelist()) == sorted(b.namelist())
        for n in a.namelist():
            assert a.read(n) == b.read(n), n
