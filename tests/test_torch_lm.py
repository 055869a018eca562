"""The port's LM (decoder, MoE, caches, converter, cells' shapes) against
the JAX reference, on the CPU.

For all five LM smoke configs, as shipped (bfloat16) and in a float32
variant (``dataclasses.replace(cfg, dtype="float32")``), the reference's
own ``init`` is carried across by ``transformer_params_from_numpy`` and the
same numpy inputs go through both packages: prefill logits and caches,
then 8 ``decode_step``s on the same tokens, their logits and caches (the
port's caches written in place). Also: the converter round trip, bfloat16
bit for bit; parameter paths, shapes and dtypes, logical axes, and the
cells' ``meta`` states and input specs at the full configs, against the
reference's ``eval_shape``; and ``python -m repro_torch.launch.serve
--arch qwen3-4b --device cpu``. ``generate`` and the serving cells:
``tests/test_torch_lm_serve.py``.

Tolerances, and the routing rule that sets aside a sequence re-routed at a
near tie in a bfloat16 MoE config: ``tests/lm_parity.py``. Each case
prints its largest differences and how many sequences it set aside.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lm_parity import hold, hold_caches, record_port, record_reference, set_aside  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro.models.api import make_cell as ref_make_cell  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models import transformer as ptfm  # noqa: E402
from repro_torch.models.api import make_cell  # noqa: E402
from repro_torch.utils import tree_items  # noqa: E402

LM_ARCHS = [
    "qwen2.5-14b", "minitron-4b", "qwen3-4b",
    "deepseek-moe-16b", "llama4-maverick-400b-a17b",
]
DTYPES = ["bfloat16", "float32"]
B, S, STEPS = 4, 16, 8


def lm_configs(arch: str, dtype: str):
    """(reference, port) smoke configs of ``arch`` in ``dtype``."""
    return tuple(dataclasses.replace(m.get_smoke_config(arch), dtype=dtype)
                 for m in (ref_configs, port_configs))


@functools.lru_cache(maxsize=None)
def lm_params(arch: str, dtype: str):
    """The reference's ``init`` (key 0) and the port's copy of it."""
    rcfg, pcfg = lm_configs(arch, dtype)
    ref = jax.jit(lambda key: rtfm.init(rcfg, key))(jax.random.key(0))   # one compile, not one per op
    port = ptfm.transformer_params_from_numpy(pcfg, jax.tree.map(np.asarray, ref), device="cpu")
    return ref, port


def flat(tree, prefix="") -> dict:
    """path → leaf of a nested dict."""
    out = {}
    for key, leaf in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(flat(leaf, path) if isinstance(leaf, dict) else {path: leaf})
    return out


def _specs(tree) -> dict:
    """path → (shape, dtype name) of a nested dict of arrays, tensors or
    ShapeDtypeStructs."""
    return {path: (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
            for path, leaf in flat(tree).items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    rcfg, pcfg = lm_configs(arch, dtype)
    rp, pp = lm_params(arch, dtype)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    feed = rng.integers(0, rcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    cache_len = S + STEPS
    ref_calls, port_calls, ref_out, port_out = [], [], [], []
    with record_reference(ref_calls):
        pre = jax.jit(lambda p, t: rtfm.prefill(rcfg, p, t, cache_len=cache_len))
        dec = jax.jit(lambda p, t, c, pos: rtfm.decode_step(rcfg, p, t, c, pos))
        logits, caches = pre(rp, jnp.asarray(prompt))
        ref_out.append((logits, jax.tree.map(np.asarray, caches)))
        for i in range(STEPS):
            logits, caches = dec(rp, jnp.asarray(feed[i]), caches, jnp.int32(S + i))
            ref_out.append((logits, jax.tree.map(np.asarray, caches)))
        jax.effects_barrier()
    with record_port(port_calls):
        logits, caches = ptfm.prefill(pcfg, pp, torch.as_tensor(prompt), cache_len)
        port_out.append((logits, {n: {k: t.clone() for k, t in c.items()} for n, c in caches.items()}))
        for i in range(STEPS):
            logits, new = ptfm.decode_step(pcfg, pp, torch.as_tensor(feed[i]), caches, S + i)
            assert all(new[n][k] is caches[n][k] for n in caches for k in "kv")   # in place
            port_out.append((logits, {n: {k: t.clone() for k, t in c.items()} for n, c in new.items()}))

    n_moe = pcfg.n_moe_layers
    aside, errs = set(), [0.0, 0.0]
    for step, ((lr, cr), (lp, cp)) in enumerate(zip(ref_out, port_out)):
        set_aside(ref_calls, port_calls, B, aside, 0, (step + 1) * n_moe)
        rows = [b for b in range(B) if b not in aside]
        assert lp.dtype == torch.float32 and lp.shape == (B, rcfg.vocab_size)
        errs[0] = max(errs[0], hold(lp, lr, rows, dtype, f"logits step {step}"))
        errs[1] = max(errs[1], hold_caches(cp, cr, rows, dtype, f"step {step}"))
    print(f"{arch} {dtype}: max |Δ| logits {errs[0]:.3g}, caches {errs[1]:.3g}; "
          f"{len(aside)} of {B} sequences re-routed at a near tie")
    assert len(aside) < B


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_converter_round_trips_bf16_bit_for_bit(arch):
    rcfg, pcfg = lm_configs(arch, "bfloat16")
    rp, pp = lm_params(arch, "bfloat16")
    ref_flat = {path: np.asarray(leaf) for path, leaf in flat(rp).items()}
    assert set(pp) == set(ref_flat)
    back = flat(ptfm.transformer_params_to_numpy(pcfg, pp))
    for path, want in ref_flat.items():
        assert pp[path].dtype == (torch.float32 if want.dtype == np.float32 else torch.bfloat16)
        got = back[path]
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=path)
    # The router is drawn in the model's dtype and kept in float32.
    if rcfg.is_moe:
        assert pp["moe_stack/moe/router"].dtype == torch.float32
    with pytest.raises(ValueError, match="paths"):
        bad = dict(rp)
        bad.pop("final_norm")
        ptfm.transformer_params_from_numpy(pcfg, bad, device="cpu")
    with pytest.raises(ValueError, match="embed"):
        bad = dict(jax.tree.map(np.asarray, rp))
        bad["embed"] = bad["embed"].astype(np.float32)
        ptfm.transformer_params_from_numpy(pcfg, bad, device="cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_config_shapes_match_reference_eval_shape(arch):
    rcfg, pcfg = ref_configs.get_config(arch), port_configs.get_config(arch)
    abstract = ptfm.abstract_params(pcfg)
    assert all(t.device.type == "meta" for t in abstract.values())
    assert _specs(abstract) == _specs(rtfm.abstract_params(rcfg))
    logical = flat(rtfm.param_logical(rcfg))
    assert ptfm.param_logical(pcfg) == logical
    for shape in rcfg.shapes:
        pshape = ShapeSpec(**dataclasses.asdict(shape))
        rcell, pcell = ref_make_cell(rcfg, shape), make_cell(pcfg, pshape)
        if shape.kind == "train":
            # The whole TrainState, optimizer state included.
            state_specs = lambda st: {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                                      for k, v in tree_items(st)}
            assert state_specs(pcell.abstract_state()) == state_specs(rcell.abstract_state())
            assert pcell.state_logical().params == logical
        else:
            assert _specs(pcell.abstract_state()) == _specs(rcell.abstract_state())
            assert pcell.state_logical() == logical
        assert _specs(pcell.input_specs()) == _specs(rcell.input_specs())
        assert flat(pcell.input_logical()) == flat(rcell.input_logical())


def test_launch_serve_qwen3_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen3-4b", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 8) tokens" in out


def test_lm_entry_points_default_to_the_card():
    """No device means the card: without one, init, the converter, the
    caches and the cells' init raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real here")
    _, pcfg = lm_configs("qwen3-4b", "bfloat16")
    rp, _ = lm_params("qwen3-4b", "bfloat16")
    cell = make_cell(pcfg, ShapeSpec("d", "decode", seq_len=8, global_batch=1))
    for call in (lambda: ptfm.init(pcfg, 0),
                 lambda: ptfm.transformer_params_from_numpy(pcfg, jax.tree.map(np.asarray, rp)),
                 lambda: ptfm.make_decode_caches(pcfg, 1, 8),
                 lambda: cell.init_state(0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
