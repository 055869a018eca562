"""The port's LM generation and serving cells against the JAX reference,
on the CPU.

For all five LM smoke configs (the reference's own ``init``, carried
across by the converter; ``tests/test_torch_lm.py``'s fixtures):
``generate``'s greedy tokens over 8 steps, as shipped (bfloat16) and in
float32, and the prefill and decode cells on ``synthesize_inputs``
(bfloat16). Tolerances and the routing rule: ``tests/lm_parity.py``.
Greedy tokens must be equal up to a sequence's first step whose two
candidate tokens' logits lie within the logit tolerance of each other
(the top-2-gap rule); a sequence re-routed at a near tie is set aside.
Every exception is counted and printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lm_parity import (  # noqa: E402
    BF16_LOGIT_TOL,
    F32_TOL,
    hold,
    hold_caches,
    record_port,
    record_reference,
    set_aside,
)
from repro.configs.base import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.models.api import make_cell as ref_make_cell  # noqa: E402
from repro.models.synth import synthesize_inputs as ref_synth  # noqa: E402
from repro.serve.lm_serve import generate as ref_generate  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.models.api import make_cell  # noqa: E402
from repro_torch.models.synth import as_tensors, synthesize_inputs  # noqa: E402
from repro_torch.serve import lm_serve  # noqa: E402
from test_torch_lm import DTYPES, LM_ARCHS, B, S, STEPS, flat, lm_configs, lm_params  # noqa: E402


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_generate_greedy_tokens_match_reference(arch, dtype, monkeypatch):
    rcfg, pcfg = lm_configs(arch, dtype)
    rp, pp = lm_params(arch, dtype)
    prompt = np.random.default_rng(2).integers(0, rcfg.vocab_size, (B, S)).astype(np.int32)
    ref_calls, port_calls, picked = [], [], []
    with record_reference(ref_calls):
        want = np.asarray(ref_generate(rcfg, rp, jnp.asarray(prompt), n_steps=STEPS))
        jax.effects_barrier()
    real_pick = lm_serve._pick
    monkeypatch.setattr(lm_serve, "_pick",
                        lambda logits, *a: picked.append(logits) or real_pick(logits, *a))
    with record_port(port_calls):
        got = lm_serve.generate(pcfg, pp, torch.as_tensor(prompt), n_steps=STEPS)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    got = got.numpy()

    tol = F32_TOL if dtype == "float32" else BF16_LOGIT_TOL
    n_moe, done, gaps, rerouted = pcfg.n_moe_layers, set(), 0, set()
    for i in range(STEPS):
        # Pick i reads the prefill (i = 0) or decode step i - 1.
        set_aside(ref_calls, port_calls, B, rerouted, i * n_moe, (i + 1) * n_moe, ignore=done)
        done |= rerouted
        for b in sorted(set(range(B)) - done):
            if got[b, i] != want[b, i]:
                lg = picked[i][b]
                gap = float(lg[got[b, i]] - lg[want[b, i]])
                assert 0 <= gap <= tol, (b, i, gap)
                gaps += 1
                done.add(b)
    print(f"{arch} {dtype}: {gaps} sequences left at a top-2 gap within {tol}, "
          f"{len(rerouted)} re-routed at a near tie, of {B}")


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serving_cells_on_synthesized_inputs(arch, kind):
    rcfg, pcfg = lm_configs(arch, "bfloat16")
    spec = dict(name=f"smoke_{kind}", kind=kind, seq_len=32, global_batch=2)
    rcell, pcell = ref_make_cell(rcfg, RefShapeSpec(**spec)), make_cell(pcfg, ShapeSpec(**spec))
    rin, pin = ref_synth(rcell, seed=1), synthesize_inputs(pcell, seed=1)
    # The same draws, bit for bit (a decode cell's bfloat16 caches come out
    # as int32 ids in both packages: see repro_torch.models.synth).
    got_in = flat(pin)
    for path, want in flat(rin).items():
        assert got_in[path].dtype == np.asarray(want).dtype, path
        np.testing.assert_array_equal(got_in[path], np.asarray(want), err_msg=path)
    rp, pp = lm_params(arch, "bfloat16")
    ref_calls, port_calls = [], []
    with record_reference(ref_calls):
        want_logits, want_caches = jax.jit(rcell.step)(rp, rin)
        jax.effects_barrier()
    inputs = as_tensors(pin, "cpu")
    with record_port(port_calls):
        logits, caches = pcell.step(pp, inputs)
    if kind == "decode":
        assert all(caches[n][k] is inputs["caches"][n][k] for n in caches for k in "kv")
    batch = spec["global_batch"]
    aside = set_aside(ref_calls, port_calls, batch, set())
    assert len(aside) < batch
    rows = [b for b in range(batch) if b not in aside]
    hold(logits, want_logits, rows, "bfloat16", "logits cell")
    hold_caches(caches, jax.tree.map(np.asarray, want_caches), rows, "bfloat16", "cell")
