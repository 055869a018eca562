"""The serving cells on a ``(data, model)`` mesh, in ``gloo`` processes:
RecSys tables split by rows with the queries over ``"batch"`` and the
candidates over ``"cands"``, the LM's prefill and decode with the caches'
sequence over ``"model"``, and the forest's queries over ``"batch"``.

Every case places its state by ``remesh`` under ``single_pod_rules``, runs
the cell's step under the rules on the mesh, and holds the gathered output
to the same step in one process (no rules, plain tensors), on every rank:

- the four RecSys families' ``serve_p99`` (16 requests) and
  ``retrieval_cand`` (2,000 candidates, padded to 2,048) on meshes (2, 2)
  and (1, 4), within 1e-6 of the output's max (a bag whose ids lie on
  several ranks adds its rows in another order, ROADMAP C17);
- Qwen3-4B and DeepSeek-MoE-16B (float32 smoke) prefill of 4 × 10 tokens
  then three decode steps at positions 10, 11 and 12 in a cache of 24, on
  meshes (2, 2) and (1, 2): the caches' sequence splits 12 / 12 over
  "model", so the steps cross from the first rank's slice to the second's.
  Logits and caches within ``F32_TOL`` (``tests/lm_parity.py``: the
  merged softmax adds in another order), the decode steps once on plain
  caches (cut by the step, gathered back) and once on caches placed by
  ``remesh`` (each rank holds its shard only);
- lear-msn1 ``rank_online`` on (2, 1): an odd Q of 3, which stays whole on
  both ranks, and a Q of 4, split; scores within 1e-6, continue masks and
  forest launches equal;
- on the (1, 1) mesh one case of each family bit-equal;
- a planted fault: the decode's partial softmaxes summed without the
  rescale to the ranks' maximum must miss the LM tolerance;
- A13's second half: a DLRM state trained one step on (1, 2), tables by
  rows, served where it lies, equals the same state gathered whole and
  served in one process.

One case per family is also held to the JAX reference's one-program
``cell.step`` on the CPU: DLRM-RM2's retrieval (1e-5, the RecSys tests'
tolerance) and Qwen3-4B's prefill and decode (``F32_TOL``), weights from
the reference's init carried by ``recsys_params_from_numpy`` /
``transformer_params_from_numpy``, and the forest's (1e-5 but documents
within 1e-5 of the threshold, ROADMAP C2).
"""

import dataclasses
import json
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import gloo_ranks  # noqa: E402
from lm_parity import F32_TOL  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models import transformer as rtfm  # noqa: E402
from repro.models.api import make_cell as ref_make_cell  # noqa: E402

_RANK_PROG = r"""
import contextlib, dataclasses, json, sys
import numpy as np, torch
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding_rules, single_pod_rules
from repro_torch.kernels import ops
from repro_torch.launch.mesh import join_ranks
from repro_torch.models import transformer
from repro_torch.models.api import make_cell
from repro_torch.models.synth import as_tensors, synthesize_inputs
from repro_torch.train import remesh
from repro_torch.train.trainer import serve_input_logical
from gloo_ranks import digest

port, rank, world, path, shape = sys.argv[1:]
rank, world = int(rank), int(world)
join_ranks("127.0.0.1", int(port), rank, world)
dims = tuple(int(n) for n in shape.split("x"))
mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
rules = single_pod_rules()
LM_B, LM_P, LM_T, LM_STEPS = 4, 10, 24, 3


def rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def ruled(on):
    return sharding_rules(rules, mesh) if on else contextlib.nullcontext()


def params_of(name, cell):
    try:
        flat = dict(np.load(f"{path}/{name}/params.npz"))
    except FileNotFoundError:
        return cell.init_state(0, "cpu")
    return {k: torch.tensor(v) for k, v in flat.items()}


def save(name, **arrays):
    if rank == 0:
        np.savez(f"{path}/{name}/out.npz", **{k: v.numpy() for k, v in arrays.items()})


def recsys(name, arch, cell_shape):
    cell = make_cell(get_smoke_config(arch), ShapeSpec(name="t", **cell_shape))
    params = params_of(name, cell)
    inputs = as_tensors(synthesize_inputs(cell, seed=5), "cpu")
    placed = remesh(params, cell.state_logical(), rules, mesh, src_data_rank=None)
    with ruled(True):
        got = cell.step(placed, inputs)
    want = cell.step(params, inputs)
    save(name, scores=got)
    return {"rel": rel(got, want), "equal": torch.equal(got, want), "shape": list(got.shape),
            "digest": digest([got])}


def lm_run(pre, dec, params, prompt, nxt, on, placed_caches=False):
    with ruled(on):
        logits, caches = pre.step(params, {"tokens": prompt})
    caches = {n: {kv: F.pad(t, (0, 0, 0, 0, 0, LM_T - LM_P)) for kv, t in c.items()}
              for n, c in caches.items()}
    if placed_caches:
        lg = serve_input_logical(dec.input_logical())["caches"]
        caches = remesh(caches, lg, rules, mesh, src_data_rank=None)
    outs = [logits]
    for i in range(LM_STEPS):
        with ruled(on):
            logits, caches = dec.step(params, {"token": nxt[i], "caches": caches,
                                               "pos": torch.tensor(LM_P + i)})
        outs.append(logits)
    return outs, {f"{n}/{kv}": whole(t) for n, c in caches.items() for kv, t in c.items()}


def lm(name, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    pre = make_cell(cfg, ShapeSpec(name="p", kind="prefill", seq_len=LM_P, global_batch=LM_B))
    dec = make_cell(cfg, ShapeSpec(name="d", kind="decode", seq_len=LM_T, global_batch=LM_B))
    params = params_of(name, pre)
    rng = np.random.default_rng(5)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_B, LM_P)).astype(np.int32))
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_STEPS, LM_B, 1)).astype(np.int32))
    want, want_c = lm_run(pre, dec, params, prompt, nxt, False)
    placed = remesh(params, pre.state_logical(), rules, mesh)
    got, got_c = lm_run(pre, dec, placed, prompt, nxt, True)
    out = {"rel": max(rel(a, b) for a, b in zip(got, want)),
           "equal": all(torch.equal(a, b) for a, b in zip(got, want))
           and all(torch.equal(got_c[k], want_c[k]) for k in want_c),
           "cache_rel": max(rel(got_c[k], want_c[k]) for k in want_c),
           "digest": digest(got)}
    if name.endswith("planted"):
        return out
    again, again_c = lm_run(pre, dec, placed, prompt, nxt, True, placed_caches=True)
    out["placed_rel"] = max(rel(a, b) for a, b in zip(again, want))
    out["placed_cache_rel"] = max(rel(again_c[k], want_c[k]) for k in want_c)
    save(name, **{f"logits{i}": t for i, t in enumerate(got)})
    return out


def forest(name, cell_shape, seed):
    cell = make_cell(get_smoke_config("lear-msn1"), ShapeSpec(name="t", **cell_shape))
    params = cell.init_state(seed, "cpu")
    inputs = as_tensors(synthesize_inputs(cell, seed=5), "cpu")
    placed = remesh(params, cell.state_logical(), rules, mesh, src_data_rank=None)
    ops.reset_launch_counts()
    with ruled(True):
        scores, cont = cell.step(placed, inputs)
        cell.step(placed, inputs)   # a second step reuses the first's local trees
    launches = dict(ops.launch_counts())
    ops.reset_launch_counts()
    want, want_cont = cell.step(params, inputs)
    cell.step(params, inputs)
    save(name, scores=scores, cont=cont)
    return {"rel": rel(scores, want), "equal": torch.equal(scores, want),
            "cont_equal": torch.equal(cont, want_cont), "launches": launches,
            "one_launches": dict(ops.launch_counts()), "digest": digest([scores, cont])}


def train_then_serve(name):
    cfg = get_smoke_config("dlrm-rm2")
    train = make_cell(cfg, ShapeSpec(name="t", kind="train", batch=16))
    batch = as_tensors(synthesize_inputs(train, seed=5), "cpu")
    placed = remesh(train.init_state(0, "cpu"), train.state_logical(), rules, mesh,
                    src_data_rank=None)
    with ruled(True):
        new, _ = train.step(placed, batch)
    gathered = {k: whole(v) for k, v in new.params.items()}
    out = {"rows": [list(v.to_local().shape) for k, v in new.params.items()
                    if k.startswith("tables/")][:1]}
    for serve_shape in (dict(kind="serve", batch=16),
                        dict(kind="serve", batch=1, n_candidates=2000)):
        serve = make_cell(cfg, ShapeSpec(name="s", **serve_shape))
        inputs = as_tensors(synthesize_inputs(serve, seed=6), "cpu")
        with ruled(True):
            got = serve.step(new.params, inputs)
        want = serve.step(gathered, inputs)
        key = "retrieval" if "n_candidates" in serve_shape else "serve"
        out[key] = rel(got, want)
    return out


for name, spec in json.load(open(f"{path}/{shape}.json")).items():
    kind = spec["kind"]
    if kind == "recsys":
        out = recsys(name, spec["arch"], spec["shape"])
    elif kind == "lm":
        if name.endswith("planted"):
            # The partials summed without the rescale to the ranks' maximum.
            transformer.merge_softmax = (
                lambda top, total, acc, axis: axis.reduce(acc) / axis.reduce(total)[..., None])
        out = lm(name, spec["arch"])
    elif kind == "forest":
        out = forest(name, spec["shape"], spec["seed"])
    else:
        out = train_then_serve(name)
    with open(f"{path}/{name}/{shape}.{rank}.json", "w") as f:
        json.dump({"rank": rank, **out}, f)
"""

RECSYS = ("dlrm-rm2", "deepfm", "din", "bert4rec")
SERVE = dict(kind="serve", batch=16)
RETRIEVAL = dict(kind="serve", batch=1, n_candidates=2000)
RECSYS_SHAPES = {"serve_p99": SERVE, "retrieval_cand": RETRIEVAL}
LM = ("qwen3-4b", "deepseek-moe-16b")
RECSYS_TOL = 1e-6
FOREST_TOL = 1e-6
# The JAX reference's one-program step against the sharded output.
REF_RECSYS_TOL = dict(rtol=1e-5, atol=1e-5)
REF_CASES = ("dlrm-rm2 retrieval_cand 2x2", "qwen3-4b 2x2", "lear-msn1 Q=4 2x1")

CASES = {}   # name -> (mesh, spec)
for mesh in ("2x2", "1x4"):
    for arch in RECSYS:
        for sname, sshape in RECSYS_SHAPES.items():
            CASES[f"{arch} {sname} {mesh}"] = (mesh, dict(kind="recsys", arch=arch, shape=sshape))
for mesh in ("2x2", "1x2"):
    for arch in LM:
        CASES[f"{arch} {mesh}"] = (mesh, dict(kind="lm", arch=arch))
CASES["qwen3-4b 1x2 planted"] = ("1x2", dict(kind="lm", arch="qwen3-4b"))
for q in (3, 4):
    CASES[f"lear-msn1 Q={q} 2x1"] = ("2x1", dict(kind="forest", shape=dict(kind="serve", batch=q)))
CASES["dlrm-rm2 trained then served 1x2"] = ("1x2", dict(kind="train_serve"))
ONE_RANK = {
    "dlrm-rm2 serve_p99 1x1": dict(kind="recsys", arch="dlrm-rm2", shape=SERVE),
    "deepfm retrieval_cand 1x1": dict(kind="recsys", arch="deepfm", shape=RETRIEVAL),
    "din retrieval_cand 1x1": dict(kind="recsys", arch="din", shape=RETRIEVAL),
    "bert4rec retrieval_cand 1x1": dict(kind="recsys", arch="bert4rec", shape=RETRIEVAL),
    "qwen3-4b 1x1": dict(kind="lm", arch="qwen3-4b"),
    "deepseek-moe-16b 1x1": dict(kind="lm", arch="deepseek-moe-16b"),
    "lear-msn1 Q=4 1x1": dict(kind="forest", shape=dict(kind="serve", batch=4)),
}
CASES.update({name: ("1x1", spec) for name, spec in ONE_RANK.items()})


def _world(mesh: str) -> int:
    return math.prod(int(n) for n in mesh.split("x"))


def FOREST_KEY():
    """The reference's key of the forest case."""
    return jax.random.key(11)


def _forest_seed() -> int:
    """The seed the reference's forest init derives from :func:`FOREST_KEY`."""
    return int(jax.random.randint(FOREST_KEY(), (), 0, 2**31 - 1))


def _reference_params(name: str):
    """(the reference's params, the port's flat copy as numpy) for the
    RecSys and LM reference cases."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.recsys import recsys_params_from_numpy
    from repro_torch.models.transformer import transformer_params_from_numpy

    if name.startswith("dlrm"):
        rcfg = ref_configs.get_smoke_config("dlrm-rm2")
        ref_cell = ref_make_cell(rcfg, ref_configs.base.ShapeSpec(name="r", **RETRIEVAL))
        ref = jax.jit(ref_cell.init_state)(jax.random.key(0))
        port = recsys_params_from_numpy(get_smoke_config("dlrm-rm2"),
                                        jax.tree.map(np.asarray, ref), "cpu")
    else:
        rcfg = dataclasses.replace(ref_configs.get_smoke_config("qwen3-4b"), dtype="float32")
        pcfg = dataclasses.replace(get_smoke_config("qwen3-4b"), dtype="float32")
        ref = jax.jit(lambda key: rtfm.init(rcfg, key))(jax.random.key(0))
        port = transformer_params_from_numpy(pcfg, jax.tree.map(np.asarray, ref), "cpu")
    return ref, {k: v.numpy() for k, v in port.items()}


def _reference_outputs(name: str, ref) -> dict:
    """The JAX reference's one-program outputs of a reference case."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.api import make_cell
    from repro_torch.models.synth import synthesize_inputs

    if name.startswith("dlrm"):
        shape = ref_configs.base.ShapeSpec(name="r", **RETRIEVAL)
        ref_cell = ref_make_cell(ref_configs.get_smoke_config("dlrm-rm2"), shape)
        from repro_torch.configs import get_smoke_config

        cell = make_cell(get_smoke_config("dlrm-rm2"), ShapeSpec(name="r", **RETRIEVAL))
        inputs = synthesize_inputs(cell, seed=5)
        return {"scores": np.asarray(jax.jit(ref_cell.step)(ref, inputs))}
    if name.startswith("qwen"):
        rcfg = dataclasses.replace(ref_configs.get_smoke_config("qwen3-4b"), dtype="float32")
        B, P, T, steps = 4, 10, 24, 3
        pre = ref_make_cell(rcfg, ref_configs.base.ShapeSpec(name="p", kind="prefill",
                                                             seq_len=P, global_batch=B))
        dec = ref_make_cell(rcfg, ref_configs.base.ShapeSpec(name="d", kind="decode",
                                                             seq_len=T, global_batch=B))
        rng = np.random.default_rng(5)
        prompt = rng.integers(0, rcfg.vocab_size, (B, P)).astype(np.int32)
        nxt = rng.integers(0, rcfg.vocab_size, (steps, B, 1)).astype(np.int32)
        logits, caches = jax.jit(pre.step)(ref, {"tokens": jnp.asarray(prompt)})
        caches = jax.tree.map(lambda t: jnp.pad(t, ((0, 0), (0, 0), (0, T - P), (0, 0), (0, 0))),
                              caches)
        out = {"logits0": np.asarray(logits)}
        step = jax.jit(dec.step)
        for i in range(steps):
            logits, caches = step(ref, {"token": jnp.asarray(nxt[i]), "caches": caches,
                                        "pos": jnp.asarray(P + i, jnp.int32)})
            out[f"logits{i + 1}"] = np.asarray(logits)
        return out
    # The forest: the port's init at the seed the reference derives from
    # its key is the reference's.
    from repro_torch.configs import get_smoke_config

    shape = ref_configs.base.ShapeSpec(name="q", kind="serve", batch=4)
    ref_cell = ref_make_cell(ref_configs.get_smoke_config("lear-msn1"), shape)
    params = ref_cell.init_state(FOREST_KEY())
    cell = make_cell(get_smoke_config("lear-msn1"), ShapeSpec(name="q", kind="serve", batch=4))
    inputs = synthesize_inputs(cell, seed=5)
    scores, cont = jax.jit(ref_cell.step)(params, inputs)
    return {"scores": np.asarray(scores), "cont": np.asarray(cont), "X": inputs["X"],
            "mask": inputs["mask"]}


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """Per case: the ranks' reports (and the reference's outputs for
    :data:`REF_CASES`). The ranks run while the reference compiles."""
    path = tmp_path_factory.mktemp("serve")
    refs = {}
    for name in CASES:
        (path / name).mkdir()
    for name in REF_CASES[:2]:
        refs[name], port = _reference_params(name)
        np.savez(path / name / "params.npz", **port)
    procs = []
    seed = _forest_seed()
    for mesh in ("2x2", "1x4", "1x2", "2x1", "1x1"):
        with open(path / f"{mesh}.json", "w") as f:
            json.dump({n: dict(spec, seed=seed) for n, (m, spec) in CASES.items() if m == mesh},
                      f)
        procs.append(gloo_ranks.start(_RANK_PROG, _world(mesh), str(path), mesh))
    try:
        want = {name: _reference_outputs(name, refs.get(name)) for name in REF_CASES}
    finally:
        for p in procs:
            gloo_ranks.join(p)
    runs = {name: [json.load(open(path / name / f"{mesh}.{r}.json"))
                   for r in range(_world(mesh))]
            for name, (mesh, _) in CASES.items()}
    got = {name: dict(np.load(path / name / "out.npz")) for name in REF_CASES}
    return runs, want, got


def _same_on_every_rank(ranks: list) -> dict:
    r0 = ranks[0]
    assert all(r["digest"] == r0["digest"] for r in ranks), [r["digest"] for r in ranks]
    return r0


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("shape", list(RECSYS_SHAPES))
@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_serving_on_a_mesh(arch, shape, mesh, serve_runs):
    """Tables split by rows over "model"; requests over "batch" (whole on
    (1, 4)); candidates over "data" × "model", each rank's looked up
    through the "model" ranks' rows and scored by its owner. The gathered
    scores equal one process's on every rank."""
    r0 = _same_on_every_rank(serve_runs[0][f"{arch} {shape} {mesh}"])
    want = [16] if shape == "serve_p99" else [2048]
    assert r0["shape"] == want, r0
    assert r0["rel"] <= RECSYS_TOL, r0


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
@pytest.mark.parametrize("arch", LM)
def test_lm_prefill_and_decode_with_the_cache_sequence_over_model(arch, mesh, serve_runs):
    """Prefill tensor parallel, the caches' sequence split over "model";
    three decode steps across the ranks' slice boundary with the merged
    softmax, on caches cut by the step and on caches placed by remesh."""
    r0 = _same_on_every_rank(serve_runs[0][f"{arch} {mesh}"])
    for key in ("rel", "cache_rel", "placed_rel", "placed_cache_rel"):
        assert r0[key] <= F32_TOL, (key, r0)


def test_a_decode_without_the_max_rescale_fails(serve_runs):
    """The planted fault: each rank's exp-sums and weighted values summed
    as they are, each from its own maximum. The logits miss the tolerance
    the sound merge holds."""
    sound = serve_runs[0]["qwen3-4b 1x2"][0]
    planted = serve_runs[0]["qwen3-4b 1x2 planted"][0]
    assert sound["rel"] <= F32_TOL, sound
    assert planted["rel"] > 100 * F32_TOL, planted


@pytest.mark.parametrize("q", [3, 4])
def test_forest_rank_online_over_batch(q, serve_runs):
    """Q = 3 does not split over two "data" ranks and stays whole on both;
    Q = 4 splits 2 / 2. Scores within 1e-6 and continue masks equal; each
    rank launches what the unplaced step launches (three a step)."""
    r0 = _same_on_every_rank(serve_runs[0][f"lear-msn1 Q={q} 2x1"])
    assert r0["rel"] <= FOREST_TOL and r0["cont_equal"], r0
    assert r0["launches"] == r0["one_launches"] and r0["launches"]["plain"] == 6, r0


@pytest.mark.parametrize("name", list(ONE_RANK))
def test_one_rank_mesh_is_bit_equal(name, serve_runs):
    r0 = serve_runs[0][name][0]
    assert r0["equal"], r0


def test_a_state_trained_on_the_mesh_serves_where_it_lies(serve_runs):
    """A13: one DLRM train step on (1, 2) with its tables by rows, then its
    placed state serves ``serve_p99`` and ``retrieval_cand`` directly; the
    same state gathered whole and served in one process gives the same
    scores."""
    for r in serve_runs[0]["dlrm-rm2 trained then served 1x2"]:
        assert r["serve"] <= RECSYS_TOL and r["retrieval"] <= RECSYS_TOL, r
        assert r["rows"][0][0] * 2 >= 512, r   # half of a padded table's rows


def test_sharded_outputs_equal_the_reference(serve_runs):
    """The sharded outputs against the JAX reference's one-program step."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.api import forest_head, make_cell

    _, want, got = serve_runs
    name = REF_CASES[0]
    np.testing.assert_allclose(got[name]["scores"], want[name]["scores"], **REF_RECSYS_TOL)
    name = REF_CASES[1]
    for i in range(4):
        np.testing.assert_allclose(got[name][f"logits{i}"], want[name][f"logits{i}"],
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=f"logits{i}")
    name = REF_CASES[2]
    cfg = get_smoke_config("lear-msn1")
    cell = make_cell(cfg, ShapeSpec(name="q", kind="serve", batch=4))
    params = cell.init_state(_forest_seed(), "cpu")
    mask = torch.as_tensor(want[name]["mask"])
    _, _, prob = forest_head(cfg, params, torch.as_tensor(want[name]["X"]), mask)
    ok = ~(mask & ((prob - params["threshold"]).abs() <= 1e-5)).numpy()
    np.testing.assert_array_equal(got[name]["cont"][ok], want[name]["cont"][ok])
    if ok.all() or cfg.capacity_frac <= 0:
        np.testing.assert_allclose(got[name]["scores"][ok], want[name]["scores"][ok],
                                   rtol=1e-5, atol=1e-5)


def test_serve_input_logical_keeps_the_serving_axes():
    from repro_torch.train.trainer import serve_input_logical

    got = serve_input_logical({
        "X": ("batch", None, None), "cand_ids": ("cands",), "dense": (None, "dense"),
        "caches": {"s": {"k": (None, "batch", "kv_seq", None, None)}}, "pos": (),
        "positions": ("nodes", None),
    })
    assert got == {"X": ("batch", None, None), "cand_ids": ("cands",), "dense": (None, None),
                   "caches": {"s": {"k": (None, "batch", "kv_seq", None, None)}}, "pos": (),
                   "positions": (None, None)}
