"""The port stands alone: no JAX and nothing of ``repro`` behind it.

In a fresh interpreter, import every module of ``repro_torch`` (the serving
tier's, the dense scorer's, the distiller's, the training pipeline's —
data, binning, GBDT, λ-MART, LEAR training, reordering — and the model-cell
path's — configs, RecSys, cells, trainer, checkpoints, launchers — and
the LM path's — layers, transformer (serving and training), MoE,
generation — and NequIP's — so3, the model, the neighbor sampler — among
them — and the serving guards': the host-read guard, the shape-checked
lane and the analyzer) and the
``chip_smoke`` script (without running it) and
check that no ``jax*`` or ``repro.*`` module was loaded. The port's
examples (``examples/torch_*.py``) and tools (``tools/torch_*.py``) are
loaded in the same interpreter, and every
``import`` statement in them (inside functions too) names neither JAX nor
``repro``. Without a card, ``chip_smoke.py`` must fail
and print no result, also when it is alone in a directory.
"""

import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from repro_torch.serve import batching, degradation, supervisor, tier, warmup
tier.ServingTier, batching.ContinuousBatcher, warmup.warmup_service
degradation.DegradationController, supervisor.WorkerSupervisor
serving = {"repro_torch.serve." + m for m in (
    "tier", "batching", "warmup", "degradation", "supervisor", "placement",
    "errors", "clock",
)}
assert serving <= set(names), sorted(serving - set(names))
hybrid = {
    "repro_torch.models", "repro_torch.models.dense_scorer",
    "repro_torch.train", "repro_torch.train.optimizer", "repro_torch.train.distill",
}
assert hybrid <= set(names), sorted(hybrid - set(names))
from repro_torch.train import distill_dense_scorer, adamw
training = {"repro_torch." + m for m in (
    "data", "data.synthetic", "forest.binning", "forest.gbdt", "forest.lambdamart",
    "forest.reorder", "metrics.classification", "core.lear",
)}
assert training <= set(names), sorted(training - set(names))
from repro_torch.forest import GBDTParams, train_gbdt, train_lambdamart, reordered_ensemble
from repro_torch.core import train_lear, build_continue_labels, instance_weights
from repro_torch.metrics import precision_recall, trees_traversed
from repro_torch.data import make_letor_dataset
from repro_torch.models import DenseScorer, dense_params_from_numpy
cells = {"repro_torch." + m for m in (
    "configs", "configs.base", "configs.lear_msn1", "configs.dlrm_rm2", "configs.deepfm",
    "configs.din", "configs.bert4rec", "configs.qwen2_5_14b", "configs.minitron_4b",
    "configs.qwen3_4b", "configs.deepseek_moe_16b", "configs.llama4_maverick",
    "configs.nequip", "models.layers", "models.recsys", "models.api", "models.synth",
    "train.trainer", "train.checkpoint", "data.pipeline", "launch", "launch.serve",
    "launch.train",
)}
assert cells <= set(names), sorted(cells - set(names))
from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_smoke_config, list_archs
for arch in list_archs():
    get_config(arch), get_smoke_config(arch)
from repro_torch.models.api import make_cell
from repro_torch.models.recsys import recsys_params_from_numpy, recsys_params_to_numpy
from repro_torch.models.synth import synthesize_inputs
from repro_torch.train import adafactor, adagrad_rowwise, get_optimizer, make_train_step
from repro_torch.train import save_checkpoint, restore_checkpoint, latest_step
from repro_torch.data import QueryBatcher, TokenPipeline
from repro_torch.launch import serve, train
lm = {"repro_torch." + m for m in ("models.transformer", "models.moe", "serve.lm_serve")}
assert lm <= set(names), sorted(lm - set(names))
from repro_torch.models import transformer_params_from_numpy, transformer_params_to_numpy
from repro_torch.models.transformer import init, prefill, decode_step, make_decode_caches
from repro_torch.models.layers import apply_rope, blockwise_attention, decode_attention, glu_mlp
from repro_torch.models.moe import moe_ffn, route
from repro_torch.serve import generate
zoo = {"repro_torch." + m for m in ("models.nequip", "models.so3", "data.graph_sampler")}
assert zoo <= set(names), sorted(zoo - set(names))
from repro_torch.models.transformer import chunked_cross_entropy, loss_fn
from repro_torch.models.nequip import forces, forward_energy, nequip_params_from_numpy
from repro_torch.models.so3 import allowed_paths, clebsch_gordan
from repro_torch.data import CSRGraph, sample_neighbors
guards = {"repro_torch." + m for m in (
    "typecheck", "analysis", "analysis.config", "analysis.callgraph", "analysis.engine",
    "analysis.annotations", "analysis.__main__", "analysis.rules", "analysis.rules.common",
    "analysis.rules.ts001_host_sync", "analysis.rules.ts002_control_flow",
    "analysis.rules.ts003_reassociation", "analysis.rules.ts004_env_reads",
    "analysis.rules.ts005_thread_discipline", "analysis.rules.ts006_single_device_get",
    "analysis.rules.ts007_bounded_serving",
)}
assert guards <= set(names), sorted(guards - set(names))
from repro_torch.utils import TransferCounts, count_host_transfers, device_get
from repro_torch.typecheck import Tensor, shape_checked
from repro_torch.analysis import main, run_paths
from repro_torch.analysis.rules import all_rules
from repro_torch.serve.ranking_service import TwoStageCascade
from repro_torch.serve.placement import auto
from repro_torch.serve.calibration import last_calibration
from repro_torch.core.stage import CascadeStage, DenseScorer
from repro_torch.metrics import ideal_dcg_at_k
assert len(all_rules()) == 7
several = {"repro_torch." + m for m in (
    "distributed", "distributed.sharding", "launch.mesh", "launch.op_analysis",
    "launch.roofline", "launch.dryrun", "launch.reanalyze", "launch.hillclimb",
    "train.elastic", "serve.placement",
)}
assert several <= set(names), sorted(several - set(names))
from repro_torch.distributed import Rules, constrain, sharding_rules, spec_to_placements
from repro_torch.launch.mesh import join_ranks, make_local_mesh, make_production_mesh
from repro_torch.launch.dryrun import all_cells, run_cell
from repro_torch.launch.hillclimb import variants
from repro_torch.launch.op_analysis import analyze, trace
from repro_torch.launch.roofline import lm_model_flops, lm_param_count, roofline
from repro_torch.train import remesh
from repro_torch.train.elastic import validate_divisibility
from repro_torch.serve.placement import data_parallel, local
assert len(list(all_cells())) == 84 and sum(map(len, variants().values())) == 13
import glob, importlib.util, os
scripts = sorted(glob.glob("examples/torch_*.py") + glob.glob("tools/torch_*.py"))
assert len(scripts) >= 7, scripts
for path in scripts:   # loaded as modules: their main() does not run
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith(("jax.", "jaxlib", "jaxtyping", "repro."))
    or m == "repro"
)
print(len(names), leaked)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), ROOT])
    return env


def test_port_imports_no_jax_and_nothing_of_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=_env(), cwd=ROOT, timeout=300, check=True,
    )
    n_modules, leaked = out.stdout.strip().split(" ", 1)
    assert int(n_modules) >= 20, out.stdout
    assert leaked == "[]", leaked


_SCRIPTS = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d in (os.path.join(ROOT, "examples"), os.path.join(ROOT, "tools"))
    for f in os.listdir(d) if f.startswith("torch_") and f.endswith(".py")
) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", _SCRIPTS)
def test_script_imports_name_no_jax_and_nothing_of_repro(path):
    import ast

    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert names, path


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real here")
    runs = [(ROOT, _env())]
    lone = tmp_path / "alone"
    lone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    runs.append((str(lone), {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}))
    for cwd, env in runs:
        out = subprocess.run(
            [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
            env=env, cwd=cwd, timeout=300, check=False,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
