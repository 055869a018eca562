"""The port's analyzer (``repro_torch.analysis``) against the reference's
fixture corpus, rewritten in torch.

Each rule has a dirty and a clean fixture, written inline into
``tmp_path``. A dirty fixture must flag its rule, and only it, as many
times as the reference analyzer flags the reference's fixture of the same
rule (``tests/fixtures/analysis``, run here through ``repro.analysis``).
Then the suppression syntax, the CLI, and the contract that the REAL
``src/repro_torch`` tree is clean: that is what makes the analyzer a gate.

The rewrite: ``@jax.jit`` becomes ``@torch.compile`` (a device-scope root,
as every ``config.DEVICE_ROOT_SUFFIXES`` name is); a Pallas kernel body
becomes a plain kernel version named as in
``config.TREE_SUM_ROOT_SUFFIXES``; ``jax.device_get`` becomes a
``device_get`` defined in the fixture (the transfer primitive).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import run_paths as ref_run_paths  # noqa: E402
from repro_torch.analysis import run_paths  # noqa: E402
from repro_torch.analysis.annotations import check_annotations, target_files  # noqa: E402
from repro_torch.analysis.callgraph import ProjectIndex  # noqa: E402
from repro_torch.analysis.engine import discover  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SRC_PORT = ROOT / "src" / "repro_torch"
REF_FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
ALL_CODES = ("TS001", "TS002", "TS003", "TS004", "TS005", "TS006", "TS007")

FIXTURES = {
    "ts001_dirty": '''
        """TS001: host syncs reachable from a device-scope root."""
        import numpy as np
        import torch


        def helper(x):
            # reached from `step` below: np.asarray reads the tensor to the host
            return np.asarray(x)


        @torch.compile
        def step(x):
            total = torch.sum(x)
            host = float(total)
            ready = total.item()
            return helper(x) + host + ready
    ''',
    "ts001_clean": '''
        """TS001 (clean): shape math, and reads in host code."""
        import numpy as np
        import torch


        @torch.compile
        def step(x, scale: float):
            n = float(x.shape[0])  # a shape is host data
            return torch.sum(x) * scale / n


        def host_summary(batch):
            # never reachable from a device root: host code may read freely
            return float(np.asarray(batch).mean())
    ''',
    "ts002_dirty": '''
        """TS002: Python control flow on tensor values."""
        import torch


        @torch.compile
        def clip_positive(x):
            if x.sum() > 0:
                return x
            while x.any():
                x = x - 1
            return -x
    ''',
    "ts002_clean": '''
        """TS002 (clean): branching on host config, shapes and devices."""
        import torch


        @torch.compile
        def normalize(x, method: str = "l2", eps: float = 1e-6):
            if method == "l2":  # annotated str parameter: host data
                return x / (torch.sqrt(torch.sum(x * x)) + eps)
            if x.shape[0] > 1 and x.is_contiguous():  # host facts of a tensor
                return x / x.shape[0]
            if x.device.type == "cpu":
                return x
            return torch.where(x > 0, x, 0.0)  # data dependence stays in ops
    ''',
    "ts003_dirty": '''
        """TS003: reassociating reductions on the tree-sum path."""
        import torch


        def forest_score_plain(x, leaf_values):
            # a plain kernel version: its tree axis must reduce in the
            # kernel's order
            total = torch.sum(leaf_values, dim=1)  # bare sum over the tree axis
            acc = torch.zeros_like(total)
            for t in range(4):
                acc += leaf_values[:, t]  # += accumulation loop
            return total + acc


        def prefix_residual(per_tree, order):
            # Reorder-path root: reduces the PERMUTED tree axis with a bare sum.
            permuted = per_tree[:, order]
            return permuted.sum(dim=1)
    ''',
    "ts003_clean": '''
        """TS003 (clean): the tree axis reduced through the sanctioned
        pairwise halving."""


        def pairwise_tree_sum(per_tree):
            n = per_tree.shape[-1]
            while n > 1:
                half = n // 2
                per_tree = per_tree[..., :half] + per_tree[..., half:2 * half]
                n = half
            return per_tree[..., 0]


        def forest_score_plain(x, leaf_values):
            return pairwise_tree_sum(leaf_values)


        def prefix_residual(per_tree, order):
            return pairwise_tree_sum(per_tree[:, order])
    ''',
    "ts004_dirty": '''
        """TS004: environment reads inside device scope."""
        import os

        import torch


        @torch.compile
        def scale(x):
            k = int(os.environ.get("SCALE_K", "4"))
            bias = int(os.getenv("BIAS", "0"))
            limit = int(os.environ["LIMIT"])
            return x * k + bias - limit
    ''',
    "ts004_clean": '''
        """TS004 (clean): the environment read once at module scope."""
        import os

        import torch

        SCALE_K = int(os.environ.get("SCALE_K", "4"))


        @torch.compile
        def scale(x):
            return x * SCALE_K
    ''',
    "ts006_dirty": '''
        """TS006: two transfer sites reachable from rank_batch."""


        def device_get(t):
            return t.cpu().numpy()


        class RankingService:
            def rank_batch(self, X, mask):
                out = self._compute(X, mask)
                stats = device_get(out)
                return stats, self._peek(out)

            def _compute(self, X, mask):
                return X

            def _peek(self, out):
                return out.item()  # second transfer on the hot path
    ''',
    "ts006_clean": '''
        """TS006 (clean): one packed device_get fetches everything."""
        import torch


        def device_get(t):
            return t.cpu().numpy()


        class RankingService:
            def rank_batch(self, X, mask):
                top, scores, stats = self._compute(X, mask)
                return device_get(torch.cat([top, scores, stats]))

            def _compute(self, X, mask):
                return X, X, mask
    ''',
    "suppressed": '''
        """Suppression: both noqa placements silence a real finding."""
        import numpy as np
        import torch


        @torch.compile
        def step(x):
            return np.asarray(x)  # repro: noqa(TS001) -- fixture: deliberate waiver


        @torch.compile
        def step2(x):
            # repro: noqa(TS001, TS002) -- fixture: comment-line waiver applies
            # to the next code line (multi-line justifications welcome)
            return np.asarray(x)
    ''',
    # The syncs eager PyTorch makes inside ATen, and the reads the reference
    # has no counterpart of. Not a reference fixture: counted on its own.
    "ts001_aten_dirty": '''
        """TS001: syncs inside ATen and torch-only reads, in device scope."""
        import torch


        def device_get(t):
            return t.cpu().numpy()


        @torch.compile
        def step(x, mask, counts):
            a = torch.nonzero(mask)
            b = x.masked_select(mask)
            c = torch.unique(x)
            d = torch.repeat_interleave(x, counts)
            e = torch.where(mask)
            f = x.cpu()
            g = x.to("cpu")
            h = x.tolist()
            torch.cuda.synchronize()
            i = device_get(x)
            j = int(x.sum())
            return a, b, c, d, e, f, g, h, i, j
    ''',
    "ts001_aten_clean": '''
        """TS001 (clean): the same ops in their sync-free forms."""
        import numpy as np
        import torch


        @torch.compile
        def step(x, mask, counts, n: int):
            d = torch.repeat_interleave(x, counts, output_size=n)
            e = torch.where(mask, x, 0.0)
            f = x.to(x.device, non_blocking=True)
            g = np.unique(np.arange(n))  # numpy on host data
            return d, e, f, g, int(x.shape[0])
    ''',
}
# TS005 and TS007 fixtures are the reference's, verbatim: they import
# nothing of JAX.
for _code in ("ts005", "ts007"):
    for _kind in ("dirty", "clean"):
        FIXTURES[f"{_code}_{_kind}"] = (REF_FIXTURES / f"{_code}_{_kind}.py").read_text()

ATEN_DIRTY_COUNT = 11  # one per line of ts001_aten_dirty's body but the return


@pytest.fixture
def fixtures(tmp_path: Path) -> Path:
    for name, text in FIXTURES.items():
        (tmp_path / f"{name}.py").write_text(textwrap.dedent(text).lstrip())
    return tmp_path


def _codes(path: Path) -> set[str]:
    return {f.code for f in run_paths([path])}


@pytest.mark.parametrize("code", ALL_CODES)
def test_dirty_fixture_flags_its_rule_and_only_it(fixtures: Path, code: str):
    findings = run_paths([fixtures / f"{code.lower()}_dirty.py"])
    want = ref_run_paths([REF_FIXTURES / f"{code.lower()}_dirty.py"])
    assert {f.code for f in findings} == {code}
    assert len(findings) == len(want), [f.format() for f in findings]
    for f in findings:
        assert f.line > 0
        assert f.hint  # every finding carries its one-line fix
        assert code in f.format()


@pytest.mark.parametrize("code", ALL_CODES)
def test_clean_fixture_is_clean(fixtures: Path, code: str):
    assert _codes(fixtures / f"{code.lower()}_clean.py") == set()


def test_aten_syncs_and_torch_reads_are_flagged(fixtures: Path):
    findings = run_paths([fixtures / "ts001_aten_dirty.py"])
    assert {f.code for f in findings} == {"TS001"}
    assert len(findings) == ATEN_DIRTY_COUNT, [f.format() for f in findings]
    assert _codes(fixtures / "ts001_aten_clean.py") == set()


def test_suppression_comment_silences_findings(fixtures: Path):
    # suppressed.py is TS001-dirty twice over, with both noqa placements
    assert _codes(fixtures / "suppressed.py") == set()


def test_suppression_is_code_specific(fixtures: Path):
    findings = run_paths([fixtures / "ts001_dirty.py"], codes=["TS001"])
    assert findings, "unsuppressed dirty fixture must flag"
    assert run_paths([fixtures / "suppressed.py"], codes=["TS001"]) == []
    # a waiver names its codes: a TS002 waiver does not silence TS001
    text = FIXTURES["suppressed"].replace("noqa(TS001) --", "noqa(TS002) --")
    other = fixtures / "suppressed_other.py"
    other.write_text(textwrap.dedent(text).lstrip())
    assert [f.code for f in run_paths([other])] == ["TS001"]


def test_real_tree_is_clean():
    findings = run_paths([SRC_PORT])
    assert findings == [], "\n".join(f.format() for f in findings)


def test_every_waiver_in_the_port_gives_its_reason():
    # (the analyzer's own package documents the syntax, and is skipped)
    waivers = [
        (path, line)
        for path in SRC_PORT.rglob("*.py")
        if "analysis" not in path.relative_to(SRC_PORT).parts
        for line in path.read_text().splitlines()
        if "repro: noqa(" in line
    ]
    assert waivers, "the port's serving code carries its waivers in the source"
    for path, line in waivers:
        reason = line.split("repro: noqa(", 1)[1].split(")", 1)[1]
        assert reason.strip().startswith("--") and len(reason.strip()) > 10, (path, line)


def test_device_scope_covers_the_serving_step():
    project = ProjectIndex(discover([SRC_PORT]))
    scope = project.device_scope
    for fid in (
        "repro_torch.core.cascade:CascadeRanker.rank_progressive",
        "repro_torch.core.cascade:_staged",
        "repro_torch.core.compaction:compact_indices_cumsum_masked",
        "repro_torch.core.features:augment_features",
        "repro_torch.core.lear:LearClassifier.continue_mask",
        "repro_torch.kernels.forest_score:forest_score_kernel",
        "repro_torch.kernels.forest_score:forest_score_segments_kernel",
        "repro_torch.kernels.forest_score:forest_score_plain",
        "repro_torch.models.dense_scorer:DenseScorer.forward",
        "repro_torch.serve.ranking_service:RankingService._make_strategy.strategy",
    ):
        assert fid in scope, fid
    # the packed read is host code, after the step
    assert "repro_torch.serve.ranking_service:RankingService.rank_batch" not in scope
    assert "repro_torch.utils:device_get" not in scope


def test_rank_batch_reaches_exactly_one_transfer_site(fixtures: Path):
    # Adding a second read to a copy of the real service flags it.
    from repro_torch.analysis.rules import SingleDeviceGetRule

    src = (SRC_PORT / "serve" / "ranking_service.py").read_text()
    marker = "        s = self.stats\n"
    assert marker in src
    pkg = fixtures / "repro_torch"
    for rel in ("serve/ranking_service.py", "utils.py"):
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text((SRC_PORT / rel).read_text())
    assert run_paths([pkg], codes=["TS006"]) == []
    (pkg / "serve" / "ranking_service.py").write_text(
        src.replace(marker, "        mask.sum().item()\n" + marker)
    )
    findings = run_paths([pkg], codes=["TS006"])
    assert [f.code for f in findings] == [SingleDeviceGetRule.code]
    assert "2 of 2" in findings[0].message


def _run_cli(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC_PORT.parent) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", *args], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )


def test_cli_exit_codes_and_json(fixtures: Path):
    dirty = _run_cli("repro_torch.analysis", str(fixtures / "ts001_dirty.py"), "--format", "json")
    assert dirty.returncode == 1
    payload = json.loads(dirty.stdout)
    assert payload and all(f["code"] == "TS001" for f in payload)

    assert _run_cli("repro_torch.analysis", str(fixtures / "ts001_clean.py")).returncode == 0
    # the default target is the port's tree, which is clean
    default = _run_cli("repro_torch.analysis")
    assert default.returncode == 0, default.stdout
    assert "no findings" in default.stdout

    rules = _run_cli("repro_torch.analysis", "--list-rules")
    assert rules.returncode == 0
    for code in ALL_CODES:
        assert code in rules.stdout


def test_select_filters_rules(fixtures: Path):
    assert run_paths([fixtures / "ts001_dirty.py"], codes=["TS004"]) == []
    selected = _run_cli(
        "repro_torch.analysis", str(fixtures / "ts004_dirty.py"), "--select", "TS001,TS002"
    )
    assert selected.returncode == 0


def test_annotation_completeness(fixtures: Path):
    assert check_annotations(target_files(
        [str(ROOT / t) for t in (
            "src/repro_torch/kernels", "src/repro_torch/core", "src/repro_torch/serve",
            "src/repro_torch/metrics", "src/repro_torch/analysis",
            "src/repro_torch/typecheck.py", "src/repro_torch/utils.py",
        )]
    )) == []
    bare = fixtures / "bare.py"
    bare.write_text(
        "def f(x, y: int):\n    def inner(z):\n        return z\n    return inner\n\n\n"
        "def g(x: int) -> int:  # repro: noqa(TYP)\n    return x\n\n\n"
        "class C:\n    def m(self, v) -> None:\n        pass\n"
    )
    problems = check_annotations([bare])
    assert [p.split(": ", 1)[1].split(" ", 1)[0] for p in problems] == [
        "TYP001", "TYP002", "TYP001",
    ]
    cli = _run_cli("repro_torch.analysis.annotations")
    assert cli.returncode == 0 and "OK" in cli.stdout, cli.stdout
    assert _run_cli("repro_torch.analysis.annotations", str(bare)).returncode == 1
