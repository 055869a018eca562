"""The port's examples run end to end on the CPU at smoke size.

Each ``examples/torch_*.py`` runs as ``--smoke --device cpu`` in a
subprocess (``PYTHONPATH=src``), as ``tests/test_docs.py`` runs the
reference's ``serve_progressive.py``, and must exit 0 and print the lines
its original prints.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# example -> lines (prefixes) its output must hold
EXPECT = {
    "torch_quickstart.py": ("training λ-MART", "Full ensemble: NDCG@10 =",
                            "LEAR(threshold=0.1): NDCG@10 =", "LEAR(threshold=0.7): NDCG@10 ="),
    "torch_serve_ranking.py": ("service stats after 3 batches:", "  continue rate  :",
                               "  overflow docs  : 0", "  speedup (trees):",
                               "  NDCG@10 (mean) :", "  batcher cursor :"),
    "torch_serve_progressive.py": ("calibrated launch_overhead_trees",
                                   "  batch 0: picked=", "stats after 4 batches",
                                   "  speedup (trees):"),
    "torch_cascade_retrieval.py": ("keep=1%: sentinel+full over 100 survivors",
                                   "keep=5%: sentinel+full over 500 survivors",
                                   "keep=20%: sentinel+full over 2000 survivors"),
    "torch_train_lm.py": ("model: demo-smoke", "step   20  loss",
                          "checkpoint → step_0000000040.npz", "first-20 mean loss",
                          "restored step 40 into a new state: equal to the trained one True"),
}


def test_every_port_example_is_covered():
    found = {f for f in os.listdir(os.path.join(ROOT, "examples")) if f.startswith("torch_")}
    assert found == set(EXPECT), found


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_example_runs_at_smoke_size_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), "--smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    for want in EXPECT[name]:
        assert any(line.startswith(want) for line in lines), (want, proc.stdout[-3000:])
