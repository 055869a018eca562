"""The float32 smoke train cases that the port's several-rank tests share
with the reference: the port's parameters (seed 0), the reference's cell
and a batch it draws, and the reference's one-device step on them.

The ranks get the parameters and the batch as numpy files; the reference's
loss is taken here, in the test process.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as ref_configs
from repro.models.api import make_cell as ref_make_cell
from repro.models.synth import synthesize_inputs as ref_synth
from repro.train import trainer as ref_trainer
from repro.train.optimizer import get_optimizer as ref_get_optimizer
from repro_torch import configs as port_configs
from repro_torch.configs import base as port_base
from repro_torch.models.api import make_cell
from repro_torch.models.nequip import nequip_params_to_numpy
from repro_torch.models.recsys import recsys_params_to_numpy
from repro_torch.models.transformer import transformer_params_to_numpy


def bert4rec_mask(kind: str, B: int, S: int, micro: int) -> np.ndarray:
    """BERT4Rec's ``mask_pos``: ``even``, three masked positions in every
    row; ``uneven``, in each microbatch the first half of the rows fully
    masked and the second half one position each."""
    m = np.zeros((B, S), np.float32)
    if kind == "even":
        m[:, [2, 7, 11]] = 1.0
        return m
    for c in range(0, B, micro):
        m[c:c + micro // 2] = 1.0
        m[c + micro // 2:c + micro, S // 2] = 1.0
    return m


def to_reference(cfg, params: dict):
    """The port's parameters as the reference's pytree."""
    if isinstance(cfg, port_base.RecSysConfig):
        return recsys_params_to_numpy(cfg, params)
    if isinstance(cfg, port_base.NequIPConfig):
        return nequip_params_to_numpy(params)
    return transformer_params_to_numpy(cfg, params)


@dataclasses.dataclass
class Case:
    pcfg: object       # the port's config, float32
    params: dict       # the port's parameters, seed 0
    rcfg: object       # the reference's config, float32
    ref_cell: object
    batch: dict        # numpy, drawn by the reference

    def save(self, path) -> None:
        """``params.npz`` and ``batch.npz`` under ``path``."""
        path.mkdir()
        np.savez(path / "params.npz", **{k: v.numpy() for k, v in self.params.items()})
        np.savez(path / "batch.npz", **self.batch)

    def reference_loss(self) -> float:
        """The loss of the reference's jitted one-device step on the same
        parameters and batch."""
        tree = jax.tree.map(jnp.asarray, to_reference(self.pcfg, self.params))
        state = ref_trainer.init_state(tree, ref_get_optimizer(self.rcfg.optimizer))
        return float(jax.jit(self.ref_cell.step)(state, self.batch)[1]["loss"])


def case(arch: str, shape: dict, mask: str | None = None, seed: int = 3) -> Case:
    """A float32 smoke case of ``arch`` at ``shape`` (``ShapeSpec``'s
    fields); ``mask`` sets BERT4Rec's masked positions."""
    pcfg = dataclasses.replace(port_configs.get_smoke_config(arch), dtype="float32")
    params = make_cell(pcfg, port_base.ShapeSpec(name="t", **shape)).init_state(0, "cpu").params
    rcfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype="float32")
    ref_cell = ref_make_cell(rcfg, ref_configs.base.ShapeSpec(name="t", **shape))
    raw = ref_synth(ref_cell, seed=seed)
    if mask:
        B, S = raw["mask_pos"].shape
        raw["mask_pos"] = bert4rec_mask(mask, B, S, shape["microbatch"])
    return Case(pcfg, params, rcfg, ref_cell, raw)
