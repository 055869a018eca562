"""Checkpoint/restart: a nested state → flat ``.npz`` + JSON, atomic, keep-N.

The port of :mod:`repro.train.checkpoint`, with the same contract:

- writes are atomic (tmp file + ``os.replace``), so a job killed mid-save
  never corrupts the latest checkpoint;
- the data-pipeline cursor and the step counter are saved WITH the model
  state (``extra``), so restart resumes the exact batch sequence;
- ``keep_last`` bounds disk usage; restore picks the newest complete step.

The keys are the reference's flattened paths (``params/tables/t0``,
``opt_state/acc/bot/0/1``, ``step``; :func:`repro_torch.utils.tree_items`),
so a checkpoint written by either package opens in the other. The file is
``np.savez``'s, written one leaf at a time, and a restore copies each leaf
in place into the template's own tensor (its device and dtype): the host
holds one leaf at a time and the card no second copy of the state, so a
state of most of the card (DLRM-RM2's 45.56 GB of tables) saves and
restores.

A bfloat16 leaf (numpy has none) is written as the reference writes one:
``np.savez`` stores an ``ml_dtypes.bfloat16`` array as the raw 2-byte
pattern under the descriptor ``<V2``, and the port writes the same header
and the same bytes from the tensor's int16 view. A restore reads a 2-byte
void or int16 leaf back into a bfloat16 template bit for bit. (The
reference's own restore casts such a leaf with ``astype`` and raises, so it
cannot reopen its bfloat16 checkpoints; ``ROADMAP.md`` C10.)
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.utils import tree_items, tree_map


def _write_leaf(f, leaf: Any) -> None:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        raw = leaf.detach().cpu().contiguous().view(torch.int16).numpy()
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": raw.shape})
        f.write(memoryview(raw).cast("B"))
        return
    host = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    np.lib.format.write_array(f, host, allow_pickle=False)


def _write_npz(path: str, items) -> list[str]:
    """``np.savez(path, **dict(items))``'s file, with one leaf on the host
    at a time. Returns the keys."""
    keys = []
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, leaf in items:
            with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                _write_leaf(f, leaf)
            keys.append(key)
    return keys


def _as_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A loaded leaf as a tensor to copy into ``like``; a bfloat16 template
    takes a 2-byte void or int16 leaf as its bit pattern."""
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and arr.dtype.kind in "Vi":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(
    directory: str,
    step: int,
    state: Any,
    extra: dict | None = None,
    keep_last: int = 3,
) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}.npz")
    final = os.path.join(directory, f"step_{step:010d}.npz")
    keys = _write_npz(tmp, tree_items(state))
    os.replace(tmp, final)
    meta = {"step": step, "extra": extra or {}, "keys": sorted(keys)}
    tmp_meta = os.path.join(directory, f".tmp_step_{step}.json")
    with open(tmp_meta, "w") as f:
        json.dump(meta, f)
    os.replace(tmp_meta, os.path.join(directory, f"step_{step:010d}.json"))
    _gc(directory, keep_last)
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)\.npz", name)
        if m and os.path.exists(os.path.join(directory, name.replace(".npz", ".json"))):
            out.append(int(m.group(1)))
    return sorted(out)


def _gc(directory: str, keep_last: int) -> None:
    steps = _steps(directory)
    for s in steps[:-keep_last] if keep_last else []:
        for ext in (".npz", ".json"):
            with contextlib.suppress(FileNotFoundError):
                os.remove(os.path.join(directory, f"step_{s:010d}{ext}"))


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, target: Any, step: int | None = None):
    """Restore into ``target`` (a template state), in place: each tensor
    leaf is overwritten with the saved values, one leaf at a time, keeping
    its device and dtype; the other leaves are replaced by the saved arrays.

    Returns (state, extra): the state is ``target``'s structure around
    ``target``'s own tensors. Raises FileNotFoundError if no checkpoint and
    ValueError if a saved leaf's shape differs from the template's.
    """
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    with open(os.path.join(directory, f"step_{step:010d}.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(directory, f"step_{step:010d}.npz")) as data:
        def leaf(key: str, like: Any) -> Any:
            arr = data[key]
            if not isinstance(like, torch.Tensor):
                return arr
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{key}: saved shape {arr.shape}, template {tuple(like.shape)}")
            with torch.no_grad():
                like.copy_(_as_tensor(arr, like))
            return like

        state = tree_map(leaf, target)
    return state, meta["extra"]
