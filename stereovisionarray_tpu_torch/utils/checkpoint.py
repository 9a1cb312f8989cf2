"""Checkpoint and resume (twin of ``stereovisionarray_tpu/utils/checkpoint.py``,
where Orbax writes the state).

A checkpoint is a directory holding the pipeline state (camera arrays,
landmark clouds, depth maps, BA state: any tree of tensors and arrays) as a
torch state file, ``state.pt``, loaded with ``weights_only=True``, and the
EngineConfig that produced it as ``engine_config.json``: the same file name
and text as the reference's, so a configuration saved by either package loads
in the other. Tensors are saved from the host; ``target`` places them back.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch.config import EngineConfig
from stereovisionarray_tpu_torch.utils.debug import _is_namedtuple

__all__ = ["load_checkpoint", "save_checkpoint"]

_CONFIG_FILE = "engine_config.json"
_STATE_FILE = "state.pt"


def _saveable(tree: Any) -> Any:
    """`tree` as containers ``weights_only`` loading accepts: tensors on the
    host, numpy arrays as tensors, NamedTuples and dataclasses as dicts of
    their fields."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, dict):
        return {k: _saveable(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return {name: _saveable(getattr(tree, name)) for name in tree._fields}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_saveable(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _saveable(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return tree


def _place(saved: Any, target: Any) -> Any:
    """`saved` in the structure of `target`, each tensor on its target's
    device and dtype (a numpy target gets a numpy array of its dtype)."""
    if isinstance(target, torch.Tensor):
        return saved.to(device=target.device, dtype=target.dtype)
    if isinstance(target, np.ndarray):
        return saved.numpy().astype(target.dtype)
    if isinstance(target, dict):
        return {k: _place(saved[k], v) for k, v in target.items()}
    if _is_namedtuple(target):
        return type(target)(*(_place(saved[n], getattr(target, n)) for n in target._fields))
    if isinstance(target, (list, tuple)):
        return type(target)(_place(s, t) for s, t in zip(saved, target))
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return dataclasses.replace(target, **{
            f.name: _place(saved[f.name], getattr(target, f.name))
            for f in dataclasses.fields(target) if f.init})
    return saved


def save_checkpoint(
    path: str,
    state: Any,
    config: Optional[EngineConfig] = None,
    force: bool = True,
) -> None:
    """Write `state` (a tree of tensors / arrays / numbers) and optionally
    the config into the directory `path` (created if needed). With
    ``force=False`` an existing checkpoint there is not overwritten
    (FileExistsError)."""
    path = os.path.abspath(path)
    state_file = os.path.join(path, _STATE_FILE)
    if not force and os.path.exists(state_file):
        raise FileExistsError(f"a checkpoint exists at {path!r} (force=False)")
    os.makedirs(path, exist_ok=True)
    tmp = state_file + ".tmp"
    torch.save(_saveable(state), tmp)
    os.replace(tmp, state_file)
    if config is not None:
        with open(os.path.join(path, _CONFIG_FILE), "w") as f:
            f.write(config.to_json())


def load_checkpoint(path: str, target: Any = None) -> Tuple[Any, Optional[EngineConfig]]:
    """Restore (state, config). Without `target` the state comes back as
    saved, tensors on the host (NamedTuples and dataclasses as dicts of
    their fields); a `target` tree of like-shaped tensors gives the
    structure, and each tensor its target's device and dtype."""
    path = os.path.abspath(path)
    state = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu", weights_only=True)
    if target is not None:
        state = _place(state, target)
    cfg = None
    cfg_path = os.path.join(path, _CONFIG_FILE)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = EngineConfig.from_json(f.read())
    return state, cfg
