"""Checkpoints of the train state (``bin_tpu/training/checkpoint.py``).

``bin_tpu`` writes Orbax directories; Orbax is not on the card's machine, so
the port writes its own format: one ``torch.save`` file per step,
``<directory>/<step>.pt``, written under a temporary name and renamed, so a
write cut short never looks finished.  The newest ``keep_last_n`` are kept.
The interchange with ``bin_tpu`` is the released-weights ``.npz``
(``weights.export_weights``), not these files.  ConvLSTM carries are not
checkpointed: they reset per clip.
"""

from __future__ import annotations

import os

import torch

from bin_tpu_torch.training.state import TrainState

__all__ = ["save", "latest_step", "restore_if_available", "restore_params"]

_SUFFIX = ".pt"


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n[:-len(_SUFFIX)]) for n in os.listdir(directory)
                  if n.endswith(_SUFFIX) and n[:-len(_SUFFIX)].isdigit())


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def save(directory: str, step: int, state: TrainState,
         keep_last_n: int = 3) -> str:
    """Write ``state`` as ``<directory>/<step>.pt`` and drop all but the
    newest ``keep_last_n`` checkpoints.  Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{step}{_SUFFIX}")
    tmp = path + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max(1, keep_last_n)]:
        os.remove(os.path.join(directory, f"{old}{_SUFFIX}"))
    return path


def _load(directory: str) -> dict:
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    return torch.load(os.path.join(directory, f"{step}{_SUFFIX}"),
                      map_location="cpu", weights_only=True)


def restore_if_available(directory: str, state: TrainState) -> TrainState:
    """Load the newest checkpoint under ``directory`` into ``state``, if
    there is one."""
    if latest_step(directory) is not None:
        state.load_state_dict(_load(directory))
    return state


def restore_params(path: str, ema: bool = False) -> dict:
    """The parameters of the newest checkpoint under a directory as a flax
    tree of fp32 numpy arrays (``ema=True``: the EMA's, which raises for a
    run without one); or of a released-weights ``.npz``."""
    from bin_tpu_torch.weights import flax_from_params, load_weights

    if path.endswith(".npz"):
        if ema:
            raise ValueError("released .npz weights carry a single params "
                             "tree; export the EMA instead")
        return load_weights(path)[0]
    tree = _load(path)["ema" if ema else "params"]
    if tree is None:
        raise ValueError(f"checkpoint under {path} has no EMA params "
                         "(trained with optim.ema_decay=0?)")
    return flax_from_params(tree)
