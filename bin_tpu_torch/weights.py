"""Released weights: read and write ``bin_tpu``'s ``.npz`` + model card, and
carry the flax parameter tree over to the port's ``state_dict`` and back.

The file format is ``bin_tpu/weights.py``'s: a flat ``.npz`` whose keys are
the flax parameter paths joined by ``/``, a JSON card embedded under
``__model_card__`` and mirrored to a ``.card.json`` sidecar that wins.  A
file the port exports loads through ``bin_tpu.weights.load_weights`` too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings

import numpy as np
import torch

from bin_tpu_torch.config import ModelConfig

__all__ = ["load_weights", "export_weights", "card_config", "read_card",
           "card_path", "params_from_flax", "flax_from_params", "flatten"]

_CARD_KEY = "__model_card__"
OPS_VERSION = 2  # replicate-border fused upsample (bin_tpu/weights.py)


def card_path(path: str) -> str:
    """The sidecar-card path for a weights file: foo.npz -> foo.card.json."""
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".card.json"


def read_card(path: str) -> dict:
    """The model card of a weights file; the sidecar JSON wins over the
    card embedded in the npz."""
    side = card_path(path)
    if os.path.exists(side):
        with open(side) as f:
            return json.load(f)
    with np.load(path) as data:
        return json.loads(bytes(data[_CARD_KEY]).decode("utf-8"))


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested parameter tree -> {'a/b/kernel': array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def load_weights(path: str) -> tuple[dict, ModelConfig, dict]:
    """Read a weights file -> (flax parameter tree of numpy arrays,
    ModelConfig, metadata).

    fp16 storage is restored to fp32, JSON lists to the tuple fields, and
    card fields the port does not carry are ignored."""
    card = read_card(path)
    if card.get("ops_version", 1) != OPS_VERSION:
        warnings.warn(
            f"{path} was exported under ops_version "
            f"{card.get('ops_version', 1)}; the port implements version "
            f"{OPS_VERSION}, so border pixels may differ from its scores")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files if k != _CARD_KEY}
    if card.get("store_dtype"):  # storage-only downcast: restore float32
        flat = {k: v.astype(np.float32) if v.dtype.kind == "f" else v
                for k, v in flat.items()}
    return _unflatten(flat), _model_config(card), card.get("metadata", {})


def card_config(path: str) -> tuple[ModelConfig, dict]:
    """(ModelConfig, metadata) of a weights file's card, without reading
    its arrays."""
    card = read_card(path)
    return _model_config(card), card.get("metadata", {})


def _model_config(card: dict) -> ModelConfig:
    """The card's model config: JSON lists to the tuple fields, fields the
    port does not carry ignored."""
    mc = dict(card["model"])
    fields = {f.name: f for f in dataclasses.fields(ModelConfig)}
    for key, f in fields.items():
        if "tuple" in str(f.type) and isinstance(mc.get(key), list):
            mc[key] = tuple(mc[key])
    return ModelConfig(**{k: v for k, v in mc.items() if k in fields})


def params_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """Flax parameter tree -> the port's ``state_dict``.

    ``level_1/dec_0/Conv_0/kernel`` becomes ``level_1.dec_0.Conv_0.weight``
    (the flax path stays recoverable: ``.`` back to ``/``, ``weight`` back
    to ``kernel``).  A conv kernel (kh, kw, I, O) becomes (O, I, kh, kw),
    the map of ``bin_tpu/import_torch.py``'s ``_from_flax_tensor``; values
    are copied bit for bit."""
    out = {}
    for path, value in flatten(params).items():
        *mods, leaf = path.split("/")
        value = torch.from_numpy(np.ascontiguousarray(value))
        if leaf == "kernel":
            if value.ndim != 4:
                raise ValueError(f"{path}: expected a 4-d conv kernel, "
                                 f"got shape {tuple(value.shape)}")
            # torch's copy of the permuted view runs on all threads
            value = value.permute(3, 2, 0, 1).contiguous()
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"{path}: unknown parameter {leaf!r}")
        out[".".join((*mods, leaf))] = value
    return out


def flax_from_params(state_dict: dict[str, torch.Tensor]) -> dict:
    """The port's ``state_dict`` -> a flax parameter tree of fp32 numpy
    arrays, the inverse of ``params_from_flax``: ``level_1.dec_0.Conv_0.
    weight`` (O, I, kh, kw) becomes ``level_1/dec_0/Conv_0/kernel`` (kh,
    kw, I, O).  Values are copied bit for bit."""
    flat = {}
    for key, value in state_dict.items():
        *mods, leaf = key.split(".")
        value = value.detach().float().cpu()
        if leaf == "weight":
            value, leaf = value.permute(2, 3, 1, 0), "kernel"
        elif leaf != "bias":
            raise ValueError(f"{key}: unknown parameter {leaf!r}")
        # torch's copy of the permuted view runs on all threads
        flat["/".join((*mods, leaf))] = value.contiguous().numpy()
    return _unflatten(flat)


def export_weights(path: str, params: dict, model_cfg: ModelConfig,
                   metadata: dict | None = None,
                   store_dtype: str | None = None) -> None:
    """Write a flax parameter tree + model card to ``path`` (.npz) and its
    sidecar card, as ``bin_tpu/weights.py`` ``export_weights`` does.

    ``store_dtype`` (e.g. ``"float16"``) downcasts the float leaves for
    storage only; ``load_weights`` restores float32.  Only float32 trees
    round-trip so."""
    card = {"model": dataclasses.asdict(model_cfg),
            "metadata": metadata or {}, "ops_version": OPS_VERSION}
    flat = flatten(params)
    if store_dtype is not None:
        dt = np.dtype(store_dtype)
        if dt.kind != "f":
            raise ValueError(f"store_dtype must be floating, got {store_dtype}")
        nonf32 = [k for k, v in flat.items()
                  if v.dtype.kind == "f" and v.dtype != np.float32]
        if nonf32:
            raise ValueError("store_dtype round-trips only float32 trees; "
                             f"non-float32 float leaves: {nonf32[:3]}")
        flat = {k: v.astype(dt) if v.dtype.kind == "f" else v
                for k, v in flat.items()}
        card["store_dtype"] = dt.name
    flat[_CARD_KEY] = np.frombuffer(json.dumps(card).encode("utf-8"),
                                    dtype=np.uint8)
    np.savez(path, **flat)
    with open(card_path(path), "w") as f:
        json.dump(card, f, indent=1)
