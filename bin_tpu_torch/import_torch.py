"""Import of a PyTorch checkpoint: a torch ``state_dict`` -> released weights
(``bin_tpu/import_torch.py``).

    python -m bin_tpu_torch.cli import-torch --preset config3_prf \\
        --torch-checkpoint ref.pth --out weights/imported.npz \\
        [--rules rules.json] [--gate-reorder 0,2,1,3] [--no-strict]

(also ``python -m bin_tpu_torch.import_torch``) converts a reference
checkpoint into the ``.npz`` and card that ``bin_tpu`` and the port serve.

* **Names**: an ordered table of regex rules maps each torch key onto a
  ``/``-joined path of the flax parameter tree (``level_1.head.Conv_0.weight``
  -> ``level_1/head/Conv_0/kernel``), after the universal cleanups (the
  ``module.`` prefix of ``nn.DataParallel`` stripped, buffers dropped).  A
  JSON file of extra rules, put ahead of these, maps another checkpoint's
  module paths without code changes.
* **Tensors** are converted by shape: a 4-d kernel is a torch conv weight
  (O, I, kh, kw), permuted to (kh, kw, I, O); a 2-d kernel is a linear
  weight, transposed.  Both packages store the ConvLSTM's 4F gate channels
  in the order (i, f, g, o), so ``gate_reorder`` is needed only for a
  checkpoint that packs them otherwise.
* **The template**: the converted tree is held against the tree of the
  port's ``Model.init`` leaf by leaf; every missing, unexpected or
  misshapen entry is reported at once, with a hint where an unpermuted
  OIHW weight would have matched.

``to_torch_state_dict`` is the way back, in the same naming.
"""

from __future__ import annotations

import json
import re
from typing import Any, Iterable, Mapping

import numpy as np

__all__ = ["DEFAULT_RULES", "convert_state_dict", "to_torch_state_dict",
           "validate_against_template", "import_torch_checkpoint",
           "import_cli"]

# ordered (pattern, replacement) rules over torch keys: the universal
# cleanups first, then the canonical naming; a None replacement drops the key
DEFAULT_RULES: tuple[tuple[str, str | None], ...] = (
    (r"^module\.", ""),                      # nn.DataParallel's prefix
    (r"num_batches_tracked$", None),         # BatchNorm buffers (the model
    (r"running_(mean|var)$", None),          # has none; dropped if present)
    (r"\.weight$", "/kernel"),
    (r"\.bias$", "/bias"),
    (r"\.", "/"),                            # module path -> tree path
)


def _apply_rules(key: str, rules: Iterable[tuple[str, str | None]]
                 ) -> str | None:
    for pat, repl in rules:
        if repl is None:
            if re.search(pat, key):
                return None
        else:
            key = re.sub(pat, repl, key)
    return key


def _to_flax_tensor(name: str, t: np.ndarray) -> np.ndarray:
    if t.ndim == 4 and name.endswith("/kernel"):
        return np.transpose(t, (2, 3, 1, 0))  # (O,I,kh,kw) -> (kh,kw,I,O)
    if t.ndim == 2 and name.endswith("/kernel"):
        return np.transpose(t, (1, 0))        # linear (O,I) -> (I,O)
    return t


def _from_flax_tensor(name: str, t: np.ndarray) -> np.ndarray:
    if t.ndim == 4 and name.endswith("/kernel"):
        return np.transpose(t, (3, 2, 0, 1))
    if t.ndim == 2 and name.endswith("/kernel"):
        return np.transpose(t, (1, 0))
    return t


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _numpy(value: Any) -> np.ndarray:
    """A torch tensor (on any device) or an array as a numpy array."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def convert_state_dict(state_dict: Mapping[str, Any],
                       rules: Iterable[tuple[str, str | None]] = DEFAULT_RULES,
                       gate_reorder: tuple[int, int, int, int] | None = None,
                       ) -> dict:
    """A torch ``state_dict`` (tensors or arrays) -> a nested flax tree.

    ``gate_reorder`` maps the checkpoint's ConvLSTM gate blocks onto (i, f,
    g, o): a checkpoint storing (i, g, f, o) takes (0, 2, 1, 3).  It applies
    to every tensor whose path ends in ``gates/kernel`` or ``gates/bias``
    (the 4F channel axis, last)."""
    rules = list(rules)
    flat: dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        mapped = _apply_rules(key, rules)
        if mapped is None:
            continue
        arr = _to_flax_tensor(mapped, _numpy(value))
        if gate_reorder is not None and re.search(r"gates/(kernel|bias)$",
                                                  mapped):
            blocks = np.split(arr, 4, axis=-1)
            arr = np.concatenate([blocks[i] for i in gate_reorder], axis=-1)
        if mapped in flat:
            raise ValueError(f"mapping collision: two torch keys map to "
                             f"{mapped!r}")
        flat[mapped] = arr
    return _unflatten(flat)


def to_torch_state_dict(params: Any) -> dict[str, np.ndarray]:
    """A flax tree -> a flat torch-style ``state_dict`` of numpy arrays:
    ``.``-joined names, ``kernel`` as ``weight``, conv weights OIHW."""
    out: dict[str, np.ndarray] = {}
    for name, t in _flatten(params).items():
        arr = _from_flax_tensor(name, np.asarray(t))
        key = name.replace("/kernel", ".weight").replace("/bias", ".bias")
        out[key.replace("/", ".")] = arr
    return out


def validate_against_template(imported: Any, template: Any) -> list[str]:
    """The problems of an imported tree against ``Model.init``'s, one line
    each (empty: the same structure and shapes)."""
    got = _flatten(imported)
    want = _flatten(template)
    problems = []
    for k in sorted(set(want) - set(got)):
        problems.append(f"MISSING  {k}  (expected shape {want[k].shape})")
    for k in sorted(set(got) - set(want)):
        problems.append(f"UNEXPECTED  {k}  (shape {got[k].shape})")
    for k in sorted(set(got) & set(want)):
        if got[k].shape != want[k].shape:
            hint = ""
            if got[k].ndim == 4 and np.transpose(got[k], (2, 3, 1, 0)).shape \
                    == want[k].shape:
                hint = "  [looks like an unpermuted OIHW conv weight]"
            problems.append(f"SHAPE  {k}: got {got[k].shape}, "
                            f"want {want[k].shape}{hint}")
    return problems


def import_torch_checkpoint(path: str, model, rules_path: str = "",
                            gate_reorder: tuple[int, int, int, int] | None
                            = None, strict: bool = True) -> dict:
    """Load a ``.pth``/``.pt`` file, convert and validate it.

    ``model`` is a port ``Model`` (``Model.init``'s tree is the template).
    The weights may sit under ``state_dict``, ``model``,
    ``model_state_dict`` or ``params``.  ``rules_path``: a JSON file of
    extra [pattern, replacement] rules put ahead of ``DEFAULT_RULES`` (a
    null replacement drops the key).  A mismatch raises ``ValueError``, or
    with ``strict=False`` prints a warning."""
    import torch

    # tensors, containers and numbers only (bin_tpu unpickles anything): a
    # foreign checkpoint's pickled objects could run code on load
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for k in ("state_dict", "model", "model_state_dict", "params"):
        if isinstance(obj, dict) and k in obj and isinstance(obj[k], dict):
            obj = obj[k]
            break
    rules = list(DEFAULT_RULES)
    if rules_path:
        with open(rules_path) as f:
            rules = [(p, r) for p, r in json.load(f)] + rules
    tree = convert_state_dict(obj, rules, gate_reorder)
    problems = validate_against_template(tree, model.init(0))
    if problems:
        msg = ("torch import does not match the model layout:\n  "
               + "\n  ".join(problems))
        if strict:
            raise ValueError(msg)
        print("WARNING: " + msg)
    return tree


def import_cli(argv: list[str] | None = None) -> None:
    """A torch checkpoint -> a released ``.npz`` with its card, for the
    preset's model.  Nothing runs on a device: the template's shapes come
    from a model built on PyTorch's meta device."""
    from bin_tpu_torch.cli import parse_config
    from bin_tpu_torch.registry import build_model
    from bin_tpu_torch.weights import export_weights

    cfg, args = parse_config(
        argv, "import-torch", "Import a PyTorch reference checkpoint.", {
            "--torch-checkpoint": dict(required=True,
                                       help=".pth/.pt state_dict"),
            "--out": dict(required=True,
                          help="output .npz released-weights file"),
            "--rules": dict(default="", help="JSON [[pattern, replacement], "
                            "...] extra name-mapping rules"),
            "--gate-reorder": dict(default="", help="comma perm of ConvLSTM "
                                   "gate blocks onto (i,f,g,o), e.g. "
                                   "0,2,1,3"),
            "--no-strict": dict(action="store_true", help="warn instead of "
                                "fail on layout mismatch"),
        })
    model = build_model(cfg.model, "meta")
    reorder = (tuple(int(x) for x in args.gate_reorder.split(","))
               if args.gate_reorder else None)
    params = import_torch_checkpoint(args.torch_checkpoint, model,
                                     rules_path=args.rules,
                                     gate_reorder=reorder,
                                     strict=not args.no_strict)
    export_weights(args.out, params, model.cfg,
                   metadata={"preset": cfg.preset,
                             "imported_from": args.torch_checkpoint})
    print(f"imported {args.torch_checkpoint} -> {args.out}")


if __name__ == "__main__":
    import_cli()
