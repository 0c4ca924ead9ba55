"""The port's torch-checkpoint import (``bin_tpu_torch/import_torch.py``) on
the CPU against ``bin_tpu/import_torch.py``, on the same ``state_dict``s of a
tiny config3_prf model (base 8, one mid ResBlock, ConvLSTM F=16) whose
parameters come from the port's ``Model.init``: ``to_torch_state_dict``,
``convert_state_dict`` (the rules, the ``module.`` prefix, the dropped
buffers, ``gate_reorder``, a rules file), ``validate_against_template``'s
problem lists string for string, ``cli import-torch`` against ``bin_tpu``'s
``import_cli`` (the same arrays and card), and the strict and the
``--no-strict`` modes.  Everything is a permutation or a copy: every
comparison is exact.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from bin_tpu import import_torch as jax_import
from bin_tpu.config import get_config as jax_get_config
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu.weights import load_weights as jax_load_weights
from bin_tpu_torch import build_model, cli, import_torch
from bin_tpu_torch.config import ModelConfig, get_config
from bin_tpu_torch.weights import flatten, load_weights, read_card

TINY = ["model.base_features=8", "model.num_res_blocks=1",
        "model.convlstm_features=16"]


@pytest.fixture(scope="module")
def case():
    """The port's tiny model on the CPU, its parameters, and bin_tpu's
    model of the same config."""
    cfg = get_config("config3_prf", TINY)
    model = build_model(cfg.model, "cpu")
    return model, model.init(seed=3), jax_build_model(
        jax_get_config("config3_prf", TINY))


def _assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape and np.array_equal(fa[k], fb[k]), k


def _swap_gates(sd):
    """The (i, f, g, o) gate blocks of every gates tensor stored as
    (i, g, f, o), the torch channel axis first."""
    out = dict(sd)
    for key in sd:
        if ".gates." in key:
            b = np.split(sd[key], 4, axis=0)
            out[key] = np.concatenate([b[0], b[2], b[1], b[3]], axis=0)
    return out


def test_to_torch_state_dict_equals_bin_tpus(case):
    _, params, _ = case
    ours = import_torch.to_torch_state_dict(params)
    theirs = jax_import.to_torch_state_dict(params)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape
        assert np.array_equal(ours[k], theirs[k]), k
    assert ours["level_1.head.Conv_0.weight"].shape[2:] == (3, 3)


@pytest.mark.parametrize("variant", ["plain", "module_prefix_and_buffers",
                                     "gate_reorder", "torch_tensors"])
def test_convert_state_dict_equals_bin_tpus(case, variant):
    _, params, _ = case
    sd = import_torch.to_torch_state_dict(params)
    reorder = None
    if variant == "module_prefix_and_buffers":
        sd = {f"module.{k}": v for k, v in sd.items()}
        sd["module.level_1.bn.num_batches_tracked"] = np.array(7)
        sd["module.level_1.bn.running_mean"] = np.zeros(4, np.float32)
    elif variant == "gate_reorder":
        sd, reorder = _swap_gates(sd), (0, 2, 1, 3)
    elif variant == "torch_tensors":
        sd = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    ours = import_torch.convert_state_dict(sd, gate_reorder=reorder)
    theirs = jax_import.convert_state_dict(sd, gate_reorder=reorder)
    _assert_trees_equal(ours, theirs)
    _assert_trees_equal(ours, params)
    if variant == "gate_reorder":  # without the permutation: other gates
        wrong = import_torch.convert_state_dict(sd)
        assert not np.array_equal(wrong["lstm_1"]["gates"]["kernel"],
                                  params["lstm_1"]["gates"]["kernel"])


def test_mapping_collision_raises_as_bin_tpus(case):
    _, params, _ = case
    sd = import_torch.to_torch_state_dict(params)
    sd["module.level_1.head.Conv_0.bias"] = sd["level_1.head.Conv_0.bias"]
    for convert in (import_torch.convert_state_dict,
                    jax_import.convert_state_dict):
        with pytest.raises(ValueError, match="mapping collision"):
            convert(sd)


def test_template_and_problem_lists_equal_bin_tpus(case):
    model, params, jmodel = case
    template = model.init(seed=0)
    jtemplate = jmodel.init(jax.random.key(0))
    assert ({k: v.shape for k, v in flatten(template).items()}
            == {k: np.shape(v) for k, v in
                flatten(jax.device_get(jtemplate)).items()})
    sd = import_torch.to_torch_state_dict(params)
    del sd["level_1.tail.bias"]                              # missing
    sd["level_9.bogus.weight"] = np.zeros((4, 4, 3, 3), np.float32)
    w = sd["level_1.head.Conv_0.weight"]
    tree = import_torch.convert_state_dict(sd)
    tree["level_1"]["head"]["Conv_0"]["kernel"] = w          # OIHW left
    ours = import_torch.validate_against_template(tree, template)
    assert ours == jax_import.validate_against_template(tree, jtemplate)
    text = "\n".join(ours)
    assert "MISSING  level_1/tail/bias" in text
    assert "UNEXPECTED  level_9/bogus/kernel" in text
    assert "unpermuted OIHW" in text
    assert import_torch.validate_against_template(params, template) == []


def _save_pth(path, params, wrap=True, drop=()):
    sd = {f"module.{k}": torch.from_numpy(v.copy())
          for k, v in import_torch.to_torch_state_dict(params).items()
          if k not in drop}
    torch.save({"state_dict": sd, "epoch": 3} if wrap else sd, path)


def test_rules_file_is_put_ahead_of_the_defaults(case, tmp_path):
    model, params, jmodel = case
    sd = {f"net.{k}": torch.from_numpy(v.copy())
          for k, v in import_torch.to_torch_state_dict(params).items()}
    sd["net.aux_head.weight"] = torch.zeros(2, 2)
    pth, rules = str(tmp_path / "ref.pth"), str(tmp_path / "rules.json")
    torch.save({"model": sd}, pth)
    with open(rules, "w") as f:
        json.dump([["^net\\.aux_head\\.", None], ["^net\\.", ""]], f)
    ours = import_torch.import_torch_checkpoint(pth, model, rules_path=rules)
    theirs = jax_import.import_torch_checkpoint(pth, jmodel, rules_path=rules)
    _assert_trees_equal(ours, theirs)
    _assert_trees_equal(ours, params)


@pytest.mark.parametrize("entry", ["cli", "module"])
def test_import_cli_writes_bin_tpus_arrays_and_card(case, tmp_path, capsys,
                                                    entry):
    _, params, _ = case
    pth = str(tmp_path / "ref.pth")
    _save_pth(pth, import_torch.convert_state_dict(
        _swap_gates(import_torch.to_torch_state_dict(params))))
    args = ["--preset", "config3_prf", *sum((["--set", s] for s in TINY), []),
            "--torch-checkpoint", pth, "--gate-reorder", "0,2,1,3"]
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    if entry == "cli":
        cli.main(["import-torch", *args, "--out", ours])
    else:
        import_torch.import_cli([*args, "--out", ours])
    jax_import.import_cli([*args, "--platform", "cpu", "--out", theirs])
    out = capsys.readouterr().out
    assert f"imported {pth} -> {ours}" in out
    got, model_cfg, meta = load_weights(ours)
    want, jmodel_cfg, jmeta = jax_load_weights(theirs)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, params)
    assert meta == jmeta == {"preset": "config3_prf", "imported_from": pth}
    assert set(read_card(ours)) == set(read_card(theirs))
    for f in ModelConfig.__dataclass_fields__:
        assert getattr(model_cfg, f) == getattr(jmodel_cfg, f), f


def test_strict_raises_and_no_strict_warns(case, tmp_path, capsys):
    model, params, _ = case
    pth = str(tmp_path / "bad.pth")
    _save_pth(pth, params, wrap=False, drop=("level_1.tail.bias",))
    with pytest.raises(ValueError, match="MISSING  level_1/tail/bias"):
        import_torch.import_torch_checkpoint(pth, model)
    out = str(tmp_path / "partial.npz")
    cli.main(["import-torch", "--preset", "config3_prf",
              *sum((["--set", s] for s in TINY), []),
              "--torch-checkpoint", pth, "--out", out, "--no-strict"])
    printed = capsys.readouterr().out
    assert "WARNING: torch import does not match the model layout" in printed
    assert "MISSING  level_1/tail/bias" in printed
    assert os.path.exists(out)
    assert "level_1/tail/bias" not in flatten(load_weights(out)[0])
