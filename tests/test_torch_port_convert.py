"""medvill_torch.convert: the jax-free state-dict writer against the JAX
package's exporter, and checkpoint loading (prefixes, strictness, refusal of
orbax directories)."""
import numpy as np
import pytest
import torch

from medvill_torch.convert import (load_vlp_checkpoint, save_state_dict,
                                   vlp_state_dict_from_flax)
from medvill_torch.models.seq2seq import VLPForPreTraining
from medvill_tpu.core.torch_export import export_vlp_state_dict
from tests.torch_port_support import (finetune_config, jax_vlp, port_config,
                                      torch_vlp)


@pytest.fixture(scope="module")
def tiny():
    cfg = finetune_config(relax_projection=4)
    _, variables = jax_vlp(cfg, seed=3)
    return cfg, variables


def test_state_dict_equals_jax_export(tiny):
    _, v = tiny
    got = vlp_state_dict_from_flax(v["params"], v["batch_stats"])
    want = export_vlp_state_dict(v["params"], v["batch_stats"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_model_owns_exactly_the_reference_keys(tiny):
    """The port's parameter and buffer names are the reference layout."""
    cfg, v = tiny
    sd = vlp_state_dict_from_flax(v["params"], v["batch_stats"])
    bert, image = port_config(cfg)
    model = VLPForPreTraining(bert, image, len_vis_input=cfg.len_vis_input)
    assert sorted(model.state_dict()) == sorted(sd)


@pytest.mark.parametrize("prefix", ["", "bert.", "module.bert."])
def test_load_checkpoint_strips_prefixes(tiny, tmp_path, prefix):
    cfg, v = tiny
    sd = vlp_state_dict_from_flax(v["params"], v["batch_stats"])
    if prefix:
        # the reference decode layout: encoder keys under bert., heads not
        sd = {(prefix + k if not k.startswith("cls.") else
               prefix.replace("bert.", "") + k): a for k, a in sd.items()}
    sd["ans_classifier.0.weight"] = np.zeros((2, 2), np.float32)
    path = str(tmp_path / "model.3.bin")
    save_state_dict(sd, path)
    bert, image = port_config(cfg)
    model = VLPForPreTraining(bert, image, len_vis_input=cfg.len_vis_input)
    extra = load_vlp_checkpoint(model, path)
    assert extra == ["ans_classifier.0.weight"]
    ref = torch_vlp(cfg, v).state_dict()
    for k, t in model.state_dict().items():
        assert torch.equal(t, ref[k]), k


def test_load_checkpoint_refuses_orbax_dirs_and_missing_keys(tiny, tmp_path):
    cfg, v = tiny
    bert, image = port_config(cfg)
    model = VLPForPreTraining(bert, image, len_vis_input=cfg.len_vis_input)
    with pytest.raises(ValueError, match="medvill_tpu.cli.export_main"):
        load_vlp_checkpoint(model, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_vlp_checkpoint(model, str(tmp_path / "nope.bin"))
    sd = vlp_state_dict_from_flax(v["params"], v["batch_stats"])
    del sd["encoder.layer.1.output.dense.weight"]
    path = str(tmp_path / "partial.bin")
    save_state_dict(sd, path)
    with pytest.raises(ValueError, match="lacks 1 model keys"):
        load_vlp_checkpoint(model, path)
