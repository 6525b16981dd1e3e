"""Checkpoint export (``spatialthinker_torch/tools/model_merger.py``) on the
CPU, with no hub: the port's state dict -> HF -> back is the identity; the
HF state dict equals the JAX package's export of the same carried weights key
for key and value for value; ``hf_config_dict`` equals JAX's at every preset
the port has; a trainer's checkpoint goes through ``main`` into a directory
``transformers`` loads, with logits within 2e-3 of the port's (as
``tests/test_merger.py`` holds the JAX export); a GAE checkpoint and the wrong
preset are refused."""

import json
import os

import numpy as np
import pytest
import torch

from spatialthinker_tpu.models.qwen2_5_vl import config as jconfig
from spatialthinker_tpu.tools import model_merger as jmm
from spatialthinker_torch.models.qwen2_5_vl import (
    forward, init_params, logits_from_hidden, params_from_hf_state_dict, params_from_jax,
)
from spatialthinker_torch.models.qwen2_5_vl import config as tconfig
from spatialthinker_torch.models.qwen2_5_vl.params import load_params
from spatialthinker_torch.tools import model_merger as tmm
from tests.test_torch_parity import CFG, JAX_CFG, random_jax_tree

torch.set_num_threads(2)


def _untied(cfg):
    import dataclasses

    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, tie_word_embeddings=False))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_state_dict_round_trip_is_the_identity(tied):
    cfg = CFG if tied else _untied(CFG)
    state = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32).state_dict()
    hf = tmm.params_to_hf_state_dict(state, cfg)
    assert "model.language_model.embed_tokens.weight" in hf and "model.visual.patch_embed.proj.weight" in hf
    assert ("lm_head.weight" in hf) == (not tied)
    assert hf["model.visual.patch_embed.proj.weight"].dim() == 5  # Conv3d again
    back = params_from_hf_state_dict(hf, cfg)
    assert back.keys() == state.keys()
    for k in state:
        assert torch.equal(back[k], state[k]), k


def test_hf_state_dict_equals_jax_export():
    tree = random_jax_tree(3)
    want = jmm.params_to_hf_state_dict(tree, JAX_CFG)
    got = tmm.params_to_hf_state_dict(params_from_jax(tree, CFG), CFG)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("preset", ["tiny", "3b", "7b"])
def test_hf_config_dict_equals_jax(preset):
    assert tmm.hf_config_dict(tconfig.get_config(preset)) == jmm.hf_config_dict(jconfig.get_config(preset))


def _trainer_checkpoint(tmp_path, *extra):
    from tests.test_torch_trainer import _reward_fn, build

    trainer, _ = build(tmp_path, "trainer.max_steps=1", "trainer.save_freq=1", *extra)
    trainer.reward_fn = _reward_fn
    trainer.fit()
    return trainer, f"{tmp_path}/ckpt/global_step_1"


def test_export_of_a_trainer_checkpoint_loads_into_transformers(tmp_path):
    """A checkpoint a port trainer wrote -> ``main`` -> ``transformers``:
    logits of the exported model within 2e-3 of the trained policy's."""
    pytest.importorskip("safetensors")
    trainer, step_dir = _trainer_checkpoint(tmp_path)
    out = tmp_path / "hf"
    tmm.main(["--checkpoint", step_dir, "--output", str(out), "--preset", "tiny", "--dtype", "float32"])
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors"]
    assert json.load(open(out / "config.json")) == tmm.hf_config_dict(tconfig.get_config("tiny"))

    # the port's own loader reads the export back bit for bit
    again = load_params(str(out), device="cpu", dtype=torch.float32)
    for (name, a), b in zip(trainer.model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name

    transformers = pytest.importorskip("transformers")
    hf_model = transformers.Qwen2_5_VLForConditionalGeneration.from_pretrained(str(out), torch_dtype=torch.float32)
    hf_model.eval()
    ids = torch.tensor([[5, 6, 7, 8, 9, 10, 11, 12]])
    with torch.no_grad():
        hf_logits = hf_model(input_ids=ids, attention_mask=torch.ones_like(ids)).logits
        pos = torch.arange(8).reshape(1, 1, 8).expand(3, 1, 8)
        hidden, _ = forward(trainer.model, ids, pos, segment_ids=torch.ones(1, 8, dtype=torch.int32))
        ours = logits_from_hidden(trainer.model.text, hidden)
    np.testing.assert_allclose(ours.numpy(), hf_logits.numpy(), rtol=2e-3, atol=2e-3)


def test_bf16_export_and_refusals(tmp_path):
    load_file = pytest.importorskip("safetensors.torch").load_file
    state = init_params(CFG, torch.Generator().manual_seed(1), device="cpu", dtype=torch.float32).state_dict()
    tmm.export_hf(state, CFG, str(tmp_path / "bf16"))
    written = load_file(str(tmp_path / "bf16" / "model.safetensors"))
    assert {v.dtype for v in written.values()} == {torch.bfloat16}
    hf = tmm.params_to_hf_state_dict(state, CFG)
    assert written.keys() == hf.keys()
    for k in hf:
        assert torch.equal(written[k], hf[k].to(torch.bfloat16)), k

    with pytest.raises(ValueError, match="do not match the preset"):
        tmm.export_hf(state, tconfig.get_config("3b"), str(tmp_path / "wrong"))
    with pytest.raises(FileNotFoundError, match="global_step_N"):
        tmm.load_checkpoint_params(str(tmp_path))
    gae = tmp_path / "global_step_3"
    gae.mkdir()
    torch.save({"actor": state, "critic": state}, gae / "params.pt")
    with pytest.raises(ValueError, match="GAE checkpoint"):
        tmm.load_checkpoint_params(str(gae))
