"""The port's copies of the JAX package's host (numpy) helpers return exactly
what the originals return; the port's eval provider answers as the JAX one
does; and the port imports no JAX.

Arrays are compared exactly: the copies are the same numpy code.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from spatialthinker_tpu.core.config import DataConfig
from spatialthinker_tpu.data import dataset as jax_dataset
from spatialthinker_tpu.data import image as jax_image
from spatialthinker_tpu.data import packing as jax_packing
from spatialthinker_tpu.data import template as jax_template
from spatialthinker_tpu.models.qwen2_5_vl import rope as jax_rope
from spatialthinker_tpu.models.qwen2_5_vl import vision as jax_vision
from spatialthinker_tpu.utils.synthetic_tokenizer import SyntheticTokenizer
from spatialthinker_torch.data import dataset, image, packing, template
from spatialthinker_torch.models.qwen2_5_vl import host
from tests.test_torch_parity import CFG, DATA_KW, JAX_CFG, VOCAB, both_models, random_image

GRIDS = [(1, 8, 12), (1, 6, 6), (2, 4, 4)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


def test_mrope_position_ids_match():
    cfg = CFG
    merged = [t * h * w // 4 for t, h, w in GRIDS[:2]]
    ids = np.asarray(
        [5, 6, cfg.vision_start_token_id] + [cfg.image_token_id] * merged[0]
        + [cfg.vision_end_token_id, 7, cfg.vision_start_token_id] + [cfg.image_token_id] * merged[1]
        + [cfg.vision_end_token_id, 8, 9], np.int32,
    )
    kw = dict(spatial_merge_size=2, image_token_id=cfg.image_token_id,
              video_token_id=cfg.video_token_id, vision_start_token_id=cfg.vision_start_token_id)
    for grids in (np.asarray(GRIDS[:2]), None):
        got = host.get_mrope_position_ids(ids, grids, **kw)
        ref = jax_rope.get_mrope_position_ids(ids, grids, **kw)
        _equal(got[0], ref[0])
        assert got[1] == ref[1]


def test_vision_layout_helpers_match():
    got = host.prepare_vision_aux(GRIDS, CFG.vision)
    ref = jax_vision.prepare_vision_aux(GRIDS, JAX_CFG.vision)
    for field in ("patch_perm", "pos_ids", "seg_full", "seg_window", "reverse_index",
                  "num_patches", "num_merged"):
        _equal(getattr(got, field), getattr(ref, field))
    n_src = sum(t * h * w for t, h, w in GRIDS)
    patches = np.random.default_rng(0).normal(size=(n_src, 5)).astype(np.float32)
    layout = host.apply_patch_layout(patches, got)
    _equal(layout, jax_vision.apply_patch_layout(patches, ref))
    assert host.window_patch_len(CFG.vision) == jax_vision.window_patch_len(JAX_CFG.vision)
    for grid in GRIDS:
        assert host.layout_patch_count(grid, CFG.vision) == jax_vision.layout_patch_count(grid, JAX_CFG.vision)
    pad_to = got.num_patches + 64
    for a, b in zip(host.pad_vision_inputs(layout, got, pad_to), jax_vision.pad_vision_inputs(layout, ref, pad_to)):
        _equal(a, b)


def test_image_and_template_helpers_match():
    img = random_image(3, 61, 97)
    for args in ((61, 97), (300, 40), (1000, 1500)):
        assert image.smart_resize_dims(*args) == jax_image.smart_resize_dims(*args)
        assert image.budget_resize_dims(*args, 3136, 12544) == jax_image.budget_resize_dims(*args, 3136, 12544)
    got = image.process_image(img, 3136, 12544)
    ref = jax_image.process_image(img, 3136, 12544)
    _equal(got[0], ref[0])
    assert got[1] == ref[1]
    prompt = template.normalize_image_placement("Which <image> is left?", 1)
    assert prompt == jax_template.normalize_image_placement("Which <image> is left?", 1)
    assert template.build_chat_text(prompt, [6]) == jax_template.build_chat_text(prompt, [6])


def _rows():
    return [
        {"problem": "<image>Where is the cup?", "answer": "left", "image": [random_image(0)]},
        {"problem": "Count the chairs.", "answer": "3", "image": []},
        {"problem": "Is the lamp <image> above <image> the table?", "answer": "yes",
         "image": [random_image(1, 56, 112), random_image(2)]},
    ]


def test_dataset_items_collate_and_vision_pack_match():
    tok = SyntheticTokenizer(VOCAB)
    dcfg = DataConfig(max_prompt_length=64, **DATA_KW)
    ours = dataset.RLHFDataset.from_rows(_rows(), tok, dcfg, CFG)
    ref = jax_dataset.RLHFDataset.from_rows(_rows(), tok, dcfg, JAX_CFG)
    got_b = dataset.collate_fn([ours[i] for i in range(len(ours))])
    ref_b = jax_dataset.collate_fn([ref[i] for i in range(len(ref))])
    assert got_b.tensors.keys() == ref_b.tensors.keys()
    for key in ref_b.tensors:
        _equal(got_b.tensors[key], ref_b.tensors[key])
    assert got_b.non_tensors.keys() == ref_b.non_tensors.keys()
    for key in ref_b.non_tensors:
        for a, b in zip(got_b.non_tensors[key], ref_b.non_tensors[key]):
            if a is None or b is None:
                assert a is None and b is None
            else:
                _equal(a, b)
    patches = list(got_b.non_tensors["patches"])
    grids = list(got_b.non_tensors["image_grid_thw"])
    for kw in (dict(), dict(granularity=64), dict(pad_to=1024)):
        got = packing.pack_vision_batch(patches, grids, CFG.vision, **kw)
        want = jax_packing.pack_vision_batch(patches, grids, JAX_CFG.vision, **kw)
        for a, b in zip(got, want):
            _equal(a, b)
    assert packing.pack_vision_batch([None], [None], CFG.vision) is None


def test_torch_provider_matches_jax_provider():
    """Greedy answers of the two providers on shared tiny weights, with an
    image and a text-only prompt (cf. tests/test_eval.py's JaxProvider test).
    The tokenizer is tests/fake_tokenizer.py's with CRC-32 word ids, so the
    prompts, and hence the answers, are the same in every process."""
    from spatialthinker_tpu.eval.providers import JaxProvider
    from spatialthinker_torch.eval.providers import TorchProvider
    from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer

    jax_params, model = both_models(seed=2)
    kw = dict(max_new_tokens=6, temperature=0.0, max_prompt_length=64, prompt_bucket=32, **DATA_KW)
    prompts = ["Where is the cup relative to the plate?", "Name a color."]
    images = [[random_image(4)], []]
    ref = JaxProvider(jax_params, JAX_CFG, QwenSyntheticTokenizer(CFG), **kw).generate(prompts, images)
    got = TorchProvider(model, CFG, QwenSyntheticTokenizer(CFG), **kw).generate(prompts, images)
    assert got == ref
    assert len(got) == 2 and all(isinstance(o, str) for o in got)


def test_qwen_synthetic_tokenizer_uses_the_config_ids():
    from spatialthinker_torch.models.qwen2_5_vl import qwen25_vl_3b
    from spatialthinker_torch.utils.synthetic_tokenizer import QwenSyntheticTokenizer

    cfg = qwen25_vl_3b()
    tok = QwenSyntheticTokenizer(cfg)
    text = template.build_chat_text("<image>Is the cup left of the plate?", [3])
    ids = tok.encode(text)
    specials = {cfg.image_token_id, cfg.vision_start_token_id, cfg.vision_end_token_id,
                cfg.eos_token_id, cfg.eos_token_id - 1}
    assert ids.count(cfg.image_token_id) == 3
    assert ids.count(cfg.vision_start_token_id) == ids.count(cfg.vision_end_token_id) == 1
    assert all(i in specials or 0 < i < min(specials) for i in ids)
    assert "cup left of the" in tok.decode(ids)
    assert tok.encode("cup") == [75371]  # CRC-32 word ids: the same in every process
    assert tok.eos_token_id == cfg.eos_token_id and tok.pad_token_id == cfg.pad_token_id


@pytest.mark.parametrize("module", [
    "spatialthinker_torch.models.qwen2_5_vl", "spatialthinker_torch.ops",
    "spatialthinker_torch.rollout", "spatialthinker_torch.eval", "spatialthinker_torch.data",
    "spatialthinker_torch.csrc", "spatialthinker_torch.utils.synthetic_tokenizer",
    "spatialthinker_torch.core", "spatialthinker_torch.rollout.paged", "spatialthinker_torch.ops.quant",
    "spatialthinker_torch.ops.silu_quant", "spatialthinker_torch.ops.paged_attention",
    "spatialthinker_torch.ops.decode_attention", "spatialthinker_torch.algos", "spatialthinker_torch.rewards",
    "spatialthinker_torch.core.config", "spatialthinker_torch.data.dataset",
    "spatialthinker_torch.utils.seqlen_balancing", "spatialthinker_torch.utils.flops_counter",
    "spatialthinker_torch.utils.tokenizer", "spatialthinker_torch.utils.profiling",
    "spatialthinker_torch.trainer.metrics", "spatialthinker_torch.trainer.tracker",
    "spatialthinker_torch.trainer.checkpoint", "spatialthinker_torch.trainer.grpo_trainer",
    "spatialthinker_torch.trainer.main", "chip_smoke", "profile_rollout", "time_flash", "time_w8a8",
    "time_paged", "time_decode", "time_silu", "time_int4_mlp", "paged_cases",
])
def test_port_imports_no_jax(module):
    """Importing a module of the port pulls in neither jax, nor anything of
    the JAX package, nor triton (kernels build and import at first launch)."""
    code = (f"import sys, {module}; bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'spatialthinker_tpu', 'triton')); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_line_of_the_port_imports_jax_or_the_jax_package():
    """The same pinned in the sources: no ``import`` / ``from`` line of the
    package, of ``chip_smoke.py``, ``profile_rollout.py`` or the timing scripts names jax or
    ``spatialthinker_tpu`` (a lazy import inside a function would slip past
    the module-import check above)."""
    import re

    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|spatialthinker_tpu)\b")
    files = [os.path.join(REPO, name) for name in
             ("chip_smoke.py", "profile_rollout.py", "time_flash.py", "time_w8a8.py", "time_paged.py",
              "time_decode.py", "time_silu.py", "time_int4_mlp.py", "paged_cases.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "spatialthinker_torch")):
        dirs[:] = [d for d in dirs if d != "build"]  # csrc/build holds build outputs, not sources
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 50
    bad = [(f, i + 1) for f in files for i, line in enumerate(open(f)) if pattern.match(line)]
    assert not bad, bad
