"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same weights and inputs, made with numpy from a seed, go into the JAX
package and into ``spatialthinker_torch``. Also the weight carry-over's own
test.

Torch runs with 2 threads: the suite runs under several xdist workers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from spatialthinker_tpu.models.qwen2_5_vl import init_params as jax_init_params
from spatialthinker_tpu.models.qwen2_5_vl import qwen25_vl_tiny as jax_tiny
from spatialthinker_torch.models.qwen2_5_vl import build_model, params_from_jax, qwen25_vl_tiny

torch.set_num_threads(2)

VOCAB = 1024
JAX_CFG = jax_tiny(VOCAB)
CFG = qwen25_vl_tiny(VOCAB)
# small images keep the tiny tower's patch count (and CPU time) low
DATA_KW = dict(min_pixels=28 * 28 * 4, max_pixels=28 * 28 * 16)


def random_jax_tree(seed: int = 0):
    """The JAX package's tiny parameter tree with every leaf random (numpy):
    norms near 1, weights and biases N(0, 0.05) — nonzero biases and
    non-unit norms make the layout mapping observable."""
    rng = np.random.default_rng(seed)
    template = jax_init_params(JAX_CFG, jax.random.key(0), jnp.float32)

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        shape = leaf.shape
        if "norm" in name or "ln_q" in name:
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (0.05 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, template)


def both_models(seed: int = 0):
    """(JAX params as jnp fp32, port Qwen25VL fp32 on CPU) with equal weights."""
    tree = random_jax_tree(seed)
    jax_params = jax.tree.map(jnp.asarray, tree)
    model = build_model(CFG, params_from_jax(tree, CFG), device="cpu", dtype=torch.float32)
    return jax_params, model


def random_image(seed: int, h: int = 60, w: int = 84) -> np.ndarray:
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


def to_torch(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def test_params_from_jax_fills_every_parameter_with_its_leaf():
    """Every port parameter comes from the JAX tree, with the right shape,
    and every JAX leaf lands somewhere (element counts match)."""
    tree = random_jax_tree(0)
    state = params_from_jax(tree, CFG)
    model = build_model(CFG, state, device="cpu", dtype=torch.float32)
    params = dict(model.named_parameters())
    assert params.keys() == state.keys()
    for name, p in params.items():
        assert p.shape == state[name].shape, name
        torch.testing.assert_close(p.detach(), state[name], atol=0, rtol=0)
    n_leaves = sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert n_leaves == sum(p.numel() for p in params.values())
