"""The port's int4 MLP (``spatialthinker_torch/ops/int4_mlp.py``, the plain
side of ``csrc/int4_mlp.cu``) and its w4a8 rollout copy against the JAX
package's ``ops/int4_mlp.py`` and ``quantize_params(mode="w4a8")``.

Tolerances:
- packing: the bytes and the scales bit-equal (the same fp32 amax, the same
  division and round-half-even on both sides);
- the plain versions against JAX's Pallas kernels in interpret mode (which is
  how they run off the TPU): the int32 group dots are exact on both sides,
  only the order of the fp32 group sums and the bf16 rounding of the output
  differ: relative error <= 2e-3, as ``tests/test_int4_mlp.py`` holds the
  kernels against their XLA reference;
- eligibility: equal decisions on every shape (JAX's traced abstractly, so
  no full-width kernel runs here);
- the per-row quantize divides: ``xs = amax / 127``, ``round(x / xs)``, as
  the JAX package's functions do when run op by op. Under ``jit`` XLA
  rewrites the division by the constant into ``amax * (1 / 127)``, a scale
  up to one ulp off, which rounds an activation lying within one ulp of a
  half step the other way (-63.499996 against -63.5). The port keeps the
  division (its int8 path, held bit for bit against JAX's eager
  ``quantize_activation`` in ``tests/test_torch_quant.py``, does the same),
  so engine-level comparisons with the jitted JAX engines allow one
  rounding step (``tests.test_torch_continuous.assert_same_up_to_ties``);
- ``quantize_model(mode="w4a8")`` against ``quantize_params(mode="w4a8")``:
  int4 bytes equal, group scales within one fp32 ulp (2e-7 relative: XLA
  compiles the jitted per-layer ``amax / 7`` to a multiply by a reciprocal,
  the eager path divides), as ``tests/test_torch_quant.py`` holds the int8
  tree; a carried JAX tree rebuilds the same port model exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.models.qwen2_5_vl import init_params as jax_init_params
from spatialthinker_tpu.models.qwen2_5_vl.text import swiglu_mlp
from spatialthinker_tpu.ops import int4_mlp as ji
from spatialthinker_tpu.ops import quant as jq
from spatialthinker_torch.models.qwen2_5_vl import build_model, params_from_jax
from spatialthinker_torch.ops import int4_mlp as ti
from spatialthinker_torch.ops import quant as tq
from tests.test_torch_parity import CFG, JAX_CFG

torch.set_num_threads(2)


def w4_configs():
    """The tiny preset widened to E = 128, I = 256 in both packages: the tiny
    preset's E = 64 makes JAX's down kernel refuse n = 64, so its MLP never
    takes the int4 path; here both kernels engage (group 64 for gate_up, 128
    for down)."""
    def widen(cfg):
        return dataclasses.replace(
            cfg, text=dataclasses.replace(cfg.text, hidden_size=128, intermediate_size=256,
                                          num_attention_heads=8),
            vision=dataclasses.replace(cfg.vision, out_hidden_size=128))
    return widen(JAX_CFG), widen(CFG)


def _w(rng, *shape, scale=0.05):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _port_weight(jw):
    """A JAX-layout int4 copy {"q4" (K/2, N), "gscale"} as the port's Int4Weight."""
    return ti.Int4Weight(torch.from_numpy(np.asarray(jw["q4"]).T.copy()),
                         torch.from_numpy(np.asarray(jw["gscale"]).copy()))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-12)


@pytest.mark.parametrize("shape,axis,group", [((512, 128), 0, 128), ((256, 96), 0, 64), ((3, 256, 40), 1, 32),
                                              ((40, 256), 1, 128)])
def test_pack_bit_equal(shape, axis, group):
    rng = np.random.default_rng(0)
    w = _w(rng, *shape)
    w[..., :2] = 0.0  # zero slices exercise the eps floor
    ref = ji.pack_int4_grouped(jnp.asarray(w), axis, group=group)
    got = ti.pack_int4_grouped(torch.from_numpy(w), axis, group)
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(ref["q4"]))
    np.testing.assert_array_equal(got["gscale"].numpy(), np.asarray(ref["gscale"]))
    assert got["q4"].dtype == torch.uint8 and got["gscale"].dtype == torch.float32


def test_int4_weight_keeps_the_port_layout():
    rng = np.random.default_rng(1)
    w = _w(rng, 96, 256)  # (out, in) = (N, K)
    iw = ti.Int4Weight.from_weight(torch.from_numpy(w), 64)
    ref = ji.pack_int4_grouped(jnp.asarray(w.T), 0, group=64)
    np.testing.assert_array_equal(iw.q4.numpy(), np.asarray(ref["q4"]).T)
    np.testing.assert_array_equal(iw.gscale.numpy(), np.asarray(ref["gscale"]))
    assert iw.group == 64 and iw.q4.is_contiguous() and iw.gscale.is_contiguous()


@pytest.mark.parametrize("m,e,i,group", [(16, 256, 256, 128), (8, 128, 256, 64), (6, 512, 128, 32)])
def test_gateup_silu_plain_matches_jax_kernel(m, e, i, group):
    rng = np.random.default_rng(2)
    x = jnp.asarray(_w(rng, m, e, scale=1.0), jnp.bfloat16)
    gu4 = ji.pack_int4_grouped(jnp.asarray(_w(rng, e, 2 * i)), 0, group=group)
    ref = ji.w4_gateup_silu(x, gu4)
    assert ref is not None
    got = ti.w4_gateup_silu(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16), _port_weight(gu4))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, i)
    assert _rel(got.float().numpy(), ref) <= 2e-3


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n,group", [(16, 256, 256, 128), (8, 512, 128, 128), (2, 256, 128, 32)])
def test_down_plain_matches_jax_kernel(m, k, n, group, out_dtype):
    rng = np.random.default_rng(3)
    x = jnp.asarray(_w(rng, m, k, scale=1.0), jnp.bfloat16)
    w4 = ji.pack_int4_grouped(jnp.asarray(_w(rng, k, n)), 0, group=group)
    ref = ji.w4_matmul(x, w4, out_dtype=getattr(jnp, out_dtype))
    got = ti.w4_matmul(torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16), _port_weight(w4),
                       out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and tuple(got.shape) == (m, n)
    assert _rel(got.float().numpy(), ref) <= 2e-3


def test_plain_version_follows_the_kernel_contract():
    """Per-row int8 activations, exact group dots on unsigned nibbles minus
    8 * sum(xq), fp32 group scales, times xs — against numpy in float64 on
    the quantized values (fp32 input: the only rounding left is fp32's)."""
    rng = np.random.default_rng(4)
    m, k, n, group = 4, 256, 128, 64
    x = _w(rng, m, k, scale=1.0)
    w4 = ti.pack_int4_grouped(torch.from_numpy(_w(rng, k, n)), 0, group)
    q4t, gs = w4["q4"].t().contiguous(), w4["gscale"]
    xq, xs = ti.quantize_rows(torch.from_numpy(x))
    vals = torch.cat([(w4["q4"] & 15).to(torch.int64) - 8, (w4["q4"] >> 4).to(torch.int64) - 8], dim=0)
    want = np.zeros((m, n))
    for g in range(k // group):
        sl = slice(g * group, (g + 1) * group)
        d = xq[:, sl].numpy().astype(np.int64) @ vals[sl].numpy()
        want += d * gs[g].numpy().astype(np.float64)
    want *= xs.numpy().astype(np.float64)
    got = ti.w4_matmul_plain(torch.from_numpy(x), q4t, gs, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_row_quantize_divides_as_the_contract():
    """A bf16 row whose x / xs lies one ulp below a half step where
    x * (1 / xs) lands on it: the port rounds by division, as JAX's
    ``quantize_activation`` does op by op; the jitted one (its scale one ulp
    off, see the next test) rounds these values the other way."""
    vals = (np.arange(1, 4096, dtype=np.float32) * np.float32(2.0**-8)).astype(np.float32)
    vals = np.asarray(jnp.asarray(vals, jnp.bfloat16), np.float32)
    amax = np.float32(13.0)
    xs = amax / np.float32(127.0)
    flips = vals[np.round(vals / xs) != np.round(vals * (np.float32(1.0) / xs))]
    assert len(flips)
    row = np.zeros((1, 128), np.float32)
    row[0, 0], row[0, 1 : 1 + min(len(flips), 8)] = amax, flips[:8]
    got, got_s = ti.quantize_rows(torch.from_numpy(row).to(torch.bfloat16))
    ref, ref_s = jq.quantize_activation(jnp.asarray(row, jnp.bfloat16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_array_equal(got.numpy()[0, 1:9].astype(np.float32)[: len(flips[:8])],
                                  np.round(flips[:8] / xs))
    jitted = np.asarray(jax.jit(jq.quantize_activation)(jnp.asarray(row, jnp.bfloat16))[0])
    assert (jitted[0, 1 : 1 + len(flips[:8])] != got.numpy()[0, 1 : 1 + len(flips[:8])]).all()


def test_jitted_scale_is_amax_times_the_reciprocal():
    """What XLA makes of ``amax / 127`` under ``jit``: ``amax * (1 / 127)``;
    x divided by that scale gives the jitted int8 rows bit for bit, where the
    port's ``amax / 127`` (JAX's own op-by-op result) and ``x * (1 / xs)``
    do not."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(512, 256)) * rng.uniform(0.1, 10.0, size=(512, 1))
    xb = jnp.asarray(x.astype(np.float32), jnp.bfloat16)
    jitted = np.asarray(jax.jit(jq.quantize_activation)(xb)[0])
    xt = torch.from_numpy(np.asarray(xb, np.float32))
    amax = torch.clamp(xt.abs().amax(dim=1, keepdim=True), min=1e-8)
    rows = lambda v: torch.clamp(torch.round(v), -127, 127).to(torch.int8).numpy()  # noqa: E731
    np.testing.assert_array_equal(rows(xt / (amax * np.float32(1.0 / 127.0))), jitted)
    port = ti.quantize_rows(xt.to(torch.bfloat16))[0].numpy()
    np.testing.assert_array_equal(port, np.asarray(jq.quantize_activation(xb)[0]))
    assert (port != jitted).any() and (rows(xt * (1.0 / (amax / 127.0))) != jitted).any()


SHAPES = {"3b": (2048, 11008), "7b": (3584, 18944), "w4_test": (128, 256)}


@pytest.mark.parametrize("preset", list(SHAPES))
@pytest.mark.parametrize("m", [8, 65, 128, 129, 136, 256])
def test_eligibility_agrees_with_jax(preset, m):
    """The port's one shape-only rule against JAX's entry points, traced
    abstractly (``jax.eval_shape`` evaluates their Python-level eligibility
    and returns None exactly where they do)."""
    e, i = SHAPES[preset]
    sd = jax.ShapeDtypeStruct
    for k, n, streams in ((e, i, 2), (i, e, 1)):
        group = jq._pick_w4_group(k)
        assert tq._pick_w4_group(k) == group
        cols = 2 * n if streams == 2 else n
        fn = ji.w4_gateup_silu if streams == 2 else ji.w4_matmul
        ref = jax.eval_shape(lambda x, q, s: fn(x, {"q4": q, "gscale": s}), sd((m, k), jnp.bfloat16),
                             sd((k // 2, cols), jnp.uint8), sd((k // group, cols), jnp.float32))
        assert ti.w4_eligible(m, k, n, group, streams) == (ref is not None), (preset, m, k, n)
    if preset == "3b":  # the decisions the continuous engine's lane count rests on
        assert ti.w4_eligible(136, e, i, 128, 2) and ti.w4_eligible(136, i, e, 128, 1)
        assert ti.w4_eligible(256, e, i, 128, 2) and not ti.w4_eligible(256, i, e, 128, 1)
        assert not ti.w4_eligible(129, e, i, 128, 2)  # the paged engine's slots + 1 lanes


def test_ineligible_shapes_return_none_and_the_mlp_takes_int8():
    rng = np.random.default_rng(5)
    w = ti.Int4Weight.from_weight(torch.from_numpy(_w(rng, 128, 256)), 128)
    assert ti.w4_matmul(torch.zeros(1024, 256), w) is None   # m too large
    assert ti.w4_matmul(torch.zeros(11, 256), w) is None     # m odd
    assert ti.w4_matmul(torch.zeros(12, 256), w) is not None


def test_quantize_model_w4a8_equals_quantize_params():
    jcfg, cfg = w4_configs()
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(3), jnp.float32))
    model = build_model(cfg, params_from_jax(tree, cfg), device="cpu", dtype=torch.float32)
    qtree = jax.tree.map(np.asarray, jq.quantize_params(jax.tree.map(jnp.asarray, tree), mode="w4a8"))
    want = params_from_jax(qtree, cfg)
    got = dict(tq.quantize_model(model, mode="w4a8").state_dict())
    assert got.keys() == want.keys()
    w4_keys = [k for k in want if "_w4." in k]
    assert len(w4_keys) == 4 * cfg.text.num_hidden_layers
    for name in w4_keys:
        assert got[name].dtype == want[name].dtype, name
        if name.endswith(".gscale"):
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=2e-7, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    assert tuple(got["text.layers.0.mlp.gate_up_w4.q4"].shape) == (512, 64)
    assert tuple(got["text.layers.0.mlp.down_w4.gscale"].shape) == (2, 128)
    # a carried JAX tree builds the same port model, int4 copies included
    carried = build_model(cfg, want, device="cpu", dtype=torch.float32)
    for name, t in carried.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[name].numpy(), err_msg=name)
    assert isinstance(carried.text.layers[1].mlp.down_w4, ti.Int4Weight)


def test_tiny_preset_has_no_int4_path_in_either_package():
    """E = 64: JAX's down kernel refuses n = 64 (no 128-multiple), so the
    tiny preset's w4a8 MLP is the int8 function in both packages."""
    assert not ti.w4_eligible(8, CFG.text.intermediate_size, CFG.text.hidden_size, 64, 1)


@pytest.mark.parametrize("m", [6, 7])
def test_w4a8_mlp_matches_jax_swiglu(m, monkeypatch):
    """One decoder MLP of the w4a8 trees on the same input: the int4 path at
    an even m, the int8 fallback at an odd m (JAX with SPATIALTHINKER_W4 set
    to force, so it takes the int4 path off the TPU)."""
    monkeypatch.setenv("SPATIALTHINKER_W4", "force")
    jcfg, cfg = w4_configs()
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(4), jnp.float32))
    qtree = jq.quantize_params(jax.tree.map(jnp.asarray, tree), mode="w4a8")
    qmodel = build_model(cfg, params_from_jax(jax.tree.map(np.asarray, qtree), cfg), device="cpu",
                         dtype=torch.float32)
    x = np.random.default_rng(6).normal(size=(1, m, cfg.text.hidden_size)).astype(np.float32)
    layer = jax.tree.map(lambda a: a[0], qtree["text"]["layers"]["mlp"])
    ref = np.asarray(swiglu_mlp(layer, jnp.asarray(x)))
    got = qmodel.text.layers[0].mlp(torch.from_numpy(x)).numpy()
    assert _rel(got, ref) <= 2e-3
    qmodel.text.layers[0].mlp.w4 = False  # SPATIALTHINKER_W4=0: the int8 path
    int8 = qmodel.text.layers[0].mlp(torch.from_numpy(x)).numpy()
    assert (_rel(int8, ref) <= 1e-5) == (m % 2 == 1)


def test_w4_swiglu_asks_both_rules_before_any_launch(monkeypatch):
    """gate_up admitted, down refused (E = 64 columns): None, and the gate_up
    function is never called — JAX computes that h and discards it; the
    result is the same int8 path either way."""
    rng = np.random.default_rng(7)
    gate_up = ti.Int4Weight.from_weight(torch.from_numpy(_w(rng, 512, 64)), 32)
    down = ti.Int4Weight.from_weight(torch.from_numpy(_w(rng, 64, 256)), 128)
    x = torch.from_numpy(_w(rng, 1, 8, 64, scale=1.0))
    assert ti.w4_eligible(8, 64, 256, 32, 2) and not ti.w4_eligible(8, 256, 64, 128, 1)
    calls = []
    monkeypatch.setattr(ti, "_gateup", lambda *a: calls.append(a))
    assert ti.w4_swiglu(x, gate_up, down, torch.float32) is None and not calls


def test_w4_swiglu_is_the_two_wrappers():
    """An admitted shape: ``w4_swiglu`` over (..., E) equals ``w4_gateup_silu``
    then ``w4_matmul`` on the flattened rows."""
    rng = np.random.default_rng(8)
    gate_up = ti.Int4Weight.from_weight(torch.from_numpy(_w(rng, 512, 128)), 64)
    down = ti.Int4Weight.from_weight(torch.from_numpy(_w(rng, 128, 256)), 128)
    x = torch.from_numpy(_w(rng, 2, 3, 128, scale=1.0))
    got = ti.w4_swiglu(x, gate_up, down, torch.float32)
    want = ti.w4_matmul(ti.w4_gateup_silu(x.reshape(6, 128), gate_up), down, out_dtype=torch.float32)
    assert tuple(got.shape) == (2, 3, 128)
    torch.testing.assert_close(got.reshape(6, 128), want, rtol=0, atol=0)
