"""The plain versions of the paged-attention kernels
(``spatialthinker_torch/ops/paged_attention.py``) against the JAX package's
Pallas kernels in interpret mode (``_pallas_paged``) and its exact XLA
gather fallback (``_xla_paged``), on the same numpy inputs.

Tolerances:
- bf16 and int8 pools, fp32 queries, pool values exactly representable in
  bf16: the plain version repeats the kernel's page-block arithmetic, so it
  sits within 1e-5 of the interpret-mode kernel on m, l (fp32 reduction
  order) and within 1e-4 on the output (the two exp implementations differ
  in the last bit, so a softmax weight on a bf16 rounding boundary may round
  the other way: 0.4% of one weight), and within 1e-5 on m, l of the exact
  fallback; its output differs from the fallback by the bf16 rounding of
  all the softmax weights, <= 2e-3;
- int4 pools with int8 dots: same arithmetic as the interpret-mode kernel —
  within 1e-5 on m, l (relative) and 2e-3 on the bf16 output (one bf16 ulp
  of an O(0.3) value; a weight that sits on an int8 rounding tie may flip
  by one step of 1/127 of its row max). Against the exact fallback, the
  reference test's envelope: m 2e-2, l 5e-2, relative output norm 3e-2;
- int4 pools with the dots on the widened nibbles (``int4_i8dot=False``):
  the plain version repeats the interpret-mode kernel's arithmetic (bf16
  weights in the dot, fp32 weights in the -8 debias): m, l within 1e-5,
  output within 2e-3 (one bf16 ulp of the O(0.3) output; a weight on a bf16
  rounding boundary may round the other way); against the exact fallback
  (which rounds every dequantized k and v to bf16, 0.4% of a value) m, l
  within 5e-3 and the output within 5e-3;
- ``paged_attention_gathered`` is the fallback itself: 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialthinker_tpu.ops.paged_attention import _pallas_paged, _xla_paged
from spatialthinker_torch.ops import paged_attention as pa

torch.set_num_threads(2)


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _case(kind, rng, n_layers=2, n_pages=9, hkv=2, page=128, d=128, g=2, lengths=(200, 128, 37, 256, 0)):
    s_slots, hq = len(lengths), hkv * g
    shape = (n_layers, n_pages, hkv, page, d)
    scales = (None, None)
    if kind == "bf16":
        k = _bf16_exact(rng.normal(size=shape))
        v = _bf16_exact(rng.normal(size=shape))
    else:
        lim = 127 if kind == "int8" else 7
        k = rng.integers(-lim, lim + 1, size=shape).astype(np.int8)
        v = rng.integers(-lim, lim + 1, size=shape).astype(np.int8)
        lo, hi = (0.001, 0.02) if kind == "int8" else (0.01, 0.1)
        scales = tuple(_bf16_exact(rng.uniform(lo, hi, size=shape[:-1])) for _ in range(2))
    if kind == "int4":
        half = page // 2

        def pack(vals):  # biased storage: nibble = value + 8
            low = (vals[:, :, :, :half] + 8).astype(np.uint8) & 0xF
            high = ((vals[:, :, :, half:] + 8).astype(np.uint8) << 4).astype(np.uint8)
            return low | high

        k, v = pack(k), pack(v)
    q = rng.normal(size=(s_slots, hq, d)).astype(np.float32)
    if kind == "int4":
        q = _bf16_exact(q)
    cols = max(-(-ell // page) for ell in lengths) + 1  # last column: dummy page 0
    table = np.zeros((s_slots, cols), dtype=np.int32)
    pages = iter(range(1, n_pages))
    for i, ell in enumerate(lengths):
        for c in range(-(-ell // page)):
            table[i, c] = next(pages)
    return q, k, v, scales, table, np.asarray(lengths, np.int32)


def _jax_args(q, k, v, scales, table, lengths, qdtype=None):
    js = tuple(None if s is None else jnp.asarray(s, jnp.bfloat16) for s in scales)
    return (jnp.asarray(q, qdtype) if qdtype else jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(1, jnp.int32), *js, 128**-0.5)


def _torch_args(q, k, v, scales, table, lengths, qdtype=torch.float32):
    ts = tuple(None if s is None else torch.from_numpy(s).to(torch.bfloat16) for s in scales)
    return (torch.from_numpy(q).to(qdtype), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(table), torch.from_numpy(lengths), 1, *ts)


def _np(x):
    return [np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float().numpy() for a in x]


@pytest.mark.parametrize("g", [2, 7])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_plain_pool_kernel_vs_pallas_and_fallback(kind, g):
    case = _case(kind, np.random.default_rng(0), g=g)
    if kind == "bf16":  # the TPU test feeds fp32 pools holding bf16-exact values
        k_ref, v_ref = case[1], case[2]
        t_case = (case[0], *(torch.from_numpy(a).to(torch.bfloat16) for a in (k_ref, v_ref)), *case[3:])
        t_args = (torch.from_numpy(case[0]), t_case[1], t_case[2], torch.from_numpy(case[4]),
                  torch.from_numpy(case[5]), 1, None, None)
    else:
        t_args = _torch_args(*case)
    o, m, l = _np(pa.paged_attention(*t_args, return_stats=True))
    o_k, m_k, l_k = _np(_pallas_paged(*_jax_args(*case)))
    o_x, m_x, l_x = _np(_xla_paged(*_jax_args(*case)))
    np.testing.assert_allclose(o, o_k, rtol=0, atol=1e-4)
    np.testing.assert_allclose(m, m_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m, m_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o, o_x, rtol=0, atol=2e-3)
    # the length-0 slot
    assert np.all(o[-1] == 0) and np.all(l[-1] == 0) and np.all(m[-1] == np.float32(-1e30))
    assert np.abs(o[0]).max() > 0


@pytest.mark.parametrize("g,lengths", [(2, (300, 256, 37, 512)), (7, (300, 1, 0, 511))])
def test_plain_int4_i8_vs_pallas_and_fallback(g, lengths):
    """The reference's int4_i8dot test shapes (page 256, two pages per slot),
    plus a 7-head group with a one-cell and an empty slot."""
    case = _case("int4", np.random.default_rng(31), page=256, g=g, lengths=lengths)
    t_args = _torch_args(*case, qdtype=torch.bfloat16)
    o, m, l = _np(pa.paged_attention(*t_args, return_stats=True, int4_i8dot=True))
    o_k, m_k, l_k = _np(_pallas_paged(*_jax_args(*case, qdtype=jnp.bfloat16), int4_i8dot=True))
    o_x, m_x, l_x = _np(_xla_paged(*_jax_args(*case, qdtype=jnp.bfloat16)))
    np.testing.assert_allclose(m, m_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o, o_k, rtol=0, atol=2e-3)
    live = np.asarray(lengths) > 0
    np.testing.assert_allclose(m[live], m_x[live], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(l[live], l_x[live], rtol=5e-2, atol=5e-2)
    err = np.linalg.norm(o - o_x) / (np.linalg.norm(o_x) + 1e-9)
    assert err < 3e-2, err
    if not live.all():
        dead = int(np.argmin(live))
        assert np.all(o[dead] == 0) and np.all(l[dead] == 0)


@pytest.mark.parametrize("g,lengths", [(2, (300, 256, 37, 512)), (7, (300, 1, 0, 511))])
def test_plain_int4_vs_pallas_and_fallback(g, lengths):
    """``_paged_kernel_int4`` (no ``int4_i8dot``) at the int8-dot test's shapes."""
    case = _case("int4", np.random.default_rng(32), page=256, g=g, lengths=lengths)
    t_args = _torch_args(*case, qdtype=torch.bfloat16)
    o, m, l = _np(pa.paged_attention(*t_args, return_stats=True, int4_i8dot=False))
    o_k, m_k, l_k = _np(_pallas_paged(*_jax_args(*case, qdtype=jnp.bfloat16), int4_i8dot=False))
    o_x, m_x, l_x = _np(_xla_paged(*_jax_args(*case, qdtype=jnp.bfloat16)))
    np.testing.assert_allclose(m, m_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_k, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o, o_k, rtol=0, atol=2e-3)
    live = np.asarray(lengths) > 0
    np.testing.assert_allclose(m[live], m_x[live], rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(l[live], l_x[live], rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(o, o_x, rtol=0, atol=5e-3)
    if not live.all():
        dead = int(np.argmin(live))
        assert np.all(o[dead] == 0) and np.all(l[dead] == 0)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_gathered_reference_is_the_xla_fallback(kind):
    case = _case(kind, np.random.default_rng(5), n_pages=13, page=64 if kind != "int4" else 128)
    if kind == "bf16":
        t_args = (torch.from_numpy(case[0]), torch.from_numpy(case[1]), torch.from_numpy(case[2]),
                  torch.from_numpy(case[4]), torch.from_numpy(case[5]), 1, None, None)
    else:
        t_args = _torch_args(*case)
    o, m, l = _np(pa.paged_attention_gathered(*t_args, scale=128**-0.5))
    o_x, m_x, l_x = _np(_xla_paged(*_jax_args(*case)))
    np.testing.assert_allclose(o, o_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m, m_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_x, rtol=1e-5, atol=1e-5)


def test_odd_half_page_and_default_scale():
    """Page sizes need only be even: page 6 (3 byte rows) through the int4
    plain version agrees with the exact reference within the int8 envelope."""
    case = _case("int4", np.random.default_rng(9), n_pages=12, page=6, lengths=(11, 6, 1, 17))
    t_args = _torch_args(*case, qdtype=torch.bfloat16)
    o = pa.paged_attention(*t_args, int4_i8dot=True).float().numpy()
    o_x = pa.paged_attention_gathered(*t_args)[0].float().numpy()
    assert np.linalg.norm(o - o_x) / np.linalg.norm(o_x) < 3e-2


def test_unported_modes_raise_on_cpu_too():
    """Inputs the kernels refuse are refused on the CPU too: int4 pools
    without scales, and ring scales that do not match the pool format."""
    case = _case("int4", np.random.default_rng(1))
    t_args = _torch_args(*case, qdtype=torch.bfloat16)
    with pytest.raises(ValueError, match="need k_scale"):
        pa.paged_attention(*t_args[:6], None, None, int4_i8dot=True)
    ring = _ring("int4", np.random.default_rng(2), n_layers=2, s_slots=5, hkv=2, c=4, d=128)
    for i8 in (False, True):
        with pytest.raises(ValueError, match="ring scales"):
            pa.paged_attention(*t_args, int4_i8dot=i8, staged=(*ring[0][:2], None, None, ring[0][4]))


def _ring(kind, rng, n_layers, s_slots, hkv, c, d, empty_slot=None):
    """A staging ring (torch, JAX): bf16 cells under bf16 pools, int8 cells
    (the int4 values, unpacked, under int4 pools) with bf16 scales otherwise;
    about half the cells live, slot 0 with none, ``empty_slot`` with some."""
    shape = (n_layers, s_slots, hkv, c, d)
    if kind == "bf16":
        k, v = (_bf16_exact(rng.normal(size=shape)) for _ in range(2))
        scales = (None, None)
    else:
        lim, lo, hi = (127, 0.001, 0.02) if kind == "int8" else (7, 0.01, 0.1)  # as the pools
        k, v = (rng.integers(-lim, lim + 1, size=shape).astype(np.int8) for _ in range(2))
        scales = tuple(_bf16_exact(rng.uniform(lo, hi, size=shape[:-1])) for _ in range(2))
    seg = (rng.random((s_slots, c)) < 0.5).astype(np.int32)
    seg[0] = 0
    if empty_slot is not None:
        seg[empty_slot, :2] = 1
    kv_t = torch.bfloat16 if kind == "bf16" else torch.int8
    t = (torch.from_numpy(k).to(kv_t), torch.from_numpy(v).to(kv_t),
         *(None if a is None else torch.from_numpy(a).to(torch.bfloat16) for a in scales), torch.from_numpy(seg))
    j = (jnp.asarray(k, jnp.bfloat16) if kind == "bf16" else jnp.asarray(k),
         jnp.asarray(v, jnp.bfloat16) if kind == "bf16" else jnp.asarray(v),
         *(None if a is None else jnp.asarray(a, jnp.bfloat16) for a in scales), jnp.asarray(seg))
    return t, j


STAGED_TOL = {  # (vs the interpret-mode kernel, vs the exact fallback), this file's envelopes per pool kind
    "bf16": dict(o=1e-4, ml=1e-5, fo=2e-3, fm=1e-5, fl=1e-5),
    "int8": dict(o=1e-4, ml=1e-5, fo=2e-3, fm=1e-5, fl=1e-5),
    "int4": dict(o=2e-3, ml=1e-5, fo=5e-3, fm=5e-3, fl=5e-3),
}


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "int4_i8"])
def test_plain_staged_vs_pallas_and_fallback(kind):
    """The staged block (the TPU helper ``_staged_block_update``, fused into
    the last grid step of #7 / #8 / #9) in every pool mode: the plain
    versions with ``staged=`` against the JAX kernels in interpret mode and
    against the exact fallback's one softmax over pool and ring cells. The
    ring has dead cells, slot 0 has none live, and slot 1 has no pool cell,
    only ring cells. q holds bf16-exact values (the staged block rounds q to
    bf16, the fallback does not). Tolerances: this file's for each pool kind
    (int4 with int8 dots: the fallback envelope m 2e-2, l 5e-2, relative
    output norm 3e-2)."""
    pool = "int4" if kind.startswith("int4") else kind
    page = 256 if pool == "int4" else 128
    lengths = (300, 0, 37, 256) if pool == "int4" else (200, 0, 37, 256, 128)
    rng = np.random.default_rng(41)
    case = list(_case(pool, rng, page=page, g=4, lengths=lengths))
    case[0] = _bf16_exact(case[0])
    ring_t, ring_j = _ring(pool, rng, 2, len(lengths), 2, 16, 128, empty_slot=1)
    i8 = kind == "int4_i8"
    qd_t, qd_j = (torch.bfloat16, jnp.bfloat16) if pool == "int4" else (torch.float32, None)
    if pool == "bf16":
        t_args = (torch.from_numpy(case[0]), *(torch.from_numpy(a).to(torch.bfloat16) for a in case[1:3]),
                  torch.from_numpy(case[4]), torch.from_numpy(case[5]), 1, None, None)
    else:
        t_args = _torch_args(*case, qdtype=qd_t)
    o, m, l = _np(pa.paged_attention(*t_args, return_stats=True, int4_i8dot=i8, staged=ring_t))
    kw = dict(int4_i8dot=i8) if pool == "int4" else {}
    o_k, m_k, l_k = _np(_pallas_paged(*_jax_args(*case, qdtype=qd_j), staged=ring_j, **kw))
    o_x, m_x, l_x = _np(_xla_paged(*_jax_args(*case, qdtype=qd_j), staged=ring_j))
    tol = STAGED_TOL[pool]
    np.testing.assert_allclose(o, o_k, rtol=0, atol=tol["o"])
    np.testing.assert_allclose(m, m_k, rtol=tol["ml"], atol=tol["ml"])
    np.testing.assert_allclose(l, l_k, rtol=tol["ml"], atol=tol["ml"])
    if i8:
        np.testing.assert_allclose(m, m_x, rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(l, l_x, rtol=5e-2, atol=5e-2)
        assert np.linalg.norm(o - o_x) / np.linalg.norm(o_x) < 3e-2
    else:
        np.testing.assert_allclose(m, m_x, rtol=tol["fm"], atol=tol["fm"])
        np.testing.assert_allclose(l, l_x, rtol=tol["fl"], atol=tol["fl"])
        pooled = [i for i in range(len(lengths)) if i != 1]
        np.testing.assert_allclose(o[pooled], o_x[pooled], rtol=0, atol=tol["fo"])
        # the ring-only slot averages a few cells, so the bf16 rounding of
        # its weights (2**-9 relative each) does not average out: bounded by
        # 2**-9 of its largest dequantized v (2**-8 with the fallback's int4
        # rounding of v added)
        v1 = ring_t[1][1, 1].float() * (1 if ring_t[3] is None else ring_t[3][1, 1].float()[..., None])
        bound = 2.0 ** (-8 if pool == "int4" else -9) * float(v1.abs().max())
        assert np.abs(o[1] - o_x[1]).max() <= bound
    # the ring-only slot attends its ring cells; the gathered reference agrees
    assert l[1].min() > 0 and np.abs(o[1]).max() > 0
    o_g, m_g, l_g = _np(pa.paged_attention_gathered(*t_args, scale=128**-0.5, staged=ring_t))
    np.testing.assert_allclose(m_g, m_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l_g, l_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o_g, o_x, rtol=1e-5, atol=1e-5)
    # the ring fused = the unfused stats merged with the ring by the flash combine
    o_u, m_u, l_u = _np(pa.paged_attention(*t_args, return_stats=True, int4_i8dot=i8))
    assert not np.allclose(l_u, l)
