"""Inputs of the paged kernels (#7, #8, #9) at the shapes they are timed and
checked at, one generator for ``time_paged.py``, ``chip_smoke.py`` and the
card tests.

Seeded random inputs, the 3B preset's 16 query heads over 2 kv heads, bf16 q
N(0, 1); the pools by ``kind`` over the same tables and lengths: ``int4``
packed int4 pools uniform in [0, 255] with bf16 scales uniform in [0.01,
0.1] (#9 and #8), ``int8`` int8 pools uniform in [-127, 127] with scales in
[0.001, 0.02] (#7), ``bf16`` bf16 pools N(0, 1) without scales (#7). Each
case is a dict: q, k, v, ks, vs (tensors on ``dev``; ks, vs None for bf16),
table, lengths (numpy), page, layers, kind, staged (None or the ring's
tensors: bf16 cells under bf16 pools, int8 cells with scales otherwise).

- ``make_path_b``: the shipped paged path's decode call as ``chip_smoke.py``'s
  ``check_paged`` draws it (its int4 pools): 65 lanes (the last the trash lane, length 0),
  page 256, lengths uniform in [422, 559], each lane's pages scattered over a
  pool of 129 pages, 36 layers; ``lanes`` cuts the engine to fewer lanes
  (17: a decode batch of 16), ``ring`` adds a staging ring whose first half
  is live in every lane but the trash lane.
- ``make_shipped``: the shipped scale, ``scripts/spatialthinker_3b_grpo.sh``'s
  ``decode_batch_size`` 128 + the trash lane, page 1024, lengths uniform in
  [6144, 8192]: ``groups`` groups of 8 lanes share their 6 prompt pages and
  own their response pages, a one-layer pool (``groups=1``: one group of 8
  lanes + the trash lane).
- ``bound_bytes``: the bytes a call must move.
"""

HQ, HKV, D = 16, 2, 128
# per cell and both kv heads: K and V values and (int4, int8) both bf16 scales
CELL_BYTES = {"int4": HKV * (D // 2 * 2 + 2 * 2), "int8": HKV * (D * 2 + 2 * 2), "bf16": HKV * D * 2 * 2}
RING_CELL_BYTES = {"int4": HKV * (2 * D + 2 * 2), "int8": HKV * (2 * D + 2 * 2), "bf16": HKV * 2 * D * 2}
SCALES = {"int4": (0.09, 0.01), "int8": (0.019, 0.001)}  # scales uniform in [lo, lo + span)


def _pools(torch, dev, shape, page, seed, kind="int4"):
    """K and V pools of ``shape`` (L, N, Hkv, page rows, D) and their scales (None for bf16)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "bf16":
        k, v = (torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16) for _ in range(2))
        return k, v, None, None, gen
    if kind == "int8":
        k, v = (torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen) for _ in range(2))
    else:
        k, v = (torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen) for _ in range(2))
    span, lo = SCALES[kind]
    ks, vs = ((torch.rand(shape[:3] + (page,), device=dev, generator=gen) * span + lo).to(torch.bfloat16)
              for _ in range(2))
    return k, v, ks, vs, gen


def _rows(page, kind):
    return page // 2 if kind == "int4" else page


def make_path_b(torch, np, dev, ring: int = 0, lanes: int = 65, kind: str = "int4"):
    """``check_paged``'s draw (seed 5, prompt 512, 64 new tokens, page 256, 129 pages)."""
    rng = np.random.default_rng(5)
    prompt_len, new, page, n_pages, n_layers = 512, 64, 256, 129, 36
    lengths = rng.integers(prompt_len - 90, prompt_len + new - 16, size=lanes)
    lengths[-1] = 0
    per_slot = -(-(prompt_len + new) // page) + 1
    table = np.zeros((lanes, per_slot), np.int32)
    for i, ell in enumerate(lengths):
        n = -(-int(ell) // page)
        table[i, :n] = rng.choice(np.arange(1, n_pages), size=n, replace=False)
    q = torch.from_numpy(rng.standard_normal((lanes, HQ, D), dtype=np.float32)).to(dev, torch.bfloat16)
    k, v, ks, vs, gen = _pools(torch, dev, (n_layers, n_pages, HKV, _rows(page, kind), D), page, 7, kind)
    staged = None
    if ring:
        rshape = (n_layers, lanes, HKV, ring, D)
        if kind == "bf16":
            st_k, st_v = (torch.randn(rshape, device=dev, generator=gen).to(torch.bfloat16) for _ in range(2))
            st_ks = st_vs = None
        else:
            lim, (span, lo) = 7 if kind == "int4" else 127, SCALES[kind]
            st_k = torch.randint(-lim, lim + 1, rshape, dtype=torch.int8, device=dev, generator=gen)
            st_v = torch.randint(-lim, lim + 1, rshape, dtype=torch.int8, device=dev, generator=gen)
            st_ks, st_vs = ((torch.rand(rshape[:4], device=dev, generator=gen) * span + lo).to(torch.bfloat16)
                            for _ in range(2))
        seg = torch.zeros((lanes, ring), dtype=torch.int32, device=dev)
        seg[:-1, : ring // 2] = 1
        staged = (st_k, st_v, st_ks, st_vs, seg)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table, lengths=lengths.astype(np.int32), page=page,
                layers=n_layers, kind=kind, staged=staged)


def make_shipped(torch, np, dev, groups: int = 16, kind: str = "int4"):
    """``groups`` x 8 lanes, each group sharing 6 prompt pages of 1024 cells, + the trash lane."""
    rng = np.random.default_rng(11)
    n, page, prompt = 8, 1024, 6144
    lanes = groups * n + 1
    p_max = -(-(prompt + 2048) // page) + 1
    lengths = np.zeros(lanes, np.int64)
    lengths[:-1] = rng.integers(prompt, prompt + 2048 + 1, size=lanes - 1)
    table = np.zeros((lanes, p_max), np.int32)
    next_page = 1
    for gi in range(groups):
        shared = np.arange(next_page, next_page + prompt // page)
        next_page += len(shared)
        for j in range(n):
            lane = gi * n + j
            own = -(-int(lengths[lane]) // page) - len(shared)
            table[lane, : len(shared)] = shared
            table[lane, len(shared): len(shared) + own] = np.arange(next_page, next_page + own)
            next_page += own
    q = torch.from_numpy(rng.standard_normal((lanes, HQ, D), dtype=np.float32)).to(dev, torch.bfloat16)
    k, v, ks, vs, _ = _pools(torch, dev, (1, next_page, HKV, _rows(page, kind), D), page, 13, kind)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table, lengths=lengths.astype(np.int32), page=page,
                layers=1, kind=kind, staged=None)


def call_args(torch, case, dev, layer: int = 0):
    """``paged_attention``'s positional arguments up to the scales for ``case``."""
    return (case["q"], case["k"], case["v"], torch.from_numpy(case["table"]).to(dev),
            torch.from_numpy(case["lengths"]).to(dev), layer, case["ks"], case["vs"])


def bound_bytes(case, distinct: bool) -> float:
    """Every lane's live cells (``distinct``: of every distinct page, the most
    any lane uses of it) and the ring's live cells, read once; q, table and
    lengths read, o, m, l written."""
    page, live, total = case["page"], {}, 0
    for lane, ell in enumerate(case["lengths"]):
        for pi in range(-(-int(ell) // page)):
            pid, cells = int(case["table"][lane, pi]), min(page, int(ell) - pi * page)
            live[pid] = max(live.get(pid, 0), cells)
            total += cells
    kind = case.get("kind", "int4")
    total = (sum(live.values()) if distinct else total) * CELL_BYTES[kind]
    lanes = len(case["lengths"])
    total += lanes * HQ * D * 2 * 2 + lanes * HQ * 4 * 2 + case["table"].size * 4 + lanes * 4
    if case["staged"] is not None:
        seg = case["staged"][4]
        total += int((seg != 0).sum()) * RING_CELL_BYTES[kind] + seg.numel() * 4
    return total
