"""Inputs of the paged int4 kernel with int8 dots (#9) at the shapes it is
timed and checked at, one generator for ``time_paged.py``, ``chip_smoke.py``
and the card tests.

Seeded random inputs (packed int4 pools uniform in [0, 255], bf16 scales
uniform in [0.01, 0.1], bf16 q N(0, 1)), the 3B preset's 16 query heads over
2 kv heads. Each case is a dict: q, k, v, ks, vs (tensors on ``dev``),
table, lengths (numpy), page, layers, staged (None or the ring's tensors).

- ``make_path_b``: the shipped paged path's decode call as ``chip_smoke.py``'s
  ``check_paged`` draws it: 65 lanes (the last the trash lane, length 0),
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
CELL_BYTES = HKV * (D // 2 * 2 + 2 * 2)  # per cell: K and V nibbles and both bf16 scales, both kv heads


def _pools(torch, dev, shape, page, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    v = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
    ks, vs = ((torch.rand(shape[:3] + (page,), device=dev, generator=gen) * 0.09 + 0.01).to(torch.bfloat16)
              for _ in range(2))
    return k, v, ks, vs, gen


def make_path_b(torch, np, dev, ring: int = 0, lanes: int = 65):
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
    k, v, ks, vs, gen = _pools(torch, dev, (n_layers, n_pages, HKV, page // 2, D), page, 7)
    staged = None
    if ring:
        rshape = (n_layers, lanes, HKV, ring, D)
        st_k = torch.randint(-7, 8, rshape, dtype=torch.int8, device=dev, generator=gen)
        st_v = torch.randint(-7, 8, rshape, dtype=torch.int8, device=dev, generator=gen)
        st_ks, st_vs = ((torch.rand(rshape[:4], device=dev, generator=gen) * 0.09 + 0.01).to(torch.bfloat16)
                        for _ in range(2))
        seg = torch.zeros((lanes, ring), dtype=torch.int32, device=dev)
        seg[:-1, : ring // 2] = 1
        staged = (st_k, st_v, st_ks, st_vs, seg)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table, lengths=lengths.astype(np.int32), page=page,
                layers=n_layers, staged=staged)


def make_shipped(torch, np, dev, groups: int = 16):
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
    k, v, ks, vs, _ = _pools(torch, dev, (1, next_page, HKV, page // 2, D), page, 13)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table, lengths=lengths.astype(np.int32), page=page,
                layers=1, staged=None)


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
    total = (sum(live.values()) if distinct else total) * CELL_BYTES
    lanes = len(case["lengths"])
    total += lanes * HQ * D * 2 * 2 + lanes * HQ * 4 * 2 + case["table"].size * 4 + lanes * 4
    if case["staged"] is not None:
        seg = case["staged"][4]
        total += int((seg != 0).sum()) * HKV * (2 * D + 2 * 2) + seg.numel() * 4
    return total
