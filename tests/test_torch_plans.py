"""Launch plans of the port's K2 (k-NN) and K1 (Eq. 2 utility) kernels,
the scans' choice of instance and the clusters of the chunked scan and
the sharded rounds.

The plans are plain Python (``knn_plan``, ``utility_plan``,
``selection_scan.ops.instance``), computed on the host and validated
again by the kernels' C entries, so their rules are checked here on the
CPU: the slices of the training set are non-empty and cover it exactly,
the shared memory fits a block of an H100, the grid covers its SMs
wherever the shapes allow, the chunks of a utility tile cover its rows in
order, a scan takes its warp instance exactly when a step's cells fit
one warp, and a wide round or row spreads its Eq. 2 tile over a cluster
sized by its cells.
"""
import pytest

from repro_torch.kernels.knn import ops as knn_ops
from repro_torch.kernels.selection_scan import ops as scan_ops
from repro_torch.kernels.utility import ops as util_ops

SMS = 132  # an H100 SXM
QS = [1, 64, 65, 127, 128, 1365, 5000]
NS = [1, 5, 16, 64, 65, 20_000, 80_000, 100_003]


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("d", [3, 24, 28, 32, 200])
def test_knn_plan_covers_the_training_set(d, k):
    for q in QS:
        for n in NS:
            if n < k:
                continue
            plan = knn_ops.knn_plan(q, n, d, k, SMS)
            assert plan.query_tile in (64, 128) and plan.stages in (2, 3)
            assert plan.query_tile == 64 or q > 64
            assert plan.slice_rows % knn_ops.TILE_ROWS == 0
            bounds = plan.slice_bounds(n)
            assert len(bounds) == plan.slices >= 1
            assert bounds[0][0] == 0 and bounds[-1][1] == n
            assert all(lo < hi for lo, hi in bounds), (q, n, plan)
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
            assert plan.smem_bytes == knn_ops.knn_smem_bytes(plan.query_tile, d, plan.stages, k)
            assert plan.smem_bytes <= knn_ops.SMEM_PER_BLOCK
            qblocks, slices = plan.grid(q)
            tiles = -(-n // knn_ops.TILE_ROWS)
            if qblocks * tiles >= SMS:
                assert qblocks * slices >= SMS, (q, n, plan)
            else:  # every tile is its own slice
                assert slices == tiles


def test_knn_plan_at_the_main_path_shape():
    """Q = 1365, N = 80,000, D = 32, k = 5: two blocks per SM in one wave."""
    plan = knn_ops.knn_plan(1365, 80_000, 32, 5, SMS)
    assert plan.query_tile == 128
    assert 2 * (plan.smem_bytes + 1024) <= knn_ops.SMEM_PER_SM
    qblocks, slices = plan.grid(1365)
    assert SMS <= qblocks * slices <= 2 * SMS


def test_knn_smem_rows_are_an_odd_number_of_float4s():
    """Eight consecutive staged rows fall on eight different bank quads."""
    for d in range(1, knn_ops.MAX_DIM + 1):
        s = knn_ops._row_stride(d)
        assert s % 4 == 0 and (s // 4) % 2 == 1 and d <= s <= d + 7
        assert len({(r * s // 4) % 8 for r in range(8)}) == 8


def test_knn_plan_rejects_what_the_kernel_cannot_take():
    for args in ((0, 10, 4, 1), (4, 10, 0, 1), (4, 10, knn_ops.MAX_DIM + 1, 1),
                 (4, 10, 4, 0), (4, 10, 4, knn_ops.MAX_K + 1), (4, 3, 4, 5)):
        with pytest.raises(ValueError):
            knn_ops.knn_plan(*args, SMS)


RS = [1, 2, 7, 41, 42, 43, 293, 294, 295, 1250, 4096, 4760, 4761, 9556, 100_003]


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("m", [1, 3, 6, 7, 64, 256])
def test_utility_plan_chunks_cover_the_rows_in_order(m, itemsize):
    for r in RS:
        plan = util_ops.utility_plan(r, m, itemsize, True)
        assert m * plan.block_rows <= util_ops.THREADS < m * (plan.block_rows + 1)
        assert 2 <= plan.cluster <= util_ops.MAX_CLUSTER
        chunks = plan.chunks(r)
        fill = plan.cluster - 1
        rounds = -(-len(chunks) // fill)
        assert chunks[0][1] == 0 and chunks[-1][2] == r
        assert all(lo < hi for _, lo, hi in chunks)
        assert all(a[2] == b[1] for a, b in zip(chunks, chunks[1:]))
        assert [b for b, _, _ in chunks] == [1 + c % fill for c in range(len(chunks))]
        assert {b for b, _, _ in chunks} == set(range(1, fill + 1))  # none idle
        assert plan.slots == (2 if rounds > 1 else 1)
        chunk_bytes = m * (plan.chunk_rows + 16 // itemsize) * itemsize  # padded columns
        assert plan.smem_bytes == plan.slots * fill * chunk_bytes <= util_ops.SUM_BYTES
        if plan.slots < rounds:  # a ring of two, only where the tile does not fit
            assert plan.slots == 2
            assert rounds * fill * chunk_bytes > util_ops.SUM_BYTES
        assert plan.chunk_rows % 8 == 0  # the sum's groups of 8 rows


@pytest.mark.parametrize("m", [1, 6, 256])
def test_utility_plan_without_sums_is_a_plain_grid(m):
    for r in RS:
        plan = util_ops.utility_plan(r, m, 8, False)
        assert plan.cluster == 0 and plan.slots == 0 and plan.smem_bytes == 0
        assert plan.chunk_rows % plan.block_rows == 0
        assert 1 <= plan.blocks <= util_ops.MAX_FILL_BLOCKS
        chunks = plan.chunks(r)
        assert len(chunks) == plan.blocks
        assert chunks[0][1] == 0 and chunks[-1][2] == r
        assert all(lo < hi for _, lo, hi in chunks)


def test_utility_plan_at_the_main_path_shape():
    """R = 1250, M = 6, f64: seven filling blocks, one chunk each."""
    plan = util_ops.utility_plan(1250, 6, 8, True)
    assert (plan.cluster, plan.block_rows, plan.chunk_rows, plan.slots) == (8, 42, 184, 1)
    assert [hi - lo for _, lo, hi in plan.chunks(1250)] == [184] * 6 + [146]


def test_utility_plan_rejects_what_the_kernel_cannot_take():
    for args in ((0, 6, 8), (10, 0, 8), (10, util_ops.MAX_MODELS + 1, 8), (10, 6, 2)):
        with pytest.raises(ValueError):
            util_ops.utility_plan(*args, True)


@pytest.mark.parametrize("n_w,members,m,want", [
    (1, 1, 6, "warp"),  # LO-EDF's per-request window
    (4, 1, 6, "warp"),  # LO-EDF on a four-worker pool: 24 cells
    (5, 1, 6, "warp"),  # 30 cells
    (6, 1, 6, "block"),  # 36 cells
    (1, 5, 6, "warp"),  # groups of up to five members
    (1, 6, 6, "block"),
    (1, 32, 1, "warp"),  # exactly one warp
    (1, 33, 1, "block"),
    (1, 1232, 6, "block"),  # SneakPeek's grouped window
    (4, 1232, 6, "block"),  # the same on four workers
])
def test_selection_scan_instance_by_shape(n_w, members, m, want):
    """The warp instance exactly when W * B * M cells fit one warp, B the
    tables' padded member count; its shared bytes (slots and tails) stay
    under P7's formula, which the block instance fills."""
    assert scan_ops.instance(n_w, members, m) == want
    assert (want == "warp") == (n_w * members * m <= scan_ops.WARP)
    for n_slots in (1, 9, 75):
        assert 8 * (n_w * n_slots + n_w) <= scan_ops.smem_bytes(n_w, n_slots, m)


@pytest.mark.parametrize("chunk,n_w,members,m,fixed,want", [
    (16, 1, 1, 6, False, 1),  # LO-EDF: the warp instance
    (16, 4, 1, 6, False, 1),  # LO-EDF on four workers: still a warp a position
    (1, 1, 1232, 6, False, 1),  # a grouped round of one position: 7,392 cells
    (2, 1, 1232, 6, False, 2),  # 14,784 cells
    (2, 1, 4000, 6, False, 6),  # 48,000 cells
    (16, 1, 1232, 6, False, 8),  # SneakPeek's grouped window at K = 16
    (16, 4, 1232, 6, False, 8),  # the same on four workers
    (4, 1, 700, 6, False, 3),  # 16,800 cells
    (16, 1, 1232, 6, True, 1),  # fixed choices: no tile
])
def test_spec_scan_cluster_by_shape(chunk, n_w, members, m, fixed, want):
    """The chunked scan takes the sequential scan's instance rule; its
    block instance spreads a round's (chunk, W, B, M) tile over one block
    per TILE_CELLS_A_BLOCK cells, at most the portable cluster of 8, and
    one block with fixed choices."""
    from repro_torch.kernels.spec_scan import ops as spec_ops

    assert spec_ops.instance(n_w, members, m) == scan_ops.instance(n_w, members, m)
    got = spec_ops.blocks(chunk, n_w, members, m, fixed)
    assert got == want
    if spec_ops.instance(n_w, members, m) == "block" and not fixed:
        cells = chunk * n_w * members * m
        assert got == min(spec_ops.MAX_CLUSTER, -(-cells // spec_ops.TILE_CELLS_A_BLOCK))


@pytest.mark.parametrize("n_w,members,m,want,blocks", [
    (1, 1, 6, "warp", 1),  # LO-EDF's per-request rows
    (5, 1, 6, "warp", 1),  # 30 cells
    (1, 6, 6, "wide", 1),  # 36 cells
    (2, 20, 6, "wide", 1),  # 240 cells
    (1, 300, 6, "wide", 2),  # 1,800 cells
    (1, 1232, 6, "wide", 8),  # a SneakPeek group of 1,232 members
    (4, 1232, 6, "wide", 1),  # the same on four workers: its tile stays in device memory
])
def test_score_block_instance_by_shape(n_w, members, m, want, blocks):
    """``score_block`` runs a row a warp when its W * B * M cells fit one,
    else a row a cluster of one block per ROW_CELLS_A_BLOCK cells (at most
    8; one with fixed choices, or when the row's tile does not fit the
    leader's shared memory)."""
    from repro_torch.kernels.shard_round import ops as shard_ops

    assert shard_ops.score_instance(n_w, members, m) == want
    assert shard_ops.tile_in_smem(n_w, members, m) == (8 * n_w * members * m < 150 * 1024)
    assert shard_ops.score_blocks(n_w, members, m) == blocks
    assert shard_ops.score_blocks(n_w, members, m, fixed=True) == 1


@pytest.mark.parametrize("b,skv,hq,hkv", [
    (8, 1024, 16, 16), (8, 1024, 16, 1), (2, 4096, 16, 1), (2, 2048, 8, 4), (1, 100, 16, 1),
    (2, 3000, 16, 1), (1, 64, 1, 1), (1, 64, 64, 1), (4, 2048, 32, 4), (1, 8192, 8, 8),
])
def test_k3b_plan_head_groups_cover_g(b, skv, hq, hkv):
    """K3b's plan at head dim 256 in bf16: the head groups cover a KV
    head's G query heads exactly, in order, each non-empty and within one
    head of the others; a single group wherever one block per (key tile, KV
    head, batch row) already fills the SMs, and then no scratch; else
    enough groups for two waves, at most G, with fp32 partials of dK and dV
    for each.  Other head dims and float32 never split.  The wgmma kernels'
    shared memory fits a block of an H100."""
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops

    g = hq // hkv
    plan = flash_ops.bwd_plan(b, skv, hq, hkv, 256, torch.bfloat16, SMS)
    heads = plan["heads"]
    assert len(heads) == plan["groups"] >= 1
    assert heads[0][0] == 0 and heads[-1][1] == g
    assert all(lo < hi for lo, hi in heads)
    assert all(a[1] == b_[0] for a, b_ in zip(heads, heads[1:]))
    sizes = [hi - lo for lo, hi in heads]
    assert max(sizes) - min(sizes) <= 1
    blocks = -(-skv // flash_ops.WGMMA_ROWS) * hkv * b
    if blocks >= SMS:
        assert plan["groups"] == 1 and plan["scratch"] == 0
    else:
        assert plan["groups"] == min(g, -(-2 * SMS // blocks))
        if plan["groups"] > 1:
            assert plan["scratch"] == 2 * plan["groups"] * b * skv * hkv * 256
    for d, dtype in ((128, torch.bfloat16), (256, torch.float32)):
        other = flash_ops.bwd_plan(b, skv, hq, hkv, d, dtype, SMS)
        assert other["groups"] == 1 and other["scratch"] == 0
    assert all(n <= flash_ops.SMEM_LIMIT for n in flash_ops.WGMMA_SMEM.values())


@pytest.mark.parametrize("b,s,width", [(8, 1024, 4096), (2, 300, 200), (3, 40, 256),
                                       (1, 1, 36), (4, 2500, 128)])
def test_rglru_bwd_scratch_holds_its_parts(b, s, width):
    """The RG-LRU backward's scratch: five partial sums and a handed-over w
    per (batch row, 64-step chunk, channel), a ticket counter per batch
    row and a flag per (batch row, chunk, 32-channel group)."""
    from repro_torch.kernels.rglru_scan import ops as rglru_ops

    nc, ng = -(-s // 64), -(-width // 32)
    assert rglru_ops.bwd_scratch_elems(b, s, width) == 6 * b * nc * width + b + b * nc * ng


# K4's shapes: (B, Hkv, G, S, D), gemma-7b's decode, recurrentgemma-9b's
# local decode, gemma3-4b's (G = 2), llama4's, tinyllama's, and edges.
K4_SHAPES = [(8, 16, 1, 1040, 256), (8, 1, 16, 1040, 256), (8, 4, 2, 1024, 256),
             (8, 8, 5, 1040, 128), (8, 4, 8, 1040, 64), (1, 1, 1, 1, 256), (1, 1, 4, 40, 256),
             (64, 16, 1, 4096, 256), (3, 2, 32, 300, 256), (2, 2, 3, 256, 256)]


@pytest.mark.parametrize("b,hkv,g,s,d", K4_SHAPES)
def test_k4_split_rule(b, hkv, g, s, d):
    """K4's blocks per (batch row, KV head): 1 to 8 (one cluster), fixed by
    the shapes; the instances of 8 heads a pass below D = 256 and in f32
    keep one block an SM; the bf16 instances at D = 256 fill every SM with
    as many blocks as it keeps resident, within a block's pass per split."""
    import torch

    from repro_torch.kernels.decode_attention import ops as decode_ops

    for dtype in (torch.bfloat16, torch.float32):
        inst = decode_ops.instance(dtype, d, g)
        n = decode_ops.split_count(b, hkv, s, SMS, inst)
        assert 1 <= n <= 8
        assert n == decode_ops.split_count(b, hkv, s, SMS, dict(inst))
        if inst["fitted"]:
            want = min(8, -(-inst["resident"] * SMS // (b * hkv)), -(-s // (4 * inst["rows"])))
            assert n == max(1, want)
        else:
            assert n == max(1, min(8, SMS // (b * hkv), -(-s // 32)))


def test_k4_split_rule_fills_the_card_at_gemma7b_decode():
    """gemma-7b's decode (B = 8, 16 KV heads, G = 1, D = 256, 1,040
    positions): 128 (batch row, KV head) pairs left 4 of 132 SMs idle and
    each block alone on its SM; the fitted instance splits each pair."""
    import torch

    from repro_torch.kernels.decode_attention import ops as decode_ops

    inst = decode_ops.instance(torch.bfloat16, 256, 1)
    n = decode_ops.split_count(8, 16, 1040, SMS, inst)
    assert n > 1 and n * 8 * 16 >= inst["resident"] * SMS
    f32 = decode_ops.instance(torch.float32, 256, 1)
    assert decode_ops.split_count(8, 16, 1040, SMS, f32) == 1


@pytest.mark.parametrize("g,heads,rows", [(1, 1, 8), (2, 2, 8), (3, 4, 4), (4, 4, 4), (5, 8, 2),
                                          (8, 8, 2), (16, 8, 2), (32, 8, 2)])
def test_k4_heads_per_pass_follow_g(g, heads, rows):
    """bf16 at D = 256: the heads a pass fitted to G (1, 2, 4, then 8 a
    pass for G >= 5), rows in flight 8, 8, 4, 2, residency 4 blocks an SM
    below 8 heads; every other (dtype, D) keeps 8 heads and 2 rows."""
    import torch

    from repro_torch.kernels.decode_attention import ops as decode_ops

    inst = decode_ops.instance(torch.bfloat16, 256, g)
    assert (inst["heads"], inst["rows"]) == (heads, rows)
    assert inst["resident"] == (4 if heads <= 4 else 2) and inst["fitted"]
    passes = -(-g // inst["heads"])
    assert passes * inst["heads"] >= g and (passes - 1) * inst["heads"] < g
    for dtype, d in ((torch.bfloat16, 128), (torch.float32, 256), (torch.bfloat16, 64)):
        other = decode_ops.instance(dtype, d, g)
        assert (other["heads"], other["rows"], other["resident"], other["fitted"]) == (
            8, 2, 2, False)


def _wgmma_walk(sq, skv, window, causal):
    """K3's bf16 instance at D = 256 walked as the kernel walks it: blocks of
    128 query rows, 64-key tiles from the block's first visible tile to its
    last; each of the two warpgroups (64 rows) computes a tile only where
    some query-key pair in it is visible.  Returns the (warpgroup, tile)
    pairs that compute, by brute force over every pair of each tile."""
    offset, pairs = skv - sq, 0
    for q0 in range(0, sq, 128):
        first, last = offset + q0, offset + min(q0 + 128, sq) - 1
        stop = min(skv, last + 1) if causal else skv
        start = (first - window + 1) // 64 * 64 if window and first - window + 1 > 0 else 0
        for k0 in range(start, stop, 64):
            for r0 in (q0, q0 + 64):
                rows = range(offset + r0, offset + min(r0 + 64, sq))
                pairs += any((not causal or j <= p) and (not window or j > p - window)
                             for p in rows for j in range(k0, min(k0 + 64, skv)))
    return pairs


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
@pytest.mark.parametrize("sq,skv,window", [
    (1024, 1024, 0), (1024, 1024, 2048), (200, 200, 0), (129, 129, 0), (64, 64, 0),
    (77, 300, 0), (130, 1000, 0), (400, 400, 63), (400, 400, 64), (400, 400, 129),
    (300, 700, 100), (1, 1, 0), (150, 150, 1), (1536, 1536, 1024), (1, 301, 0),
])
def test_k3_key_tiles_count_the_wgmma_walk(sq, skv, window, causal):
    """The count the dry run takes for K3 bf16 at D = 256 (``key_tiles``
    with ``_key_tile``'s 64 keys and ``QUERY_ROWS`` rows, and ``_area``)
    equals a brute-force count of the (warpgroup, key tile) pairs the
    wgmma instance computes."""
    import torch

    from repro_torch.kernels.flash_attention import ops as flash_ops

    tile = flash_ops._key_tile(torch.bfloat16, 256)
    assert tile == 64 == flash_ops.QUERY_ROWS
    walked = _wgmma_walk(sq, skv, window, causal)
    assert flash_ops.key_tiles(sq, skv, window, tile, causal=causal) == walked
    assert flash_ops._area((2, sq, 3, 256), (2, skv, 1, 256), window, tile,
                           causal=causal) == 2 * 3 * walked * 64 * 64
