"""The CUDA kernels K1, K2, K3 (fp32 and bf16 streams), K4 (the split3 mode
of K1/K2) and the row gathers P1/P2 against their plain PyTorch versions on
the card, and the port end to end on the card against the CPU: serving,
grad-of-grad, and a train step in fp32, bf16 and matmul_precision="high";
the kernels on capacity plans bit-equal to the exact plans, and the
captured (CUDA graph) train step against the eager one.

Marked `cuda`; each test asks for a card through the `device` fixture and
skips without one. This file imports no JAX, so on a machine with a card it
runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -q
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# kernel vs plain version: fp32 sums in another order (atomics in the plain
# K3): a few ulps of the terms, far below this share of the output's scale
RTOL = 1e-5
# bf16 streams: both sum in fp32 in other orders and round once to bf16, so
# they may differ by one bf16 ulp (2^-7 relative at most) of the output
BF16_RTOL = 2.0**-7


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _sorted_ids(rng, n_rows, n_seg, long_seg=None, long_rows=0):
    """Sorted ids with empty segments and, optionally, one long segment (as
    padded rows make)."""
    ids = rng.integers(0, max(n_seg - 3, 1), n_rows)
    if long_seg is not None:
        ids = np.concatenate([ids, np.full(long_rows, long_seg)])
    return np.sort(ids)


def _assert_close(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    scale = max(float(ref.abs().max()), 1.0)
    assert float((out - ref).abs().max()) <= RTOL * 10 * scale


def _assert_close_bf16(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    assert float((out - ref).abs().max()) <= BF16_RTOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("S,M", [(7, 64), (49, 32)])
def test_bf16_kernels_match_plain(device, S, M):
    """K1 and K2 on bf16 streams (the cotangent bf16, as the model gives
    it), and K3 on bf16 rows, against their plain versions on the card."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import expand_gather as eg
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    _cuda.set_matmul_precision()
    rng = np.random.default_rng(S + M)
    ids = _sorted_ids(rng, 3000, 300, long_seg=250, long_rows=700)
    plan = segment_plan(ids, 300, 128, device)
    a = torch.from_numpy(rng.normal(size=(len(ids), S)).astype(np.float32)).to(device).bfloat16()
    b = torch.from_numpy(rng.normal(size=(len(ids), M)).astype(np.float32)).to(device).bfloat16()
    cot = torch.from_numpy(rng.normal(size=(S, 300, M)).astype(np.float32)).to(device).bfloat16()
    tid = torch.from_numpy(ids).to(device)
    _cuda.reset_launches()
    _assert_close_bf16(so.outer_sum(a, b, tid, plan), so._outer_sum_plain(a, b, tid, 300))
    for o, r in zip(so.gather_contract(cot, a, b, tid, plan),
                    so._gather_contract_plain(cot, a, b, tid)):
        _assert_close_bf16(o, r)
    idx = rng.integers(0, 299, len(ids))
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    srt = idx[perm].astype(np.int32)
    tperm, tsrt = torch.from_numpy(perm).to(device), torch.from_numpy(srt).to(device)
    splan = segment_plan(srt, 300, 32, device)
    _assert_close_bf16(eg.sorted_segsum_values(b, tperm, tsrt, splan),
                       eg._segsum_plain(b[tperm.long()], tsrt, 300))
    assert _cuda.kernel_launches() == {"gemnet_segment_outer_sum_bf16": 1,
                                       "gemnet_segment_gather_contract_bf16": 1,
                                       "gemnet_sorted_segsum_bf16": 1}


CASES_SO = [(7, 64), (49, 32), (3, 5), (16, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,M", CASES_SO)
def test_segment_outer_sum_kernel_matches_plain(device, S, M):
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    rng = np.random.default_rng(S * 100 + M)
    ids = _sorted_ids(rng, 3000, 300, long_seg=250, long_rows=700)
    plan = segment_plan(ids, 300, 128, device)
    a = torch.from_numpy(rng.normal(size=(len(ids), S)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.normal(size=(len(ids), M)).astype(np.float32)).to(device)
    tid = torch.from_numpy(ids).to(device)
    _assert_close(so.outer_sum(a, b, tid, plan), so._outer_sum_plain(a, b, tid, 300))


@pytest.mark.cuda
@pytest.mark.parametrize("S,M", CASES_SO)
def test_segment_gather_contract_kernel_matches_plain(device, S, M):
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    rng = np.random.default_rng(S * 100 + M + 1)
    ids = _sorted_ids(rng, 3000, 300, long_seg=250, long_rows=700)
    plan = segment_plan(ids, 300, 128, device)
    a = torch.from_numpy(rng.normal(size=(len(ids), S)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.normal(size=(len(ids), M)).astype(np.float32)).to(device)
    cot = torch.from_numpy(rng.normal(size=(S, 300, M)).astype(np.float32)).to(device)
    tid = torch.from_numpy(ids).to(device)
    for o, r in zip(so.gather_contract(cot, a, b, tid, plan),
                    so._gather_contract_plain(cot, a, b, tid)):
        _assert_close(o, r)


@pytest.mark.cuda
@pytest.mark.parametrize("S,M", CASES_SO + [(49, 64), (5, 12)])
def test_split3_kernels_match_plain(device, S, M):
    """K4 forward and backward against the plain split3 versions on the card:
    the same bf16 products, exact in fp32, summed in fp32 in another order;
    and not equal to the exact fp32 kernels (split3 ran). Each counted under
    its own name."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    _cuda.set_matmul_precision()
    rng = np.random.default_rng(S * 100 + M + 2)
    ids = _sorted_ids(rng, 3000, 300, long_seg=250, long_rows=700)
    plan = segment_plan(ids, 300, 128, device)
    a = torch.from_numpy(rng.normal(size=(len(ids), S)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.normal(size=(len(ids), M)).astype(np.float32)).to(device)
    cot = torch.from_numpy(rng.normal(size=(S, 300, M)).astype(np.float32)).to(device)
    tid = torch.from_numpy(ids).to(device)
    _cuda.reset_launches()
    out = so.outer_sum(a, b, tid, plan, "split3")
    _assert_close(out, so._outer_sum_split3_plain(a, b, tid, 300))
    assert not torch.equal(out, so.outer_sum(a, b, tid, plan))
    grads = so.gather_contract(cot, a, b, tid, plan, "split3")
    for o, r in zip(grads, so._gather_contract_split3_plain(cot, a, b, tid)):
        _assert_close(o, r)
    assert _cuda.kernel_launches() == {"gemnet_segment_outer_sum_split3": 1,
                                       "gemnet_segment_outer_sum_f32": 1,
                                       "gemnet_segment_gather_contract_split3": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,R", [
    (29184, 32, 192512), (100, 8, 1000), (7, 64, 33),
    # P2's routes: a partial group of feature rows, with and without 16-byte
    # columns; one resident feature row per block; a table too wide for one
    (29184, 3, 1000), (100, 3, 33), (80000, 3, 1000), (120000, 4, 1000)])
def test_row_gather_kernels_match_plain(device, N, M, R):
    """P1 (where M % 8 == 0; it refuses other widths) and P2 bit-equal to
    table[idx] (the probe's shape among them), indices at 0 and N - 1; P2
    writes a zero column for an index outside [0, N)."""
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import row_gather as rg

    rng = np.random.default_rng(N + M + R)
    table = torch.from_numpy(rng.normal(size=(N, M)).astype(np.float32)).to(device).bfloat16()
    idx_np = rng.integers(0, N, R).astype(np.int32)
    idx_np[0], idx_np[-1] = 0, N - 1
    idx = torch.from_numpy(idx_np).to(device)
    tableT = table.t().contiguous()
    _cuda.reset_launches()
    if M % 8 == 0:
        assert torch.equal(rg.gather_rows(table, idx), table[idx.long()])
    else:
        with pytest.raises(ValueError):
            rg.gather_rows(table, idx)
    assert torch.equal(rg.gather_rows_fm(tableT, idx), table[idx.long()].t())
    bad = idx.clone()
    bad[1], bad[R // 2] = -1, N
    out = rg.gather_rows_fm(tableT, bad)
    torch.cuda.synchronize()
    assert not out[:, [1, R // 2]].float().abs().any()
    keep = torch.ones(R, dtype=torch.bool, device=device)
    keep[[1, R // 2]] = False
    assert torch.equal(out[:, keep], table[idx.long()].t()[:, keep])
    assert _cuda.kernel_launches() == {"gemnet_row_gather_fm": 2,
                                       **({"gemnet_row_gather": 1} if M % 8 == 0 else {})}
    with pytest.raises(TypeError):
        rg.gather_rows(table.float(), idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [3, 4, 32, 64])
def test_sorted_segsum_kernel_matches_plain(device, M, dtype):
    """Any row width, an n_src that is no multiple of 128, a 10 000-row
    segment (as padded rows make), empty and 1-row segments; against the
    plain version, bit-equal across two launches, one launch each, and the
    plan's arrival counters back at zero."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.data.batch import SEGMENT_PLANS
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import expand_gather as eg

    rng = np.random.default_rng(M)
    n_src = 1000
    idx = np.concatenate([rng.integers(5, n_src - 7, 3000), np.arange(n_src - 7, n_src - 2),
                          np.zeros(10_000, np.int64)])  # rows of ids 1-4, n_src-2.. stay empty
    rng.shuffle(idx)
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    srt = idx[perm].astype(np.int32)
    plan = segment_plan(srt, n_src, SEGMENT_PLANS["quad_abd_plan"][2], device)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(len(idx), M)).astype(np.float32)).to(device).to(dt)
    tperm, tsrt = torch.from_numpy(perm).to(device), torch.from_numpy(srt).to(device)
    _cuda.reset_launches()
    out = eg.sorted_segsum_values(x, tperm, tsrt, plan)
    again = eg.sorted_segsum_values(x, tperm, tsrt, plan)
    ref = eg._segsum_plain(x[tperm.long()], tsrt, n_src)
    if dt == torch.bfloat16:
        _assert_close_bf16(out, ref)
    else:
        _assert_close(out, ref)
    assert torch.equal(out, again)
    assert int(plan.arrivals.abs().sum()) == 0 and plan.merge_seg.numel() >= 1
    assert _cuda.kernel_launches() == {f"gemnet_sorted_segsum_{_cuda.DTYPE_SUFFIX[dt]}": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [3, 512])
def test_sorted_segsum_without_perm_matches_plain(device, M, dtype):
    """K3 with no perm (rows already in sorted order, as the triplet
    geometry's gather by the ascending reduce column) on 16-row items (its
    plan, id3_reduce_ca_plan's), a 10 000-row segment and empty ones:
    against the plain version and bit-equal to the kernel with an identity
    perm."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.data.batch import SEGMENT_PLANS
    from gemnet_pytorch_tpu_torch.ops import expand_gather as eg

    rng = np.random.default_rng(M)
    n_src = 1000
    srt = np.sort(np.concatenate([rng.integers(5, n_src - 7, 3000),
                                  np.full(10_000, n_src - 3)])).astype(np.int32)
    plan = segment_plan(srt, n_src, SEGMENT_PLANS["id3_reduce_ca_plan"][2], device)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(len(srt), M)).astype(np.float32)).to(device).to(dt)
    tsrt = torch.from_numpy(srt).to(device)
    out = eg.sorted_segsum_values(x, None, tsrt, plan)
    ident = eg.sorted_segsum_values(
        x, torch.arange(len(srt), dtype=torch.int32, device=device), tsrt, plan)
    ref = eg._segsum_plain(x, tsrt, n_src)
    if dt == torch.bfloat16:
        _assert_close_bf16(out, ref)
    else:
        _assert_close(out, ref)
    assert torch.equal(out, ident)
    assert int(plan.arrivals.abs().sum()) == 0


def _ragged_ids(rng, n_seg):
    """Sorted ids whose segments hold 1, 15, 16, 17, 127, 128, 129, 3, 2, 5,
    0 and 300 rows (items of those lengths, starting at every residue mod
    4), then random short segments."""
    lengths = [1, 15, 16, 17, 127, 128, 129, 3, 2, 5, 0, 300]
    head = np.repeat(np.arange(len(lengths)), lengths)
    tail = np.sort(rng.integers(len(lengths) + 1, n_seg - 2, 2000))
    return np.concatenate([head, tail])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,M", [(7, 64), (49, 32)])
def test_segment_gather_contract_kernel_ragged_items(device, S, M, dtype):
    """K2 on items of 1, 15, 16, 17, 127, 128 and 129 rows, starting at
    every residue mod 4, empty segments, and a segment split into several
    items: against the plain version and bit-equal across two launches."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    _cuda.set_matmul_precision()
    rng = np.random.default_rng(S + M)
    n_seg = 400
    ids = _ragged_ids(rng, n_seg)
    starts = np.searchsorted(ids, np.arange(12))
    assert set(starts % 4) == {0, 1, 2, 3}
    plan = segment_plan(ids, n_seg, 128, device)
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device).to(dt)

    a, b, cot = rand(len(ids), S), rand(len(ids), M), rand(S, n_seg, M)
    tid = torch.from_numpy(ids).to(device)
    _cuda.reset_launches()
    outs = so.gather_contract(cot, a, b, tid, plan)
    again = so.gather_contract(cot, a, b, tid, plan)
    for o, r, o2 in zip(outs, so._gather_contract_plain(cot, a, b, tid), again):
        if dt == torch.bfloat16:
            _assert_close_bf16(o, r)
        else:
            _assert_close(o, r)
        assert torch.equal(o, o2)
    assert _cuda.kernel_launches() == {
        f"gemnet_segment_gather_contract_{_cuda.DTYPE_SUFFIX[dt]}": 2}


def _k4_ids(rng, n_seg):
    """Sorted ids whose segments hold 0, 1, 15, 16, 17, 31, 32, 33, 63, 128,
    129 and 9600 rows, then random short segments; an odd row count, so with
    odd S the rows end past the tensor's last 16-byte boundary."""
    lengths = [0, 1, 15, 16, 17, 31, 32, 33, 63, 128, 129, 9600]
    head = np.repeat(np.arange(len(lengths)), lengths)
    tail = np.sort(rng.integers(len(lengths), n_seg, 1502))
    return np.concatenate([head, tail])


# K4 vs its plain split3 version (share of the plain output's magnitude): the
# same bf16 products, exact in fp32, summed in fp32 in another order
SPLIT3_RTOL = 1e-5
# K4 vs the exact fp32 K1/K2, share of max |exact| per output: the JAX
# package's split3 bound (tests/test_segment_outer.py)
SPLIT3_EXACT_RTOL = 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("S", [49, 25])
def test_split3_quad_kernels(device, S):
    """The K4 ring kernels (forward with its merge tree, backward) at M = 32
    on segments of 0-129 rows and one of 9600, rows that start off 16-byte
    boundaries and a last chunk that ends at the tensor's end: against the
    plain split3 versions and the exact fp32 ones, bit-equal across two
    launches and across two replays of one captured CUDA graph, and the merge
    tree's counters back at zero."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    _cuda.set_matmul_precision()
    rng = np.random.default_rng(S)
    n_seg, M = 700, 32
    ids = _k4_ids(rng, n_seg)
    n = len(ids)
    assert n % 2 == 1
    plan = segment_plan(ids, n_seg, 128, device)
    assert plan.tree_nodes.shape[0] > 1  # the 9600-row segment merges in two levels

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)

    a, b, cot = rand(n, S), rand(n, M), rand(S, n_seg, M)
    tid = torch.from_numpy(ids).to(device)

    def k4():
        return (so.outer_sum(a, b, tid, plan, "split3"),
                *so.gather_contract(cot, a, b, tid, plan, "split3"))

    _cuda.reset_launches()
    outs, again = k4(), k4()
    torch.cuda.synchronize()
    assert _cuda.kernel_launches() == {"gemnet_segment_outer_sum_split3": 2,
                                       "gemnet_segment_gather_contract_split3": 2}
    plain = (so._outer_sum_split3_plain(a, b, tid, n_seg),
             *so._gather_contract_split3_plain(cot, a, b, tid))
    exact = (so._outer_sum_plain(a, b, tid, n_seg), *so._gather_contract_plain(cot, a, b, tid))
    for o, o2, p, e in zip(outs, again, plain, exact):
        assert torch.equal(o, o2)
        assert float((o - p).abs().max()) <= SPLIT3_RTOL * float(p.abs().max())
        rel = float((o - e).abs().max()) / float(e.abs().max())
        assert 0 < rel <= SPLIT3_EXACT_RTOL
    assert int(plan.tree_arrivals.abs().sum()) == 0

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k4()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in captured])
    for o, r1, r2 in zip(outs, *replays):
        assert torch.equal(r1, r2) and torch.equal(r1, o)
    assert int(plan.tree_arrivals.abs().sum()) == 0


@pytest.mark.cuda
def test_split3_triplet_forward(device):
    """The K4 forward at the triplet shape (S = 7, M = 64: K1's warp kernel
    with split3 products) on the triplet plan's 16-row items, segments of
    0-129 rows and a padded one of 1600 (~100 items, a two-level merge
    tree): against the plain split3 version and the exact fp32 K1, one
    launch a call, bit-equal across two launches and across two replays of
    one captured CUDA graph, the tree's counters back at zero."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.data.batch import SEGMENT_PLANS
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    _cuda.set_matmul_precision()
    rng = np.random.default_rng(7)
    n_seg, S, M = 700, 7, 64
    ids = _k1_ids(rng, n_seg, 0)
    item_rows = SEGMENT_PLANS["id3_reduce_ca_plan"][2]
    plan = segment_plan(ids, n_seg, item_rows, device)
    nodes = plan.tree_nodes.cpu().numpy()
    assert item_rows == 16 and (nodes[:, 2] >= 0).any()  # the 1600-row segment: two levels

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)

    a, b = rand(len(ids), S), rand(len(ids), M)
    tid = torch.from_numpy(ids).to(device)
    _cuda.reset_launches()
    out, again = so.outer_sum(a, b, tid, plan, "split3"), so.outer_sum(a, b, tid, plan, "split3")
    torch.cuda.synchronize()
    assert _cuda.kernel_launches() == {"gemnet_segment_outer_sum_split3": 2}
    plain = so._outer_sum_split3_plain(a, b, tid, n_seg)
    exact = so._outer_sum_plain(a, b, tid, n_seg)
    assert float((out - plain).abs().max()) <= SPLIT3_RTOL * float(plain.abs().max())
    rel = float((out - exact).abs().max()) / float(exact.abs().max())
    assert 0 < rel <= SPLIT3_EXACT_RTOL
    assert torch.equal(out, again)
    assert int(plan.tree_arrivals.abs().sum()) == 0

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = so.outer_sum(a, b, tid, plan, "split3")
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(captured.clone())
    assert torch.equal(replays[0], out) and torch.equal(replays[1], out)
    assert int(plan.tree_arrivals.abs().sum()) == 0


@pytest.mark.cuda
def test_split3_triplet_backward(device):
    """The K4 backward at the triplet shape (S = 7, M = 64: a warp per work
    item, split3 FFMAs) on the triplet plan's 16-row items over segments of
    0-129 rows and a padded one of 1600: against the plain split3 version,
    each of da and db against the exact fp32 K2, one launch a call, bit-equal
    across two launches and across two replays of one captured CUDA graph;
    and the wmma kernel, which takes rows that start off a 16-byte boundary
    (a[1:]), against the plain version too."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.data.batch import SEGMENT_PLANS
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    _cuda.set_matmul_precision()
    rng = np.random.default_rng(8)
    n_seg, S, M = 700, 7, 64
    ids = _k1_ids(rng, n_seg, 0)
    item_rows = SEGMENT_PLANS["id3_reduce_ca_plan"][2]
    assert item_rows == 16
    plan = segment_plan(ids, n_seg, item_rows, device)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)

    a, b, cot = rand(len(ids), S), rand(len(ids), M), rand(S, n_seg, M)
    tid = torch.from_numpy(ids).to(device)

    def k4():
        return so.gather_contract(cot, a, b, tid, plan, "split3")

    _cuda.reset_launches()
    outs, again = k4(), k4()
    torch.cuda.synchronize()
    assert _cuda.kernel_launches() == {"gemnet_segment_gather_contract_split3": 2}
    plain = so._gather_contract_split3_plain(cot, a, b, tid)
    exact = so._gather_contract_plain(cot, a, b, tid)
    for o, o2, p, e in zip(outs, again, plain, exact):
        assert torch.equal(o, o2)
        assert float((o - p).abs().max()) <= SPLIT3_RTOL * float(p.abs().max())
        rel = float((o - e).abs().max()) / float(e.abs().max())
        assert 0 < rel <= SPLIT3_EXACT_RTOL

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k4()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in captured])
    for o, r1, r2 in zip(outs, *replays):
        assert torch.equal(r1, o) and torch.equal(r2, o)

    # rows off the 16-byte boundary: the wmma kernel
    ids1 = ids[1:]
    plan1 = segment_plan(ids1, n_seg, item_rows, device)
    a1, b1, tid1 = a[1:], b[1:], tid[1:]
    assert a1.data_ptr() % 16 != 0
    outs1 = so.gather_contract(cot, a1, b1, tid1, plan1, "split3")
    for o, p in zip(outs1, so._gather_contract_split3_plain(cot, a1, b1, tid1)):
        torch.cuda.synchronize()
        assert float((o - p).abs().max()) <= SPLIT3_RTOL * float(p.abs().max())


def _k1_ids(rng, n_seg, long_rows):
    """Sorted ids whose segments hold 0, 1, 7, 8, 31, 32, 33, 127, 128, 129,
    1600 and `long_rows` rows, then random short segments; an odd row count,
    so with odd S the rows end past the tensor's last 16-byte boundary."""
    lengths = [0, 1, 7, 8, 31, 32, 33, 127, 128, 129, 1600, long_rows]
    head = np.repeat(np.arange(len(lengths)), lengths)
    tail = np.sort(rng.integers(len(lengths), n_seg, 2000))
    return np.concatenate([head, tail])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,M", [(7, 64), (49, 32)], ids=["triplet", "quad"])
def test_outer_sum_routes(device, S, M, dtype):
    """K1 at the model's two shapes, per stream type (the warp kernel at the
    triplet shape, the FFMA and mma ring kernels at the quadruplet shape), on
    segments of 0-129, 1600 and 9600 rows (merge trees of one and two
    levels): against the plain version, bit-equal across two launches and
    across two replays of one captured CUDA graph, the merge tree's counters
    back at zero."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    _cuda.set_matmul_precision()
    rng = np.random.default_rng(S + M)
    n_seg = 700
    ids = _k1_ids(rng, n_seg, 9601)
    n = len(ids)
    assert n % 2 == 1
    plan = segment_plan(ids, n_seg, 128, device)
    assert plan.tree_nodes.shape[0] > 2  # the 9601-row segment merges in two levels
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device).to(dt)

    a, b = rand(n, S), rand(n, M)
    tid = torch.from_numpy(ids).to(device)
    _cuda.reset_launches()
    out, again = so.outer_sum(a, b, tid, plan), so.outer_sum(a, b, tid, plan)
    torch.cuda.synchronize()
    assert _cuda.kernel_launches() == {f"gemnet_segment_outer_sum_{_cuda.DTYPE_SUFFIX[dt]}": 2}
    ref = so._outer_sum_plain(a, b, tid, n_seg)
    if dt == torch.bfloat16:
        _assert_close_bf16(out, ref)
    else:
        _assert_close(out, ref)
    assert torch.equal(out, again)
    assert int(plan.tree_arrivals.abs().sum()) == 0

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = so.outer_sum(a, b, tid, plan)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(captured.clone())
    assert torch.equal(replays[0], out) and torch.equal(replays[1], out)
    assert int(plan.tree_arrivals.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_outer_sum_shape_changes(device, dtype):
    """K1's persistent triplet kernel at the model's width, then at a narrow
    one (less shared memory), then at the model's width again: each launch
    takes the shared memory its shape needs, whatever came before."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    rng = np.random.default_rng(3)
    ids = _sorted_ids(rng, 3000, 300, long_seg=250, long_rows=700)
    plan = segment_plan(ids, 300, 16, device)
    tid = torch.from_numpy(ids).to(device)
    for S, M in ((7, 64), (3, 8), (7, 64)):
        a, b = (torch.from_numpy(rng.normal(size=(len(ids), w)).astype(np.float32)).to(device)
                .to(getattr(torch, dtype)) for w in (S, M))
        out, ref = so.outer_sum(a, b, tid, plan), so._outer_sum_plain(a, b, tid, 300)
        if dtype == "bfloat16":
            _assert_close_bf16(out, ref)
        else:
            _assert_close(out, ref)


@pytest.mark.cuda
def test_launch_counter_and_input_checks(device):
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    ids = np.sort(np.random.default_rng(0).integers(0, 20, 100))
    plan = segment_plan(ids, 20, 128, device)
    a = torch.ones(100, 3, device=device)
    b = torch.ones(100, 4, device=device)
    tid = torch.from_numpy(ids).to(device)
    _cuda.reset_launches()
    so.outer_sum(a, b, tid, plan)
    so.outer_sum(a, b, tid, plan)
    assert _cuda.kernel_launches() == {"gemnet_segment_outer_sum_f32": 2}
    with pytest.raises(TypeError):
        so.outer_sum(a.half(), b, tid, plan)
    with pytest.raises(ValueError):
        so.outer_sum(torch.ones(3, 100, device=device).t(), b, tid, plan)
    with pytest.raises(ValueError):
        so.outer_sum(a, b, tid, segment_plan(ids, 20, 128, "cpu"))
    assert _cuda.kernel_launches() == {"gemnet_segment_outer_sum_f32": 2}
    # mixed streams stage fp32 explicitly: the fp32 kernel, an fp32 output
    assert so.outer_sum(a.bfloat16(), b, tid, plan).dtype == torch.float32
    assert _cuda.kernel_launches() == {"gemnet_segment_outer_sum_f32": 3}


def _small_batch(triplets_only):
    """4 molecules of 5-8 atoms, padded, with toy energy/force targets."""
    from gemnet_pytorch_tpu_torch.data import PadDims, build_graph, pad_batch, scale_graph_dims
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule, toy_energy_forces

    rng = np.random.default_rng(5)
    mols = [random_molecule(rng, int(rng.integers(5, 9))) for _ in range(4)]
    N = np.array([len(z) for z, _ in mols])
    Z = np.concatenate([z for z, _ in mols])
    R = np.concatenate([r for _, r in mols])
    g = build_graph(R, N, 5.0, 10.0, triplets_only=triplets_only)
    dims = PadDims(n_mol=4, n_atoms=16, n_edges=128, n_triplets=256, kmax3=4,
                   n_int_edges=0 if triplets_only else 64, n_intm=0 if triplets_only else 256,
                   n_quads=0 if triplets_only else 512, kmax4=0 if triplets_only else 4)
    dims = dims.grow_to(scale_graph_dims(g, 1.2), 4, len(Z))
    EF = [toy_energy_forces(z, r) for z, r in mols]
    E = np.array([e for e, _ in EF], np.float32)
    F = np.concatenate([f for _, f in EF])
    return pad_batch(g, Z, R, dims, E=E, F=F, triplets_only=triplets_only)


@pytest.mark.cuda
@pytest.mark.parametrize("triplets_only,direct_forces", [(False, False), (True, True)],
                         ids=["Q", "dT"])
def test_model_on_card_matches_cpu(device, triplets_only, direct_forces):
    """E and F, and the parameter gradient of a force loss (grad-of-grad
    through all three kernels' autograd pairs), on the card vs the CPU."""
    import copy

    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet, energy_and_forces

    cfg = ModelConfig(num_spherical=4, num_radial=4, num_blocks=2, emb_size_atom=32,
                      emb_size_edge=32, emb_size_trip=16, emb_size_quad=8, emb_size_rbf=8,
                      emb_size_cbf=8, emb_size_sbf=8, emb_size_bil_quad=8,
                      emb_size_bil_trip=16, triplets_only=triplets_only,
                      direct_forces=direct_forces)
    model_cpu = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model_gpu = copy.deepcopy(model_cpu).to(device)
    batch_np = _small_batch(triplets_only)
    outs = []
    for model, dev in ((model_cpu, "cpu"), (model_gpu, device)):
        E, F = energy_and_forces(model, to_torch(batch_np, dev), create_graph=True)
        loss = E.abs().sum() + (F**2).sum()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        outs.append([E.detach(), F.detach()] + [g.detach() for g in grads])
    for c, g in zip(*outs):
        scale = max(float(c.abs().max()), 1.0)
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_step_on_card_matches_cpu(device, compute_dtype):
    """Three Trainer steps of GemNet-Q on the card (the captured step)
    against the same steps on the CPU: the losses within rtol 1e-4 (fp32) and the whole parameter update
    within a relative L2 error of 1e-3 (fp32); bf16 is held to the bf16
    contract of tests/test_bf16.py instead (its roundings differ between the
    card's kernels and the CPU's plain versions), and its losses must fall."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    cfg = ModelConfig(num_spherical=4, num_radial=4, num_blocks=2, emb_size_atom=32,
                      emb_size_edge=32, emb_size_trip=16, emb_size_quad=8, emb_size_rbf=8,
                      emb_size_cbf=8, emb_size_sbf=8, emb_size_bil_quad=8,
                      emb_size_bil_trip=16, compute_dtype=compute_dtype)
    batch_np = _small_batch(False)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1)
    runs = {}
    for dev in ("cpu", device):
        model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device=dev)
        trainer = Trainer(model, tcfg)
        state = trainer.init_state()
        p0 = state.params.clone()
        losses = []
        for _ in range(3):  # the captured step on the card
            state, loss = trainer.train_on_batch(state, batch_np, 1.0)
            losses.append(float(loss))
        runs[str(dev)] = (np.array(losses), (state.params - p0).cpu().numpy())
    (l_cpu, d_cpu), (l_gpu, d_gpu) = runs["cpu"], runs[str(device)]
    assert np.isfinite(l_gpu).all() and l_gpu[-1] < l_gpu[0]
    if compute_dtype == "float32":
        np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
        assert np.linalg.norm(d_gpu - d_cpu) <= 1e-3 * np.linalg.norm(d_cpu)
    else:
        np.testing.assert_allclose(l_gpu[0], l_cpu[0], rtol=0.05)


@pytest.mark.cuda
def test_high_train_step_on_card_matches_cpu(device):
    """One matmul_precision="high" Trainer step of a 2-block GemNet-Q on the
    card (K4) against the CPU (the plain split3 versions): the loss within
    rtol 1e-4, the update within a relative L2 error of 1e-3; every K1/K2
    launch split3 (2 blocks: 4 + 8 K1, 4 + 4 + 4 K2) and the K3s exact (8
    geometry + 10 block gathers in -dE/dR, 10 + 2 network gathers in the
    loss's backward)."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.training import Trainer

    cfg = ModelConfig(num_spherical=4, num_radial=4, num_blocks=2, emb_size_atom=32,
                      emb_size_edge=32, emb_size_trip=16, emb_size_quad=8, emb_size_rbf=8,
                      emb_size_cbf=8, emb_size_sbf=8, emb_size_bil_quad=8,
                      emb_size_bil_trip=16, matmul_precision="high")
    batch_np = _small_batch(False)
    runs = {}
    for dev in ("cpu", device):
        trainer = Trainer(GemNet(cfg, generator=torch.Generator().manual_seed(0), device=dev),
                          TrainConfig(learning_rate=1e-3, warmup_steps=1))
        state = trainer.init_state()
        p0 = state.params.clone()
        _cuda.reset_launches()
        state, metrics, _ = trainer.train_step(state, to_torch(batch_np, dev), 1.0)  # eager
        loss = metrics["loss"]
        torch.cuda.synchronize()
        runs[str(dev)] = (float(loss), (state.params - p0).cpu().numpy(), _cuda.kernel_launches())
    (l_cpu, d_cpu, n_cpu), (l_gpu, d_gpu, n_gpu) = runs["cpu"], runs[str(device)]
    assert n_cpu == {}
    assert n_gpu == {"gemnet_segment_outer_sum_split3": 12,
                     "gemnet_segment_gather_contract_split3": 12, "gemnet_sorted_segsum_f32": 30}
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    assert np.linalg.norm(d_gpu - d_cpu) <= 1e-3 * np.linalg.norm(d_cpu)


def _plan_cases(rng, device):
    """(kernel, dtype, call(plan) -> outputs, sorted ids, segments, item rows)
    at the model's shapes: K1 and K2 (fp32, bf16) and K4 (split3) at the
    triplet (16-row items) and quadruplet (128-row items) shapes, K3 (fp32,
    bf16) at the quad_abd shape (64-row items); the ids with a long padded
    segment and empty ones."""
    from gemnet_pytorch_tpu_torch.ops import expand_gather as eg
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    cases = []
    n_seg = 400
    ids = _sorted_ids(rng, 3000, n_seg, long_seg=n_seg - 1, long_rows=2500)
    tid = torch.from_numpy(ids).to(device)
    for S, M, item_rows in ((7, 64, 16), (49, 32, 128)):
        for dtype in ("float32", "bfloat16", "split3"):
            dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
            precision = "split3" if dtype == "split3" else "exact"
            a, b = (torch.from_numpy(rng.normal(size=(len(ids), w)).astype(np.float32))
                    .to(device).to(dt) for w in (S, M))
            cot = torch.from_numpy(rng.normal(size=(S, n_seg, M)).astype(np.float32)).to(
                device).to(dt)
            cases.append(("K1", dtype, S, lambda p, a=a, b=b, pr=precision: (
                so.outer_sum(a, b, tid, p, pr),), ids, n_seg, item_rows))
            cases.append(("K2", dtype, S, lambda p, a=a, b=b, c=cot, pr=precision:
                          so.gather_contract(c, a, b, tid, p, pr), ids, n_seg, item_rows))
    n_src = 500
    idx = rng.integers(0, n_src - 2, 6000)
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    srt = idx[perm].astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        x = torch.from_numpy(rng.normal(size=(len(idx), 32)).astype(np.float32)).to(device).to(
            getattr(torch, dtype))
        tperm, tsrt = torch.from_numpy(perm).to(device), torch.from_numpy(srt).to(device)
        cases.append(("K3", dtype, 32, lambda p, x=x, tp=tperm, ts=tsrt: (
            eg.sorted_segsum_values(x, tp, ts, p),), srt, n_src, 64))
    return cases


@pytest.mark.cuda
def test_capacity_plans_bit_equal_to_exact_plans(device):
    """Every kernel of the model's shapes (K1, K2, K4 both directions, K3)
    on a capacity plan (padding items, merges and tree nodes appended)
    writes the same bits as on the exact plan, and leaves its counters at
    zero."""
    from gemnet_pytorch_tpu_torch.data import segment_plan

    rng = np.random.default_rng(11)
    for kernel, dtype, S, call, ids, n_seg, item_rows in _plan_cases(rng, device):
        exact = segment_plan(ids, n_seg, item_rows, device, capacity=False)
        cap = segment_plan(ids, n_seg, item_rows, device)
        assert cap.items.shape[0] > exact.items.shape[0]
        outs_exact, outs_cap = call(exact), call(cap)
        torch.cuda.synchronize()
        for o, r in zip(outs_cap, outs_exact):
            assert torch.equal(o, r), (kernel, dtype, S)
        assert int(cap.arrivals.abs().sum()) == int(cap.tree_arrivals.abs().sum()) == 0


@pytest.mark.cuda
def test_captured_fp32_step_matches_eager(device):
    """One GemNet-Q Trainer captured into a CUDA graph (train_step_fn) and
    one run eagerly (train_step), from the same weights, 3 steps each: the
    losses within rtol 1e-5, the parameter updates within a relative L2
    error of 1e-4, the metric accumulators within rtol 1e-5; the capture
    recorded the eager step's hand-written kernel launches exactly."""
    import collections

    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.training import Trainer

    cfg = ModelConfig(num_spherical=4, num_radial=4, num_blocks=2, emb_size_atom=32,
                      emb_size_edge=32, emb_size_trip=16, emb_size_quad=8, emb_size_rbf=8,
                      emb_size_cbf=8, emb_size_sbf=8, emb_size_bil_quad=8,
                      emb_size_bil_trip=16)
    batch_np = _small_batch(False)
    runs = {}
    for mode in ("eager", "captured"):
        trainer = Trainer(GemNet(cfg, generator=torch.Generator().manual_seed(0), device=device),
                          TrainConfig(learning_rate=1e-3, warmup_steps=1))
        state = trainer.init_state()
        p0 = state.params.clone()
        losses = []
        _cuda.reset_launches()
        for i in range(3):
            if mode == "eager":
                state, metrics, _ = trainer.train_step(state, to_torch(batch_np, device), 1.0)
            else:
                state, metrics, _ = trainer.train_step_fn()(state, batch_np, 1.0)
            losses.append(float(metrics["loss"]))
            if i == 0:
                launches = collections.Counter(_cuda.LAUNCHES)
        runs[mode] = (np.array(losses), (state.params - p0).cpu().numpy(),
                      state.metric_acc.cpu().numpy(), launches, trainer)
    eager, cap = runs["eager"], runs["captured"]
    np.testing.assert_allclose(cap[0], eager[0], rtol=1e-5)
    assert np.linalg.norm(cap[1] - eager[1]) <= 1e-4 * np.linalg.norm(eager[1])
    np.testing.assert_allclose(cap[2], eager[2], rtol=1e-5)
    assert cap[4]._captured[1].launches == eager[3]


# ---------------------------------------------------------------- the rest of training

_SMALL_Q = dict(num_spherical=4, num_radial=4, num_blocks=2, emb_size_atom=32, emb_size_edge=32,
                emb_size_trip=16, emb_size_quad=8, emb_size_rbf=8, emb_size_cbf=8,
                emb_size_sbf=8, emb_size_bil_quad=8, emb_size_bil_trip=16)


@pytest.mark.cuda
def test_captured_mve_step_matches_eager(device):
    """MVE (num_targets=2, two -dE/dR backwards and the grad-of-grad through
    both) with deterministic algorithms: 3 captured steps against 3 eager
    ones from the same weights, the losses within rtol 1e-5, the update
    within a relative L2 error of 1e-4, the 8 metric accumulators within
    rtol 1e-5; the capture recorded the eager step's launches; 2 blocks:
    4 + 16 K1 (the forward's; two per first-backward K2), 8 + 4 + 8 K2 (the
    two backwards'; the forward K1s' VJP; one per first-backward K2) and
    2 x 18 + 12 K3 (the two backwards'; the forward's network gathers)."""
    import collections

    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.training import Trainer

    cfg = ModelConfig(num_targets=2, **_SMALL_Q)
    batch_np = _small_batch(False)
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in ("eager", "captured"):
            trainer = Trainer(GemNet(cfg, generator=torch.Generator().manual_seed(0),
                                     device=device),
                              TrainConfig(learning_rate=1e-3, warmup_steps=1, mve=True))
            state = trainer.init_state()
            p0 = state.params.clone()
            losses = []
            _cuda.reset_launches()
            for i in range(3):
                if mode == "eager":
                    state, metrics, _ = trainer.train_step(state, to_torch(batch_np, device), 1.0)
                else:
                    state, metrics, _ = trainer.train_step_fn()(state, batch_np, 1.0)
                losses.append(float(metrics["loss"]))
                if i == 0:
                    launches = collections.Counter(_cuda.LAUNCHES)
                    per_kernel = _cuda.kernel_launches()
            runs[mode] = (np.array(losses), (state.params - p0).cpu().numpy(),
                          state.metric_acc.cpu().numpy(), launches, trainer, per_kernel)
    finally:
        torch.use_deterministic_algorithms(False)
    eager, cap = runs["eager"], runs["captured"]
    assert eager[5] == {"gemnet_segment_outer_sum_f32": 20,
                        "gemnet_segment_gather_contract_f32": 20,
                        "gemnet_sorted_segsum_f32": 48}
    assert eager[2].shape == (8, 2) and np.isfinite(cap[0]).all()
    np.testing.assert_allclose(cap[0], eager[0], rtol=1e-5)
    assert np.linalg.norm(cap[1] - eager[1]) <= 1e-4 * np.linalg.norm(eager[1])
    np.testing.assert_allclose(cap[2], eager[2], rtol=1e-5)
    assert cap[4]._captured[1].launches == eager[3]


@pytest.mark.cuda
@pytest.mark.parametrize("over", [dict(flat_optimizer=False), dict(agc=True, grad_clip_max=0.02),
                                  dict(agc=True, agc_compat_reference=True, grad_clip_max=0.02)],
                         ids=["tree", "agc", "agc_compat"])
def test_tree_and_agc_steps_on_card_match_cpu(device, over):
    """Three captured steps of the per-tensor optimizer (with global-norm
    clipping, or AGC with either selection) on the card against the same
    steps on the CPU: losses within rtol 1e-4, the whole update within a
    relative L2 error of 1e-3; every moment stays at its address."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    batch_np = _small_batch(False)
    runs = {}
    for dev in ("cpu", device):
        trainer = Trainer(GemNet(ModelConfig(**_SMALL_Q), generator=torch.Generator().manual_seed(0),
                                 device=dev),
                          TrainConfig(learning_rate=1e-3, warmup_steps=1, **over))
        state = trainer.init_state()
        ptrs = [t.data_ptr() for t in state.opt_state.nu_max.values()]
        p0 = state.params.clone()
        losses = []
        for _ in range(3):
            state, loss = trainer.train_on_batch(state, batch_np, 1.0)
            losses.append(float(loss))
        assert [t.data_ptr() for t in state.opt_state.nu_max.values()] == ptrs
        assert int(state.opt_state.count) == 3
        runs[str(dev)] = (np.array(losses), (state.params - p0).cpu().numpy())
    (l_cpu, d_cpu), (l_gpu, d_gpu) = runs["cpu"], runs[str(device)]
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    assert np.linalg.norm(d_gpu - d_cpu) <= 1e-3 * np.linalg.norm(d_cpu)


@pytest.mark.cuda
def test_captured_eval_matches_eager(device):
    """After two steps (EMA apart from the weights): the captured eval of
    the EMA weights and of the current ones against the eager eval
    (deterministic algorithms, metrics rtol 1e-5), each from its own graph
    (keyed on the buffer the parameters are bound to), the parameters bound
    to the trained buffer after; the captured predict against the eager
    one; a second eval replays without a new capture."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    batch_np = _small_batch(False)
    trainer = Trainer(GemNet(ModelConfig(**_SMALL_Q), generator=torch.Generator().manual_seed(0),
                             device=device),
                      TrainConfig(learning_rate=1e-3, warmup_steps=1, ema_decay=0.5))
    state = trainer.init_state()
    for _ in range(2):
        state, _ = trainer.train_on_batch(state, batch_np, 1.0)
    batch = to_torch(batch_np, device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = {}
        for use_ema in (True, False):
            metrics, _ = trainer.eval_step_fn()(state, batch_np, use_ema)
            got[use_ema] = {k: float(v) for k, v in metrics.items()}
            want = {k: float(v) for k, v in trainer.eval_step(state, batch, use_ema)[0].items()}
            for k in want:
                np.testing.assert_allclose(got[use_ema][k], want[k], rtol=1e-5, err_msg=k)
            assert next(trainer.model.parameters()).data_ptr() == state.params.data_ptr()
        assert got[True]["loss"] != got[False]["loss"]
        graphs_before = dict(trainer._forward_captured["eval"])
        assert len(graphs_before) == 2
        trainer.eval_step_fn()(state, batch_np, True)
        assert trainer._forward_captured["eval"] == graphs_before
        E, _, F, _ = trainer.predict_fn()(state, batch_np, use_ema=True)
        E0, _, F0, _ = trainer.predict(state, batch, use_ema=True)
        torch.testing.assert_close(E, E0, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(F, F0, rtol=1e-5, atol=1e-6)
    finally:
        torch.use_deterministic_algorithms(False)
    with pytest.raises(TypeError, match="eval_step"):
        trainer.test_on_batch(state, batch, None)
