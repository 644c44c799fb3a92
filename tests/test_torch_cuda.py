"""The CUDA kernels K1, K2, K3 (fp32 and bf16 streams), K4 (the split3 mode
of K1/K2) and the row gathers P1/P2 against their plain PyTorch versions on
the card, and the port end to end on the card against the CPU: serving,
grad-of-grad, and a train step in fp32, bf16 and matmul_precision="high".

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
@pytest.mark.parametrize("S,M", CASES_SO + [(49, 64)])
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
@pytest.mark.parametrize("N,M,R", [(29184, 32, 192512), (100, 8, 1000), (7, 64, 33)])
def test_row_gather_kernels_match_plain(device, N, M, R):
    """P1 and P2 bit-equal to table[idx] (the probe's shape among them)."""
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import row_gather as rg

    rng = np.random.default_rng(N + M + R)
    table = torch.from_numpy(rng.normal(size=(N, M)).astype(np.float32)).to(device).bfloat16()
    idx = torch.from_numpy(rng.integers(0, N, R).astype(np.int32)).to(device)
    _cuda.reset_launches()
    assert torch.equal(rg.gather_rows(table, idx), table[idx.long()])
    assert torch.equal(rg.gather_rows_fm(table.t().contiguous(), idx), table[idx.long()].t())
    assert _cuda.kernel_launches() == {"gemnet_row_gather": 1, "gemnet_row_gather_fm": 1}
    with pytest.raises(TypeError):
        rg.gather_rows(table.float(), idx)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 4, 32, 64])
def test_sorted_segsum_kernel_matches_plain(device, M):
    """Any row width and an n_src that is no multiple of 128."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops import expand_gather as eg

    rng = np.random.default_rng(M)
    n_src, n_rows = 1000, 7000
    idx = rng.integers(0, n_src - 1, n_rows)
    idx[-900:] = 0  # padded rows point at row 0 of their source
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    srt = idx[perm].astype(np.int32)
    plan = segment_plan(srt, n_src, 32, device)
    x = torch.from_numpy(rng.normal(size=(n_rows, M)).astype(np.float32)).to(device)
    tperm, tsrt = torch.from_numpy(perm).to(device), torch.from_numpy(srt).to(device)
    out = eg.sorted_segsum_values(x, tperm, tsrt, plan)
    ref = torch.zeros(n_src, M, device=device).index_add_(0, torch.from_numpy(idx).to(device), x)
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
    """One Trainer step of GemNet-Q on the card against the same step on the
    CPU: the loss within rtol 1e-4 (fp32) and the whole parameter update
    within a relative L2 error of 1e-3 (fp32); bf16 is held to the bf16
    contract of tests/test_bf16.py instead (its roundings differ between the
    card's kernels and the CPU's plain versions), and its losses must fall."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
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
        for _ in range(3):
            state, loss = trainer.train_on_batch(state, to_torch(batch_np, dev), 1.0)
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
    launch split3 (2 blocks: 4 + 8 K1, 4 + 4 + 4 K2) and the K3s exact."""
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
        state, loss = trainer.train_on_batch(state, to_torch(batch_np, dev), 1.0)
        torch.cuda.synchronize()
        runs[str(dev)] = (float(loss), (state.params - p0).cpu().numpy(), _cuda.kernel_launches())
    (l_cpu, d_cpu, n_cpu), (l_gpu, d_gpu, n_gpu) = runs["cpu"], runs[str(device)]
    assert n_cpu == {}
    assert n_gpu == {"gemnet_segment_outer_sum_split3": 12,
                     "gemnet_segment_gather_contract_split3": 12, "gemnet_sorted_segsum_f32": 14}
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    assert np.linalg.norm(d_gpu - d_cpu) <= 1e-3 * np.linalg.norm(d_cpu)
