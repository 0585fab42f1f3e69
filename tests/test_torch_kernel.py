"""The hand-written kernels (``granule_step``, ``systolic_step``,
``flash_attention``, ``rglru_scan``, ``slstm_scan``) against their plain
PyTorch versions, on the card (``granule_step`` for ManycoreCell,
SystolicCell and programs of several groups).  These tests need a CUDA device and skip
without one (run them there with
``python -m pytest -q -m cuda tests/test_torch_kernel.py``);
``chip_smoke.py`` makes the same checks, through the same
``kernels.systolic_checks`` and ``kernels.lm_checks`` helpers, and at full
width."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.convert import fused_state_to_numpy
from repro_torch.core import ChannelGraph, tiered_grid_partition
from repro_torch.core.fused import FusedEngine
from repro_torch.core.struct import tree_map
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_checks, granule_step, lm_checks, systolic_checks
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import slstm_scan as sl
from repro_torch.kernels import systolic_step as sk
from repro_torch.models import model as lm
from repro_torch.hw.manycore import ManycoreCell, make_core_params
from repro_torch.hw.systolic import SystolicCell, make_cell_params, matmul_error_bound

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _engine(R, C, tiers, cap, overlap):
    vals = ((np.arange(R * C) % 8) + 1).astype(np.float32).reshape(R, C)
    graph = ChannelGraph.torus(ManycoreCell(R, C), R, C,
                               params=make_core_params(vals), capacity=cap)
    return FusedEngine(graph, tiered_grid_partition(R, C, [(2, 1), (2, 2)]),
                       None, tiers=tiers, batch_axes={"pod": 2, "g": 4},
                       overlap=overlap, device="cuda")


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("tiers,cap", [([(("pod",), 1), (("g",), 1)], 2),
                                       ([(("pod",), 2), (("g",), 4)], 4)])
def test_kernel_matches_plain_version(cuda, tiers, cap, overlap):
    """Every state leaf bit-exact after every epoch, through convergence."""
    eng = _engine(16, 16, tiers, cap, overlap)
    gpu = eng.init(0)
    cpu = tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, gpu)
    before = granule_step.launches
    for ep in range(12):
        gpu = eng.run_epochs(gpu, 3)
        cpu = eng.run_epochs(cpu, 3)
        a, b = fused_state_to_numpy(gpu), fused_state_to_numpy(cpu)
        for k in a:
            assert np.array_equal(a[k], b[k]), (ep, k)
    assert granule_step.launches - before == 36


def test_donate_false_keeps_input_on_card(cuda):
    eng = _engine(8, 8, [(("pod",), 2), (("g",), 4)], 8, False)
    st = eng.init(0)
    before = fused_state_to_numpy(st)
    eng.run_epochs(st, 2, donate=False)
    after = fused_state_to_numpy(st)
    assert all(np.array_equal(before[k], after[k]) for k in before)


class _HalfRateCell(ManycoreCell):
    """A many-core cell stepped every other base-clock cycle."""

    clock_divider = 2


@pytest.mark.parametrize("cell_cls", [ManycoreCell, _HalfRateCell])
def test_kernel_single_granule_and_divided_clock(cuda, cell_cls):
    """One granule (no boundary queues: the kernel's register-only path)
    and a divided block clock match the plain version through convergence."""
    R = C = 8
    vals = ((np.arange(R * C) % 8) + 1).astype(np.float32).reshape(R, C)
    graph = ChannelGraph.torus(cell_cls(R, C), R, C,
                               params=make_core_params(vals), capacity=4)
    eng = FusedEngine(graph, None, None, K=4, device="cuda")
    assert eng.n_q == 1 and eng.B == 1
    gpu = eng.init(0)
    cpu = tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, gpu)
    for ep in range(40):
        gpu, cpu = eng.run_epochs(gpu, 1), eng.run_epochs(cpu, 1)
        a, b = fused_state_to_numpy(gpu), fused_state_to_numpy(cpu)
        for k in a:
            assert np.array_equal(a[k], b[k]), (ep, k)
    assert (eng.gather_group(gpu, 0).total == vals.sum()).all()


def test_kernel_odd_cycle_program(cuda):
    """Three cycles an epoch: every program ends on buffer 1 of the
    parity-buffered leaves, which must come back to the carry's tensors;
    bit-exact after every epoch through convergence."""
    eng = _engine(16, 16, [(("pod",), 1), (("g",), 3)], 4, False)
    assert sum(a for op, a in eng._resident_program(0) if op == "C") == 3
    gpu = eng.init(0)
    cpu = tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, gpu)
    for ep in range(400):
        gpu, cpu = eng.run_epochs(gpu, 1), eng.run_epochs(cpu, 1)
        a, b = fused_state_to_numpy(gpu), fused_state_to_numpy(cpu)
        for k in a:
            assert np.array_equal(a[k], b[k]), (ep, k)
        if (eng.gather_group(cpu, 0).phase == 2).all():
            break
    assert (eng.gather_group(gpu, 0).total == ((np.arange(256) % 8) + 1).sum()).all()


class _HalfRateMac(SystolicCell):
    """A systolic cell stepped every other base-clock cycle."""

    clock_divider = 2


@pytest.mark.parametrize("M,R,C,K,tiles", [
    (6, 4, 4, 1, (1, 1)), (33, 17, 23, 3, (1, 1)), (33, 17, 23, 62, (1, 1)),
    (12, 8, 8, 3, (2, 2))])
def test_fused_grid_kernel_matches_plain_version(cuda, M, R, C, K, tiles):
    """``FusedEngine.grid`` of SystolicCells through the kernel against the
    plain version on the card, every leaf bit-exact after every epoch, to
    the end: one-cycle and odd-length calls (each program ends on the
    other parity buffer), a call longer than the run, and 2x2 granules
    batched (boundary queues between SystolicCells); Y within the bound."""
    A, B = fused_checks.operands(M, R, C, seed=M + K)
    eng = FusedEngine.grid(SystolicCell(M), R, C, K=K, capacity=4,
                           params=make_cell_params(A, B),
                           batch_axes={"gr": tiles[0], "gc": tiles[1]})
    epochs, st = fused_checks.check_engine(eng, fused_checks.network_done(eng), 400)
    assert epochs > 0
    Y = fused_checks.grid_result(eng, st, 0, R, C, M)
    Y64 = A.astype(np.float64) @ B.astype(np.float64)
    assert (np.abs(Y - Y64) <= matmul_error_bound(A, B)).all()


@pytest.mark.parametrize("which", ["two_group", "two_group_half_rate", "mixed",
                                   "mixed_2granules"])
def test_several_groups_kernel_matches_plain_version(cuda, which):
    """Programs of several groups in one launch a cycle: two SystolicCell
    groups (the south one on a divided clock, so a producer's pop follows
    its consumer's clock), and ManycoreCell with SystolicCell (two types
    dispatched in one launch, channels between them both ways), on one
    granule and on two batched ones; bit-exact after every epoch."""
    A, B = fused_checks.operands(9, 6, 5, seed=5)
    kw = dict(K=3)
    if which.startswith("two_group"):
        net, _ = fused_checks.two_group_systolic(
            A, B, capacity=4,
            south_cls=_HalfRateMac if which.endswith("half_rate") else None)
    else:
        net, *_ = fused_checks.mixed_network(A, B, 4, 5, capacity=4)
        if which == "mixed_2granules":
            kw.update(partition=np.arange(54) % 2, tiers=[(("g",), 3)],
                      batch_axes={"g": 2})
    eng = net.build(engine="fused", session=False, device="cuda", **kw)
    done = fused_checks.network_done(eng)
    assert fused_checks.check_engine(eng, done, 400)[0] > 0


def _sys_input(M, R, C, tiles, K, epochs, seed):
    """The kernel's input at epoch ``epochs`` of the register engine on
    the card."""
    from repro_torch.core.fastgrid import RegisterGridEngine

    rng = np.random.RandomState(seed)
    A, B = rng.randn(M, R).astype(np.float32), rng.randn(R, C).astype(np.float32)
    eng = RegisterGridEngine(R, C, K=K, m_stream=M, tiles=tiles, device="cuda")
    st = eng.run_epochs(eng.init(A, B), epochs)
    return eng.step_input(st)


@pytest.mark.parametrize("K", [1, 3])
def test_systolic_call_shorter_than_the_plan(cuda, K):
    """K = 1, and K below the plan's k (one launch of K cycles), with
    blocks and halos inside the tile: the call equals the plain version's."""
    st = _sys_input(12, 16, 12, (1, 1), 8, 2, seed=3)
    plan = sk.tile_plan(16, 12, K, k=8, block=(5, 4))
    assert plan.launches == 1
    systolic_checks.check_call(st, K, plan)


def test_systolic_blocks_below_the_tile(cuda):
    """(M, R, C) = (33, 17, 23), one tile cut into 5 x 8 blocks (dividing
    neither side), 3 cycles a launch: bit-exact through completion."""
    plan = sk.tile_plan(17, 23, 7, k=3, block=(5, 8))
    assert plan.block == (5, 8) and plan.launches == 3
    epochs, cycles = systolic_checks.check_engine(33, 17, 23, 7, (1, 1), seed=7,
                                                  plan=plan)
    assert epochs > 0 and cycles == epochs * 7


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_systolic_k_sweep(cuda, k):
    """Every k of the full-width sweep at 2x2 tiles of 9 x 12 cells in 4 x 5
    blocks, K = 16: bit-exact through completion."""
    plan = sk.tile_plan(9, 12, 16, k=k, block=(4, 5))
    epochs, _ = systolic_checks.check_engine(33, 18, 24, 16, (2, 2), seed=k,
                                             plan=plan)
    assert epochs > 0


def test_systolic_mac_is_one_rounding(cuda):
    """The kernel's ``__fmaf_rn`` MAC equals ``mac`` on the card and on the
    CPU (an exact FMA there), and differs from multiply-then-add."""
    assert systolic_checks.check_mac(1 << 20, seed=0) > 0


@pytest.mark.parametrize("tiles", [(1, 1), (2, 2)])
@pytest.mark.parametrize("K", [2, 7, 16])
def test_systolic_kernel_matches_plain_version(cuda, K, tiles):
    """The register engine's epochs through the kernel and through the
    plain version, both on the card: every state leaf equal after every
    epoch, through completion."""
    epochs, cycles = systolic_checks.check_engine(12, 8, 8, K, tiles, seed=K)
    assert epochs > 0 and cycles == epochs * K


@pytest.mark.parametrize("limit", [None, 3])
def test_systolic_kernel_interior_tile(cuda, limit):
    """An interior tile fed only through its slabs, with emission limits
    below K: every output key equal to the plain version's, call by call."""
    limits = None if limit is None else (limit, limit)
    assert systolic_checks.check_interior_tile(limits) > 0


@pytest.mark.parametrize("case", lm_checks.FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain_version(cuda, case):
    """o within the stated tolerance (one bf16 ulp for bf16), lse in f32;
    bf16 through the tensor-core route, f32 through the CUDA-core one."""
    route = fa.route(case[8], case[5])
    before = fa.route_launches[route]
    assert lm_checks.check_flash(case) >= 0.0
    assert fa.route_launches[route] == before + 1


@pytest.mark.parametrize("case", lm_checks.RGLRU_CASES, ids=str)
def test_rglru_kernel_matches_plain_version(cuda, case):
    assert lm_checks.check_rglru(case) >= 0.0


def _rglru_inputs(B, T, D, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(B, T, D).astype(np.float32), device="cuda").to(dtype)
    a = torch.tensor(rng.uniform(0.3, 0.999, (B, T, D)).astype(np.float32),
                     device="cuda").to(dtype)
    h0 = torch.tensor(rng.randn(B, D).astype(np.float32), device="cuda")
    return x, a, h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("chunk", rg.CHUNK_SWEEP)
def test_rglru_kernel_every_chunk(cuda, chunk, dtype):
    """Each chunk size of the sweep (built on request), over several chunks
    and a partial last one."""
    x, a, h0 = _rglru_inputs(2, 700, 40, dtype, chunk)
    assert rg.scan_plan(2, 700, 40, chunk).chunks == -(-700 // chunk)
    assert lm_checks.compare_rglru(x, a, h0, rg.chunk_variant(chunk)) >= 0.0


@pytest.mark.parametrize("shape", [(2, 3072, 64), (4, 3072, 2560)], ids=str)
def test_rglru_kernel_is_deterministic(cuda, shape):
    """The look-back composes the same maps in the same order on every
    call, so repeated calls give the same bits, however the CTAs race."""
    x, a, h0 = _rglru_inputs(*shape, torch.float32, 7)
    a = 0.9 + 0.099 * (a - 0.3) / 0.699  # the model's range: carries reach far
    first = rg.rglru_scan_cuda(x, a, h0)
    for _ in range(5):
        again = rg.rglru_scan_cuda(x, a, h0)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


def test_rglru_scan_plan(cuda):
    """The library's cut: 3,840 CTAs of 256 threads at the served shape."""
    served = rg.scan_plan(4, 3072, 2560)
    assert served == (80, 12, 3840, 256, 256, 3840 * 32 + 1)
    assert rg.scan_plan(3, 1, 37).ctas == 6
    with pytest.raises(ValueError, match="does not take"):
        rg.scan_plan(1, 0, 8)


@pytest.mark.parametrize("case", lm_checks.SLSTM_CASES, ids=str)
def test_slstm_kernel_matches_plain_version(cuda, case):
    """hs, the c/n/m sequences and the final carry, T = 1 included."""
    assert lm_checks.check_slstm(case) >= 0.0


@pytest.mark.parametrize("arch,over,launches", [
    ("recurrentgemma-2b", dict(use_kernels=True, rnn_width=256, attn_window=96),
     {"flash": 1, "rglru": 4, "slstm": 0}),
    ("xlstm-125m", dict(use_kernels=True), {"flash": 0, "rglru": 0, "slstm": 3}),
])
def test_lm_on_the_card_matches_the_cpu(cuda, arch, over, launches):
    """The kernel-aligned smoke configs in f32: prefill (T = 256) and two
    decode steps on the card, through the kernels, give the CPU's logits
    (within 1e-3: cuBLAS sums the f32 products in its own order, on logits
    up to ~60) and tokens; each kernel launched as the shape rules say."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    params = lm.init_params(cfg, 0, device="cpu")
    toks = torch.tensor(np.random.RandomState(1).randint(2, cfg.vocab, (2, 256)))
    mods = {"flash": fa, "rglru": rg, "slstm": sl}
    for mod in mods.values():
        mod.launches = 0
    out = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda x: x.to(dev), params)
            states, logits = lm.prefill(p, cfg, toks.to(dev), 258)
            seq = [logits.cpu()]
            for i in range(2):
                states, logits = lm.decode_step(p, cfg, states, logits.argmax(-1), 256 + i)
                seq.append(logits.cpu())
            out[dev] = seq
    assert {k: m.launches for k, m in mods.items()} == launches
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-3)
        assert (a.argmax(-1) == b.argmax(-1)).all()
