"""``launch.op_analysis`` and ``obs.op_counts`` on the CPU: the counted FLOPs of the mini cells
(2-3 layers at the smoke widths, vocab 512, 8 x 64) against the reference's
``hlo_analysis.roofline_terms(...)["hlo_flops"]`` on a one-device mesh with
Auto axes: the train steps of llama3.2-1b and recurrentgemma-2b exactly,
and each prefill and decode cell exactly or by the terms the port counts
that the reference's optimized HLO does not (``extra``); the kernels'
reports (``plain_counts`` of each kernel module) against their plain
versions counted directly; the counter's model of an op; the terms."""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as j_get_config
from repro.configs.registry import ShapeSpec as JShapeSpec
from repro.launch import hlo_analysis as HA
from repro.launch.steps import lower_cell
from repro.sharding.partition import Strategy as JStrategy
from repro_torch.configs.registry import ShapeSpec, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lm_checks
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import slstm_scan as sl
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import steps as S
from repro_torch.obs import op_counts as OC
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.sharding.partition import Strategy

B, T = 8, 64
LAYERS = {"llama3.2-1b": 2, "recurrentgemma-2b": 3, "xlstm-125m": 2}


def extra(cfg, step: str) -> int:
    """FLOPs the eager port counts beyond the reference's optimized HLO:

    * prefill, each attention layer: ``_attention_prefill`` projects k and
      v for the cache, and ``attention_fwd`` projects them again; XLA's CSE
      merges the two pairs of products, the eager port runs both;
    * decode, each mLSTM layer: the outer product k v^T of the recurrent
      update, a matmul with a contraction of 1 in the port
      (``k[..., :, None] @ v[..., None, :]``), a multiply in XLA's HLO;
    * train, each mLSTM layer: the gradient of ``n_inter = einsum("bchd,
      bhd->bch", q, n0)`` with respect to q, an outer product with no
      contraction: a ``bmm`` in the port's autograd, a multiply in XLA's.
    """
    kinds = [k for pattern, n in M.segments_of(cfg) for k in pattern * n]
    n_attn = sum(k in M.ATTN_KINDS for k in kinds)
    n_mlstm = kinds.count("mlstm")
    hd_m = 2 * cfg.d_model // cfg.n_heads
    if step == "prefill":
        return n_attn * 2 * (2 * B * T * cfg.d_model * cfg.n_kv_heads * cfg.head_dim)
    if step == "decode":
        return n_mlstm * 2 * B * cfg.n_heads * hd_m * hd_m
    return n_mlstm * 2 * B * T * cfg.n_heads * hd_m


def _hlo_and_count(arch: str, layers: int, step: str):
    """The reference's ``hlo_flops`` of the mini cell on a one-device Auto
    mesh, the port's counts of the same cell, and the port's config."""
    over = dict(n_layers=layers, vocab=512)
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), **over)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    lowered, _ = lower_cell(jcfg, JShapeSpec("mini", T, B, step), mesh,
                            JStrategy(dp=("data",)))
    compiled = lowered.compile()
    want = HA.roofline_terms(compiled.cost_analysis(), compiled.as_text(), 1)["hlo_flops"]
    fn, args, _ = S.cell_step(tcfg, ShapeSpec("mini", T, B, step), make_host_mesh(),
                              Strategy(), "cpu")
    with OA.count() as c:
        fn(*args)
    return want, c, tcfg


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(LAYERS))
def test_mini_cell_flops_match_hlo(arch, step):
    want, c, tcfg = _hlo_and_count(arch, LAYERS[arch], step)
    assert c.flops - want == extra(tcfg, step)
    if arch != "xlstm-125m" and step == "train":
        assert c.flops == want  # 452,984,832 and 637,534,208
    assert c.bytes > 0 and c.ops > 0 and c.kernels == {}


@pytest.mark.parametrize("arch,figure", [("llama3.2-1b", 452_984_832),
                                         ("recurrentgemma-2b", 461_373_440)])
def test_two_layer_train_flops_match_hlo(arch, figure):
    """The mini train cell at its 2-layer cut (recurrentgemma-2b's first
    segment then has no stage): the port's count equals the reference's
    ``hlo_flops`` exactly, and both are the figure."""
    want, c, _ = _hlo_and_count(arch, 2, "train")
    assert c.flops == want == figure


def _flash_case(B_, Hq, Hkv, T_, S_, D, causal, window, dtype, transposed):
    g = torch.Generator().manual_seed(0)
    if transposed:  # as the model hands them over: (B, T, H, D) -> (B, H, T, D)
        mk = lambda n, h: torch.randn(B_, n, h, D, generator=g).to(dtype).transpose(1, 2)  # noqa: E731
    else:
        mk = lambda n, h: torch.randn(B_, h, n, D, generator=g).to(dtype)  # noqa: E731
    return (mk(T_, Hq), mk(S_, Hkv), mk(S_, Hkv)), dict(causal=causal, window=window)


FLASH_CASES = [(1, 4, 2, 512, 512, 16, True, None, torch.bfloat16, True),
               (2, 2, 1, 384, 384, 8, True, 200, torch.float32, False),
               (1, 2, 2, 256, 512, 8, False, None, torch.float32, True),
               (1, 2, 1, 640, 640, 8, True, 256, torch.bfloat16, True),
               (1, 2, 2, 256, 256, 8, True, None, torch.float32, False)]


def _direct(fn, *args, **kw):
    with OA.count() as c:
        fn(*args, **kw)
    return c.flops, c.bytes, c.ops


def _fit(c):
    return c.flops, c.bytes, c.ops


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_report_equals_its_plain_version(case):
    """What the kernel reports at a call (``plain_counts``: runs at up to
    3 x 3 blocks on the call's device, fitted in the blocks and visible
    pairs) equals the plain version counted directly at the call, FLOPs,
    bytes and ops."""
    (q, k, v), kw = _flash_case(*case)
    sig = OC.signature
    for lse in (False, True):
        got = fa.plain_counts("cpu", sig(q), sig(k), sig(v), kw["causal"], kw["window"],
                              None, 128, 128, lse)
        assert _fit(got) == _direct(fa.flash_attention_ref, q, k, v, return_lse=lse, **kw)


@pytest.mark.parametrize("case", [(2, 1024, 64, True, torch.float32),
                                  (1, 768, 32, False, torch.bfloat16),
                                  (1, 128, 32, True, torch.float32)], ids=str)
def test_rglru_report_equals_its_plain_version(case):
    B_, T_, D, h0, dtype = case
    x, a = torch.randn(B_, T_, D).to(dtype), torch.rand(B_, T_, D).to(dtype)
    hh = torch.randn(B_, D) if h0 else None
    sig = OC.signature
    got = rg.plain_counts("cpu", sig(x), sig(a), sig(hh), 256, 256)
    assert _fit(got) == _direct(rg.rglru_scan_ref, x, a, hh)


@pytest.mark.parametrize("case", [(2, 40, 32, 4, torch.float32), (1, 7, 16, 2, torch.bfloat16),
                                  (2, 1, 16, 4, torch.float32)], ids=str)
def test_slstm_report_equals_its_plain_version(case):
    B_, T_, d, H, rdt = case
    r = {g: torch.randn(H, d // H, d // H).to(rdt) for g in sl.GATES}
    pre = torch.randn(B_, T_, 4, d)
    carry = (torch.zeros(B_, d), torch.zeros(B_, d), torch.zeros(B_, d),
             torch.full((B_, d), -float("inf")))
    sig = OC.signature
    got = sl.plain_counts("cpu", tuple(sig(r[g]) for g in sl.GATES), sig(pre),
                          tuple(map(sig, carry)), 128)
    assert _fit(got) == _direct(sl.slstm_scan_ref, r, pre, carry, block_t=T_)


def test_kernel_report_replaces_the_launch():
    """``kernel``: the launch's own ops are not counted, the plain
    version's counts are, and the call is named; nothing is active
    outside a counter."""
    assert OC.active is None
    with OC.count() as c:
        out = OC.kernel("k", lambda: torch.ones(64, 64) @ torch.ones(64, 64),
                        lambda: OC.Counts(7, 11, 1))
        assert OC.active is c
    assert OC.active is None
    assert out.shape == (64, 64)
    assert (c.flops, c.bytes, c.ops, c.kernels) == (7, 11, 1, {"k": 1})


def test_the_op_model():
    """FLOPs as ``FlopCounterMode`` gives them (forward and backward);
    bytes: each op's inputs and outputs, views and allocations free, an
    in-place op's output once."""
    a = torch.ones(8, 16, requires_grad=True)
    b = torch.ones(16, 4)
    with OA.count() as c:
        y = a @ b  # mm: 2 * 8 * 16 * 4
    assert c.flops == 2 * 8 * 16 * 4 and c.ops == 1
    assert c.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    with OA.count() as c:
        y.sum().backward()  # sum's backward, mm for dA
    assert c.flops == 2 * 8 * 4 * 16
    x = torch.zeros(32)
    with OA.count() as c:
        x.view(4, 8).t()
        torch.empty(100)
        x.add_(1.0)
    assert (c.ops, c.bytes) == (1, 4 * 32)


def test_roofline_terms():
    c = OA.Counts(flops=989_000_000_000, bytes=3_350_000_000)
    terms = OA.roofline_terms(c, 1)
    assert terms["compute_s"] == pytest.approx(1e-3) and terms["memory_s"] == pytest.approx(1e-3)
    ref_keys = set(HA.roofline_terms(None, "", 1)) - {"xla_cost_flops_bodyonce",
                                                       "xla_cost_bytes_bodyonce"}
    assert set(terms) == ref_keys
    assert terms["collective_s"] == 0.0 and terms["hlo_flops_per_chip"] == c.flops
    terms["memory_s"] *= 2
    assert OA.dominant_term(terms) == HA.dominant_term(terms) == "memory_s"


def test_count_paths_on_the_cpu():
    """On the CPU both paths run the plain versions: the same counts, the
    kernel modules' dispatchers restored after."""
    tcfg = dataclasses.replace(get_config("recurrentgemma-2b", smoke=True), use_kernels=True,
                               rnn_width=256, attn_window=96)

    def run():
        fn, args, _ = S.cell_step(tcfg, ShapeSpec("k", 256, 1, "train"), make_host_mesh(),
                                  Strategy(), "cpu")
        fn(*args)

    before = (fa.flash_attention, rg.rglru_scan, sl.slstm_scan)
    kern, plain = lm_checks.count_paths(run)
    assert (fa.flash_attention, rg.rglru_scan, sl.slstm_scan) == before
    assert (kern.flops, kern.bytes, kern.ops) == (plain.flops, plain.bytes, plain.ops)
