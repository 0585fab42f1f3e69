"""Kernel-aligned training parity on the CPU: ``use_kernels=True`` with T
and widths that meet the kernels' shape rules (T = 256; recurrentgemma's
``rnn_width`` 256), so the three ``Function``s of ``kernels/ops.py`` run
inside the model (their plain forwards here, their backwards as on the
card), against ``jax.value_and_grad`` of the reference, whose model takes
its blocked attention and custom VJPs.  The checks and tolerances are
``test_torch_train_grads.py``'s; each case also counts the plain versions'
calls, so the kernel modules (and the RG-LRU backward's reverse scan) were
reached."""
import pytest

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import slstm_scan as sl
from test_torch_train_grads import check_against_jax

#: name -> (arch, overrides, plain-version calls (flash, rglru, slstm) of
#: one loss and its gradients, remat recomputing each stage once)
CASES = {
    "llama": ("llama3.2-1b", {}, (4, 0, 0)),
    "rg": ("recurrentgemma-2b", dict(rnn_width=256, attn_window=96), (2, 12, 0)),
    "xlstm": ("xlstm-125m", {}, (0, 0, 2)),
}


@pytest.fixture
def plain_calls(monkeypatch):
    calls = {"flash": 0, "rglru": 0, "slstm": 0}
    for key, mod, fn in (("flash", fa, "flash_attention_ref"),
                         ("rglru", rg, "rglru_scan_ref"),
                         ("slstm", sl, "slstm_scan_ref")):
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, fn, counted)
    return calls


@pytest.mark.parametrize("name", CASES)
def test_kernel_aligned_loss_and_grads_match_jax(name, plain_calls):
    arch, over, want = CASES[name]
    check_against_jax(arch, dict(use_kernels=True, **over), T=256)
    assert (plain_calls["flash"], plain_calls["rglru"], plain_calls["slstm"]) == want
