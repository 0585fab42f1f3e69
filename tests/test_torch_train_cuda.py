"""Training on the card (``cuda``; these tests skip without a CUDA device,
run them there with ``python -m pytest -q -m cuda tests/test_torch_train_cuda.py``).

The gradient check: each ``Function`` of ``kernels/ops.py`` on CUDA tensors carries
its backward, and its kernel path's gradients equal its plain path's
(``kernels.lm_checks.compare_*_grads``, their tolerances).  Before the
``Function``s the kernels' outputs had no ``grad_fn``, so the same calls
raised.  Then train steps on the card: ``launch.train.train`` at the smoke
size, and a kernel-aligned step whose flash, RG-LRU and sLSTM calls
launch the kernels.  No JAX here: the card has none."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lm_checks
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import slstm_scan as sl
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.optim.optimizer import AdamW

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", lm_checks.FLASH_GRAD_CASES, ids=str)
def test_flash_grads_kernel_vs_plain(cuda, case):
    lm_checks.check_flash_grads(case)


@pytest.mark.parametrize("case", lm_checks.RGLRU_GRAD_CASES, ids=str)
def test_rglru_grads_kernel_vs_plain(cuda, case):
    lm_checks.check_rglru_grads(case)


@pytest.mark.parametrize("case", lm_checks.SLSTM_GRAD_CASES, ids=str)
def test_slstm_grads_kernel_vs_plain(cuda, case):
    lm_checks.check_slstm_grads(case)


def test_train_smoke_on_the_card(cuda, tmp_path):
    out = train("llama3.2-1b", smoke=True, steps=12, batch=4, seq=128,
                ckpt_dir=str(tmp_path), ckpt_every=4, fail_at=(6,), verbose=False)
    assert out["restarts"] == 1 and out["final_loss"] < out["losses"][0]
    assert all(np.isfinite(out["losses"] + out["grad_norms"]))


@pytest.mark.parametrize("arch,over", [
    ("recurrentgemma-2b", dict(rnn_width=256, attn_window=96)),
    ("xlstm-125m", {})])
def test_kernel_aligned_train_step(cuda, arch, over):
    """Two steps with every kernel on its path: launches counted, loss and
    grad norm finite."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), use_kernels=True, **over)
    params = M.init_params(cfg, 0, device="cuda")
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=2)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    pipe = TokenPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=256, global_batch=2))
    before = (fa.launches, rg.launches, sl.launches)
    for _ in range(2):
        b = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch().items()}
        params, state, m = step(params, state, b)
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    after = (fa.launches, rg.launches, sl.launches)
    ran = [a > b for a, b in zip(after, before)]
    assert ran == ([True, True, False] if arch.startswith("recurrent") else
                   [False, False, True])
