"""The op counter on the card (``cuda``; these tests skip without a CUDA
device, run them there with ``python -m pytest -q -m cuda
tests/test_torch_op_analysis_cuda.py``).

A step through the kernels counts what the same step counts through the
kernels' plain versions (``kernels.lm_checks.count_paths``): each launch of
flash attention, the RG-LRU scan and the sLSTM scan reports its plain
version's FLOPs and bytes.  The FLOPs are equal; the bytes differ by one
copy a flash call (``lm_checks.flash_layout_bytes``): the kernel writes o
in (B, H, T, D) order, where the plain version's ``empty_like(q)`` keeps
the caller's (B, T, H, D) memory, so the layer's ``o.transpose(1, 2)
.reshape(...)`` copies o after the kernel only.  Kernel-aligned smoke
configs (T = 256), a train step and a prefill.  No JAX here: the card has
none."""
import dataclasses

import pytest
import torch

from repro_torch.configs.registry import ShapeSpec, get_config
from repro_torch.kernels import lm_checks
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.partition import Strategy

pytestmark = pytest.mark.cuda

CASES = {"llama3.2-1b": (dict(use_kernels=True), {"flash_attention"}),
         "recurrentgemma-2b": (dict(use_kernels=True, rnn_width=256, attn_window=96),
                               {"flash_attention", "rglru_scan"}),
         "xlstm-125m": (dict(use_kernels=True), {"slstm_scan"})}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("step", ["train", "prefill"])
@pytest.mark.parametrize("arch", list(CASES))
def test_kernel_path_counts_its_plain_path(cuda, arch, step):
    over, kernels = CASES[arch]
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)

    def run():
        fn, args, _ = S.cell_step(cfg, ShapeSpec("k", 256, 2, step), make_host_mesh(),
                                  Strategy(), cuda)
        fn(*args)
        torch.cuda.synchronize()

    kern, plain = lm_checks.count_paths(run)
    assert set(kern.kernels) == kernels and plain.kernels == {}
    assert kern.flops == plain.flops
    assert kern.bytes - plain.bytes == lm_checks.flash_layout_bytes(cfg, 2, 256, kern)
