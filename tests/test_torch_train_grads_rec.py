"""The port's training loss and gradients against the JAX package on the
CPU, for the MoE and recurrent archs at their smoke configs: qwen3-moe
and llama4 (``attn_moe``: the aux loss, the router through top-k, the
scatter's ``index_add_``), xlstm-125m (mLSTM, and the sLSTM through its
``Function`` always, as the reference through its custom VJP) and
recurrentgemma-2b (RG-LRU off the kernel rule, local attention).  The
checks and tolerances are ``test_torch_train_grads.py``'s."""
import pytest

from test_torch_train_grads import check_against_jax


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
                                  "xlstm-125m", "recurrentgemma-2b"])
def test_loss_and_grads_match_jax(arch):
    check_against_jax(arch)
