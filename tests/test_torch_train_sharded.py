"""The sharded trainer on one device, against the JAX package on the CPU:
``launch.train.make_trainer(cfg, opt, mesh=make_host_mesh(), strategy)``
runs the reference's sharding hook (``sharding.partition.make_constrain``
resolving each spec and leaving the tensor as it is) and is held against
the reference's ``make_trainer`` on a one-device mesh with Auto axes (3
steps, losses within 1e-4) and, bit for bit, against the port's unsharded
trainer.  A mesh of more than one device raises ``NotImplementedError``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as j_get_config
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import train as j_train
from repro.models import model as JM
from repro.optim.optimizer import AdamW as JAdamW
from repro.sharding.partition import Strategy as JStrategy
from repro_torch.configs.registry import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.struct import tree_paths
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import make_trainer
from repro_torch.optim.optimizer import AdamW
from repro_torch.sharding import partition as SP
from test_torch_train_grads import flatten

STEPS = 3


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-235b-a22b"])
def test_one_device_trainer_matches_jax_and_the_unsharded_one(arch):
    """3 steps from the JAX weights on the reference pipeline's batches:
    the port's one-device sharded trainer (sequence sharding on, and for
    the MoE the dispatch and combine hooks) against the reference's
    sharded trainer, and against the port's unsharded trainer, whose
    losses and parameters it must equal exactly."""
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=STEPS)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    strategy = SP.Strategy(seq_shard=True)
    jstep = jax.jit(j_train.make_trainer(jcfg, JAdamW(**kw), mesh=jmesh,
                                         strategy=JStrategy(seq_shard=True)))
    jparams = JM.init_params(jcfg, jax.random.key(0))
    jstate = JAdamW(**kw).init(jparams)
    runs = {}
    for name, trainer in (("sharded", make_trainer(tcfg, AdamW(**kw), make_host_mesh(),
                                                   strategy)),
                          ("plain", make_trainer(tcfg, AdamW(**kw)))):
        params = lm_params_from_numpy(tcfg, flatten(jparams), device="cpu")
        state = AdamW(**kw).init(params)
        pipe = JTokenPipeline(JPipelineConfig(vocab=jcfg.vocab, seq_len=32, global_batch=2))
        losses = []
        for _ in range(STEPS):
            b = {k: torch.from_numpy(v) for k, v in pipe.batch().items()}
            params, state, m = trainer(params, state, b)
            losses.append(float(m["loss"]))
        runs[name] = (losses, params)
    pipe = JTokenPipeline(JPipelineConfig(vocab=jcfg.vocab, seq_len=32, global_batch=2))
    jlosses = []
    for _ in range(STEPS):
        jparams, jstate, jm = jstep(jparams, jstate, jax.tree.map(jnp.asarray, pipe.batch()))
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose(runs["sharded"][0], jlosses, rtol=1e-4)
    assert runs["sharded"][0] == runs["plain"][0]
    for (path, a), (_, b) in zip(tree_paths(runs["sharded"][1]), tree_paths(runs["plain"][1])):
        assert torch.equal(a, b), path


def test_train_step_takes_a_constrain_hook():
    """``make_train_step(constrain=...)``: every hook point the model has
    is called with the reference's kinds, and the step is the plain one."""
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    opt = AdamW()
    seen = []
    hook = SP.make_constrain(SP.Strategy(), make_host_mesh(), seq_len=16)

    def constrain(x, kind):
        seen.append(kind)
        return hook(x, kind)

    outs = []
    for c in (constrain, None):
        params = S.M.init_params(cfg, 0, device="cpu")
        b = {"inputs": torch.arange(32).reshape(2, 16) % cfg.vocab,
             "labels": torch.arange(32).reshape(2, 16) % cfg.vocab}
        _, _, m = S.make_train_step(cfg, opt, c)(params, opt.init(params), b)
        outs.append(float(m["loss"]))
    assert outs[0] == outs[1]
    assert set(seen) == {"activation", "residual", "dispatch", "combine"}


def test_a_larger_mesh_raises():
    cfg = get_config("llama3.2-1b", smoke=True)
    for mesh in ({"data": 2, "model": 1}, {"data": 1, "model": 2}, {"pod": 2, "data": 1}):
        with pytest.raises(NotImplementedError, match="one card"):
            make_trainer(cfg, AdamW(), mesh, SP.Strategy())
        with pytest.raises(NotImplementedError, match="one card"):
            SP.make_constrain(SP.Strategy(), mesh)
    step = make_trainer(cfg, AdamW(), {"data": 1, "model": 1}, None)  # no strategy: no hook
    assert callable(step)
