"""The port's training substrates against the JAX package on the CPU:
``optim.optimizer.AdamW`` (``tests/test_substrates.py``'s cases, and one
update held against the reference's from the same gradients),
``data.pipeline.TokenPipeline`` (batch for batch equal to the
reference's), ``launch.steps.make_train_step`` (5 steps from the same
weights and batches: losses and parameters against JAX's) and
``launch.train.train`` (crashes and restarts, resume determinism as
``tests/test_system.py``, and a checkpoint the JAX trainer wrote resumed
here with the JAX run's next losses)."""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.launch import train as j_train
from repro.models import model as JM
from repro.optim.optimizer import AdamW as JAdamW
from repro_torch.checkpoint import checkpointing
from repro_torch.configs.registry import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.struct import tree_paths
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import make_trainer, train
from repro_torch.models import model as TM
from repro_torch.optim.optimizer import AdamW, AdamWState
from test_torch_train_grads import flatten


# ------------------------------------------------------------- AdamW
def test_adamw_converges_quadratic():
    opt = AdamW(lr=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(150):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = opt.update(grads, state, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)
    assert int(state.step) == 150


def test_adamw_schedule_and_clip():
    opt = AdamW(lr=1.0, warmup_steps=10, total_steps=100, clip_norm=1.0)
    assert float(opt.schedule(torch.tensor(5))) == pytest.approx(0.5)
    assert float(opt.schedule(torch.tensor(10))) == pytest.approx(1.0, rel=1e-2)
    assert float(opt.schedule(torch.tensor(100))) == pytest.approx(0.1, rel=1e-2)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    _, _, m = opt.update({"w": torch.full((4,), 100.0)}, state, params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Three updates from the same parameters and gradients (one step
    clipped): parameters, moments, step, grad norm and lr against the
    reference's; the schedule at every step of a run against JAX's."""
    rng = np.random.RandomState(0)
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (2, 2, 4)}}
    p_np = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))
    grads_np = [jax.tree.map(lambda s: (rng.randn(*s) * k).astype(np.float32), shapes,
                             is_leaf=lambda x: isinstance(x, tuple)) for k in (0.1, 5.0, 0.3)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p_np)
    tp = jax.tree.map(lambda x: torch.tensor(x).to(tdt), p_np)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads_np:
        jp, js, jm = jopt.update(jax.tree.map(lambda x: jnp.asarray(x, jdt), g), js, jp)
        tp, ts, tm = topt.update(jax.tree.map(lambda x: torch.tensor(x).to(tdt), g), ts, tp)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts.step) == int(js.step) == 3
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for (path, g), w in zip(tree_paths(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                       rtol=1e-5, atol=1e-7, err_msg=path)
    for s in range(12):
        assert float(topt.schedule(torch.tensor(s))) == pytest.approx(
            float(jopt.schedule(jnp.asarray(s))), rel=1e-6)


# ------------------------------------------------------------- TokenPipeline
def test_pipeline_batches_equal_the_reference():
    """Batch for batch, including host sharding, the cursor's state and
    restore, explicit steps and the embeddings stub table."""
    for embed_dim in (None, 24):
        kw = dict(vocab=1000, seq_len=64, global_batch=8, seed=3, mean_doc_len=40,
                  embed_dim=embed_dim)
        for host, n_hosts in ((0, 1), (0, 2), (1, 2)):
            j = JTokenPipeline(JPipelineConfig(**kw), host_id=host, n_hosts=n_hosts)
            t = TokenPipeline(PipelineConfig(**kw), host_id=host, n_hosts=n_hosts)
            for _ in range(3):
                bj, bt = j.batch(), t.batch()
                for k in ("inputs", "labels"):
                    assert bt[k].dtype == bj[k].dtype
                    np.testing.assert_array_equal(bt[k], bj[k])
            assert t.state() == j.state() == {"step": 3}
            for k in ("inputs", "labels"):
                np.testing.assert_array_equal(t.batch(step=7)[k], j.batch(step=7)[k])
            t2 = TokenPipeline(PipelineConfig(**kw), host_id=host, n_hosts=n_hosts)
            t2.restore(t.state())
            np.testing.assert_array_equal(t2.batch()["labels"], j.batch()["labels"])
    with pytest.raises(ValueError):
        TokenPipeline(PipelineConfig(vocab=10, seq_len=8, global_batch=3), n_hosts=2)


def test_pipeline_prefetch():
    cfg = PipelineConfig(vocab=100, seq_len=16, global_batch=2)
    it = TokenPipeline(cfg).prefetch(depth=2)
    got = [next(it) for _ in range(3)]
    it.close()
    ref = JTokenPipeline(JPipelineConfig(vocab=100, seq_len=16, global_batch=2))
    for b in got:
        np.testing.assert_array_equal(b["inputs"], ref.batch()["inputs"])


# ------------------------------------------------------------- the train step
def _jax_train_step(jcfg, jopt):
    return jax.jit(j_train.make_trainer(jcfg, jopt))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "xlstm-125m"])
def test_train_step_matches_jax(arch):
    """5 steps of ``make_train_step`` from the JAX weights on the reference
    pipeline's batches: each loss and grad norm, and every parameter after
    the last step, against the JAX trainer's step."""
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=5)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jparams = JM.init_params(jcfg, jax.random.key(0))
    tparams = lm_params_from_numpy(tcfg, flatten(jparams), device="cpu")
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    jstep, tstep = _jax_train_step(jcfg, jopt), make_train_step(tcfg, topt)
    pipe = JTokenPipeline(JPipelineConfig(vocab=jcfg.vocab, seq_len=32, global_batch=2))
    for _ in range(5):
        b = pipe.batch()
        jparams, jstate, jm = jstep(jparams, jstate, jax.tree.map(jnp.asarray, b))
        tparams, tstate, tm = tstep(tparams, tstate,
                                    {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "nll", "z_loss", "grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    # Adam divides each gradient by its own running magnitude, so an
    # element whose gradient is rounding noise moves by a fraction of lr
    # either way: an absolute 1e-5 (lr / 300) beside the relative 1e-4
    want = flatten(jparams)
    for path, p in tree_paths(tparams):
        np.testing.assert_allclose(p.numpy(), want[path], rtol=1e-4, atol=1e-5,
                                   err_msg=path)
    with pytest.raises(NotImplementedError):
        make_trainer(tcfg, topt, mesh={"data": 2})


# ------------------------------------------------------------- train
def test_train_loss_decreases_and_survives_crashes(tmp_path):
    out = train(arch="llama3.2-1b", smoke=True, steps=24, batch=4, seq=64,
                ckpt_dir=str(tmp_path), ckpt_every=8, fail_at=(10, 19), lr=3e-3,
                verbose=False, device="cpu")
    assert out["restarts"] == 2
    assert out["final_loss"] < out["losses"][0]
    assert out["steps_run"] > 24
    assert all(np.isfinite(out["losses"])) and len(out["grad_norms"]) == out["steps_run"]


def test_resume_is_deterministic(tmp_path):
    """A crashed-and-resumed run ends at the same loss as an uninterrupted
    one (the same data cursor, the same parameters)."""
    kw = dict(arch="llama3.2-1b", smoke=True, steps=16, batch=2, seq=32, verbose=False)
    a = train(ckpt_dir=str(tmp_path / "a"), ckpt_every=4, device="cpu", **kw)
    b = train(ckpt_dir=str(tmp_path / "b"), ckpt_every=4, fail_at=(9,), device="cpu", **kw)
    assert a["final_loss"] == pytest.approx(b["final_loss"], rel=1e-5)
    assert b["restarts"] == 1


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX trainer runs 8 steps with a checkpoint every 4; the port's
    ``train`` on that directory, its step-8 checkpoint removed, restores
    step 4 (the JAX package's treedef, read in its leaf order) and runs
    steps 4-7, whose losses must be the JAX run's."""
    kw = dict(arch="llama3.2-1b", smoke=True, steps=8, batch=2, seq=32, lr=3e-3,
              verbose=False)
    ref = j_train.train(ckpt_dir=str(tmp_path / "ck"), ckpt_every=4, **kw)
    shutil.rmtree(tmp_path / "ck" / "step_00000008")
    out = train(ckpt_dir=str(tmp_path / "ck"), ckpt_every=100, device="cpu", **kw)
    assert out["steps_run"] == 4
    np.testing.assert_allclose(out["losses"], ref["losses"][4:], rtol=1e-4)
    # the JAX checkpoint is read only on request
    tcfg = get_config("llama3.2-1b", smoke=True)
    opt = AdamW()
    params = TM.init_params(tcfg, 0, device="cpu")
    template = {"params": params, "opt": opt.init(params)}
    with pytest.raises(ValueError, match="convert"):
        checkpointing.restore(str(tmp_path / "ck"), template, step=4)
    restored, meta = checkpointing.restore(str(tmp_path / "ck"), template, step=4,
                                           from_reference=True)
    assert isinstance(restored["opt"], AdamWState) and int(restored["opt"].step) == 4
    assert meta["pipe"] == {"step": 4}
    bad = {"params": dict(params, extra=torch.zeros(1)), "opt": template["opt"]}
    with pytest.raises(ValueError, match="treedef"):
        checkpointing.restore(str(tmp_path / "ck"), bad, step=4, from_reference=True)
    assert dataclasses.is_dataclass(restored["opt"])
