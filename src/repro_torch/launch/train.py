"""Fault-tolerant training driver, as ``repro.launch.train``.

Composes the port's substrates: config registry -> model -> AdamW ->
synthetic data pipeline -> watchdog -> checkpoint/restore loop, on one
device (``"cuda"`` by default; pass ``device="cpu"`` for the CPU).

    python -m repro_torch.launch.train --arch llama3.2-1b --smoke \\
        --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

(with ``src`` on ``PYTHONPATH``).  ``examples/torch_train_pipeline.py``
drives the same entry point end to end, crashes and restores included.
Checkpoints hold {"params", "opt"} and the pipeline's cursor, in the
reference's tree, so a checkpoint the JAX trainer wrote resumes here.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import checkpointing as ckpt
from ..configs.registry import get_config
from ..core.device import resolve_device
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..models import model as M
from ..optim.optimizer import AdamW
from ..runtime.fault_tolerance import FailureInjector, Watchdog, run_resumable
from ..sharding import partition as SP
from .mesh import mesh_size
from .steps import make_train_step


def make_trainer(cfg, opt, mesh=None, strategy=None):
    """The train step of ``cfg`` and ``opt``; with a ``mesh`` and a
    ``strategy``, with the reference's sharding hook
    (``sharding.partition.make_constrain``).  A mesh of one device
    (``launch.mesh.make_host_mesh()``) runs the same step as no mesh; a
    larger one raises ``NotImplementedError`` (the port runs an LM on one
    card and has no SPMD partitioner)."""
    if mesh is not None and mesh_size(mesh) > 1:
        raise NotImplementedError(
            f"a trainer sharded over {mesh_size(mesh)} devices: the port runs an LM "
            "on one card and has no SPMD partitioner")
    constrain = SP.make_constrain(strategy, mesh) if (mesh and strategy) else None
    return make_train_step(cfg, opt, constrain)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(
    arch: str = "llama3.2-1b",
    smoke: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-3,
    ckpt_dir: str | None = None,
    ckpt_every: int = 25,
    fail_at: tuple[int, ...] = (),
    log_every: int = 10,
    seed: int = 0,
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Train ``arch`` for ``steps`` steps on the synthetic stream, with a
    checkpoint every ``ckpt_every`` steps (when ``ckpt_dir`` is given) and a
    ``RuntimeError`` injected at each step of ``fail_at`` (each restart
    restores the latest checkpoint and replays).

    Returns {'final_loss', 'losses', 'restarts', 'steps_run', 'stragglers'}
    as the reference does, plus 'grad_norms' (a float a step run),
    'step_s' (each step's wall seconds, ended by the loss's host read) and
    'setup_s' (the first state: weights and moments on the device)."""
    cfg = get_config(arch, smoke=smoke)
    dev = resolve_device(device)
    opt = AdamW(lr=lr, warmup_steps=max(steps // 20, 2), total_steps=steps)
    pipe_cfg = PipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
        embed_dim=cfg.d_model if cfg.input_mode == "embeddings" else None,
    )
    train_step = make_trainer(cfg, opt)
    injector = FailureInjector(fail_at=fail_at)
    watchdog = Watchdog()
    losses: list[float] = []
    grad_norms: list[float] = []
    step_s: list[float] = []
    stats = {"restarts": 0, "steps_run": 0, "setup_s": None}

    def make_state():
        t0 = time.perf_counter()
        params = M.init_params(cfg, seed, device=dev)
        state = {"params": params, "opt": opt.init(params), "pipe": TokenPipeline(pipe_cfg)}
        _sync(dev)
        if stats["setup_s"] is None:
            stats["setup_s"] = time.perf_counter() - t0
        return state

    def restore_state():
        if ckpt_dir is None or ckpt.latest_step(ckpt_dir) is None:
            return None
        stats["restarts"] += 1 if stats["steps_run"] else 0
        template = make_state()
        tree = {"params": template["params"], "opt": template["opt"]}
        del template
        restored, meta = ckpt.restore(ckpt_dir, tree, from_reference=True)
        pipe = TokenPipeline(pipe_cfg)
        pipe.restore(meta["pipe"])
        return ({"params": restored["params"], "opt": restored["opt"], "pipe": pipe},
                meta["step"])

    def train_one(state, step):
        injector.maybe_fail(step)
        t0 = time.perf_counter()
        batch_np = state["pipe"].batch()
        batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        state["params"], state["opt"], metrics = train_step(
            state["params"], state["opt"], batch_dev)
        loss = float(metrics["loss"])  # a host read: the step has ended
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        stats["steps_run"] += 1
        if verbose and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"gnorm {grad_norms[-1]:.3f}  "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return state

    def save_state(state, step):
        if ckpt_dir is None:
            return
        ckpt.save(ckpt_dir, step, {"params": state["params"], "opt": state["opt"]},
                  meta={"step": step, "pipe": state["pipe"].state()})

    run_resumable(
        total_steps=steps, make_state=make_state, restore_state=restore_state,
        train_one=train_one, save_state=save_state, ckpt_every=ckpt_every,
        watchdog=watchdog,
    )
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "losses": losses,
        "restarts": stats["restarts"],
        "steps_run": stats["steps_run"],
        "stragglers": watchdog.stragglers,
        "grad_norms": grad_norms,
        "step_s": step_s,
        "setup_s": stats["setup_s"],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=False)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(
        arch=args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, fail_at=tuple(args.fail_at), device=args.device,
    )
    print(f"done: final_loss={out['final_loss']:.4f} "
          f"restarts={out['restarts']} steps_run={out['steps_run']}")


if __name__ == "__main__":
    main()
