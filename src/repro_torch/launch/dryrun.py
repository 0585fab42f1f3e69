"""The dry-run, as ``repro.launch.dryrun``: every (arch x shape x mesh)
cell's partitioning and per-device bytes, and each cell's step on the
card.

The reference lowers and compiles every cell for the 256- and 512-chip
meshes.  The port has no SPMD partitioner, so it splits the work by what
it can show:

  * ``single`` (16x16) and ``multi`` (2x16x16) need no card: the cell's
    strategy (``default_strategy``), its arguments' specs
    (``sharding.partition``) and the bytes one device holds of them,
    ``memory_analysis.argument_size_in_bytes`` (the sum of the local
    shards' bytes, which is what the reference's compiled
    ``memory_analysis`` reports), with ``model_flops``.  Without a
    partitioner no production program exists to count, so these records
    have no roofline terms;
  * ``card`` runs the cell's eager step (``steps.cell_step``) on one H100
    at the cell's sequence length, once counted by ``obs.op_counts``
    (which also warms it up), then once timed.  The batch is cut only as far
    as the card's memory forces (halved while the predicted arguments do
    not fit, then on each out-of-memory error), and every cut is in the
    record's ``reduced``.  A cell whose arguments do not fit at batch 1 is
    skipped before anything is allocated.

``run_manycore`` does the same for the paper's own grid
(``configs/manycore.py``, 1024 x 1024 ``SystolicCell``s on
``GridEngine``): on ``card`` one shard, one epoch timed and counted; on
``single``/``multi`` each shard's state bytes of the 16x16 and 32x16
tilings, from the engine's state on the ``meta`` device.

    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both|card]
    python -m repro_torch.launch.dryrun --arch manycore --mesh card

(with ``src`` on ``PYTHONPATH``).  Records go to
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json`` or ``--out-dir``;
``launch.report`` renders them.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback

from ..configs.registry import ALIASES, ARCH_IDS, SHAPES, get_config, skip_reason
from ..core.struct import tree_leaves
from ..optim.optimizer import AdamW
from ..sharding import partition as SP
from ..sharding.partition import Strategy
from . import op_analysis as OA
from . import steps as S
from .mesh import make_grid_mesh, make_host_mesh, make_production_mesh, mesh_size

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")
#: The reference's record keys that only a compiled production program
#: gives: absent from ``single``/``multi`` records (``card`` records have
#: the terms, not the XLA compile times or its body-once cost analysis).
NO_PARTITIONER_KEYS = ("lower_s", "compile_s", "useful_ratio", "dominant", "compute_s",
                       "memory_s", "collective_s", "hlo_flops", "hlo_flops_per_chip",
                       "hlo_bytes_per_chip", "collective_wire_bytes", "collective_counts",
                       "collective_raw_bytes", "xla_cost_flops_bodyonce",
                       "xla_cost_bytes_bodyonce")


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D prefill, 2·N_active·B decode."""
    n_active = cfg.active_param_count()
    if shape.step == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.step == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # one token per request


# Per-(arch, shape-kind) strategy overrides found by the reference's §Perf
# hillclimb.  key: (arch_id, step) with None wildcards; first match wins.
STRATEGY_OVERRIDES: list[tuple[str | None, str | None, dict]] = [
    # xlstm-125m: small enough to replicate; pure data parallelism, one
    # gradient all-reduce a step.
    ("xlstm_125m", None, dict(tp=None, dp_all=True, fsdp=False)),
]

# Sequence sharding of the activations for the pure-attention families;
# recurrent and hybrid archs keep it off (a recurrence cannot shard its
# scan axis).
_SP_FAMILIES = {"dense", "moe", "vlm", "audio"}


def default_strategy(cfg, shape, mesh) -> Strategy:
    """The reference's strategy for a cell on ``mesh`` (a mapping)."""
    dp = ("pod", "data") if "pod" in mesh else ("data",)
    arch = getattr(cfg, "name", "").replace(".", "_").replace("-", "_")
    for a, s, kw in STRATEGY_OVERRIDES:
        if (a is None or arch == a or arch.startswith(a)) and (
            s is None or s == shape.step
        ):
            kw = dict(kw)
            if kw.pop("dp_all", False):
                # grow the DP axis set greedily while the global batch
                # still divides it
                dp = ()
                for ax in ("data", "model", "pod"):
                    if ax in mesh:
                        size = 1
                        for a in dp + (ax,):
                            size *= mesh[a]
                        if shape.global_batch % size == 0:
                            dp = dp + (ax,)
            return Strategy(dp=dp, tp=kw.pop("tp", "model"),
                            fsdp=kw.pop("fsdp", True),
                            seq_shard=kw.pop("seq_shard", False))
    sp = (
        getattr(cfg, "family", "") in _SP_FAMILIES
        and shape.step in ("train", "prefill")
    )
    return Strategy(dp=dp, tp="model", fsdp=True, seq_shard=sp)


# ------------------------------------------------------------- arguments
def cell_arguments(cfg, shape, strategy: Strategy, mesh, batch: int | None = None,
                   opt: AdamW | None = None) -> list:
    """[(name, tree, specs)]: the step's arguments as meta tensors (the
    reference's abstract arguments, ``batch`` rows where given) and their
    specs on ``mesh``.  A decode step's position is a () int32, as the
    reference's (the port's step takes a host int)."""
    import torch

    b = batch or shape.global_batch
    params = S.abstract_params(cfg)
    p_specs = SP.param_specs(params, strategy, mesh)
    out = [("params", params, p_specs)]
    if shape.step == "train":
        opt_state = S.abstract_opt_state(cfg, opt or AdamW(), params)
        bshape = dataclasses.replace(shape, global_batch=b)
        return out + [("opt_state", opt_state, SP.opt_specs(p_specs)),
                      ("batch", S.abstract_batch(cfg, shape, b),
                       SP.batch_specs(cfg, bshape, strategy, mesh))]
    dpb = SP._canon(SP._div(b, strategy.dp, mesh))
    if shape.step == "prefill":
        inputs = S.abstract_batch(cfg, shape, b)["inputs"]
        return out + [("inputs", inputs, (dpb,) + (None,) * (inputs.dim() - 1))]
    states = S.abstract_decode_state(cfg, b, shape.seq_len)
    meta = dict(dtype=torch.int32, device="meta")
    return out + [("states", states, SP.decode_state_specs(states, cfg, strategy, mesh)),
                  ("token", torch.empty((b,), **meta), (dpb,)),
                  ("pos", torch.empty((), **meta), ())]


def argument_bytes(args: list, mesh) -> int:
    """Bytes one device holds of the cell's arguments under their specs."""
    return sum(SP.argument_bytes(tree, specs, mesh) for _, tree, specs in args)


def allocated_bytes(*trees) -> int:
    """Device bytes the tensors of ``trees`` take: each distinct storage's
    size once (the allocator's rounding apart)."""
    import torch

    seen = {}
    for t in tree_leaves(list(trees)):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


# ------------------------------------------------------------- LM cells
def run_lm_cell(arch: str, shape_name: str, mesh_kind: str,
                strategy: Strategy | None = None, *, batch: int | None = None,
                device="cuda") -> dict:
    """The record of one LM cell on ``mesh_kind`` (``single``, ``multi``
    or ``card``; ``device`` and ``batch``, a first batch to try, are
    ``card``'s)."""
    arch_id = ALIASES.get(arch, arch)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind}
    reason = skip_reason(arch_id, shape_name)
    if reason:
        rec.update(status="skipped", reason=reason)
        return rec
    cfg = get_config(arch_id)
    try:
        if mesh_kind == "card":
            _card_cell(rec, cfg, shape, strategy, batch, device)
        else:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
            strategy = strategy or default_strategy(cfg, shape, mesh)
            args = cell_arguments(cfg, shape, strategy, mesh)
            rec.update(status="ok", step_kind=S.STEP_KINDS[shape.step],
                       n_chips=mesh_size(mesh), model_flops=model_flops(cfg, shape),
                       strategy=dataclasses.asdict(strategy),
                       memory_analysis={"argument_size_in_bytes": argument_bytes(args, mesh)})
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


def _card_cell(rec: dict, cfg, shape, strategy, batch, device) -> None:
    import torch

    from ..core.device import resolve_device

    dev = resolve_device(device)
    mesh = make_host_mesh()
    strategy = strategy or default_strategy(cfg, shape, mesh)
    budget = (torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda"
              else None)
    b = batch or shape.global_batch
    predict = lambda n: argument_bytes(cell_arguments(cfg, shape, strategy, mesh, n),  # noqa: E731
                                       mesh)
    reduced = []
    if budget is not None:
        while b > 1 and predict(b) > budget:
            b //= 2
        if predict(b) > budget:
            rec.update(status="skipped", reason=(
                f"arguments {predict(b) / 1e9:.1f} GB at batch {b} exceed the card's "
                f"{budget / 1e9:.1f} GB"))
            return
    while True:
        try:
            out = _run_card_step(cfg, shape, mesh, strategy, b, dev)
            break
        except torch.cuda.OutOfMemoryError:
            if b == 1:
                raise
        # past the handler, whose traceback held the failed attempt's tensors
        gc.collect()
        torch.cuda.empty_cache()
        b //= 2
    if b != shape.global_batch:
        reduced.append(f"batch {shape.global_batch} -> {b}: the card's memory")
    run_shape = dataclasses.replace(shape, global_batch=b)
    counts = out.pop("counts")
    terms = OA.roofline_terms(counts, 1)
    mf = model_flops(cfg, run_shape)
    rec.update(status="ok", step_kind=S.STEP_KINDS[shape.step], n_chips=1, batch=b,
               reduced=reduced, device=_device_name(dev),
               strategy=dataclasses.asdict(strategy), model_flops=mf,
               useful_ratio=mf / terms["hlo_flops"] if terms["hlo_flops"] else None,
               dominant=OA.dominant_term(terms), ops=counts.ops, kernels=counts.kernels,
               memory_analysis={"argument_size_in_bytes": predict(b), **out.pop("memory")},
               **out, **terms)


def _measure(call, dev) -> tuple[float, OA.Counts, int | None]:
    """``call()`` once counted, which also warms it up, then once timed
    (host wall to a device synchronize): (step s, counts, the peak bytes
    of the two on a card)."""
    import torch

    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    with OA.count() as counts:
        call()
    sync()
    t0 = time.perf_counter()
    call()
    sync()
    step_s = time.perf_counter() - t0
    return step_s, counts, torch.cuda.max_memory_allocated(dev) if on_card else None


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _run_card_step(cfg, shape, mesh, strategy, b: int, dev) -> dict:
    """The cell's step at batch ``b`` built and measured (``_measure``),
    with its arguments' bytes."""
    import torch

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    step, args, _ = S.cell_step(cfg, shape, mesh, strategy, dev, batch=b)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    allocated = allocated_bytes(args)
    try:
        step_s, counts, peak = _measure(lambda: step(*args), dev)
    finally:
        del args, step
    return {"build_s": build_s, "step_s": step_s, "counts": counts,
            "memory": {"argument_allocated_bytes": allocated, "peak_bytes": peak}}


# ------------------------------------------------------------- manycore
def run_manycore(mesh_kind: str, config=None, device="cuda") -> dict:
    """The paper's grid of ``SystolicCell``s on ``GridEngine``
    (``config``: ``configs.manycore.CONFIG`` by default): on ``card`` one
    shard on ``device``, an epoch measured as a cell's step (``_measure``);
    on ``single`` and ``multi`` the state bytes of each shard of the 16x16
    and 32x16 tilings (meta tensors)."""
    import numpy as np
    import torch

    from ..configs.manycore import CONFIG
    from ..core.device import resolve_device
    from ..core.distributed import GridEngine
    from ..hw.systolic import SystolicCell, SystolicParams

    cfg = config or CONFIG
    R, C, M, K = cfg.grid_rows, cfg.grid_cols, cfg.m_stream, cfg.k_epoch
    rec: dict = {"arch": "manycore", "shape": f"grid{R}x{C}", "mesh": mesh_kind}
    try:
        mesh = None if mesh_kind == "card" else make_grid_mesh(
            *((32, 16) if mesh_kind == "multi" else (16, 16)))
        dev = resolve_device(device if mesh_kind == "card" else "meta")
        eng = GridEngine(SystolicCell(m_stream=M), R, C, mesh, K=K,
                         capacity=cfg.queue_capacity, device=dev)
        # the reference's zero operands (make_cell_params(zeros, zeros)),
        # made on the device: the host copy of a_buf alone is 4 GiB
        zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        rr, cc = np.meshgrid(np.arange(R), np.arange(C), indexing="ij")
        flag = lambda m: torch.as_tensor(m).to(dev)  # noqa: E731
        params = SystolicParams(b=zeros(R, C), is_west=flag(cc == 0), is_north=flag(rr == 0),
                                is_south=flag(rr == R - 1), is_east=flag(cc == C - 1),
                                a_buf=zeros(R, C, M))
        t0 = time.perf_counter()
        state = eng.init(0, params)
        del params
        rec.update(status="ok", step_kind=f"epoch(K={K})", cores=R * C,
                   n_chips=1 if mesh is None else mesh_size(mesh))
        if mesh is not None:
            shards = [sum(x.numel() * x.element_size() for x in tree_leaves(sh))
                      for sh in state.shards]
            rec["memory_analysis"] = {"argument_size_in_bytes": max(shards)}
            return rec
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        held = [state]

        def epoch():
            held[0] = eng.run_epochs(held[0], 1)

        del state
        step_s, counts, peak = _measure(epoch, dev)
        terms = OA.roofline_terms(counts, 1)
        rec.update(build_s=build_s, step_s=step_s, ops=counts.ops, device=_device_name(dev),
                   memory_analysis={"argument_size_in_bytes": allocated_bytes(held),
                                    "peak_bytes": peak},
                   dominant=OA.dominant_term(terms), **terms)
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    return rec


# ------------------------------------------------------------- records
def save(rec: dict, out_dir: str | None = None) -> str:
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return path


def _fmt(x, spec: str) -> str:
    return "-" if x is None else format(x, spec)


def summary(rec: dict) -> str:
    """One line a record; ``-`` for what a record lacks."""
    head = f"{rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:6s}"
    if rec["status"] == "ok":
        gb = rec.get("memory_analysis", {}).get("argument_size_in_bytes", 0) / 1e9
        dom = rec.get("dominant")
        return (f"OK   {head} dom={dom[:-2] if dom else '-':10s} "
                f"comp={_fmt(rec.get('compute_s'), '.3e')}s "
                f"mem={_fmt(rec.get('memory_s'), '.3e')}s "
                f"coll={_fmt(rec.get('collective_s'), '.3e')}s args/dev={gb:.2f}GB "
                f"step={_fmt(rec.get('step_s'), '.4f')}s")
    if rec["status"] == "skipped":
        return f"SKIP {head} ({rec['reason'][:60]})"
    return f"FAIL {head} {rec['error'][:100]}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both", "card"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="card: the first batch to try (the shape's by default)")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    jobs: list = []
    if args.all:
        for arch in ARCH_IDS:
            if arch == "manycore":
                continue
            jobs.extend((arch, shape, mk) for shape in SHAPES for mk in meshes)
        jobs.extend(("manycore", None, mk) for mk in meshes)
    else:
        arch = args.arch or "llama3.2-1b"
        if ALIASES.get(arch, arch) == "manycore":
            jobs = [("manycore", None, mk) for mk in meshes]
        else:
            shapes = [args.shape] if args.shape else list(SHAPES)
            jobs = [(arch, s, mk) for s in shapes for mk in meshes]

    for arch, shape, mk in jobs:
        if arch == "manycore":
            rec = run_manycore(mk)
        else:
            rec = run_lm_cell(arch, shape, mk, batch=args.batch)
        save(rec, args.out_dir)
        print(summary(rec), flush=True)


if __name__ == "__main__":
    main()
