"""The port's sharding rules and abstract trees against the JAX package's,
on the CPU, for all 10 LM architectures at their published widths:
``launch.steps.abstract_*`` (meta tensors) against ``jax.eval_shape`` of
the reference's trees, leaf for leaf; ``sharding.partition``'s specs
against the reference's ``PartitionSpec`` entries on the 16x16, 2x16x16
and 4x2 meshes; ``default_strategy`` and ``model_flops`` against
``repro.launch.dryrun``'s; ``argument_bytes`` against the local-shard
arithmetic over the reference's own specs and, for the mini train cell,
against JAX's compiled ``memory_analysis`` on 8 fake devices.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` when it is imported, so it is
imported only in the subprocess, which also holds the 8 devices."""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.launch import steps as JS
from repro.optim.optimizer import AdamW as JAdamW
from repro.sharding import partition as JP
from repro_torch.configs.registry import ARCH_IDS, SHAPES, ShapeSpec, get_config, skip_reason
from repro_torch.core.struct import tree_paths
from repro_torch.launch import dryrun as TD
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim.optimizer import AdamW
from repro_torch.sharding import partition as TP

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LM_ARCHS = [a for a in ARCH_IDS if a != "manycore"]
MESHES = {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True),
          "4x2": {"data": 4, "model": 2}}


class RefMesh:
    """What the reference's rules read of a mesh: ``shape[axis]`` and
    ``axis_names``."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def j_paths(tree, is_leaf=None) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                       for p in path)
        out[key] = leaf
    return out


def shapes_of(tree_dict: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree_dict.items()}


def spec_at(specs, path: str):
    """The port's spec at a dotted leaf path of the tree it was made for."""
    node = specs
    for part in path.split("."):
        if dataclasses.is_dataclass(node):
            node = getattr(node, part)
        elif isinstance(node, dict):
            node = node[part]
        else:
            node = node[int(part)]
    return node


def same_specs(tree, port_specs, ref_specs):
    want = {k: tuple(v) for k, v in j_paths(ref_specs, lambda x: isinstance(x, P)).items()}
    got = {p: spec_at(port_specs, p) for p, _ in tree_paths(tree)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])


def ref_local_bytes(shape, dtype, spec, mesh: dict) -> int:
    """One device's bytes of a leaf: each dim over the product of its
    entry's axes (the reference's spec), rounded up."""
    n = np.dtype(dtype).itemsize
    for i, d in enumerate(shape):
        entry = tuple(spec)[i] if i < len(tuple(spec)) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        n *= -(-d // math.prod(mesh[a] for a in axes))
    return n


@pytest.fixture(scope="module")
def reference():
    """The reference's ``default_strategy`` and ``model_flops`` for every
    cell on both production meshes, and the mini train cell's compiled
    ``argument_size_in_bytes`` on a 4x2 mesh of 8 fake devices (Auto
    axes), from one subprocess."""
    code = textwrap.dedent("""
        import dataclasses, json, jax
        from jax.sharding import AxisType
        from repro.configs import ARCH_IDS, SHAPES, get_config, skip_reason
        from repro.configs.registry import ShapeSpec
        from repro.launch.steps import lower_cell
        from repro.sharding.partition import Strategy
        mesh = jax.make_mesh((4, 2), ('data', 'model'), axis_types=(AxisType.Auto,) * 2)
        cfg = dataclasses.replace(get_config('llama3_2_1b', smoke=True), n_layers=2,
                                  vocab=512)
        lowered, _ = lower_cell(cfg, ShapeSpec('mini', 64, 8, 'train'), mesh,
                                Strategy(dp=('data',)))
        out = {'mini_argument_bytes':
               lowered.compile().memory_analysis().argument_size_in_bytes,
               'strategy': {}, 'model_flops': {}}
        import repro.launch.dryrun as D  # its XLA_FLAGS come after jax started

        class M:
            def __init__(self, sizes):
                self.shape, self.axis_names = dict(sizes), tuple(sizes)

        meshes = {'single': M({'data': 16, 'model': 16}),
                  'multi': M({'pod': 2, 'data': 16, 'model': 16})}
        for arch in ARCH_IDS:
            if arch == 'manycore':
                continue
            cfg = get_config(arch)
            for shape in SHAPES:
                if skip_reason(arch, shape):
                    continue
                out['model_flops'][arch + '|' + shape] = D.model_flops(cfg, SHAPES[shape])
                for mk, m in meshes.items():
                    out['strategy']['|'.join((arch, shape, mk))] = dataclasses.asdict(
                        D.default_strategy(cfg, SHAPES[shape], m))
        print('JSON:' + json.dumps(out))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(x for x in out.stdout.splitlines() if x.startswith("JSON:"))
    return json.loads(line[5:])


def strategies(arch: str, mesh: dict) -> list:
    """Each shape's default strategy on ``mesh``, FSDP off and no TP."""
    cfg = get_config(arch)
    out = {TD.default_strategy(cfg, SHAPES[s], mesh) for s in SHAPES}
    dp = ("pod", "data") if "pod" in mesh else ("data",)
    return sorted(out | {TP.Strategy(dp=dp, fsdp=False), TP.Strategy(dp=dp, tp=None)},
                  key=repr)


def j_strategy(s: TP.Strategy) -> JP.Strategy:
    return JP.Strategy(**dataclasses.asdict(s))


# ------------------------------------------------------------- abstract trees
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_trees_match_eval_shape(arch):
    """Params, the optimizer state, each shape's batch and decode state:
    the port's meta trees against ``jax.eval_shape`` of the reference's,
    leaf for leaf (path, shape, dtype); nothing allocated."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jp, tp = JS.abstract_params(jcfg), TS.abstract_params(tcfg)
    assert all(x.device.type == "meta" for _, x in tree_paths(tp))
    assert shapes_of(dict(tree_paths(tp))) == shapes_of(j_paths(jp))
    jo, to = JS.abstract_opt_state(jcfg, JAdamW(), jp), TS.abstract_opt_state(tcfg, AdamW(), tp)
    assert shapes_of(dict(tree_paths(to))) == shapes_of(j_paths(jo))
    for name, shape in SHAPES.items():
        if skip_reason(arch, name):
            continue
        jb = JS.abstract_batch(jcfg, shape)
        assert shapes_of(TS.abstract_batch(tcfg, shape)) == shapes_of(jb)
        if shape.step == "decode":
            js = JS.abstract_decode_state(jcfg, shape.global_batch, shape.seq_len)
            ts = TS.abstract_decode_state(tcfg, shape.global_batch, shape.seq_len)
            assert shapes_of(dict(tree_paths(ts))) == shapes_of(j_paths(js))


# ------------------------------------------------------------- specs
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_match_the_reference(arch):
    """``param_specs`` (and the optimizer state's specs) on the 16x16,
    2x16x16 and 4x2 meshes under each shape's default strategy, FSDP off
    and no TP: every leaf's spec equal to the reference's entries."""
    jp = JS.abstract_params(j_get_config(arch))
    tp = TS.abstract_params(get_config(arch))
    to = TS.abstract_opt_state(get_config(arch), AdamW(), tp)
    for mesh in MESHES.values():
        for s in strategies(arch, mesh):
            ref = JP.param_specs(jp, j_strategy(s), RefMesh(mesh))
            got = TP.param_specs(tp, s, mesh)
            same_specs(tp, got, ref)
            opt = TP.opt_specs(got)
            assert opt.step == ()
            same_specs(to.mu, opt.mu, ref)
            same_specs(to.nu, opt.nu, ref)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_batch_and_decode_state_specs_match_the_reference(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for mesh in MESHES.values():
        for s in strategies(arch, mesh):
            for name, shape in SHAPES.items():
                if skip_reason(arch, name):
                    continue
                ref = JP.batch_specs(jcfg, shape, j_strategy(s), RefMesh(mesh))
                got = TP.batch_specs(tcfg, shape, s, mesh)
                assert got == {k: tuple(v) for k, v in ref.items()}
                if shape.step != "decode":
                    continue
                js = JS.abstract_decode_state(jcfg, shape.global_batch, shape.seq_len)
                ts = TS.abstract_decode_state(tcfg, shape.global_batch, shape.seq_len)
                same_specs(ts, TP.decode_state_specs(ts, tcfg, s, mesh),
                           JP.decode_state_specs(js, jcfg, j_strategy(s), RefMesh(mesh)))


def test_default_strategy_and_model_flops_match_the_reference(reference):
    """Every cell that runs, on both production meshes."""
    n = 0
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if skip_reason(arch, name):
                continue
            assert TD.model_flops(cfg, shape) == reference["model_flops"][f"{arch}|{name}"]
            for mk, mesh in (("single", MESHES["16x16"]), ("multi", MESHES["2x16x16"])):
                want = reference["strategy"][f"{arch}|{name}|{mk}"]
                got = dataclasses.asdict(TD.default_strategy(cfg, shape, mesh))
                assert json.loads(json.dumps(got)) == want, (arch, name, mk)
                n += 1
    assert n == 62  # 31 cells run, on two meshes


# ------------------------------------------------------------- bytes
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_argument_bytes_equal_local_shard_arithmetic(arch):
    """The bytes ``dryrun`` records for a device of each cell on the
    16x16 and 2x16x16 meshes equal the sum, over the reference's abstract
    arguments, of each leaf's local shard under the reference's specs."""
    jcfg = j_get_config(arch)
    for name, shape in SHAPES.items():
        if skip_reason(arch, name):
            continue
        for mk, mesh in (("single", MESHES["16x16"]), ("multi", MESHES["2x16x16"])):
            rec = TD.run_lm_cell(arch, name, mk)
            s = j_strategy(TD.default_strategy(get_config(arch), shape, mesh))
            m = RefMesh(mesh)
            jp = JS.abstract_params(jcfg)
            ps = JP.param_specs(jp, s, m)
            if shape.step == "train":
                args = [(jp, ps), (JS.abstract_opt_state(jcfg, JAdamW(), jp).mu, ps),
                        (JS.abstract_opt_state(jcfg, JAdamW(), jp).nu, ps),
                        (JS.abstract_batch(jcfg, shape), JP.batch_specs(jcfg, shape, s, m))]
                want = 4  # the step counter, replicated
            else:
                dpb = JP._div(shape.global_batch, s.dp, m)
                if shape.step == "prefill":
                    inp = JS.abstract_batch(jcfg, shape)["inputs"]
                    args = [(jp, ps), (inp, P(dpb, *(None,) * (inp.ndim - 1)))]
                    want = 0
                else:
                    st = JS.abstract_decode_state(jcfg, shape.global_batch, shape.seq_len)
                    args = [(jp, ps), (st, JP.decode_state_specs(st, jcfg, s, m))]
                    want = ref_local_bytes((shape.global_batch,), np.int32, P(dpb), mesh) + 4
            for tree, specs in args:
                leaves = jax.tree.leaves(tree)
                spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
                assert len(leaves) == len(spec_leaves)
                want += sum(ref_local_bytes(x.shape, x.dtype, sp, mesh)
                            for x, sp in zip(leaves, spec_leaves))
            got = rec["memory_analysis"]["argument_size_in_bytes"]
            assert got == want, (arch, name, mk, got, want)


def test_mini_cell_bytes_equal_compiled_memory_analysis(reference):
    """The mini train cell (llama3.2-1b smoke, 2 layers, vocab 512, 8 x 64)
    on a 4x2 mesh: the port's prediction from the specs equals JAX's
    compiled ``argument_size_in_bytes``."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True), n_layers=2, vocab=512)
    mesh = MESHES["4x2"]
    args = TD.cell_arguments(cfg, ShapeSpec("mini", 64, 8, "train"),
                             TP.Strategy(dp=("data",)), mesh)
    got = TD.argument_bytes(args, mesh)
    assert got == reference["mini_argument_bytes"]
    parts = {name: TP.argument_bytes(tree, specs, mesh) for name, tree, specs in args}
    # params, then mu and nu (f32 like the smoke weights) and the 4-byte step
    # counter, then 8 x 64 int32 inputs and labels over the 4-way data axis
    assert parts["opt_state"] == 2 * parts["params"] + 4
    assert parts["batch"] == 2 * 8 * 64 * 4 // 4
    assert got == sum(parts.values())


# ------------------------------------------------------------- the hook
def test_local_shape_and_constrain():
    mesh = {"data": 4, "model": 2}
    assert TP.local_shape((8, 6, 5), (("data", "model"), None), mesh) == (1, 6, 5)
    assert TP.local_shape((10, 6), ("data", "model"), mesh) == (3, 3)  # padded
    one = make_host_mesh()
    c = TP.make_constrain(TP.Strategy(seq_shard=True), one, seq_len=16)
    x = torch.zeros(2, 16, 8)
    for kind in ("activation", "residual", "logits", "other"):
        assert c(x, kind) is x
    assert c(torch.zeros(2, 3, 4, 5), "dispatch").shape == (2, 3, 4, 5)
    with pytest.raises(KeyError):  # an axis the mesh lacks, as the reference
        TP.make_constrain(TP.Strategy(dp=("pod", "data")), one)(x, "activation")
    with pytest.raises(ValueError):
        c(torch.zeros(2, 3), "dispatch")
    assert TP.make_constrain(TP.Strategy(), None)(x, "activation") is x
    with pytest.raises(NotImplementedError):
        TP.make_constrain(TP.Strategy(), mesh)
