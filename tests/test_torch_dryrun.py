"""``launch.dryrun`` and ``launch.report`` on the CPU: the ``single`` and
``multi`` records of one architecture a family (the reference's keys, less
those only a compiled production program gives), the reference's
``dryrun_table`` and ``roofline_table`` printing the same rows as the
port's over the same records, the ``card`` path at the smoke size on the
CPU, ``run_manycore`` on a 32 x 32 grid and the command line."""
import dataclasses
import json

import pytest

from repro.launch import hlo_analysis as HA
from repro.launch import report as JR
from repro_torch.configs.manycore import CONFIG
from repro_torch.configs.registry import SHAPES, ShapeSpec, get_config
from repro_torch.launch import dryrun as TD
from repro_torch.launch import report as TR

FAMILY_ARCHS = {"dense": "llama3.2-1b", "vlm": "qwen2-vl-72b", "audio": "hubert-xlarge",
                "moe": "qwen3-moe-235b-a22b", "ssm": "xlstm-125m",
                "hybrid": "recurrentgemma-2b"}
#: the keys of the reference's record of a cell that compiled
REF_KEYS = ({"arch", "shape", "mesh", "status", "step_kind", "n_chips", "lower_s", "compile_s",
             "model_flops", "useful_ratio", "dominant", "memory_analysis"}
            | set(HA.roofline_terms(None, "", 1)))


@pytest.mark.parametrize("family", FAMILY_ARCHS)
def test_single_and_multi_records(family, tmp_path):
    arch = FAMILY_ARCHS[family]
    for shape in SHAPES:
        for mk, chips in (("single", 256), ("multi", 512)):
            rec = TD.run_lm_cell(arch, shape, mk)
            path = TD.save(rec, str(tmp_path))
            assert json.load(open(path))["mesh"] == mk
            if rec["status"] == "skipped":
                assert family == "audio" or shape == "long_500k"
                continue
            assert rec["status"] == "ok", rec.get("trace")
            assert REF_KEYS - set(rec) == set(TD.NO_PARTITIONER_KEYS)
            assert rec["n_chips"] == chips
            assert rec["step_kind"] == {"train": "train_step", "prefill": "prefill",
                                        "decode": "serve_step"}[SHAPES[shape].step]
            assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
            assert rec["model_flops"] == TD.model_flops(get_config(arch), SHAPES[shape])


def _records(tmp_path):
    """Records of every kind: ok, skipped and failed single/multi cells, a
    card record at the smoke size on the CPU and the manycore grid's."""
    recs = [TD.run_lm_cell(a, s, mk) for a in ("llama3.2-1b", "hubert-xlarge")
            for s in ("train_4k", "decode_32k") for mk in ("single", "multi")]
    recs.append({"arch": "gemma_2b", "shape": "train_4k", "mesh": "single",
                 "status": "error", "error": "RuntimeError: for the table"})
    recs.append(card_record())
    recs.append(TD.run_manycore("single", _grid()))
    for r in recs:
        TD.save(r, str(tmp_path))
    return recs


def _grid():
    return dataclasses.replace(CONFIG, grid_rows=32, grid_cols=32, m_stream=32)


def card_record() -> dict:
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True), n_layers=2, vocab=512)
    rec = {"arch": "llama3_2_1b", "shape": "mini", "mesh": "card"}
    TD._card_cell(rec, cfg, ShapeSpec("mini", 64, 8, "train"), None, None, "cpu")
    return rec


def test_tables_print_the_reference_rows(tmp_path, monkeypatch):
    """Given the same records, the reference's tables print the port's
    rows (its roofline table needs the terms: the card records')."""
    _records(tmp_path)
    monkeypatch.setattr(JR, "OUT_DIR", str(tmp_path))
    assert TR.dryrun_table(str(tmp_path)) == JR.dryrun_table()
    assert TR.roofline_table("card", str(tmp_path)) == JR.roofline_table("card")
    rows = TR.roofline_table("single", str(tmp_path)).splitlines()
    ok = [r for r in rows if "| llama3_2_1b | train_4k |" in r]
    assert ok and "| - | - | - | - |" in ok[0]  # no terms without a partitioner


def test_card_path_on_the_cpu():
    """The card path at the smoke size on the CPU: the step warmed up,
    timed and counted, the terms and the predicted bytes beside the
    allocated ones (exactly equal for a train step)."""
    rec = card_record()
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["device"] == "cpu" and rec["batch"] == 8 and rec["reduced"] == []
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == mem["argument_allocated_bytes"]
    assert rec["hlo_flops"] == 452_984_832  # the reference's HLO count of this cell
    assert rec["useful_ratio"] == pytest.approx(rec["model_flops"] / rec["hlo_flops"])
    assert rec["dominant"] in ("compute_s", "memory_s") and rec["kernels"] == {}


def test_run_manycore_on_a_small_grid():
    single, multi = TD.run_manycore("single", _grid()), TD.run_manycore("multi", _grid())
    card = TD.run_manycore("card", _grid(), device="cpu")
    for rec in (single, multi, card):
        assert rec["status"] == "ok", rec.get("trace")
        assert rec["shape"] == "grid32x32" and rec["cores"] == 1024
    assert (single["n_chips"], multi["n_chips"], card["n_chips"]) == (256, 512, 1)
    per_shard = [r["memory_analysis"]["argument_size_in_bytes"] for r in (single, multi, card)]
    assert 0 < per_shard[1] < per_shard[0] < per_shard[2]
    assert card["hlo_bytes_per_chip"] > 0 and card["step_s"] > 0 and card["device"] == "cpu"


def test_command_line(tmp_path, capsys):
    TD.main(["--arch", "xlstm-125m", "--shape", "decode_32k", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("OK   xlstm_125m") == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "xlstm_125m__decode_32k__multi.json", "xlstm_125m__decode_32k__single.json"]
    TR.main(["--out-dir", str(tmp_path)])
    assert "| xlstm_125m | decode_32k | single | OK | 256 |" in capsys.readouterr().out
