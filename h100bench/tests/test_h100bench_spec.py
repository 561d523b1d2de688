"""BENCHMARK.json against the contract's limits, and every cell's files
found by name; the same checks on BENCHMARK.json as it stands once an NDH
cell joins it by appending entries only."""

import copy
import json
import re

import pytest

from h100bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = spec.load_benchmark()
NDH_CELLS = {"ndh_train.mp3d.b128.t10": ("nav_actions_per_s", "ndh_train"),
             "ndh_eval.mp3d.b256.t40": ("episodes_per_s", "ndh_eval")}
NDH_UNITS = {"nav_actions_per_s": "actions/s", "episodes_per_s": "episodes/s"}


def with_ndh_cell(name: str) -> dict:
    """BENCHMARK.json with the NDH cell ``name`` joined as a later PR joins
    it: its configuration and cell at the end of their lists, its rate at
    the end of ``end_to_end`` with ``workloads`` naming the cell (the bound
    here is the contract's cap; the joining PR sets it from its spreads),
    and per-layer entries (the pretraining cell's metrics that have an NDH
    reader) at the end of ``per_layer``."""
    bench = copy.deepcopy(BENCH)
    rate, loop = NDH_CELLS[name]
    if not any(c["name"] == "visitron-ndh" for c in bench["configs"]):
        with open(spec.HERE / "configs" / "visitron-ndh.json") as f:
            source = json.load(f)["source"]
        bench["configs"].append({"name": "visitron-ndh", "source": source,
                                 "file": "h100bench/configs/visitron-ndh.json", "reduced": [],
                                 "why": "the NDH agent: BERT encoder, LSTM and attention decoder"})
    bench["workloads"].append({"name": name, "config": "visitron-ndh", "traffic": name,
                               "chips": 1, "why": "an NDH loop on the Matterport-scale world"})
    bench["end_to_end"].append({"name": rate, "unit": NDH_UNITS[rate], "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": [name]})
    for m in list(bench["per_layer"]):
        metric = m["name"].rsplit(".", 1)[0] + "." + loop
        if (spec.HERE / "metrics" / f"{metric}.py").exists():
            bench["per_layer"].append({**m, "name": metric, "moves": rate, "workloads": [name]})
    return bench


BENCHES = {"committed": BENCH, **{n: with_ndh_cell(n) for n in NDH_CELLS}}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("bench", BENCHES.values(), ids=BENCHES.keys())
def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128


@pytest.mark.parametrize("bench", BENCHES.values(), ids=BENCHES.keys())
def test_names_units_and_keys(bench):
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names.setdefault(group, set())
            names[group].add(e["name"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["config"] in names["configs"]
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "workloads" in m:
            assert m["workloads"] and set(m["workloads"]) <= names["workloads"], m["name"]
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in names["end_to_end"] and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in names["end_to_end"]
    assert {w["config"] for w in bench["workloads"]} == names["configs"]


@pytest.mark.parametrize("bench,workload", [(b, w["name"]) for b in BENCHES
                                            for w in BENCHES[b]["workloads"]])
def test_cell_files_found_by_name(bench, workload):
    cell = spec.cell(workload, BENCHES[bench])
    assert cell["traffic"]["loop"] in ("ndh_train", "pretrain", "ndh_eval")
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for m in cell["per_layer"]:
        assert m["moves"] in reported


def test_pretrain_cell_reports_what_it_did():
    cell = spec.cell("pretrain.s768.b64")
    assert [m["name"] for m in cell["end_to_end"]] == ["pretrain_tokens_per_s", "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == [
        f"{m}.pretrain" for m in ("mfu", "idle_share", "busy_ms", "kernels_per_step", "gemm_ms",
                                  "elementwise_ms", "optimizer_ms", "attn_roofline",
                                  "ln_roofline", "copy_idle_share", "compute_idle_share",
                                  "h2d_mb")]


def test_ndh_rates_wait_for_their_cells():
    rates = {m["name"] for m in BENCH["end_to_end"]}
    for rate, _ in NDH_CELLS.values():
        assert rate not in rates and callable(spec.reader(rate))


@pytest.mark.parametrize("name", NDH_CELLS)
def test_ndh_cell_joins_with_its_rate_alone(name):
    bench = with_ndh_cell(name)
    cell = spec.cell(name, bench)
    rate = NDH_CELLS[name][0]
    assert sorted(m["name"] for m in cell["end_to_end"]) == sorted([rate, "setup_s"])
    assert {m["moves"] for m in cell["per_layer"]} == {rate}
    assert spec.cell("pretrain.s768.b64", bench) == spec.cell("pretrain.s768.b64")
