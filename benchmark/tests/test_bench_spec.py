"""``BENCHMARK.json`` against the contract's shapes, and the files it names
found by name."""

import json
import shutil

import pytest

from benchkit import spec as S

BENCH = S.load_spec()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_entry_keys():
    assert set(BENCH) == TOP
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in BENCH["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in BENCH["workloads"])
    e2e = {"name", "unit", "better", "bound", "source"}
    assert all(set(m) - {"workloads"} == e2e for m in BENCH["end_to_end"])
    layer = {"name", "unit", "better", "source", "layer", "moves"}
    assert all(set(m) - {"workloads"} == layer for m in BENCH["per_layer"])
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(S.NAME_RE.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert S.UNIT_RE.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(_line(x) for c in BENCH["configs"] for x in (c["why"], c["source"]))
    assert all(_line(w["why"]) and w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert all(_line(m["layer"]) for m in BENCH["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_each_moves_pairing_is_reported_by_its_cells():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in S.end_to_end_for(BENCH, w)}, (m["name"], w)


def test_each_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        names = {m["name"] for m in S.end_to_end_for(BENCH, w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert S.per_layer_for(BENCH, w["name"])


def test_every_named_file_is_found():
    for w in BENCH["workloads"]:
        cfg = S.config(BENCH, w["config"])
        assert cfg["name"] == w["config"]
        traffic = S.traffic(w["traffic"])
        driver = S.load_module("drivers", traffic["driver"])
        assert callable(driver.run) and callable(driver.readings) and callable(driver.control)
        assert S.limits(w["name"])
    for m in BENCH["per_layer"]:
        assert callable(S.load_module("metrics", m["name"]).read)


def test_new_config_mix_metric_and_cell_need_no_edit(tmp_path):
    """A later change adds files and entries only: the harness finds them."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(S.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(BENCH))
    cfg = dict(S.config(BENCH, "sasrec"), name="sasrec_wide", dim=128, ffn_dim=512)
    (bench_dir / "configs" / "sasrec_wide.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "serve_long.json").write_text(
        json.dumps(dict(S.traffic("serve"), mean_length=60.0)))
    (bench_dir / "limits" / "sasrec_wide.serve_long.json").write_text(
        json.dumps({"model_gap": {"limit": 1.0}}))
    (bench_dir / "metrics" / "shards_per_s.py").write_text(
        "def read(ctx):\n    return ctx.get('shards')\n")
    spec["configs"].append({"name": "sasrec_wide", "source": "x",
                            "file": "benchmark/configs/sasrec_wide.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "sasrec_wide.serve_long", "config": "sasrec_wide",
                              "traffic": "serve_long", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "shards_per_s", "unit": "1/s", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "serve_sessions_per_s",
                              "workloads": ["sasrec_wide.serve_long"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "sasrec.serve" in m["workloads"]:
            m["workloads"].append("sasrec_wide.serve_long")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    loaded = S.load_spec(tmp_path)
    cell = S.workload(loaded, "sasrec_wide.serve_long")
    assert S.config(loaded, cell["config"], tmp_path)["dim"] == 128
    assert S.traffic(cell["traffic"], bench_dir)["mean_length"] == 60.0
    assert S.limits(cell["name"], bench_dir) == {"model_gap": 1.0}
    reader = S.load_module("metrics", "shards_per_s", bench_dir)
    assert reader.read({"shards": 3}) == 3
    assert [m["name"] for m in S.per_layer_for(loaded, cell["name"])] == ["shards_per_s"]
    assert {m["name"] for m in S.end_to_end_for(loaded, cell["name"])} == {
        "serve_sessions_per_s", "serve_shard_p95_ms", "setup_s"}


@pytest.mark.parametrize("name", ["../x", "a b", "", "x/y"])
def test_bad_names_are_refused(name):
    with pytest.raises(ValueError):
        S.traffic(name)
