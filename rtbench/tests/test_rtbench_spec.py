"""The harness finds every configuration, traffic mix, limit file and
per-layer reader by the names BENCHMARK.json gives, and a missing file
fails loudly."""

import copy

import pytest

from rtbench import spec

BENCH = spec.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = spec.load_cell(name, BENCH)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == w["config"]
    assert cell.traffic["name"] == w["traffic"]
    assert cell.traffic["check"] in ("u8", "accumulate")
    assert cell.limits, "every cell's check has limits"
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(spec.load_reader(m["name"]))


def test_configs_match_their_files():
    """BENCHMARK.json's configs name their files, which hold the same
    source and reduced keys."""
    for c in BENCH["configs"]:
        cfg = spec._load_json(spec.config_path(c["name"]), c["name"])
        assert c["file"] == f"rtbench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_per_layer_metrics_move_a_reported_metric():
    """Each per-layer metric moves an end-to-end metric that every one of
    its cells reports."""
    for m in BENCH["per_layer"]:
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert "workloads" not in e2e or cell in e2e["workloads"]


def test_missing_files_fail_loudly():
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "ref_demo.nosuch", "config": "ref_demo",
                               "traffic": "nosuch", "chips": 1, "why": "x"})
    with pytest.raises(FileNotFoundError, match="traffic nosuch"):
        spec.load_cell("ref_demo.nosuch", bench)
    bench["workloads"][-1].update(config="nosuch", traffic="orbit")
    with pytest.raises(FileNotFoundError, match="config nosuch"):
        spec.load_cell("ref_demo.nosuch", bench)
    bench["per_layer"].append({"name": "nosuch_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "x", "moves": "frame_ms"})
    with pytest.raises(FileNotFoundError, match="nosuch_ms"):
        spec.load_cell("ref_demo.orbit", bench)
    with pytest.raises(KeyError, match="no workload"):
        spec.load_cell("nosuch", BENCH)
    with pytest.raises(FileNotFoundError, match="no reader"):
        spec.load_reader("nosuch_ms")


def test_reader_of_a_split_metric():
    """A metric split by the end-to-end metric it moves reads with the
    reader of its name's first part; one of its own comes first."""
    assert spec.metric_path("rt_frame_ms.kernel_paced") == spec.metric_path(
        "rt_frame_ms")
    assert spec.metric_path("rt_frame_ms").endswith("metrics/rt_frame_ms.py")
    assert spec.metric_path("accumulate_ms").endswith(
        "metrics/accumulate_ms.py")
    with pytest.raises(FileNotFoundError, match="no reader"):
        spec.load_reader("nosuch_ms.orbit")
