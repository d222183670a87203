"""Cells, configurations, mixes and metrics are found by name from their
own files; the import check compares whole top-level names."""
import json

import pb_spec
import run


def test_every_cell_finds_its_files():
    bench = pb_spec.benchmark()
    for w in bench["workloads"]:
        c = pb_spec.Cell(bench, w["name"])
        assert c.config["name"] == w["config"]
        assert c.traffic["name"] == w["traffic"]
        for key in ("rows", "slots", "limits", "sample_requests"):
            assert key in c.cell
    names = {c["name"] for c in bench["configs"]}
    assert names == {w["config"] for w in bench["workloads"]}


def test_every_metric_has_a_reader_and_every_cell_its_metrics():
    bench = pb_spec.benchmark()
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(pb_spec.metric_reader(m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for w in bench["workloads"]:
        ends = {m["name"] for m in pb_spec.metrics_for(bench, w["name"],
                                                       False)}
        assert "setup_s" in ends and len(ends) >= 2
        layers = pb_spec.metrics_for(bench, w["name"], True)
        assert layers
        for m in layers:                 # a metric moves one its cell has
            assert m["moves"] in ends


def test_configs_hold_their_source_and_cuts():
    bench = pb_spec.benchmark()
    for c in bench["configs"]:
        with open(pb_spec.ROOT / c["file"]) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert conf["model"]["name"] == c["name"]


def test_import_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.serving",
                                  "reprox", "numpy"]) == []
    assert run.forbidden_modules(["repro", "repro.core.manager", "jax",
                                  "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib", "repro",
        "repro.core.manager"]


def test_harness_imports_no_jax():
    import importlib

    # the test session itself may hold JAX (the repository's oracle
    # tests); the harness's own modules must not bring it in
    for mod in ("pb_correct", "pb_reference", "pb_serve", "pb_trace",
                "pb_traffic", "pb_flops", "pb_weights", "pb_spec"):
        src = open(importlib.import_module(mod).__file__).read()
        assert "import jax" not in src and "from repro." not in src \
            and "import repro\n" not in src
