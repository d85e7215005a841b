"""Every file a cell names parses and resolves, ``BENCHMARK.json`` keeps to
the benchmark's rules, and each configuration's port section is the
published configuration as run."""
import json
import math
import re

import pytest

from bench import spec
from bench_cells import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_has_the_contracts_keys_and_shapes(bench_json):
    assert set(bench_json) == {"command", "paths", "run_seconds", "configs", "workloads",
                               "end_to_end", "per_layer"}
    assert bench_json["paths"] == ["bench"]
    assert 1 <= bench_json["run_seconds"] <= 51
    assert len(json.dumps(bench_json)) < 64 * 1024
    names = [c["name"] for c in bench_json["configs"]]
    names += [w["name"] for w in bench_json["workloads"]]
    names += [m["name"] for m in bench_json["end_to_end"] + bench_json["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert [w["name"] for w in bench_json["workloads"]] == list(CELLS)
    for c in bench_json["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in bench_json["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in bench_json["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    e2e = {m["name"] for m in bench_json["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench_json["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(bench_json, cell):
    w = spec.cell(bench_json, cell)
    cfg = spec.config(bench_json, w["config"])
    traffic = spec.traffic(w["traffic"])
    limits = spec.limits(cell)
    assert set(limits) <= {"loss_gap", "first_loss_gap", "grad_gap", "update_gap"}
    assert all(0 < v < 1 for v in limits.values())
    assert hasattr(spec.driver(traffic["driver"]), "run")
    ref = spec.reference(cfg["reference"])
    assert ref.param_specs(cfg)
    assert traffic["global_batch"] % len(traffic["slot_sets"][0]) == 0
    reported = {m["name"] for m in spec.metrics_for(bench_json, cell, False)}
    assert {"setup_s", "train_tokens_per_s"} <= reported
    for m in spec.metrics_for(bench_json, cell, True):
        assert m["moves"] in reported
        assert callable(spec.reader(m["name"]).read)
    for m in spec.metrics_for(bench_json, cell, False):
        assert callable(spec.reader(m["name"]).read)


@pytest.mark.parametrize("name", ["yi-6b.d4.fp32", "granite-moe-3b-a800m.fp32"])
def test_the_port_section_is_the_published_configuration_as_run(bench_json, name):
    cfg = spec.config(bench_json, name)
    entry = [c for c in bench_json["configs"] if c["name"] == name][0]
    assert entry["source"] == cfg["source"]
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    p = cfg["port"]
    same = {"num_layers": "num_hidden_layers", "d_model": "hidden_size",
            "num_heads": "num_attention_heads", "num_kv_heads": "num_key_value_heads",
            "vocab_size": "vocab_size", "rope_theta": "rope_theta",
            "norm_eps": "rms_norm_eps", "tie_embeddings": "tie_word_embeddings"}
    for port_key, key in same.items():
        assert p[port_key] == cfg[key], port_key
    assert p["vocab_pad_to"] == cfg["departures"]["vocab_pad_to"]["as_run"]
    assert p["dtype"] == cfg["assumed"]["dtype"] == "float32"
    if "num_local_experts" in cfg:
        m = p["moe"]
        assert (m["num_experts"], m["experts_per_token"], m["d_ff_expert"]) == (
            cfg["num_local_experts"], cfg["num_experts_per_tok"], cfg["intermediate_size"])
        assert m["router_aux_weight"] == cfg["router_aux_loss_coef"]
        assert m["capacity_factor"] == cfg["departures"]["moe_capacity_factor"]["as_run"]
        assert p["d_ff"] == 0
        # the reference applies no granitemoe multiplier: each runs neutral
        d = cfg["departures"]
        assert d["embedding_multiplier"]["as_run"] == d["residual_multiplier"]["as_run"] \
            == d["logits_scaling"]["as_run"] == 1.0
        head_dim = cfg["hidden_size"] // cfg["num_attention_heads"]
        assert d["attention_multiplier"]["as_run"] == head_dim ** -0.5
    else:
        assert p["d_ff"] == cfg["intermediate_size"]


@pytest.mark.parametrize("name,params", [("yi-6b.d4.fp32", 1_216_385_024),
                                         ("granite-moe-3b-a800m.fp32", 3_299_182_080)])
def test_the_reference_and_the_port_hold_the_same_parameters(bench_json, name, params):
    from repro_torch.models.params import param_shapes
    from bench.drivers.train import port_config
    cfg = spec.config(bench_json, name)
    want = {k: s[0] for k, s in spec.reference(cfg["reference"]).param_specs(cfg).items()}
    assert param_shapes(port_config(cfg)) == want
    assert sum(math.prod(s) for s in want.values()) == params


def test_the_warmup_schedule_is_the_ports(bench_json):
    from repro_torch.optim import warmup_cosine
    from bench.reference.decoder import dims, lr_at
    cfg = spec.config(bench_json, "yi-6b.d4.fp32")
    c = dims(cfg)
    for step in (0, 3, 9, 10, 11, 5000, 99_999):
        want = float(warmup_cosine(step, peak_lr=c.peak_lr, warmup_steps=c.warmup,
                                   total_steps=c.total))
        assert lr_at(c, step) == pytest.approx(want, rel=1e-6)


def test_a_traffic_mix_is_data(bench_json):
    for w in bench_json["workloads"]:
        path = f"{ROOT}/bench/traffic/{w['traffic']}.json"
        with open(path) as f:
            t = json.load(f)
        assert t["driver"] == "train" and t["seq_len"] > 0 and t["zipf_s"] > 0
