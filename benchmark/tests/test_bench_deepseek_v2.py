"""The ``deepseek_v2_lite`` configuration and the two cells that came with
it: the nominal count by part against a count by hand, the model's size at
the configuration's widths, the catalog keys against what the model runs,
and on the CPU a tiny ``stream`` cell and a tiny ``deepseek_v2`` training
cell added by files (the second also with its two faults planted)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from .bench_helpers import BENCH, TINY_SERVE, TINY_TRAIN, add_cell, copy_benchmark, run_cell

with open(os.path.join(BENCH, "configs", "deepseek_v2_lite.json")) as f:
    CFG = json.load(f)

TINY = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 96,
        "moe_intermediate_size": 32, "n_routed_experts": 8, "n_shared_experts": 1,
        "num_experts_per_tok": 2, "num_hidden_layers": 3}


def test_nominal_is_the_count_by_hand():
    c, tokens, moe_layers = CFG["model"]["deepseek"], 785, 4
    d, heads = c["hidden_size"], c["num_attention_heads"]
    dqk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    mla = d * heads * dqk + d * (c["kv_lora_rank"] + c["qk_rope_head_dim"]) \
        + c["kv_lora_rank"] * heads * (c["qk_nope_head_dim"] + c["v_head_dim"]) \
        + heads * c["v_head_dim"] * d
    assert mla == 13_762_560
    by_part = {
        "patch_embed": 784 * 3 * 8 * 8 * d,
        "mla_projections": mla * tokens * c["num_hidden_layers"],
        # causal: N(N+1)/2 pairs a head, Q K^T then P V
        "attention_core": tokens * (tokens + 1) // 2 * (dqk + c["v_head_dim"]) * heads * 5,
        "dense_mlp": 3 * d * c["intermediate_size"] * tokens,
        "routed_experts": c["num_experts_per_tok"] * 3 * d * c["moe_intermediate_size"]
        * tokens * moe_layers,
        "shared_experts": 3 * d * c["moe_intermediate_size"] * c["n_shared_experts"]
        * tokens * moe_layers,
        "router": d * c["n_routed_experts"] * tokens * moe_layers,
    }
    nominal = CFG["nominal"]
    assert nominal["by_part"] == by_part
    assert nominal["heads"] == d * 512 + 512 * 256 + 6 * 256 * 19
    assert nominal["forward_macs"] == sum(by_part.values()) + nominal["heads"] == 332_727_072_256
    assert nominal["train_flops"] == 6 * nominal["forward_macs"]


def test_the_model_has_the_published_widths_and_size():
    """The reference and the port build the same 2,422,007,154 parameters
    under the same names; the catalog's keys at the file's top level are
    what the model group runs, but the two cut ones."""
    from benchmark.reference import models

    from guitar_tablature_classification_tpu_torch.config import ModelConfig
    from guitar_tablature_classification_tpu_torch.models.deepseek_v2 import DeepseekV2Tab

    with torch.device("meta"):
        ref = models.build(CFG["model"])
        port = DeepseekV2Tab(ModelConfig(**CFG["model"]).deepseek)
    shapes = {n: tuple(p.shape) for n, p in ref.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert sum(p.numel() for p in ref.parameters()) == 2_422_007_154
    assert shapes["model.layers.4.mlp.experts.63.gate_proj.weight"] == (1408, 2048)
    deep = CFG["model"]["deepseek"]
    assert {k: v for k, v in CFG.items() if k in deep} == {k: v for k, v in deep.items()
                                                           if k in CFG}
    assert set(CFG["reduced"]) == {"num_hidden_layers", "vocab_size"}
    assert (CFG["num_hidden_layers"], deep["aux_loss_alpha"]) == (5, 0.001)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = copy_benchmark(str(tmp_path_factory.mktemp("bench")))
    stream = {**TINY_SERVE, "kind": "stream", "chunk_seconds": [0.1, 0.3, 0.5, 0.2, 0.4],
              "track_seconds": [6.0, 3.0]}
    add_cell(root, "tiny_native_stream", "resnet18_native", stream, "native_stream",
             model={"dtype": "float32"}, e2e=("serve_windows_per_s",))
    add_cell(root, "tiny_dsv2_train", "deepseek_v2_lite", {**TINY_TRAIN, "batch": 2},
             "dsv2lite_train", model={"dtype": "float32",
                                      "deepseek": {**CFG["model"]["deepseek"], **TINY}},
             e2e=("train_segments_per_s",))
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    for metric in ("chunk_ms_p95.stream", "forward_calls_per_chunk.stream", "serve_mfu"):
        next(m for m in spec["per_layer"] if m["name"] == metric)["workloads"].append(
            "tiny_native_stream")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return root


def test_a_stream_cell_runs_sessions(root):
    out = run_cell(root, "tiny_native_stream", seconds=0.5)
    assert out["correct"], out["checks"]
    assert out["checks"]["frets_mismatch"]["value"] == 0.0
    assert set(out["metrics"]) == {"serve_windows_per_s", "setup_s"}
    traced = run_cell(root, "tiny_native_stream", seconds=0.5, trace=True)
    assert traced["metrics"]["chunk_ms_p95.stream"]["value"] > 0
    assert traced["metrics"]["forward_calls_per_chunk.stream"]["value"] > 0
    assert traced["metrics"]["serve_mfu"]["value"] > 0


@pytest.mark.parametrize("fault", [None, "moe_top5", "mla_no_causal"])
def test_a_deepseek_train_cell_and_its_faults(root, fault):
    patch = f"from benchmark.faults.{fault} import plant\nplant()" if fault else ""
    out = run_cell(root, "tiny_dsv2_train", patch=patch)
    assert out["correct"] == (fault is None), out["checks"]
    if fault is None:
        assert set(out["metrics"]) == {"train_segments_per_s", "setup_s"}
