"""PyTorch port, the recipes' single-chip table and the observability
helpers, on the CPU.

``recipes.SINGLE_CHIP_SHAPES`` holds one H100 shape for every key of the
JAX package's single-chip table, at an effective batch of 1024 with the JAX
table's BN group sizes (its tests/test_training_loop.py:76 holds the same
rules), and it is the pick of its source, ``single_chip_h100.json``; the
override rule is JAX's. ``utils/observability.py``: ``load_metrics`` reads
what ``MetricsWriter`` wrote, ``StepTimer`` counts, and ``trace`` writes a
Chrome trace under ``<exp_dir>/profile`` that names the traced ops.
"""

import json
import os
import time

import pytest
import torch

from voxsrc2020_speaker_verification_tpu.recipes import SINGLE_CHIP_SHAPES as JAX_SHAPES
from voxsrc2020_speaker_verification_tpu_torch import recipes
from voxsrc2020_speaker_verification_tpu_torch.cli import train as train_cli
from voxsrc2020_speaker_verification_tpu_torch.recipes import (
    SINGLE_CHIP_SHAPES, get_recipe, single_chip_shape)
from voxsrc2020_speaker_verification_tpu_torch.utils.observability import (
    MetricsWriter, StepTimer, load_metrics, trace)

SOURCE = os.path.join(os.path.dirname(recipes.__file__), "single_chip_h100.json")


def test_single_chip_table_covers_the_jax_keys():
    assert set(SINGLE_CHIP_SHAPES) == set(JAX_SHAPES)


@pytest.mark.parametrize("key", sorted(JAX_SHAPES))
def test_single_chip_shape_rules(key):
    """Effective batch 1024; a BN group of 32 rows on the f200 legs, 16 on
    the f600 legs, 128 for the TDNN (or the whole microbatch where it is
    smaller); remat stages only with remat."""
    model, frames = key
    shape = SINGLE_CHIP_SHAPES[key]
    assert shape["batch_size"] * shape["num_accumulation_steps"] == 1024, key
    want = 128 if model == "tdnn" else (16 if frames == 600 else 32)
    assert shape["batch_size"] // shape["bn_groups"] == min(want, shape["batch_size"]), key
    assert shape["batch_size"] % shape["bn_groups"] == 0
    assert shape.get("remat_stages") is None or shape["remat"]


def test_single_chip_table_is_its_measured_source():
    """Each row is the pick of scripts/encoder_memory.py --single-chip: the
    most rows per second among the shapes whose peak left 10% of the card
    free."""
    with open(SOURCE) as f:
        src = json.load(f)
    assert src["headroom"] == 0.1 and src["effective_batch"] == 1024
    assert "H100" in src["card"]
    limit = 0.9 * src["total_memory_bytes"]
    for row in src["rows"]:
        key = (row["model"], row["frames"])
        stages = tuple(row["remat_stages"]) if row["remat_stages"] else None
        assert SINGLE_CHIP_SHAPES[key] == dict(
            batch_size=row["batch_size"], num_accumulation_steps=row["num_accumulation_steps"],
            remat=row["remat"], remat_stages=stages, bn_groups=row["bn_groups"]), key
        fits = [c for c in src["cases"] if (c["model"], c["frames"]) == key
                and c["fits"] and c["peak_memory_bytes"] <= limit]
        assert max(fits, key=lambda c: c["rows_per_s"])["microbatch"] == row["batch_size"]
    assert {(r["model"], r["frames"]) for r in src["rows"]} == set(SINGLE_CHIP_SHAPES)


def test_get_recipe_single_chip_and_override_rule():
    model = "res2net200_w24_s4_c32_att"
    base, _ = get_recipe("res2net_vox2_dev_aug", model=model)
    shape = single_chip_shape(model, 200)
    cfg, _ = get_recipe("res2net_vox2_dev_aug", model=model, single_chip=True)
    assert (cfg.batch_size, cfg.num_accumulation_steps, cfg.bn_groups) == (
        shape["batch_size"], shape["num_accumulation_steps"], shape["bn_groups"])
    # the schedules and step counts stay the recipe's
    assert cfg.total_steps == base.total_steps and cfg.learning_rate == base.learning_rate
    # pinning either of batch_size / num_accumulation_steps drops both keys
    cfg, _ = get_recipe("res2net_vox2_dev_aug", model=model, single_chip=True, batch_size=64)
    assert (cfg.batch_size, cfg.num_accumulation_steps) == (64, base.num_accumulation_steps)
    cfg, _ = get_recipe("res2net_vox2_dev_aug", model=model, single_chip=True,
                        num_accumulation_steps=2)
    assert (cfg.batch_size, cfg.num_accumulation_steps) == (base.batch_size, 2)
    # any other key the user pins wins alone
    cfg, _ = get_recipe("res2net_vox2_dev_aug", model=model, single_chip=True, bn_groups=2)
    assert cfg.bn_groups == 2 and cfg.batch_size == shape["batch_size"]
    # the LMFT leg takes its 600-frame row; a model the table lacks keeps the recipe
    cfg, _ = get_recipe("res2net_finetune_vox2_dev", model=model, single_chip=True)
    assert cfg.batch_size == single_chip_shape(model, 600)["batch_size"]
    assert single_chip_shape("ecapa_tdnn_512", 200) == {}
    cfg, _ = get_recipe("ecapa_vox2_dev_aug", single_chip=True)
    assert cfg == get_recipe("ecapa_vox2_dev_aug")[0]


def test_train_cli_single_chip_flag():
    args = train_cli.build_parser().parse_args(
        ["--recipe", "res2net_vox2_dev_aug", "--single-chip", "--num-model-shards", "2",
         "--coordinator", "localhost:1", "--num-processes", "2"])
    assert args.single_chip and args.num_model_shards == 2 and args.coordinator


def test_load_metrics_reads_what_the_writer_wrote(tmp_path):
    assert load_metrics(str(tmp_path)) == []
    w = MetricsWriter(str(tmp_path))
    w.write(10, {"loss": 1.5, "accuracy": 0.5}, audio_s_per_s=1000.0)
    w.write(20, {"loss": torch.tensor(1.25), "accuracy": 0.625}, audio_s_per_s=1100.0)
    w.close()
    recs = load_metrics(str(tmp_path))
    assert [r["step"] for r in recs] == [10, 20]
    assert recs[1]["loss"] == 1.25 and recs[1]["audio_s_per_s"] == 1100.0


def test_step_timer_counts_steps_and_audio():
    timer = StepTimer(audio_seconds_per_step=512.0)
    timer.tick()
    timer.tick(3)
    time.sleep(0.01)
    lap = timer.lap()
    assert lap["audio_s_per_s"] == pytest.approx(512.0 * lap["steps_per_s"])
    assert 0 < lap["steps_per_s"] <= 4 / 0.01
    assert timer.lap()["steps_per_s"] == 0.0


def test_trace_writes_a_chrome_trace_under_profile(tmp_path):
    with trace(str(tmp_path), name="step") as prof:
        torch.mm(torch.randn(8, 8), torch.randn(8, 8))
    assert prof.trace_path == str(tmp_path / "profile" / "step.json")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    with trace(str(tmp_path / "off"), enabled=False) as off:
        pass
    assert off is None and not os.path.exists(tmp_path / "off" / "profile")
