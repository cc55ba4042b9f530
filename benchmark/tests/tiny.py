"""A tiny cell for CPU tests: a cell's structure (its modalities, ResNet-50,
the MobileNetV2s, the LSTM policy) at 64 px, 2 segments of 4 frames,
float32."""

import copy

from benchmark import harness

FLAGS = ["--dataset", "kinetics-sounds", "--modality", "rgb", "sound",
         "--groups", "4", "--frames_per_group", "4", "--num_segments", "2",
         "--dense_sampling", "--causality_modeling", "lstm",
         "--learnable_lf_weights", "--cost_weights", "1.0", "0.05",
         "-b", "4", "--lr", "1e-3", "--p_lr", "1e-2", "--input_size", "64",
         "--audio_length", "0.16", "--compute_dtype", "float32",
         "--steps_per_dispatch", "2"]
REFERENCE = {
    "modality": ["rgb", "sound"], "num_classes": 31, "frames": 4,
    "segments": 2, "input_size": 64, "policy_input_size": 160,
    "audio_length": 0.16, "resampling_rate": 24000, "canvas": [64, 96],
    "scale_range": [256, 320], "dropout": 0.5, "temperature": 5.0,
    "gammas": 10.0, "cost_weights": [1.0, 0.05], "lr": 0.001, "p_lr": 0.01,
    "momentum": 0.9, "weight_decay": 0.0001}


def flags_for(modality) -> list:
    flags = list(FLAGS)
    i = flags.index("--modality")
    j = i + 1
    while not flags[j].startswith("-"):
        j += 1
    flags[i + 1:j] = list(modality)
    return flags


def cell(name: str, **traffic_changes) -> harness.Cell:
    """The named cell of BENCHMARK.json at the tiny size."""
    real = harness.load_cell(name)
    traffic = copy.deepcopy(real.traffic)
    traffic.update(batch=4, pool_batches=2, workers=2)
    traffic.update(traffic_changes)
    traffic["trace"] = {"skip_dispatches": 1, "dispatches": 1,
                        "skip_requests": 1, "requests": 1}
    if traffic["entry"] == "serve":
        traffic.update(segments=2, check_requests=2, warmup_requests=1)
    modality = real.config["reference"]["modality"]
    config = dict(real.config, flags=flags_for(modality),
                  reference=dict(REFERENCE, modality=modality))
    return harness.Cell(name=name, chips=1, config=config, traffic=traffic,
                        end_to_end=real.end_to_end,
                        per_layer=real.per_layer)
