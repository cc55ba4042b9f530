#!/usr/bin/env python3
"""The fed pipeline on the card: disk -> JPEG/WAV decode -> device
preprocessing -> the flagship train step, on a generated tree (the port's
counterpart of tools/bench_pipeline.py).

    python -m adamml_tpu_torch.tools.bench_pipeline [videos=16] [batch=8] [steps=12]
    python -m adamml_tpu_torch.tools.bench_pipeline --threads [videos=4]

The first form builds a kinetics-sounds tree with ``generate_tree`` (in
``$BENCH_PIPELINE_DIR`` when set, else a temporary directory), feeds the
flagship (``configs.flagship_cfg``: rgb + sound, ResNet-50 + MobileNetV2,
5 segments x 8 frames, 224, bf16) from the host loader's worker threads,
and steps the policy phase. It prints JSON lines: the card, the tree, then
one summary with clips/s including host time, data ms and step ms per
batch (host clock; the step's time ends in torch.cuda.synchronize()), and
the frames each decoder decoded. ``--threads`` decodes one set of JPEGs
with 1, 2, 4 and 8 threads through each decoder that loads here (the
native library's own threads; a thread pool over PIL) and prints ms per
frame. Both need a CUDA card for the step; ``--threads`` runs anywhere.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

FRAMES = 64
SIZE = (256, 340)  # tools/extract_rgb.py's short side 256, 4:3 video
FPS = 29.97
SAMPLE_RATE = 24000  # tools/extract_audio.py's mono int16 WAVs
CLASSES = 31


def generate_tree(root: str, videos: int = 16, frames: int = FRAMES,
                  size=SIZE) -> dict:
    """A kinetics-sounds tree under ``root``, from seed 0:
    ``rgb/vid_<v>/<i:05d>.jpg`` (JPEG quality 85: a smooth random scene
    with sensor-like noise, panning 3 px a frame, about 24 KB at 256x340),
    ``sound/vid_<v>.wav`` (mono int16), and ``train.txt`` / ``val.txt`` in
    both roots with ';' separators (the sound rows name the .wav), labels
    ``v % 31``. Both lists hold every video; the last video has no WAV, so
    its sound windows are zeros with valid=0. Returns the tree's
    description."""
    from PIL import Image
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    h, w = size
    rgb_root = os.path.join(root, "rgb")
    sound_root = os.path.join(root, "sound")
    os.makedirs(rgb_root, exist_ok=True)
    os.makedirs(sound_root, exist_ok=True)
    t0 = time.perf_counter()
    rows, jpeg_bytes = [], 0
    for v in range(videos):
        scene = rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
        wide = np.asarray(Image.fromarray(scene).resize((2 * w, h),
                                                        Image.BILINEAR))
        wide = np.clip(wide + rng.normal(0.0, 10.0, wide.shape), 0,
                       255).astype(np.uint8)
        vdir = os.path.join(rgb_root, f"vid_{v}")
        os.makedirs(vdir, exist_ok=True)
        for i in range(frames):
            off = (3 * i) % w
            path = os.path.join(vdir, f"{i + 1:05d}.jpg")
            Image.fromarray(wide[:, off:off + w]).save(path, quality=85)
            jpeg_bytes += os.path.getsize(path)
        if v < videos - 1:
            n = int(SAMPLE_RATE * frames / FPS)
            sig = (rng.normal(size=n) * 5000).astype(np.int16)
            wavfile.write(os.path.join(sound_root, f"vid_{v}.wav"),
                          SAMPLE_RATE, sig)
        rows.append((f"vid_{v}", f"1;{frames};{v % CLASSES}"))
    for name in ("train.txt", "val.txt"):
        with open(os.path.join(rgb_root, name), "w") as f:
            f.writelines(f"{p};{rest}\n" for p, rest in rows)
        with open(os.path.join(sound_root, name), "w") as f:
            f.writelines(f"{p}.wav;{rest}\n" for p, rest in rows)
    return dict(root=root, videos=videos, frames=frames, size=list(size),
                jpeg_bytes=jpeg_bytes, wavs=videos - 1,
                seconds=time.perf_counter() - t0)


def _tree(videos: int) -> str:
    root = os.environ.get("BENCH_PIPELINE_DIR") or tempfile.mkdtemp(
        prefix="adamml_pipe_")
    if not os.path.isdir(os.path.join(root, "rgb")):
        print(json.dumps({"tree": generate_tree(root, videos)}), flush=True)
    return root


def decode_threads(root: str, videos: int = 4) -> list:
    """ms per frame decoding the first ``videos`` videos' JPEGs of the tree
    at ``root`` into one canvas, at 1, 2, 4 and 8 threads, through each
    decoder that loads (host clock)."""
    import PIL

    from ..data.loaders import load_frame_rgb, place_in_canvas
    from ..data.native_decode import (decode_jpeg_batch, load_error,
                                      native_available)

    paths = [os.path.join(root, "rgb", f"vid_{v}", f"{i:05d}.jpg")
             for v in range(videos) for i in range(1, FRAMES + 1)]
    canvas = np.zeros((len(paths), 256, 464, 3), np.uint8)

    def pil(n):
        def one(k):
            place_in_canvas(load_frame_rgb(paths[k]), canvas[k])
        with ThreadPoolExecutor(max_workers=n) as pool:
            list(pool.map(one, range(len(paths))))

    decoders = {"pil": pil}
    if native_available():
        decoders["native"] = lambda n: decode_jpeg_batch(paths, canvas,
                                                         n_threads=n)
    rows = []
    for name, run in decoders.items():
        run(1)  # warm the page cache
        base = None
        for n in (1, 2, 4, 8):
            t0 = time.perf_counter()
            run(n)
            dt = time.perf_counter() - t0
            base = base or dt
            rows.append(dict(decoder=name, threads=n, frames=len(paths),
                             ms_per_frame=dt / len(paths) * 1e3,
                             speedup=base / dt))
    rows.append(dict(native_library=("loads" if native_available()
                                     else load_error()),
                     pil=PIL.__version__, host_cores=os.cpu_count()))
    return rows


def fed_pipeline(videos: int, batch: int, steps: int) -> dict:
    """The flagship's policy-phase step fed from a generated tree."""
    import torch

    from ..configs import flagship_cfg
    from ..data import loaders
    from ..data.dataflow import HostDataLoader
    from ..data.device_pipeline import make_batch_preprocessor
    from ..data.video_dataset import MultiVideoDataset
    from ..models.model_builder import build_model
    from ..train.optim import build_optimizer
    from ..train.steps import make_adamml_train_step
    from ..train.train_state import StageFlags, TrainState

    root = _tree(videos)
    dev = torch.device("cuda", 0)
    cfg = flagship_cfg()
    cfg.optim.batch_size = batch
    d = cfg.data
    dataset = MultiVideoDataset(
        [os.path.join(root, "rgb"), os.path.join(root, "sound")],
        "train.txt", ["rgb", "sound"], num_groups=cfg.model.groups,
        frames_per_group=cfg.model.frames_per_group,
        num_clips=cfg.model.num_segments, dense_sampling=True,
        is_train=True, separator=";", num_classes=cfg.model.num_classes,
        canvas_size=d.canvas_size, audio_length=d.audio_length,
        resampling_rate=d.resampling_rate, fps=FPS)
    workers = os.cpu_count() or 1
    loader = HostDataLoader(dataset, batch, is_train=True,
                            input_size=d.input_size, workers=workers, seed=0,
                            prefetch=3)
    pre = make_batch_preprocessor(cfg, train=True,
                                  num_segments=cfg.model.num_segments,
                                  device=dev)
    model, _ = build_model(cfg, dev)
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))
    step = make_adamml_train_step(model, flags=StageFlags.policy_phase(),
                                  penalty_type="blockdrop", gammas=10.0,
                                  clip_gradient=None)

    def batches():
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            yield from loader
            epoch += 1

    it = batches()
    inputs, target = pre(next(it))
    step(state, inputs, target, 1e-3, 1e-2, [1.0, 0.05], seed=0)  # warm-up
    torch.cuda.synchronize()
    before = dict(loaders.decode_counts)
    data_t, step_t, clips = [], [], 0
    t_start = end = time.perf_counter()
    for i in range(steps):
        host_batch = next(it)
        t1 = time.perf_counter()
        data_t.append(t1 - end)
        inputs, target = pre(host_batch)
        m = step(state, inputs, target, 1e-3, 1e-2, [1.0, 0.05], seed=i + 1)
        float(m["loss"])
        torch.cuda.synchronize()
        end = time.perf_counter()
        step_t.append(end - t1)
        clips += int(target.shape[0])
    total = time.perf_counter() - t_start
    return dict(clips_per_s=clips / total, batch=batch, steps=steps,
                host_threads=workers,
                data_ms_per_batch=float(np.mean(data_t)) * 1e3,
                step_ms_per_batch=float(np.mean(step_t)) * 1e3,
                data_share=float(np.sum(data_t)) / total,
                decoded={k: loaders.decode_counts[k] - before[k]
                         for k in before},
                timing="host clock; each step ends in "
                       "torch.cuda.synchronize()")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--threads"]:
        videos = int(argv[1]) if len(argv) > 1 else 4
        for row in decode_threads(_tree(videos), videos):
            print(json.dumps(row), flush=True)
        return 0
    from .timing import need_card, nvidia_smi

    need_card()
    print(json.dumps({"card": nvidia_smi()}), flush=True)
    videos, batch, steps = ([int(a) for a in argv] + [16, 8, 12][len(argv):])
    print(json.dumps(fed_pipeline(videos, batch, steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
