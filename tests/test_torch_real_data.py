"""PyTorch port, the real-data slice, against the JAX package on JPEG/WAV
trees generated in tmp: list parsing, the loaders, both decoders, both
datasets and the host loader over them.

Tolerance: exact (byte-equal payloads and batches) when both packages go
through the same decoder, native against native and PIL against PIL; the
two decoders against each other within 1 LSB on frames that fit the
canvas (IDCT rounding), and oversized frames, which each decoder fits with
its own resample, within the JAX package's own bounds
(tests/test_real_data.py::TestOversizedFrames).
"""

import dataclasses
import os

import numpy as np
import pytest
from PIL import Image
from scipy.io import wavfile

from adamml_tpu.data import dataflow as jflow
from adamml_tpu.data import loaders as jload
from adamml_tpu.data import native_decode as jnative
from adamml_tpu.data import records as jrec
from adamml_tpu.data import video_dataset as jvd
from adamml_tpu_torch.data import dataflow as tflow
from adamml_tpu_torch.data import loaders as tload
from adamml_tpu_torch.data import native_decode as tnative
from adamml_tpu_torch.data import records as trec
from adamml_tpu_torch.data import video_dataset as tvd

from torch_parity import one_torch_thread  # noqa: F401

NUM_FRAMES = 24
H, W = 48, 64
CANVAS = (48, 80)
CLASSES = 4


def _lines(names, labels):
    return "\n".join(f"{n};1;{NUM_FRAMES};{lab}"
                     for n, lab in zip(names, labels)) + "\n"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """rgb, flow (x_/y_ pairs) and sound roots over 5 videos; vid_4 has no
    WAV. Lists: train.txt (single label), multi.txt (multi-label rows),
    short.txt (a 6-frame video among 24-frame ones)."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    roots = {m: root / m for m in ("rgb", "flow", "sound")}
    for d in roots.values():
        d.mkdir()
    names = [f"vid_{v}" for v in range(5)]
    for v, name in enumerate(names):
        (roots["rgb"] / name).mkdir()
        (roots["flow"] / name).mkdir()
        for i in range(1, NUM_FRAMES + 1):
            arr = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
            Image.fromarray(arr).save(roots["rgb"] / name / f"{i:05d}.jpg",
                                      quality=90)
            for axis in "xy":
                g = rng.integers(0, 255, (H, W), dtype=np.uint8)
                Image.fromarray(g, "L").save(
                    roots["flow"] / name / f"{axis}_{i:05d}.jpg")
        if v < 4:
            sig = (rng.normal(size=24000) * 5000).astype(np.int16)
            wavfile.write(str(roots["sound"] / f"{name}.wav"), 24000, sig)
    labels = [v % CLASSES for v in range(5)]
    multi = [f"{v % CLASSES};{(v + 1) % CLASSES}" for v in range(5)]
    for m, d in roots.items():
        wav = ".wav" if m == "sound" else ""
        ids = [n + wav for n in names]
        (d / "train.txt").write_text(_lines(ids, labels))
        (d / "multi.txt").write_text(_lines(ids, multi))
        (d / "short.txt").write_text(
            _lines(ids[:2], labels) + f"{ids[2]};1;6;2\n"
            + _lines(ids[3:], labels[3:]))
    return root


def _kwargs(**kw):
    args = dict(num_groups=4, frames_per_group=2, num_clips=2,
                dense_sampling=True, is_train=True, separator=";",
                num_classes=CLASSES, canvas_size=CANVAS, audio_length=0.1,
                resampling_rate=24000, fps=29.97)
    args.update(kw)
    return args


# -- records ----------------------------------------------------------------

RECORD_CASES = [
    ("train.txt", "rgb", 0, False), ("multi.txt", "rgb", 0, False),
    ("short.txt", "rgb", 10, False), ("short.txt", "rgb", 10, True),
    ("train.txt", "rgbdiff", 0, False)]


@pytest.mark.parametrize("name,modality,filter_video,test_mode", RECORD_CASES)
def test_records_match(tree, name, modality, filter_video, test_mode):
    """The multi-label auto-detect, the filter_video drop (not in test
    mode) and rgbdiff's lost last frame, as the JAX parser gives them."""
    path = str(tree / "rgb" / name)
    kw = dict(separator=";", filter_video=filter_video, test_mode=test_mode,
              modality=modality)
    jr, jml = jrec.parse_list_file(path, **kw)
    tr, tml = trec.parse_list_file(path, **kw)
    assert tml == jml and tml == (name == "multi.txt" and not test_mode)
    assert [dataclasses.asdict(r) for r in tr] == [
        dataclasses.asdict(r) for r in jr]
    dropped = name == "short.txt" and filter_video and not test_mode
    assert len(tr) == (4 if dropped else 5)
    if modality == "rgbdiff":
        assert all(r.end_frame == NUM_FRAMES - 1 for r in tr)


# -- datasets, payload by payload -------------------------------------------

def _pair(root, modality, list_file="train.txt", **kw):
    args = _kwargs(**kw)
    return (jvd.VideoDataset(str(root), list_file, modality=modality, **args),
            tvd.VideoDataset(str(root), list_file, modality=modality, **args))


def _assert_payloads_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


GET_DATA_CASES = [("rgb", True), ("rgb", False), ("flow", True),
                  ("rgbdiff", True), ("sound", True)]


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("modality,native", GET_DATA_CASES,
                         ids=[f"{m}-{'native' if n else 'pil'}"
                              for m, n in GET_DATA_CASES])
def test_get_sample_byte_equal(tree, modality, native, is_train):
    if native and not tnative.native_available():
        pytest.skip(f"native decoder: {tnative.load_error()}")
    root = tree / ("rgb" if modality == "rgbdiff" else modality)
    jd, td = _pair(root, modality, use_native_decoder=native,
                   is_train=is_train)
    for index in range(len(td)):
        ja, jl = jd.get_sample(index, np.random.RandomState(index))
        ta, tl = td.get_sample(index, np.random.RandomState(index))
        _assert_payloads_equal(ja, ta)
        assert tl == jl
    if modality == "sound":  # vid_4 has no WAV
        assert ta["valid"].tolist() == [0.0, 0.0] and not ta["wave"].any()


def test_decode_counts_name_the_decoder(tree):
    """Every rgb frame is counted once, under the decoder that decoded it."""
    if not tnative.native_available():
        pytest.skip(f"native decoder: {tnative.load_error()}")
    _, nat = _pair(tree / "rgb", "rgb", use_native_decoder=True)
    _, pil = _pair(tree / "rgb", "rgb", use_native_decoder=False)
    before = dict(tload.decode_counts)
    payload, _ = nat.get_sample(0, np.random.RandomState(0))
    n = len(payload["frames"])
    assert tload.decode_counts == {"native": before["native"] + n,
                                   "pil": before["pil"]}
    pil.get_sample(0, np.random.RandomState(0))
    assert tload.decode_counts == {"native": before["native"] + n,
                                   "pil": before["pil"] + n}


def test_native_and_pil_within_one_lsb(tree):
    if not tnative.native_available():
        pytest.skip(f"native decoder: {tnative.load_error()}")
    _, nat = _pair(tree / "rgb", "rgb", use_native_decoder=True)
    _, pil = _pair(tree / "rgb", "rgb", use_native_decoder=False)
    rec = nat.video_list[1]
    idx = np.arange(1, NUM_FRAMES + 1)
    a, b = nat.get_data(rec, idx), pil.get_data(rec, idx)
    np.testing.assert_array_equal(a["hw"], [H, W])
    np.testing.assert_array_equal(b["hw"], [H, W])
    assert np.abs(a["frames"].astype(int) - b["frames"].astype(int)).max() <= 1
    assert not a["frames"][:, :, W:].any()  # the canvas padding stays zero


@pytest.mark.parametrize("frames", [4, 5], ids=["even", "odd"])
def test_sound_centre_index(tree, frames):
    """The mean of the two middle indices when num_frames is even, the
    middle one when odd, clamped to the record's length: equal to JAX at
    indices that reach past a short record's end."""
    jd, td = _pair(tree / "sound", "sound", num_groups=frames)
    rec = dataclasses.replace(td.video_list[0], end_frame=8)
    idx = np.asarray([3, 9, 15, 21, 23] * 2)[:frames * 2]
    _assert_payloads_equal(jd.get_data(rec, idx), td.get_data(rec, idx))
    full = td.get_data(td.video_list[0], idx)
    assert not np.array_equal(full["wave"], td.get_data(rec, idx)["wave"])


def test_multi_dataset_shares_indices_and_aligns_rows(tree):
    """One index draw for rgb and sound; children indexed by the first
    child's row, after filter_video too."""
    args = _kwargs(filter_video=10)
    roots = [str(tree / "rgb"), str(tree / "sound")]
    jd = jvd.MultiVideoDataset(roots, "short.txt", ["rgb", "sound"], **args)
    td = tvd.MultiVideoDataset(roots, "short.txt", ["rgb", "sound"], **args)
    assert len(td) == 4
    assert [r.path for r in td.children[1].video_list] == [
        r.path + ".wav" for r in td.children[0].video_list]
    for index in range(len(td)):
        ja, jl = jd.get_sample(index, np.random.RandomState(7))
        ta, tl = td.get_sample(index, np.random.RandomState(7))
        assert tl == jl
        for m in ("rgb", "sound"):
            _assert_payloads_equal(ja[m], ta[m])


# -- the host loader over the real datasets ---------------------------------

LOADER_CASES = [  # (list file, is_train, num_clips, native)
    ("train.txt", True, 2, True), ("train.txt", False, 3, True),
    ("multi.txt", True, 2, False), ("multi.txt", False, 2, True),
    ("train.txt", True, 1, False)]


@pytest.mark.parametrize("list_file,is_train,num_clips,native", LOADER_CASES)
def test_host_loader_batches_byte_equal(tree, list_file, is_train, num_clips,
                                        native):
    if native and not tnative.native_available():
        pytest.skip(f"native decoder: {tnative.load_error()}")
    roots = [str(tree / "rgb"), str(tree / "sound")]
    batches = []
    for vd, flow in ((jvd, jflow), (tvd, tflow)):
        ds = vd.MultiVideoDataset(
            roots, list_file, ["rgb", "sound"],
            **_kwargs(is_train=is_train, num_clips=num_clips,
                      use_native_decoder=native))
        ld = flow.HostDataLoader(ds, 2, is_train=is_train, input_size=32,
                                 scale_range=(36, 44), workers=2, seed=3)
        ld.set_epoch(1)
        batches.append(list(ld))
    jb, tb = batches
    assert len(tb) == len(jb) == (2 if is_train else 3)
    for a, b in zip(jb, tb):
        _assert_payloads_equal(a, b)
    target = tb[0]["target"]
    if list_file == "multi.txt":
        assert target.dtype == np.float32 and target.shape == (2, CLASSES)
        assert (target.sum(1) == 2).all()
    else:
        assert target.dtype == np.int32


# -- frames larger than the canvas ------------------------------------------

def _smooth(shape, seed):
    """Low-frequency content (the JAX package's oversized-frame oracle)."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 255, (8, 12) + shape[2:], dtype=np.uint8)
    img = Image.fromarray(small.squeeze() if small.shape[-1:] == (1,)
                          else small)
    return np.asarray(img.resize((shape[1], shape[0]), Image.BILINEAR),
                      dtype=np.uint8)


OVERSIZED = [  # (name, shape, channels, mean bound, max bound)
    ("wide_rgb", (256, 600, 3), 3, 2.0, 16),
    ("tall_rgb", (600, 256, 3), 3, 2.0, None),
    ("wide_gray", (256, 600, 1), 1, 2.0, None),
    ("prescale_1024", (1024, 1024, 3), 3, 3.0, None),
    ("fitting", (200, 300, 3), 3, None, 1)]


@pytest.mark.parametrize("name,shape,channels,mean_bound,max_bound",
                         OVERSIZED, ids=[c[0] for c in OVERSIZED])
def test_oversized_frames(tmp_path, name, shape, channels, mean_bound,
                          max_bound):
    """Each decoder equal to its JAX twin byte for byte; the two decoders
    fit to the same geometry, pixels within the JAX tests' bounds."""
    if name == "fitting":
        arr = np.random.default_rng(5).integers(0, 255, shape, np.uint8)
    else:
        arr = _smooth(shape, len(name))
    if channels == 1:
        arr = arr[..., 0]
    path = str(tmp_path / f"{name}.jpg")
    Image.fromarray(arr).save(path, quality=95)
    ch, cw = 256, 320

    def pil(load):
        canvas = np.zeros((ch, cw, channels), np.uint8)
        with Image.open(path) as img:
            dec = np.asarray(img.convert(img.mode), dtype=np.uint8)
        return load.place_in_canvas(dec, canvas), canvas

    (hw_p, can_p), (jhw_p, jcan_p) = pil(tload), pil(jload)
    assert hw_p == jhw_p
    np.testing.assert_array_equal(can_p, jcan_p)
    if not tnative.native_available():
        pytest.skip(f"native decoder: {tnative.load_error()}")
    can_n = np.zeros((1, ch, cw, channels), np.uint8)
    jcan_n = np.zeros_like(can_n)
    hw_n = tnative.decode_jpeg_batch([path], can_n, n_threads=1)
    jhw_n = jnative.decode_jpeg_batch([path], jcan_n, n_threads=1)
    np.testing.assert_array_equal(hw_n, jhw_n)
    np.testing.assert_array_equal(can_n, jcan_n)
    assert tuple(hw_n[0].tolist()) == hw_p
    diff = np.abs(can_n[0].astype(int) - can_p.astype(int))
    if mean_bound is not None:
        assert diff.mean() < mean_bound
    if max_bound is not None:
        assert diff.max() <= max_bound


# -- WAV reading and the audio window ----------------------------------------

def _wav(path, kind, rng):
    sig = rng.normal(size=3000)
    data = {"int16": (sig * 5000).astype(np.int16),
            "int32": (sig * 2e8).astype(np.int32),
            "uint8": np.clip(sig * 30 + 128, 0, 255).astype(np.uint8),
            "stereo": (rng.normal(size=(3000, 2)) * 5000).astype(np.int16),
            "float32": (sig * 0.1).astype(np.float32)}[kind]
    wavfile.write(path, 24000, data)


@pytest.mark.parametrize("kind", ["int16", "int32", "uint8", "stereo",
                                  "float32"])
def test_read_wav_scales_like_jax(tmp_path, kind):
    """Mono files equal to JAX; a stereo int16 file is scaled, then
    averaged. The JAX package averages first (float64), which skips its
    int16 scaling: its stereo samples are 32768 times the port's."""
    path = str(tmp_path / f"{kind}.wav")
    _wav(path, kind, np.random.default_rng(1))
    (a, sr_a), (b, sr_b) = jload.read_wav(path), tload.read_wav(path)
    assert sr_a == sr_b == 24000 and b.dtype == np.float32 and b.ndim == 1
    assert np.abs(b).max() <= 1.0
    if kind == "stereo":
        raw = wavfile.read(path)[1]
        np.testing.assert_array_equal(
            b, (raw.astype(np.float32) / 32768.0).mean(axis=1))
        np.testing.assert_allclose(a, b * 32768.0, rtol=1e-6)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("centre,samples", [
    (0, 6000), (3, 6000), (60, 6000), (150, 6000), (30, 500), (30, 0)],
    ids=["left_edge", "inside", "right_edge", "past_end", "tiled", "empty"])
def test_audio_window_like_jax(centre, samples):
    """Edge clamps, a short clip tiled, an empty one zero; the duration
    from the declared rate (16 kHz here, whatever the file says)."""
    rec = trec.VideoRecord("v.wav", 1, 90, 0)
    x = np.random.default_rng(2).normal(size=samples).astype(np.float32)
    args = (rec, centre, 29.97, 0.25, 16000)
    a = jload.extract_audio_window(x, *args)
    b = tload.extract_audio_window(x, *args)
    assert b.shape == (4000,)
    np.testing.assert_array_equal(a, b)


def test_missing_wav_is_zero_and_invalid(tmp_path):
    rec = trec.VideoRecord("absent.wav", 1, 30, 0)
    wave, ok = tload.load_sound_window(str(tmp_path), rec, 5, 29.97, 0.5,
                                       24000)
    assert not ok and wave.shape == (12000,) and not wave.any()


# -- failures ---------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False], ids=["native", "pil"])
def test_file_failing_every_try_raises(tmp_path, native, capsys):
    """A corrupt frame: the native decoder marks its row failed, PIL tries
    ten times and raises the ValueError, as the JAX loader does."""
    root = tmp_path / "rgb"
    (root / "bad").mkdir(parents=True)
    for i in range(1, 9):
        (root / "bad" / f"{i:05d}.jpg").write_bytes(b"not a jpeg")
    (root / "train.txt").write_text("bad;1;8;0\n")
    ds = tvd.VideoDataset(str(root), "train.txt", modality="rgb",
                          **_kwargs(num_clips=1, use_native_decoder=native))
    with pytest.raises(ValueError, match=r"\[Fail 10 times\]"):
        ds.get_sample(0, np.random.RandomState(0))
    assert capsys.readouterr().out.count("[Will try load again]") == 10


def test_native_library_is_loaded_never_built(monkeypatch, tmp_path):
    """A missing library leaves the decoder unavailable and every row to
    PIL; nothing is built or written."""
    monkeypatch.setattr(tnative, "LIB_PATH", str(tmp_path / "absent.so"))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_error", None)
    assert not tnative.native_available()
    assert "absent.so" in tnative.load_error()
    canvas = np.zeros((2, 8, 8, 3), np.uint8)
    assert not tnative.decode_jpeg_batch(["a", "b"], canvas).any()
    assert os.listdir(tmp_path) == []
