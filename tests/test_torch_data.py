"""PyTorch port, the data slice, against the JAX package: the host loader
over the synthetic dataset (train, val with a ragged tail, oversample
crops), the device preprocessing ops and the batch preprocessors.

Tolerances: loader batches are byte-equal (the same numpy code on the same
seeds); ``rgbdiff_from_frames`` is bit-exact; ``crop_resize_normalize``
within 1e-4 absolute on the normalised float32 output (two float32
contractions of up to ~20 taps over values up to 255, summed in another
order: measured 2e-5); ``log_power_spectrogram`` within 1e-3 absolute on
the log power (two float32 FFTs of 511 points: measured 1.2e-4), both also
held to the float64 numpy twin; the batch preprocessors within 1e-4.
"""

import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adamml_tpu.configs import config as jconfig
from adamml_tpu.data import dataflow as jflow
from adamml_tpu.data import device_pipeline as jpipe
from adamml_tpu.data.synthetic import SyntheticVideoDataset as JSynthetic
from adamml_tpu.ops import augment as jaug
from adamml_tpu.ops import spectrogram as jspec
from adamml_tpu_torch.configs import config as tconfig
from adamml_tpu_torch.data import dataflow as tflow
from adamml_tpu_torch.data import device_pipeline as tpipe
from adamml_tpu_torch.data.synthetic import SyntheticVideoDataset as TSynthetic
from adamml_tpu_torch.ops import augment as taug
from adamml_tpu_torch.ops import spectrogram as tspec

from torch_parity import one_torch_thread, t  # noqa: F401

CANVAS = (40, 64)


def _loaders(modality, *, is_train, length, num_clips, num_crops=1,
             batch=4, shards=1, shard=0, epoch=1):
    """(JAX loader, port loader) over their own synthetic datasets."""
    out = []
    for synth, flow in ((JSynthetic, jflow), (TSynthetic, tflow)):
        ds = synth(modality, length=length, num_groups=2, frames_per_group=2,
                   num_clips=num_clips, num_classes=7, canvas_size=CANVAS,
                   audio_length=0.02, is_train=is_train,
                   dense_sampling=True, seed=3)
        ld = flow.HostDataLoader(ds, batch, is_train=is_train, input_size=16,
                                 scale_range=(20, 28), workers=2, seed=5,
                                 num_crops=num_crops, num_shards=shards,
                                 shard_index=shard)
        ld.set_epoch(epoch)
        out.append(ld)
    return out


LOADER_CASES = [
    # (modality, is_train, length, num_clips, num_crops, shards)
    (("rgb", "sound"), True, 9, 2, 1, 1),
    (("rgb", "sound"), False, 10, 3, 1, 1),
    (("rgb", "sound"), False, 7, 2, 3, 1),
    (("rgb", "sound"), False, 6, 1, 10, 1),
    (("flow", "rgbdiff"), True, 8, 2, 1, 1),
    (("flow", "rgbdiff"), False, 5, 2, 3, 1),
    (("rgb", "flow", "rgbdiff", "sound"), False, 9, 2, 10, 1),
    (("rgb",), False, 9, 2, 1, 2),
]


@pytest.mark.parametrize("modality,is_train,length,clips,crops,shards",
                         LOADER_CASES,
                         ids=["-".join(c[0]) + ("-train" if c[1] else "-val")
                              + f"-n{c[2]}-crops{c[4]}-shards{c[5]}"
                              for c in LOADER_CASES])
def test_loader_batches_are_byte_equal(modality, is_train, length, clips,
                                       crops, shards):
    """Every batch: frames, waves, valid flags, crops, flips and targets,
    dtype and bytes; the valid masks and row indices of the padded val
    tail; the number of batches."""
    jl, tl = _loaders(list(modality), is_train=is_train, length=length,
                      num_clips=clips, num_crops=crops, shards=shards)
    assert len(tl) == len(jl)
    jb, tb = list(jl), list(tl)
    assert len(tb) == len(jb) == len(jl)
    for b_j, b_t in zip(jb, tb):
        assert sorted(b_t) == sorted(b_j)
        for k in b_j:
            assert b_t[k].dtype == b_j[k].dtype, k
            assert b_t[k].shape == b_j[k].shape, k
            assert b_t[k].tobytes() == b_j[k].tobytes(), k
    for name in ("global_valid_masks", "global_row_indices"):
        want, got = getattr(jl, name)(), getattr(tl, name)()
        assert (got is None) == (want is None), name
        if want is not None:
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=name)
    if not is_train and length % 4:
        assert tl.global_valid_masks() is not None


def test_loader_epoch_reshuffles_like_jax():
    """Train order and crops depend on (seed, epoch, index) alone."""
    for epoch in (0, 3):
        jl, tl = _loaders(["rgb"], is_train=True, length=8, num_clips=1,
                          epoch=epoch)
        for b_j, b_t in zip(jl, tl):
            np.testing.assert_array_equal(b_t["rgb_crop"], b_j["rgb_crop"])
            np.testing.assert_array_equal(b_t["target"], b_j["target"])


# --------------------------------------------------------------------------
# batches assembled in place
# --------------------------------------------------------------------------

class FakePinned:
    """``dataflow.PinnedMemory`` on the CPU: plain tensors over numpy
    arrays. ``allocs`` counts them (one a large key a batch), ``alive``
    those not yet freed and ``peak`` the most alive at once; ``freed_on``
    names the thread that freed each, as the storage's last reference went
    (where torch's allocator makes its CUDA calls)."""

    def __init__(self):
        self.allocs = self.alive = self.peak = 0
        self.freed_on = []
        self.lock = threading.Lock()

    def available(self):
        return True

    def empty(self, shape, dtype):
        a = np.empty(shape, dtype)
        weakref.finalize(a, self._freed)
        with self.lock:
            self.allocs += 1
            self.alive += 1
            self.peak = max(self.peak, self.alive)
        return torch.from_numpy(a)

    def _freed(self):
        with self.lock:
            self.alive -= 1
            self.freed_on.append(threading.current_thread().name)


def _stacked(loader):
    """The loader's batches as ``np.stack`` of the fetched samples builds
    them: the reference for the fill in place."""
    idx = loader._indices()
    rng = np.random.RandomState(
        (loader.seed + 7919 * (loader.epoch + 1)) % (2**31))
    out = []
    for b in range(len(loader)):
        samples = [loader._fetch(i)
                   for i in idx[b * loader.batch_size:
                                (b + 1) * loader.batch_size]]
        bufs = {k: np.stack([p[m][f] for p, _ in samples])
                for k, (m, f) in loader._large.items()}
        out.append(loader._collate(samples, rng, bufs))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            assert g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


FILL_CASES = [
    # (modality, is_train, length, num_crops, pad_to_batch)
    (("rgb", "sound"), True, 9, 1, None),
    (("rgb", "sound"), False, 10, 1, None),
    (("rgb", "sound"), False, 6, 10, None),
    (("flow", "rgbdiff"), True, 8, 1, None),
    (("flow", "rgbdiff"), False, 7, 10, None),
    (("rgb", "flow", "rgbdiff", "sound"), False, 9, 1, False),
    (("rgb", "flow", "rgbdiff", "sound"), True, 9, 1, None),
    (("sound",), False, 5, 1, None),
]


@pytest.mark.parametrize("memory", ["numpy", "ring"])
@pytest.mark.parametrize(
    "modality,is_train,length,crops,pad", FILL_CASES,
    ids=["-".join(c[0]) + ("-train" if c[1] else "-val") + f"-n{c[2]}"
         f"-crops{c[3]}" + ("-short-tail" if c[4] is False else "")
         for c in FILL_CASES])
def test_loader_fill_equals_stack(modality, is_train, length, crops, pad,
                                  memory):
    """Every batch filled in place (new numpy arrays, or a ring of buffers
    as with a card) equals ``np.stack`` of the fetched samples in every
    key, dtype and byte, the padded val tail and a short tail batch too;
    the batches ``list(loader)`` keeps stay intact and share no memory."""
    ds = TSynthetic(list(modality), length=length, num_groups=2,
                    frames_per_group=2, num_clips=2, num_classes=7,
                    canvas_size=CANVAS, audio_length=0.02,
                    is_train=is_train, dense_sampling=True, seed=3)
    ld = tflow.HostDataLoader(ds, 4, is_train=is_train, input_size=16,
                              scale_range=(20, 28), workers=3, seed=5,
                              num_crops=crops, pad_to_batch=pad)
    ld.set_epoch(2)
    if memory == "ring":
        ld.pinned = FakePinned()
    got = list(ld)
    _assert_same(got, _stacked(ld))
    assert got[-1][next(iter(ld._large))].shape[0] == (
        length % 4 if pad is False else 4)
    large = [b[k] for b in got for k in ld._large]
    for i, a in enumerate(large):
        for b in large[i + 1:]:
            assert not np.shares_memory(a, b)
    if memory == "ring":
        assert ld.pinned.allocs == len(got) * len(ld._large)


class _Odd:
    """A dataset whose sample ``bad`` has frames of another shape or
    dtype."""

    modality = ["rgb"]

    def __init__(self, bad, how):
        self.bad, self.how = bad, how

    def __len__(self):
        return 8

    def __getitem__(self, i):
        shape, dtype = (2, 4, 4, 3), np.uint8
        if i == self.bad:
            if self.how == "shape":
                shape = (2, 4, 5, 3)
            else:
                dtype = np.int16
        return ({"rgb": {"frames": np.full(shape, i, dtype),
                         "hw": np.asarray([4, 4], np.int32)}}, i % 3)


@pytest.mark.parametrize("memory", ["numpy", "ring"])
@pytest.mark.parametrize("bad", [2, 6], ids=["first-batch", "second-batch"])
@pytest.mark.parametrize("how", ["shape", "dtype"])
def test_loader_sample_unlike_its_row_raises(how, bad, memory):
    """A sample whose frames differ from their row in shape or dtype
    raises, in the first batch or a later one."""
    ld = tflow.HostDataLoader(_Odd(bad, how), 4, is_train=False,
                              input_size=4, workers=2)
    if memory == "ring":
        ld.pinned = FakePinned()
    with pytest.raises(ValueError, match=f"sample {bad % 4}"):
        list(ld)


def _ring_dataset(length):
    return TSynthetic(["rgb", "sound"], length=length, num_groups=2,
                      frames_per_group=2, num_clips=1, num_classes=7,
                      canvas_size=CANVAS, audio_length=0.02, is_train=True,
                      dense_sampling=True, seed=4)


def _ring_loader(length, pinned, prefetch=2, workers=3):
    ld = tflow.HostDataLoader(_ring_dataset(length), 2, is_train=True, input_size=16,
                              scale_range=(20, 28), workers=workers,
                              seed=6, prefetch=prefetch)
    ld.pinned = pinned
    return ld


def _freed_here(pinned):
    me = threading.current_thread().name
    return pinned.alive == 0 and set(pinned.freed_on) <= {me}


@pytest.mark.parametrize("lag", [0, 3])
def test_ring_reuses_a_buffer_only_after_its_late_copy(lag):
    """A consumer that drops each batch, after a pause of ``lag`` ms: each
    batch holds its own bytes; the loader allocates one buffer a batch
    from the allocator (which reuses a block only once the batch is gone
    and its copies have run), drops the last reference to each on the
    consuming thread, and holds at most prefetch + 4 at once: the batch
    taken, the queued ones, the one being filled, one handed ahead and one
    handed at a request answered late."""
    pinned = FakePinned()
    ld = _ring_loader(24, pinned)
    want = _stacked(ld)
    n = 0
    for i, batch in enumerate(ld):
        _assert_same([batch], [want[i]])
        time.sleep(lag / 1e3)
        n += 1
    del batch
    assert n == 12
    assert pinned.allocs == n * len(ld._large)
    assert pinned.peak <= (ld.prefetch + 4) * len(ld._large)
    assert _freed_here(pinned)


def test_ring_consumer_holding_more_than_the_ring():
    """Batches held past the prefetch keep buffers of their own; all stay
    intact, and are freed where the consumer drops them."""
    pinned = FakePinned()
    ld = _ring_loader(24, pinned)
    want = _stacked(ld)
    it = iter(ld)
    kept = [next(it) for _ in range(8)]
    _assert_same(kept, want[:8])
    assert pinned.alive >= 8 * len(ld._large)
    del kept
    rest = list(it)
    _assert_same(rest, want[8:])
    del rest, it
    assert _freed_here(pinned)


def test_ring_under_thread_switches():
    """More workers than cores, a thread switch every microsecond, and a
    consumer that keeps a random share of its batches for a while: every
    batch reads its own bytes, every buffer is freed on the consuming
    thread, and the pass ends with its threads."""
    rs = np.random.RandomState(0)
    pinned = FakePinned()
    ld = _ring_loader(60, pinned, prefetch=3, workers=16)
    want = _stacked(ld)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    before = threading.active_count()
    t0 = time.monotonic()
    try:
        kept = []
        for i, batch in enumerate(ld):
            _assert_same([batch], [want[i]])
            if rs.rand() < 0.4:
                kept.append((i, batch))
            if len(kept) > 3:
                j, old = kept.pop(rs.randint(len(kept)))
                _assert_same([old], [want[j]])
            del batch
    finally:
        sys.setswitchinterval(switch)
    for j, old in kept:
        _assert_same([old], [want[j]])
    del kept, old
    assert _freed_here(pinned)
    assert time.monotonic() - t0 < 60
    assert threading.active_count() == before


def test_loader_early_break_cuts_the_fetch_short():
    """A consumer that stops after the first batch waits for the samples
    being fetched, not for the rest of the next batch's, and the pass
    ends with its threads."""
    ds = _Slow(_ring_dataset(24), seconds=0.4)
    ld = tflow.HostDataLoader(ds, 8, is_train=True, input_size=16,
                              scale_range=(20, 28), workers=2, seed=6)
    before = threading.active_count()
    it = iter(ld)
    next(it)
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 1.0
    assert threading.active_count() == before


class _Slow:
    """A dataset whose every sample takes ``seconds`` to fetch."""

    def __init__(self, ds, seconds):
        self.ds, self.seconds = ds, seconds
        self.modality = ds.modality

    def __len__(self):
        return len(self.ds)

    def get_sample(self, index, rng=None):
        time.sleep(self.seconds)
        return self.ds.get_sample(index, rng)


# --------------------------------------------------------------------------
# device ops
# --------------------------------------------------------------------------

# (x0, y0, w, h) on a 40x64 canvas: whole canvas, fractional origins,
# crops touching the right / bottom edge, one running past the canvas, a
# tiny crop (magnified at every out size) and a wide one
CROPS = np.array([[0, 0, 64, 40], [3.3, 1.7, 20.5, 30.2],
                  [10.25, 5.5, 53.75, 34.5], [0.5, 0.1, 7.3, 9.1],
                  [44, 20, 20, 20], [50.5, 30.5, 20, 15],
                  [12.75, 8.125, 3.5, 4.25], [0, 12, 64, 16]], np.float32)
FLIPS = np.array([True, False, True, False, True, True, False, True])


@pytest.mark.parametrize("out_size", [8, 16, 48])
@pytest.mark.parametrize("channels,flow", [(3, False), (2, True), (3, True)],
                         ids=["rgb", "flow", "flow3"])
@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
def test_crop_resize_normalize_matches(out_size, channels, flow, normalize):
    """Minification (out 8 and 16 from crops up to 64 wide) and
    magnification (out 48, and the 3.5-pixel crop at every size), within
    1e-4 of the JAX function when normalised. Without normalisation the
    output is in pixel units up to 255, within 5e-3: a float32 sample
    position one ulp apart (XLA may fuse its arithmetic; 4e-6 at 50 pixels)
    times a neighbour difference of up to 255 on random frames moves an
    output by 1e-3 (measured 2.4e-3); normalising divides that by 57."""
    rs = np.random.RandomState(out_size + channels)
    frames = rs.randint(0, 256, (len(CROPS), 3) + CANVAS + (channels,),
                        dtype=np.uint8)
    mean = (0.5, 0.45, 0.4)[:channels] if normalize else None
    std = (0.2, 0.25, 0.3)[:channels] if normalize else None
    want = np.asarray(jaug.crop_resize_normalize(
        jnp.asarray(frames), jnp.asarray(CROPS), jnp.asarray(FLIPS),
        out_size=out_size, mean=mean, std=std, flow_channels=flow))
    got = taug.crop_resize_normalize(
        t(frames), t(CROPS), t(FLIPS), out_size=out_size, mean=mean,
        std=std, flow_channels=flow)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 if normalize else 5e-3)


def test_crop_resize_normalize_compute_dtype():
    rs = np.random.RandomState(1)
    frames = t(rs.randint(0, 256, (2, 2, 20, 30, 3), dtype=np.uint8))
    crop = t(np.array([[1, 2, 15, 15], [0, 0, 30, 20]], np.float32))
    flip = t(np.array([False, True]))
    f32 = taug.crop_resize_normalize(frames, crop, flip, out_size=8,
                                     mean=(0.5,) * 3, std=(0.2,) * 3)
    bf = taug.crop_resize_normalize(frames, crop, flip, out_size=8,
                                    mean=(0.5,) * 3, std=(0.2,) * 3,
                                    compute_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, f32.to(torch.bfloat16))


def test_rgbdiff_from_frames_is_bit_exact():
    rs = np.random.RandomState(2)
    frames = rs.randint(0, 256, (3, 2, 6, 5, 7, 3), dtype=np.uint8)
    frames[0, 0, 1] = frames[0, 0, 0]        # a zero difference
    frames[1, 0, 1] = 255
    frames[1, 0, 0] = 0                      # the largest
    frames[1, 1, 1] = 0
    frames[1, 1, 0] = 255                    # the smallest
    want = np.asarray(jaug.rgbdiff_from_frames(jnp.asarray(frames)))
    got = taug.rgbdiff_from_frames(t(frames))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("audio_length", [0.16, 1.28])
def test_log_power_spectrogram_matches(audio_length):
    """The log power within 1e-3 of JAX's, both within 1e-3 of the float64
    numpy twin; shapes (..., num_freqs, num_frames)."""
    tcfg = tspec.SpectrogramConfig(audio_length=audio_length)
    jcfg = jspec.SpectrogramConfig(audio_length=audio_length)
    assert (tcfg.num_freqs, tcfg.num_frames) == (jcfg.num_freqs,
                                                 jcfg.num_frames)
    rs = np.random.RandomState(int(audio_length * 100))
    wave = (rs.randn(2, 2, tcfg.num_samples) * 0.1).astype(np.float32)
    wave[1, 1, : tcfg.num_samples // 2] = 0.0  # a half-silent clip
    want = np.asarray(jspec.log_power_spectrogram(jnp.asarray(wave), jcfg))
    got = tspec.log_power_spectrogram(t(wave), tcfg).numpy()
    assert got.shape == want.shape == (2, 2, tcfg.num_freqs,
                                       tcfg.num_frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    for i, j in ((0, 0), (1, 1)):
        twin = tspec.log_power_spectrogram_np(wave[i, j], tcfg)
        np.testing.assert_array_equal(
            twin, jspec.log_power_spectrogram_np(wave[i, j], jcfg))
        np.testing.assert_allclose(got[i, j], twin, rtol=0, atol=1e-3)
        np.testing.assert_allclose(want[i, j], twin, rtol=0, atol=1e-3)


# --------------------------------------------------------------------------
# batch preprocessors
# --------------------------------------------------------------------------

def _cfgs(argv):
    argv = ["--dataset", "synthetic", "--groups", "2", "--frames_per_group",
            "2", "--dense_sampling", "--input_size", "16", "--audio_length",
            "0.02", "--compute_dtype", "float32", "--scale_range", "20",
            "28"] + argv
    tcfg = tconfig.config_from_args(tconfig.arg_parser().parse_args(argv))
    jcfg = jconfig.config_from_args(jconfig.arg_parser().parse_args(argv))
    for cfg in (tcfg, jcfg):
        cfg.data.canvas_size = CANVAS
    return tcfg, jcfg


PRE_CASES = [(True, 1), (False, 1), (False, 3)]


@pytest.mark.parametrize("train,crops", PRE_CASES,
                         ids=["train", "val", "val-crops3"])
def test_batch_preprocessor_matches(train, crops):
    """All four modalities (rgb, flow, rgbdiff, sound) of one synthetic
    batch, 2 segments: inputs within 1e-4, targets equal."""
    mods = ["rgb", "flow", "rgbdiff", "sound"]
    tcfg, jcfg = _cfgs(["--modality", *mods, "--num_crops", str(crops)])
    ld, _ = _loaders(mods, is_train=train, length=4, num_clips=2,
                     num_crops=crops)
    batch = next(iter(ld))
    want_x, want_y = jpipe.make_batch_preprocessor(
        jcfg, train=train, num_segments=2)(batch)
    got_x, got_y = tpipe.make_batch_preprocessor(
        tcfg, train=train, num_segments=2, device="cpu")(batch)
    assert len(got_x) == len(want_x) == 4
    for m, g, w in zip(mods, got_x, want_x):
        assert tuple(g.shape) == w.shape, m
        assert g.dtype == torch.float32, m
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4, err_msg=m)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


@pytest.mark.parametrize("modality", ["rgb", "sound"])
def test_unimodal_preprocessor_matches(modality):
    tcfg, jcfg = _cfgs(["--modality", modality, "--num_clips", "2"])
    ld, _ = _loaders([modality], is_train=False, length=4, num_clips=2)
    batch = next(iter(ld))
    want_x, _ = jpipe.make_unimodal_preprocessor(
        jcfg, train=False, num_clips=2)(batch)
    got_x, _ = tpipe.make_unimodal_preprocessor(
        tcfg, train=False, num_clips=2, device="cpu")(batch)
    assert tuple(got_x.shape) == want_x.shape
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-4)
