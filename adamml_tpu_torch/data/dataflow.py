"""Host data loader: sharded, shuffled, thread-prefetched batches (the
port's copy of ``adamml_tpu/data/dataflow.py``: the same batches, byte for
byte).

A batch is assembled where the card will read it. For each batch the
producer thread takes a buffer with a row a sample for each large array
(``<m>_frames``, ``sound_wave``), and the worker threads write every
sample into its row; the small arrays (``hw``, crops, flips,
``sound_valid``, the targets) are stacked as before. With a CUDA device
present the buffers are page-locked tensors from torch's caching host
allocator (``PinnedMemory``), which ``device_pipeline.to_device`` copies
to the card as they are; the allocator reuses a buffer once the batch is
dropped and its copies have run. Otherwise each batch gets new numpy
arrays. The workers only copy bytes: the thread that takes the batches
allocates every buffer and drops the last reference to it, so it alone
makes the allocator's CUDA calls.

Replaces the reference's torch DataLoader + DistributedSampler stack
(reference utils/utils.py:153-163): per-process index sharding (the port
runs one process, ``num_shards=1``; the shard arithmetic stays, so the eval
masks and row indices are the JAX package's), epoch-seeded shuffling (the
DistributedSampler.set_epoch equivalent, reference utils/utils.py:197-198),
a thread pool for decode
parallelism, and a small look-ahead queue so host decode overlaps device
compute. Augmentation parameters for the device preprocessing op are drawn
here, per sample per modality (matching the reference's independent
per-modality transform randomness, reference train_adamml.py:226-234).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import counted
from .aug_params import oversample_crop_flip, sample_crop_flip

# batch key -> (shape of one sample's array, dtype): the large arrays
Spec = Dict[str, Tuple[tuple, np.dtype]]


class PinnedMemory:
    """Page-locked host memory from torch's caching host allocator. A block
    goes back to the allocator when its last tensor is gone (the array
    ``Tensor.numpy()`` makes keeps its tensor alive), and the allocator
    hands it out again only once every copy to a card that read it has
    run: it records an event on the stream of each such copy."""

    @staticmethod
    def available() -> bool:
        return torch.cuda.is_available()

    @staticmethod
    def empty(shape: tuple, dtype: np.dtype) -> torch.Tensor:
        like = torch.from_numpy(np.empty(0, dtype))
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)


class _Need:
    """The producer's request for a buffer, sent on the batch queue."""

    __slots__ = ("spec",)

    def __init__(self, spec: Spec):
        self.spec = spec


class HostDataLoader:
    def __init__(self, dataset, batch_size: int, *, is_train: bool,
                 input_size: int = 224, augmentor_ver: str = "v2",
                 scale_range: Sequence[int] = (256, 320),
                 disable_scaleup: bool = False, workers: int = 8,
                 seed: int = 0, num_shards: int = 1, shard_index: int = 0,
                 drop_last: Optional[bool] = None, prefetch: int = 2,
                 pad_to_batch: Optional[bool] = None,
                 num_crops: int = 1) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.is_train = is_train
        self.input_size = input_size
        self.augmentor_ver = augmentor_ver
        self.scale_range = tuple(scale_range)
        self.disable_scaleup = disable_scaleup
        self.workers = max(1, workers)
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = is_train if drop_last is None else drop_last
        # Eval default: pad the ragged tail batch to the static batch size
        # (wrapped real samples, masked out of the metrics by
        # global_valid_masks) so every eval batch compiles to ONE shape and
        # multi-host shards stay equal-sized.
        self.pad_to_batch = ((not self.drop_last) if pad_to_batch is None
                             else pad_to_batch)
        self.prefetch = prefetch
        # multi-crop oversample eval (reference GroupOverSample,
        # utils/video_transforms.py:121-178): emit num_crops fixed crop
        # rectangles per sample; the device pipeline folds them into the
        # batch and the eval step averages logits over crops
        self.num_crops = num_crops if not is_train else 1
        self.epoch = 0
        self.modality = list(getattr(dataset, "modality", ["rgb"]))
        # the large arrays: batch key -> (payload modality, payload field)
        self._large = {("sound_wave" if m == "sound" else f"{m}_frames"):
                       (m, "wave" if m == "sound" else "frames")
                       for m in self.modality}
        self.pinned = PinnedMemory()
        self._rngs = threading.local()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.is_train:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        # torch DistributedSampler semantics: pad by wrapping so every shard
        # has the SAME length -- without this, shards can differ by one
        # sample and processes would disagree on the number of batches
        # (collective deadlock). Reference utils/utils.py:157.
        if self.num_shards > 1 and n % self.num_shards:
            total = -(-n // self.num_shards) * self.num_shards
            order = np.concatenate([order, order[: total - n]])
        return order

    def _shard(self, shard_index: int):
        """(indices, valid) for one shard; valid marks rows that are real
        (not shard-equalization or batch-tail padding)."""
        n = len(self.dataset)
        order = self._order()
        real = np.arange(len(order)) < n  # wrap-padding sits at the tail
        idx = order[shard_index::self.num_shards]
        valid = real[shard_index::self.num_shards]
        if self.pad_to_batch and not self.drop_last and len(idx):
            nb = -(-len(idx) // self.batch_size)
            pad = nb * self.batch_size - len(idx)
            if pad:
                reps = -(-pad // len(idx))
                fill = np.tile(idx, reps)[:pad]
                idx = np.concatenate([idx, fill])
                valid = np.concatenate([valid, np.zeros(pad, bool)])
        return idx, valid

    def _indices(self) -> np.ndarray:
        return self._shard(self.shard_index)[0]

    def global_valid_masks(self) -> Optional[list]:
        """Per-batch boolean masks over the GLOBAL (all-shard) batch rows,
        ordered [shard0 rows, shard1 rows, ...] -- the layout of a
        batch-sharded output gathered over the processes. None when
        no padding is in play (all rows real). Pure function of (dataset
        size, shards, batch size): every process computes the same masks."""
        if self.drop_last or not self.pad_to_batch:
            return None
        shard_valid = [self._shard(p)[1] for p in range(self.num_shards)]
        if all(v.all() for v in shard_valid):
            return None
        nb = len(self)
        bs = self.batch_size
        return [np.concatenate([v[bi * bs:(bi + 1) * bs]
                                for v in shard_valid]) for bi in range(nb)]

    def global_row_indices(self) -> Optional[list]:
        """Per-batch dataset indices of the GLOBAL batch rows, in the same
        [shard0 rows, shard1 rows, ...] layout as global_valid_masks.

        With num_shards > 1 the gathered eval matrices are shard-interleaved
        (row (batch b, shard p, slot k) holds dataset index (b*bs+k)*P + p),
        NOT val-list order; consumers (validate()) use these indices to
        restore dataset order so saved val_*.npy artifacts line up with the
        val list (and with --pred_files scoring). Pure function of (dataset
        size, shards, batch size): every process computes the same answer."""
        shard_idx = [self._shard(p)[0] for p in range(self.num_shards)]
        nb = len(self)
        bs = self.batch_size
        return [np.concatenate([ix[bi * bs:(bi + 1) * bs]
                                for ix in shard_idx]) for bi in range(nb)]

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _spec(self, sample) -> Spec:
        """Each large array's shape and dtype, from one sample."""
        payload, _ = sample
        return {k: (payload[m][f].shape, payload[m][f].dtype)
                for k, (m, f) in self._large.items()}

    def _fill(self, pool, bufs: Dict[str, np.ndarray], samples) -> None:
        """Write every sample's large arrays into its rows of ``bufs``, in
        the worker threads: the copies cut along the sample's first axis
        into about four pieces a worker, so that the workers share the
        bytes evenly. A sample whose array differs from its row in shape or
        dtype raises."""
        pieces = []
        for k, (m, f) in self._large.items():
            dst = bufs[k]
            for j, (payload, _) in enumerate(samples):
                src = payload[m][f]
                if src.shape != dst.shape[1:] or src.dtype != dst.dtype:
                    raise ValueError(
                        f"{k}: sample {j} is {src.dtype} {src.shape}, its "
                        f"row {dst.dtype} {dst.shape[1:]}")
                pieces.append((dst[j, ...], src))
        share = max(1, sum(d.nbytes for d, _ in pieces)
                    // (4 * self.workers))
        cut = []
        for d, s in pieces:
            n = min(len(d), -(-d.nbytes // share)) if d.ndim else 1
            cut += (zip(np.array_split(d, n), np.array_split(s, n)) if n > 1
                    else [(d, s)])
        # the tasks carry indices, so that no worker holds a view of a
        # buffer once ``cut`` is cleared
        try:
            for _ in pool.map(lambda i: np.copyto(*cut[i]), range(len(cut))):
                pass
        finally:
            cut.clear()

    def _collate(self, samples, rng: np.random.RandomState,
                 bufs: Dict[str, np.ndarray]) -> Dict:
        """The batch: the large arrays ``bufs`` (filled by ``_fill``), the
        small ones stacked here, crops and flips drawn from ``rng``."""
        batch: Dict[str, np.ndarray] = {}
        labels = []
        per_mod: Dict[str, list] = {m: [] for m in self.modality}
        for payload, label in samples:
            labels.append(label)
            for m in self.modality:
                per_mod[m].append(payload[m])
        for m in self.modality:
            items = per_mod[m]
            if m == "sound":
                batch["sound_wave"] = bufs["sound_wave"]
                batch["sound_valid"] = np.stack([it["valid"] for it in items])
                continue
            hw = np.stack([it["hw"] for it in items])
            if not self.is_train and self.num_crops > 1:
                crop, flip = oversample_crop_flip(
                    hw, input_size=self.input_size,
                    num_crops=self.num_crops,
                    disable_scaleup=self.disable_scaleup)  # (N,C,4), (N,C)
            else:
                crop, flip = sample_crop_flip(
                    hw, input_size=self.input_size, train=self.is_train,
                    version=self.augmentor_ver, scale_range=self.scale_range,
                    disable_scaleup=self.disable_scaleup, rng=rng)
                if not self.is_train:
                    flip = np.zeros_like(flip)
            batch[f"{m}_frames"] = bufs[f"{m}_frames"]
            batch[f"{m}_crop"] = crop
            batch[f"{m}_flip"] = flip
        first = labels[0]
        if isinstance(first, (int, np.integer)):
            batch["target"] = np.asarray(labels, np.int32)
        else:
            batch["target"] = np.stack(labels).astype(np.float32)
        return batch

    def _sample_rng(self, index: int) -> np.random.RandomState:
        """Per-sample RandomState keyed on (seed, epoch, index): identical
        seeds reproduce identical frame indices regardless of thread
        scheduling, and no worker ever touches the global np.random.

        Each thread reseeds one RandomState of its own, valid until its
        next call: the state of ``RandomState(mix)``, without the OS
        entropy that a new one draws first and discards, a far slower call
        that holds the interpreter lock, which the consuming thread then
        waits out."""
        mix = (1_000_003 * self.seed + 9_176_957 * (self.epoch + 1)
               + 2_654_435_761 * index) % (2**31 - 1)
        rng = getattr(self._rngs, "rng", None)
        if rng is None:
            rng = self._rngs.rng = np.random.RandomState(mix)
        else:
            rng.seed(mix)
        return rng

    def _fetch(self, index: int):
        idx = int(index)
        get = getattr(self.dataset, "get_sample", None)
        if get is not None:
            return get(idx, self._sample_rng(idx))
        return self.dataset[idx]

    def __iter__(self) -> Iterator[Dict]:
        indices = self._indices()
        nb = len(self)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        rng = np.random.RandomState(
            (self.seed + 7919 * (self.epoch + 1)) % (2**31))

        pool = ThreadPoolExecutor(max_workers=self.workers)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        # with a card, page-locked buffers that this thread allocates and
        # hands to the producer; without, new numpy arrays a batch
        pinned = self.pinned.available()
        free: "queue.SimpleQueue" = queue.SimpleQueue()

        def produce():
            spec = None
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    samples = list(pool.map(self._fetch,
                                            [int(i) for i in idxs]))
                    spec = spec or self._spec(samples[0])
                    n = len(samples)
                    if pinned:
                        try:
                            bufs = free.get_nowait()
                        except queue.Empty:
                            out_q.put(_Need(spec))
                            bufs = free.get()
                        if bufs is None:
                            return
                        bufs = {k: (t if n == len(t) else t[:n]).numpy()
                                for k, t in bufs.items()}
                    else:
                        bufs = {k: np.empty((n,) + shape, dtype)
                                for k, (shape, dtype) in spec.items()}
                    # a count and seconds a batch (utils/profiling.py)
                    with counted("data.collate"):
                        self._fill(pool, bufs, samples)
                        box = [self._collate(samples, rng, bufs)]
                    del bufs, samples
                    # the consumer empties the box: its reference to the
                    # batch is then the only one
                    out_q.put(box)
                out_q.put(None)
            except BaseException as e:  # surface worker errors to consumer
                out_q.put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        spec, handed = None, 0

        def hand() -> None:
            """A batch's buffers to the producer, while batches remain
            without: one at its request, and one at each batch taken, so
            that it can fill ahead while this thread is away."""
            nonlocal handed
            if handed < nb:
                handed += 1
                with counted("data.pinned_alloc"):
                    free.put({k: self.pinned.empty(
                        (self.batch_size,) + shape, dtype)
                        for k, (shape, dtype) in spec.items()})

        try:
            while True:
                batch = None  # the consumer alone holds what it took
                item = out_q.get()
                if isinstance(item, _Need):
                    spec = item.spec
                    hand()
                    continue
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch = item.pop()
                if spec is not None:
                    hand()
                yield batch
        finally:
            stop.set()
            free.put(None)  # wakes a producer waiting for a buffer
            # fetches not yet begun are cancelled: an early break waits
            # only for the samples being fetched
            pool.shutdown(wait=False, cancel_futures=True)
            while producer.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    producer.join(0.01)
            pool.shutdown(wait=True)
