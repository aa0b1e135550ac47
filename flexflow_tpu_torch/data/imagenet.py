"""ImageNet-style directory dataset and its training batch stream (PyTorch
port of ``flexflow_tpu/data/imagenet.py``).

The reference's loader (model.cc:156-205, model.cu:97-211), as the JAX
package has it:

  * the dataset root holds ``train/<labelId>/<sample>`` (and ``val/``);
    each subdirectory of a split is one class, label indices given by
    the sorted directory names;
  * samples are (label, file) pairs; ``get_samples`` walks the list with
    wraparound; ``shuffle_samples`` reshuffles it from
    ``np.random.RandomState(seed)``;
  * images are JPEG-decoded, nearest-neighbor resized to the model's
    input (index ``floor(v * scale + 0.5)``, clamped) and normalized
    ``(u8/256 - mean) / std`` with the ImageNet mean and std, in NHWC
    float32.

Decode runs on the native thread pool (``data/native.py``) with batches
submitted ahead, or with PIL where the native library cannot be built;
the stream names the decoder it took (``decoder``, a log line and a
``data_decoder`` record).  The PIL path retries a transient ``OSError``
per file and skips a permanently bad file within a budget, with the JAX
package's records and messages.

The stream differs from JAX's in what each process decodes: every rank
walks the same seeded sample list and decodes only its block's rows of
each global batch (``machine.batch_block``), so that a world of N ranks
decodes each image once and the global batch is JAX's.  It yields
tensors on the machine's device (``place=False``: host tensors, for the
``DevicePrefetcher``), and an elastic resize rebinds it to the new
machine's blocks (:meth:`ImageStream.rebind`), as ``data.BlockStream``.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ImageDataset:
    """(label, file) sample list for one split of a directory tree."""

    def __init__(self, root: str, split: str = "train"):
        split_dir = os.path.join(root, split)
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(f"no {split!r} split under {root!r}")
        self.root = root
        self.split = split
        self.class_names: List[str] = sorted(
            d for d in os.listdir(split_dir)
            if os.path.isdir(os.path.join(split_dir, d)))
        self.samples: List[Tuple[int, str]] = []
        for label, cls in enumerate(self.class_names):
            cdir = os.path.join(split_dir, cls)
            for fname in sorted(os.listdir(cdir)):
                path = os.path.join(cdir, fname)
                if os.path.isfile(path):
                    self.samples.append((label, path))
        if not self.samples:
            raise ValueError(f"empty dataset at {split_dir!r}")
        self._pos = 0

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def __len__(self) -> int:
        return len(self.samples)

    def shuffle_samples(self, seed: Optional[int] = None) -> None:
        """Reshuffle in place (``DataLoader::shuffle_samples``,
        model.cc:202-205), deterministic when seeded."""
        rng = np.random.RandomState(seed)
        perm = rng.permutation(len(self.samples))
        self.samples = [self.samples[i] for i in perm]
        self._pos = 0

    def get_samples(self, n: int) -> Tuple[List[int], List[str]]:
        """The next n (label, file) pairs, wrapping around at the end of
        an epoch (``DataLoader::get_samples``, model.cc:189-199)."""
        labels, files = [], []
        for _ in range(n):
            if self._pos >= len(self.samples):
                self._pos = 0
            lbl, f = self.samples[self._pos]
            self._pos += 1
            labels.append(lbl)
            files.append(f)
        return labels, files

    def seek(self, pulled: int) -> None:
        """Stand where ``pulled`` samples drawn from the start of the
        list leave the cursor."""
        self._pos = pulled % len(self.samples)


def _decode_one(path: str, height: int, width: int) -> np.ndarray:
    """Decode, resize and normalize one file (the retry and skip unit of
    the PIL path; PIL raises ``OSError`` subclasses on corrupt or
    unreadable files)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8)
    oh, ow = arr.shape[:2]
    # floor(v + 0.5), the native loader's and the reference's rounding
    # (np.round would round half to even)
    ys = np.minimum(np.floor(np.arange(height) * (oh / height) + 0.5)
                    .astype(np.int64), oh - 1)
    xs = np.minimum(np.floor(np.arange(width) * (ow / width) + 0.5)
                    .astype(np.int64), ow - 1)
    resized = arr[ys][:, xs].astype(np.float32)
    return (resized / 256.0 - IMAGENET_MEAN) / IMAGENET_STD


def decode_batch_pil(files: List[str], height: int,
                     width: int) -> np.ndarray:
    """The PIL decode of ``files``, with the native loader's resize and
    normalization."""
    out = np.zeros((len(files), height, width, 3), np.float32)
    for i, f in enumerate(files):
        out[i] = _decode_one(f, height, width)
    return out


class ImageStream:
    """This rank's blocks of the global batches of ``dataset``, forever:
    ``(images NHWC float32, labels int32)`` tensors on the machine's
    device (on ``device`` without a machine; host tensors with
    ``place=False``).  ``position`` counts the batches yielded;
    ``decoder`` is ``"native"`` or ``"pil"``."""

    def __init__(self, dataset: ImageDataset, batch_size: int, height: int,
                 width: int, machine=None, device="cuda",
                 num_threads: int = 4, prefetch: int = 2,
                 use_native: bool = True, place: bool = True, olog=None,
                 retry_attempts: int = 4, skip_budget: int = 16, log=None):
        from flexflow_tpu_torch import obs
        from flexflow_tpu_torch.data import native
        from flexflow_tpu_torch.utils.retry import RetryPolicy

        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.height, self.width = int(height), int(width)
        self.prefetch = max(int(prefetch), 1)
        self.place = place
        self.olog = olog if olog is not None else obs.NULL
        self.policy = RetryPolicy(attempts=max(int(retry_attempts), 1))
        self.skip_budget = int(skip_budget)
        self.skips = 0
        self.position = 0
        self._device = device
        # samples drawn to replace skipped ones: they shift the cursor
        self._drawn = 0
        self._loader = None
        reason = "use_native=False"
        if use_native:
            try:
                self._loader = native.NativeLoader(self.height, self.width,
                                                   num_threads)
            except RuntimeError as e:
                reason = str(e)
        self.decoder = "native" if self._loader is not None else "pil"
        fields = {"source": "imagenet", "decoder": self.decoder,
                  "samples": len(dataset), "classes": dataset.num_classes}
        if self._loader is None:
            fields["reason"] = reason
        self.olog.event("data_decoder", **fields)
        if log is not None:
            log(f"data: imagenet decoder {self.decoder} ({len(dataset)} "
                f"samples, {dataset.num_classes} classes"
                + (f"; {reason}" if self._loader is None else "") + ")")
        self._bind(machine)

    def _bind(self, machine) -> None:
        from flexflow_tpu_torch.machine import resolve_device

        self.machine = machine
        self.device = machine.device if machine is not None \
            else resolve_device(self._device) if self.place else None
        self.rows = (0, self.batch_size) if machine is None \
            else machine.batch_block(self.batch_size)
        if self._loader is not None:
            for _ in range(self.prefetch):
                self._submit()

    def rebind(self, machine, position: Optional[int] = None) -> None:
        """Yield ``machine``'s blocks from now on (every row when it is
        None), from batch ``position`` when given, else from where the
        stream stands.  Batches decoded ahead for the old blocks are
        dropped, and the cursor is put back where ``position`` batches
        and this rank's skips leave it."""
        if position is not None:
            self.position = int(position)
        if self._loader is not None:
            while self._loader.pending:
                self._loader.next()
        self.dataset.seek(self.position * self.batch_size + self._drawn)
        self._bind(machine)

    def _submit(self) -> None:
        lbls, files = self.dataset.get_samples(self.batch_size)
        lo, hi = self.rows
        self._loader.submit(files[lo:hi], lbls[lo:hi])

    def _decode_pil(self):
        """The block's rows of the next global batch under the retry and
        skip rules of ``flexflow_tpu/data/imagenet.py:image_batches``."""
        from flexflow_tpu_torch.utils import faultinject
        from flexflow_tpu_torch.utils.retry import call_with_retry

        olog, policy = self.olog, self.policy
        lbls, files = self.dataset.get_samples(self.batch_size)
        lo, hi = self.rows
        lbls, files = list(lbls[lo:hi]), list(files[lo:hi])
        img = np.zeros((hi - lo, self.height, self.width, 3), np.float32)
        for i in range(hi - lo):
            while True:
                f = files[i]

                def once(path=f):
                    faultinject.raise_if("data_io", site=f"imagenet:{path}")
                    return _decode_one(path, self.height, self.width)

                try:
                    img[i] = call_with_retry(
                        once, policy, retry_on=(OSError,),
                        on_retry=lambda e, n, d: olog.event(
                            "data_fault", source="imagenet",
                            action="retry", file=f, attempt=n,
                            delay_s=d, error=str(e)),
                        on_recover=lambda n: olog.event(
                            "recovery", source="imagenet",
                            after="retry", file=f, failures=n))
                    break
                except OSError as e:
                    # a permanently corrupt sample: skip it (within the
                    # budget) and take the dataset's next sample instead
                    self.skips += 1
                    if self.skips > self.skip_budget:
                        raise RuntimeError(
                            f"imagenet decode skip budget "
                            f"({self.skip_budget}) exhausted") from e
                    warnings.warn(
                        f"imagenet: skipping corrupt sample {f!r} after "
                        f"{policy.attempts} decode attempts: {e}",
                        RuntimeWarning)
                    olog.event("data_fault", source="imagenet",
                               action="skip", file=f, skips=self.skips,
                               error=str(e))
                    (rl,), (rf,) = self.dataset.get_samples(1)
                    self._drawn += 1
                    lbls[i], files[i] = rl, rf
        return img, np.asarray(lbls, np.int32)

    def __iter__(self) -> "ImageStream":
        return self

    def __next__(self) -> tuple:
        import torch

        if self._loader is not None:
            img, lbl = self._loader.next()
            self._submit()   # keep the pipeline full
        else:
            img, lbl = self._decode_pil()
        self.position += 1
        img, lbl = torch.from_numpy(img), torch.from_numpy(lbl)
        if not self.place:
            return img, lbl
        return img.to(self.device), lbl.to(self.device)

    def close(self) -> None:
        """Join the native loader's threads."""
        if self._loader is not None:
            self._loader.close()
            self._loader = None


def image_batches(machine, dataset: ImageDataset, batch_size: int,
                  height: int, width: int, num_threads: int = 4,
                  prefetch: int = 2, shuffle_seed: Optional[int] = 0,
                  use_native: bool = True, place: bool = True,
                  olog=None, retry_attempts: int = 4,
                  skip_budget: int = 16, device="cuda",
                  log=None) -> ImageStream:
    """The JAX package's ``image_batches`` (same arguments, same retry,
    skip and budget rules, same records): ``dataset`` reshuffled from
    ``shuffle_seed`` (None: as it stands), then an :class:`ImageStream`
    of ``machine``'s blocks (every row on ``device`` when ``machine`` is
    None), ``prefetch`` batches decoding ahead on the native loader."""
    if shuffle_seed is not None:
        dataset.shuffle_samples(shuffle_seed)
    return ImageStream(dataset, batch_size, height, width, machine=machine,
                       device=device, num_threads=num_threads,
                       prefetch=prefetch, use_native=use_native,
                       place=place, olog=olog,
                       retry_attempts=retry_attempts,
                       skip_budget=skip_budget, log=log)
