"""Input pipelines of the PyTorch port (counterparts of
``flexflow_tpu/data/``), the reference's three loaders:

  * :func:`synthetic_batches` and :func:`synthetic_token_stream` — seeded
    synthetic images, labels and tokens, the default without ``-d``;
  * :class:`ImageDataset` / :func:`image_batches` — an ImageNet-style
    ``<root>/train/<label>/<file>.jpg`` tree, decoded on the native
    loader's threads or with PIL (``data/imagenet.py``, ``data/native.py``);
  * :func:`hdf5_batches` — HDF5 batch files, round robin with a prefetch
    thread (``data/hdf5.py``);

and the device prefetcher (``data/prefetch.py``).  ``h5py`` and PIL are
imported only when their source is made.
"""

from flexflow_tpu_torch.data.hdf5 import hdf5_batches
from flexflow_tpu_torch.data.imagenet import (ImageDataset, ImageStream,
                                              image_batches)
from flexflow_tpu_torch.data.synthetic import (BlockStream,
                                               synthetic_batches,
                                               synthetic_token_stream)

__all__ = ["BlockStream", "synthetic_batches", "synthetic_token_stream",
           "ImageDataset", "ImageStream", "image_batches", "hdf5_batches"]
