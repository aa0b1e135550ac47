"""The port's file readers against the JAX package's, on the CPU
(``tests/test_data.py`` and the reader tests of ``tests/test_faults.py``):
the ImageNet-style tree's scan, wraparound and seeded shuffle; the
native loader's decode and FIFO order; ``image_batches`` on the native
and the PIL path, whose first batches are bit-equal to JAX's
``place=False`` batches; a corrupt file skipped with JAX's records and
warning, and the skip budget's message; HDF5 batches (two files, a batch
larger than its file), the transient fault, the skipped range, the
budget and the thread-leak record; the streams' blocks over two ranks
and both streams' rebinding from two ranks to one; ``apps.cnn -d f.h5
--elastic`` shrinking from two gloo ranks to one.

Both packages read the same files, written here with PIL and h5py; each
record list is held to JAX's but for the port's own ``data_decoder``
record (the decoder it took).
"""

import threading
import warnings

import numpy as np
import pytest
import torch

import torch_ranks as tr
from flexflow_tpu.data import hdf5 as j_hdf5
from flexflow_tpu.data import imagenet as j_img
from flexflow_tpu.data import native as j_native
from flexflow_tpu.utils import faultinject as j_fi
from flexflow_tpu_torch.data import hdf5 as t_hdf5
from flexflow_tpu_torch.data import imagenet as t_img
from flexflow_tpu_torch.data import native as t_native
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.utils import faultinject as t_fi

h5py = pytest.importorskip("h5py")

SIZE = 9   # the decoded height and width


class Records:
    """An obs sink that keeps its records as (kind, fields)."""
    enabled = True

    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append((kind, fields))

    def close(self):
        pass

    def kinds(self, drop=("data_decoder",)):
        return [(k, f) for k, f in self.events if k not in drop]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """train/{cat,dog,eel}/img*.jpg at mixed sizes, one grayscale."""
    from PIL import Image

    root = tmp_path_factory.mktemp("torch_imagenet")
    rng = np.random.RandomState(0)
    for ci, cls in enumerate(("cat", "dog", "eel")):
        d = root / "train" / cls
        d.mkdir(parents=True)
        for i in range(3):
            h, w = 11 + 3 * i + ci, 13 + 2 * i
            arr = rng.randint(0, 255, size=(h, w, 3), dtype=np.uint8)
            im = Image.fromarray(arr)
            if (ci, i) == (2, 1):
                im = im.convert("L")
            im.save(d / f"img{i}.jpg", quality=90)
    return str(root)


def _both(root):
    return j_img.ImageDataset(root), t_img.ImageDataset(root)


def _stream(ds, batch, **kw):
    kw.setdefault("shuffle_seed", 5)
    return t_img.image_batches(None, ds, batch, SIZE, SIZE, place=False,
                               device="cpu", **kw)


def _jstream(ds, batch, **kw):
    kw.setdefault("shuffle_seed", 5)
    return j_img.image_batches(None, ds, batch, SIZE, SIZE, place=False,
                               **kw)


def test_scan_wraparound_and_seeded_shuffle(tree):
    jd, td = _both(tree)
    assert td.class_names == jd.class_names == ["cat", "dog", "eel"]
    assert td.samples == jd.samples and td.num_classes == 3
    for n in (4, 4, 5):   # 13 of 9 samples: the third call wraps
        assert td.get_samples(n) == jd.get_samples(n)
    jd.shuffle_samples(7)
    td.shuffle_samples(7)
    assert td.samples == jd.samples
    other = t_img.ImageDataset(tree)
    other.shuffle_samples(8)
    assert other.samples != td.samples
    with pytest.raises(FileNotFoundError, match="no 'val' split"):
        t_img.ImageDataset(tree, "val")


def test_native_decode_matches_jax_and_pil(tree):
    jd, td = _both(tree)
    for _, f in td.samples:
        got = t_native.decode_image(f, SIZE, 11)
        assert got is not None and got.dtype == np.float32
        assert np.array_equal(got, j_native.decode_image(f, SIZE, 11))
        # the two decoders' JPEG decodes may round apart by one level
        pil = t_img._decode_one(f, SIZE, 11)
        assert np.array_equal(pil, j_img._decode_one(f, SIZE, 11))
        assert np.abs(got - pil).max() <= 0.1
    with pytest.raises(OSError, match="failed with code"):
        t_native.decode_image(tree + "/missing.jpg", SIZE, SIZE)


def test_native_loader_is_fifo(tree):
    _, td = _both(tree)
    loader = t_native.NativeLoader(SIZE, SIZE, num_threads=3)
    try:
        batches = [td.get_samples(n) for n in (4, 2, 5)]
        for labels, files in batches:
            loader.submit(files, labels)
        assert loader.pending == 3
        for labels, files in batches:
            img, lbl = loader.next()
            assert lbl.tolist() == labels and img.shape[0] == len(files)
            want = np.stack([j_native.decode_image(f, SIZE, SIZE)
                             for f in files])
            assert np.array_equal(img, want)
        with pytest.raises(RuntimeError, match="no submitted batch"):
            loader.next()
    finally:
        loader.close()


@pytest.mark.parametrize("use_native", [True, False])
def test_image_batches_equal_jax(tree, use_native):
    jd, td = _both(tree)
    jr, tr_ = Records(), Records()
    want = _jstream(jd, 4, use_native=use_native, olog=jr)
    got = _stream(td, 4, use_native=use_native, olog=tr_)
    assert got.decoder == ("native" if use_native else "pil")
    assert tr_.events[0] == ("data_decoder", dict(
        {"source": "imagenet", "decoder": got.decoder, "samples": 9,
         "classes": 3}, **({} if use_native else
                           {"reason": "use_native=False"})))
    for _ in range(4):   # 16 of 9 samples: through the wrap
        (ji, jl), (ti, tl) = next(want), next(got)
        assert ti.dtype == torch.float32 and tl.dtype == torch.int32
        assert np.array_equal(ti.numpy(), ji) and np.array_equal(
            tl.numpy(), jl)
    assert got.position == 4 and tr_.kinds() == jr.kinds() == []
    got.close()


def _corrupt_tree(tmp_path, names=("img1.jpg",)):
    from PIL import Image

    rng = np.random.RandomState(0)
    for cls in ("cat", "dog"):
        d = tmp_path / "train" / cls
        d.mkdir(parents=True)
        for i in range(3):
            arr = rng.randint(0, 255, size=(10, 12, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img{i}.jpg", quality=95)
    for name in names:
        (tmp_path / "train" / "cat" / name).write_bytes(b"not a jpeg")
    return str(tmp_path)


def test_corrupt_sample_is_skipped_as_in_jax(tmp_path):
    root = _corrupt_tree(tmp_path)
    jd, td = _both(root)
    jr, tr_ = Records(), Records()
    kw = dict(use_native=False, shuffle_seed=None, retry_attempts=2,
              skip_budget=4)
    with pytest.warns(RuntimeWarning) as jw:
        ji, jl = next(_jstream(jd, 6, olog=jr, **kw))
    with pytest.warns(RuntimeWarning) as tw:
        stream = _stream(td, 6, olog=tr_, **kw)
        ti, tl = next(stream)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert "skipping corrupt sample" in str(tw[0].message)
    assert np.array_equal(ti.numpy(), ji) and np.array_equal(tl.numpy(), jl)
    assert tr_.kinds() == jr.kinds()
    (skip,) = [f for k, f in tr_.kinds() if f.get("action") == "skip"]
    assert skip["source"] == "imagenet" and "img1.jpg" in skip["file"]
    assert stream.skips == 1


def test_skip_budget_message_as_in_jax(tmp_path):
    root = _corrupt_tree(tmp_path, ("img0.jpg", "img1.jpg", "img2.jpg"))
    jd, td = _both(root)
    kw = dict(use_native=False, shuffle_seed=None, retry_attempts=1,
              skip_budget=2)
    msgs = []
    for make, ds in ((_jstream, jd), (_stream, td)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with pytest.raises(RuntimeError) as e:
                next(make(ds, 6, **kw))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "imagenet decode skip budget (2) exhausted"


def test_injected_decode_faults_are_retried_as_in_jax(tree):
    records = []
    for pkg, make in ((j_fi, _jstream), (t_fi, _stream)):
        ds = (j_img if pkg is j_fi else t_img).ImageDataset(tree)
        rec = Records()
        prev = pkg.install(pkg.FaultInjector("data_io@3x2"))
        try:
            img, _ = next(make(ds, 4, use_native=False, olog=rec))
        finally:
            pkg.install(prev)
        records.append((rec.kinds(), np.asarray(img)))
    (jrec, jimg), (trec, timg) = records
    assert trec == jrec and np.array_equal(timg, jimg)
    assert [k for k, _ in trec] == ["data_fault", "data_fault", "recovery"]


def _h5(path, n, base=0, dtype=np.uint8, shape=(4, 4, 3)):
    with h5py.File(path, "w") as f:
        img = np.full((n,) + shape, base, dtype)
        img += np.arange(n, dtype=dtype).reshape((n,) + (1,) * len(shape))
        f["images"] = img
        f["labels"] = np.arange(n, dtype=np.int32) + base
    return str(path)


def _pair_h5(paths, batch, n, **kw):
    """The first ``n`` batches of both packages' streams, with records."""
    out = []
    for mod in (j_hdf5, t_hdf5):
        rec = Records()
        extra = {} if mod is j_hdf5 else {"device": "cpu"}
        it = mod.hdf5_batches(None, paths, batch, place=False, olog=rec,
                              **kw, **extra)
        got = [tuple(np.asarray(a) for a in next(it)) for _ in range(n)]
        it.close()
        out.append((got, rec.kinds()))
    return out


def test_hdf5_batches_equal_jax(tmp_path):
    paths = [_h5(tmp_path / f"part{i}.h5", 12, base=100 * i)
             for i in range(2)]
    (jb, _), (tb, _) = _pair_h5(paths, 8, 4)
    for (ji, jl), (ti, tl) in zip(jb, tb):
        assert ti.dtype == np.float32 and tl.dtype == np.int32
        assert np.array_equal(ti, ji) and np.array_equal(tl, jl)
    assert [b[1].tolist() for b in tb[:3]] == [
        list(range(8)), list(range(100, 108)), [8, 9, 10, 11, 0, 1, 2, 3]]


def test_hdf5_batch_larger_than_its_file(tmp_path):
    path = _h5(tmp_path / "small.h5", 3, dtype=np.float32, shape=(2, 2, 3))
    (jb, _), (tb, _) = _pair_h5([path], 8, 2)
    assert [b[1].tolist() for b in tb] == [b[1].tolist() for b in jb] == [
        [0, 1, 2, 0, 1, 2, 0, 1], [2, 0, 1, 2, 0, 1, 2, 0]]
    assert all(np.array_equal(t[0], j[0]) for t, j in zip(tb, jb))


@pytest.mark.parametrize("spec,kw,want_labels,kinds", [
    # attempts 2 and 3 fail, the 4th succeeds: transparent
    ("data_io@2x2", dict(retry_attempts=4),
     [list(range(8)), list(range(8, 16))],
     ["data_fault", "data_fault", "recovery"]),
    # read 1 fails twice of 2 tries: its range is skipped
    ("data_io@1x2", dict(retry_attempts=2, skip_budget=4),
     [list(range(8, 16))], ["data_fault", "data_fault"]),
])
def test_hdf5_faults_as_in_jax(tmp_path, spec, kw, want_labels, kinds):
    path = _h5(tmp_path / "f.h5", 32, dtype=np.float32)
    got = []
    for pkg in (j_fi, t_fi):
        prev = pkg.install(pkg.FaultInjector(spec))
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                (batches, rec), = [p for p, m in zip(
                    _pair_h5([path], 8, len(want_labels), **kw),
                    (j_fi, t_fi)) if m is pkg]
        finally:
            pkg.install(prev)
        got.append(([b[1].tolist() for b in batches], rec))
    assert got[0] == got[1]
    assert got[1][0] == want_labels
    assert [k for k, _ in got[1][1]] == kinds


def test_hdf5_skip_budget_as_in_jax(tmp_path):
    path = _h5(tmp_path / "f.h5", 32, dtype=np.float32)
    causes = []
    for pkg, mod in ((j_fi, j_hdf5), (t_fi, t_hdf5)):
        prev = pkg.install(pkg.FaultInjector("data_io@1x1000"))
        try:
            it = mod.hdf5_batches(None, [path], 8, place=False,
                                  retry_attempts=2, skip_budget=2)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                with pytest.raises(RuntimeError,
                                   match="hdf5 prefetch thread") as e:
                    next(it)
            it.close()
        finally:
            pkg.install(prev)
        causes.append(str(e.value.__cause__))
    assert causes[0] == causes[1] == "hdf5 read skip budget (2) exhausted"


def test_hdf5_thread_leak_is_recorded(tmp_path, monkeypatch):
    path = _h5(tmp_path / "f.h5", 16)
    release, entered = threading.Event(), threading.Event()
    read = t_hdf5._read_batch

    def slow(*args):
        entered.set()
        release.wait(10)   # a read the stop event cannot cut short
        return read(*args)

    monkeypatch.setattr(t_hdf5, "_JOIN_TIMEOUT_S", 0.1)
    rec = Records()
    it = t_hdf5.hdf5_batches(None, [path], 8, place=False, olog=rec,
                             device="cpu")
    monkeypatch.setattr(t_hdf5, "_read_batch", slow)
    next(it)
    # close only once the reader is inside the read: before it, the
    # reader sees the stop event and exits in time
    assert entered.wait(10)
    with pytest.warns(RuntimeWarning, match="did not exit within 0.1s"):
        it.close()
    assert rec.events == [("thread_leak", {"source": "hdf5_batches",
                                           "timeout_s": 0.1})]
    release.set()


def test_streams_cut_blocks_and_rebind_from_two_ranks_to_one(tmp_path,
                                                            tree):
    ranks = [MachineModel("cpu", 2, r) for r in range(2)]
    one = MachineModel("cpu")
    whole = _stream(t_img.ImageDataset(tree), 4)
    want = [next(whole) for _ in range(3)]
    halves = [t_img.image_batches(m, t_img.ImageDataset(tree), 4, SIZE,
                                  SIZE, shuffle_seed=5) for m in ranks]
    first = [next(h) for h in halves]
    assert torch.equal(torch.cat([f[0] for f in first]), want[0][0])
    assert torch.equal(torch.cat([f[1] for f in first]), want[0][1])
    # rank 0 goes on alone from batch 1: the whole batches, as one rank's
    halves[0].rebind(one, 1)
    for w in want[1:]:
        got = next(halves[0])
        assert torch.equal(got[0], w[0]) and torch.equal(got[1], w[1])
    assert halves[0].position == 3
    for h in halves:
        h.close()
    path = _h5(tmp_path / "f.h5", 16)
    full = next(t_hdf5.hdf5_batches(None, [path], 8, device="cpu"))
    parts = [next(t_hdf5.hdf5_batches(m, [path], 8)) for m in ranks]
    assert torch.equal(torch.cat([p[1] for p in parts]), full[1])


def test_hdf5_stream_rebinds_from_two_ranks_to_one(tmp_path):
    """Two ranks read their halves of each global batch; rank 0 rebinds
    to one rank at batch 1 and yields the whole batches, as the image
    stream does: every file's cursor at batch 1 (two files, round
    robin), the batches read ahead for the old half dropped."""
    paths = [_h5(tmp_path / f"p{i}.h5", 12, base=50 * i) for i in range(2)]
    ranks = [MachineModel("cpu", 2, r) for r in range(2)]
    one = MachineModel("cpu")
    whole = t_hdf5.hdf5_batches(None, paths, 4, device="cpu")
    want = [next(whole) for _ in range(5)]
    whole.close()
    halves = [t_hdf5.hdf5_batches(m, paths, 4) for m in ranks]
    first = [next(h) for h in halves]
    for k in range(2):
        assert torch.equal(torch.cat([f[k] for f in first]), want[0][k])
    halves[0].rebind(one, 1)
    for w in want[1:]:
        got = next(halves[0])
        assert torch.equal(got[0], w[0]) and torch.equal(got[1], w[1])
    assert halves[0].position == 5
    # a rebind with no position goes on from where the stream stands
    halves[1].rebind(one)
    for w in want[1:3]:
        assert torch.equal(next(halves[1])[1], w[1])
    for h in halves:
        h.close()
        assert not h._thread.is_alive()


def test_cnn_app_hdf5_elastic_shrinks_over_two_ranks(tmp_path):
    """``apps.cnn -d f.h5 --elastic`` on two gloo ranks: rank 1 is lost
    at step 2 and the run goes on alone with the whole batches, its
    losses the healthy two-rank run's."""
    path = _h5(tmp_path / "f.h5", 24, shape=(67, 67, 3))
    argv = ["alexnet", "-b", "4", "--height", "67", "--width", "67", "-i",
            "5", "--lr", "0.001", "--device", "cpu", "-p", "1", "-d", path]
    res = tr.run_ranks(tr.run_cases, 2, [
        ("app_main", (argv, "cnn", True)),
        ("app_main", (argv + ["--elastic", "--min-devices", "1",
                              "--research-budget-s", "5", "--fault-spec",
                              "device_loss@2"], "cnn", True))],
        timeout=180.0)
    (healthy, _), (shrunk, lines) = res[0]
    assert res[1][1][0] is None
    assert len(shrunk) == 5
    np.testing.assert_allclose(shrunk, healthy, rtol=1e-4)
    assert any("resized 2 -> 1 devices at iteration 2" in s
               for s in lines), lines
