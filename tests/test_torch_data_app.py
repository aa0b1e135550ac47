"""The port's drivers on file datasets, on the CPU, against the JAX
package's:

* ``apps.cnn alexnet -d <tree>`` (67x67, batch 8, a JPEG tree of three
  classes written here): its losses against JAX's ``apps.cnn`` on the
  same tree, the port starting from JAX's parameters
  (``interop.params_from_jax``), within ``torch_ranks.LOSS_RTOL`` /
  ``LOSS_ATOL``; ``num_classes`` taken from the tree, and ``--classes``
  smaller than the tree refused with JAX's message;
* the same run on two gloo ranks (each decoding its block of every
  batch) against one process;
* ``apps.cnn -d <file>.h5`` on the CPU;
* ``apps.fault_smoke``: ``main`` returns 0, and its recovery run's
  records are JAX's kinds in JAX's order, the training loop's and the
  reader's each (the reader's thread writes beside the loop).
"""

import numpy as np
import pytest
import torch

import torch_ranks as tr
from flexflow_tpu.apps import cnn as j_cnn
from flexflow_tpu.apps import fault_smoke as j_smoke
from flexflow_tpu.model import FFModel as JModel
from flexflow_tpu_torch.apps import cnn as t_cnn
from flexflow_tpu_torch.apps import fault_smoke as t_smoke
from flexflow_tpu_torch.interop import params_from_jax
from flexflow_tpu_torch.machine import MachineModel
from flexflow_tpu_torch.model import FFModel as TModel

h5py = pytest.importorskip("h5py")
torch.set_num_threads(2)

ARGV = ["alexnet", "-b", "8", "-i", "3", "--height", "67", "--width", "67",
        "--lr", "0.001", "-p", "0"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """train/{a,b,c}/*.jpg: 15 images of mixed sizes around 67 px."""
    from PIL import Image

    root = tmp_path_factory.mktemp("cnn_tree")
    rng = np.random.RandomState(1)
    for cls in ("a", "b", "c"):
        d = root / "train" / cls
        d.mkdir(parents=True)
        for i in range(5):
            h, w = rng.randint(50, 100, size=2)
            arr = rng.randint(0, 255, size=(h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{i}.jpg", quality=90)
    return str(root)


def test_cnn_app_on_a_jpeg_tree_matches_jax(tree, monkeypatch):
    seen = {}
    j_init = JModel.init

    def init(self, *args, **kwargs):
        params, state = j_init(self, *args, **kwargs)
        seen["tree"] = tr.jax_logical(self, params, state)[0]
        return params, state

    monkeypatch.setattr(JModel, "init", init)
    want = j_cnn.main(ARGV + ["-d", tree], log=lambda *a: None)["loss"]
    params = params_from_jax(seen["tree"], "cpu")
    monkeypatch.setattr(TModel, "init", lambda self, seed=None: (params, {}))
    lines = []
    got = t_cnn.main(ARGV + ["-d", tree, "--device", "cpu"],
                     log=lines.append)
    np.testing.assert_allclose(got["loss"], want, rtol=tr.LOSS_RTOL,
                               atol=tr.LOSS_ATOL)
    assert "data: imagenet decoder native (15 samples, 3 classes)" in lines
    _, cfg, _, _ = t_cnn.parse(ARGV + ["-d", tree])
    assert t_cnn.scan_dataset(cfg, []).num_classes == cfg.num_classes == 3
    for main in (j_cnn.main, t_cnn.main):
        with pytest.raises(SystemExit, match="--classes 2 but dataset has "
                                             "3 class directories"):
            main(ARGV + ["-d", tree, "--classes", "2", "--device", "cpu"],
                 log=lambda *a: None)


def test_cnn_app_on_a_jpeg_tree_over_two_ranks_matches_one(tree):
    argv = ARGV + ["-d", tree, "--device", "cpu"]
    got = tr.run_ranks(tr.app_main, 2, argv, timeout=150)
    assert got[1] is None
    want = t_cnn.main(argv, log=lambda *a: None)["loss"]
    np.testing.assert_allclose(got[0], want, rtol=tr.LOSS_RTOL,
                               atol=tr.LOSS_ATOL)


def test_cnn_app_on_hdf5_files(tmp_path):
    path = str(tmp_path / "d.h5")
    rng = np.random.RandomState(0)
    with h5py.File(path, "w") as f:
        f["images"] = rng.randint(0, 255, (12, 67, 67, 3), dtype=np.uint8)
        f["labels"] = rng.randint(0, 10, 12).astype(np.int32)
    out = t_cnn.main(ARGV + ["-d", f"{path},{path}", "--classes", "10",
                             "--device", "cpu"], log=lambda *a: None)
    assert len(out["loss"]) == 3 and np.all(np.isfinite(out["loss"]))


def _streams(records):
    """(the loop's records, the reader's records): kind and source, in
    write order; the reader's are the data surface's and the injected
    read faults."""
    keep = ("fault", "rollback", "recovery", "data_fault", "checkpoint_save")
    loop, reader = [], []
    for e in records:
        if e["kind"] not in keep:
            continue
        item = (e["kind"], e.get("source"), e.get("fault"), e.get("action"),
                e.get("after"))
        if e.get("surface") == "data" or e.get("fault") == "data_io":
            reader.append(item)
        else:
            loop.append(item)
    return loop, reader


def _jax_recovery(tmp_path):
    """JAX's ``fault_smoke`` recovery run (``main``'s body without its
    ``summarize``), its records."""
    import os

    from flexflow_tpu import obs
    from flexflow_tpu.data.hdf5 import hdf5_batches
    from flexflow_tpu.machine import MachineModel as JMachine

    machine = JMachine()
    h5 = j_smoke._write_h5(os.path.join(tmp_path, "data.h5"))
    cfg = j_smoke._cfg(ckpt_dir=os.path.join(tmp_path, "ckpt"), ckpt_freq=2,
                       obs_dir=os.path.join(tmp_path, "obs"),
                       run_id="fault-smoke", on_divergence="rollback",
                       fault_spec=j_smoke.FAULT_SPEC)
    ff = j_smoke._build(cfg, machine)
    data_olog = obs.from_config(cfg, surface="data")
    try:
        out = ff.fit(hdf5_batches(machine, [h5], cfg.batch_size,
                                  olog=data_olog), log=lambda *a: None)
    finally:
        data_olog.close()
    return out, list(obs.read_run(out["obs_path"]))


def test_fault_smoke_passes_with_jax_records(tmp_path):
    lines = []
    assert t_smoke.main(["--device", "cpu"], log=lines.append) == 0
    assert lines[-1].startswith("fault-smoke ok: 12 iters survived "
                                "'data_io@3x2,loss_nan@7' with 1 rollback")
    # the counts come from obs.report.summarize, as in the JAX smoke, and
    # read as the smoke's own count of the four kinds did
    assert lines[-1].endswith("records: data_fault=2, fault=4, "
                              "recovery=2, rollback=1")
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = t_smoke.run_recovery(MachineModel("cpu"), str(tmp_path / "t"),
                               log=lambda *a: None)
    want, jrecords = _jax_recovery(str(tmp_path / "j"))
    assert got["rollbacks"] == want["rollbacks"] == 1
    loop, reader = _streams(got["records"])
    assert (loop, reader) == _streams(jrecords)
    assert [r[0] for r in reader] == ["fault", "data_fault", "fault",
                                      "data_fault", "recovery"]
