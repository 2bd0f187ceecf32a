"""Port parity: the data plane (``datasets/``) and the pod helpers
(``platforms/tpu_pod.py``) against the JAX package, bitwise.

The same inputs (seeds, env dicts, files written to ``tmp_path``) go
through both packages: the elastic adaptor's sequences through a resize,
a skip and an epoch change; the MNIST IDX reader, the CIFAR pickle
reader and their hash pins; the three synthetic fallbacks; the ImageNet
folder's scan, PIL decode and augmentation; device prefetch on the CPU;
the pod env parse and the slice layouts.  No test reaches the network:
every cache dir is under ``tmp_path`` and ``urllib.request.urlopen`` is
replaced by one that refuses, so the readers' fetch on a miss runs and
fails at once, as an air-gapped host's does.
"""

import gzip
import io
import os
import pickle
import struct
import tarfile
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from kungfu_tpu.datasets import ElasticDataset as JElastic
from kungfu_tpu.datasets import ImageNetFolder as JImageNet
from kungfu_tpu.datasets import cifar as jcifar
from kungfu_tpu.datasets import mnist as jmnist
from kungfu_tpu.platforms import tpu_pod as jpod
from kungfu_tpu_torch.datasets import ElasticDataset, ImageNetFolder
from kungfu_tpu_torch.datasets import cache, cifar, mnist
from kungfu_tpu_torch.datasets import prefetch_to_device
from kungfu_tpu_torch.monitor import timeline
from kungfu_tpu_torch.platforms import tpu_pod


@pytest.fixture(autouse=True)
def _no_network(monkeypatch):
    """Every fetch attempt fails at once, in both packages."""
    calls = []

    def refuse(url, *a, **k):
        calls.append(url)
        raise OSError(f"no network in tests: {url}")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    return calls


# -- ElasticDataset ------------------------------------------------------------

def _pair(*args, **kw):
    return JElastic(*args, **kw), ElasticDataset(*args, **kw)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


class TestElasticDataset:
    def test_sequence_through_resize_skip_and_epochs(self):
        x = np.arange(100, dtype=np.float32).reshape(50, 2)
        y = np.arange(50, dtype=np.int32)
        j, t = _pair([x, y], batch_size=4, rank=1, size=3, seed=5)
        for step in range(12):
            if step == 3:
                j.set_cluster(0, 2), t.set_cluster(0, 2)
            if step == 6:
                j.skip(37), t.skip(37)
            if step == 9:
                j.set_cluster(2, 4), t.set_cluster(2, 4)
            _same(j.next_batch(), t.next_batch())
            assert j.consumed == t.consumed
        assert j.batches_per_epoch() == t.batches_per_epoch()
        a = [b for b in j.epochs(2)]
        b = [b for b in t.epochs(2)]
        assert len(a) == len(b) > 0
        for u, v in zip(a, b):
            _same(u, v)

    def test_no_shuffle_and_refusals(self):
        j, t = _pair([np.arange(12)], batch_size=4, shuffle=False)
        _same(j.next_batch(), t.next_batch())
        for bad in (dict(batch_size=0), dict(batch_size=2, rank=2, size=2)):
            with pytest.raises(ValueError):
                ElasticDataset([np.arange(4)], **bad)
        with pytest.raises(ValueError, match="smaller than one global"):
            ElasticDataset([np.arange(4)], batch_size=8).next_batch()
        with pytest.raises(ValueError):
            ElasticDataset([np.arange(4), np.arange(5)], batch_size=1)

    def test_sync_consumed_adopts_the_max(self):
        class Engine:
            def __init__(self, peers):
                self.peers = peers

            def all_reduce(self, x, op, record):
                assert op == "max" and record is False
                return np.max([p.consumed for p in self.peers],
                              keepdims=True).astype(x.dtype)

        class Peer:
            def __init__(self, e):
                self._e = e

            def engine(self):
                return self._e

        for cls in (JElastic, ElasticDataset):
            ds = [cls([np.arange(640)], 16, rank=i, size=2, seed=1)
                  for i in range(2)]
            ds[0].skip(320)
            eng = Engine(ds)
            assert [d.sync_consumed(Peer(eng)) for d in ds] == [320, 320]
            assert ds[1].consumed == 320


# -- MNIST ---------------------------------------------------------------------

def _write_idx(path, arr):
    arr = np.asarray(arr, np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x800 | arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.tobytes())


class TestMnist:
    def test_synthetic_bitwise(self):
        for kw in ({}, {"n": 64, "seed": 3}):
            _same(jmnist.synthetic_mnist(**kw), mnist.synthetic_mnist(**kw))

    def test_raw_idx_cache(self, tmp_path):
        rng = np.random.RandomState(0)
        _write_idx(tmp_path / "train-images-idx3-ubyte",
                   rng.randint(0, 256, size=(32, 28, 28)))
        _write_idx(tmp_path / "train-labels-idx1-ubyte",
                   rng.randint(0, 10, size=(32,)))
        for mod in (jmnist, mnist):
            with pytest.raises((ValueError, RuntimeError)):
                mod.load_mnist("train", cache_dir=str(tmp_path),
                               synthetic_fallback=False, timeout=0.01)
        kw = dict(cache_dir=str(tmp_path), verify=False, timeout=0.01)
        _same(jmnist.load_mnist("train", **kw), mnist.load_mnist("train", **kw))
        kw["normalize"] = False
        _same(jmnist.load_mnist("train", **kw), mnist.load_mnist("train", **kw))

    def test_gz_pin_rejects_tampering(self, tmp_path):
        for name, arr in (("train-images-idx3-ubyte", np.zeros((4, 28, 28))),
                          ("train-labels-idx1-ubyte", np.zeros((4,)))):
            _write_idx(tmp_path / "tmp", arr)
            with open(tmp_path / "tmp", "rb") as fi, \
                    gzip.open(tmp_path / f"{name}.gz", "wb") as fo:
                fo.write(fi.read())
            os.unlink(tmp_path / "tmp")
        for mod in (jmnist, mnist):
            with pytest.raises((ValueError, RuntimeError)):
                mod.load_mnist("train", cache_dir=str(tmp_path),
                               synthetic_fallback=False, timeout=0.01)
        kw = dict(cache_dir=str(tmp_path), timeout=0.01)
        _same(mnist.load_mnist("train", **kw), mnist.synthetic_mnist())
        kw.update(verify=False, synthetic_fallback=False)
        _same(jmnist.load_mnist("train", **kw), mnist.load_mnist("train", **kw))

    def test_airgapped(self, tmp_path, _no_network):
        empty = str(tmp_path / "empty")
        _same(mnist.load_mnist("train", cache_dir=empty, timeout=0.01),
              jmnist.load_mnist("train", cache_dir=empty, timeout=0.01))
        assert _no_network and all("mnist" in u for u in _no_network)
        with pytest.raises(RuntimeError):
            mnist.load_mnist("test", cache_dir=empty,
                             synthetic_fallback=False, timeout=0.01)
        with pytest.raises(ValueError):
            mnist.load_mnist("val", cache_dir=empty)
        assert mnist.FILES == jmnist.FILES and mnist.MIRRORS == jmnist.MIRRORS


# -- CIFAR-10 ------------------------------------------------------------------

def _fake_cifar(path):
    """A tar.gz in CIFAR-10's layout: five data batches and a test batch
    of 3 images each, NCHW bytes in pickles."""
    rng = np.random.RandomState(1)
    with tarfile.open(path, "w:gz") as tf:
        for name in [f"data_batch_{i}" for i in (3, 1, 5, 2, 4)] + \
                ["test_batch", "batches.meta"]:
            d = {b"data": rng.randint(0, 256, size=(3, 3072)).astype(np.uint8),
                 b"labels": list(rng.randint(0, 10, size=3))}
            blob = pickle.dumps(d)
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


class TestCifar:
    def test_synthetic_bitwise(self, tmp_path, monkeypatch):
        monkeypatch.setenv(cache.DATA_DIR_ENV, str(tmp_path))
        kw = dict(timeout=0.01, n_synthetic_train=256, n_synthetic_test=64)
        a, b = jcifar.load_cifar10(**kw), cifar.load_cifar10(**kw)
        for u, v in zip(a, b):
            _same(u, v)
        assert b[0][0].shape == (256, 32, 32, 3)

    def test_reader_bitwise(self, tmp_path):
        path = str(tmp_path / "c.tar.gz")
        _fake_cifar(path)
        _same(jcifar._read_batches(path), cifar._read_batches(path))
        assert cifar._read_batches(path)[0].shape == (15, 32, 32, 3)

    def test_strict_and_pin(self, tmp_path, monkeypatch):
        monkeypatch.setenv(cache.DATA_DIR_ENV, str(tmp_path / "empty"))
        with pytest.raises(OSError):
            cifar.load_cifar10(synthetic_fallback=False, timeout=0.01)
        monkeypatch.setenv(cache.DATA_DIR_ENV, str(tmp_path))
        d = cifar.data_dir()
        assert d == jcifar.data_dir() == str(tmp_path / "cifar10")
        os.makedirs(d, exist_ok=True)
        _fake_cifar(os.path.join(d, cifar.ARCHIVE))
        with pytest.raises(ValueError, match="sha256"):
            cifar.load_cifar10(timeout=0.01)
        (xa, ya), (ta, tya) = jcifar.load_cifar10(verify=False)
        (xb, yb), (tb, tyb) = cifar.load_cifar10(verify=False)
        _same((xa, ya, ta, tya), (xb, yb, tb, tyb))
        assert cifar.ARCHIVE_SHA256 == jcifar.ARCHIVE_SHA256


# -- ImageNet ------------------------------------------------------------------

def _tree(tmp_path, n_per_class=3):
    from PIL import Image

    root = tmp_path / "imagenet"
    rng = np.random.default_rng(0)
    for ci, wnid in enumerate(["n01440764", "n01443537"]):
        d = root / "train" / wnid
        d.mkdir(parents=True)
        for j in range(n_per_class):
            arr = rng.integers(0, 255, size=(48 + 8 * ci, 64, 3)).astype(
                "uint8")
            Image.fromarray(arr).save(d / f"img{j}.JPEG")
        (d / "notes.txt").write_text("not an image")
    return str(root)


def _folder_pair(**kw):
    return JImageNet(**kw), ImageNetFolder(**kw, device="cpu")


def _same_batch(j, t):
    x, y = j.next_batch()
    tx, ty = t.next_batch()
    assert isinstance(tx, torch.Tensor) and tx.device.type == "cpu"
    _same((x, y), (tx.numpy(), ty.numpy()))


class TestImageNet:
    @pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
    def test_decode_and_augment_bitwise(self, tmp_path, train):
        root = _tree(tmp_path)
        j, t = _folder_pair(root=root, image_size=32, batch_size=2, seed=3,
                            train_transform=train)
        assert t.classes == j.classes and t.paths == j.paths
        assert len(t) == 6
        for _ in range(4):  # past the epoch boundary (3 batches of 2)
            _same_batch(j, t)

    def test_shards_and_resume(self, tmp_path):
        root = _tree(tmp_path)
        j, t = _folder_pair(root=root, image_size=16, batch_size=1, rank=1,
                            size=2, seed=7)
        _same_batch(j, t)
        j.set_cluster(0, 3), t.set_cluster(0, 3)
        _same_batch(j, t)
        j.skip(5), t.skip(5)
        _same_batch(j, t)
        assert j.consumed == t.consumed
        assert j.batches_per_epoch() == t.batches_per_epoch()

    def test_synthetic_bitwise(self, tmp_path, monkeypatch):
        monkeypatch.setenv(cache.DATA_DIR_ENV, str(tmp_path))
        kw = dict(image_size=37, batch_size=4, n_synthetic=64,
                  synthetic_classes=10, seed=2, rank=1, size=2)
        j, t = _folder_pair(**kw)
        for _ in range(3):
            _same_batch(j, t)

    def test_strict_modes(self, tmp_path, monkeypatch):
        monkeypatch.setenv(cache.DATA_DIR_ENV, str(tmp_path))
        with pytest.raises(OSError):
            ImageNetFolder(image_size=32, synthetic_fallback=False,
                           device="cpu")
        (tmp_path / "imagenet" / "train").mkdir(parents=True)
        with pytest.raises(ValueError, match="no images"):
            ImageNetFolder(device="cpu")


# -- prefetch ------------------------------------------------------------------

def _no_prefetch_threads():
    deadline = time.time() + 5
    while time.time() < deadline and any(
            t.name == "kf-prefetch" and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.02)
    return not any(t.name == "kf-prefetch" and t.is_alive()
                   for t in threading.enumerate())


class TestPrefetch:
    def test_order_and_tensors(self):
        batches = [(np.full((2,), i, np.float32), np.int32(i),
                    {"t": torch.full((1,), float(i))}) for i in range(6)]
        out = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
        assert len(out) == 6
        for i, (x, y, d) in enumerate(out):
            assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
            np.testing.assert_array_equal(x.numpy(), np.full((2,), i))
            assert y.dim() == 0 and int(y) == i and y.dtype == torch.int32
            assert float(d["t"]) == i
        # a staged leaf is a copy: the producer may reuse its buffer
        src = np.zeros(3, np.float32)
        (got,) = list(prefetch_to_device(iter([src]), device="cpu"))
        src[:] = 1
        assert float(got.sum()) == 0.0

    def test_overlaps_a_slow_consumer(self):
        produced = []

        def gen():
            for i in range(4):
                produced.append(i)
                yield np.full((1,), i, np.float32)

        it = prefetch_to_device(gen(), size=3, device="cpu")
        first = next(it)
        time.sleep(0.3)
        assert len(produced) >= 3
        assert len(list(it)) == 3 and float(first) == 0.0

    def test_worker_exception_propagates(self):
        def gen():
            yield np.zeros((1,), np.float32)
            raise RuntimeError("loader broke")

        it = prefetch_to_device(gen(), size=2, device="cpu")
        next(it)
        with pytest.raises(RuntimeError, match="loader broke"):
            list(it)

    def test_abandoned_iterator_releases_worker(self):
        def gen():
            for i in range(1000):
                yield np.full((1,), i, np.float32)

        it = prefetch_to_device(gen(), size=2, device="cpu")
        next(it)
        it.close()
        assert _no_prefetch_threads()

    def test_eager_validation(self):
        with pytest.raises(ValueError):
            prefetch_to_device(iter([]), size=0, device="cpu")

    def test_input_span(self, monkeypatch):
        monkeypatch.setenv("KF_CONFIG_ENABLE_TRACE", "1")
        timeline.reset()

        def slow():
            for i in range(3):
                time.sleep(0.05)
                yield np.full((1,), i, np.float32)

        it = prefetch_to_device(slow(), size=1, device="cpu")
        assert len(list(it)) == 3
        spans = [e for e in timeline.snapshot()
                 if e["kind"] == "input" and e["name"] == "prefetch.next"]
        assert len(spans) == 4  # three items and the end of the stream
        assert max(e["dur"] for e in spans) > 0.02
        timeline.reset()

    def test_feeds_a_sharded_dataset(self):
        x = np.arange(64, dtype=np.float32).reshape(32, 2)
        ds = ElasticDataset([x], batch_size=4, rank=1, size=2, seed=0)
        ref = JElastic([x], batch_size=4, rank=1, size=2, seed=0)
        for (got,), (want,) in zip(
                prefetch_to_device(ds.epochs(1), device="cpu"), ref.epochs(1)):
            np.testing.assert_array_equal(got.numpy(), want)


# -- platforms/tpu_pod ---------------------------------------------------------

POD_ENVS = [
    {},
    {"TPU_WORKER_HOSTNAMES": "t1k-0,t1k-1,t1k-2,t1k-3", "TPU_WORKER_ID": "2"},
    {"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "0",
     "MEGASCALE_COORDINATOR_ADDRESS": "a:8476", "MEGASCALE_SLICE_ID": "1",
     "MEGASCALE_NUM_SLICES": "4"},
    {"TPU_WORKER_HOSTNAMES": "solo"},
    {"TPU_WORKER_HOSTNAMES": " x , y ,", "TPU_WORKER_ID": "1"},
]
BAD_POD_ENVS = [
    ({"TPU_WORKER_HOSTNAMES": "a,b"}, "TPU_WORKER_ID"),
    ({"TPU_WORKER_HOSTNAMES": "a,b", "TPU_WORKER_ID": "2"}, "outside"),
    ({"TPU_WORKER_HOSTNAMES": ","}, "empty"),
]


class _Dev:
    """Stand-in device: the layouts touch only these attrs."""

    def __init__(self, slice_index=None, process_index=0):
        if slice_index is not None:
            self.slice_index = slice_index
        self.process_index = process_index


def _ids(devs):
    return [id(d) for d in devs]


class TestTpuPod:
    @pytest.mark.parametrize("env", POD_ENVS, ids=range(len(POD_ENVS)))
    def test_parse(self, env):
        want, got = jpod.parse_tpu_pod_env(env=env), \
            tpu_pod.parse_tpu_pod_env(env=env)
        assert tpu_pod.detected(env) == jpod.detected(env)
        if want is None:
            assert got is None
            return
        for f in ("self_host", "worker_id", "coordinator", "slice_id",
                  "num_slices", "num_hosts"):
            assert getattr(got, f) == getattr(want, f), f
        assert [(h.ip, h.slots) for h in got.hosts.hosts] == \
            [(h.ip, h.slots) for h in want.hosts.hosts]

    @pytest.mark.parametrize("env,match", BAD_POD_ENVS,
                             ids=[m for _, m in BAD_POD_ENVS])
    def test_parse_refusals(self, env, match):
        for mod in (jpod, tpu_pod):
            with pytest.raises(ValueError, match=match):
                mod.parse_tpu_pod_env(env=env)

    def test_groups_by_slice_outer_sorted(self):
        devs = [_Dev(slice_index=s, process_index=p)
                for s, p in ((1, 3), (0, 1), (1, 2), (0, 0))]
        want = [_ids(g) for g in jpod.slice_device_groups(devs)]
        assert [_ids(g) for g in tpu_pod.slice_device_groups(devs)] == want
        assert [_ids(g) for g in tpu_pod.slice_device_groups(
            devs, by="process")] == [_ids(g) for g in jpod.slice_device_groups(
                devs, by="process")]

    @pytest.mark.parametrize("case", ["emulation", "single", "env"])
    def test_layouts_equal_the_reference(self, case, monkeypatch):
        if case == "emulation":
            devs = [_Dev(slice_index=0, process_index=p) for p in (0, 0, 1, 1)]
            kw = dict(num_slices=2)
        elif case == "single":
            devs = [_Dev(slice_index=0) for _ in range(4)]
            kw = dict(num_slices=1)
        else:
            monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
            devs = [_Dev(slice_index=s) for s in (1, 0, 0, 1)]
            kw = {}
        jflat, jper = jpod.slice_mesh_layout(devices=devs, **kw)
        flat, per = tpu_pod.slice_mesh_layout(devices=devs, **kw)
        assert (_ids(flat), per) == (_ids(jflat), jper)

    @pytest.mark.parametrize("devs,num,match", [
        ([_Dev(slice_index=0) for _ in range(4)], 3, "slice group"),
        ([_Dev(slice_index=0)] * 3 + [_Dev(slice_index=1)], 2,
         "uneven slice sizes"),
    ], ids=["disagreement", "uneven"])
    def test_loud_failures(self, devs, num, match):
        for mod in (jpod, tpu_pod):
            with pytest.raises(ValueError, match=match):
                mod.slice_mesh_layout(num_slices=num, devices=devs)

    def test_co_resident_default_world(self, monkeypatch):
        monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
        monkeypatch.setenv("KF_SLICE_RANKS", "3")
        ranks = tpu_pod.co_resident_ranks(device="cpu")
        assert [r.slice_index for r in ranks] == [0, 0, 0, 1, 1, 1]
        groups = tpu_pod.slice_device_groups()
        assert [[r.rank for r in g] for g in groups] == [[0, 1, 2], [3, 4, 5]]
        monkeypatch.delenv("KF_SLICE_RANKS")
        assert [r.slice_index for r in tpu_pod.co_resident_ranks(4)] == \
            [0, 0, 1, 1]
        with pytest.raises(ValueError, match="not whole slices"):
            tpu_pod.co_resident_ranks(3, ranks_per_slice=2)
        with pytest.raises(ValueError, match="does not tile"):
            tpu_pod.co_resident_ranks(3)
        monkeypatch.delenv("MEGASCALE_NUM_SLICES")
        assert len(tpu_pod.slice_device_groups()) == 1

    def test_multislice_communicator(self):
        ranks = tpu_pod.co_resident_ranks(4, ranks_per_slice=2, device="cpu")
        comm = tpu_pod.multislice_communicator(num_slices=2, devices=ranks,
                                               version=3)
        assert (comm.size, comm.num_hosts, comm.local_size) == (4, 2, 2)
        assert comm.version == 3
        x = torch.arange(1.0, 5.0)[:, None]
        assert comm.all_reduce(x)[:, 0].tolist() == [10.0] * 4
        assert comm.cross_all_reduce(x)[:, 0].tolist() == [4.0, 6.0, 4.0, 6.0]
        assert comm.local_all_reduce(x)[:, 0].tolist() == [3.0, 3.0, 7.0, 7.0]
        comm.set_strategy("two_stage")
        assert comm.all_reduce(x)[:, 0].tolist() == [10.0] * 4
        with pytest.raises(ValueError, match="slice group"):
            tpu_pod.multislice_communicator(num_slices=3, devices=ranks)

    def test_mesh_refuses_multislice_naming_the_multi_card_slice(
            self, monkeypatch):
        from kungfu_tpu_torch.parallel.mesh import MeshPlan

        monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
        with pytest.raises(NotImplementedError,
                           match="slice_mesh_layout.*multi-card slice"):
            MeshPlan(dp=2).build_mesh(["cpu"] * 2)
        monkeypatch.delenv("MEGASCALE_NUM_SLICES")
        assert MeshPlan(dp=2).build_mesh(["cpu"] * 2) is not None
