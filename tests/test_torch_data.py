"""The port's data path against the JAX package's, on the CPU: the same
fixtures give the same bytes.

- ``BatchLoader`` batches (train shuffled over two epochs, val with
  deterministic frame picks, test with padding) on npy and mp4 fixtures, also
  length-bucketed with frame buckets ``True`` and ``"auto"``;
- ``optimal_frame_buckets``, ``bucket_frame_cost``, ``resolve_frame_buckets``
  and ``get_class_weights``;
- ``generate_synthetic_dataset`` (npy) and ``pack_dataset`` write the same
  bytes from the same seed;
- ``VNRBatchLoader`` yields JAX's batches, and reads the bf16 and fp8 feature
  payloads that JAX's ``RecordWriter`` wrote bit for bit;
- ``host_prefetch`` and ``device_prefetch`` keep order and raise a
  producer's error; a failed build of the native library raises.

Fixtures are written by the tests, small (at most 40 frames a video).
"""

import filecmp
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from videonavqa_tpu.data import buckets as jbuckets
from videonavqa_tpu.data import pipeline as jpipe
from videonavqa_tpu.data import synthetic as jsynth
from videonavqa_tpu.data import vnr as jvnr
from videonavqa_tpu_torch.cli.common import prepare_batch
from videonavqa_tpu_torch.data import buckets, pipeline, synthetic, vnr
from videonavqa_tpu_torch.data.prefetch import device_prefetch, host_prefetch


@pytest.fixture(scope="module", params=["npy", "mp4"])
def dataset(request, tmp_path_factory):
    out = str(tmp_path_factory.mktemp(f"data_{request.param}"))
    jsynth.generate_synthetic_dataset(out, num_houses=3, trajs_per_house=5, seed=3,
                                      video_format=request.param, max_frames=40)
    return out


def _datasets(base, part, **kw):
    paths_j, paths_t = jpipe.DataPaths(base), pipeline.DataPaths(base)
    split, labels = jpipe.load_json(paths_j.split_file), jpipe.load_json(paths_j.labels_file)
    return (jpipe.VNQADataset(paths_j, split[part], labels, **kw),
            pipeline.VNQADataset(paths_t, split[part], labels, **kw))


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("part, mode, shuffle, det, loader_kw", [
    ("train", "train", True, False, {}),
    ("val", "val", False, True, {}),
    ("test", "test", False, True, {}),
    ("train", "train", True, False, dict(bucket_by_length=True, frame_buckets=True)),
    ("train", "train", True, False, dict(bucket_by_length=True, frame_buckets="auto")),
    ("test", "test", False, True, dict(bucket_by_length=True, frame_buckets="auto")),
])
def test_batch_loader_matches_jax(dataset, part, mode, shuffle, det, loader_kw):
    jds, tds = _datasets(dataset, part, deterministic=det, q_metadata=(mode == "test"))
    kw = dict(shuffle=shuffle, mode=mode, num_workers=2, seed=5, **loader_kw)
    jl, tl = jpipe.BatchLoader(jds, 2, **kw), pipeline.BatchLoader(tds, 2, **kw)
    assert len(tl) == len(jl) and tl.frame_buckets == jl.frame_buckets
    for epoch in (0, 1) if mode == "train" else (0,):
        _assert_batches_equal(tl.epoch(epoch), jl.epoch(epoch))
    if mode == "test":
        last = list(tl.epoch(0))[-1]
        n = int(last["num_valid"])
        assert n < 2 and (last["q_id"][n:] == pipeline.PAD_QID).all()
        assert (last["v_len"][n:] >= 1).all() and (last["q_len"][n:] >= 1).all()


def test_question_only_and_video_only_examples_match_jax(dataset):
    for kw in (dict(q_only=True), dict(v_only=True)):
        jds, tds = _datasets(dataset, "train", **kw)
        for i in range(len(jds)):
            w, g = jds.load_example(i, epoch=2), tds.load_example(i, epoch=2)
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("seed, k", [(0, 1), (1, 3), (2, 8), (3, 12)])
def test_frame_buckets_match_jax(seed, k):
    lengths = np.random.default_rng(seed).integers(1, 36, 200)
    got = buckets.optimal_frame_buckets(lengths, k)
    assert got == jbuckets.optimal_frame_buckets(lengths, k)
    assert buckets.bucket_frame_cost(lengths, got) == jbuckets.bucket_frame_cost(lengths, got)
    for spec in (True, "auto", (4, 35), None):
        assert buckets.resolve_frame_buckets(spec, lambda: lengths, (8, 35), k) == \
            jbuckets.resolve_frame_buckets(spec, lambda: lengths, (8, 35), k)


def test_class_weights_match_jax(dataset):
    jds, tds = _datasets(dataset, "train")
    for n in (70, 7):
        got, want = tds.get_class_weights(n), jds.get_class_weights(n)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_synthetic_dataset_writes_jax_bytes(tmp_path):
    kw = dict(num_houses=3, trajs_per_house=2, seed=11, video_format="npy", max_frames=24)
    ids_t = synthetic.generate_synthetic_dataset(str(tmp_path / "t"), **kw)
    ids_j = jsynth.generate_synthetic_dataset(str(tmp_path / "j"), **kw)
    assert ids_t == ids_j
    files = _tree_files(tmp_path / "j")
    assert files == _tree_files(tmp_path / "t") and len(files) == 3 + 2 * 6
    for f in files:
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f, shallow=False), f


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("vnr"))
    jsynth.generate_synthetic_dataset(base, num_houses=3, trajs_per_house=5, seed=4,
                                      video_format="npy", max_frames=40)
    jvnr.ensure_built()
    return base


@pytest.mark.parametrize("codec", ["zstd", "zlib", "raw"])
def test_pack_dataset_writes_jax_bytes(packed, codec, tmp_path):
    ids_j = jvnr.pack_dataset(packed, str(tmp_path / "j.vnr"), compress=codec)
    ids_t = vnr.pack_dataset(packed, str(tmp_path / "t.vnr"), compress=codec)
    assert ids_t == ids_j
    assert filecmp.cmp(tmp_path / "j.vnr", tmp_path / "t.vnr", shallow=False)
    assert vnr.read_fingerprint(str(tmp_path / "t.vnr")) == bytes(16)


@pytest.mark.parametrize("mode, shuffle, det, kw", [
    ("train", True, False, {}),
    ("val", False, True, {}),
    ("test", False, True, {}),
    ("train", True, False, dict(bucket_by_length=True, frame_buckets=True)),
    ("train", True, False, dict(bucket_by_length=True, frame_buckets="auto")),
])
def test_vnr_loader_matches_jax(packed, mode, shuffle, det, kw, tmp_path):
    path = str(tmp_path / "all.vnr")
    jvnr.pack_dataset(packed, path)
    args = dict(shuffle=shuffle, mode=mode, seed=9, deterministic=det, **kw)
    jl, tl = jvnr.VNRBatchLoader(path, 4, **args), vnr.VNRBatchLoader(path, 4, **args)
    assert len(tl) == len(jl) and tl.frame_buckets == jl.frame_buckets
    np.testing.assert_array_equal(tl.lengths, jl.lengths)
    for epoch in (0, 1) if mode == "train" else (0,):
        _assert_batches_equal(tl.epoch(epoch), jl.epoch(epoch))
    np.testing.assert_array_equal(tl.example_frames(2), jl.example_frames(2))
    for g, w in zip(tl.example_meta(3), jl.example_meta(3)):
        np.testing.assert_array_equal(g, w)
    tl.close()
    jl.close()


@pytest.mark.parametrize("payload, ml_dtype, torch_dtype", [
    ("bfloat16", ml_dtypes.bfloat16, torch.bfloat16),
    ("float8_e4m3", ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
])
def test_vnr_feature_payloads_read_bit_for_bit(payload, ml_dtype, torch_dtype, tmp_path):
    r = np.random.default_rng(6)
    path = str(tmp_path / "f.fnr")
    shape = (10, 13, 8)
    with jvnr.RecordWriter(path, shape, payload=payload, fingerprint=b"stem") as w:
        for i in range(5):
            frames = (r.standard_normal((int(r.integers(3, 30)), *shape)) * 3).astype(ml_dtype)
            w.add(frames, r.integers(1, 134, int(r.integers(3, 12))), i, i + 1)
    args = dict(shuffle=True, seed=2, bucket_by_length=True, frame_buckets=True)
    jl, tl = jvnr.VNRBatchLoader(path, 2, **args), vnr.VNRBatchLoader(path, 2, **args)
    assert tl.payload_key == "v_features" and tl.torch_dtype == torch_dtype
    assert vnr.read_fingerprint(path) == b"stem".ljust(16, b"\0")
    for g, want in zip(tl.epoch(1), jl.epoch(1)):
        bits = want["v_features"].view(g["v_features"].dtype)
        np.testing.assert_array_equal(g["v_features"], bits)
        as_torch = torch.from_numpy(g["v_features"]).view(torch_dtype).float().numpy()
        np.testing.assert_array_equal(as_torch, want["v_features"].astype(np.float32))


def test_vnr_refuses_row_slices(packed, tmp_path):
    """A row slice outside the batch is refused; one inside decodes exactly
    its rows of the global batches (the JAX loader's row_slice), in test mode
    with the padded last batch's valid count cut to the slice."""
    path = str(tmp_path / "all.vnr")
    vnr.pack_dataset(packed, path, compress="zlib")
    for bad in ((0, 3), (2, 1), (-1, 1), (0, 0)):
        with pytest.raises(ValueError, match="row_slice"):
            vnr.VNRBatchLoader(path, 2, row_slice=bad)
    args = dict(shuffle=True, seed=3, mode="test", bucket_by_length=True, frame_buckets=True)
    whole = list(vnr.VNRBatchLoader(path, 3, **args).epoch(1))
    want = list(jvnr.VNRBatchLoader(path, 3, row_slice=(1, 2), **args).epoch(1))
    got = list(vnr.VNRBatchLoader(path, 3, row_slice=(1, 2), **args).epoch(1))
    assert len(got) == len(whole) == len(want)
    for g, w, a in zip(got, want, whole):
        assert int(g["num_valid"]) == int(w["num_valid"]) == \
            int(np.clip(int(a["num_valid"]) - 1, 0, 2))
        for k in ("video", "v_len", "question", "q_len", "label", "q_id"):
            np.testing.assert_array_equal(g[k], w[k])
            n = int(g["num_valid"])
            np.testing.assert_array_equal(g[k][:n], a[k][1:1 + n])


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "vnr.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(vnr, "SOURCE", src)
    monkeypatch.setattr(vnr, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        vnr.ensure_built()
    assert not vnr.library_path().exists()


def _failing(n):
    for i in range(n):
        yield i
    raise ValueError("producer failed")


def test_host_prefetch_keeps_order_and_raises_the_producers_error():
    assert list(host_prefetch(iter(range(50)), depth=3)) == list(range(50))
    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for item in host_prefetch(_failing(7), depth=2):
            got.append(item)
    assert got == list(range(7))


def test_device_prefetch_keeps_order_and_raises_the_producers_error():
    def prepare(i):
        return {"x": torch.full((2,), float(i)), "n": torch.tensor(i)}, i * 10

    out = list(device_prefetch(iter(range(9)), prepare, "cpu", depth=2))
    assert [extra for _, extra in out] == [i * 10 for i in range(9)]
    assert [float(b["x"][0]) for b, _ in out] == [float(i) for i in range(9)]
    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for b, _ in device_prefetch(host_prefetch(_failing(4)), prepare, "cpu"):
            got.append(int(b["n"]))
    # the error surfaces once the copy-ahead reaches it: a prefix came first
    assert got == [0, 1]


def test_prepare_batch_drops_q_id_and_masks_padding(dataset):
    _, tds = _datasets(dataset, "test", deterministic=True, q_metadata=True)
    last = list(pipeline.BatchLoader(tds, 2, shuffle=False, mode="test").epoch(0))[-1]
    video = last["video"]
    batch, num_valid = prepare_batch(dict(last))
    assert num_valid == int(last["num_valid"]) == 1
    assert "q_id" not in batch and "num_valid" not in batch
    assert batch["valid"].tolist() == [True, False]
    assert batch["video"].dtype == torch.uint8
    np.testing.assert_array_equal(batch["video"].numpy(), video)
    full = list(pipeline.BatchLoader(tds, 2, shuffle=False, mode="test").epoch(0))[0]
    assert "valid" not in prepare_batch(full)[0]
