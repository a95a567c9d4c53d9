"""The port's data path held against the JAX package (CPU, host code).

The local-folder dataset gives JAX's batches bit for bit (npz and gif
clips, a long clip's window, the pad path of a short one, an embedding
trimmed, one padded and one missing); each augmentor, decoder, loader and
distributor gives its JAX counterpart's output on the same seeded inputs;
the native resize is within 1 LSB of JAX's NumPy fallback, the native crop
equals it exactly and the native normalize within 2^-23 (and JAX's native
normalize exactly); the native tar reader equals
``tarfile``; a remote shard path raises. (No timing is asserted.)
"""

import io
import pickle
import tarfile

import numpy as np
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)
import pytest
from PIL import Image

from cosmos_predict2_tpu.data import augmentors as jaug
from cosmos_predict2_tpu.data import decoders as jdec
from cosmos_predict2_tpu.data import distributors as jdist
from cosmos_predict2_tpu.data import loaders as jload
from cosmos_predict2_tpu.data.local_dataset import LocalVideoDataset as JLocalVideoDataset
from cosmos_predict2_tpu.data.local_dataset import LocalVideoDatasetConfig as JLocalVideoDatasetConfig
from cosmos_predict2_tpu.utils import native as jnative
from cosmos_predict2_tpu_torch.data import augmentors as taug
from cosmos_predict2_tpu_torch.data import decoders as tdec
from cosmos_predict2_tpu_torch.data import distributors as tdist
from cosmos_predict2_tpu_torch.data import loaders as tload
from cosmos_predict2_tpu_torch.data import native_tar
from cosmos_predict2_tpu_torch.data.local_dataset import LocalVideoDataset, LocalVideoDatasetConfig
from cosmos_predict2_tpu_torch.utils import native


def assert_same(a, b, path="sample"):
    """Equal structure and values, arrays bit-equal with the same dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a.keys(), b)
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (path, type(b))
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def _video(t=8, h=32, w=48):
    return np.arange(t * h * w * 3, dtype=np.int64).reshape(t, h, w, 3).astype(np.uint8)


# ------------------------------- local dataset -------------------------------


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Four clips: a long npz (resized, cropped, a drawn window), a short npz
    (padded) at another fps, a gif and an npz with no embedding; embeddings
    longer and shorter than text_len, in fp16 and 3-D."""
    root = tmp_path_factory.mktemp("clips")
    for d in ("videos", "metas", "t5_xxl"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    clip = lambda t, h, w: rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    np.savez(root / "videos" / "a_long.npz", video=clip(14, 40, 56), fps=24.0)
    np.savez(root / "videos" / "b_short.npz", video=clip(3, 32, 32), fps=10.0)
    frames = [Image.fromarray(f) for f in clip(6, 36, 30)]
    frames[0].save(root / "videos" / "c_anim.gif", save_all=True, append_images=frames[1:], duration=125, loop=0)
    np.savez(root / "videos" / "d_noemb.npz", video=clip(9, 32, 40))
    (root / "metas" / "a_long.txt").write_text("  a robot arm  \n")
    (root / "metas" / "c_anim.txt").write_text("a gif")
    np.save(root / "t5_xxl" / "a_long.npy", rng.standard_normal((11, 16)).astype(np.float16))
    np.save(root / "t5_xxl" / "b_short.npy", rng.standard_normal((1, 5, 16)).astype(np.float32))
    np.save(root / "t5_xxl" / "c_anim.npy", rng.standard_normal((8, 16)).astype(np.float32))
    return str(root)


def test_local_dataset_batches_equal_jax(folder):
    cfg = dict(root=folder, num_frames=5, height=24, width=32, text_len=8, text_dim=16, seed=3)
    port, ref = LocalVideoDataset(LocalVideoDatasetConfig(**cfg)), JLocalVideoDataset(JLocalVideoDatasetConfig(**cfg))
    assert len(port) == len(ref) == 4
    for idx in range(6):  # past the end: the clips again, with other windows
        assert_same(port[idx], ref[idx], f"batch {idx}")
    b = port[1]
    assert b["video"].shape == (1, 3, 5, 24, 32) and b["fps"][0] == 10.0
    np.testing.assert_array_equal(b["video"][:, :, 3], b["video"][:, :, 2])  # padded with the last frame
    assert not port[3]["t5_text_embeddings"].any() and port[0]["caption"] == "a robot arm"
    assert [b for b, _ in zip(port, range(2))][1]["fps"] == ref[1]["fps"]


def test_local_dataset_without_clips_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no clips"):
        LocalVideoDataset(LocalVideoDatasetConfig(root=str(tmp_path)))


# ------------------------------- native ops -------------------------------


@pytest.fixture
def numpy_fallback(monkeypatch):
    """The JAX package's media ops on their NumPy fallback."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)


@pytest.mark.parametrize("size", [(16, 24), (7, 50), (40, 48)])
def test_native_resize_within_one_lsb_of_jax_fallback(size, numpy_fallback):
    frames = np.random.default_rng(1).integers(0, 256, (3, 23, 37, 3), dtype=np.uint8)
    before = dict(native.route_counts)
    got = native.resize_bilinear(frames, *size)
    assert native.get_lib() is not None and native.route_counts["native"] == before["native"] + 1
    want = jnative.resize_bilinear(frames, *size)
    assert got.shape == want.shape == (3, *size, 3)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_native_crop_and_normalize_equal_jax(monkeypatch):
    """The crop equals JAX's NumPy fallback exactly. The normalize equals
    JAX's native one bit for bit (the same source) and is within one ulp of
    its fallback's unit in the last place at 1 (2^-23): the C++ multiplies by
    1/127.5 where NumPy divides."""
    frames = np.random.default_rng(2).integers(0, 256, (2, 21, 30, 3), dtype=np.uint8)
    assert jnative.get_lib() is not None
    np.testing.assert_array_equal(native.to_pm1_float(frames), jnative.to_pm1_float(frames))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    np.testing.assert_array_equal(native.center_crop(frames, 10, 13), jnative.center_crop(frames, 10, 13))
    np.testing.assert_allclose(native.to_pm1_float(frames), jnative.to_pm1_float(frames), rtol=0, atol=2.0**-23)


def test_native_fallback_counts_its_route(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    before = dict(native.route_counts)
    frames = np.zeros((1, 4, 4, 3), np.uint8)
    native.resize_bilinear(frames, 2, 2)
    assert native.route_counts == {"native": before["native"], "numpy": before["numpy"] + 1}


def test_native_tar_reader_equals_tarfile(tmp_path):
    payloads = {f"sample_{i:03d}.bin": bytes([i]) * (100 + i * 37) for i in range(12)}
    payloads["deep/" + "x" * 120 + ".bin"] = b"L" * 999  # a GNU long name
    path = str(tmp_path / "shard.tar")
    with tarfile.open(path, "w", format=tarfile.GNU_FORMAT) as tf:
        for name, data in payloads.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    with tarfile.open(path) as tf:
        want = [(m.name, tf.extractfile(m).read()) for m in tf.getmembers() if m.isreg()]
    shard = native_tar.NativeTarShard(path)
    assert shard.native and len(shard) == len(want)
    assert [(n, shard.read(i)) for i, n in enumerate(shard.names)] == want
    order = list(range(len(want)))[::-1]
    shard.prefetch(order)
    assert [shard.get_prefetched(slot) for slot in range(len(order))] == [want[i][1] for i in order]
    shard.end_prefetch()
    shard.close()


# ------------------------------- augmentors -------------------------------

AUGMENTORS = [
    ("ResizeSmallestSide", dict(input_keys=["video"], args={"size": 16})),
    ("ResizeLargestSide", dict(input_keys=["video"], output_keys=["out"], args={"size": 24})),
    ("CenterCrop", dict(input_keys=["video"], args={"height": 16, "width": 20})),
    ("CenterCrop", dict(input_keys=["video"], args={"height": 40, "width": 40})),  # resizes up first
    ("RandomCrop", dict(input_keys=["video"], args={"height": 16, "width": 20, "seed": 5})),
    ("RandomCrop", dict(input_keys=["video"], args={"height": 99, "width": 20})),  # rejects
    ("HorizontalFlip", dict(input_keys=["video"], args={"prob": 0.5})),
    ("Normalize", dict(input_keys=["video"], args={"mean": 100.0, "std": 50.0})),
    ("ReflectionPadding", dict(input_keys=["video"], args={"height": 40, "width": 52})),
    ("UniformTemporalSubsample", dict(input_keys=["video"], args={"num_frames": 5})),
    ("AppendFPSFramesForImage", dict(input_keys=["image"], args={"num_video_frames": 3, "fps": 24})),
    ("MergeDataDict", dict(input_keys=["metas"])),
    ("CaptionFilter", dict(input_keys=["caption"], args={"min_words": 3})),
    ("TextTransform", dict(input_keys=["captions"])),
]


def _sample(key: str) -> dict:
    return {"video": _video(), "image": _video()[0], "__key__": key, "metas": {"fps": 10, "video": 1},
            "caption": "three short words" if key != "b" else "two words",
            "captions": [{"caption": "w0"}, {"caption": "w1", "embedding": [[0.5, 1.0]]}], "chunk_index": 1}


@pytest.mark.parametrize("name,kwargs", AUGMENTORS, ids=[f"{n}-{i}" for i, (n, _) in enumerate(AUGMENTORS)])
def test_augmentor_equals_jax(name, kwargs):
    for key in ("a", "b", "flip-me", "c"):
        assert_same(getattr(taug, name)(**kwargs)(_sample(key)), getattr(jaug, name)(**kwargs)(_sample(key)), key)


def test_video_parsing_and_chain_equal_jax():
    classes = lambda mod: {n for n, c in vars(mod).items() if isinstance(c, type) and issubclass(c, mod.Augmentor)}
    assert classes(taug) == classes(jaug) == {n for n, _ in AUGMENTORS} | {"VideoParsing", "Augmentor"}
    meta = {"framerate": 10, "t2w_windows": [{"start_frame": 0, "end_frame": 10}, {"start_frame": 10, "end_frame": 20},
                                             {"start_frame": 20, "end_frame": 24}]}
    args = {"num_video_frames": 5, "min_fps": 1, "max_fps": 60, "min_duration": 0.5}
    for key, m in (("v1", meta), ("v2", meta), ("fast", {**meta, "framerate": 500}), ("none", {"framerate": 10})):
        mk = lambda: {"metas": m, "mp4": _video(t=24), "__key__": key}
        assert_same(taug.VideoParsing(["metas", "mp4"], args=args)(mk()),
                    jaug.VideoParsing(["metas", "mp4"], args=args)(mk()), key)
    chain = lambda mod: [mod.CenterCrop(["video"], args={"height": 16, "width": 16}),
                         mod.CaptionFilter(["caption"], args={"min_words": 2}), mod.Normalize(["video"])]
    for cap in ("a good caption", "x"):
        mk = lambda: {"video": _video(), "caption": cap, "__key__": "k"}
        assert_same(taug.apply_augmentors(mk(), chain(taug)), jaug.apply_augmentors(mk(), chain(jaug)), cap)


# ------------------------------- decoders -------------------------------


def test_item_decoders_equal_jax():
    img = np.random.default_rng(0).integers(0, 255, (16, 20, 3), dtype=np.uint8)
    png = io.BytesIO()
    Image.fromarray(img).save(png, format="PNG")
    depth = np.full((4, 6), 2.5, np.float32)
    depth[0, 0] = np.nan
    npz = io.BytesIO()
    np.savez(npz, depth=depth)
    cases = [("pil_image_decoder", "x.png", png.getvalue()), ("pil_image_decoder", "x.txt", b"text"),
             ("pickle_decoder", "x.pkl", pickle.dumps({"a": [1, 2]})), ("pickle_decoder", "x.json", b"{}"),
             ("depth_decoder", "x.npz", npz.getvalue()), ("depth_decoder", "x.png", b"")]
    for name, key, data in cases:
        assert_same(getattr(tdec, name)(key, data), getattr(jdec, name)(key, data), f"{name} {key}")
    with pytest.raises(RuntimeError, match="OpenEXR"):
        tdec.depth_decoder("x.exr", b"")
    assert set(tdec.VIDEO_DECODER_OPTIONS) == set(jdec.VIDEO_DECODER_OPTIONS)
    dec, jd = tdec.get_video_decoder("video_naive_bytes"), jdec.get_video_decoder("video_naive_bytes")
    assert dec("a.mov", b"\x01") == jd("a.mov", b"\x01") and dec("a.npy", b"\x01") is jd("a.npy", b"\x01") is None


@pytest.mark.parametrize("n,target,chunk", [(100, 10, 30), (100, 10, 100), (95, 10, 30), (45, 40, 30)])
def test_chunk_and_stride_samplers_equal_jax(n, target, chunk):
    def draws(mod):
        rng, out = np.random.default_rng(7), []
        for _ in range(30):
            try:
                out.append(mod.sample_chunk_index(n, target, chunk, rng))
                out.append(mod.lowered_fps_indices(n, 30.0, 4.0, 30.0, target, rng))
            except ValueError as e:
                out.append(str(e))
        return out

    assert draws(tdec) == draws(jdec)


@pytest.mark.parametrize("name,kwargs", [("chunked_video_decoder", dict(chunk_size=16, sequence_length=8)),
                                         ("chunked_video_decoder_w_lower_fps", dict(sequence_length=8)),
                                         ("chunked_video_decoder", dict(chunk_size=0, sequence_length=0))])
def test_chunked_video_decoders_equal_jax(name, kwargs):
    frames = np.arange(64, dtype=np.uint8)[:, None, None, None] * np.ones((1, 4, 4, 3), np.uint8)
    reader = lambda ext, data: (frames, 29.97)
    port = tdec.get_video_decoder(name, seed=3, read_fn=reader, **kwargs)
    ref = jdec.get_video_decoder(name, seed=3, read_fn=reader, **kwargs)
    for key in ("a.mp4", "b.webm", "c.gif", "d.txt"):
        assert_same(port(key, b""), ref(key, b""), key)


# ------------------------------- loaders -------------------------------


def _write_shard(path, start: int, n: int):
    with tarfile.open(path, "w") as tf:
        for i in range(start, start + n):
            npy = io.BytesIO()
            np.save(npy, _video(t=4, h=24, w=24) + np.uint8(i))
            for name, data in ((f"{i:03d}.npy", npy.getvalue()), (f"{i:03d}.txt", f"caption number {i}".encode()),
                               (f"{i:03d}.json", b'{"fps": 16}')):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def test_sharded_tar_dataset_equals_jax(tmp_path):
    shards = []
    for s in range(3):
        shards.append(str(tmp_path / f"shard_{s}.tar"))
        _write_shard(shards[-1], 3 * s, 3)
    chain = lambda mod: [mod.CenterCrop(["npy"], output_keys=["video"], args={"height": 16, "width": 16}),
                         mod.CaptionFilter(["txt"], args={"min_words": 3}), mod.Normalize(["video"])]
    for kwargs in (dict(shuffle_seed=1), dict(shuffle_seed=None, process_index=1, process_count=2)):
        port = tload.ShardedTarDataset(shards, augmentors=chain(taug), **kwargs)
        ref = jload.ShardedTarDataset(shards, augmentors=chain(jaug), **kwargs)
        for a, b, _ in zip(port, ref, range(12)):  # past an epoch: reshuffled
            assert_same(a, b)
    assert "jpg" in port.decoders and "pkl" in port.decoders


def test_remote_shard_raises():
    with pytest.raises(NotImplementedError, match="easy_io"):
        tload.ShardedTarDataset(["local.tar", "s3://bucket/shard_000.tar"])


def test_joint_cached_and_watchdog_loaders_equal_jax():
    def joint(mod):
        a, b = iter(lambda: {"x": 1}, None), iter(lambda: {"x": 2}, None)
        return [batch for batch, _ in zip(mod.IterativeJointDataLoader({"image": (a, 1), "video": (b, 2)}), range(6))]

    assert joint(tload) == joint(jload)
    port, ref = tload.CachedReplayDataLoader(iter(range(10)), 3), jload.CachedReplayDataLoader(iter(range(10)), 3)
    assert [x for x, _ in zip(port, range(7))] == [x for x, _ in zip(ref, range(7))] == [0, 0, 0, 1, 1, 1, 2]
    port.close()
    ref.close()
    failing = tload.CachedReplayDataLoader(map(lambda i: 1 // (2 - i), range(5)), 1)
    with pytest.raises(ZeroDivisionError):
        list(failing)
    wd = tload.OperationWatchdog(warn_after_s=100, poll_s=0.05)
    wd.beat("step")
    assert wd._operation == "step"
    wd.close()
    wd._thread.join(timeout=5)
    assert not wd._thread.is_alive()


# ------------------------------- distributors -------------------------------

ASPECTS = ["1:1", "4:3", "3:4", "16:9", "9:16"]


def _shards(mod, counts):
    return [mod.TarShardInfo(path=f"tar_{i:05d}", root="root/", dset_id="mock", opts=(("aspect_ratio", a),))
            for a, n in zip(ASPECTS, counts) for i in range(n)]


@pytest.mark.parametrize("counts,world,workers", [([100] * 5, 1, 16), ([10, 3, 1, 20, 7], 2, 4), ([1, 1], 3, 2)])
def test_multi_aspect_distributor_equals_jax(counts, world, workers):
    shape = {k: n for k, n in zip(ASPECTS, counts)}
    assert tdist.allocate_workers_to_aspects(shape, world * workers) == \
        jdist.allocate_workers_to_aspects(shape, world * workers)
    for rank in range(world):
        for worker in range(workers):
            kw = dict(rank=rank, world_size=world, worker_id=worker, num_workers=workers, shuffle=True, seed=4)
            port = tdist.MultiAspectRatioDistributor(_shards(tdist, counts), **kw)
            ref = jdist.MultiAspectRatioDistributor(_shards(jdist, counts), **kw)
            assert port.aspect_ratio == ref.aspect_ratio
            assert [s.url for s, _ in zip(port, range(25))] == [s.url for s, _ in zip(ref, range(25))]


@pytest.mark.parametrize("n_shards", [7, 2])
def test_basic_distributor_equals_jax(n_shards):
    shards = [f"s3_{i:03d}.tar" for i in range(n_shards)]
    for rank in range(2):
        for worker in range(2):
            kw = dict(rank=rank, world_size=2, worker_id=worker, num_workers=2, seed=9)
            port, ref = tdist.BasicShardDistributor(shards, **kw), jdist.BasicShardDistributor(shards, **kw)
            assert [s for s, _ in zip(port, range(12))] == [s for s, _ in zip(ref, range(12))]
            once = dict(kw, infinite=False, shuffle=False)
            port, ref = tdist.BasicShardDistributor(shards, **once), jdist.BasicShardDistributor(shards, **once)
            assert list(port) == list(ref)
    with pytest.raises(ValueError, match="aspect_ratio"):
        tdist.split_by_aspect_ratio([tdist.TarShardInfo(path="x")])
