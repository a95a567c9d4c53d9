"""The port's object-store IO (utils/remote_io.py, utils/easy_io.py) against
the JAX package's, on an in-process fake store (tests/torch_fake_store.py,
a copy of tests/test_remote_io.py's): S3 and GCS round trips, the SigV4
Authorization header of both packages for the same request, keys and clock,
MSC over an injected client, easy_io's remote load and dump, the S3 backend
built from ``CredentialEnvParser.backend_args`` (which the JAX package's
S3Backend refuses), and every file format dumped by one package and loaded
by the other. No request leaves 127.0.0.1: every GCS backend gets a token,
every S3 backend an endpoint."""

import datetime
import io
import sys
import tarfile
import types

import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  (torch's CPU threads under xdist)

from cosmos_predict2_tpu.utils import easy_io as j_easy_io
from cosmos_predict2_tpu.utils import env_parsers as jenv
from cosmos_predict2_tpu.utils import remote_io as jrio
from cosmos_predict2_tpu_torch.utils import easy_io
from cosmos_predict2_tpu_torch.utils import env_parsers as tenv
from cosmos_predict2_tpu_torch.utils import remote_io as rio
from cosmos_predict2_tpu_torch.utils import vqa_check
from torch_fake_store import FakeMSCClient, FakeStore, serve


@pytest.fixture(scope="module")
def store():
    with serve() as url:
        yield url


@pytest.fixture
def s3(store):
    """The port's easy_io with an S3 backend on the fake store, removed after."""
    easy_io.register_backend("s3", rio.S3Backend(access_key="k", secret_key="s", endpoint_url=store))
    yield store
    easy_io._BACKENDS.pop("s3", None)


def test_s3_backend_roundtrip(store):
    be = rio.S3Backend(access_key="test", secret_key="secret", endpoint_url=store)
    be.put(b"hello card", "s3://bkt/dir/a.bin")
    assert be.get("s3://bkt/dir/a.bin") == b"hello card"
    assert be.exists("s3://bkt/dir/a.bin")
    assert not be.exists("s3://bkt/dir/missing.bin")
    be.put(b"x", "s3://bkt/dir/b.bin")
    assert sorted(be.list("s3://bkt/dir/")) == ["s3://bkt/dir/a.bin", "s3://bkt/dir/b.bin"]
    # the JAX package's client reads what the port's wrote, and the reverse
    jbe = jrio.S3Backend(access_key="test", secret_key="secret", endpoint_url=store)
    assert jbe.get("s3://bkt/dir/a.bin") == b"hello card"
    jbe.put(b"from jax", "s3://bkt/dir/c.bin")
    assert be.get("s3://bkt/dir/c.bin") == b"from jax"
    with pytest.raises(rio.RemoteIOError, match="HTTP 404"):
        be.get("s3://bkt/dir/missing.bin")


def test_gcs_backend_roundtrip(store):
    be = rio.GCSBackend(token="fake", endpoint_url=store)
    be.put(b"gcs bytes", "gs://bkt2/x/y.bin")
    assert be.get("gs://bkt2/x/y.bin") == b"gcs bytes"
    assert be.exists("gs://bkt2/x/y.bin")
    assert not be.exists("gs://bkt2/x/nope.bin")
    assert list(be.list("gs://bkt2/x/")) == ["gs://bkt2/x/y.bin"]
    assert jrio.GCSBackend(token="fake", endpoint_url=store).get("gs://bkt2/x/y.bin") == b"gcs bytes"
    assert FakeStore.requests[-1][2]["Authorization"] == "Bearer fake"


@pytest.mark.parametrize("method,url,payload", [
    ("GET", "http://127.0.0.1:9/bkt/dir/a%20b.bin", b""),
    ("PUT", "http://127.0.0.1:9/bkt/dir/w.npy", b"\x00\x01payload"),
    ("HEAD", "https://bkt.s3.eu-west-1.amazonaws.com/k", b""),
    ("GET", "http://127.0.0.1:9/bkt?list-type=2&prefix=dir%2F&continuation-token=a%2Bb", b""),
])
def test_sigv4_header_equals_jax(monkeypatch, method, url, payload):
    """Both packages sign the same request with the same keys at a frozen
    clock into the same headers (and so the same Authorization)."""
    frozen = datetime.datetime(2026, 3, 4, 5, 6, 7, tzinfo=datetime.timezone.utc)

    class Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return frozen

    fake = types.SimpleNamespace(datetime=Clock, timezone=datetime.timezone)
    monkeypatch.setattr(rio, "datetime", fake)
    monkeypatch.setattr(jrio, "datetime", fake)
    args = dict(access_key="AKIDEXAMPLE", secret_key="wJalrXUtnFEMI/K7MDENG", region="eu-west-1")
    got = rio.S3Backend(**args)._sign(method, url, payload, {"x-extra": "1"})
    want = jrio.S3Backend(**args)._sign(method, url, payload, {"x-extra": "1"})
    assert got == want
    assert got["Authorization"].startswith("AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20260304/eu-west-1/s3/aws4_request")
    assert got["x-amz-date"] == "20260304T050607Z"
    # unsigned without keys, as JAX's
    monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
    monkeypatch.delenv("AWS_SECRET_ACCESS_KEY", raising=False)
    assert rio.S3Backend()._sign(method, url, payload, {}) == jrio.S3Backend()._sign(method, url, payload, {}) == {}


def test_msc_backend_fake_client():
    """The MSC adapter over an injected client: the longest path_mapping
    prefix wins, and the calls reach the client as they do from JAX's."""
    mapping = {"s3://bucket/": "data/", "s3://bucket/deep/": "deep/"}
    port, ref = FakeMSCClient(), FakeMSCClient()
    for be in (rio.MSCBackend(client=port, path_mapping=mapping), jrio.MSCBackend(client=ref, path_mapping=mapping)):
        be.put(b"hello", "msc://s3://bucket/a.txt")
        be.put(b"x", "msc://s3://bucket/deep/b.bin")
        assert be.get("msc://s3://bucket/a.txt") == b"hello"
        assert be.exists("msc://s3://bucket/a.txt") and not be.exists("msc://s3://bucket/missing")
        assert list(be.list("msc://s3://bucket/")) == ["data/a.txt"]
        be.remove("msc://s3://bucket/a.txt")
        assert not be.exists("msc://s3://bucket/a.txt")
    assert port.blobs == ref.blobs == {"deep/b.bin": b"x"}
    be = rio.MSCBackend(client=port, path_mapping=mapping)
    easy_io.register_backend("msc", be)
    try:
        easy_io.dump({"k": 1}, "msc://s3://bucket/c.json")
        assert port.blobs["data/c.json"] and easy_io.load("msc://s3://bucket/c.json") == {"k": 1}
    finally:
        easy_io._BACKENDS.pop("msc", None)


def test_msc_without_the_package_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "multistorageclient", None)
    with pytest.raises(rio.RemoteIOError, match="multistorageclient"):
        rio.MSCBackend()


def test_easy_io_remote_load_dump(s3):
    easy_io.dump({"a": 1, "b": [2, 3]}, "s3://bkt/conf/cfg.json")
    assert easy_io.load("s3://bkt/conf/cfg.json") == {"a": 1, "b": [2, 3]}
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    easy_io.dump(arr, "s3://bkt/conf/w.npy")
    np.testing.assert_array_equal(easy_io.load("s3://bkt/conf/w.npy"), arr)
    assert easy_io.exists("s3://bkt/conf/w.npy")
    assert not easy_io.exists("s3://bkt/conf/nothing.npy")
    state = {"w": torch.arange(4.0), "b": torch.ones(2, dtype=torch.bfloat16)}
    easy_io.dump(state, "s3://bkt/conf/state.pt")
    back = easy_io.load("s3://bkt/conf/state.pt")
    assert back.keys() == state.keys() and all(torch.equal(back[k], state[k]) for k in state)
    easy_io.dump({"a": 1}, "s3://bkt/conf/x.pkl")
    with pytest.raises(ValueError, match="refusing to unpickle"):
        easy_io.load("s3://bkt/conf/x.pkl")
    assert easy_io.load("s3://bkt/conf/x.pkl", allow_pickle=True) == {"a": 1}
    with pytest.raises(NotImplementedError, match="no backend registered"):
        easy_io.load("ftp://host/x.json")


def test_s3_backend_from_backend_args(store, monkeypatch):
    """``S3Backend(**CredentialEnvParser().backend_args(role))``: the port
    builds the client JAX's short keywords build, and it reaches the store;
    the JAX package's S3Backend raises TypeError on the same dict."""
    env = {"TEAM_DIR_ACCESS_KEY_ID": "AKIDTEAM", "TEAM_DIR_SECRET_ACCESS_KEY": "team-secret",
           "TEAM_DIR_ENDPOINT_URL": store, "TEAM_DIR_REGION_NAME": "eu-central-1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = tenv.get_credential_envs().backend_args("TEAM_DIR")
    assert args == jenv.get_credential_envs().backend_args("TEAM_DIR")
    be = rio.S3Backend(**args)
    want = jrio.S3Backend(access_key="AKIDTEAM", secret_key="team-secret", endpoint_url=store, region="eu-central-1")
    assert vars(be) == vars(want)
    with pytest.raises(TypeError, match="access_key_id"):
        jrio.S3Backend(**args)
    easy_io.register_backend("s3", be)
    try:
        easy_io.dump([{"x": 1}, {"x": 2}], "s3://team/rows.jsonl")
        assert want.get("s3://team/rows.jsonl") == b'{"x": 1}\n{"x": 2}\n'
        assert "Credential=AKIDTEAM/" in FakeStore.requests[-1][2]["Authorization"]
    finally:
        easy_io._BACKENDS.pop("s3", None)


def _tar_bytes() -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in (("0001.txt", b"one"), ("0001.npy", b"\x93NUMPY"), ("0002.txt", b"two")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


_RNG = np.random.default_rng(18)
_ARR = _RNG.standard_normal((3, 4)).astype(np.float32)
# (file name, object): what each package dumps, and the other loads
FORMATS = {
    "json": ("a.json", {"a": 1, "b": [2.5, "x"], "c": {"d": None}}),
    "yaml": ("a.yaml", {"name": "clip", "frames": 93, "hw": [192, 320], "nested": {"ok": True}}),
    "txt": ("a.txt", "a robot arm moves a block\nsecond line"),
    "npy": ("a.npy", _ARR),
    "npz": ("a.npz", {"x": _ARR, "y": np.arange(5, dtype=np.int64)}),
    "jsonl": ("a.jsonl", [{"i": 0}, {"i": 1, "s": "t"}]),
    "pkl": ("a.pkl", {"t": (1, 2), "s": {3}, "a": _ARR}),
    "csv": ("a.csv", [["a", "b"], ["1", "2"]]),
    "gz": ("a.json.gz", {"zipped": [1, 2, 3]}),
    "bytes": ("a.bytes", b"\x00\xffraw"),
    "msgpack": ("a.msgpack", {"params": {"w": _ARR, "b": np.zeros(3, np.float16)}, "step": np.int64(7),
                              "lr": np.float32(1e-4), "names": ["q", "k"], "z": 1 + 2j}),
}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        return isinstance(b, (np.ndarray, np.generic)) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("fmt", list(FORMATS) + ["tar"])
def test_formats_cross_load_between_packages(tmp_path, fmt):
    """A file the JAX package dumped loads in the port to equal values, and
    one the port dumped loads in the JAX package; a tar (which neither
    dumps) opens to the same members."""
    if fmt == "tar":
        path = tmp_path / "a.tar"
        path.write_bytes(_tar_bytes())
        got, want = easy_io.load(str(path)), j_easy_io.load(str(path))
        assert [(m.name, got.extractfile(m).read()) for m in got.getmembers()] == \
               [(m.name, want.extractfile(m).read()) for m in want.getmembers()]
        return
    name, obj = FORMATS[fmt]
    for writer, reader, sub in ((j_easy_io, easy_io, "from_jax"), (easy_io, j_easy_io, "from_port")):
        path = str(tmp_path / sub / name)
        writer.dump(obj, path)
        back, direct = reader.load(path), writer.load(path)
        assert _equal(back, direct), (fmt, sub, back, direct)


def test_msgpack_is_flax_serialization(tmp_path):
    """The port's msgpack (no flax) writes flax.serialization's bytes, also
    for bf16 arrays and chunk-free torch tensors, and restores them."""
    from flax import serialization

    tree = {"a": _ARR, "b": {"c": np.int32(3), "d": [1, 2.5, "x"]}, "e": np.ones((2, 2), np.int8)}
    assert easy_io.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    import ml_dtypes

    bf = np.arange(4, dtype=np.float32).astype(ml_dtypes.bfloat16)
    data = serialization.msgpack_serialize({"bf": bf})
    back = easy_io.msgpack_restore(data)["bf"]
    assert back.dtype == bf.dtype and np.array_equal(back.astype(np.float32), bf.astype(np.float32))
    t = {"t": torch.arange(4, dtype=torch.bfloat16), "u": torch.ones(2, 3)}
    restored = serialization.msgpack_restore(easy_io.msgpack_serialize(t))
    assert np.array_equal(np.asarray(restored["t"], np.float32), np.arange(4, dtype=np.float32))
    assert np.array_equal(restored["u"], np.ones((2, 3), np.float32))


def test_pt_round_trips(tmp_path):
    state = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(0)), "n": torch.tensor(7),
             "nested": {"b": torch.zeros(2, dtype=torch.bfloat16)}}
    for name in ("s.pt", "s.pth"):
        easy_io.dump(state, str(tmp_path / name))
        back = easy_io.load(str(tmp_path / name))
        assert torch.equal(back["w"], state["w"]) and torch.equal(back["n"], state["n"])
        assert back["nested"]["b"].dtype == torch.bfloat16
    # weights_only: an arbitrary object is refused
    torch.save({"f": FakeMSCClient()}, tmp_path / "obj.pt")
    with pytest.raises(Exception, match="[Ww]eights only"):
        easy_io.load(str(tmp_path / "obj.pt"))


def test_safetensors_load_equals_jax(tmp_path):
    from safetensors.numpy import save_file

    arrays = {"w": _ARR, "i": np.arange(3, dtype=np.int32)}
    save_file(arrays, str(tmp_path / "w.safetensors"))
    got, want = easy_io.load(str(tmp_path / "w.safetensors")), j_easy_io.load(str(tmp_path / "w.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], torch.Tensor) and np.array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("name,module", [("a.yaml", "yaml"), ("a.msgpack", "msgpack"),
                                         ("a.safetensors", "safetensors.torch"), ("a.png", "PIL")])
def test_missing_optional_package_raises_named_import_error(tmp_path, monkeypatch, name, module):
    path = tmp_path / name
    path.write_bytes(b"\x00")
    monkeypatch.setitem(sys.modules, module, None)
    with pytest.raises(ImportError, match=rf"{name.split('.')[1]} files need the '{module.split('.')[0]}' package"):
        easy_io.load(str(path))
    if module in ("yaml", "msgpack"):
        with pytest.raises(ImportError, match=module):
            easy_io.dump({"a": 1}, str(path))


def test_vqa_spec_without_yaml_raises_named_import_error(monkeypatch, tmp_path):
    (tmp_path / "s.yaml").write_text("vqa_checks: []\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        vqa_check.load_spec(tmp_path / "s.yaml")
