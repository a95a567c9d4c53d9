"""The port's HTTP server (inference/serving.py), its guardrail hooks
(inference/api.py) and the CLI's text guardrail (inference/cli.py), held
against the JAX package on the CPU.

One module-scoped pair of servers, JAX's and the port's, over the seeded
tiny pipeline of tests/test_torch_serving_modes.py (a 2-block 128-channel
DiT, the dim-16 VAE, 32x32 frames, 5-frame clips, 2 steps), each behind
the default blocklist. The cases of tests/test_serving.py run against the
port; where a request writes a video, the frames it wrote are held against
the JAX server's for the same request within one uint8 level (fp32 on both
sides; a pixel on a rounding boundary may round the other way, as in
test_torch_serving_modes.py), and a png the same.
"""

import base64
import glob
import http.client
import io
import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_threads  # noqa: F401  torch's CPU threads under xdist
from PIL import Image

from cosmos_predict2_tpu.inference import api as japi
from cosmos_predict2_tpu.inference import cli as jcli
from cosmos_predict2_tpu.inference import serving as jserving
from cosmos_predict2_tpu.inference.pipeline import Video2WorldInference as JPipe
from cosmos_predict2_tpu.utils import flags as jflags
from cosmos_predict2_tpu.utils import guardrails as jg
from cosmos_predict2_tpu_torch.inference import api as tapi
from cosmos_predict2_tpu_torch.inference import cli as tcli
from cosmos_predict2_tpu_torch.inference import serving as tserving
from cosmos_predict2_tpu_torch.inference.pipeline import Video2WorldInference
from cosmos_predict2_tpu_torch.utils import flags as tflags
from cosmos_predict2_tpu_torch.utils import guardrails as tg
from torch_variants_util import CTX_IN, tiny_serving_setup

BLOCKED = "a beheading in the town square"


def _record_exports(module, seen: dict):
    """Wrap ``module.save_img_or_video`` to keep the frames of every video
    it writes, by output name. Returns the original."""
    inner = module.save_img_or_video

    def spy(frames, path, *a, **kw):
        seen[os.path.basename(path)] = np.array(frames)
        return inner(frames, path, *a, **kw)

    module.save_img_or_video = spy
    return inner


@pytest.fixture(scope="module")
def pipes():
    jsetup, params, vae_params, setup, net, vae = tiny_serving_setup()
    jpipe = JPipe(jsetup, params, vae_params, text_encoder=lambda p: jnp.ones((len(p), 8, CTX_IN)) * 0.01)
    tpipe = Video2WorldInference(setup, net, vae, text_encoder=lambda p: torch.ones((len(p), 8, CTX_IN)) * 0.01)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def servers(pipes, tmp_path_factory):
    """{"jax": (server, exported frames), "port": (...)}: each server over
    its package's Inference with the default text guardrail."""
    jpipe, tpipe = pipes
    out = {}
    originals = []
    for name, api, serving, guard, pipe in (("jax", japi, jserving, jg, jpipe), ("port", tapi, tserving, tg, tpipe)):
        seen: dict = {}
        originals.append((api, _record_exports(api, seen)))
        inference = api.Inference(pipe, output_dir=str(tmp_path_factory.mktemp(f"serve_{name}")),
                                  text_guardrail=guard.create_text_guardrail_runner())
        srv = serving.ModelServer(inference, port=0)
        srv.serve_background()
        out[name] = (srv, seen)
    yield out
    for srv, _ in out.values():
        srv.shutdown()
    for api, inner in originals:
        api.save_img_or_video = inner


@pytest.fixture(scope="module")
def server(servers):
    return servers["port"][0]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return json.loads(r.read())


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _wait(port, job_id, timeout=600):
    deadline = time.time() + timeout
    while time.time() < deadline:
        status = _get(port, f"/status/{job_id}")
        if status["status"] in ("done", "error"):
            return status
        time.sleep(0.2)
    raise TimeoutError(job_id)


def _both(servers, payload):
    """The same request through both servers, one after the other: the
    port's status and the JAX server's."""
    return [_wait(servers[k][0].port, _post(servers[k][0].port, "/generate", payload)["job_id"]) for k in ("port", "jax")]


def _close_to_jax(servers, name):
    got, want = servers["port"][1][name], servers["jax"][1][name]
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_health(server):
    out = _get(server.port, "/health")
    assert out == {"status": "ok", "devices": 1}  # the pipeline is on the CPU


def test_generate_roundtrip(servers):
    ours, theirs = _both(servers, {"name": "job1", "prompt": "hello", "num_steps": 2, "guidance": 2.0})
    assert ours["status"] == theirs["status"] == "done", (ours, theirs)
    assert os.path.exists(ours["output"]) and ours["error"] is None
    _close_to_jax(servers, "job1")


def test_bad_requests(server):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server.port, "/status/nonexistent")
    assert exc.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server.port, "/bogus")
    assert exc.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server.port, "/elsewhere", {})
    assert exc.value.code == 404


def test_generate_image_mode(servers):
    ours, theirs = _both(servers, {"name": "img_job", "prompt": "a lighthouse", "mode": "image", "num_steps": 2,
                                   "guidance": 2.0})
    assert ours["status"] == theirs["status"] == "done", (ours, theirs)
    assert ours["output"].endswith(".png") and theirs["output"].endswith(".png")
    got, want = (np.asarray(Image.open(s["output"])).astype(np.int16) for s in (ours, theirs))
    assert got.shape == want.shape == (32, 32, 3) and np.abs(got - want).max() <= 1


def test_queue_endpoint(server):
    out = _get(server.port, "/queue")
    assert out["depth"] >= 0 and out["max_batch"] == 4


def test_concurrent_requests_all_complete(servers):
    """Three simultaneous same-geometry POSTs: the worker drains and batches
    them; every job reaches 'done' with its own output, each within one
    level of the JAX server's output for the same request."""
    port = servers["port"][0].port
    payloads = [{"name": f"conc{i}", "prompt": f"prompt {i}", "num_steps": 2, "guidance": 2.0, "seed": i + 1}
                for i in range(3)]
    job_ids, lock = [], threading.Lock()

    def post(payload):
        out = _post(port, "/generate", payload)
        with lock:
            job_ids.append(out["job_id"])

    threads = [threading.Thread(target=post, args=(p,)) for p in payloads]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    statuses = [_wait(port, j) for j in job_ids]
    assert all(s["status"] == "done" for s in statuses), statuses
    assert len({s["output"] for s in statuses}) == 3  # distinct files, no clobbering
    for p in payloads:
        jport = servers["jax"][0].port
        assert _wait(jport, _post(jport, "/generate", p)["job_id"])["status"] == "done"
        _close_to_jax(servers, p["name"])


def test_batched_generation_matches_single(pipes):
    """Pipeline level: one batched pass equals N single passes (same seeds),
    and equals JAX's batched pass."""
    jpipe, pipe = pipes
    emb = np.concatenate([np.full((1, 8, CTX_IN), 0.01, np.float32), np.full((1, 8, CTX_IN), 0.03, np.float32)])
    video = np.zeros((2, 3, 5, 32, 32), dtype=np.uint8)
    batched = pipe.generate_vid2world_batch(video, emb, guidance=2.0, num_steps=2, num_conditional_frames=0,
                                            seeds=[11, 22])
    for b, seed in enumerate((11, 22)):
        single = pipe.generate_vid2world(video[b:b + 1], emb[b:b + 1], guidance=2.0, num_steps=2,
                                         num_conditional_frames=0, seed=seed)
        np.testing.assert_allclose(batched[b], single, rtol=1e-4, atol=1e-4)
    assert np.abs(batched[0] - batched[1]).max() > 1e-6  # seeds differ
    want = jpipe.generate_vid2world_batch(video, jnp.asarray(emb), guidance=2.0, num_steps=2, num_conditional_frames=0,
                                          seeds=[11, 22])
    np.testing.assert_allclose(batched, np.asarray(want), rtol=0, atol=2e-3)


def test_schema_and_param_validation(servers, server):
    schema = _get(server.port, "/schema")
    assert schema == _get(servers["jax"][0].port, "/schema")
    assert schema["num_steps"]["min"] == 1 and sorted(schema["mode"]["values"]) == ["image", "video"]
    for bad in ({"guidance": 99.0}, {"mode": "audio"}, {"bogus_key": 1}, {"num_steps": 0}, {"input_path": "/nope.png"},
                {"sampler": "ddim"}, {"seed": -1}):
        for srv in (server, servers["jax"][0]):
            with pytest.raises(urllib.error.HTTPError) as exc:
                _post(srv.port, "/generate", {"prompt": "x", **bad})
            assert exc.value.code == 400
            assert json.loads(exc.value.read())["error"].startswith("bad request:")


def test_web_ui_index(servers, server):
    pages = []
    for srv in (server, servers["jax"][0]):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/") as r:
            assert r.headers.get("Content-Type", "").startswith("text/html")
            pages.append(r.read().decode())
    for needle in ("/generate", "/status/", "/output/", "<video", "prompt"):
        assert needle in pages[0], needle
    assert "TPU" not in pages[0] and "GPU" in pages[0]
    assert pages[0].replace("GPU", "TPU") == pages[1]  # the same page, naming the card


def test_output_endpoint_serves_video(server):
    job_id = _post(server.port, "/generate", {"name": "ui_job", "prompt": "hi", "num_steps": 2, "guidance": 2.0})["job_id"]
    status = _wait(server.port, job_id)
    assert status["status"] == "done", status
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/output/{job_id}") as r:
        ctype, data = r.headers["Content-Type"], r.read()
    assert ctype in ("video/mp4", "image/gif") and len(data) > 100
    with open(status["output"], "rb") as f:
        assert f.read() == data  # streamed whole, in 1 MiB chunks
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/output/{job_id}", method="HEAD")
    with urllib.request.urlopen(req) as r:
        assert r.headers["Content-Type"] == ctype and int(r.headers["Content-Length"]) == len(data)
        assert r.read() == b""
    for method in ("GET", "HEAD"):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/output/nonexistent", method=method)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req)
        assert exc.value.code == 404


def _png_b64(color=(200, 30, 30)):
    buf = io.BytesIO()
    Image.new("RGB", (32, 32), color).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def test_inline_image_upload(servers, server):
    """input_image_b64 (data URL) feeds Image2World like an input_path, and
    the upload's temp file is gone when the job is done."""
    before = set(glob.glob(os.path.join(tempfile.gettempdir(), "cosmos_upload_*")))
    ours, theirs = _both(servers, {"name": "upload_job", "prompt": "x", "num_steps": 2, "guidance": 2.0,
                                   "num_conditional_frames": 1, "input_image_b64": _png_b64()})
    assert ours["status"] == theirs["status"] == "done", (ours, theirs)
    _close_to_jax(servers, "upload_job")
    assert set(glob.glob(os.path.join(tempfile.gettempdir(), "cosmos_upload_*"))) <= before
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server.port, "/generate", {"prompt": "x", "input_image_b64": "!!!notbase64"})
    assert exc.value.code == 400


def test_non_object_json_body_is_400(server):
    for body in (json.dumps([1, 2, 3]).encode(), b"{not json"):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req)
        assert exc.value.code == 400


@pytest.mark.parametrize("case", ["wav", "webp", "png", "jpg", "gif", "text", "oversized"])
def test_image_magic_sniffing(case):
    """save_inline_image: the same accepted formats and rejections as JAX's
    (RIFF alone, as WAV or AVI, is rejected; RIFF....WEBP is a webp)."""
    data = {"wav": b"RIFF" + (36).to_bytes(4, "little") + b"WAVEfmt " + b"\x00" * 32,
            "webp": b"RIFF" + (20).to_bytes(4, "little") + b"WEBPVP8 " + b"\x00" * 16,
            "png": b"\x89PNG\r\n\x1a\n" + b"\x00" * 8, "jpg": b"\xff\xd8\xff\xe0" + b"\x00" * 8,
            "gif": b"GIF89a" + b"\x00" * 8, "text": b"hello world"}.get(case)
    b64 = "A" * (tserving.MAX_UPLOAD_BYTES * 4 // 3 + 8) if case == "oversized" else base64.b64encode(data).decode()
    results = []
    for serving in (tserving, jserving):
        try:
            path = serving.save_inline_image(b64)
            results.append(os.path.splitext(path)[1])
            os.unlink(path)
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]
    assert results[0].startswith(".") == (case in ("webp", "png", "jpg", "gif"))


def test_oversized_body_rejected_before_read(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    try:
        conn.putrequest("POST", "/generate")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(512 * 1024 * 1024))
        conn.endheaders()  # headers only: the 512 MB body is never sent
        resp = conn.getresponse()
        assert resp.status == 413, (resp.status, resp.read()[:200])
    finally:
        conn.close()
    for length in ("-5", "abc"):
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        try:
            conn.putrequest("POST", "/generate")
            conn.putheader("Content-Length", length)
            conn.endheaders()
            assert conn.getresponse().status == 400
        finally:
            conn.close()


def test_rejected_upload_leaves_no_temp_file(server):
    png = base64.b64encode(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64).decode()
    before = set(glob.glob(os.path.join(tempfile.gettempdir(), "cosmos_upload_*")))
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/generate",
                                 data=json.dumps({"input_image_b64": png, "num_steps": -5}).encode(),
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req)
    assert exc.value.code == 400
    assert set(glob.glob(os.path.join(tempfile.gettempdir(), "cosmos_upload_*"))) == before


# ------------------------------- guardrails -------------------------------


def test_blocked_prompt_is_an_error_job(servers):
    """A blocklisted prompt ends in status error with no output on both
    servers; nothing is exported."""
    ours, theirs = _both(servers, {"name": "blocked_job", "prompt": BLOCKED, "num_steps": 2})
    for status in (ours, theirs):
        assert status["status"] == "error" and status["output"] is None, status
    assert ours["error"] == theirs["error"]
    assert "blocked_job" not in servers["port"][1] and "blocked_job" not in servers["jax"][1]


@pytest.mark.parametrize("route", ["sequential", "batched", "autoregressive", "image"])
def test_inference_guardrails_match_jax(pipes, tmp_path, route):
    """Both packages' Inference on each route: a blocklisted prompt gives no
    output (keep_going) or raises the same ValueError; the video guardrail
    sees the same uint8 frames (within one level), what it returns is what
    is written, and a None from it skips the sample or raises the same
    RuntimeError. Image mode runs no video guardrail, as in JAX."""
    results = {}
    for name, api, guard, pipe in (("port", tapi, tg, pipes[1]), ("jax", japi, jg, pipes[0])):
        seen, written = [], {}
        inner = _record_exports(api, written)
        try:
            def video_guard(frames, seen=seen):
                seen.append(np.array(frames))
                return frames[::-1].copy()  # what the guard returns is what is written

            args = [api.InferenceArguments(name=f"{route}{i}", prompt=p, num_steps=2, guidance=2.0, seed=i + 1,
                                           mode="image" if route == "image" else "video",
                                           enable_autoregressive=route == "autoregressive", chunk_size=5,
                                           num_output_frames=9)
                    for i, p in enumerate(["a calm lake", BLOCKED, "a busy street"])]
            inference = api.Inference(pipe, output_dir=str(tmp_path / name), video_guardrail=video_guard,
                                      text_guardrail=guard.create_text_guardrail_runner())
            outputs = (inference.generate_batch(args) if route == "batched" else
                       {a.name: p for a, p in zip([args[0], args[2]], inference.generate(args))})
            strict = api.Inference(pipe, output_dir=str(tmp_path / name), keep_going=False,
                                   text_guardrail=guard.create_text_guardrail_runner(),
                                   video_guardrail=lambda frames: None)
            errors = []
            for a in args[1:2] if route == "image" else args[1:]:  # image mode runs no video guardrail
                with pytest.raises((ValueError, RuntimeError)) as exc:
                    strict.generate_batch([a, args[0]] if route == "batched" else [a])
                errors.append((exc.type.__name__, str(exc.value)))
        finally:
            api.save_img_or_video = inner
        results[name] = (seen, written, outputs, errors)
    (seen, written, outputs, errors), (jseen, jwritten, joutputs, jerrors) = results["port"], results["jax"]
    assert sorted(outputs) == sorted(joutputs) == sorted([f"{route}0", f"{route}2"])
    assert not any(BLOCKED in str(p) for p in outputs.values())
    assert os.listdir(tmp_path / "port") and f"{route}1" not in "".join(os.listdir(tmp_path / "port"))
    if route == "image":
        assert seen == jseen == [] and errors == jerrors and errors[0][0] == "ValueError"
        return
    assert errors == jerrors  # text: ValueError; video: RuntimeError "... video blocked by guardrail"
    assert errors[0][0] == "ValueError" and errors[1] == ("RuntimeError", f"sample {route}2: video blocked by guardrail")
    assert len(seen) == len(jseen) == 2
    for got, want in zip(seen, jseen):
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    for i, got in zip((0, 2), seen):
        np.testing.assert_array_equal(written[f"{route}{i}"], got[::-1])


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("mode", ["video", "text2image"])
def test_cli_refuses_a_blocklisted_prompt(pipes, tmp_path, monkeypatch, package, mode):
    """By default either CLI refuses a blocklisted prompt, writes nothing and
    exits 1 (before this guardrail the port's CLI wrote the video); with
    --disable-guardrails the prompt goes through and a file is written."""
    cli, flags = (tcli, tflags) if package == "port" else (jcli, jflags)
    monkeypatch.setattr(cli, "build_pipeline", lambda args: pipes[0 if package == "jax" else 1])
    monkeypatch.setattr(flags, "SMOKE", False)  # another test of this process may have reloaded it under COSMOS_SMOKE
    out = tmp_path / "out"
    argv = ["--prompt", BLOCKED, "--output-dir", str(out), "--num-steps", "2", "--guidance", "2", "--mode", mode]
    assert cli.main(argv) == 1
    assert not out.exists() or not os.listdir(out)
    if mode == "video":
        assert cli.main(argv + ["--disable-guardrails"]) == 0
        assert [os.path.splitext(f)[0] for f in os.listdir(out)] == ["sample"]
