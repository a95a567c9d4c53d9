"""Serving: HTTP front end + worker queue.

Counterpart of cosmos_predict2_tpu/inference/serving.py, in place of the
reference's Gradio multi-GPU serving stack (packages/cosmos-gradio/:
ModelServer spawning one OS process per GPU with filesystem IPC + barrier,
model_ipc/model_server.py:25-145): one process drives the card, so serving
is a single worker thread consuming a job queue behind a small stdlib HTTP
server.

Endpoints:
  GET  /           browser UI (prompt box, image upload, job polling,
                   inline playback): the reference Gradio app's surface
                   (cosmos-gradio/gradio_app/gradio_app.py:26)
  POST /generate   {"prompt": ..., "input_path": ..., ...InferenceArguments}
                   -> {"job_id": ...}; accepts "input_image_b64" (data URL
                   or raw base64) as an inline alternative to input_path
  GET  /status/<job_id>  -> {"status": queued|running|done|error, "output": path, "error": ...}
  GET  /output/<job_id>  -> the generated video/gif/image bytes (GET and HEAD)
  GET  /health     -> {"status": "ok", "devices": N}: the visible CUDA
                   devices when the pipeline is on one, 1 on the CPU
  GET  /queue      -> {"depth": ..., "max_batch": ...}
  GET  /schema     -> validated parameter schema (types/ranges/defaults)

The worker drains up to ``max_batch`` queued jobs, buckets them by
``Inference.batch_key`` and serves each bucket with one
``Inference.generate_batch`` call: one batched sampling pass for
same-geometry UniPC video requests. The Inference's guardrails apply to
every job.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import json
import logging
import os
import queue
import shutil
import tempfile
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from cosmos_predict2_tpu_torch.inference.api import Inference, InferenceArguments
from cosmos_predict2_tpu_torch.utils import validator as V

log = logging.getLogger("cosmos_predict2_tpu_torch")


class GenerateRequest(V.ValidatedParams):
    """Validated /generate payload (the reference validates its serving
    model params with the same descriptor library, imaginaire/utils/
    validator.py via gradio ModelParams). Mirrors InferenceArguments with
    ranges; unknown keys are rejected with HTTP 400."""

    name = V.String(default="sample", max_len=128)
    prompt = V.String(default="", max_len=10_000)
    input_path = V.Path(default=None, tooltip="image or video; omit for Text2World")
    negative_prompt = V.String(default="", max_len=10_000)
    num_output_frames = V.Int(default=77, min=1, max=4096)
    num_steps = V.Int(default=InferenceArguments.num_steps, min=1, max=200)
    guidance = V.Float(default=7.0, min=0.0, max=30.0)
    seed = V.Int(default=1, min=0)
    num_conditional_frames = V.OneOf(default=1, options=(0, 1, 2), type_cast=int)
    enable_autoregressive = V.Bool(default=False)
    chunk_size = V.Int(default=77, min=2, max=4096)
    chunk_overlap = V.Int(default=1, min=1, max=64)
    text_embedding_path = V.Path(default=None)
    mode = V.OneOf(default="video", options=("video", "image"))
    sampler = V.OneOf(default="unipc", options=("unipc", "dmd2"))

    def to_args(self) -> InferenceArguments:
        return InferenceArguments(**self.to_dict())


_IMAGE_MAGIC = {b"\x89PNG": "png", b"\xff\xd8\xff": "jpg", b"GIF8": "gif"}


MAX_UPLOAD_BYTES = 64 * 1024 * 1024  # decoded image size cap


def save_inline_image(b64: str) -> str:
    """Decode an uploaded base64/data-URL image to a temp file, return its path."""
    if "," in b64 and b64.lstrip().startswith("data:"):
        b64 = b64.split(",", 1)[1]
    if len(b64) > MAX_UPLOAD_BYTES * 4 // 3 + 4:
        raise ValueError(f"image upload exceeds {MAX_UPLOAD_BYTES >> 20} MB cap")
    try:
        data = base64.b64decode(b64, validate=True)
    except (binascii.Error, ValueError) as e:
        raise ValueError(f"invalid base64 image: {e}") from e
    ext = next((x for magic, x in _IMAGE_MAGIC.items() if data[:4].startswith(magic[:4])), None)
    # RIFF alone also matches WAV/AVI containers; webp needs bytes 8..12
    if ext is None and data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        ext = "webp"
    if ext is None:
        raise ValueError("unrecognized image format (need png/jpg/gif/webp)")
    fd, path = tempfile.mkstemp(suffix=f".{ext}", prefix="cosmos_upload_")
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    return path


@dataclasses.dataclass
class Job:
    job_id: str
    args: InferenceArguments
    status: str = "queued"
    output: Optional[str] = None
    error: Optional[str] = None
    cleanup_path: Optional[str] = None  # uploaded temp file, removed when done


class ModelWorker:
    """Background worker draining the job queue through Inference.

    Batching: each drain takes everything queued (up to ``max_batch``),
    buckets jobs by Inference.batch_key, and runs each bucket as one
    batched sampling pass (denoise at batch 2N), so concurrent same-shape
    requests cost barely more than one. Mixed-key, image, autoregressive
    and dmd2 jobs take the sequential path inside generate_batch.
    """

    def __init__(self, inference: Inference, max_batch: int = 4):
        self.inference = inference
        self.max_batch = max_batch
        self.jobs: dict[str, Job] = {}
        self.queue: queue.Queue[Job] = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, args: InferenceArguments, cleanup_path: Optional[str] = None) -> str:
        job = Job(job_id=uuid.uuid4().hex[:12], args=args, cleanup_path=cleanup_path)
        # unique output name per job so concurrent requests never clobber
        if not args.name or args.name == "sample":
            job.args = dataclasses.replace(args, name=f"sample_{job.job_id}")
        self.jobs[job.job_id] = job
        self.queue.put(job)
        return job.job_id

    def queue_depth(self) -> int:
        return self.queue.qsize()

    def devices(self) -> int:
        """The visible CUDA devices when the pipeline is on one, else 1."""
        return torch.cuda.device_count() if self.inference.pipe.device.type == "cuda" else 1

    def _drain(self) -> list[Job]:
        batch = [self.queue.get()]  # block for the first
        while len(batch) < self.max_batch:
            try:
                batch.append(self.queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _run(self):
        while True:
            drained = self._drain()
            buckets: dict = {}
            for job in drained:
                buckets.setdefault(self.inference.batch_key(job.args), []).append(job)
            for bucket in buckets.values():
                for job in bucket:
                    job.status = "running"
                try:
                    outputs = self.inference.generate_batch([j.args for j in bucket])
                    for job in bucket:
                        if job.args.name in outputs:
                            job.output = outputs[job.args.name]
                            job.status = "done"
                        else:
                            job.status = "error"
                            job.error = "generation produced no output (guardrail or failure)"
                except Exception as e:
                    for job in bucket:
                        if job.status == "running":
                            job.status = "error"
                            job.error = str(e)
                    log.error(f"batch of {len(bucket)} failed: {e}")
                finally:
                    for job in bucket:  # uploaded temp files are one-shot
                        if job.cleanup_path:
                            try:
                                os.unlink(job.cleanup_path)
                            except OSError:
                                pass
                            job.cleanup_path = None


def make_handler(worker: ModelWorker):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_file(self, path: str, head_only: bool = False):
            types = {".mp4": "video/mp4", ".gif": "image/gif", ".png": "image/png", ".jpg": "image/jpeg"}
            ctype = types.get(os.path.splitext(path)[1].lower(), "application/octet-stream")
            try:
                size = os.stat(path).st_size
            except OSError:
                self._send(404, {"error": "output file missing"})
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(size))
            self.end_headers()
            if head_only:
                return
            try:  # stream in chunks: a 720p clip is hundreds of MB
                with open(path, "rb") as f:
                    shutil.copyfileobj(f, self.wfile, length=1 << 20)
            except OSError:
                pass  # file vanished mid-send or client disconnected

        def _output_path(self):
            job = worker.jobs.get(self.path.rsplit("/", 1)[-1])
            if job is None or job.status != "done" or not job.output:
                return None
            return job.output

        def do_HEAD(self):
            if self.path.startswith("/output/"):
                path = self._output_path()
                if path is None:
                    self.send_response(404)
                    self.end_headers()
                else:
                    self._send_file(path, head_only=True)
            else:
                self.send_response(404)
                self.end_headers()

        def do_GET(self):
            if self.path == "/" or self.path == "/index.html":
                from cosmos_predict2_tpu_torch.inference.web_ui import INDEX_HTML

                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/output/"):
                path = self._output_path()
                if path is None:
                    self._send(404, {"error": "no finished output for that job"})
                else:
                    self._send_file(path)
            elif self.path == "/health":
                self._send(200, {"status": "ok", "devices": worker.devices()})
            elif self.path == "/queue":
                self._send(200, {"depth": worker.queue_depth(), "max_batch": worker.max_batch})
            elif self.path == "/schema":
                self._send(200, GenerateRequest.schema())
            elif self.path.startswith("/status/"):
                job = worker.jobs.get(self.path.rsplit("/", 1)[-1])
                if job is None:
                    self._send(404, {"error": "unknown job"})
                else:
                    self._send(200, {"status": job.status, "output": job.output, "error": job.error})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._send(400, {"error": "invalid Content-Length"})
                return
            # bound the body BEFORE buffering it: the base64 of a cap-sized
            # image plus the other fields; anything bigger can only be an
            # over-cap upload, rejected here without reading it into memory.
            # A negative length would make read(-1) buffer until EOF: reject.
            max_body = MAX_UPLOAD_BYTES * 4 // 3 + 65536
            if length < 0:
                self._send(400, {"error": "invalid Content-Length"})
                return
            if length > max_body:
                self._send(413, {"error": f"request body exceeds {max_body >> 20} MB cap"})
                return
            upload_path = None
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("request body must be a JSON object")
                b64 = payload.pop("input_image_b64", None)
                if b64:
                    upload_path = save_inline_image(b64)
                    payload["input_path"] = upload_path
                args = GenerateRequest.from_dict(payload).to_args()
            except (json.JSONDecodeError, TypeError, ValueError) as e:
                if upload_path:  # rejected request must not leak its temp file
                    try:
                        os.unlink(upload_path)
                    except OSError:
                        pass
                self._send(400, {"error": f"bad request: {e}"})
                return
            self._send(200, {"job_id": worker.submit(args, cleanup_path=upload_path)})

        def log_message(self, fmt, *args):  # route to our logger
            log.debug("http: " + fmt % args)

    return Handler


class ModelServer:
    """HTTP server + worker (reference GradioApp/ModelServer equivalent)."""

    def __init__(self, inference: Inference, host: str = "127.0.0.1", port: int = 8080):
        self.worker = ModelWorker(inference)
        self.httpd = ThreadingHTTPServer((host, port), make_handler(self.worker))
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        log.info(f"serving on port {self.port}")
        self.httpd.serve_forever()

    def serve_background(self) -> threading.Thread:
        thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        thread.start()
        return thread

    def shutdown(self):
        self.httpd.shutdown()
