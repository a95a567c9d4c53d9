"""In-process fakes for the port's remote-IO tests: an object store, a copy
of tests/test_remote_io.py's handler (just enough of the S3 XML API and the
GCS JSON API for utils/remote_io.py's backends) served on 127.0.0.1 by a
threaded http.server with a log of the requests it answered, and a
multistorageclient stand-in for the MSC backend."""

import contextlib
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class FakeStore(BaseHTTPRequestHandler):
    """Speaks just enough S3 XML API and GCS JSON API for the backends."""

    objects: dict = {}  # (bucket, key) -> bytes
    requests: list = []  # (method, path, headers) in arrival order

    def log_message(self, *a):
        pass

    def _send(self, code, body=b"", ctype="application/octet-stream"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)

    def _parse(self):
        self.requests.append((self.command, self.path, dict(self.headers)))
        parsed = urllib.parse.urlparse(self.path)
        return parsed.path.strip("/"), dict(urllib.parse.parse_qsl(parsed.query))

    def do_GET(self):
        path, q = self._parse()
        # GCS JSON API
        if path.startswith("storage/v1/b/"):
            parts = path.split("/")
            bucket = parts[3]
            if len(parts) >= 6 and parts[4] == "o" and parts[5]:
                key = urllib.parse.unquote(parts[5])
                data = self.objects.get((bucket, key))
                if data is None:
                    return self._send(404, b"{}", "application/json")
                if q.get("alt") == "media":
                    return self._send(200, data)
                return self._send(200, json.dumps({"name": key}).encode(), "application/json")
            prefix = q.get("prefix", "")
            items = [{"name": k} for (b, k) in sorted(self.objects) if b == bucket and k.startswith(prefix)]
            return self._send(200, json.dumps({"items": items}).encode(), "application/json")
        # S3
        bucket, _, key = path.partition("/")
        if "list-type" in q:
            prefix = q.get("prefix", "")
            keys = [k for (b, k) in sorted(self.objects) if b == bucket and k.startswith(prefix)]
            xml = "<ListBucketResult>" + "".join(
                f"<Contents><Key>{k}</Key></Contents>" for k in keys
            ) + "<IsTruncated>false</IsTruncated></ListBucketResult>"
            return self._send(200, xml.encode(), "application/xml")
        data = self.objects.get((bucket, urllib.parse.unquote(key)))
        if data is None:
            return self._send(404, b"NoSuchKey")
        return self._send(200, data)

    do_HEAD = do_GET

    def do_PUT(self):
        path, _ = self._parse()
        bucket, _, key = path.partition("/")
        n = int(self.headers.get("Content-Length", 0))
        self.objects[(bucket, urllib.parse.unquote(key))] = self.rfile.read(n)
        self._send(200)

    def do_POST(self):
        # GCS media upload
        path, q = self._parse()
        if path.startswith("upload/storage/v1/b/"):
            bucket = path.split("/")[4]
            n = int(self.headers.get("Content-Length", 0))
            self.objects[(bucket, q["name"])] = self.rfile.read(n)
            return self._send(200, b"{}", "application/json")
        self._send(404)


@contextlib.contextmanager
def serve():
    """A fresh store on 127.0.0.1; yields its endpoint URL."""
    FakeStore.objects, FakeStore.requests = {}, []
    server = ThreadingHTTPServer(("127.0.0.1", 0), FakeStore)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


class _Meta:
    def __init__(self, key):
        self.key = key


class FakeMSCClient:
    """The calls MSCBackend makes of a multistorageclient StorageClient."""

    def __init__(self):
        self.blobs = {}

    def read(self, path):
        return self.blobs[path]

    def write(self, path, body):
        self.blobs[path] = bytes(body)

    def is_file(self, path):
        return path in self.blobs

    def is_empty(self, path):
        return not any(k.startswith(path) for k in self.blobs)

    def delete(self, path, recursive):
        del self.blobs[path]

    def list(self, path, include_directories, include_url_prefix):
        return [_Meta(k) for k in sorted(self.blobs) if k.startswith(path)]
