"""First-party S3 / GCS / MSC object-store backends over plain HTTP
(standard library only): the port's copy of
cosmos_predict2_tpu/utils/remote_io.py.

Capability parity with the reference's easy_io backends
(imaginaire/utils/easy_io/backends/boto3_backend.py, boto3_client.py,
http_backend.py, msc_backend.py): get / put / exists / list for
``s3://bucket/key``, ``gs://bucket/key`` and ``msc://...`` paths, without
boto3 or google-cloud-storage:

* S3: AWS Signature V4 request signing (GET/PUT/HEAD + list-objects-v2),
  credentials from the standard env vars or a json credentials file, the
  secret format of the reference's ``s3_credential_path``
  (utils/env_parsers.py's ``CredentialEnvParser.backend_args`` builds the
  keyword arguments).
* GCS: JSON API with a bearer token (``GOOGLE_OAUTH_ACCESS_TOKEN`` or the
  GCE metadata server), anonymous for public buckets.
* MSC: an adapter over the ``multistorageclient`` package, or an injected
  client.

S3 and GCS take an ``endpoint_url``, which is also how the tests run them
against a local fake object store (tests/test_torch_remote_io.py), as
boto3 users point a client at minio or localstack.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterator, Optional
from xml.etree import ElementTree


class RemoteIOError(IOError):
    pass


def _http(req: urllib.request.Request, timeout: float = 60.0) -> tuple[int, bytes, dict]:
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)
    except urllib.error.URLError as e:
        raise RemoteIOError(f"{req.full_url}: {e.reason}") from e


def split_bucket_key(path: str, scheme: str) -> tuple[str, str]:
    assert path.startswith(scheme + "://"), path
    rest = path[len(scheme) + 3 :]
    bucket, _, key = rest.partition("/")
    return bucket, key


# ---------------------------------------------------------------------------
# S3 (AWS Signature V4)
# ---------------------------------------------------------------------------


class S3Backend:
    """Minimal S3 client: SigV4-signed GET/PUT/HEAD/LIST.

    Credentials resolution order (mirrors the reference's boto3 usage,
    boto3_client.py:25-85): explicit args > env (AWS_ACCESS_KEY_ID /
    AWS_SECRET_ACCESS_KEY / AWS_ENDPOINT_URL / AWS_REGION) > json
    credentials file {"aws_access_key_id": ..., "aws_secret_access_key":
    ..., "endpoint_url": ...} (the reference's s3 secret format). With no
    credentials at all, requests go unsigned (public buckets / fakes).

    ``access_key_id``, ``secret_access_key`` and ``region_name`` are the
    spellings of ``CredentialEnvParser.backend_args`` (utils/env_parsers.py),
    so ``S3Backend(**CredentialEnvParser().backend_args("TEAM_DIR"))``
    builds a client. The JAX package's S3Backend takes only the short names
    and raises TypeError on that dict.
    """

    def __init__(
        self,
        access_key: Optional[str] = None,
        secret_key: Optional[str] = None,
        region: Optional[str] = None,
        endpoint_url: Optional[str] = None,
        credential_path: Optional[str] = None,
        access_key_id: Optional[str] = None,
        secret_access_key: Optional[str] = None,
        region_name: Optional[str] = None,
    ):
        access_key, secret_key = access_key or access_key_id, secret_key or secret_access_key
        region = region or region_name
        creds: dict = {}
        if credential_path and os.path.exists(credential_path):
            with open(credential_path) as f:
                creds = json.load(f)
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID") or creds.get("aws_access_key_id")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY") or creds.get("aws_secret_access_key")
        self.region = region or os.environ.get("AWS_REGION") or creds.get("region_name", "us-east-1")
        self.endpoint_url = (
            endpoint_url or os.environ.get("AWS_ENDPOINT_URL") or creds.get("endpoint_url")
        )

    # ---- SigV4 ----

    def _sign(self, method: str, url: str, payload: bytes, headers: dict) -> dict:
        if not (self.access_key and self.secret_key):
            return headers  # anonymous
        parsed = urllib.parse.urlparse(url)
        host = parsed.netloc
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(payload).hexdigest()

        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
            for k, v in sorted(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True))
        )
        signed = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        canonical_headers = "".join(f"{k}:{v}\n" for k, v in sorted(signed.items()))
        signed_names = ";".join(sorted(signed))
        canonical_request = "\n".join(
            [
                method,
                urllib.parse.quote(parsed.path or "/"),
                canonical_query,
                canonical_headers,
                signed_names,
                payload_hash,
            ]
        )
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )

        def hm(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = hm(hm(hm(hm(b"AWS4" + self.secret_key.encode(), datestamp), self.region), "s3"), "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        headers = dict(headers)
        headers.update(
            {
                "x-amz-date": amz_date,
                "x-amz-content-sha256": payload_hash,
                "Authorization": (
                    f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
                    f"SignedHeaders={signed_names}, Signature={signature}"
                ),
            }
        )
        return headers

    def _url(self, bucket: str, key: str, query: str = "") -> str:
        if self.endpoint_url:
            base = f"{self.endpoint_url.rstrip('/')}/{bucket}/{urllib.parse.quote(key)}"
        else:
            base = f"https://{bucket}.s3.{self.region}.amazonaws.com/{urllib.parse.quote(key)}"
        return base + (f"?{query}" if query else "")

    def _request(self, method: str, url: str, payload: bytes = b"") -> tuple[int, bytes, dict]:
        headers = self._sign(method, url, payload, {})
        req = urllib.request.Request(url, data=payload if method == "PUT" else None, headers=headers, method=method)
        return _http(req)

    # ---- public API ----

    def get(self, path: str) -> bytes:
        bucket, key = split_bucket_key(path, "s3")
        status, body, _ = self._request("GET", self._url(bucket, key))
        if status != 200:
            raise RemoteIOError(f"s3 GET {path}: HTTP {status}: {body[:200]!r}")
        return body

    def put(self, data: bytes, path: str) -> None:
        bucket, key = split_bucket_key(path, "s3")
        status, body, _ = self._request("PUT", self._url(bucket, key), payload=data)
        if status not in (200, 201):
            raise RemoteIOError(f"s3 PUT {path}: HTTP {status}: {body[:200]!r}")

    def exists(self, path: str) -> bool:
        bucket, key = split_bucket_key(path, "s3")
        status, _, _ = self._request("HEAD", self._url(bucket, key))
        return status == 200

    def list(self, prefix_path: str) -> Iterator[str]:
        """Yield s3://bucket/key for keys under the prefix (list-objects-v2)."""
        bucket, prefix = split_bucket_key(prefix_path, "s3")
        token = None
        while True:
            q = {"list-type": "2", "prefix": prefix}
            if token:
                q["continuation-token"] = token
            query = urllib.parse.urlencode(sorted(q.items()))
            if self.endpoint_url:
                url = f"{self.endpoint_url.rstrip('/')}/{bucket}?{query}"
            else:
                url = f"https://{bucket}.s3.{self.region}.amazonaws.com/?{query}"
            status, body, _ = self._request("GET", url)
            if status != 200:
                raise RemoteIOError(f"s3 LIST {prefix_path}: HTTP {status}: {body[:200]!r}")
            root = ElementTree.fromstring(body)
            ns = root.tag.partition("}")[0] + "}" if root.tag.startswith("{") else ""
            for el in root.iter(f"{ns}Key"):
                yield f"s3://{bucket}/{el.text}"
            truncated = root.find(f"{ns}IsTruncated")
            token_el = root.find(f"{ns}NextContinuationToken")
            if truncated is None or truncated.text != "true" or token_el is None:
                return
            token = token_el.text


# ---------------------------------------------------------------------------
# GCS (JSON API)
# ---------------------------------------------------------------------------


class GCSBackend:
    """Minimal GCS client over the JSON API.

    Auth: explicit token > GOOGLE_OAUTH_ACCESS_TOKEN env > GCE metadata
    server > anonymous (public buckets). ``endpoint_url`` overrides
    https://storage.googleapis.com for tests/emulators
    (STORAGE_EMULATOR_HOST is honored too, like google-cloud-storage).
    """

    def __init__(self, token: Optional[str] = None, endpoint_url: Optional[str] = None):
        self._token = token
        self.endpoint_url = (
            endpoint_url
            or os.environ.get("STORAGE_EMULATOR_HOST")
            or "https://storage.googleapis.com"
        )
        if self.endpoint_url and not self.endpoint_url.startswith(("http://", "https://")):
            self.endpoint_url = "http://" + self.endpoint_url

    def _auth_headers(self) -> dict:
        token = self._token or os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        if not token:
            token = self._metadata_token()
        return {"Authorization": f"Bearer {token}"} if token else {}

    def _metadata_token(self) -> Optional[str]:
        try:
            req = urllib.request.Request(
                "http://metadata.google.internal/computeMetadata/v1/instance/service-accounts/default/token",
                headers={"Metadata-Flavor": "Google"},
            )
            with urllib.request.urlopen(req, timeout=2.0) as r:
                return json.loads(r.read()).get("access_token")
        except Exception:
            return None

    def get(self, path: str) -> bytes:
        bucket, key = split_bucket_key(path, "gs")
        url = f"{self.endpoint_url}/storage/v1/b/{bucket}/o/{urllib.parse.quote(key, safe='')}?alt=media"
        status, body, _ = _http(urllib.request.Request(url, headers=self._auth_headers()))
        if status != 200:
            raise RemoteIOError(f"gs GET {path}: HTTP {status}: {body[:200]!r}")
        return body

    def put(self, data: bytes, path: str) -> None:
        bucket, key = split_bucket_key(path, "gs")
        url = (
            f"{self.endpoint_url}/upload/storage/v1/b/{bucket}/o"
            f"?uploadType=media&name={urllib.parse.quote(key, safe='')}"
        )
        headers = {"Content-Type": "application/octet-stream", **self._auth_headers()}
        status, body, _ = _http(urllib.request.Request(url, data=data, headers=headers, method="POST"))
        if status not in (200, 201):
            raise RemoteIOError(f"gs PUT {path}: HTTP {status}: {body[:200]!r}")

    def exists(self, path: str) -> bool:
        bucket, key = split_bucket_key(path, "gs")
        url = f"{self.endpoint_url}/storage/v1/b/{bucket}/o/{urllib.parse.quote(key, safe='')}"
        status, _, _ = _http(urllib.request.Request(url, headers=self._auth_headers()))
        return status == 200

    def list(self, prefix_path: str) -> Iterator[str]:
        bucket, prefix = split_bucket_key(prefix_path, "gs")
        page = None
        while True:
            q = {"prefix": prefix}
            if page:
                q["pageToken"] = page
            url = f"{self.endpoint_url}/storage/v1/b/{bucket}/o?{urllib.parse.urlencode(q)}"
            status, body, _ = _http(urllib.request.Request(url, headers=self._auth_headers()))
            if status != 200:
                raise RemoteIOError(f"gs LIST {prefix_path}: HTTP {status}: {body[:200]!r}")
            data = json.loads(body)
            for item in data.get("items", []):
                yield f"gs://{bucket}/{item['name']}"
            page = data.get("nextPageToken")
            if not page:
                return


class MSCBackend:
    """Multi-Storage Client backend (``msc://`` paths).

    Mirrors the reference's MSC easy_io backend
    (imaginaire/utils/easy_io/backends/msc_backend.py): a thin adapter over
    the ``multistorageclient`` package's ``StorageClient``, with the same
    URL-path translation semantics — URL file paths (``s3://bucket/key``)
    are rewritten through ``path_mapping`` (longest-prefix-first replace)
    into profile-relative paths, in which case the provider's base path
    must be empty.

    ``multistorageclient`` is not bundled; construction raises a clear
    RemoteIOError when it is missing (tests inject a fake client).
    """

    def __init__(
        self,
        config_path: Optional[str] = None,
        profile: str = "default",
        path_mapping: Optional[dict] = None,
        client=None,
    ):
        if client is None:
            try:
                from multistorageclient import StorageClient, StorageClientConfig
            except ImportError as e:  # pragma: no cover - env without MSC
                raise RemoteIOError(
                    "msc:// paths need the 'multistorageclient' package "
                    "(pip install multi-storage-client), or pass an explicit "
                    "client"
                ) from e
            client = StorageClient(
                config=StorageClientConfig.from_file(config_path=config_path, profile=profile)
                if config_path
                else StorageClientConfig.from_json(profile=profile)
            )
        self._client = client
        # longest prefix first so the most specific mapping wins
        self._path_mapping = dict(
            sorted((path_mapping or {}).items(), key=lambda kv: -len(kv[0]))
        )

    def _translate(self, path: str) -> str:
        if path.startswith("msc://"):
            path = path[len("msc://"):]
        for src, dst in self._path_mapping.items():
            if path.startswith(src):
                return dst + path[len(src):]
        return path

    def get(self, path: str) -> bytes:
        return self._client.read(path=self._translate(path))

    def put(self, data: bytes, path: str) -> None:
        self._client.write(path=self._translate(path), body=data)

    def exists(self, path: str) -> bool:
        p = self._translate(path)
        if self._client.is_file(path=p):
            return True
        return not self._client.is_empty(path=p)

    def remove(self, path: str) -> None:
        self._client.delete(path=self._translate(path), recursive=False)

    def list(self, prefix_path: str) -> Iterator[str]:
        for meta in self._client.list(
            path=self._translate(prefix_path), include_directories=False, include_url_prefix=False
        ):
            yield getattr(meta, "key", str(meta))
