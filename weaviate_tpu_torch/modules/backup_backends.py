"""Backup backend modules.

Reference: modules/backup-{filesystem,s3,gcs,azure} implementing
modulecapabilities.BackupBackend (entities/modulecapabilities/backup.go:
Initialize/PutObject/GetObject/HomeDir/...). The filesystem backend is
fully local (BACKUP_FILESYSTEM_PATH, modules/backup-filesystem/backend.go);
the cloud backends talk to object stores. Here, s3/gcs/azure speak the
shared minimal "HTTP object store" dialect (PUT/GET against an endpoint —
the shape a local minio/azurite/fake-gcs test container accepts) with
REAL cloud authentication layered on when credentials are configured:

- backup-s3:    AWS Signature V4 (AWS_ACCESS_KEY_ID/_SECRET_ACCESS_KEY,
                optional _SESSION_TOKEN; region from BACKUP_S3_REGION or
                AWS_REGION) — reference: modules/backup-s3 via minio-go.
- backup-gcs:   OAuth bearer token (GOOGLE_OAUTH_ACCESS_TOKEN or
                GCP_ACCESS_TOKEN) — reference: modules/backup-gcs.
- backup-azure: SAS token appended to every URL
                (AZURE_STORAGE_SAS_TOKEN) — reference: modules/backup-azure.

Unauthenticated endpoints (minio/azurite/fake-gcs in CI) keep working:
auth headers attach only when credentials are present.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request

from weaviate_tpu_torch.modules.base import BackupBackend, ModuleError


def sigv4_headers(method: str, url: str, region: str, service: str,
                  access_key: str, secret_key: str, payload_hash: str,
                  amz_date: str, session_token: str | None = None,
                  extra_headers: dict | None = None) -> dict:
    """AWS Signature Version 4 request headers (no SDK — ~80 lines of
    canonicalization + HMAC chain per the SigV4 spec). Deterministic given
    ``amz_date``; tests/test_backup.py pins AWS's published known-answer
    vector. Reference: modules/backup-s3 (minio-go signs the same way)."""
    parts = urllib.parse.urlsplit(url)
    host = parts.netloc
    canonical_uri = urllib.parse.quote(parts.path or "/", safe="/")
    q = urllib.parse.parse_qsl(parts.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(q))
    headers = {"host": host, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload_hash}
    if session_token:
        headers["x-amz-security-token"] = session_token
    for k, v in (extra_headers or {}).items():
        headers[k.lower()] = " ".join(str(v).split())
    signed = ";".join(sorted(headers))
    canonical_headers = "".join(
        f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join([
        method.upper(), canonical_uri, canonical_query,
        canonical_headers, signed, payload_hash])
    date = amz_date[:8]
    scope = f"{date}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(("AWS4" + secret_key).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    auth = (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={signature}")
    out = {k2: v for k2, v in headers.items() if k2 != "host"}
    out["Authorization"] = auth
    return out


def walk_files(root: str) -> list[str]:
    """Sorted relative paths of every file under ``root``."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            out.append(os.path.relpath(os.path.join(dirpath, fn), root))
    return sorted(out)


class FilesystemBackend(BackupBackend):
    """backup-filesystem: objects under <path>/<backup_id>/<key>."""

    name = "backup-filesystem"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.root = settings.get("path") or os.environ.get(
            "BACKUP_FILESYSTEM_PATH", "")

    def _require_root(self) -> str:
        if not self.root:
            raise ModuleError(
                "backup-filesystem needs a path (module setting 'path' or "
                "BACKUP_FILESYSTEM_PATH)")
        return self.root

    def initialize(self, backup_id: str) -> None:
        os.makedirs(os.path.join(self._require_root(), backup_id),
                    exist_ok=True)

    def put(self, backup_id: str, key: str, data: bytes) -> None:
        path = self._safe_path(backup_id, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def get(self, backup_id: str, key: str) -> bytes:
        path = self._safe_path(backup_id, key)
        if not os.path.exists(path):
            raise KeyError(f"{backup_id}/{key} not found")
        with open(path, "rb") as f:
            return f.read()

    def list(self, backup_id: str) -> list[str]:
        return walk_files(os.path.join(self._require_root(), backup_id))

    def put_file(self, backup_id: str, key: str, src_path: str) -> None:
        """Streamed variant: never materializes the file in memory."""
        import shutil

        dst = self._safe_path(backup_id, key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = f"{dst}.tmp"
        with open(src_path, "rb") as src, open(tmp, "wb") as out:
            shutil.copyfileobj(src, out, 1 << 20)
        os.replace(tmp, dst)

    def get_file(self, backup_id: str, key: str, dst_path: str) -> None:
        import shutil

        src = self._safe_path(backup_id, key)
        if not os.path.exists(src):
            raise KeyError(f"{backup_id}/{key} not found")
        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        with open(src, "rb") as f, open(dst_path, "wb") as out:
            shutil.copyfileobj(f, out, 1 << 20)

    def home_dir(self, backup_id: str) -> str:
        return os.path.join(self._require_root(), backup_id)

    def _safe_path(self, backup_id: str, key: str) -> str:
        # containment is anchored at the CONFIGURED root, so a traversal
        # backup_id ('..') can't move the anchor outside it
        base = os.path.abspath(self._require_root())
        root = os.path.abspath(os.path.join(base, backup_id))
        if not root.startswith(base + os.sep):
            raise ModuleError(f"backup id {backup_id!r} escapes the "
                              "backup root")
        path = os.path.abspath(os.path.join(root, key))
        if not path.startswith(root + os.sep) and path != root:
            raise ModuleError(f"backup key {key!r} escapes the backup root")
        return path


class _HttpObjectStoreBackend(BackupBackend):
    """Shared minimal HTTP object-store client for the cloud backends:
    PUT/GET <endpoint>/<container>/<backup_id>/<key>."""

    endpoint_setting = "endpoint"
    endpoint_env = ""
    container_setting = "bucket"
    container_env = ""
    default_container = "weaviate-backups"

    def init(self, settings: dict | None = None) -> None:
        settings = settings or {}
        self.endpoint = (settings.get(self.endpoint_setting)
                         or os.environ.get(self.endpoint_env, "")).rstrip("/")
        self.container = (settings.get(self.container_setting)
                          or os.environ.get(self.container_env, "")
                          or self.default_container)

    def _url(self, backup_id: str, key: str) -> str:
        if not self.endpoint:
            raise ModuleError(
                f"{self.name} needs an endpoint (module setting "
                f"{self.endpoint_setting!r} or {self.endpoint_env})")
        return f"{self.endpoint}/{self.container}/{backup_id}/{key}"

    def _auth_headers(self, method: str, url: str,
                      payload_hash: str) -> dict:
        """Per-backend request authentication; {} = anonymous (the
        minio/azurite/fake-gcs CI shape)."""
        return {}

    def _sign_url(self, url: str) -> str:
        """Per-backend URL decoration (Azure SAS)."""
        return url

    def initialize(self, backup_id: str) -> None:
        self._url(backup_id, "")  # endpoint check

    _EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()

    def put(self, backup_id: str, key: str, data: bytes) -> None:
        url = self._sign_url(self._url(backup_id, key))
        headers = self._auth_headers(
            "PUT", url, hashlib.sha256(data).hexdigest())
        req = urllib.request.Request(url, data=data, method="PUT",
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=60):
            pass

    def get(self, backup_id: str, key: str) -> bytes:
        url = self._sign_url(self._url(backup_id, key))
        req = urllib.request.Request(
            url, headers=self._auth_headers("GET", url, self._EMPTY_SHA256))
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise KeyError(f"{backup_id}/{key} not found")
            raise

    def put_file(self, backup_id: str, key: str, src_path: str) -> None:
        size = os.path.getsize(src_path)
        url = self._sign_url(self._url(backup_id, key))
        headers = {"Content-Length": str(size)}
        headers.update(self._auth_headers("PUT", url, "UNSIGNED-PAYLOAD"))
        with open(src_path, "rb") as f:
            req = urllib.request.Request(url, data=f, method="PUT",
                                         headers=headers)
            with urllib.request.urlopen(req, timeout=300):
                pass

    def get_file(self, backup_id: str, key: str, dst_path: str) -> None:
        import shutil

        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        url = self._sign_url(self._url(backup_id, key))
        req = urllib.request.Request(
            url, headers=self._auth_headers("GET", url, self._EMPTY_SHA256))
        try:
            with urllib.request.urlopen(req, timeout=300) as resp, \
                    open(dst_path, "wb") as out:
                shutil.copyfileobj(resp, out, 1 << 20)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise KeyError(f"{backup_id}/{key} not found")
            raise

    def list(self, backup_id: str) -> list[str]:
        raise ModuleError(f"{self.name} does not support listing without "
                          "cloud credentials")

    def home_dir(self, backup_id: str) -> str:
        return f"{self.endpoint}/{self.container}/{backup_id}" \
            if self.endpoint else ""


class S3Backend(_HttpObjectStoreBackend):
    name = "backup-s3"
    endpoint_env = "BACKUP_S3_ENDPOINT"
    container_env = "BACKUP_S3_BUCKET"

    def _auth_headers(self, method: str, url: str,
                      payload_hash: str) -> dict:
        access = os.environ.get("AWS_ACCESS_KEY_ID", "")
        secret = os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        if not access or not secret:
            return {}  # anonymous endpoint (minio CI shape)
        region = (os.environ.get("BACKUP_S3_REGION")
                  or os.environ.get("AWS_REGION") or "us-east-1")
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ")
        return sigv4_headers(
            method, url, region, "s3", access, secret, payload_hash,
            amz_date,
            session_token=os.environ.get("AWS_SESSION_TOKEN") or None)


class GCSBackend(_HttpObjectStoreBackend):
    name = "backup-gcs"
    endpoint_env = "BACKUP_GCS_ENDPOINT"
    container_env = "BACKUP_GCS_BUCKET"

    def _auth_headers(self, method: str, url: str,
                      payload_hash: str) -> dict:
        token = (os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
                 or os.environ.get("GCP_ACCESS_TOKEN"))
        return {"Authorization": f"Bearer {token}"} if token else {}


class AzureBackend(_HttpObjectStoreBackend):
    name = "backup-azure"
    endpoint_env = "BACKUP_AZURE_ENDPOINT"
    container_setting = "container"
    container_env = "BACKUP_AZURE_CONTAINER"

    def _auth_headers(self, method: str, url: str,
                      payload_hash: str) -> dict:
        # blob uploads need the blob type even for azurite
        return {"x-ms-blob-type": "BlockBlob"} if method == "PUT" else {}

    def _sign_url(self, url: str) -> str:
        sas = os.environ.get("AZURE_STORAGE_SAS_TOKEN", "").lstrip("?")
        if not sas:
            return url
        sep = "&" if "?" in url else "?"
        return f"{url}{sep}{sas}"
