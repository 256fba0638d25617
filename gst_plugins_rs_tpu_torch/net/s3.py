"""Minimal S3 REST client over SigV4 — GET / PUT / multipart upload.

Parity target: the reference's net/aws uses the AWS SDK (aws-sdk-s3);
this client owns the REST calls the elements need:

  GetObject (with Range), PutObject, CreateMultipartUpload, UploadPart,
  CompleteMultipartUpload, AbortMultipartUpload, HeadObject.

`endpoint-uri` works like the reference's property (net/aws/src/s3url.rs
/ s3sink endpoint-uri): point it at any S3-compatible server — tests run
against an in-process fake.
"""
from __future__ import annotations

import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree

from . import sigv4


def _backoff(attempt: int) -> None:
    """SDK-style capped exponential backoff between retries."""
    import time

    time.sleep(min(0.05 * (2 ** attempt), 1.0))


@dataclass
class S3Url:
    region: str
    bucket: str
    key: str

    @classmethod
    def parse(cls, uri: str) -> "S3Url":
        """s3://<region>/<bucket>/<key...> (the reference's s3url format)."""
        u = urllib.parse.urlsplit(uri)
        if u.scheme != "s3":
            raise ValueError(f"not an s3 uri: {uri}")
        path = u.path.lstrip("/")
        bucket, _, key = path.partition("/")
        if not (u.netloc and bucket and key):
            raise ValueError(f"s3 uri must be s3://region/bucket/key: {uri}")
        return cls(region=u.netloc, bucket=bucket, key=key)

    @classmethod
    def parse_s3uri(cls, uri: str, default_region: str = "us-east-1") -> "S3Url":
        """AWS-standard `s3://<bucket>/<key...>` (the reference s3-uri
        property format — region comes from the region property)."""
        u = urllib.parse.urlsplit(uri)
        if u.scheme != "s3":
            raise ValueError(f"not an s3 uri: {uri}")
        key = u.path.lstrip("/")
        if not (u.netloc and key):
            raise ValueError(f"s3-uri must be s3://bucket/key: {uri}")
        return cls(region=default_region, bucket=u.netloc, key=key)


class S3Client:
    def __init__(self, region: str, access_key: Optional[str], secret_key: Optional[str],
                 session_token: Optional[str] = None, endpoint_uri: Optional[str] = None,
                 force_path_style: bool = False, timeout_ms: int = 15_000,
                 retry_attempts: int = 5):
        self.region = region
        self.access_key = access_key or "anonymous"
        self.secret_key = secret_key or "anonymous"
        self.session_token = session_token
        self._custom_endpoint = endpoint_uri is not None
        self.endpoint_uri = (endpoint_uri or f"https://s3.{region}.amazonaws.com").rstrip("/")
        # virtual-hosted addressing only applies to the real AWS endpoint;
        # custom endpoints (tests, MinIO-alikes) are always path-style
        self.force_path_style = force_path_style or self._custom_endpoint
        self.timeout_ms = timeout_ms if timeout_ms and timeout_ms > 0 else None
        self.retry_attempts = max(1, int(retry_attempts))

    def _url(self, bucket: str, key: str, query: str = "") -> str:
        q = f"?{query}" if query else ""
        if self.force_path_style:
            return f"{self.endpoint_uri}/{bucket}/{urllib.parse.quote(key)}{q}"
        scheme, host = self.endpoint_uri.split("://", 1)
        return f"{scheme}://{bucket}.{host}/{urllib.parse.quote(key)}{q}"

    def _request(self, method: str, url: str, body: bytes = b"",
                 headers: Optional[Dict[str, str]] = None) -> Tuple[int, bytes, Dict[str, str]]:
        timeout = (self.timeout_ms / 1000.0) if self.timeout_ms else 300.0
        last_exc: Optional[BaseException] = None
        for attempt in range(self.retry_attempts):
            hdrs = sigv4.sign_headers(
                method, url, self.region, "s3",
                self.access_key, self.secret_key,
                headers=dict(headers or {}), payload=body, session_token=self.session_token,
            )
            req = urllib.request.Request(url, data=body if body else None, method=method)
            for k, v in hdrs.items():
                if k.lower() != "host":
                    req.add_header(k, v)
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return resp.status, resp.read(), dict(resp.headers)
            except urllib.error.HTTPError as e:
                if e.code >= 500 and attempt + 1 < self.retry_attempts:
                    _backoff(attempt)
                    continue  # server errors retry like the AWS SDK
                return e.code, e.read(), dict(e.headers)
            except OSError as e:  # connection/timeout errors retry
                last_exc = e
                if attempt + 1 < self.retry_attempts:
                    _backoff(attempt)
        raise IOError(f"S3 {method} {url}: retries exhausted") from last_exc

    # -- object ops -------------------------------------------------------------
    def get_object(self, bucket: str, key: str,
                   range_: Optional[Tuple[int, Optional[int]]] = None) -> bytes:
        headers = {}
        if range_ is not None:
            start, end = range_
            headers["range"] = f"bytes={start}-" + ("" if end is None else str(end))
        status, body, _ = self._request("GET", self._url(bucket, key), headers=headers)
        if status not in (200, 206):
            raise IOError(f"S3 GET {bucket}/{key} -> {status}: {body[:200]!r}")
        return body

    def head_object(self, bucket: str, key: str) -> int:
        status, body, headers = self._request("HEAD", self._url(bucket, key))
        if status != 200:
            raise IOError(f"S3 HEAD {bucket}/{key} -> {status}")
        return int(headers.get("Content-Length", headers.get("content-length", 0)))

    def put_object(self, bucket: str, key: str, data: bytes,
                   content_type: Optional[str] = None,
                   extra_headers: Optional[Dict[str, str]] = None) -> None:
        headers = {"content-type": content_type} if content_type else {}
        headers.update({k: v for k, v in (extra_headers or {}).items() if v})
        status, body, _ = self._request("PUT", self._url(bucket, key), body=data, headers=headers)
        if status != 200:
            raise IOError(f"S3 PUT {bucket}/{key} -> {status}: {body[:200]!r}")

    def delete_object(self, bucket: str, key: str) -> None:
        self._request("DELETE", self._url(bucket, key))

    # -- multipart ---------------------------------------------------------------
    def create_multipart(self, bucket: str, key: str,
                         content_type: Optional[str] = None,
                         extra_headers: Optional[Dict[str, str]] = None) -> str:
        headers = {"content-type": content_type} if content_type else {}
        headers.update({k: v for k, v in (extra_headers or {}).items() if v})
        status, body, _ = self._request("POST", self._url(bucket, key, "uploads"),
                                        headers=headers)
        if status != 200:
            raise IOError(f"S3 CreateMultipartUpload -> {status}")
        root = ElementTree.fromstring(body)
        upload_id = root.findtext(".//{*}UploadId") or root.findtext(".//UploadId")
        if not upload_id:
            raise IOError("S3 CreateMultipartUpload: no UploadId")
        return upload_id

    def upload_part(self, bucket: str, key: str, upload_id: str,
                    part_number: int, data: bytes) -> str:
        q = f"partNumber={part_number}&uploadId={urllib.parse.quote(upload_id)}"
        status, body, headers = self._request("PUT", self._url(bucket, key, q), body=data)
        if status != 200:
            raise IOError(f"S3 UploadPart {part_number} -> {status}")
        etag = headers.get("ETag", headers.get("etag", ""))
        return etag.strip('"')

    def complete_multipart(self, bucket: str, key: str, upload_id: str,
                           parts: List[Tuple[int, str]]) -> None:
        xml = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{etag}</ETag></Part>"
            for n, etag in sorted(parts)
        ) + "</CompleteMultipartUpload>"
        q = f"uploadId={urllib.parse.quote(upload_id)}"
        status, body, _ = self._request("POST", self._url(bucket, key, q), body=xml.encode())
        if status != 200:
            raise IOError(f"S3 CompleteMultipartUpload -> {status}")

    def abort_multipart(self, bucket: str, key: str, upload_id: str) -> None:
        q = f"uploadId={urllib.parse.quote(upload_id)}"
        self._request("DELETE", self._url(bucket, key, q))
