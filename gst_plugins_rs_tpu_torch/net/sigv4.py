"""AWS Signature Version 4 signing (headers + presigned query strings).

Parity target: the reference's aws plugin and aws_kvs_signaller rely on
the AWS SDK's SigV4 implementation (net/aws, net/webrtc/src/
aws_kvs_signaller/imp.rs builds a presigned wss:// URL); this module owns
the algorithm.  Validated against the signing-key derivation example from
the AWS documentation.
"""
from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
from typing import Dict, Mapping, Optional, Tuple

ALGORITHM = "AWS4-HMAC-SHA256"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret_key: str, date: str, region: str, service: str) -> bytes:
    """kSigning = HMAC(HMAC(HMAC(HMAC("AWS4"+secret, date), region), service), "aws4_request")."""
    k = _hmac(("AWS4" + secret_key).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(params: Mapping[str, str]) -> str:
    pairs = sorted((_uri_encode(k), _uri_encode(str(v))) for k, v in params.items())
    return "&".join(f"{k}={v}" for k, v in pairs)


def canonical_request(method: str, path: str, query: Mapping[str, str],
                      headers: Mapping[str, str], payload_hash: str) -> Tuple[str, str]:
    canon_headers = sorted((k.lower().strip(), " ".join(str(v).split()))
                           for k, v in headers.items())
    signed_headers = ";".join(k for k, _ in canon_headers)
    creq = "\n".join([
        method.upper(),
        _uri_encode(path, encode_slash=False) or "/",
        canonical_query(query),
        "".join(f"{k}:{v}\n" for k, v in canon_headers),
        signed_headers,
        payload_hash,
    ])
    return creq, signed_headers


def string_to_sign(amz_date: str, scope: str, creq: str) -> str:
    return "\n".join([ALGORITHM, amz_date, scope, hashlib.sha256(creq.encode()).hexdigest()])


def sign_headers(method: str, url: str, region: str, service: str,
                 access_key: str, secret_key: str,
                 headers: Optional[Dict[str, str]] = None,
                 payload: bytes = b"",
                 session_token: Optional[str] = None,
                 now: Optional[datetime.datetime] = None) -> Dict[str, str]:
    """Returns headers including Authorization for a signed request."""
    u = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    hdrs = dict(headers or {})
    hdrs.setdefault("host", u.netloc)
    hdrs["x-amz-date"] = amz_date
    if session_token:
        hdrs["x-amz-security-token"] = session_token
    payload_hash = hashlib.sha256(payload).hexdigest()
    hdrs["x-amz-content-sha256"] = payload_hash
    query = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
    creq, signed = canonical_request(method, u.path or "/", query, hdrs, payload_hash)
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = string_to_sign(amz_date, scope, creq)
    sig = hmac.new(signing_key(secret_key, date, region, service),
                   sts.encode(), hashlib.sha256).hexdigest()
    hdrs["Authorization"] = (
        f"{ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}"
    )
    return hdrs


def presign_url(method: str, url: str, region: str, service: str,
                access_key: str, secret_key: str,
                session_token: Optional[str] = None,
                expires: int = 299,
                extra_params: Optional[Mapping[str, str]] = None,
                now: Optional[datetime.datetime] = None) -> str:
    """Presigned URL (query-string auth) — the KVS wss:// connect form
    (aws_kvs_signaller/imp.rs:378-379 builds exactly this)."""
    u = urllib.parse.urlsplit(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    scope = f"{date}/{region}/{service}/aws4_request"
    params = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
    params.update(extra_params or {})
    params["X-Amz-Algorithm"] = ALGORITHM
    params["X-Amz-Credential"] = f"{access_key}/{scope}"
    params["X-Amz-Date"] = amz_date
    params["X-Amz-Expires"] = str(expires)
    params["X-Amz-SignedHeaders"] = "host"
    if session_token:
        params["X-Amz-Security-Token"] = session_token
    headers = {"host": u.netloc}
    creq, _ = canonical_request(method, u.path or "/", params, headers, "UNSIGNED-PAYLOAD")
    sts = string_to_sign(amz_date, scope, creq)
    sig = hmac.new(signing_key(secret_key, date, region, service),
                   sts.encode(), hashlib.sha256).hexdigest()
    params["X-Amz-Signature"] = sig
    return urllib.parse.urlunsplit(
        (u.scheme, u.netloc, u.path or "/", canonical_query(params), "")
    )


def verify_presigned(url: str, secret_key: str) -> bool:
    """Check a presigned URL's signature (used by test fake servers)."""
    u = urllib.parse.urlsplit(url)
    params = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
    sig = params.pop("X-Amz-Signature", None)
    if sig is None:
        return False
    cred = params.get("X-Amz-Credential", "")
    try:
        _, date, region, service, _ = cred.split("/")
    except ValueError:
        return False
    headers = {"host": u.netloc}
    creq, _ = canonical_request("GET", u.path or "/", params, headers, "UNSIGNED-PAYLOAD")
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = string_to_sign(params.get("X-Amz-Date", ""), scope, creq)
    expect = hmac.new(signing_key(secret_key, date, region, service),
                      sts.encode(), hashlib.sha256).hexdigest()
    return hmac.compare_digest(expect, sig)
