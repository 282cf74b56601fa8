"""AWS Signature Version 4: request signing and its verification.

A copy of the signing half of `pinot_tpu/cluster/s3store.py` (the public
SigV4 spec, the subset object stores and the Kinesis JSON API need): the
canonical request over a fixed signed-header set (`host`,
`x-amz-content-sha256`, `x-amz-date`), the string to sign, the derived key's
signature, `sign_request` (the headers of a signed request) and
`sigv4_verify` (a stub's check of them). `ingest/kinesislite.py` signs its
client's requests and verifies them in its stub through these; the headers
equal the JAX package's for the same request, date and keys.

Not ported: the S3 wire deep store itself (`S3DeepStoreFS`) and its stub
server (`S3StubServer`), which wait in ROADMAP.md queue 1 item 3.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
from typing import Dict, Optional, Tuple


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_signature(secret_key: str, region: str, amz_date: str,
                    string_to_sign: str, service: str = "s3") -> str:
    """The hex signature of `string_to_sign` under the key derived from
    the secret, the date, the region and the service."""
    k = _hmac(("AWS4" + secret_key).encode(), amz_date[:8])
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    return hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()


def sigv4_canonical(method: str, path: str, query: str, host: str,
                    amz_date: str, payload_sha: str) -> Tuple[str, str]:
    """(canonical request, signed headers). `path` is the request path as
    sent (already percent-encoded) and is used as it is: quoting it again
    would sign '%2520' for a space and fail against a real service."""
    cq = "&".join(sorted(
        f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
        for k, v in urllib.parse.parse_qsl(query, keep_blank_values=True)))
    signed = "host;x-amz-content-sha256;x-amz-date"
    canonical = "\n".join([
        method,
        path,
        cq,
        f"host:{host}\nx-amz-content-sha256:{payload_sha}\nx-amz-date:{amz_date}\n",
        signed,
        payload_sha,
    ])
    return canonical, signed


def sigv4_string_to_sign(canonical: str, amz_date: str, region: str,
                         service: str = "s3") -> str:
    scope = f"{amz_date[:8]}/{region}/{service}/aws4_request"
    return "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                      hashlib.sha256(canonical.encode()).hexdigest()])


def sign_request(method: str, url: str, payload: bytes, access_key: str,
                 secret_key: str, region: str, amz_date: Optional[str] = None,
                 payload_sha: Optional[str] = None,
                 service: str = "s3") -> Dict[str, str]:
    """The headers of a SigV4-signed request (the Authorization header
    form). `amz_date` defaults to now (UTC); `payload_sha` lets a caller
    hash a streamed body itself."""
    parsed = urllib.parse.urlparse(url)
    if amz_date is None:
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    if payload_sha is None:
        payload_sha = hashlib.sha256(payload or b"").hexdigest()
    canonical, signed = sigv4_canonical(method, parsed.path, parsed.query, parsed.netloc,
                                        amz_date, payload_sha)
    sts = sigv4_string_to_sign(canonical, amz_date, region, service)
    sig = sigv4_signature(secret_key, region, amz_date, sts, service)
    scope = f"{amz_date[:8]}/{region}/{service}/aws4_request"
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_sha,
        "Authorization": (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
                          f"SignedHeaders={signed}, Signature={sig}"),
    }


def sigv4_verify(headers, method: str, path: str, query: str, body: bytes,
                 access_key: str, secret_key: str, region: str,
                 service: str = "s3") -> bool:
    """A stub's check of a signed request: the body's hash as signed, the
    credential's access key, and the signature."""
    auth = headers.get("Authorization", "")
    amz_date = headers.get("x-amz-date", "")
    sha = headers.get("x-amz-content-sha256", "")
    if not auth.startswith("AWS4-HMAC-SHA256") or not amz_date:
        return False
    if hashlib.sha256(body).hexdigest() != sha:
        return False
    canonical, _ = sigv4_canonical(method, path, query, headers.get("Host", ""), amz_date, sha)
    sts = sigv4_string_to_sign(canonical, amz_date, region, service)
    want = sigv4_signature(secret_key, region, amz_date, sts, service)
    got = auth.rsplit("Signature=", 1)[-1].strip()
    cred = auth.split("Credential=", 1)[-1].split("/", 1)[0]
    return cred == access_key and hmac.compare_digest(want, got)
