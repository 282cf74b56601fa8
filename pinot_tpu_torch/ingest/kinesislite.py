"""KinesisLite: the AWS Kinesis JSON API as a stream plugin, and a stub of it.

A copy of `pinot_tpu/ingest/kinesislite.py` (the analog of the reference's
Kinesis plugin, `pinot-plugins/pinot-stream-ingestion/pinot-kinesis/.../
KinesisConsumer.java` and `KinesisStreamMetadataProvider.java`): streams of
shards read through GetShardIterator and GetRecords. Both halves live here,
so that the stream SPI runs against Kinesis's wire shape: JSON POSTs with
the `X-Amz-Target: Kinesis_20131202.<Action>` header (CreateStream,
DescribeStream, PutRecord, PutRecords, GetShardIterator, GetRecords),
base64 record data, sequence numbers monotone a shard, `MillisBehindLatest`.

* `KinesisStub`: the API over a `ThreadingHTTPServer`; a record goes to the
  shard `crc32(partition key) % shards`; with an access key it verifies every
  request's SigV4 signature (`cluster/s3store.sigv4_verify`, service
  "kinesis"); `outage` makes it answer 503 (ServiceUnavailable). An error is
  AWS's envelope (`__type`, `message`).
* `KinesisClient`: signed calls (`s3store.sign_request`) when it has keys,
  over the pooled HTTP client; `KinesisError` carries the envelope's type.
* `KinesisConsumer`: one shard; the consumer's integer offsets are the
  sequence numbers (the stub issues them as decimal strings), an
  AT_SEQUENCE_NUMBER iterator anchors a fetch, and the NextShardIterator a
  GetRecords returned is reused while the next fetch starts where it points
  (one call a fetch in steady polling). It has no `latest_offset`: Kinesis
  has no latest-sequence query, so its lag reads as unknown.
* `KinesisFactory`, registered as stream type "kinesis"
  (`properties`: `endpoint`, and `accessKey`, `secretKey`, `region` for
  signed requests).

The requests and their signatures equal the JAX package's, and each
package's client works against the other's stub.
"""

from __future__ import annotations

import base64
import json
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from ..cluster.http_service import HttpError, _pooled_request
from ..cluster.s3store import sign_request, sigv4_verify
from .stream import (MessageBatch, PartitionGroupConsumer, StreamConsumerFactory,
                     StreamMessage, StreamMetadataProvider, register_stream_factory)

_TARGET_PREFIX = "Kinesis_20131202."


class KinesisError(RuntimeError):
    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}")
        self.code = code


class KinesisStub:
    """A Kinesis JSON endpoint: logs of shards with sequence numbers and
    shard iterators; SigV4 verification when keys are set; `outage`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, access_key: str = "",
                 secret_key: str = "", region: str = "us-east-1"):
        # stream -> its shards' logs of (sequence number, arrival ms, data, key)
        self._streams: Dict[str, List[List[Tuple[int, int, bytes, str]]]] = {}
        self._lock = threading.Lock()
        self.outage = False
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b"{}"
                target = self.headers.get("X-Amz-Target", "")
                try:
                    if stub.outage:
                        raise KinesisError("ServiceUnavailable", "outage")
                    if not stub._authorized(self.headers, body, self.path):
                        raise KinesisError("AccessDeniedException", "bad signature")
                    if not target.startswith(_TARGET_PREFIX):
                        raise KinesisError("UnknownOperationException", target)
                    out = stub._dispatch(target[len(_TARGET_PREFIX):], json.loads(body.decode()))
                    payload, status = json.dumps(out).encode(), 200
                except KinesisError as e:
                    payload = json.dumps({"__type": e.code, "message": str(e)}).encode()
                    status = 503 if e.code == "ServiceUnavailable" else 400
                except Exception as e:   # a malformed request: AWS's ValidationException
                    payload = json.dumps({"__type": "ValidationException",
                                          "message": f"{type(e).__name__}: {e}"}).encode()
                    status = 400
                self.send_response(status)
                self.send_header("Content-Type", "application/x-amz-json-1.1")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        class _Server(ThreadingHTTPServer):
            request_queue_size = 64

        self._server = _Server((host, port), Handler)
        self._server.daemon_threads = True
        self.url = f"http://{host}:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                        name="kinesis-stub")
        self._thread.start()

    def _authorized(self, headers, body: bytes, path: str) -> bool:
        if not self.access_key:
            return True
        return sigv4_verify(headers, "POST", path, "", body, self.access_key,
                            self.secret_key, self.region, service="kinesis")

    def _shards(self, stream: str):
        shards = self._streams.get(stream)
        if shards is None:
            raise KinesisError("ResourceNotFoundException", stream)
        return shards

    def _dispatch(self, action: str, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if action == "CreateStream":
                if req["StreamName"] not in self._streams:
                    self._streams[req["StreamName"]] = [
                        [] for _ in range(int(req.get("ShardCount", 1)))]
                return {}
            if action == "DescribeStream":
                shards = self._shards(req["StreamName"])
                return {"StreamDescription": {
                    "StreamName": req["StreamName"], "StreamStatus": "ACTIVE",
                    "Shards": [{"ShardId": f"shardId-{i:012d}"} for i in range(len(shards))]}}
            if action == "PutRecord":
                return self._put_one(self._shards(req["StreamName"]), req["Data"],
                                     req["PartitionKey"])
            if action == "PutRecords":
                shards = self._shards(req["StreamName"])
                return {"FailedRecordCount": 0,
                        "Records": [self._put_one(shards, r["Data"], r["PartitionKey"])
                                    for r in req["Records"]]}
            if action == "GetShardIterator":
                return self._iterator(req)
            if action == "GetRecords":
                return self._get_records(req)
        raise KinesisError("UnknownOperationException", action)

    @staticmethod
    def _put_one(shards, data_b64: str, pk: str) -> Dict[str, Any]:
        idx = zlib.crc32(pk.encode()) % len(shards)
        log = shards[idx]
        seq = len(log)
        log.append((seq, int(time.time() * 1000), base64.b64decode(data_b64), pk))
        return {"ShardId": f"shardId-{idx:012d}", "SequenceNumber": str(seq)}

    def _iterator(self, req: Dict[str, Any]) -> Dict[str, Any]:
        shards = self._shards(req["StreamName"])
        idx = int(req["ShardId"].rsplit("-", 1)[-1])
        if not 0 <= idx < len(shards):
            raise KinesisError("ResourceNotFoundException", req["ShardId"])
        it_type = req["ShardIteratorType"]
        if it_type == "TRIM_HORIZON":
            seq = 0
        elif it_type == "LATEST":
            seq = len(shards[idx])
        elif it_type in ("AT_SEQUENCE_NUMBER", "AFTER_SEQUENCE_NUMBER"):
            seq = int(req["StartingSequenceNumber"]) + (it_type == "AFTER_SEQUENCE_NUMBER")
        else:
            raise KinesisError("InvalidArgumentException", it_type)
        return {"ShardIterator": json.dumps({"s": req["StreamName"], "i": idx, "q": seq})}

    def _get_records(self, req: Dict[str, Any]) -> Dict[str, Any]:
        it = json.loads(req["ShardIterator"])
        log = self._shards(it["s"])[it["i"]]
        seq = it["q"]
        out = [{"SequenceNumber": str(rec_seq), "ApproximateArrivalTimestamp": ts / 1000.0,
                "Data": base64.b64encode(data).decode(), "PartitionKey": pk}
               for rec_seq, ts, data, pk in log[seq:seq + int(req.get("Limit", 10000))]]
        nxt = seq + len(out)
        return {"Records": out,
                "NextShardIterator": json.dumps({"s": it["s"], "i": it["i"], "q": nxt}),
                # a millisecond a record behind, as a proxy of the real API's
                "MillisBehindLatest": (len(log) - nxt) * 1000}

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


class KinesisClient:
    """The JSON API's client (the AWS SDK's role), signed when it has keys."""

    def __init__(self, endpoint: str, access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1", timeout_s: float = 30.0):
        self.endpoint = endpoint.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout_s = timeout_s

    def call(self, action: str, req: Dict[str, Any]) -> Dict[str, Any]:
        body = json.dumps(req).encode()
        headers = {"Content-Type": "application/x-amz-json-1.1",
                   "X-Amz-Target": _TARGET_PREFIX + action}
        if self.access_key:
            headers.update(sign_request("POST", self.endpoint + "/", body, self.access_key,
                                        self.secret_key, self.region, service="kinesis"))
        # the pooled keep-alive client: the consumers poll this in their loop
        try:
            data = _pooled_request("POST", self.endpoint + "/", body, headers, self.timeout_s)
        except HttpError as e:
            msg = str(e).split(": ", 1)[-1]
            try:
                d = json.loads(msg or "{}")
            except ValueError:
                d = {}
            raise KinesisError(d.get("__type", f"HTTP{e.status}"), d.get("message", "")) \
                from None
        return json.loads(data.decode())

    def create_stream(self, name: str, shards: int) -> None:
        self.call("CreateStream", {"StreamName": name, "ShardCount": shards})

    def put_record(self, stream: str, data, partition_key: str) -> Dict:
        raw = data if isinstance(data, bytes) else str(data).encode()
        return self.call("PutRecord", {"StreamName": stream, "PartitionKey": partition_key,
                                       "Data": base64.b64encode(raw).decode()})

    def put_records(self, stream: str, items) -> Dict:
        """`items`: (partition key, data) pairs, one PutRecords call."""
        recs = [{"PartitionKey": pk,
                 "Data": base64.b64encode(d if isinstance(d, bytes) else str(d).encode()).decode()}
                for pk, d in items]
        return self.call("PutRecords", {"StreamName": stream, "Records": recs})

    def shard_count(self, stream: str) -> int:
        d = self.call("DescribeStream", {"StreamName": stream})
        return len(d["StreamDescription"]["Shards"])


class KinesisConsumer(PartitionGroupConsumer):
    """One shard; the integer offsets are its sequence numbers (the
    reference's KinesisConsumer.getRecords and its checkpointed offsets)."""

    def __init__(self, client: KinesisClient, stream: str, shard: int):
        self.client = client
        self.stream = stream
        self.shard = shard
        # (the offset it starts at, the NextShardIterator of the last
        # GetRecords): reused while fetches go on in order (real Kinesis
        # throttles GetShardIterator at 5 a second a shard)
        self._cached: Optional[Tuple[int, str]] = None

    def _iterator(self, seq: int) -> str:
        if self._cached is not None and self._cached[0] == seq:
            return self._cached[1]
        return self.client.call("GetShardIterator", {
            "StreamName": self.stream, "ShardId": f"shardId-{self.shard:012d}",
            "ShardIteratorType": "AT_SEQUENCE_NUMBER",
            "StartingSequenceNumber": str(seq)})["ShardIterator"]

    def fetch(self, start_offset: int, max_messages: int, timeout_ms: int = 0) -> MessageBatch:
        d = self.client.call("GetRecords", {"ShardIterator": self._iterator(start_offset),
                                            "Limit": max_messages})
        msgs = [StreamMessage(
            value=base64.b64decode(r["Data"]).decode("utf-8", "surrogateescape"),
            offset=int(r["SequenceNumber"]), key=r.get("PartitionKey"),
            timestamp_ms=int(r.get("ApproximateArrivalTimestamp", 0) * 1000))
            for r in d.get("Records", [])]
        next_offset = msgs[-1].offset + 1 if msgs else start_offset
        nxt = d.get("NextShardIterator")
        self._cached = (next_offset, nxt) if nxt else None
        return MessageBatch(msgs, next_offset)

    # no latest_offset: Kinesis has no latest-sequence query, and the
    # NextShardIterator is opaque


class KinesisFactory(StreamConsumerFactory):
    """Stream type "kinesis"; `properties`: endpoint, and accessKey,
    secretKey, region for signed requests."""

    def __init__(self, topic: str, properties: Optional[Dict[str, Any]] = None):
        props = properties or {}
        self.topic = topic
        self.client = KinesisClient(props.get("endpoint", ""),
                                    access_key=props.get("accessKey", ""),
                                    secret_key=props.get("secretKey", ""),
                                    region=props.get("region", "us-east-1"))

    def create_consumer(self, topic: str, partition: int) -> PartitionGroupConsumer:
        return KinesisConsumer(self.client, topic or self.topic, partition)

    def metadata_provider(self) -> StreamMetadataProvider:
        factory = self

        class _Meta(StreamMetadataProvider):
            def partition_count(self, topic: str) -> int:
                return factory.client.shard_count(topic or factory.topic)

        return _Meta()


register_stream_factory("kinesis", KinesisFactory)
