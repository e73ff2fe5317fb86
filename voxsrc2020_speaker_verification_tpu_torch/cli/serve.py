"""Embedding/verification server over an inference artifact.

    python -m voxsrc2020_speaker_verification_tpu_torch.cli.serve \
        --artifact exp/.../artifact --host 0.0.0.0 --port 7512

Concurrent connections share one eval/serving.py EmbeddingService, whose
batcher packs requests into the same bucket shapes offline extraction uses.
The service runs on the GPU (``--device``, default ``cuda``).

Wire protocol (length-delimited JSON header + raw little-endian payload;
every request gets exactly one response):

    -> {"op": "embed", "kind": "wave",  "n": N}\n           + int16[N]
    -> {"op": "embed", "kind": "feats", "t": T, "f": F}\n   + float32[T*F]
    <- {"ok": true, "d": D}\n                               + float32[D]

    -> {"op": "score", "d": D, "asnorm": false}\n           + float32[2*D]
    <- {"ok": true, "score": S}\n

    -> {"op": "ping"}\n
    <- {"ok": true, "model": ..., "feat_dim": ..., "batch_size": ...}\n

    <- {"ok": false, "error": "..."}\n   on any failure.  The connection
       stays up EXCEPT when the declared payload size itself is invalid
       (oversized n/t/f/d or unknown embed kind): the stream position is
       then unknowable, so the server replies and closes.
"""

from __future__ import annotations

import argparse
import json
import socket
import socketserver
import struct
from typing import Optional, Tuple

import numpy as np

_MAX_HEADER = 4096
_MAX_PAYLOAD = 512 << 20  # 512 MB ~= 4.7 h of float32 80-d features


class _FatalProtocolError(ValueError):
    """Request whose payload size cannot be trusted: the stream position is
    unknowable, so the only safe reply is error-then-close (reading on
    would parse payload bytes as the next header)."""


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise EOFError("connection closed mid-payload")
        buf += chunk
    return buf


def _read_header(rfile) -> Optional[dict]:
    line = rfile.readline(_MAX_HEADER)
    if not line:
        return None  # clean EOF between requests
    if not line.endswith(b"\n"):
        raise ValueError("header too long or truncated")
    return json.loads(line)


def _send(wfile, header: dict, payload: bytes = b"") -> None:
    wfile.write(json.dumps(header).encode() + b"\n" + payload)
    wfile.flush()


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        service = self.server.service  # type: ignore[attr-defined]
        while True:
            try:
                req = _read_header(self.rfile)
            except (EOFError, ValueError, json.JSONDecodeError):
                return
            if req is None:
                return
            fatal = False
            try:
                resp, payload = self._dispatch(service, req)
            except (EOFError, BrokenPipeError, ConnectionResetError):
                return
            except _FatalProtocolError as e:  # report, then close
                resp, payload, fatal = {"ok": False, "error": str(e)}, b"", True
            except Exception as e:  # report, keep the connection
                # _dispatch consumed the payload before validating, so the
                # stream is positioned at the next header
                resp, payload = {"ok": False, "error": str(e)}, b""
            try:
                _send(self.wfile, resp, payload)
            except (BrokenPipeError, ConnectionResetError):
                return
            if fatal:
                return

    def _dispatch(self, service, req) -> Tuple[dict, bytes]:
        op = req.get("op")
        if op == "ping":
            return {
                "ok": True,
                "model": service.config.model,
                "feat_dim": service.config.feat_dim,
                "batch_size": service.batch_size,
            }, b""
        # Every branch READS its declared payload before validating content:
        # a reply without consuming the payload would leave those bytes to
        # be parsed as the next request's header.  Only size/shape fields
        # that make the payload length itself untrustworthy are fatal.
        if op == "embed":
            kind = req.get("kind", "feats")
            if kind == "wave":
                n = int(req["n"])
                if not 0 < n * 2 <= _MAX_PAYLOAD:
                    raise _FatalProtocolError(f"bad wave length {n}")
                wave = np.frombuffer(
                    _read_exact(self.rfile, n * 2), "<i2").astype(np.float32)
                emb = service.embed_wave(wave, cmvn=req.get("cmvn", True))
            elif kind == "feats":
                t, f = int(req["t"]), int(req["f"])
                if not 0 < t * f * 4 <= _MAX_PAYLOAD:
                    raise _FatalProtocolError(f"bad feature shape ({t}, {f})")
                feats = np.frombuffer(
                    _read_exact(self.rfile, t * f * 4), "<f4").reshape(t, f)
                emb = service.embed_features(feats, cmvn=req.get("cmvn", True))
            else:
                raise _FatalProtocolError(f"unknown embed kind {kind!r}")
            payload = np.ascontiguousarray(emb, "<f4").tobytes()
            return {"ok": True, "d": len(emb)}, payload
        if op == "score":
            d = int(req["d"])
            if not 0 < d * 8 <= _MAX_PAYLOAD:
                raise _FatalProtocolError(f"bad embedding dim {d}")
            buf = np.frombuffer(_read_exact(self.rfile, d * 8), "<f4")
            s = service.score(buf[:d], buf[d:],
                              asnorm=bool(req.get("asnorm", False)),
                              topk=int(req.get("topk", 400)))
            return {"ok": True, "score": s}, b""
        raise ValueError(f"unknown op {op!r}")


class EmbeddingServer(socketserver.ThreadingTCPServer):
    """One EmbeddingService shared by all connections; requests from every
    connection batch together on the service's single device thread."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address):
        super().__init__(address, _Handler)
        self.service = None  # attached by make_server after a clean bind


def make_server(artifact: str, host: str = "127.0.0.1", port: int = 0,
                **service_kwargs) -> EmbeddingServer:
    """Build (but do not run) a server; ``server.server_address`` carries the
    bound (host, port) -- port 0 picks an ephemeral one.  Binds BEFORE
    loading the model: a bind failure (port in use) must not leak a live
    batcher thread + device-resident weights.  ``service_kwargs`` go to
    EmbeddingService (``device`` among them)."""
    from ..eval.serving import EmbeddingService

    server = EmbeddingServer((host, port))
    try:
        server.service = EmbeddingService(artifact, **service_kwargs)
    except BaseException:
        server.server_close()
        raise
    return server


class ServingClient:
    """Minimal blocking client for the wire protocol above."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._rfile = self._sock.makefile("rb")

    def _call(self, header: dict, payload: bytes = b"") -> Tuple[dict, bytes]:
        self._sock.sendall(json.dumps(header).encode() + b"\n" + payload)
        resp = _read_header(self._rfile)
        if resp is None:
            raise EOFError("server closed connection")
        if not resp.get("ok"):
            raise RuntimeError(resp.get("error", "server error"))
        body = b""
        if "d" in resp and header.get("op") == "embed":
            body = _read_exact(self._rfile, int(resp["d"]) * 4)
        return resp, body

    def ping(self) -> dict:
        return self._call({"op": "ping"})[0]

    def embed_wave(self, wave: np.ndarray, cmvn: bool = True) -> np.ndarray:
        pcm = np.clip(np.rint(np.asarray(wave, np.float64)),
                      -32768, 32767).astype("<i2")
        resp, body = self._call(
            {"op": "embed", "kind": "wave", "n": len(pcm), "cmvn": cmvn},
            pcm.tobytes())
        return np.frombuffer(body, "<f4").copy()

    def embed_features(self, feats: np.ndarray, cmvn: bool = True) -> np.ndarray:
        f = np.ascontiguousarray(feats, "<f4")
        resp, body = self._call(
            {"op": "embed", "kind": "feats", "t": f.shape[0], "f": f.shape[1],
             "cmvn": cmvn}, f.tobytes())
        return np.frombuffer(body, "<f4").copy()

    def score(self, emb_a: np.ndarray, emb_b: np.ndarray,
              asnorm: bool = False, topk: int = 400) -> float:
        a = np.ascontiguousarray(emb_a, "<f4")
        b = np.ascontiguousarray(emb_b, "<f4")
        assert a.shape == b.shape and a.ndim == 1
        resp, _ = self._call(
            {"op": "score", "d": len(a), "asnorm": asnorm, "topk": topk},
            a.tobytes() + b.tobytes())
        return float(resp["score"])

    def close(self):
        try:
            self._rfile.close()
        finally:
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", required=True,
                   help="inference artifact dir (cli.export output)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7512)
    p.add_argument("--batch-size", type=int, default=None,
                   help="bucket batch (default: per model class, "
                        "eval/extract.py:default_batch_size)")
    p.add_argument("--max-wait-ms", type=float, default=10.0,
                   help="max time a lone request waits for batch-mates")
    p.add_argument("--cmn-window", type=int, default=300)
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every bucket shape (and building the "
                        "CUDA kernels) before announcing readiness")
    p.add_argument("--wire", choices=("float32", "bfloat16"),
                   default="float32",
                   help="host->device feature wire per flush; bfloat16 "
                        "halves the transfer (equal for bf16-compute "
                        "models)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    server = make_server(
        args.artifact, args.host, args.port,
        batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        cmn_window=args.cmn_window, wire=args.wire, device=args.device)
    host, port = server.server_address[:2]
    if not args.no_warmup:
        print("warming up (every bucket shape, kernel builds)...", flush=True)
        server.service.warmup()
    print(f"serving {args.artifact} on {host}:{port} "
          f"(model {server.service.config.model}, "
          f"batch {server.service.batch_size})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.service.close()


if __name__ == "__main__":
    main()
