"""V2 Open Inference protocol over a binary socket — the gRPC data plane
of the PyTorch port (counterpart of ``kubeflow_tpu.serving.v2_socket``:
the same frames byte for byte, so a client of either package talks to a
server of the other).

The reference serves V2 twice: REST and gRPC (KServe `python/kserve`,
SURVEY.md §2.4). This environment has no grpcio, so — recorded
substitution, same approach as ``hpo/service.py`` — the gRPC role runs
the SAME proto-shaped V2 messages (`model_infer`, `model_metadata`,
`server_ready`, repository load/unload) over length-prefixed JSON framing
on a raw TCP socket. The message *schema* is shared with the REST path
(`serving/protocol.py` InferRequest/InferResponse dicts mirror the V2
proto fields), so swapping the wire encoding for protobuf later touches
only the framing functions here.

Frame: 4-byte big-endian length + JSON body.
Request body: {"method": <name>, ...params}; response: result dict or
{"error": msg, "code": <http-ish status>}.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Optional

from kubeflow_tpu_torch.serving.model import (
    ModelMissing, ModelNotReady, ModelRepository,
)
from kubeflow_tpu_torch.serving.protocol import InferRequest, InferResponse


def _recv_msg(sock: socket.socket) -> Optional[bytes]:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _send_msg(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


class V2SocketServer:
    """Serves a ModelRepository over the socket protocol (gRPC-server role).

    Methods mirror the V2 gRPC service: ServerLive, ServerReady, ModelReady,
    ModelMetadata, ModelInfer, RepositoryModelLoad, RepositoryModelUnload.
    """

    def __init__(self, repository: ModelRepository,
                 host: str = "127.0.0.1", port: int = 0):
        self.repository = repository
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    raw = _recv_msg(self.request)
                    if raw is None:
                        return
                    try:
                        resp = outer._dispatch(json.loads(raw))
                    except ModelMissing as e:
                        resp = {"error": str(e), "code": 404}
                    except ModelNotReady as e:
                        resp = {"error": str(e), "code": 503}
                    except Exception as e:
                        resp = {"error": f"{type(e).__name__}: {e}",
                                "code": 500}
                    _send_msg(self.request, json.dumps(resp).encode())

        self._server = socketserver.ThreadingTCPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.address: tuple[str, int] = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def _dispatch(self, req: dict) -> dict:
        method = req.get("method")
        if method == "ServerLive":
            return {"live": True}
        if method == "ServerReady":
            return {"ready": self.repository.all_ready()}
        if method == "ModelReady":
            model = self.repository.get(req["model_name"])
            return {"name": model.name, "ready": model.ready}
        if method == "ModelMetadata":
            return self.repository.get(req["model_name"]).metadata()
        if method == "ModelInfer":
            model = self.repository.get(req["model_name"])
            infer_req = InferRequest.from_dict(req["model_name"],
                                               req["request"])
            return model(infer_req).to_dict()
        if method == "RepositoryModelLoad":
            self.repository.get(req["model_name"]).load()
            return {"name": req["model_name"], "ok": True}
        if method == "RepositoryModelUnload":
            self.repository.unload(req["model_name"])
            return {"name": req["model_name"], "ok": True}
        raise ValueError(f"unknown method {method!r}")

    def start(self) -> "V2SocketServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class V2SocketClient:
    """Client counterpart (gRPC-stub role); same call surface as the V2
    gRPC client stubs."""

    def __init__(self, address: tuple[str, int], timeout: float = 30.0):
        self._sock = socket.create_connection(address, timeout=timeout)
        self._lock = threading.Lock()

    def close(self) -> None:
        self._sock.close()

    def _call(self, method: str, **kwargs) -> dict:
        req = json.dumps({"method": method, **kwargs}).encode()
        with self._lock:
            _send_msg(self._sock, req)
            raw = _recv_msg(self._sock)
        if raw is None:
            raise ConnectionError("v2 socket server closed connection")
        resp = json.loads(raw)
        if "error" in resp:
            raise RuntimeError(f"[{resp.get('code', 500)}] {resp['error']}")
        return resp

    def server_live(self) -> bool:
        return bool(self._call("ServerLive")["live"])

    def server_ready(self) -> bool:
        return bool(self._call("ServerReady")["ready"])

    def model_ready(self, name: str) -> bool:
        return bool(self._call("ModelReady", model_name=name)["ready"])

    def model_metadata(self, name: str) -> dict:
        return self._call("ModelMetadata", model_name=name)

    def infer(self, request: InferRequest) -> InferResponse:
        out = self._call("ModelInfer", model_name=request.model_name,
                         request=request.to_dict())
        return InferResponse.from_dict(out)

    def load(self, name: str) -> dict:
        return self._call("RepositoryModelLoad", model_name=name)

    def unload(self, name: str) -> dict:
        return self._call("RepositoryModelUnload", model_name=name)
