"""The port's V2 socket (``serving/v2_socket.py``) against the JAX
package's on the CPU: the frames are the same bytes, so a JAX client
talks to a port server and a port client to a JAX server; concurrent
clients; repository load and unload over the socket.
"""

import socket
import threading

import numpy as np
import pytest

from kubeflow_tpu.serving.model import Model as JModel
from kubeflow_tpu.serving.model import ModelRepository as JRepository
from kubeflow_tpu.serving.protocol import InferRequest as JRequest
from kubeflow_tpu.serving.protocol import InferResponse as JResponse
from kubeflow_tpu.serving.protocol import InferTensor as JTensor
from kubeflow_tpu.serving.v2_socket import V2SocketClient as JClient
from kubeflow_tpu.serving.v2_socket import V2SocketServer as JServer
from kubeflow_tpu.serving.v2_socket import _recv_msg as j_recv
from kubeflow_tpu.serving.v2_socket import _send_msg as j_send
from kubeflow_tpu_torch.serving import (
    InferRequest, InferResponse, InferTensor, Model, ModelRepository,
)
from kubeflow_tpu_torch.serving.v2_socket import (
    V2SocketClient, V2SocketServer, _recv_msg, _send_msg,
)


class Affine(Model):
    """y = 2x + 1."""

    def predict(self, request):
        return InferResponse.from_numpy(
            self.name, {"output-0": request.as_numpy() * 2.0 + 1.0},
            id=request.id)


class JAffine(JModel):
    def predict(self, request):
        return JResponse.from_numpy(
            self.name, {"output-0": request.as_numpy() * 2.0 + 1.0},
            id=request.id)


X = np.arange(6, dtype=np.float32).reshape(2, 3)


@pytest.fixture(params=["port server, jax client", "jax server, port client",
                        "port server, port client"])
def pair(request):
    """(server, client class, request class, tensor class) of one
    pairing; the served repository holds a loaded "affine"."""
    port_server = request.param.startswith("port")
    if port_server:
        repo = ModelRepository()
        repo.register(Affine("affine"))
        server = V2SocketServer(repo).start()
    else:
        repo = JRepository()
        repo.register(JAffine("affine"))
        server = JServer(repo).start()
    port_client = request.param.endswith("port client")
    kinds = ((V2SocketClient, InferRequest, InferTensor) if port_client
             else (JClient, JRequest, JTensor))
    yield server, *kinds
    server.stop()


def test_v2_socket_across_packages(pair):
    server, client_cls, req_cls, tensor_cls = pair
    client = client_cls(server.address)
    try:
        assert client.server_live() and client.server_ready()
        assert client.model_ready("affine")
        meta = client.model_metadata("affine")
        assert meta["name"] == "affine" and meta["versions"] == ["1"]
        out = client.infer(req_cls(model_name="affine", id="q-1", inputs=[
            tensor_cls.from_numpy("x", X)]))
        np.testing.assert_array_equal(out.as_numpy(), X * 2.0 + 1.0)
        assert out.id == "q-1" and out.model_name == "affine"
        with pytest.raises(RuntimeError, match=r"\[404\]"):
            client.model_ready("missing")
        client.unload("affine")
        with pytest.raises(RuntimeError, match=r"\[404\]"):
            client.infer(req_cls(model_name="affine", inputs=[
                tensor_cls.from_numpy("x", X)]))
        assert client.server_ready()             # an empty repository
    finally:
        client.close()


def test_v2_socket_frames_are_the_jax_frames():
    """The framing functions write and read the same bytes."""
    a, b = socket.socketpair()
    try:
        for send, recv in ((_send_msg, j_recv), (j_send, _recv_msg)):
            for payload in (b"", b'{"method": "ServerLive"}', bytes(70000)):
                send(a, payload)
                assert recv(b) == payload
        a.sendall(b"\x00\x00\x00\x05ab")
        a.close()
        assert _recv_msg(b) is None              # cut mid-frame
    finally:
        b.close()


def test_v2_socket_concurrent_clients():
    repo = ModelRepository()
    repo.register(Affine("affine"))
    server = V2SocketServer(repo).start()
    errors, outs = [], {}

    def run(i):
        client = V2SocketClient(server.address)
        try:
            for j in range(5):
                x = np.full((1, 4), float(10 * i + j), np.float32)
                out = client.infer(InferRequest(
                    model_name="affine", id=f"{i}-{j}",
                    inputs=[InferTensor.from_numpy("x", x)]))
                outs[(i, j)] = (out.id, float(out.as_numpy()[0, 0]))
        except Exception as e:          # surfaced below
            errors.append(repr(e))
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    server.stop()
    assert not errors
    assert outs == {(i, j): (f"{i}-{j}", 2.0 * (10 * i + j) + 1.0)
                    for i in range(8) for j in range(5)}


def test_v2_socket_load_and_unload():
    """RepositoryModelLoad re-loads a registered model; unload drops it."""
    repo = ModelRepository()
    model = Affine("affine")
    repo.register(model, load=False)
    server = V2SocketServer(repo).start()
    client = JClient(server.address)
    try:
        assert not client.model_ready("affine")
        assert not client.server_ready()
        with pytest.raises(RuntimeError, match=r"\[503\]"):
            client.infer(JRequest(model_name="affine", inputs=[
                JTensor.from_numpy("x", X)]))
        assert client.load("affine") == {"name": "affine", "ok": True}
        assert model.ready and client.model_ready("affine")
        assert client.unload("affine") == {"name": "affine", "ok": True}
        assert repo.names() == [] and not model.ready
        with pytest.raises(RuntimeError, match=r"\[404\]"):
            client.load("affine")
        with pytest.raises(RuntimeError, match=r"\[500\].*unknown method"):
            client._call("Nope")
    finally:
        client.close()
        server.stop()
