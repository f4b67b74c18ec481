"""The port's function models and predictor (``models/mnist.py``,
``models/resnet.py``, ``serving.torch_model.TorchModel``) against the JAX
package's on the CPU, on the same weights (``interop.mnist_from_jax`` /
``resnet_from_jax``) and the same numpy-seeded inputs.

Tolerances, each over the largest magnitude of the JAX output: MNIST
1e-5 (f32); ResNet in f32 1e-5 on logits and new batch statistics (a
few convolutions and reductions summed in another order; read 2e-7 to
5e-7); ResNet in bf16 an rms error of 1e-3 of the JAX logits' rms (each
side computes in f32 and rounds every activation to bf16 at the same
points; read 1.5e-7 to 1.7e-7). The nearest fault, XLA's asymmetric
"SAME" pads replaced by PyTorch's symmetric ``k // 2``, must read above
that bf16 limit where the pads differ (32 x 32 inputs: every stride-2
window; read 0.20; at 34 x 34 only the stem's, 0.099) and the same as
the sound code where they do not (33 x 33: every pad is symmetric).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import mnist as j_mnist
from kubeflow_tpu.models import resnet as j_resnet
from kubeflow_tpu.serving.jax_model import JAXModel
from kubeflow_tpu.training.data import mnist_synthetic as j_mnist_synthetic
from kubeflow_tpu_torch import interop
from kubeflow_tpu_torch.models import mnist, resnet
from kubeflow_tpu_torch.serving import InferRequest, InferTensor, TorchModel
from kubeflow_tpu_torch.training.data import mnist_synthetic

MNIST_RTOL = 1e-5
RESNET_F32_RTOL = 1e-5
RESNET_BF16_RMS = 1e-3


def _np(x):
    return np.asarray(x, np.float32)


def _rel_max(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_rms(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_mnist_synthetic_draws_match_jax():
    for ours, theirs, _ in zip(mnist_synthetic(5, seed=3),
                               j_mnist_synthetic(5, seed=3), range(3)):
        np.testing.assert_array_equal(ours["image"], theirs["image"])
        np.testing.assert_array_equal(ours["label"], theirs["label"])


def test_mnist_forward_matches_jax():
    jp = j_mnist.init_params(jax.random.key(0))
    images = next(mnist_synthetic(6, seed=1))["image"]
    want = j_mnist.forward(jp, jnp.asarray(images))
    tp = interop.mnist_from_jax(jax.device_get(jp), device="cpu")
    assert tuple(tp["conv2"].shape) == (64, 32, 3, 3)     # OIHW
    got = mnist.forward(tp, torch.from_numpy(images))
    assert got.shape == (6, 10)
    assert _rel_max(got, want) <= MNIST_RTOL


def test_mnist_init_params_shapes_and_scale():
    p = mnist.init_params(torch.Generator().manual_seed(0), device="cpu")
    jp = j_mnist.init_params(jax.random.key(0))
    conv = {"conv1", "conv2"}
    for k, v in jp.items():
        shape = (tuple(np.transpose(np.zeros(v.shape), (3, 2, 0, 1)).shape)
                 if k in conv else v.shape)
        assert tuple(p[k].shape) == shape and p[k].dtype == torch.float32
    # He-normal: the std of fc1 is sqrt(2 / fan_in) within a few percent
    std = float(p["fc1"].std())
    assert abs(std / (2.0 / (7 * 7 * 64)) ** 0.5 - 1) < 0.05


def _resnet_case(size, dtype, seed=0):
    """JAX ResNet-tiny params, the JAX stats after one training forward
    (so eval reads non-trivial statistics) and images of ``size``."""
    jcfg = j_resnet.resnet_tiny(dtype=dtype)
    jp, js = j_resnet.init_params(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    warm = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    _, js = j_resnet.forward(jp, js, jnp.asarray(warm), jcfg, train=True)
    images = rng.normal(size=(3, size, size, 3)).astype(np.float32)
    tcfg = resnet.resnet_tiny(dtype=interop.torch_dtype(dtype))
    tp, ts = interop.resnet_from_jax(jax.device_get(jp), jax.device_get(js),
                                     device="cpu")
    return jcfg, jp, js, tcfg, tp, ts, images


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("size", [32, 33, 34])
def test_resnet_f32_matches_jax(size, train):
    jcfg, jp, js, tcfg, tp, ts, images = _resnet_case(size, jnp.float32)
    want, want_s = j_resnet.forward(jp, js, jnp.asarray(images), jcfg,
                                    train=train)
    got, got_s = resnet.forward(tp, ts, torch.from_numpy(images), tcfg,
                                train=train)
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    assert _rel_max(got, want) <= RESNET_F32_RTOL
    want_leaves = dict(_leaves(jax.device_get(want_s)))
    got_leaves = dict(_leaves(got_s))
    assert want_leaves.keys() == got_leaves.keys()
    for k, v in want_leaves.items():
        assert _rel_max(got_leaves[k], v) <= RESNET_F32_RTOL, k


def _symmetric_pads(n, k, s):
    return k // 2, k // 2


@pytest.mark.parametrize("size", [32, 33, 34])
def test_resnet_bf16_matches_jax_and_sees_symmetric_padding(
        size, monkeypatch):
    jcfg, jp, js, tcfg, tp, ts, images = _resnet_case(size, jnp.bfloat16)
    want, _ = j_resnet.forward(jp, js, jnp.asarray(images), jcfg,
                               train=False)
    x = torch.from_numpy(images)
    got, _ = resnet.forward(tp, ts, x, tcfg, train=False)
    sound = _rel_rms(got, want)
    assert sound <= RESNET_BF16_RMS
    monkeypatch.setattr(resnet, "same_pads", _symmetric_pads)
    fault = _rel_rms(resnet.forward(tp, ts, x, tcfg, train=False)[0], want)
    if size != 33:
        assert fault > RESNET_BF16_RMS, (sound, fault)
    else:
        assert fault == sound


def test_resnet_same_pads_are_xla_s():
    assert resnet.same_pads(224, 7, 2) == (2, 3)
    assert resnet.same_pads(112, 3, 2) == (0, 1)
    assert resnet.same_pads(56, 3, 2) == (0, 1)
    assert resnet.same_pads(56, 3, 1) == (1, 1)
    assert resnet.same_pads(56, 1, 2) == (0, 0)
    assert resnet.same_pads(33, 7, 2) == (3, 3)


def test_resnet_init_params_tree_matches_jax():
    cfg = resnet.resnet18(num_classes=7)
    p, s = resnet.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    jp, js = jax.eval_shape(
        lambda k: j_resnet.init_params(k, j_resnet.resnet18(num_classes=7)),
        jax.random.key(0))
    got = {k: tuple(v.shape) for k, v in _leaves(p)}
    want = {k: (tuple(np.transpose(np.zeros(v.shape), (3, 2, 0, 1)).shape)
                if len(v.shape) == 4 else tuple(v.shape))
            for k, v in _leaves(jp)}
    assert got == want
    assert {k: tuple(v.shape) for k, v in _leaves(s)} == \
        {k: tuple(v.shape) for k, v in _leaves(js)}


def _lin(params, x):
    return x @ params


@pytest.mark.parametrize("n", [1, 3, 4, 9])
def test_torch_model_buckets_and_chunks_like_jax_model(n):
    """tests/test_serving.py's bucketing case, and requests larger than
    the largest bucket (chunks of 4, the last padded to its bucket)."""
    w = np.eye(3, dtype=np.float32) * 3
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    req = InferRequest(model_name="lin", inputs=[
        InferTensor.from_numpy("x", x)])
    jm = JAXModel("lin", _lin, params=w, batch_buckets=(2, 4), warmup=False)
    jm.load()
    seen = []

    def fn(params, xb):
        seen.append(int(xb.shape[0]))
        return xb @ params

    tm = TorchModel("lin", fn, params=torch.from_numpy(w),
                    batch_buckets=(4, 2), warmup=False, device="cpu")
    tm.load()
    from kubeflow_tpu.serving.protocol import InferRequest as JRequest
    want = jm(JRequest.from_dict("lin", req.to_dict())).as_numpy()
    got = tm(req).as_numpy()
    assert got.shape == (n, 3)
    np.testing.assert_array_equal(got, want)
    full, rest = divmod(n, 4)
    assert seen == [4] * full + ([2 if rest <= 2 else 4] if rest else [])
    tm.unload()
    assert not tm.ready


def test_torch_model_serves_resnet_on_the_cpu_eagerly():
    """On the CPU (and without ``example_shape``) nothing is captured:
    each chunk runs ``fn`` eagerly, and the answer is the forward's."""
    cfg = resnet.resnet_tiny(dtype=torch.float32)
    p, s = resnet.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")

    def fn(params, x):
        return resnet.forward(params[0], params[1], x, cfg, train=False)[0]

    m = TorchModel("rn", fn, (p, s), batch_buckets=(1, 4),
                   example_shape=(16, 16, 3), device="cpu")
    m.load()
    assert m._graphs == {} and m.capture_seconds is None
    x = np.random.default_rng(0).normal(size=(3, 16, 16, 3)).astype(
        np.float32)
    out = m(InferRequest(model_name="rn", inputs=[
        InferTensor.from_numpy("x", x)])).as_numpy()
    want = fn((p, s), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
