"""Hygiene of the PyTorch port: it imports neither JAX nor anything of the
JAX package, its entry points refuse to run on the CPU unless asked, and
chip_smoke.py refuses to report without a GPU or outside the repo."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "kubeflow_tpu_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield path, ".".join(parts)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "kubeflow_tpu")


def test_no_jax_or_reference_imports_in_source():
    bad = []
    for path, _ in _port_modules():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(str(path), n) for n in names if _forbidden(n)]
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [("chip_smoke.py", a.name) for a in node.names
                    if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and _forbidden(
                node.module or ""):
            bad.append(("chip_smoke.py", node.module))
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    mods = [m for _, m in _port_modules()] + ["chip_smoke"]
    assert {"kubeflow_tpu_torch.rendezvous",
            "kubeflow_tpu_torch.rendezvous.bootstrap",
            "kubeflow_tpu_torch.rendezvous.worker_check",
            "kubeflow_tpu_torch.training.dataset",
            "kubeflow_tpu_torch.training.checkpoint",
            "kubeflow_tpu_torch.parallel.depot",
            "kubeflow_tpu_torch.parallel.mesh",
            "kubeflow_tpu_torch.parallel.sharding",
            "kubeflow_tpu_torch.training.trainer",
            "kubeflow_tpu_torch.training.optim",
            "kubeflow_tpu_torch.training.step_graph",
            "kubeflow_tpu_torch.training.loop",
            "kubeflow_tpu_torch.tools.world_train",
            "kubeflow_tpu_torch.training",
            "kubeflow_tpu_torch.training.data",
            "kubeflow_tpu_torch.cuda_graph",
            "kubeflow_tpu_torch.hpo",
            "kubeflow_tpu_torch.hpo.trial_worker",
            "kubeflow_tpu_torch.hpo.nas",
            "kubeflow_tpu_torch.parallel.mpmd"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'kubeflow_tpu'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu_unless_cpu_asked(
        no_cuda, tmp_path, monkeypatch):
    from kubeflow_tpu_torch import training
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.rendezvous import bootstrap, worker_check
    from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams
    from kubeflow_tpu_torch.serving.runtime import build_model_from_env
    from kubeflow_tpu_torch.serving.torch_model import LLMModel

    cfg = llama.llama_tiny(dtype=torch.float32)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    kw = dict(max_batch=2, max_seq=32, prefill_buckets=(8,))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(params, cfg, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMModel("m", params, cfg, **kw).load()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model_from_env({"KFT_MODEL_DIR": str(tmp_path)})
    # the training pod: its bootstrap, its entry point and its trainer
    with pytest.raises(RuntimeError, match="CUDA"):
        bootstrap.initialize({})
    with pytest.raises(RuntimeError, match="CUDA"):
        training.Trainer(lambda g: llama.init_params(g, cfg, device="cpu"),
                         training.lm_loss_fn(llama.forward, cfg),
                         training.TrainerConfig())
    for key in ("KFT_FORCE_PLATFORM", "KFT_TRAIN_STEPS", "KFT_PHASES_PATH",
                "KFT_METRICS_PATH", "KFT_MESH", "KFT_NUM_PROCESSES",
                "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        worker_check.main()
    world, dev = bootstrap.initialize({"KFT_FORCE_PLATFORM": "cpu"})
    assert dev.type == "cpu" and world.num_processes == 1
    monkeypatch.setenv("KFT_FORCE_PLATFORM", "cpu")
    assert worker_check.main() == 0
    # asking for the CPU is the one way to run there
    eng = LLMEngine(params, cfg, device="cpu", **kw)
    assert eng.device.type == "cpu" and eng.cache["k"].device.type == "cpu"
    [req] = eng.generate([[1, 2, 3]], SamplingParams(max_tokens=3))
    assert len(req.generated) == 3


def _tiny_checkpoint(tmp_path):
    """An HF config with no weights: the device is resolved before any
    tensor is read, so the loaders raise for the device, not the files."""
    from kubeflow_tpu_torch.models import llama

    cfg = llama.llama_tiny()
    (tmp_path / "config.json").write_text(
        '{"vocab_size": %d, "hidden_size": %d, "num_hidden_layers": %d, '
        '"num_attention_heads": %d, "num_key_value_heads": %d, '
        '"intermediate_size": %d}' % (cfg.vocab_size, cfg.dim, cfg.n_layers,
                                      cfg.n_heads, cfg.n_kv_heads,
                                      cfg.mlp_dim))
    return str(tmp_path)


def _constructors():
    """Each public function of the port that allocates tensors, called
    with no device: (name, call(tmp_path))."""
    import numpy as np

    from kubeflow_tpu_torch import interop, training
    from kubeflow_tpu_torch.hpo import nas
    from kubeflow_tpu_torch.models import hf_llama, llama, mnist, resnet
    from kubeflow_tpu_torch.parallel import TensorMesh, mesh_from_topology_env
    from kubeflow_tpu_torch.parallel import mpmd
    from kubeflow_tpu_torch.serving import TorchModel, paged_kv
    from kubeflow_tpu_torch.serving.llm import LLMEngine

    cfg = llama.llama_tiny(dtype=torch.float32)
    return {
        "init_params": lambda tmp: llama.init_params(
            torch.Generator().manual_seed(0), cfg),
        "init_cache": lambda tmp: llama.init_cache(cfg, 2, 16),
        "init_paged_cache": lambda tmp: paged_kv.init_paged_cache(
            cfg, max_batch=2, max_seq=16, block_size=8, num_blocks=5),
        "PagedKV": lambda tmp: paged_kv.PagedKV(
            cfg=cfg, max_batch=2, max_seq=16, block_size=8, num_blocks=5),
        "params_from_jax": lambda tmp: interop.params_from_jax(
            {"embed": np.zeros((4, 2), np.float32)}),
        "load_params": lambda tmp: hf_llama.load_params(
            _tiny_checkpoint(tmp)),
        "load_pretrained": lambda tmp: hf_llama.load_pretrained(
            _tiny_checkpoint(tmp)),
        "Trainer": lambda tmp: training.Trainer(
            lambda g: llama.init_params(g, cfg, device="cpu"),
            training.lm_loss_fn(llama.forward, cfg),
            training.TrainerConfig()),
        "to_device": lambda tmp: training.to_device(
            {"tokens": np.zeros((2, 3), np.int32)}),
        # tensor parallelism: one card per rank unless the CPU is asked
        # for, and no rank is spawned onto a missing card
        "mesh_from_topology_env": lambda tmp: mesh_from_topology_env(
            {"KFT_MESH": "tensor=2"}),
        "SeededParams": lambda tmp: llama.SeededParams(0)(cfg, None, None),
        "CheckpointParams": lambda tmp: hf_llama.CheckpointParams(
            _tiny_checkpoint(tmp))(cfg, None, None),
        "LLMEngine(mesh=)": lambda tmp: LLMEngine(
            llama.SeededParams(0), cfg, max_seq=16, prefill_buckets=(8,),
            mesh=TensorMesh(2, ["cuda:0", "cuda:1"])),
        # the function predictor and its models
        "resnet.init_params": lambda tmp: resnet.init_params(
            torch.Generator().manual_seed(0), resnet.resnet_tiny()),
        "mnist.init_params": lambda tmp: mnist.init_params(
            torch.Generator().manual_seed(0)),
        "TorchModel.load": lambda tmp: TorchModel(
            "m", lambda p, x: x, example_shape=(2,)).load(),
        "resnet_from_jax": lambda tmp: interop.resnet_from_jax(
            {"stem": {"conv": np.zeros((7, 7, 3, 8), np.float32)}},
            {"stem": {"mean": np.zeros((8,), np.float32)}}),
        "mnist_from_jax": lambda tmp: interop.mnist_from_jax(
            {"conv1": np.zeros((3, 3, 1, 32), np.float32)}),
        # DARTS and the MPMD runtime: the card unless the CPU is asked for
        "darts_search": lambda tmp: nas.darts_search(
            np.zeros((4, 2), np.float32), np.zeros((4, 1), np.float32),
            np.zeros((4, 2), np.float32), np.zeros((4, 1), np.float32),
            steps=1),
        "mpmd.init_stage_params": lambda tmp: mpmd.init_stage_params(
            mpmd.PipelineRunConfig(), 0),
        "mpmd.init_head_params": lambda tmp: mpmd.init_head_params(
            mpmd.PipelineRunConfig()),
        "mpmd.StageRuntime": lambda tmp: mpmd.StageRuntime(
            mpmd.PipelineRunConfig(), 0),
        "mpmd.run_inproc": lambda tmp: mpmd.run_inproc(
            mpmd.PipelineRunConfig()),
        "mpmd.run_oracle": lambda tmp: mpmd.run_oracle(
            mpmd.PipelineRunConfig()),
    }


@pytest.mark.parametrize("name", sorted(_constructors()))
def test_allocating_functions_raise_without_gpu_unless_cpu_asked(
        no_cuda, tmp_path, name):
    """No public function places tensors on the CPU unasked: with CUDA
    hidden and no device named, each raises instead."""
    with pytest.raises(RuntimeError, match="CUDA"):
        _constructors()[name](tmp_path)


def test_trial_worker_raises_without_gpu_unless_cpu_asked(
        no_cuda, tmp_path, monkeypatch):
    """The HPO trial pod: with ``KFT_FORCE_PLATFORM`` unset and no card it
    raises before its first step, and it never runs on the CPU unasked;
    ``KFT_FORCE_PLATFORM=cpu`` runs it there."""
    from kubeflow_tpu_torch.hpo import trial_worker

    for key in ("KFT_FORCE_PLATFORM", "KFT_PHASES_PATH", "KFT_DEPOT"):
        monkeypatch.delenv(key, raising=False)
    metrics = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("KFT_METRICS_PATH", str(metrics))
    with pytest.raises(RuntimeError, match="CUDA"):
        trial_worker.main()
    assert not metrics.exists()
    monkeypatch.setenv("KFT_FORCE_PLATFORM", "cpu")
    assert trial_worker.main() == 0
    assert len(metrics.read_text().splitlines()) == 8


def test_hpo_package_imports_nothing_heavy():
    """``kubeflow_tpu_torch.hpo`` loads neither torch nor the port's
    serving or training stacks: a trial pod stamps ``proc_start``
    before its imports."""
    code = ("import sys, kubeflow_tpu_torch.hpo\n"
            "heavy = sorted(k for k in sys.modules if k == 'torch' or "
            "k.startswith(('kubeflow_tpu_torch.serving', "
            "'kubeflow_tpu_torch.training')))\n"
            "assert not heavy, heavy\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_mesh_runs_on_the_cpu_only_when_asked(no_cuda):
    from kubeflow_tpu_torch.parallel import mesh_from_topology_env

    mesh = mesh_from_topology_env({"KFT_MESH": "tensor=2",
                                   "KFT_FORCE_PLATFORM": "cpu"})
    assert [d.type for d in mesh.devices] == ["cpu", "cpu"]
    assert mesh.backend == "gloo"


def test_spawned_rank_imports_no_jax(tmp_path):
    """A tensor-parallel engine's other ranks are fresh processes that
    import neither JAX nor the JAX package (whatever rank 0 imported);
    close() stops and joins them."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.parallel import TensorMesh
    from kubeflow_tpu_torch.serving.llm import LLMEngine

    cfg = llama.llama_tiny(dtype=torch.float32)
    eng = LLMEngine(llama.SeededParams(0), cfg, max_seq=32,
                    prefill_buckets=(8,),
                    mesh=TensorMesh(2, ["cpu", "cpu"],
                                    rendezvous_dir=str(tmp_path)))
    procs = list(eng.tp.procs)
    try:
        [worker] = eng.tp_status()[1:]
    finally:
        eng.close()
    assert worker["rank"] == 1 and worker["pid"] != os.getpid()
    assert not {"jax", "jaxlib", "kubeflow_tpu"} & set(worker["packages"])
    assert "kubeflow_tpu_torch" in worker["packages"]
    assert [p.exitcode for p in procs] == [0]


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_chip_smoke_fails_without_gpu(tmp_path):
    out = _run(ROOT, "chip_smoke.py")
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory (a GPU faked visible), the script cannot find
    the port and exits nonzero with no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path, "-c",
               "import runpy, torch\n"
               "torch.cuda.is_available = lambda: True\n"
               "runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert "repository root" in out.stderr
