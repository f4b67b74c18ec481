"""The training pod's rendezvous (counterpart of
``kubeflow_tpu.rendezvous``): the controller's env -> a
``torch.distributed`` world and a device, and the pod entry point
``python -m kubeflow_tpu_torch.rendezvous.worker_check``.

The names below load ``bootstrap`` (and torch) on first use, not when
the package is imported: the pod stamps ``proc_start`` before its
imports, so that ``imports_done`` measures them."""

_BOOTSTRAP = ("WorldInfo", "initialize", "world_from_env")


def __getattr__(name):
    if name in _BOOTSTRAP:
        from kubeflow_tpu_torch.rendezvous import bootstrap

        return getattr(bootstrap, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
