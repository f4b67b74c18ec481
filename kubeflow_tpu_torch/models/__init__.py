"""Model code of the port (counterpart of ``kubeflow_tpu.models``)."""
