"""Training on one card (counterpart of ``kubeflow_tpu.training``);
``TokenDataset`` and checkpoints are later slices of the port."""

from kubeflow_tpu_torch.training.data import synthetic_lm_batches, to_device
from kubeflow_tpu_torch.training.metrics import (
    MetricsWriter, objective_from_metrics, read_metrics,
)
from kubeflow_tpu_torch.training.trainer import (
    Trainer, TrainerConfig, lm_loss_fn, make_optimizer,
)
