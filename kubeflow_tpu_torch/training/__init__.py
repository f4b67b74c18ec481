"""Training on one card or over a world of processes (counterpart of
``kubeflow_tpu.training``): the trainer and its captured step, the synthetic and file-backed token
streams, checkpoints with step-exact resume, and the ``fit`` loop."""

from kubeflow_tpu_torch.training.checkpoint import CheckpointManager
from kubeflow_tpu_torch.training.data import (
    mnist_synthetic, synthetic_lm_batches, to_device,
)
from kubeflow_tpu_torch.training.dataset import (
    TokenDataset, write_token_shards,
)
from kubeflow_tpu_torch.training.loop import (
    checkpoint_manager, fit, restore_latest,
)
from kubeflow_tpu_torch.training.metrics import (
    MetricsWriter, objective_from_metrics, read_metrics,
)
from kubeflow_tpu_torch.training.trainer import (
    Trainer, TrainerConfig, lm_loss_fn, make_optimizer,
)
