"""Hyperparameter search in the PyTorch port (counterpart of
``kubeflow_tpu.hpo``): the data-plane parts only.

- ``hpo.trial_worker``: the trial pod, ``python -m
  kubeflow_tpu_torch.hpo.trial_worker``;
- ``hpo.nas``: ``darts_search``, DARTS's one-shot differentiable search.

The experiment controller, the suggestion algorithms (``ENASSearch``
among them) and the early stoppers are the JAX package's numpy control
plane: they start trial pods, whatever program the pods run, and are not
ported. Importing this package loads neither torch nor the port's
serving or training stacks.
"""
