from neuralmelting_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
