"""Utilities: the run's metrics, the structured step log and profiling."""

from ps_tpu_torch.utils.metrics import TrainMetrics
from ps_tpu_torch.utils.profiling import trace
from ps_tpu_torch.utils.step_log import StepLogger

__all__ = ["TrainMetrics", "StepLogger", "trace"]
