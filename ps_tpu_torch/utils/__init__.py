"""Utilities: the run's metrics, the structured step log and profiling."""

from ps_tpu_torch.utils.metrics import Meter, TrainMetrics, TransportStats
from ps_tpu_torch.utils.profiling import trace
from ps_tpu_torch.utils.step_log import StepLogger

__all__ = ["Meter", "TrainMetrics", "TransportStats", "StepLogger",
           "trace"]
