from seldon_core_tpu_torch.metrics.registry import Metrics, MetricsResilienceEvents, NullMetrics, get_metrics

__all__ = ["Metrics", "MetricsResilienceEvents", "NullMetrics", "get_metrics"]
