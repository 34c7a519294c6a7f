from .detections_evaluator import (
    APAccumulator,
    EvaluateDetections,
    average_precision_50,
    evaluate_image_counters,
)

__all__ = [
    "APAccumulator",
    "EvaluateDetections",
    "average_precision_50",
    "evaluate_image_counters",
]
