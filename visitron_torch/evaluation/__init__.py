from visitron_torch.evaluation.classifier_metrics import binary_classification_metrics
from visitron_torch.evaluation.metrics import Evaluator, cls_metric, ndtw

__all__ = ["Evaluator", "ndtw", "cls_metric", "binary_classification_metrics"]
