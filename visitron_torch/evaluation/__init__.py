from visitron_torch.evaluation.metrics import Evaluator, cls_metric, ndtw

__all__ = ["Evaluator", "ndtw", "cls_metric"]
