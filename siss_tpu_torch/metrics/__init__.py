from siss_tpu_torch.metrics.tshirt import TShirtClassifier

__all__ = ["TShirtClassifier"]
