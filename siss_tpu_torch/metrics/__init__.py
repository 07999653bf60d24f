from siss_tpu_torch.metrics.classifier import Classifier, load_classifier_state
from siss_tpu_torch.metrics.fid import FIDEvaluator, frechet_distance
from siss_tpu_torch.metrics.inception_score import InceptionScore, inception_score_from_logits
from siss_tpu_torch.metrics.likelihood import LikelihoodEvaluator
from siss_tpu_torch.metrics.membership import MembershipLoss
from siss_tpu_torch.metrics.tshirt import TShirtClassifier

__all__ = ["Classifier", "FIDEvaluator", "InceptionScore", "LikelihoodEvaluator", "MembershipLoss",
           "TShirtClassifier", "frechet_distance", "inception_score_from_logits",
           "load_classifier_state"]
