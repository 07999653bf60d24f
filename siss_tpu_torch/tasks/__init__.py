from siss_tpu_torch.tasks.base import Task, boundary_crossed
from siss_tpu_torch.tasks.delete_celeb import DeleteCeleb
from siss_tpu_torch.tasks.delete_sd import DeleteSD
from siss_tpu_torch.tasks.delete_tshirt import DeleteTShirt
from siss_tpu_torch.tasks.train_classifier import TrainClassifier
from siss_tpu_torch.tasks.train_unconditional import TrainUnconditional

__all__ = ["Task", "boundary_crossed", "DeleteCeleb", "DeleteSD", "DeleteTShirt", "TrainClassifier",
           "TrainUnconditional"]
